"""Ape-X epsilon ladder: eps_i = base ** (1 + i / (N - 1) * alpha).

Port of r2d2_tpu/ops/epsilon.py (the single-task ladder).
"""

from __future__ import annotations

import numpy as np


def epsilon_ladder(
    num_actors: int, base_eps: float = 0.4, alpha: float = 7.0
) -> np.ndarray:
    """(N,) float32 per-actor epsilons, computed in float64 once."""
    if num_actors < 1:
        raise ValueError(f"num_actors must be >= 1, got {num_actors}")
    i = np.arange(num_actors, dtype=np.float64)
    exponent = 1.0 + i / max(num_actors - 1, 1) * alpha
    return (float(base_eps) ** exponent).astype(np.float32)
