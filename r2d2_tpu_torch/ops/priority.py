"""Per-sequence mixed TD-error priorities (torch and numpy).

p_seq = eta * max_t |delta_t| + (1 - eta) * mean_t |delta_t| over each
sequence's valid learning steps. Port of r2d2_tpu/ops/priority.py.
"""

from __future__ import annotations

import numpy as np
import torch


def mixed_td_priorities(
    abs_td: torch.Tensor, mask: torch.Tensor, eta: float = 0.9
) -> torch.Tensor:
    """abs_td: (B, L) |delta|; mask: (B, L) 1.0 on valid learning steps.
    Returns (B,) float32 priorities; rows with an empty mask give 0."""
    abs_td = abs_td.float()
    mask = mask.float()
    masked = abs_td * mask
    max_td = masked.amax(dim=1)
    count = torch.clamp(mask.sum(dim=1), min=1.0)
    mean_td = masked.sum(dim=1) / count
    return eta * max_td + (1.0 - eta) * mean_td


def mixed_td_priorities_np(
    abs_td: np.ndarray, mask: np.ndarray, eta: float = 0.9
) -> np.ndarray:
    """numpy twin for host-side (accumulator initial-priority) use."""
    abs_td = np.asarray(abs_td, np.float32)
    mask = np.asarray(mask, np.float32)
    masked = abs_td * mask
    max_td = masked.max(axis=1)
    count = np.maximum(mask.sum(axis=1), 1.0)
    mean_td = masked.sum(axis=1) / count
    return (eta * max_td + (1.0 - eta) * mean_td).astype(np.float32)
