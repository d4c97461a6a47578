"""Ape-X epsilon ladder: eps_i = base ** (1 + i / (N - 1) * alpha), and the
multi-task plane's ladders.

Port of r2d2_tpu/ops/epsilon.py: host numpy, the same float64 arithmetic
and the same final casts, so every ladder is the JAX package's bit for bit.
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


def multitask_epsilon_ladders(
    num_tasks: int,
    actors_per_task: int,
    base_eps: float = 0.4,
    alpha: float = 7.0,
) -> np.ndarray:
    """(num_tasks, actors_per_task) ε matrix: each task gets its own full
    Ape-X ladder (exploration needs are per task), not a slice of one."""
    if num_tasks < 1:
        raise ValueError(f"num_tasks must be >= 1, got {num_tasks}")
    ladder = epsilon_ladder(actors_per_task, base_eps, alpha)
    return np.tile(ladder[None, :], (num_tasks, 1))


def multitask_gamma_ladder(
    num_tasks: int, gamma_min: float = 0.97, gamma_max: float = 0.997
) -> np.ndarray:
    """(num_tasks,) float32 per-task discounts, uniform in log(1 - gamma)
    (Agent57's horizon spacing): task 0 gets gamma_max, the last task
    gamma_min; one task gets gamma_max exactly."""
    if num_tasks < 1:
        raise ValueError(f"num_tasks must be >= 1, got {num_tasks}")
    if not (0.0 < gamma_min <= gamma_max < 1.0):
        raise ValueError(f"need 0 < gamma_min <= gamma_max < 1, got [{gamma_min}, {gamma_max}]")
    i = np.arange(num_tasks, dtype=np.float64)
    frac = i / max(num_tasks - 1, 1)
    log_span = np.log(1.0 - gamma_max) + frac * (
        np.log(1.0 - gamma_min) - np.log(1.0 - gamma_max)
    )
    return (1.0 - np.exp(log_span)).astype(np.float64).astype(np.float32)
