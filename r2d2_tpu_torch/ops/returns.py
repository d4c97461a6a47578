"""n-step returns and bootstrap discounts (host numpy).

Port of r2d2_tpu/ops/returns.py: R_t = sum_{k<n} gamma^k r_{t+k} with
zero padding past the chunk, and gamma_n(t) carrying all terminal
information (0 past a terminal).
"""

from __future__ import annotations

import numpy as np


def n_step_returns(rewards: np.ndarray, gamma: float, n: int) -> np.ndarray:
    """(T,) float32 n-step returns of one (partial) episode chunk; float32
    and float64 rewards accumulate in float64, half-width ones in float32."""
    rewards = np.asarray(rewards)
    acc = np.float32 if rewards.dtype.itemsize <= 2 else np.float64
    rewards = rewards.astype(acc)
    padded = np.concatenate([rewards, np.zeros(n - 1, dtype=acc)])
    kernel = np.array([gamma ** (n - 1 - i) for i in range(n)], dtype=acc)
    return np.convolve(padded, kernel, "valid").astype(np.float32)


def n_step_gammas(size: int, gamma: float, n: int, done: bool) -> np.ndarray:
    """Bootstrap discount gamma_n(t) for a chunk of `size` steps: gamma^n,
    shrinking to gamma^1 toward a block cut, or 0 toward a terminal."""
    max_fwd = min(size, n)
    head = [gamma**n] * (size - max_fwd)
    if done:
        tail = [0.0] * max_fwd
    else:
        tail = [gamma**j for j in reversed(range(1, max_fwd + 1))]
    return np.asarray(head + tail, dtype=np.float32)
