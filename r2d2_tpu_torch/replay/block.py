"""Block — the unit of replay storage (port of r2d2_tpu/replay/block.py).

`last_action` is a scalar uint8 index (one-hot expansion happens on the
device); per-sequence step counters are int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Block:
    # (stored_steps, *obs_shape) uint8; stored_steps = burn_in_steps[0] +
    # sum(learning_steps) + 1 (trailing seed entry for the next window)
    obs: np.ndarray
    last_action: np.ndarray    # (stored_steps,) uint8
    last_reward: np.ndarray    # (stored_steps,) float32
    action: np.ndarray         # (T,) uint8 action taken at each learning step
    n_step_reward: np.ndarray  # (T,) float32 n-step return
    gamma: np.ndarray          # (T,) float32 bootstrap discount, 0 past a terminal
    # (num_sequences, 2, hidden_dim) float32 (h, c) at each sequence's TRUE
    # replay-window start
    hidden: np.ndarray
    num_sequences: int
    burn_in_steps: np.ndarray  # (num_sequences,) int32
    learning_steps: np.ndarray
    forward_steps: np.ndarray

    @property
    def stored_steps(self) -> int:
        return len(self.obs)
