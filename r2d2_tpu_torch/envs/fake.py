"""Deterministic scripted environment for exact-math tests (port of
r2d2_tpu/envs/fake.py's ScriptedEnv, numpy only).

Emits a fixed reward script and observations whose pixel value encodes the
timestep, so n-step returns, terminal encoding and replay window contents
have closed-form expected values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class ScriptedEnv:
    def __init__(
        self,
        obs_shape: Tuple[int, ...] = (12, 12, 1),
        action_dim: int = 4,
        episode_len: int = 9,
        rewards: Optional[Sequence[float]] = None,
    ):
        self.obs_shape = obs_shape
        self.action_dim = action_dim
        self.episode_len = episode_len
        self.rewards = (list(rewards) if rewards is not None
                        else [float(i % 3) for i in range(episode_len)])
        self.t = 0

    def _obs(self) -> np.ndarray:
        return np.full(self.obs_shape, self.t % 256, dtype=np.uint8)

    def reset(self) -> np.ndarray:
        self.t = 0
        return self._obs()

    def step(self, action: int):
        reward = self.rewards[self.t % len(self.rewards)]
        self.t += 1
        done = self.t >= self.episode_len
        return self._obs(), float(reward), bool(done), {}
