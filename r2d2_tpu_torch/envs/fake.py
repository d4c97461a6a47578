"""Deterministic scripted environment for exact-math tests (port of
r2d2_tpu/envs/fake.py: ScriptedEnv on the host, ScriptedFnEnv over batched
tensors for the on-device collector).

Emits a fixed reward script and observations whose pixel value encodes the
timestep, so n-step returns, terminal encoding and replay window contents
have closed-form expected values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


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


class ScriptedFnState(NamedTuple):
    t: torch.Tensor  # (E,) int32 timestep


class ScriptedFnEnv:
    """The tensor twin of ScriptedEnv for the on-device collector: the same
    reward script, timestep-encoded observations and episode length over
    (E,) states, so the device collection path can be held field by field
    against the host actor path on identical trajectories."""

    def __init__(self, obs_shape: Tuple[int, ...] = (12, 12, 1), action_dim: int = 4,
                 episode_len: int = 9, rewards: Optional[Sequence[float]] = None):
        self.obs_shape = tuple(obs_shape)
        self.action_dim = self.NUM_ACTIONS = action_dim
        self.episode_len = episode_len
        script = (list(rewards) if rewards is not None
                  else [float(i % 3) for i in range(episode_len)])
        self._rewards = torch.tensor(script, dtype=torch.float32)

    def reset(self, n: int, generator=None, device="cpu", draws=None) -> ScriptedFnState:
        return ScriptedFnState(torch.zeros(n, dtype=torch.int32, device=device))

    def render(self, s: ScriptedFnState) -> torch.Tensor:
        v = (s.t % 256).to(torch.uint8)
        return v.view(-1, *([1] * len(self.obs_shape))).expand(-1, *self.obs_shape).clone()

    def step(self, s: ScriptedFnState, action: torch.Tensor, generator=None, respawn=None):
        rewards = self._rewards.to(s.t.device)
        reward = rewards[(s.t % len(rewards)).long()]
        t2 = (s.t + 1).to(torch.int32)
        return ScriptedFnState(t2), reward, t2 >= self.episode_len
