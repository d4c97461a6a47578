"""Drift — the continuing target-tracking env of the multi-task family, as a
tensor core (port of r2d2_tpu/envs/drift.py).

A target random-walks along a strip (one move of -1, 0 or +1 every
`drift_every` steps) and the agent (0 NOOP, 1 left, 2 right; other actions
are NOOPs) is paid +1 for every step on it. `step` never returns done:
truncation is the caller's (max_episode_steps). Frames are (H, W, 1) uint8:
row 0 the target, row 1 the agent.

The port's tensor-core protocol (envs/catch.TensorCatchEnv). Draws: a reset
takes (pos, target) columns, and every step one move per env (drawn each
step, used on the steps the target moves, as the JAX core draws it), from
`generator` or handed in as `draws` (the tests hand in the JAX package's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

DRIFT_DEFAULTS = dict(drift_every=2)


def drift_params(name: str) -> dict:
    """'drift[:EVERY]' -> the target's move interval. Raises on other names
    and on EVERY < 1."""
    base, _, suffix = name.lower().partition(":")
    if base != "drift":
        raise ValueError(f"not a drift family env name: {name!r}")
    out = dict(DRIFT_DEFAULTS)
    if suffix:
        out["drift_every"] = int(suffix)
    if out["drift_every"] < 1:
        raise ValueError(f"drift_every must be >= 1, got {out['drift_every']}")
    return out


def is_drift_name(name: str) -> bool:
    return name.lower().partition(":")[0] == "drift"


def build_drift_env(obs_shape, max_episode_steps: int, name: str) -> "DriftEnv":
    """The one factory of every drift name; the episode budget is the
    caller's, never the env's."""
    h, w, _ = obs_shape
    return DriftEnv(height=h, width=w, **drift_params(name))


class DriftState(NamedTuple):
    pos: torch.Tensor     # (E,) int32 agent cell in [0, width)
    target: torch.Tensor  # (E,) int32 target cell in [0, width)
    t: torch.Tensor       # (E,) int32 step counter (drives the drift cadence)


class DriftEnv:
    NUM_ACTIONS = 3  # 0 NOOP, 1 left, 2 right

    def __init__(self, height: int = 4, width: int = 10, drift_every: int = 2):
        if height < 2:
            raise ValueError(f"drift needs height >= 2 (target + agent rows), got {height}")
        if width < 3:
            raise ValueError(f"drift needs width >= 3 (room to track), got {width}")
        if drift_every < 1:
            raise ValueError(f"drift_every must be >= 1, got {drift_every}")
        self.h, self.w = height, width
        self.every = drift_every
        self.obs_shape = (height, width, 1)

    def reset(self, n: int, generator: Optional[torch.Generator] = None, device="cpu",
              draws=None) -> DriftState:
        """n fresh episodes; `draws` = (pos, target) columns."""
        if draws is None:
            draws = tuple(torch.randint(0, self.w, (n,), generator=generator, device=device)
                          for _ in range(2))
        pos, target = (torch.as_tensor(d, device=device).to(torch.int32) for d in draws)
        return DriftState(pos, target, torch.zeros_like(pos))

    def render(self, s: DriftState) -> torch.Tensor:
        dev = s.pos.device
        ys = torch.arange(self.h, device=dev)[None, :, None]
        xs = torch.arange(self.w, device=dev)[None, None, :]
        target = (ys == 0) & (xs == s.target[:, None, None])
        agent = (ys == 1) & (xs == s.pos[:, None, None])
        return ((target | agent).to(torch.uint8) * 255)[..., None]

    def step(self, s: DriftState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None):
        """(state', reward, done=False); `draws` = the (E,) moves in {-1, 0,
        +1}."""
        a = action.to(s.pos.device)
        dx = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
        pos = torch.clamp(s.pos + dx, 0, self.w - 1).to(torch.int32)
        t = (s.t + 1).to(torch.int32)
        if draws is None:
            move = torch.randint(-1, 2, pos.shape, generator=generator, device=pos.device)
        else:
            move = torch.as_tensor(draws, device=pos.device)
        delta = torch.where(t % self.every == 0, move.to(torch.int32), 0)
        target = torch.clamp(s.target + delta, 0, self.w - 1).to(torch.int32)
        reward = (pos == target).to(torch.float32)
        return DriftState(pos, target, t), reward, torch.zeros_like(pos, dtype=torch.bool)
