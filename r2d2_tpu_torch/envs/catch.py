"""Catch — a ball falls down an HxW grid onto a paddle (port of
r2d2_tpu/envs/catch.py to host numpy).

Action 0 is NOOP, 1 left, 2 right; catching pays +1, missing -1, and the
episode ends when the ball reaches the paddle row. Frames are (H, W, 1)
uint8 at 84x84 by default, the Atari resolution.

Step and render are the same functions of the state as the JAX package's
`CatchEnv`. Resets cannot match it: the JAX package draws them from
`jax.random`, and this port draws them from a numpy Generator.

The memory variants ("memory_catch[:K[:F[:N]]]"): the ball is visible only
for the first K rows, the paddle frozen meanwhile, and the ball falls one
row every F steps. With N > 1 balls an episode runs N landings: each pays
out, and before the last a fresh ball respawns at the top (t rewinds to 0,
the paddle stays where it is) in a column drawn uniformly from the interval
the current paddle can reach in the new ball's blind phase. That draw comes
from the env's numpy Generator (the JAX package draws it from
`jax.random`), so `step` takes the Generator for the multi-ball variant.

`TensorCatchEnv` is the same core over batched (E,) int32 state tensors on
any device, for the on-device collector (collect.py): step and render are
the numpy core's and JAX's functions of the state bit for bit; its reset
columns and multi-ball respawn columns come from an explicit
``torch.Generator``, or are handed in (the tests hand in JAX's draws).
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

MEMORY_CATCH_DEFAULT_CUE = 8


def catch_params(name: str) -> dict:
    """Variant parameters encoded in an env name, as CatchEnv kwargs."""
    n = name.lower()
    if n == "catch":
        return {}
    if n == "memory_catch":
        return {"cue_steps": MEMORY_CATCH_DEFAULT_CUE}
    if n.startswith("memory_catch:"):
        parts = n.split(":")
        if len(parts) > 4:
            raise ValueError(f"memory_catch takes at most cue:fall:balls, got {name!r}")
        cue = int(parts[1])
        if cue < 1:
            raise ValueError(f"memory_catch cue must be >= 1, got {cue}")
        out = {"cue_steps": cue}
        if len(parts) > 2:
            fall = int(parts[2])
            if fall < 1:
                raise ValueError(f"memory_catch fall interval must be >= 1, got {fall}")
            out["fall_every"] = fall
        if len(parts) > 3:
            balls = int(parts[3])
            if balls < 1:
                raise ValueError(f"memory_catch balls must be >= 1, got {balls}")
            out["balls"] = balls
        return out
    raise ValueError(f"not a catch family env name: {name!r}")


def is_catch_name(name: str) -> bool:
    n = name.lower()
    return n == "catch" or n == "memory_catch" or n.startswith("memory_catch:")


class CatchState(NamedTuple):
    """Per-env int32 arrays of shape (E,)."""

    ball_x: np.ndarray
    ball_y: np.ndarray
    paddle_x: np.ndarray
    t: np.ndarray           # step counter (drives the slow-fall variants)
    balls_left: np.ndarray  # landings remaining incl. the current ball


class CatchEnv:
    """Vectorized core over E envs: reset / render / step on CatchState."""

    NUM_ACTIONS = 3

    def __init__(self, height: int = 84, width: int = 84, paddle_width: int = 7,
                 ball_size: int = 3, cue_steps: Optional[int] = None,
                 fall_every: int = 1, balls: int = 1):
        self.h, self.w = height, width
        self.pw = paddle_width
        self.bs = ball_size
        if cue_steps is not None and not (1 <= cue_steps <= height - 3):
            raise ValueError(
                f"cue_steps must be in [1, height-3={height - 3}], got {cue_steps}"
            )
        self.cue = cue_steps
        if fall_every < 1:
            raise ValueError(f"fall_every must be >= 1, got {fall_every}")
        self.fall = fall_every
        if balls < 1:
            raise ValueError(f"balls must be >= 1, got {balls}")
        self.balls = balls

    def _within_reach(self, rng: np.random.Generator, anchor: np.ndarray) -> np.ndarray:
        """Columns drawn uniformly from the interval that the paddle can
        cover from (or to) `anchor` in a ball's blind phase, as the JAX
        core's spawn cap."""
        reach = max(2 * (self.h - 2 - self.cue) * self.fall - 4, 1)
        lo = np.maximum(anchor - reach, 0)
        hi = np.minimum(anchor + reach, self.w - 1)
        return rng.integers(lo, hi + 1)

    def reset(self, rng: np.random.Generator, n: int) -> CatchState:
        ball_x = rng.integers(0, self.w, size=n)
        if self.cue is None:
            paddle_x = rng.integers(0, self.w, size=n)
        else:
            paddle_x = self._within_reach(rng, ball_x)
        zero = np.zeros(n, np.int32)
        return CatchState(ball_x.astype(np.int32), zero, paddle_x.astype(np.int32),
                          zero.copy(), np.full(n, self.balls, np.int32))

    def render(self, s: CatchState) -> np.ndarray:
        """(E, H, W, 1) uint8 frames: ball block + paddle strip at 255."""
        ys = np.arange(self.h)[None, :, None]
        xs = np.arange(self.w)[None, None, :]
        by, bx, px = (v[:, None, None] for v in (s.ball_y, s.ball_x, s.paddle_x))
        ball = (np.abs(ys - by) < self.bs) & (np.abs(xs - bx) < self.bs)
        if self.cue is not None:
            ball = ball & (by < self.cue)
        paddle = (ys >= self.h - 2) & (np.abs(xs - px) <= self.pw // 2)
        return np.where(ball | paddle, 255, 0).astype(np.uint8)[..., None]

    def step(self, s: CatchState, action: np.ndarray,
             rng: Optional[np.random.Generator] = None):
        """(state', reward (E,) float32, done (E,) bool). The multi-ball
        variant draws its respawn columns from `rng`."""
        action = np.asarray(action)
        dx = np.where(action == 1, -1, np.where(action == 2, 1, 0))
        if self.cue is not None:
            dx = np.where(s.ball_y < self.cue, 0, dx)
        paddle_x = np.clip(s.paddle_x + dx * 2, 0, self.w - 1).astype(np.int32)
        t = s.t + 1
        if self.fall == 1:
            ball_y = s.ball_y + 1
        else:
            ball_y = s.ball_y + np.where(t % self.fall == 0, 1, 0)
        ball_y = ball_y.astype(np.int32)
        landed = ball_y >= self.h - 2
        caught = np.abs(s.ball_x - paddle_x) <= self.pw // 2
        reward = np.where(landed, np.where(caught, 1.0, -1.0), 0.0).astype(np.float32)
        t = t.astype(np.int32)
        if self.balls == 1:
            return CatchState(s.ball_x, ball_y, paddle_x, t, s.balls_left), reward, landed
        if rng is None:
            raise ValueError("the multi-ball catch variant draws its respawns: pass rng")
        balls_left = (s.balls_left - landed).astype(np.int32)
        done = landed & (balls_left <= 0)
        respawn = landed & ~done
        ball_x = s.ball_x.copy()
        if respawn.any():
            if self.cue is None:
                new_x = rng.integers(0, self.w, size=int(respawn.sum()))
            else:
                new_x = self._within_reach(rng, paddle_x[respawn])
            ball_x[respawn] = new_x
        return (CatchState(ball_x, np.where(respawn, 0, ball_y).astype(np.int32), paddle_x,
                           np.where(respawn, 0, t).astype(np.int32), balls_left),
                reward, done)


class CatchHostEnv:
    """Single-env host protocol (reset() / step(int))."""

    def __init__(self, height: int = 84, width: int = 84, seed: int = 0, **variant):
        self.env = CatchEnv(height, width, **variant)
        self.action_dim = CatchEnv.NUM_ACTIONS
        self.obs_shape = (height, width, 1)
        self.rng = np.random.default_rng(seed)
        self._state = None

    def reset(self) -> np.ndarray:
        self._state = self.env.reset(self.rng, 1)
        return self.env.render(self._state)[0]

    def step(self, action: int):
        self._state, reward, done = self.env.step(self._state, np.asarray([action]), self.rng)
        return self.env.render(self._state)[0], float(reward[0]), bool(done[0]), {}


class CatchVecEnv:
    """E Catch envs stepped together with auto-reset. step() returns the
    terminal-inclusive frame plus the frame that seeds the next step (the
    fresh episode's first frame on done rows)."""

    def __init__(self, num_envs: int = 1, height: int = 84, width: int = 84,
                 seed: int = 0, **variant):
        self.env = CatchEnv(height, width, **variant)
        self.num_envs = num_envs
        self.action_dim = CatchEnv.NUM_ACTIONS
        self.obs_shape = (height, width, 1)
        self.rng = np.random.default_rng(seed)
        self._state = self.env.reset(self.rng, num_envs)

    def reset_all(self) -> np.ndarray:
        self._state = self.env.reset(self.rng, self.num_envs)
        return self.env.render(self._state)

    def step(self, actions: np.ndarray):
        s2, reward, done = self.env.step(self._state, actions, self.rng)
        term_obs = self.env.render(s2)
        nxt = s2
        if done.any():
            fresh = self.env.reset(self.rng, int(done.sum()))
            nxt = CatchState(*(a.copy() for a in s2))
            for field, new in zip(nxt, fresh):
                field[done] = new
        self._state = nxt
        return term_obs, reward.astype(np.float64), done, self.env.render(nxt)

    def get_state(self) -> dict:
        """The whole env state as host arrays (npz-safe), for the
        preemption carry: set_state on a fresh instance of the same geometry
        resumes the exact episodes. The port's resets and respawns come
        from the numpy Generator, so its state is part of this (the JAX
        package carries its key schedule instead)."""
        d = {"s_" + name: np.asarray(v).copy() for name, v in zip(CatchState._fields, self._state)}
        d["rng"] = np.asarray(json.dumps(self.rng.bit_generator.state))
        return d

    def set_state(self, d: dict) -> None:
        self._state = CatchState(*(
            np.asarray(d["s_" + name], np.int32).copy() for name in CatchState._fields
        ))
        self.rng.bit_generator.state = json.loads(str(np.asarray(d["rng"])[()]))


class TensorCatchEnv:
    """Catch over batched (E,) int32 state tensors (a CatchState of
    tensors) on any device: reset / step / render with no host read-back.
    The geometry and variants are CatchEnv's."""

    NUM_ACTIONS = 3

    def __init__(self, height: int = 84, width: int = 84, paddle_width: int = 7,
                 ball_size: int = 3, cue_steps: Optional[int] = None,
                 fall_every: int = 1, balls: int = 1):
        # the numpy core validates the variant and holds the geometry
        self.core = CatchEnv(height, width, paddle_width, ball_size, cue_steps, fall_every,
                             balls)
        self.h, self.w, self.pw, self.bs = height, width, paddle_width, ball_size
        self.cue, self.fall, self.balls = cue_steps, fall_every, balls
        self.obs_shape = (height, width, 1)

    def _reach_bounds(self, anchor: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[lo, hi] of the columns reachable from `anchor` in a ball's blind
        phase (the memory variants' spawn cap), or the whole row."""
        if self.cue is None:
            return torch.zeros_like(anchor), torch.full_like(anchor, self.w - 1)
        reach = max(2 * (self.h - 2 - self.cue) * self.fall - 4, 1)
        return (torch.clamp(anchor - reach, min=0), torch.clamp(anchor + reach, max=self.w - 1))

    @staticmethod
    def _uniform_int(lo: torch.Tensor, hi: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """One integer uniform in [lo, hi] per element, from `generator`."""
        # r2d2: disable=float64-op  (a few scalars per reset: float64 keeps floor(u * span) exact)
        f64 = torch.float64
        u = torch.rand(lo.shape, generator=generator, device=lo.device, dtype=f64)
        return (lo + torch.floor(u * (hi - lo + 1).to(f64)).long()).clamp(max=hi).to(torch.int32)

    def reset(self, n: int, generator: Optional[torch.Generator] = None, device="cpu",
              draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> CatchState:
        """n fresh episodes. `draws` = (ball_x, paddle_x) columns hands the
        draws in; else ball_x is uniform over the row and paddle_x uniform
        over its allowed interval, from `generator`."""
        if draws is not None:
            ball_x, paddle_x = (torch.as_tensor(d, device=device).to(torch.int32) for d in draws)
        else:
            zero = torch.zeros(n, dtype=torch.int32, device=device)
            ball_x = self._uniform_int(zero, zero + self.w - 1, generator)
            paddle_x = self._uniform_int(*self._reach_bounds(ball_x), generator)
        zero = torch.zeros(n, dtype=torch.int32, device=ball_x.device)
        return CatchState(ball_x, zero, paddle_x, zero.clone(),
                          torch.full_like(zero, self.balls))

    def render(self, s: CatchState) -> torch.Tensor:
        """(E, H, W, 1) uint8 frames: ball block + paddle strip at 255."""
        dev = s.ball_x.device
        ys = torch.arange(self.h, device=dev)[None, :, None]
        xs = torch.arange(self.w, device=dev)[None, None, :]
        by, bx, px = (v[:, None, None] for v in (s.ball_y, s.ball_x, s.paddle_x))
        ball = (torch.abs(ys - by) < self.bs) & (torch.abs(xs - bx) < self.bs)
        if self.cue is not None:
            ball = ball & (by < self.cue)
        paddle = (ys >= self.h - 2) & (torch.abs(xs - px) <= self.pw // 2)
        return ((ball | paddle).to(torch.uint8) * 255)[..., None]

    def step(self, s: CatchState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             respawn: Optional[torch.Tensor] = None):
        """(state', reward (E,) float32, done (E,) bool). The multi-ball
        variant's respawn columns are `respawn` (E,) where given, else drawn
        from `generator` (one per env; used where a ball respawns)."""
        action = action.to(s.ball_x.device)
        dx = torch.where(action == 1, -1, torch.where(action == 2, 1, 0))
        if self.cue is not None:
            dx = torch.where(s.ball_y < self.cue, 0, dx)
        paddle_x = torch.clamp(s.paddle_x + dx * 2, 0, self.w - 1).to(torch.int32)
        t = (s.t + 1).to(torch.int32)
        if self.fall == 1:
            ball_y = s.ball_y + 1
        else:
            ball_y = s.ball_y + (t % self.fall == 0).to(torch.int32)
        ball_y = ball_y.to(torch.int32)
        landed = ball_y >= self.h - 2
        caught = torch.abs(s.ball_x - paddle_x) <= self.pw // 2
        one = torch.ones_like(ball_y, dtype=torch.float32)
        reward = torch.where(landed, torch.where(caught, one, -one), torch.zeros_like(one))
        if self.balls == 1:
            return CatchState(s.ball_x, ball_y, paddle_x, t, s.balls_left), reward, landed
        balls_left = (s.balls_left - landed.to(torch.int32)).to(torch.int32)
        done = landed & (balls_left <= 0)
        respawn_now = landed & ~done
        new_x = (respawn.to(s.ball_x.device, torch.int32) if respawn is not None
                 else self._uniform_int(*self._reach_bounds(paddle_x), generator))
        zero = torch.zeros_like(ball_y)
        return (CatchState(torch.where(respawn_now, new_x, s.ball_x),
                           torch.where(respawn_now, zero, ball_y), paddle_x,
                           torch.where(respawn_now, zero, t), balls_left),
                reward, done)
