"""Catch — a ball falls down an HxW grid onto a paddle (port of
r2d2_tpu/envs/catch.py to host numpy).

Action 0 is NOOP, 1 left, 2 right; catching pays +1, missing -1, and the
episode ends when the ball reaches the paddle row. Frames are (H, W, 1)
uint8 at 84x84 by default, the Atari resolution.

Step and render are the same functions of the state as the JAX package's
`CatchEnv`. Resets cannot match it: the JAX package draws them from
`jax.random`, and this port draws them from a numpy Generator.

The memory variants ("memory_catch[:K[:F]]": ball visible only for the
first K rows, paddle frozen meanwhile, ball falling one row every F steps)
are ported; the multi-ball variant (a fourth name field) is not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

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
        if balls != 1:
            raise NotImplementedError("the multi-ball catch variant is not ported")

    def reset(self, rng: np.random.Generator, n: int) -> CatchState:
        ball_x = rng.integers(0, self.w, size=n)
        if self.cue is None:
            paddle_x = rng.integers(0, self.w, size=n)
        else:
            # spawn within blind-phase reach, as the JAX core does
            reach = max(2 * (self.h - 2 - self.cue) * self.fall - 4, 1)
            lo = np.maximum(ball_x - reach, 0)
            hi = np.minimum(ball_x + reach, self.w - 1)
            paddle_x = rng.integers(lo, hi + 1)
        zero = np.zeros(n, np.int32)
        return CatchState(ball_x.astype(np.int32), zero, paddle_x.astype(np.int32),
                          zero.copy(), np.ones(n, np.int32))

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

    def step(self, s: CatchState, action: np.ndarray):
        """(state', reward (E,) float32, done (E,) bool)."""
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
        return CatchState(s.ball_x, ball_y, paddle_x, t.astype(np.int32), s.balls_left), reward, landed


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
        self._state, reward, done = self.env.step(self._state, np.asarray([action]))
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
        s2, reward, done = self.env.step(self._state, actions)
        term_obs = self.env.render(s2)
        nxt = s2
        if done.any():
            fresh = self.env.reset(self.rng, int(done.sum()))
            nxt = CatchState(*(a.copy() for a in s2))
            for field, new in zip(nxt, fresh):
                field[done] = new
        self._state = nxt
        return term_obs, reward.astype(np.float64), done, self.env.render(nxt)
