"""Atari (ALE) environment with the reference's preprocessing (port of
r2d2_tpu/envs/atari.py), import-gated.

- ``gym.make('ALE/{name}-v5', obs_type='grayscale', frameskip=4,
  repeat_action_probability=0, full_action_space=False)``;
- WarpFrame: cv2 INTER_AREA resize to 84x84, channels last (84, 84, 1);
- NoopReset: 1..noop_max NOOPs on reset (action 0 must be NOOP), from a
  seeded numpy Generator.

gymnasium and cv2 are imported where they are used, so importing this
module needs neither; ``create_atari_env`` raises a clear error where
gymnasium, ALE or cv2 is missing.
"""

from __future__ import annotations

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("cv2 is required for Atari frame warping") from e
    return cv2


class WarpFrame:
    def __init__(self, env, width: int = 84, height: int = 84):
        self.env = env
        self._w, self._h = width, height
        self.action_space = env.action_space
        self.obs_shape = (height, width, 1)
        self._cv2 = _cv2()

    def _warp(self, obs: np.ndarray) -> np.ndarray:
        obs = self._cv2.resize(obs, (self._w, self._h), interpolation=self._cv2.INTER_AREA)
        return obs[:, :, None].astype(np.uint8)

    def reset(self):
        obs, _info = self.env.reset()
        return self._warp(obs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._warp(obs), float(reward), bool(terminated or truncated), info


class NoopReset:
    def __init__(self, env, noop_max: int = 30, seed: int = 0):
        self.env = env
        self.noop_max = noop_max
        self.action_space = env.action_space
        self.obs_shape = env.obs_shape
        self._rng = np.random.default_rng(seed)

    def reset(self):
        obs = self.env.reset()
        for _ in range(int(self._rng.integers(1, self.noop_max + 1))):
            obs, _r, done, _i = self.env.step(0)
            if done:
                obs = self.env.reset()
        return obs

    def step(self, action):
        return self.env.step(action)


def create_atari_env(env_name: str, noop_start: bool = True, noop_max: int = 30, seed: int = 0):
    try:
        import gymnasium as gym
    except ImportError as e:
        raise ImportError("gymnasium is required for Atari envs") from e
    _cv2()
    env = gym.make(
        f"ALE/{env_name}-v5",
        obs_type="grayscale",
        frameskip=4,
        repeat_action_probability=0.0,
        full_action_space=False,
    )
    meanings = env.unwrapped.get_action_meanings()
    if meanings[0] != "NOOP":
        raise ValueError(f"action 0 of {env_name} is {meanings[0]}, not NOOP")
    env = WarpFrame(env)
    if noop_start:
        env = NoopReset(env, noop_max=noop_max, seed=seed)
    return env
