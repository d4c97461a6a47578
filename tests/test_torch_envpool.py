"""The threaded host env pool and the two config fields that JAX's
R2D2Config read and the port lacked (r2d2_tpu_torch/actor.py
ThreadedHostEnvPool, config.env_pool_workers and config.noop_max), against
the JAX package:

- the port's ThreadedHostEnvPool steps as its serial HostEnvPool and as
  JAX's ThreadedHostEnvPool, over ScriptedEnvs with distinct rewards across
  the auto-reset boundary, per-env order kept, on `envpool` threads;
- train.build_vec_env routes env_pool_workers > 0 to the threaded pool for
  host envs, and catch and the tensor family bypass it, as in JAX;
- make_env hands noop_max to the Atari wrapper, on a fake gym that replaces
  ALE on both sides: the same frames and the same no-op counts as JAX;
- `--set noop_max=5` and `--set env_pool_workers=4` load, and JAX's config
  fields less the port's are exactly {param_dtype, scan_chunk}.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from r2d2_tpu.actor import ThreadedHostEnvPool as JaxThreadedPool
from r2d2_tpu.config import R2D2Config as JaxConfig
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.envs import make_env as jax_make_env
from r2d2_tpu.envs.fake import ScriptedEnv as JaxScriptedEnv
from r2d2_tpu_torch.actor import HostEnvPool, ThreadedHostEnvPool
from r2d2_tpu_torch.config import R2D2Config, parse_overrides, tiny_test
from r2d2_tpu_torch.envs import make_env
from r2d2_tpu_torch.envs.fake import ScriptedEnv
from r2d2_tpu_torch.train import build_vec_env

torch.set_num_threads(1)


def _scripted(cls, n=6):
    # distinct per-env rewards so a reordered step would show
    return [cls(obs_shape=(4, 4, 1), action_dim=3, episode_len=5,
                rewards=[float(i) + 0.125 * t for t in range(5)]) for i in range(n)]


def _assert_steps_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_threaded_pool_matches_serial_and_jax():
    serial = HostEnvPool(_scripted(ScriptedEnv))
    threaded = ThreadedHostEnvPool(_scripted(ScriptedEnv), workers=3)
    ref = JaxThreadedPool(_scripted(JaxScriptedEnv), workers=3)
    try:
        first = serial.reset_all()
        np.testing.assert_array_equal(first, threaded.reset_all())
        np.testing.assert_array_equal(first, ref.reset_all())
        seen_done = False
        for t in range(12):  # crosses the episode_len=5 auto-reset twice
            acts = (np.arange(6) + t) % 3
            out = serial.step(acts)
            _assert_steps_equal(out, threaded.step(acts))
            _assert_steps_equal(out, ref.step(acts))
            seen_done |= bool(out[2].any())
            # per-env order: env i's reward script starts at float(i)
            np.testing.assert_array_equal(np.floor(out[1]), np.arange(6))
        assert seen_done
        assert threaded.num_envs == 6 and threaded.action_dim == 3
    finally:
        threaded.close()
        ref.close()


def test_threaded_pool_steps_on_envpool_threads():
    names = set()

    class Recording(ScriptedEnv):
        def step(self, action):
            names.add(threading.current_thread().name)
            return super().step(action)

    pool = ThreadedHostEnvPool([Recording(obs_shape=(2, 2, 1)) for _ in range(4)], workers=2)
    try:
        pool.reset_all()
        pool.step(np.zeros(4, np.int64))
    finally:
        pool.close()
    assert names and all(n.startswith("envpool") for n in names), names
    # the default pool size is min(32, num_envs)
    pool = ThreadedHostEnvPool([ScriptedEnv() for _ in range(3)])
    try:
        assert pool._pool._max_workers == 3
    finally:
        pool.close()


@pytest.mark.parametrize("env_name,workers,want", [
    ("scripted", 4, ThreadedHostEnvPool),
    ("scripted", 0, HostEnvPool),
    ("scripted:7", 2, ThreadedHostEnvPool),
    ("catch", 4, None),          # the vectorized catch core: no pool
    ("procmaze", 4, None),       # the tensor family through FnVecEnv
])
def test_build_vec_env_routes_the_pool_as_jax(env_name, workers, want):
    kw = dict(env_name=env_name, num_actors=3, env_pool_workers=workers)
    if env_name == "procmaze":
        kw.update(obs_shape=(16, 16, 3), action_dim=5, max_episode_steps=96)
    env = build_vec_env(tiny_test().replace(**kw), seed=1)
    try:
        if want is None:
            assert not isinstance(env, HostEnvPool)
        else:
            assert type(env) is want
            if want is ThreadedHostEnvPool:
                assert env._pool._max_workers == workers
    finally:
        if isinstance(env, ThreadedHostEnvPool):
            env.close()


class _FakeAle:
    """A gymnasium env standing in for ALE: seeded 210x160 frames, a NOOP
    action 0, and a count of the steps taken."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.action_space = "Discrete(4)"
        self.unwrapped = self
        self.steps = 0
        self.t = 0

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "LEFT", "RIGHT"]

    def _frame(self):
        return self.rng.integers(0, 256, size=(210, 160), dtype=np.uint8)

    def reset(self, **kw):
        self.t = 0
        return self._frame(), {}

    def step(self, action):
        self.steps += 1
        self.t += 1
        return self._frame(), float(action), self.t % 9 == 0, False, {}


class _FakeGymModule:
    def __init__(self):
        self.made = []

    def make(self, name, **kw):
        env = _FakeAle(seed=len(self.made))
        self.made.append((name, env))
        return env


@pytest.mark.parametrize("noop_max", [1, 5, 30])
def test_make_env_honours_noop_max(monkeypatch, noop_max):
    import gymnasium

    import r2d2_tpu.envs.atari as jax_atari

    port_gym, jax_gym = _FakeGymModule(), _FakeGymModule()
    monkeypatch.setattr(gymnasium, "make", port_gym.make)
    monkeypatch.setattr(jax_atari, "gym", jax_gym)
    cfg = tiny_test().replace(env_name="Pong", obs_shape=(84, 84, 1), action_dim=4,
                              noop_max=noop_max)
    jcfg = jax_tiny_test().replace(env_name="Pong", obs_shape=(84, 84, 1), action_dim=4,
                                   noop_max=noop_max)
    port, ref = make_env(cfg, seed=3), jax_make_env(jcfg, seed=3)
    assert port.noop_max == ref.noop_max == noop_max
    assert port_gym.made[0][0] == jax_gym.made[0][0] == "ALE/Pong-v5"
    ale = port_gym.made[0][1]
    for _ in range(4):
        before = ale.steps
        np.testing.assert_array_equal(port.reset(), ref.reset())
        assert 1 <= ale.steps - before <= noop_max
        for a in (1, 2, 3):
            o1, r1, d1, _ = port.step(a)
            o2, r2, d2, _ = ref.step(a)
            np.testing.assert_array_equal(o1, o2)
            assert (r1, d1) == (r2, d2)
    assert ale.steps == jax_gym.made[0][1].steps


def test_the_two_fields_load_and_only_two_jax_fields_are_missing():
    over = parse_overrides(["noop_max=5", "env_pool_workers=4"])
    assert over == {"noop_max": 5, "env_pool_workers": 4}
    cfg = tiny_test().replace(**over)
    assert (cfg.noop_max, cfg.env_pool_workers) == (5, 4)
    base = R2D2Config()
    jbase = JaxConfig()
    assert (base.noop_max, base.env_pool_workers) == (jbase.noop_max, jbase.env_pool_workers)
    port = {f.name for f in dataclasses.fields(R2D2Config)}
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    assert jax_fields - port == {"param_dtype", "scan_chunk"}
    assert port - jax_fields == set()
