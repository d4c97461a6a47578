"""The port's long-context path against the JAX package: the multi-ball
memory catch, the scripted env and the Atari wrappers, and the slice as a
whole (multi-ball catch -> IMPALA encoder -> LRU core, cosine lr) through
both Trainers.

- Multi-ball catch (memory_catch:K:F:N, N > 1): from identical states the
  port's step equals JAX's CatchEnv step bit for bit on every field but the
  respawn column, which both draw from their own generators (the port from
  a numpy Generator, JAX from jax.random); the port's column must fall in
  JAX's interval [max(paddle - reach, 0), min(paddle + reach, W - 1)], and
  its draws must be uniform over it (a chi-square bound).
- ScriptedEnv, WarpFrame and NoopReset against the reference's on scripted
  envs, bit for bit.
- The slice: a tiny long_context-shaped config (memory_catch:2:1:3 at
  12x12, IMPALA, LRU, cosine lr, fp32). Both Trainers run on twin numpy
  envs (the port's CatchVecEnv, which both actors take) from JAX's init
  converted by interop.py, 6 inline updates; the port replays through its
  native core, JAX through numpy. The records agree exactly on env_steps,
  replay_size and episodes and on loss and q_mean to rtol 1e-4 / atol 1e-5
  (tests/test_torch_end_to_end.py's tolerance); both save steps 3 and 6,
  and JAX's step-6 checkpoint converted matches the port's. The JAX
  package's networks run the IMPALA stack (16, 32, 32) whatever
  impala_channels says (its make_encoder does not pass it on), so the
  slice sets those channels on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import long_context as jax_long_context
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.envs import make_env as jax_make_env
from r2d2_tpu.envs.atari import NoopReset as RefNoopReset
from r2d2_tpu.envs.atari import WarpFrame as RefWarpFrame
from r2d2_tpu.envs.catch import CatchEnv as RefCatchEnv
from r2d2_tpu.envs.catch import CatchState as RefCatchState
from r2d2_tpu.envs.fake import ScriptedEnv as RefScriptedEnv
from r2d2_tpu.train import Trainer as JaxTrainer
from r2d2_tpu.utils.checkpoint import list_checkpoint_steps as jax_list_checkpoint_steps
from r2d2_tpu.utils.checkpoint import restore_checkpoint as jax_restore_checkpoint
from r2d2_tpu_torch.config import PRESETS, long_context, tiny_test
from r2d2_tpu_torch.envs import ScriptedEnv, make_env
from r2d2_tpu_torch.envs.atari import NoopReset, WarpFrame
from r2d2_tpu_torch.envs.catch import CatchEnv, CatchState, CatchVecEnv, catch_params
from r2d2_tpu_torch.interop import adam_state_from_optax, adam_state_to_optax
from r2d2_tpu_torch.learner import init_train_state
from r2d2_tpu_torch.ops import lstm_kernel
from r2d2_tpu_torch.train import Trainer
from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps, restore_checkpoint
from tests.test_torch_end_to_end import (
    _assert_trees_close,
    _load_flax,
    _np_tree,
    _optax_adam,
    _port_tree,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


# --------------------------------------------------------------------------
# multi-ball catch
# --------------------------------------------------------------------------


def _reach(env):
    return max(2 * (env.h - 2 - env.cue) * env.fall - 4, 1)


@pytest.mark.parametrize("name,size", [("memory_catch:10:8:4", 26), ("memory_catch:2:1:3", 12),
                                       ("memory_catch:5:3:2", 84)])
def test_multi_ball_step_matches_reference(name, size):
    kw = catch_params(name)
    ref, port = RefCatchEnv(size, size, **kw), CatchEnv(size, size, **kw)
    rng = np.random.default_rng(size)
    E = 256
    # rows near the landing and every count of balls left, so landings,
    # respawns and episode ends all happen within a few steps
    s = CatchState(
        ball_x=rng.integers(0, size, E).astype(np.int32),
        ball_y=rng.integers(size - 4, size - 2, E).astype(np.int32),
        paddle_x=rng.integers(0, size, E).astype(np.int32),
        t=rng.integers(0, 20, E).astype(np.int32),
        balls_left=rng.integers(1, kw["balls"] + 1, E).astype(np.int32),
    )
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    step_rng = np.random.default_rng(7)
    respawns = 0
    for _ in range(3 * kw["fall_every"]):
        rs = RefCatchState(*(jnp.asarray(v) for v in (s.ball_x, s.ball_y, s.paddle_x)), keys,
                           jnp.asarray(s.t), jnp.asarray(s.balls_left))
        actions = rng.integers(0, 3, E).astype(np.int32)
        np.testing.assert_array_equal(port.render(s), np.asarray(jax.vmap(ref.render)(rs)))
        s2, reward, done = port.step(s, actions, step_rng)
        rs2, r_reward, r_done = jax.vmap(ref.step)(rs, jnp.asarray(actions))
        landed = s.ball_y + (((s.t + 1) % port.fall) == 0) >= size - 2
        respawn = landed & ~np.asarray(r_done)
        respawns += int(respawn.sum())
        for field in ("ball_y", "paddle_x", "t", "balls_left"):
            got, want = getattr(s2, field), np.asarray(getattr(rs2, field))
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        np.testing.assert_array_equal(s2.ball_x[~respawn], np.asarray(rs2.ball_x)[~respawn])
        lo = np.maximum(s2.paddle_x - _reach(port), 0)
        hi = np.minimum(s2.paddle_x + _reach(port), size - 1)
        assert ((s2.ball_x >= lo) & (s2.ball_x <= hi))[respawn].all()
        np.testing.assert_array_equal(reward, np.asarray(r_reward))
        np.testing.assert_array_equal(done, np.asarray(r_done))
        # both go on from the port's state (JAX's respawn columns differ)
        s = CatchState(*(np.array(v) for v in s2))
        s = s._replace(balls_left=np.where(done, kw["balls"], s.balls_left).astype(np.int32))
        keys = rs2.key
    assert respawns > 20


def test_multi_ball_respawns_are_uniform_over_the_reachable_interval():
    env = CatchEnv(26, 26, **catch_params("memory_catch:10:8:4"))
    E, paddle = 30_000, 3
    s = CatchState(np.full(E, 10, np.int32), np.full(E, 23, np.int32),
                   np.full(E, paddle, np.int32), np.full(E, 7, np.int32), np.full(E, 2, np.int32))
    s2, reward, done = env.step(s, np.zeros(E, np.int32), np.random.default_rng(0))
    assert not done.any() and (s2.ball_y == 0).all() and (s2.t == 0).all()
    assert (s2.balls_left == 1).all() and (reward != 0).all()
    lo, hi = max(paddle - _reach(env), 0), min(paddle + _reach(env), 25)
    counts = np.bincount(s2.ball_x - lo, minlength=hi - lo + 1)
    assert len(counts) == hi - lo + 1  # nothing outside [lo, hi]
    expected = E / len(counts)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # 25 degrees of freedom: chi2 > 60 has probability about 1e-4
    assert chi2 < 60, chi2


def test_multi_ball_episodes_through_the_vec_env():
    name = "memory_catch:2:1:3"
    vec = CatchVecEnv(num_envs=4, height=12, width=12, seed=0, **catch_params(name))
    vec.reset_all()
    rewards, dones, t = np.zeros(4), np.zeros(4, int), 0
    while dones.min() < 2:
        _, r, d, _ = vec.step(np.random.default_rng(t).integers(0, 3, 4))
        rewards += np.abs(r)
        dones += d
        t += 1
    # an episode is 3 landings of (12 - 2) rows: 30 steps, 3 paid landings
    assert t == 60 and (rewards == 6).all()


# --------------------------------------------------------------------------
# the scripted env and the Atari wrappers
# --------------------------------------------------------------------------


def _walk(env, actions):
    out = [env.reset()]
    for a in actions:
        out.append(env.step(a))
    return out


def _assert_walks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            np.testing.assert_array_equal(x[0], y[0])
            assert x[1:] == y[1:]
        else:
            np.testing.assert_array_equal(x, y)


def test_scripted_env_matches_reference():
    for kw in (dict(), dict(obs_shape=(5, 5, 2), episode_len=4, rewards=[1.0, -0.5])):
        _assert_walks_equal(_walk(ScriptedEnv(**kw), range(11)),
                            _walk(RefScriptedEnv(**kw), range(11)))
    cfg = tiny_test().replace(env_name="scripted:6")
    env = make_env(cfg)
    ref = jax_make_env(jax_tiny_test().replace(env_name="scripted:6"))
    assert env.action_dim == ref.action_dim == 6
    _assert_walks_equal(_walk(env, [0] * 10), _walk(ref, [0] * 10))


class _FakeGym:
    """A gymnasium-protocol env with seeded 210x160 grayscale frames."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.action_space = "Discrete(4)"
        self.t = 0

    def _frame(self):
        return self.rng.integers(0, 256, size=(210, 160), dtype=np.uint8)

    def reset(self):
        self.t = 0
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        return self._frame(), float(action) - 1.0, self.t % 7 == 0, self.t % 11 == 0, {}


def test_warp_frame_and_noop_reset_match_reference():
    port = NoopReset(WarpFrame(_FakeGym(0)), noop_max=5, seed=3)
    ref = RefNoopReset(RefWarpFrame(_FakeGym(0)), noop_max=5, seed=3)
    assert port.obs_shape == ref.obs_shape == (84, 84, 1)
    for _ in range(3):
        _assert_walks_equal(_walk(port, [1, 2, 0, 3, 1, 1, 2]),
                            _walk(ref, [1, 2, 0, 3, 1, 1, 2]))
    # NoopReset over the scripted env: the same NOOP counts, the same frames
    envs = ScriptedEnv(episode_len=4), RefScriptedEnv(episode_len=4)
    for env in envs:
        env.action_space = "Discrete(4)"  # what NoopReset passes through
    _assert_walks_equal(_walk(NoopReset(envs[0], noop_max=9, seed=1), [0] * 5),
                        _walk(RefNoopReset(envs[1], noop_max=9, seed=1), [0] * 5))


def test_an_atari_name_fails_as_in_the_reference_without_ale():
    """Any other env name is an ALE game; where ALE is missing both packages
    raise the same error from gymnasium (or an ImportError without it)."""
    errors = []
    for build in (lambda: make_env(tiny_test().replace(env_name="Pong")),
                  lambda: jax_make_env(jax_tiny_test().replace(env_name="Pong"))):
        with pytest.raises(Exception) as e:
            build()
        errors.append(type(e.value))
    assert errors[0] is errors[1]


# --------------------------------------------------------------------------
# the preset
# --------------------------------------------------------------------------


def test_long_context_preset_matches_the_jax_preset():
    cfg, jcfg = PRESETS["long_context"](), jax_long_context()
    for f in ("env_name", "obs_shape", "action_dim", "max_episode_steps", "encoder",
              "impala_channels", "hidden_dim", "recurrent_core", "lr_schedule",
              "burn_in_steps", "learning_steps", "forward_steps", "block_length",
              "buffer_capacity", "compute_dtype", "lru_chunk", "lru_r_min", "lru_r_max",
              "use_native_replay", "batch_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.seq_len == 581 and cfg.max_episode_steps == 768
    # the LRU acts from a float32 carry whatever the compute dtype, as JAX's
    assert cfg.carry_dtype == torch.float32 and PRESETS["atari"]().carry_dtype == torch.bfloat16
    assert cfg.resolve_backward_arm(device="cuda") == ("default", 0)
    assert long_context("catch", (12, 12, 1)).max_episode_steps == 10
    with pytest.raises(ValueError, match="lru_chunk"):
        tiny_test().replace(lru_chunk=8)
    with pytest.raises(ValueError, match="pallas"):
        cfg.replace(lstm_backend="pallas")
    with pytest.raises(ValueError, match="ring"):
        cfg.replace(lru_r_min=0.99, lru_r_max=0.9)


# --------------------------------------------------------------------------
# the slice against the JAX package
# --------------------------------------------------------------------------

SLICE = dict(env_name="memory_catch:2:1:3", encoder="impala", impala_channels=(16, 32, 32),
             recurrent_core="lru", lr_schedule="cosine", training_steps=6, save_interval=3,
             log_interval=0.0, learning_starts=48)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("long_context_twins")
    jcfg = jax_tiny_test().replace(use_native_replay=False, checkpoint_dir=str(tmp / "jax"),
                                   metrics_path=str(tmp / "jax.jsonl"), **SLICE)
    cfg = tiny_test().replace(checkpoint_dir=str(tmp / "port"),
                              metrics_path=str(tmp / "port.jsonl"), **SLICE)
    env = dict(num_envs=2, height=12, width=12, seed=5, **catch_params(SLICE["env_name"]))
    jtr = JaxTrainer(jcfg, vec_env=CatchVecEnv(**env))
    ptr = Trainer(cfg, vec_env=CatchVecEnv(**env), device="cpu")
    _load_flax(ptr, _np_tree(jtr.state.params))
    lstm_kernel.reset_launch_counts()
    jtr.run_inline()
    ptr.run_inline()
    jtr.metrics.close()
    ptr.metrics_logger.close()
    return jtr, ptr


def test_slice_matches_jax_record_by_record(twins):
    jtr, ptr = twins
    assert ptr.replay.native is not None and jtr.replay.native is None
    assert not any(lstm_kernel.launch_counts.values())  # the LRU reaches no LSTM kernel
    jrecs = [json.loads(line) for line in open(jtr.cfg.metrics_path)]
    precs = [json.loads(line) for line in open(ptr.cfg.metrics_path)]
    assert len(jrecs) == len(precs) == 6
    assert sum(r["episodes"] for r in precs) > 0
    for j, p in zip(jrecs, precs):
        for k in ("step", "env_steps", "replay_size", "episodes", "backward_arm"):
            assert p[k] == j[k], (k, p, j)
        for k in ("loss", "q_mean"):
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_slice_saves_the_same_steps_and_state(twins):
    jtr, ptr = twins
    assert jax_list_checkpoint_steps(jtr.cfg.checkpoint_dir) == [3, 6]
    assert list_checkpoint_steps(ptr.cfg.checkpoint_dir) == [3, 6]
    jstate, j_env, _ = jax_restore_checkpoint(jtr.cfg.checkpoint_dir, jtr.state, 6)
    _, template = init_train_state(ptr.cfg, "cpu", seed=1)
    pstate, p_env, _ = restore_checkpoint(ptr.cfg.checkpoint_dir, template, 6)
    assert int(jstate.step) == pstate.step == 6 and j_env == p_env
    _assert_trees_close(_port_tree(pstate.net), _np_tree(jstate.params)["params"], "params")
    _assert_trees_close(_port_tree(pstate.target_net), _np_tree(jstate.target_params)["params"],
                        "target")
    names = [n for n, _ in pstate.net.named_parameters()]
    mu, nu, count = adam_state_to_optax(pstate.optimizer.state_dict(), names)
    jmu, jnu, jcount = _optax_adam(_np_tree(jstate.opt_state))
    assert int(count) == int(jcount) == 6
    _assert_trees_close(mu["params"], jmu["params"], "mu")
    _assert_trees_close(nu["params"], jnu["params"], "nu")


def test_slice_adam_state_round_trips_bitwise(twins):
    """JAX's Adam state over the IMPALA + LRU tree (ResidualBlock_j/Conv_k,
    the LRU's parameters) into the port's optimizer and back, bit for bit."""
    jtr, ptr = twins
    mu, nu, count = _optax_adam(_np_tree(jtr.state.opt_state))
    _, state = init_train_state(ptr.cfg, "cpu", seed=1)
    names = [n for n, _ in state.net.named_parameters()]
    sd = adam_state_from_optax(state.optimizer.state_dict(), names, mu, nu, count)
    state.optimizer.load_state_dict(sd)  # every name and shape lines up
    mu2, nu2, count2 = adam_state_to_optax(sd, names)
    assert int(count2) == int(count) == 6
    for a, b in ((mu2, mu), (nu2, nu)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert len(fa) == len(fb)
        for path, v in fa:
            assert v.dtype == fb[path].dtype and np.array_equal(v, fb[path]), path
