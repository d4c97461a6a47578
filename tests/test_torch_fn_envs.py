"""The port's tensor env cores (envs/catch.TensorCatchEnv, envs/fake.
ScriptedFnEnv), their host-protocol adapters (envs/functional.py) and
train.build_fn_env, against the JAX package's functional cores and the
port's numpy env.

From equal states, step and render are JAX's CatchEnv's and the numpy
CatchEnv's bit for bit, for every catch variant; the reset and respawn
columns are handed in (JAX's own draws) or drawn from a torch.Generator
within the variant's ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.envs.catch import CatchEnv as RefCatchEnv
from r2d2_tpu.envs.catch import CatchState as RefCatchState
from r2d2_tpu.envs.fake import ScriptedFnEnv as RefScriptedFnEnv
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import CatchEnv, CatchState, TensorCatchEnv, catch_params
from r2d2_tpu_torch.envs.fake import ScriptedEnv, ScriptedFnEnv
from r2d2_tpu_torch.envs.functional import FnHostEnv, FnVecEnv, select_rows
from r2d2_tpu_torch.train import build_fn_env

torch.set_num_threads(1)

VARIANTS = ["catch", "memory_catch", "memory_catch:5:3", "memory_catch:2:1:3",
            "memory_catch:3:2:2"]


def _states(size, name, E, seed):
    rng = np.random.default_rng(seed)
    balls = catch_params(name).get("balls", 1)
    return CatchState(
        ball_x=rng.integers(0, size, E).astype(np.int32),
        ball_y=rng.integers(0, size - 2, E).astype(np.int32),
        paddle_x=rng.integers(0, size, E).astype(np.int32),
        t=rng.integers(0, 20, E).astype(np.int32),
        balls_left=rng.integers(1, balls + 1, E).astype(np.int32),
    )


def _tensor(s):
    return CatchState(*(torch.from_numpy(np.asarray(v, np.int32)) for v in s))


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("size", [12, 84])
def test_step_and_render_match_jax_and_numpy(name, size):
    kw = catch_params(name)
    ref, host, port = RefCatchEnv(size, size, **kw), CatchEnv(size, size, **kw), \
        TensorCatchEnv(size, size, **kw)
    rng = np.random.default_rng(size)
    E = 48
    s = _states(size, name, E, size + len(name))
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    rs = RefCatchState(*(jnp.asarray(v) for v in (s.ball_x, s.ball_y, s.paddle_x)),
                       keys, jnp.asarray(s.t), jnp.asarray(s.balls_left))
    ts, hs = _tensor(s), s
    for _ in range(12):
        np.testing.assert_array_equal(port.render(ts).numpy(),
                                      np.asarray(jax.vmap(ref.render)(rs)))
        np.testing.assert_array_equal(port.render(ts).numpy(), host.render(hs))
        actions = rng.integers(0, 3, E).astype(np.int32)
        rs, r_rew, r_done = jax.vmap(ref.step)(rs, jnp.asarray(actions))
        # JAX's respawn columns, handed in (only read where a ball respawns)
        respawn = torch.from_numpy(np.array(rs.ball_x, np.int32))
        ts, t_rew, t_done = port.step(ts, torch.from_numpy(actions), respawn=respawn)
        np.testing.assert_array_equal(t_rew.numpy(), np.asarray(r_rew, np.float32))
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(r_done))
        for f in ("ball_x", "ball_y", "paddle_x", "t", "balls_left"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(rs, f)),
                                          err_msg=f)
        hs, h_rew, h_done = host.step(hs, actions, np.random.default_rng(0))
        landed = np.asarray(r_rew) != 0
        np.testing.assert_array_equal(h_rew, t_rew.numpy())
        np.testing.assert_array_equal(h_done, t_done.numpy())
        # the numpy core draws its own respawn columns: hold it on the rest
        for f in ("ball_y", "paddle_x", "t", "balls_left"):
            np.testing.assert_array_equal(getattr(hs, f), getattr(ts, f).numpy(), err_msg=f)
        hs = hs._replace(ball_x=np.where(landed, ts.ball_x.numpy(), hs.ball_x).astype(np.int32))
        # restart finished rows from the same fresh states on all three
        done = np.asarray(r_done)
        if done.any():
            fresh = _states(size, name, E, int(rng.integers(1 << 30)))
            fresh = fresh._replace(ball_y=np.zeros(E, np.int32), t=np.zeros(E, np.int32))
            ts = select_rows(torch.from_numpy(done), _tensor(fresh), ts)
            hs = CatchState(*(np.where(done, f, o).astype(np.int32) for f, o in zip(fresh, hs)))
            rs = rs._replace(**{f: jnp.asarray(getattr(hs, f)) for f in CatchState._fields})


@pytest.mark.parametrize("name", VARIANTS)
def test_resets_take_jax_columns_or_draw_within_its_ranges(name):
    size, E = 84, 256
    kw = catch_params(name)
    ref, port = RefCatchEnv(size, size, **kw), TensorCatchEnv(size, size, **kw)
    rs = jax.vmap(ref.reset)(jax.random.split(jax.random.PRNGKey(3), E))
    given = port.reset(E, draws=(torch.from_numpy(np.asarray(rs.ball_x)),
                                 torch.from_numpy(np.asarray(rs.paddle_x))))
    for f in ("ball_x", "ball_y", "paddle_x", "t", "balls_left"):
        np.testing.assert_array_equal(getattr(given, f).numpy(), np.asarray(getattr(rs, f)))
    a = port.reset(E, torch.Generator().manual_seed(5))
    b = port.reset(E, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (a.ball_x >= 0).all() and (a.ball_x < size).all()
    assert (a.paddle_x >= 0).all() and (a.paddle_x < size).all()
    if ref.cue is not None:
        reach = max(2 * (size - 2 - ref.cue) * ref.fall - 4, 1)
        assert ((a.paddle_x - a.ball_x).abs() <= reach).all()
    assert len(torch.unique(a.ball_x)) > 40  # spread over the row


def test_multi_ball_respawns_from_the_generator_stay_reachable():
    size, name = 84, "memory_catch:2:1:3"
    port = TensorCatchEnv(size, size, **catch_params(name))
    s = port.reset(512, torch.Generator().manual_seed(0))
    s = s._replace(ball_y=torch.full_like(s.ball_y, size - 3))  # every ball lands now
    g = torch.Generator().manual_seed(1)
    s2, rew, done = port.step(s, torch.zeros(512, dtype=torch.int32), generator=g)
    assert not done.any() and (rew != 0).all()
    reach = max(2 * (size - 2 - 2) - 4, 1)
    assert ((s2.ball_x - s2.paddle_x).abs() <= reach).all()
    assert (s2.ball_y == 0).all() and (s2.t == 0).all() and (s2.balls_left == 2).all()


def test_scripted_fn_env_matches_jax_and_the_host_script():
    E, ep = 3, 5
    ref, port = RefScriptedFnEnv(episode_len=ep), ScriptedFnEnv(episode_len=ep)
    host = [ScriptedEnv(episode_len=ep) for _ in range(E)]
    rs = jax.vmap(ref.reset)(jax.random.split(jax.random.PRNGKey(0), E))
    ts = port.reset(E)
    obs = [h.reset() for h in host]
    for _ in range(ep):
        np.testing.assert_array_equal(port.render(ts).numpy(),
                                      np.asarray(jax.vmap(ref.render)(rs)))
        np.testing.assert_array_equal(port.render(ts).numpy(), np.stack(obs))
        a = np.zeros(E, np.int32)
        rs, rr, rd = jax.vmap(ref.step)(rs, jnp.asarray(a))
        ts, tr, td = port.step(ts, torch.from_numpy(a))
        out = [h.step(0) for h in host]
        obs = [o[0] for o in out]
        np.testing.assert_array_equal(tr.numpy(), np.asarray(rr))
        np.testing.assert_array_equal(tr.numpy(), np.asarray([o[1] for o in out], np.float32))
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    assert td.all() and port.NUM_ACTIONS == 4


def test_fn_vec_env_auto_resets_and_keeps_the_terminal_frame():
    env = FnVecEnv(ScriptedFnEnv(episode_len=3), num_envs=2, seed=0)
    assert env.obs_shape == (12, 12, 1) and env.action_dim == 4
    obs = env.reset_all()
    assert (obs == 0).all()
    for t in range(3):
        term, rew, done, nxt = env.step(np.zeros(2, np.int32))
        assert (term == t + 1).all() and rew.dtype == np.float64
    assert done.all() and (nxt == 0).all()  # the fresh episode's first frame
    cat = FnVecEnv(TensorCatchEnv(12, 12), num_envs=4, seed=1)
    for _ in range(10):
        term, rew, done, nxt = cat.step(np.ones(4, np.int32))
    assert done.all() and (rew != 0).all() and term.shape == (4, 12, 12, 1)
    assert (nxt[:, :3].max(axis=(1, 2, 3)) == 255).all()  # new balls at the top


def test_fn_host_env_speaks_the_single_env_protocol():
    env = FnHostEnv(TensorCatchEnv, (12, 12), seed=2, kwargs={"cue_steps": 3})
    assert env.obs_shape == (12, 12, 1) and env.action_dim == 3
    obs = env.reset()
    assert obs.shape == (12, 12, 1) and obs.dtype == np.uint8
    for i in range(10):
        obs, rew, done, _ = env.step(0)
    assert done and rew in (1.0, -1.0) and isinstance(rew, float)


def test_build_fn_env_names_catch_and_scripted_only():
    cfg = tiny_test()
    assert isinstance(build_fn_env(cfg.replace(env_name="catch")), TensorCatchEnv)
    mc = build_fn_env(cfg.replace(env_name="memory_catch:3:1:2", max_episode_steps=40))
    assert (mc.cue, mc.balls) == (3, 2)
    sc = build_fn_env(cfg.replace(env_name="scripted:5"))
    assert isinstance(sc, ScriptedFnEnv) and sc.NUM_ACTIONS == 5
    with pytest.raises(ValueError, match="no tensor core"):
        build_fn_env(cfg.replace(env_name="MsPacman"))
