"""The port's tensor cores of procmaze and the multi-task family
(r2d2_tpu_torch/envs/{procmaze,keydoor,drift,banditgrid}.py), their
host-protocol adapters and factories, against the JAX package's functional
cores.

The port draws from a torch.Generator where JAX splits keys, so the tests
hand in JAX's own draws, computed from the same keys the JAX cores split:
procmaze's wall uniforms, start, goal and bend coin, keydoor's colour,
drift's reset columns and per-step move, banditgrid's per-step normal.
Given them, reset, step and render are JAX's bit for bit over random action
streams (out-of-range actions of a padded union space included), and so
is FnVecEnv's auto-reset against JAX's FnVecEnv. The name parsers, the
factories and the geometry errors are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.envs import make_env as jax_make_env
from r2d2_tpu.envs.banditgrid import BanditGridEnv as RefBandit
from r2d2_tpu.envs.banditgrid import banditgrid_params as ref_banditgrid_params
from r2d2_tpu.envs.drift import DriftEnv as RefDrift
from r2d2_tpu.envs.drift import drift_params as ref_drift_params
from r2d2_tpu.envs.functional import FnVecEnv as RefFnVecEnv
from r2d2_tpu.envs.keydoor import KeyDoorEnv as RefKeyDoor
from r2d2_tpu.envs.keydoor import keydoor_params as ref_keydoor_params
from r2d2_tpu.envs.procmaze import ProcMazeEnv as RefProcMaze
from r2d2_tpu.envs.procmaze import procmaze_params as ref_procmaze_params
from r2d2_tpu.train import build_fn_env as jax_build_fn_env
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs import is_multitask_family_name, make_env
from r2d2_tpu_torch.envs.banditgrid import BanditGridEnv, banditgrid_params, is_banditgrid_name
from r2d2_tpu_torch.envs.drift import DriftEnv, drift_params, is_drift_name
from r2d2_tpu_torch.envs.functional import FnHostEnv, FnVecEnv
from r2d2_tpu_torch.envs.keydoor import KeyDoorEnv, is_keydoor_name, keydoor_params
from r2d2_tpu_torch.envs.procmaze import (
    ProcMazeEnv,
    build_procmaze_env,
    is_procmaze_name,
    procmaze_geometry,
    procmaze_params,
)
from r2d2_tpu_torch.train import build_fn_env, build_vec_env

torch.set_num_threads(1)

E = 24
STEPS = 40


# --------------------------------------------------------------------------
# JAX's draws, from the keys its cores split
# --------------------------------------------------------------------------


def _procmaze_level(env, key):
    kw, ks, kg, kb = jax.random.split(key, 4)
    g = env.g
    return (jax.random.uniform(kw, (g, g)), jax.random.randint(ks, (2,), 0, g),
            jax.random.randint(kg, (2,), 0, g), jax.random.bernoulli(kb))


def _reset_draws(kind, env, key):
    """The draws JAX's reset(key) takes, for the port's reset(draws=)."""
    if kind == "procmaze":
        return _procmaze_level(env, jax.random.split(key)[1])
    if kind == "keydoor":
        return jax.random.randint(jax.random.split(key)[1], (), 0, env.colors)
    if kind == "drift":
        _, kp, kt = jax.random.split(key, 3)
        return (jax.random.randint(kp, (), 0, env.w), jax.random.randint(kt, (), 0, env.w))
    return None


def _step_draws(kind, key):
    """The draw JAX's step takes from a state's key (drift, banditgrid)."""
    sub = jax.random.split(key)[1]
    if kind == "drift":
        return jax.random.randint(sub, (), -1, 2)
    if kind == "banditgrid":
        return jax.random.normal(sub)
    return None


def _to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(torch.from_numpy(np.array(x)) for x in tree)
    return torch.from_numpy(np.array(tree))


def _vdraws(fn, keys):
    return None if fn(keys[0]) is None else jax.vmap(fn)(keys)


def _state_of(port_cls, jstate):
    """A JAX state's fields (its key dropped) as the port's state."""
    return port_cls(*(torch.from_numpy(np.array(getattr(jstate, f)))
                      for f in port_cls._fields))


def _assert_state(port_state, jstate, what=""):
    for f in type(port_state)._fields:
        np.testing.assert_array_equal(getattr(port_state, f).numpy(),
                                      np.asarray(getattr(jstate, f)), err_msg=f"{what}{f}")


CORES = {
    "procmaze": (lambda: RefProcMaze(16, 4, 24), lambda: ProcMazeEnv(16, 4, 24)),
    "procmaze_shaped8": (lambda: RefProcMaze(8, 2, 24, shaping_coef=0.02),
                         lambda: ProcMazeEnv(8, 2, 24, shaping_coef=0.02)),
    "keydoor": (lambda: RefKeyDoor(12, 12, length=4, num_colors=3, cue_steps=2, horizon=20),
                lambda: KeyDoorEnv(12, 12, length=4, num_colors=3, cue_steps=2, horizon=20)),
    "drift": (lambda: RefDrift(12, 12, drift_every=1), lambda: DriftEnv(12, 12, drift_every=1)),
    "banditgrid": (lambda: RefBandit(12, 12, grid=4, horizon=16),
                   lambda: BanditGridEnv(12, 12, grid=4, horizon=16)),
}


def _kind(name):
    return "procmaze" if name.startswith("procmaze") else name.partition(":")[0]


@pytest.mark.parametrize("name", sorted(CORES))
def test_core_matches_jax_bit_for_bit_from_its_draws(name):
    kind = _kind(name)
    ref, port = (make() for make in CORES[name])
    keys = jax.random.split(jax.random.PRNGKey(len(name)), E)
    rs = jax.vmap(ref.reset)(keys)
    ps = port.reset(E, draws=_to_torch(_vdraws(lambda k: _reset_draws(kind, ref, k), keys)))
    _assert_state(ps, rs, "reset ")
    rng = np.random.default_rng(len(name))
    # op by op, as the draws above: inside one jitted program XLA may
    # contract the normal's polynomial differently (a last-bit change)
    vstep, vrender = jax.vmap(ref.step), jax.vmap(ref.render)
    ends = 0
    for t in range(STEPS):
        np.testing.assert_array_equal(port.render(ps).numpy(), np.asarray(vrender(rs)))
        # actions over the padded union space (5): the extra ones are NOOPs
        a = rng.integers(0, 5, E).astype(np.int32)
        step_draws = _to_torch(_vdraws(lambda k: _step_draws(kind, k), rs.key))
        rs, r_rew, r_done = vstep(rs, jnp.asarray(a))
        ps, p_rew, p_done = port.step(ps, torch.from_numpy(a), draws=step_draws)
        np.testing.assert_array_equal(p_rew.numpy(), np.asarray(r_rew), err_msg=f"step {t}")
        np.testing.assert_array_equal(p_done.numpy(), np.asarray(r_done), err_msg=f"step {t}")
        assert p_rew.dtype == torch.float32 and p_done.dtype == torch.bool
        _assert_state(ps, rs, f"step {t} ")
        ends += int(np.asarray(r_done).sum())
    if kind == "drift":
        assert ends == 0  # a continuing env never ends
    else:
        assert ends > 0


@pytest.mark.parametrize("name", ["procmaze:8", "keydoor:4:3", "drift:1", "banditgrid:3:6"])
def test_fn_vec_env_auto_reset_matches_jax_from_its_draws(name):
    """The port's FnVecEnv against JAX's, E envs on the same actions, the
    step and fresh-episode draws JAX took handed in: terminal frames,
    rewards, dones, the next frames and the states bit for bit."""
    kind = _kind(name)
    obs = (16, 16, 3) if kind == "procmaze" else (12, 12, 1)
    jcfg = jax_tiny_test().replace(env_name=name, obs_shape=obs, max_episode_steps=12)
    cfg = tiny_test().replace(env_name=name, obs_shape=obs, max_episode_steps=12)
    n = 6
    ref = RefFnVecEnv(jax_build_fn_env(jcfg), num_envs=n, seed=3)
    port = build_vec_env(cfg.replace(num_actors=n), seed=3)
    assert isinstance(port, FnVecEnv) and port.obs_shape == ref.obs_shape
    assert port.action_dim == ref.action_dim
    state_cls = type(port._state)
    port._state = _state_of(state_cls, ref._state)
    rng = np.random.default_rng(1)
    dones = 0
    for t in range(30):
        a = rng.integers(0, port.action_dim, n).astype(np.int32)
        step_d = _to_torch(_vdraws(lambda k: _step_draws(kind, k), ref._state.key))
        # the key JAX's auto-reset splits: the stepped state's key
        stepped = ref._state.key if kind in ("procmaze", "keydoor") else jax.vmap(
            lambda k: jax.random.split(k)[0])(ref._state.key)
        subs = jax.vmap(lambda k: jax.random.split(k)[1])(stepped)
        reset_d = _to_torch(_vdraws(lambda k: _reset_draws(kind, port.env, k), subs))
        want = ref.step(a)
        got = port.step(a, draws=(step_d, reset_d))
        for g, w, what in zip(got, want, ("term_obs", "reward", "done", "next_obs")):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"step {t} {what}")
        _assert_state(port._state, ref._state, f"step {t} ")
        dones += int(np.asarray(want[2]).sum())
    assert (dones == 0) == (kind == "drift")


@pytest.mark.parametrize("name", ["procmaze", "keydoor", "drift", "banditgrid:3:5"])
def test_fn_host_env_and_make_env_build_the_jax_geometry(name):
    """make_env routes each family name to FnHostEnv over its core with the
    factory's arguments (JAX's); the single-env protocol equals the core's
    own steps from the same generator."""
    obs = (64, 64, 3) if name == "procmaze" else (12, 12, 1)
    cfg = tiny_test().replace(env_name=name, obs_shape=obs, max_episode_steps=40)
    jcfg = jax_tiny_test().replace(env_name=name, obs_shape=obs, max_episode_steps=40)
    host, ref = make_env(cfg, seed=5), jax_make_env(jcfg, seed=5)
    assert isinstance(host, FnHostEnv)
    assert host.obs_shape == ref.obs_shape and host.action_dim == ref.action_dim
    for attr in ("g", "cell", "horizon", "density", "shaping", "h", "w", "length", "colors",
                 "cue", "every", "noise"):
        if hasattr(ref.env, attr):
            assert getattr(host.env, attr) == getattr(ref.env, attr), attr
    twin = build_fn_env(cfg)
    gen = torch.Generator().manual_seed(5)
    s = twin.reset(1, gen)
    o = host.reset()
    assert o.shape == host.obs_shape and o.dtype == np.uint8
    np.testing.assert_array_equal(o, twin.render(s)[0].numpy())
    for t in range(20):
        a = t % host.action_dim
        o, r, d, _ = host.step(a)
        s, tr, td = twin.step(s, torch.tensor([a], dtype=torch.int32), gen)
        np.testing.assert_array_equal(o, twin.render(s)[0].numpy())
        assert isinstance(r, float) and r == float(tr[0]) and d == bool(td[0])
        if d:
            break


def test_generator_draws_are_reproducible_and_in_range():
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    maze = ProcMazeEnv(16, 4, 96)
    a, b = maze.reset(256, g()), maze.reset(256, g())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not (a.agent == a.goal).all(-1).any()
    assert 0.15 < a.walls.float().mean() < 0.3  # density 0.3 minus the corridors
    assert not a.walls[torch.arange(256), a.agent[:, 0], a.agent[:, 1]].any()
    kd = KeyDoorEnv(12, 12, length=4, num_colors=3)
    colors = kd.reset(512, g()).color
    assert set(colors.tolist()) == {0, 1, 2}
    dr = DriftEnv(12, 12, drift_every=1)
    s = dr.reset(512, g())
    assert (s.pos >= 0).all() and (s.pos < 12).all() and len(torch.unique(s.target)) == 12
    s2, _, _ = dr.step(s, torch.zeros(512, dtype=torch.int32), g())
    assert set((s2.target - s.target).tolist()) <= {-1, 0, 1}
    bg = BanditGridEnv(12, 12, grid=4, horizon=16)
    _, r, _ = bg.step(bg.reset(4096), torch.full((4096,), 2, dtype=torch.int32), g())
    # the cell (1, 0) pays 1/6 plus noise of sigma 0.5
    assert abs(float(r.mean()) - 1 / 6) < 0.05 and abs(float(r.std()) - 0.5) < 0.05


NAMES = ["procmaze", "procmaze_shaped", "procmaze:8", "procmaze_shaped:4", "keydoor",
         "keydoor:4", "keydoor:5:3", "keydoor:6:2:3", "drift", "drift:1", "drift:5",
         "banditgrid", "banditgrid:6", "banditgrid:3:9", "catch", "MsPacman"]
BAD = ["procmaze:1", "keydoor:1", "keydoor:4:1", "keydoor:4:2:0", "keydoor:1:2:3:4",
       "drift:0", "banditgrid:1", "banditgrid:4:1", "banditgrid:4:4:4"]
PARSERS = [(procmaze_params, ref_procmaze_params, is_procmaze_name),
           (keydoor_params, ref_keydoor_params, is_keydoor_name),
           (drift_params, ref_drift_params, is_drift_name),
           (banditgrid_params, ref_banditgrid_params, is_banditgrid_name)]


def _outcome(fn, name):
    try:
        return fn(name)
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("name", NAMES + BAD)
def test_name_parsers_match_jax(name):
    for port, ref, is_name in PARSERS:
        assert _outcome(port, name) == _outcome(ref, name)
        if not is_name(name):
            assert _outcome(port, name)[0] == "raises"
    assert is_multitask_family_name(name) == (
        is_keydoor_name(name) or is_drift_name(name) or is_banditgrid_name(name))


GEOMETRY = [
    ("keydoor", (12, 12, 1), 100), ("keydoor:8", (12, 6, 1), 100),
    ("keydoor:6", (2, 12, 1), 100), ("keydoor:6", (12, 12, 1), 5),
    ("drift", (1, 12, 1), 100), ("drift", (12, 2, 1), 100), ("drift:3", (12, 12, 1), 1),
    ("banditgrid:5", (4, 12, 1), 100), ("banditgrid", (12, 12, 1), 1),
    ("banditgrid", (12, 12, 1), 2), ("catch", (12, 12, 1), 5),
]


@pytest.mark.parametrize("name,obs,cap", GEOMETRY)
def test_geometry_validation_matches_jax(name, obs, cap):
    def check(make):
        try:
            make().replace(env_name=name, obs_shape=obs, max_episode_steps=cap)
            return None
        except ValueError as e:
            return str(e)

    assert check(tiny_test) == check(jax_tiny_test)


def test_factories_and_core_errors():
    assert procmaze_geometry((64, 64, 3), 96) == (16, 4, 96)
    assert procmaze_geometry((64, 64, 3), 96, grid=8) == (8, 8, 96)
    for bad in ((64, 32, 3), (64, 64, 1)):
        with pytest.raises(ValueError, match="square 3-channel"):
            procmaze_geometry(bad, 96)
    with pytest.raises(ValueError, match="not divisible"):
        procmaze_geometry((64, 64, 3), 96, grid=6)
    maze = build_procmaze_env((64, 64, 3), 96, "procmaze_shaped:8")
    assert (maze.g, maze.cell, maze.shaping) == (8, 8, 0.02)
    cfg = tiny_test()
    for name, cls, n in (("procmaze", ProcMazeEnv, 5), ("keydoor:4:3", KeyDoorEnv, 6),
                         ("drift", DriftEnv, 3), ("banditgrid", BanditGridEnv, 5)):
        obs = (16, 16, 3) if cls is ProcMazeEnv else cfg.obs_shape
        c = cfg.replace(env_name=name, obs_shape=obs)
        core = build_fn_env(c)
        ref = jax_build_fn_env(jax_tiny_test().replace(env_name=name, obs_shape=obs))
        assert isinstance(core, cls) and core.NUM_ACTIONS == ref.NUM_ACTIONS == n
        assert {k: getattr(core, k) for k in vars(ref)} == vars(ref)  # the same geometry
        assert isinstance(build_vec_env(c.replace(num_actors=3)), FnVecEnv)
    for make, msg in ((lambda: KeyDoorEnv(12, 3, length=4), "cannot render"),
                      (lambda: KeyDoorEnv(2, 12), "height >= 3"),
                      (lambda: KeyDoorEnv(12, 12, length=6, horizon=5), "ends before the door"),
                      (lambda: DriftEnv(1, 12), "height >= 2"),
                      (lambda: DriftEnv(12, 2), "width >= 3"),
                      (lambda: BanditGridEnv(3, 12, grid=4), "cannot render"),
                      (lambda: BanditGridEnv(12, 12, horizon=1), "horizon must be >= 2")):
        with pytest.raises(ValueError, match=msg):
            make()
