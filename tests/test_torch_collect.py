"""The port's on-device collector (r2d2_tpu_torch/collect.py) against the
port's host actor path and the JAX package's collect core.

On identical trajectories (the scripted env's host and tensor twins, or
catch from the same states with the host actor's own ε draws handed in) a
chunk's blocks are the host VectorizedActor + SequenceAccumulator blocks:
frames, actions, counters and stored carries bit for bit, n-step returns
and bootstrap discounts bit for bit, initial priorities to 1e-6 relative
(a float32 sum order). Fed JAX's per-step draws and reset columns, a chunk
matches JAX's collect core (rtol 1e-4 / atol 1e-5 on the float fields;
the actions and every integer field equal). Episodes longer than a chunk
carry across it; resync and the preemption carry restore the stream.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.collect import make_collect_fn as jax_collect_fn
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.envs.catch import CatchEnv as RefCatchEnv
from r2d2_tpu.envs.fake import ScriptedFnEnv as RefScriptedFnEnv
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu_torch.actor import HostEnvPool, ParamStore, VectorizedActor
from r2d2_tpu_torch.collect import (
    CollectDraws,
    DeviceCollector,
    GivenDraws,
    initial_collect_carry,
    make_collect_fn,
)
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import CatchState, CatchVecEnv, TensorCatchEnv
from r2d2_tpu_torch.envs.fake import ScriptedEnv, ScriptedFnEnv
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.models.r2d2 import R2D2Network, init_params
from r2d2_tpu_torch.replay.block import to_state_host
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer

torch.set_num_threads(1)

E = 3


def _cfg(**kw):
    base = dict(block_length=12, buffer_capacity=624, learning_starts=24, num_actors=E,
                max_episode_steps=12, replay_plane="device")
    base.update(kw)
    return tiny_test().replace(**base)


def _host_blocks(cfg, net, env, epsilons, steps, seed=7, on_start=None):
    pushed = []
    actor = VectorizedActor(cfg, copy.deepcopy(net), ParamStore(net), env, epsilons,
                            lambda b, p, r: pushed.append((b, p, r)), seed=seed, device="cpu")
    if on_start is not None:
        on_start()  # the actor's first episodes have been reset
    for _ in range(steps):
        actor.step()
    return pushed


def _host_draws(seed, steps, n, num_actions):
    """The host actor's ε coins and random actions, step by step."""
    rng = np.random.default_rng(seed)
    u, a = [], []
    for _ in range(steps):
        u.append(rng.random(n).astype(np.float32))
        a.append(rng.integers(0, num_actions, size=n))
    return np.stack(u), np.stack(a)


def _compare(cfg, out, pushed):
    fields, prios, num_seq, sizes, dones, ep_rewards, _ = out
    for i, (block, host_prios, ep_reward) in enumerate(pushed):
        size, ns = int(sizes[i]), int(num_seq[i])
        assert size == len(block.action) and ns == block.num_sequences
        obs = fields["obs"][i].numpy()
        np.testing.assert_array_equal(obs[: size + 1], block.obs)
        assert not obs[size + 1:].any()  # zero padding past the stored entries
        np.testing.assert_array_equal(fields["last_action"][i, : size + 1].numpy(),
                                      block.last_action.astype(np.int32))
        np.testing.assert_array_equal(fields["last_reward"][i, : size + 1].numpy(),
                                      block.last_reward)
        np.testing.assert_array_equal(fields["action"][i, :size].numpy(),
                                      block.action.astype(np.int32))
        np.testing.assert_array_equal(fields["n_step_reward"][i, :size].numpy(),
                                      block.n_step_reward)
        np.testing.assert_array_equal(fields["gamma"][i, :size].numpy(), block.gamma)
        for f, g in (("burn_in", "burn_in_steps"), ("learning", "learning_steps"),
                     ("forward", "forward_steps")):
            np.testing.assert_array_equal(fields[f][i, :ns].numpy(), getattr(block, g))
            assert not fields[f][i, ns:].any()
        np.testing.assert_array_equal(to_state_host(fields["hidden"][i, :ns], cfg.state_dtype),
                                      block.hidden)  # bf16 carries as their bits
        np.testing.assert_allclose(prios[i].numpy(), host_prios, rtol=1e-6, atol=1e-7)
        assert bool(dones[i]) == (ep_reward is not None)
        if ep_reward is not None:
            assert float(ep_rewards[i]) == pytest.approx(ep_reward)


def _net(cfg, seed=0):
    return init_params(cfg, seed, "cpu")


def test_terminal_chunk_is_the_host_actor_blocks():
    cfg = _cfg()
    net = _net(cfg)
    ep = 9
    pushed = _host_blocks(cfg, net, HostEnvPool([ScriptedEnv(episode_len=ep) for _ in range(E)]),
                          np.zeros(E, np.float32), steps=ep)
    assert len(pushed) == E
    fn_env = ScriptedFnEnv(episode_len=ep)
    draws = CollectDraws(torch.Generator().manual_seed(3))
    out = make_collect_fn(cfg, fn_env, E, cfg.block_length)(
        net, fn_env.reset(E), torch.zeros(E), draws)
    assert out[4].all()
    np.testing.assert_array_equal(out[5].numpy(), sum(float(i % 3) for i in range(ep)))
    _compare(cfg, out, pushed)


def test_truncation_chunk_is_the_host_actor_deferred_cut():
    chunk = 7
    cfg = _cfg(max_episode_steps=chunk)
    net = _net(cfg, 1)
    # the host actor takes one more step to flush its deferred cut
    pushed = _host_blocks(cfg, net, HostEnvPool([ScriptedEnv(episode_len=100)
                                                 for _ in range(E)]),
                          np.zeros(E, np.float32), steps=chunk + 1)
    assert len(pushed) == E
    fn_env = ScriptedFnEnv(episode_len=100)
    out = make_collect_fn(cfg, fn_env, E, chunk)(
        net, fn_env.reset(E), torch.zeros(E), CollectDraws(torch.Generator().manual_seed(0)))
    assert not out[4].any() and (out[3] == chunk).all()
    _compare(cfg, out, pushed)
    g = out[0]["gamma"][0].numpy()
    assert g[chunk - 1] == np.float32(cfg.gamma) and g[chunk - 2] == np.float32(cfg.gamma ** 2)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_catch_chunk_is_the_host_actor_on_the_same_trajectories(precision):
    """Catch from the CatchVecEnv's own start states, with the host actor's
    ε coins and random actions handed to the collector: every slot's
    episode-aligned block is the host accumulator's."""
    cfg = _cfg(block_length=16, buffer_capacity=1600, max_episode_steps=16, num_actors=8,
               env_name="catch", action_dim=3, precision=precision)
    net = _net(cfg, 2)
    eps = np.asarray([0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0, 0.2], np.float32)
    vec = CatchVecEnv(8, 12, 12, seed=4)
    starts = []
    pushed = _host_blocks(cfg, net, vec, eps, steps=10, seed=11, on_start=lambda: starts.append(
        CatchState(*(torch.from_numpy(v.copy()) for v in vec._state))))
    start = starts[0]
    assert len(pushed) == 8  # catch episodes last height-2 steps
    u, a = _host_draws(11, cfg.block_length, 8, 3)
    out = make_collect_fn(cfg, TensorCatchEnv(12, 12), 8, cfg.block_length)(
        net, start, torch.from_numpy(eps), GivenDraws(u, a, resets=start))
    _compare(cfg, out, pushed)


def _jax_draws(key, T, n, num_actions):
    """The per-step explore uniforms and random actions of JAX's collect
    core, and the key of its fresh-episode resets."""
    keys = jax.random.split(key, T + 2)
    u, a = [], []
    for t in range(T):
        ke, ka = jax.random.split(keys[t])
        u.append(np.asarray(jax.random.uniform(ke, (n,))))
        a.append(np.asarray(jax.random.randint(ka, (n,), 0, num_actions)))
    return np.stack(u), np.stack(a), keys[T + 1]


@pytest.mark.parametrize("env_name", ["catch", "scripted"])
def test_chunk_matches_jax_collect_core_with_its_draws(env_name):
    n, T = 4, 12
    kw = dict(block_length=12, buffer_capacity=624, num_actors=n, max_episode_steps=12)
    if env_name == "catch":
        ref_env, port_env, A = RefCatchEnv(12, 12), TensorCatchEnv(12, 12), 3
    else:
        ref_env, port_env, A = RefScriptedFnEnv(episode_len=9), ScriptedFnEnv(episode_len=9), 4
    jcfg = jax_tiny_test().replace(action_dim=A, **kw)
    cfg = tiny_test().replace(action_dim=A, **kw)
    jnet, params = jax_init_params(jax.random.PRNGKey(1), jcfg)
    net = R2D2Network.from_config(cfg, device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    env0 = jax.vmap(ref_env.reset)(jax.random.split(jax.random.PRNGKey(2), n))
    key = jax.random.PRNGKey(3)
    eps = np.asarray([0.0, 0.3, 0.6, 1.0], np.float32)
    jout = jax_collect_fn(jcfg, jnet, ref_env, n, T)(params, env0, jnp.asarray(eps), key)
    u, a, kr = _jax_draws(key, T, n, A)
    fresh = jax.vmap(ref_env.reset)(jax.random.split(kr, n))

    def port_state(s):
        if env_name == "catch":
            return CatchState(*(torch.from_numpy(np.array(getattr(s, f), np.int32))
                                for f in CatchState._fields))
        return port_env.reset(n)._replace(t=torch.from_numpy(np.array(s.t, np.int32)))

    pout = make_collect_fn(cfg, port_env, n, T)(
        net, port_state(env0), torch.from_numpy(eps), GivenDraws(u, a, resets=port_state(fresh)))
    jf, jp, jns, jsz, jd, jr = (jout[i] for i in range(6))
    pf, pp, pns, psz, pd, pr, pfresh = pout
    for k in ("obs", "last_action", "action", "burn_in", "learning", "forward"):
        np.testing.assert_array_equal(pf[k].numpy(), np.asarray(jf[k]), err_msg=k)
    for k in ("last_reward", "n_step_reward", "gamma", "hidden"):
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(jf[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-5)
    for got, want in ((pns, jns), (psz, jsz), (pd, jd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6)
    assert all(torch.equal(x, y) for x, y in zip(pfresh, port_state(fresh)))


def test_carry_episodes_across_chunks():
    cfg = _cfg(max_episode_steps=24)  # chunk 12: two-chunk episodes
    net = _net(cfg)
    fn_env = ScriptedFnEnv(episode_len=24, action_dim=cfg.action_dim)
    collect = make_collect_fn(cfg, fn_env, E, 12, carry_episodes=True)
    draws = CollectDraws(torch.Generator().manual_seed(5))
    carry0 = initial_collect_carry(cfg, fn_env, E, draws, "cpu")
    eps = torch.zeros(E)
    f1, _, _, sizes1, dones1, ep1, carry1 = collect(net, carry0, eps, draws)
    assert not dones1.any() and (sizes1 == 12).all()
    np.testing.assert_allclose(carry1.prefix_reward.numpy(), 12.0)
    assert (carry1.env_state.t == 12).all()  # the episode goes on
    f2, _, _, sizes2, dones2, ep2, carry2 = collect(net, carry1, eps, draws)
    assert dones2.all() and (sizes2 == 12).all()
    np.testing.assert_allclose(ep2.numpy(), 24.0)  # the whole episode's return
    np.testing.assert_allclose(carry2.prefix_reward.numpy(), 0.0)
    assert f2["obs"][:, 0].max() == 12  # the seam's frame
    np.testing.assert_array_equal(f2["hidden"][:, 0].numpy(),
                                  torch.stack([carry1.h, carry1.c], 1).numpy())
    np.testing.assert_array_equal(f2["last_action"][:, 0].numpy(), carry1.last_action.numpy())
    np.testing.assert_array_equal(f2["last_reward"][:, 0].numpy(), carry1.last_reward.numpy())
    assert (f2["burn_in"][:, 0] == 0).all()


def _collector(cfg, fn_env, seed=5, **kw):
    net = _net(cfg, 2)
    replay = DeviceReplayBuffer(cfg, "cpu")
    return DeviceCollector(cfg, copy.deepcopy(net), ParamStore(net), fn_env, replay,
                           seed=seed, device="cpu", **kw), replay


def test_collector_feeds_the_device_store_and_carries_mode_end_to_end():
    cfg = _cfg()
    col, replay = _collector(cfg, ScriptedFnEnv(episode_len=9))
    while not replay.can_sample():
        col.step()
    n_ep, r_sum = replay.pop_episode_stats()
    assert n_ep > 0 and r_sum == pytest.approx(n_ep * sum(i % 3 for i in range(9)))
    assert col.total_steps == replay.env_steps and col.steps_per_call == E * 12
    # episodes longer than a chunk carry across it, counted once each
    cfg = _cfg(max_episode_steps=24)
    col, replay = _collector(cfg, ScriptedFnEnv(episode_len=24, action_dim=cfg.action_dim),
                             epsilons=np.zeros(E, np.float32))
    assert col.carry_episodes
    assert col.step() == E * 12 and replay.pop_episode_stats()[0] == 0
    assert col.step() == E * 12
    n_ep, r_sum = replay.pop_episode_stats()
    assert n_ep == E and r_sum == pytest.approx(24.0 * E)
    col.resync()
    assert (col.env_state.env_state.t == 0).all() and (col.env_state.prefix_reward == 0).all()


def test_catch_collector_records_whole_episodes():
    cfg = _cfg(env_name="catch", action_dim=3, block_length=16, buffer_capacity=1600,
               max_episode_steps=16)
    col, replay = _collector(cfg, TensorCatchEnv(12, 12), seed=6)
    assert col.step() == E * 10  # catch episodes last height-2 steps
    assert len(replay) == E * 10 and replay.episode_totals()[0] == E


def test_resync_and_the_preemption_carry_restore_the_stream():
    cfg = _cfg(env_name="catch", action_dim=3, block_length=16, buffer_capacity=1600,
               max_episode_steps=16)
    a, ra = _collector(cfg, TensorCatchEnv(12, 12), seed=8)
    a.step()
    carry = a.carry_state()
    b, rb = _collector(cfg, TensorCatchEnv(12, 12), seed=99)
    b.restore_carry(carry)
    b.total_steps = a.total_steps
    a.step()
    b.step()
    # a's second chunk (slots 3..5) is b's first after the restore (0..2)
    n = a.E
    for k, t in ra.stores.items():
        assert torch.equal(t[n:2 * n], rb.stores[k][:n]), k
    before = a.total_steps
    a.resync()
    a.step()
    assert a.total_steps == before + n * 10
