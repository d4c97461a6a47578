"""The port's dp-sharded fused megastep and priority superstep
(r2d2_tpu_torch/megastep.py: make_sharded_megastep, ShardedFusedRunner,
MultiHostFusedRunner, make_sharded_priority_superstep), mirroring the JAX
package's tests/test_sharded_megastep.py.

The sharded megastep equals its unsharded components: K updates over the
concatenated global batch (rtol 2e-4 / atol 2e-5) and each shard's
collection chunk with its own draws and env slice (bit for bit), the slab
at each shard's reserved slots; tp=2 gives the tp=1 megastep. The runner
advances every shard's ring at reserve time and lands the accounting one
dispatch late. The sharded superstep is its hand-rolled parts bit for bit,
superstep-N is N superstep-1 calls, and given JAX's draws it matches JAX's
sharded superstep (rtol 1e-4 / atol 1e-5). The Trainer runs --mode fused
and priority_plane="device" on the sharded plane, and two gloo ranks run
MultiHostFusedRunner to bit-identical parameters.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.megastep import make_sharded_priority_superstep as jax_sharded_superstep
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.replay.sharded_store import ShardedDeviceReplay as JaxSharded
from bench import synth_block as jax_synth_block
from r2d2_tpu_torch.actor import ParamStore
from r2d2_tpu_torch.collect import CollectDraws, DeviceCollector, make_collect_fn
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import TensorCatchEnv
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    TrainState,
    init_train_state,
    make_multi_update_core,
    make_optimizer,
    make_sharded_fused_multi_train_step,
)
from r2d2_tpu_torch.megastep import (
    ShardedFusedRunner,
    env_rows,
    make_sharded_megastep,
    make_sharded_priority_superstep,
    superstep_generators,
    superstep_uniforms,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.parallel.mesh import make_mesh
from r2d2_tpu_torch.replay import device_sum_tree as dst
from r2d2_tpu_torch.replay.control_plane import shard_config
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from r2d2_tpu_torch.train import Trainer
from torch_multihost_child import synth_block

torch.set_num_threads(1)

DP, K = 4, 2
RTOL, ATOL = 2e-4, 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    return tiny_test().replace(
        env_name="catch", obs_shape=(10, 8, 1), action_dim=3,
        num_actors=8,           # 2 envs per shard
        batch_size=8,           # 2 sequences per shard
        max_episode_steps=8, block_length=16,
        buffer_capacity=1280,   # 80 slots, 20 per shard
        learning_starts=48, collector="device", replay_plane="sharded", dp_size=DP,
        updates_per_dispatch=K, training_steps=4 * K, target_net_update_interval=2,
    ).replace(**kw)


def _mesh(dp=DP, tp=1):
    return make_mesh(dp, ["cpu"] * (dp * tp), tp=tp)


def _filled(cfg, state, fn_env, seed=7, mesh=None):
    replay = ShardedDeviceReplay(cfg, mesh or _mesh())
    col = DeviceCollector(cfg, copy.deepcopy(state.net), ParamStore(state.net), fn_env, replay,
                          seed=seed, device="cpu")
    while not replay.can_sample():
        col.step()
    return replay, col


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    fn_env = TensorCatchEnv(cfg.obs_shape[0], cfg.obs_shape[1])
    _, state = init_train_state(cfg, "cpu")
    return cfg, fn_env, state


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _draws(replay, seed):
    rng = np.random.default_rng(seed)
    draws = [replay.sample_indices(rng) for _ in range(K)]
    return tuple(np.stack([getattr(d, f) for d in draws]) for f in ("b", "s", "is_weights"))


def _assert_states_close(a, b, rtol=RTOL, atol=ATOL):
    for x, y in zip(list(a.net.parameters()) + list(a.target_net.parameters()),
                    list(b.net.parameters()) + list(b.target_net.parameters())):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=rtol, atol=atol)
    assert a.step == b.step


def test_sharded_megastep_equals_unsharded_components(setup):
    cfg, fn_env, state = setup
    E, El = cfg.num_actors, cfg.num_actors // DP
    chunk = min(cfg.block_length, cfg.max_episode_steps)
    bps = cfg.num_blocks // DP
    replay, col = _filled(cfg, state, fn_env)
    before = [{k: t.clone() for k, t in st.items()} for st in replay.stores]
    b, s, w = _draws(replay, 11)
    env0 = fn_env.reset(E, _gen(55), "cpu")
    eps = col.epsilons
    starts = [3 % bps] * DP

    # A: one sharded megastep
    state_a = copy.deepcopy(state)
    envs = [env_rows(env0, slice(i * El, (i + 1) * El), "cpu") for i in range(DP)]
    mega = make_sharded_megastep(cfg, fn_env, ["cpu"] * DP, E, chunk, K)
    state_a, m_a, prios_a, chunk_a, env_a = mega(
        state_a, replay.stores, envs, [eps[i * El:(i + 1) * El] for i in range(DP)],
        [CollectDraws(_gen(100 + i)) for i in range(DP)], [state_a.net] * DP, b, s, w, starts)

    # B1: K updates over the concatenated global batch
    state_b = copy.deepcopy(state)
    glob = {k: torch.cat([st[k] for st in before]) for k in before[0]}
    offs = (np.arange(DP) * bps)[None, :, None]
    flat = [torch.from_numpy(np.ascontiguousarray(x.reshape(K, -1)))
            for x in (b + offs, s, w)]
    state_b, m_b, prios_b = make_multi_update_core(cfg.replace(replay_plane="device", dp_size=1,
                                                               collector="host"), K)(
        state_b, glob, *flat)
    np.testing.assert_allclose(prios_a.reshape(K, -1).numpy(), prios_b.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]), rtol=RTOL, atol=ATOL)
    _assert_states_close(state_a, state_b)

    # B2: each shard's chunk with its draws and env slice, at its slots
    collect = make_collect_fn(cfg, fn_env, El, chunk)
    for sid in range(DP):
        sl = slice(sid * El, (sid + 1) * El)
        fields, cp, ns, sz, dn, er, env_f = collect(
            copy.deepcopy(state.net), env_rows(env0, sl, "cpu"), eps[sl], CollectDraws(_gen(100 + sid)))
        for x, y in zip(chunk_a, (cp, ns, sz, dn, er)):
            assert torch.equal(x[sl], y)
        assert all(torch.equal(x, y) for x, y in zip(env_a[sid], env_f))
        for k, t in fields.items():
            assert torch.equal(replay.stores[sid][k][starts[sid]:starts[sid] + El], t), k
        # slot 0 (outside the slab) kept its contents
        assert torch.equal(replay.stores[sid]["obs"][0], before[sid]["obs"][0])


def test_sharded_megastep_tp2_matches_tp1(setup):
    cfg, fn_env, state = setup
    E, El = cfg.num_actors, cfg.num_actors // DP
    chunk = min(cfg.block_length, cfg.max_episode_steps)
    replay, col = _filled(cfg, state, fn_env, seed=31)
    stores0 = [{k: t.clone() for k, t in st.items()} for st in replay.stores]
    b, s, w = _draws(replay, 17)
    env0 = fn_env.reset(E, _gen(3), "cpu")
    outs = []
    for tp in (1, 2):
        st = copy.deepcopy(state)
        stores = [{k: t.clone() for k, t in x.items()} for x in stores0]
        mega = make_sharded_megastep(cfg.replace(tp_size=tp), fn_env, ["cpu"] * DP, E, chunk,
                                     K, mesh=_mesh(tp=tp))
        outs.append((mega(st, stores, [env_rows(env0, slice(i * El, (i + 1) * El), "cpu")
                                       for i in range(DP)],
                          [col.epsilons[i * El:(i + 1) * El] for i in range(DP)],
                          [CollectDraws(_gen(7 + i)) for i in range(DP)], [st.net] * DP,
                          b, s, w, [1] * DP), stores))
    (a, sa), (c, sc) = outs
    _assert_states_close(a[0], c[0])
    np.testing.assert_allclose(a[2].numpy(), c[2].numpy(), rtol=RTOL, atol=ATOL)
    for x, y in zip(a[3], c[3]):
        assert torch.equal(x, y)  # collected with the same entry parameters
    for x, y in zip(sa, sc):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_sharded_runner_protocol(setup):
    cfg, fn_env, state = setup
    replay, col = _filled(cfg, state, fn_env, seed=21)
    env0 = replay.env_steps
    ptrs0 = [sh.block_ptr for sh in replay.shards]
    runner = ShardedFusedRunner(cfg, fn_env, replay, col.epsilons, col.env_state, 9,
                                collect_every=2, sample_rng=np.random.default_rng(5))
    El = cfg.num_actors // DP
    state2, m, rec = runner.step(copy.deepcopy(state))  # dispatch 0 collects
    assert rec == 0 and replay.env_steps == env0
    for sh, p0 in zip(replay.shards, ptrs0):
        assert sh.block_ptr == (p0 + El) % replay.blocks_per_shard
    state3, m2, rec2 = runner.step(state2)  # dispatch 1 drains chunk 0
    assert rec2 > 0 and replay.env_steps == env0 + rec2
    assert np.isfinite(float(m2["loss"])) and state3.step == state.step + 2 * K
    assert runner.finish() == 0 and runner._pending is None
    with pytest.raises(ValueError, match="store too small"):
        ShardedFusedRunner(cfg.replace(num_actors=40), fn_env, replay,
                           torch.zeros(40), fn_env.reset(40, _gen(0), "cpu"), 9)
    assert runner.env_state_on("cpu")[0].shape[0] == cfg.num_actors


def test_trainer_run_fused_sharded_end_to_end(tmp_path):
    cfg = _cfg(checkpoint_dir=str(tmp_path / "ckpt"), metrics_path=str(tmp_path / "m.jsonl"),
               save_interval=K)
    tr = Trainer(cfg, device=",".join(["cpu"] * DP))
    tr.run_fused()
    assert tr._step >= cfg.training_steps and tr.state.step == tr._step
    from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step

    assert latest_checkpoint_step(cfg.checkpoint_dir) is not None
    assert tr.actor.total_steps > 0


def test_sharded_plane_multi_update_threaded(tmp_path):
    cfg = _cfg(collector="host", checkpoint_dir=str(tmp_path / "ckpt"),
               metrics_path=str(tmp_path / "m.jsonl"), training_steps=2 * K)
    tr = Trainer(cfg, device=",".join(["cpu"] * DP))
    tr.run_threaded()
    assert tr._step >= cfg.training_steps and tr.state.step == tr._step
    assert tr.plane._pending is None


# ------------------------------------------------------------ the superstep


def _dev_cfg(**kw):
    return _cfg(priority_plane="device", collector="host", **kw)


@pytest.fixture(scope="module")
def warm_sharded(tmp_path_factory):
    cfg = _dev_cfg(checkpoint_dir=str(tmp_path_factory.mktemp("ss")))
    tr = Trainer(cfg, device=",".join(["cpu"] * DP))
    tr.warmup()
    return tr


def _nss(replay):
    return [torch.from_numpy(sh.num_seq_store.copy()) for sh in replay.shards]


def _uniforms(seed, n, shards, batch):
    return [superstep_uniforms(superstep_generators(seed, 0, n, "cpu", shard=i), K, batch, "cpu")
            for i in range(shards)]


def test_sharded_superstep_of_n_is_n_superstep_ones(warm_sharded):
    tr = warm_sharded
    cfg, rp = tr.cfg, tr.replay
    trees0 = [sh.dtree.tree for sh in rp.shards]
    u = _uniforms(17, 2, DP, cfg.batch_size // DP)
    mesh = _mesh()
    sA, treesA, mA = make_sharded_priority_superstep(cfg, mesh, 2, K)(
        copy.deepcopy(tr.state), rp.stores, trees0, _nss(rp), u)
    one = make_sharded_priority_superstep(cfg, mesh, 1, K)
    sB, treesB, _ = one(copy.deepcopy(tr.state), rp.stores, trees0, _nss(rp), [x[0:1] for x in u])
    sB, treesB, mB = one(sB, rp.stores, treesB, _nss(rp), [x[1:2] for x in u])
    for a, b, t0 in zip(treesA, treesB, trees0):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, t0) for a, t0 in zip(treesA, trees0))
    _assert_states_close(sA, sB, 0, 0)
    assert sA.step == tr.state.step + 2 * K
    with pytest.raises(ValueError, match="uniforms"):
        one(copy.deepcopy(tr.state), rp.stores, trees0, _nss(rp), u)


def test_sharded_superstep_is_its_hand_rolled_parts(warm_sharded):
    """One dispatch = per-shard descents on the entry trees, K sharded
    updates on the raw priorities (normalised over the batch), the
    write-back row by row; and it equals the unsharded update of the same
    draws with host-normalised weights (rtol 2e-4 / atol 2e-5)."""
    tr = warm_sharded
    cfg, rp = tr.cfg, tr.replay
    scfg = shard_config(cfg, DP)
    L, S = dst.tree_layers(scfg.num_sequences), scfg.seqs_per_block
    trees0 = [sh.dtree.tree for sh in rp.shards]
    u = _uniforms(23, 1, DP, cfg.batch_size // DP)
    sA, treesA, _ = make_sharded_priority_superstep(cfg, _mesh(), 1, K)(
        copy.deepcopy(tr.state), rp.stores, trees0, _nss(rp), u)
    leaf = np.stack([np.stack([dst.tree_descend(t, L, uk).numpy() for uk in ui[0]])
                     for t, ui in zip(trees0, u)], axis=1)  # (K, dp, B/dp)
    p = np.stack([np.stack([dst.priorities_of(t, L, torch.from_numpy(li)).numpy()
                            for li in leaf[:, i]]) for i, t in enumerate(trees0)], axis=1)
    nss = np.stack([sh.num_seq_store for sh in rp.shards])
    b = leaf // S
    s = np.minimum(leaf % S, np.maximum(np.take_along_axis(nss[None], b, 2) - 1, 0))
    multi = make_sharded_fused_multi_train_step(cfg, K, is_from_priorities=True)
    sB, _, prios = multi(copy.deepcopy(tr.state), rp.stores, b, s, p)
    treesB = list(trees0)
    for i in range(DP):
        for k in range(K):
            treesB[i] = dst.tree_update(treesB[i], L, torch.from_numpy(b[k, i] * S + s[k, i]),
                                        prios[k, i], cfg.prio_exponent)
    for a, c in zip(treesA, treesB):
        assert torch.equal(a, c)
    _assert_states_close(sA, sB, 0, 0)
    # the unsharded update of the same draws, each update's weights
    # normalised over its batch in float32 as the step normalises them
    pt = torch.from_numpy(p)
    min_p = torch.stack([pk[pk > 0].min() for pk in pt])[:, None, None]
    w = torch.pow(torch.maximum(pt, min_p) / min_p, -cfg.is_exponent).numpy()
    bps = rp.blocks_per_shard
    glob = {k: torch.cat([st[k] for st in rp.stores]) for k in rp.stores[0]}
    sC, _, _ = make_multi_update_core(cfg.replace(replay_plane="device", dp_size=1,
                                                  priority_plane="host"), K)(
        copy.deepcopy(tr.state), glob,
        *(torch.from_numpy(np.ascontiguousarray(x.reshape(K, -1)))
          for x in (b + (np.arange(DP) * bps)[None, :, None], s, w)))
    _assert_states_close(sA, sC)


def _jax_uniforms(keys, n, batch):
    """Per shard, the (N, K, B/dp) uniforms JAX's sharded superstep draws
    from that shard's key."""
    out = []
    for key in keys:
        dkeys = jax.random.split(key, n) if n > 1 else key[None]
        out.append(torch.from_numpy(np.stack([
            np.stack([np.asarray(jax.random.uniform(kk, (batch,), dtype=jnp.float32))
                      for kk in jax.random.split(kd, K)]) for kd in dkeys])))
    return out


@pytest.mark.parametrize("n", [1, 2])
def test_sharded_superstep_matches_jax_with_its_draws(n):
    dp = 2
    kw = dict(replay_plane="sharded", dp_size=dp, priority_plane="device",
              target_net_update_interval=2, batch_size=8)
    cfg, jcfg = tiny_test().replace(**kw), jax_tiny_test().replace(**kw)
    port = ShardedDeviceReplay(cfg, _mesh(dp))
    ref = JaxSharded(jcfg, jax_make_mesh(dp=dp, tp=1, devices=jax.devices()[:dp]))
    rng_p, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    for i in range(12):
        prios = np.random.default_rng(50 + i).uniform(0.3, 2.0, cfg.seqs_per_block)
        port.add_block(synth_block(cfg, rng_p), prios.astype(np.float32), None)
        ref.add_block(jax_synth_block(jcfg, rng_j), prios.astype(np.float32), None)
    # the same tree bits on both sides (ingestion's pow may differ by an ulp)
    ref.dtree_stack = jax.device_put(port.dtree_stack.numpy(), ref._dtree_shd)
    np.testing.assert_array_equal(np.asarray(ref.dtree_stack), port.dtree_stack.numpy())
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jstate.params)
    nets = []
    for _ in range(2):
        m = R2D2Network.from_config(cfg, device="cpu")
        m.load_state_dict(params_from_flax(tree))
        nets.append(m)
    nets[1].requires_grad_(False)
    pstate = TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(31), i) for i in range(dp)])
    u = _jax_uniforms(keys, n, cfg.batch_size // dp)
    pstate, ptrees, pm = make_sharded_priority_superstep(cfg, _mesh(dp), n, K)(
        pstate, port.stores, [sh.dtree.tree for sh in port.shards], _nss(port), u)
    nss = jnp.asarray(np.stack([sh.num_seq_store for sh in ref.shards]))
    jstate, jtrees, jm = jax_sharded_superstep(
        jcfg, net, ref.mesh, n, K, donate=False)(jstate, ref.stores, ref.dtree_stack, nss, keys)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack(ptrees).numpy(), np.asarray(jtrees),
                               rtol=1e-4, atol=1e-5)
    assert pstate.step == int(jstate.step) == n * K
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstate.params))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(pstate.net))[0])
    for path, v in flat_j:
        np.testing.assert_allclose(flat_t[path], v, rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_trainer_sharded_device_priority_and_resume(tmp_path):
    """The Trainer's sharded device priority plane trains N x K per
    superstep; its per-shard device trees ride in the snapshot and a resume
    restores them bit for bit."""
    cfg = _dev_cfg(checkpoint_dir=str(tmp_path / "ck"), superstep_dispatches=2,
                   training_steps=8, save_interval=4, snapshot_replay=True)
    dev = ",".join(["cpu"] * DP)
    tr = Trainer(cfg, device=dev)
    tr.run_inline(env_steps_per_update=4)
    assert tr.state.step == 8 and tr.plane.steps_per_update == 2 * K
    stack = tr.replay.dtree_stack
    assert torch.isfinite(stack).all() and stack[:, 0].sum() > 0
    tr2 = Trainer(cfg.replace(training_steps=16), device=dev, resume=True)
    assert tr2.state.step == 8 and torch.equal(tr2.replay.dtree_stack, stack)
    tr2.run_inline(env_steps_per_update=4)
    assert tr2.state.step == 16


# --------------------------------------------------------- two gloo ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_ranks_run_the_multihost_fused_runner(tmp_path):
    port = _free_port()
    env0 = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    procs = []
    for r in range(2):
        env = {**env0, "PYTHONPATH": ROOT, "WORLD_SIZE": "2", "RANK": str(r),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        argv = [sys.executable, "-m", "r2d2_tpu_torch.train", "--distributed", "--replay",
                "multihost", "--mode", "fused", "--device", "cpu", "--preset", "tiny_test",
                "--env", "catch", "--steps", "6", "--updates-per-dispatch", "2",
                "--set", "learning_starts=32", "--set", "num_actors=4",
                "--set", "max_episode_steps=16"]
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [o["mode"] for o in outs] == ["fused", "fused"]
    assert all(o["step"] == 6 and o["process_count"] == 2 for o in outs)
    assert outs[0]["params_sha256"] == outs[1]["params_sha256"]
    assert outs[0]["gradient_allreduce_calls"] == 6
