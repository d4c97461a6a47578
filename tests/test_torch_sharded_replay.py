"""The port's dp-sharded replay (replay/sharded_store.py), the sharded
learner steps (learner.make_sharded_*) and the sharded snapshot kind,
against the JAX package on its fake 8-device CPU mesh.

The same blocks go into both ShardedDeviceReplays at dp=2 and dp=4, through
single adds and add_blocks_batch starting at every round-robin cursor and
with a remainder: stores, trees and pointers bit for bit; sample_indices
bit for bit from the same Generator; the trees after update_priorities.
One sharded update from JAX's parameters (interop) with the clip active
matches JAX's make_sharded_fused_train_step to rtol 1e-4 / atol 1e-5; K=2
in one dispatch is two single steps bit for bit; the dp=4 step is the
unsharded step on the concatenated batch; raw priorities normalised in the
step are the host-normalised weights; a replica per shard gives the bits of
the shared module and stays bit-identical to the state. Snapshots cross
both ways; another dp raises TopologyMismatch in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_sharded_fused_train_step as jax_sharded_step
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.replay.block import Block as RefBlock
from r2d2_tpu.replay.device_store import DeviceReplayBuffer as RefDeviceBuffer
from r2d2_tpu.replay.sharded_store import ShardedDeviceReplay as RefSharded
from r2d2_tpu.replay.snapshot import TopologyMismatch as JaxTopologyMismatch
from r2d2_tpu.replay.snapshot import restore_replay as jax_restore
from r2d2_tpu.replay.snapshot import save_replay as jax_save
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    TrainState,
    make_optimizer,
    make_sharded_fused_multi_train_step,
    make_sharded_fused_train_step,
    make_sharded_gather_step,
    make_train_step,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.parallel.mesh import make_mesh
from r2d2_tpu_torch.replay.block import state_tensor
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.multihost_store import MultiHostShardedReplay
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from r2d2_tpu_torch.replay.snapshot import TopologyMismatch, restore_replay, save_replay
from torch_multihost_child import synth_block

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
_REF_FIELDS = {f.name for f in dataclasses.fields(RefBlock)}


def _cfgs(dp, **kw):
    kw = {**dict(dp_size=dp, replay_plane="sharded", buffer_capacity=16 * 16, batch_size=8,
                 learning_starts=16), **kw}
    return tiny_test().replace(**kw), jax_tiny_test().replace(**kw)


def _pair(dp, **kw):
    cfg, jcfg = _cfgs(dp, **kw)
    port = ShardedDeviceReplay(cfg, make_mesh(dp, ["cpu"] * dp))
    ref = RefSharded(jcfg, jax_make_mesh(dp=dp, tp=1, devices=jax.devices()[:dp]))
    return cfg, port, ref


def _blocks(cfg, n, seed):
    """n blocks with their priorities and episode rewards; some cut short
    (fewer sequences), as the collector's last blocks of an episode are."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        blk = synth_block(cfg, rng)
        keep = [cfg.seqs_per_block, 2, 3, 1][i % 4]
        if keep < cfg.seqs_per_block:
            steps = keep * cfg.learning_steps
            blk = dataclasses.replace(
                blk, num_sequences=keep, obs=blk.obs[:cfg.burn_in_steps + steps + 1],
                last_action=blk.last_action[:cfg.burn_in_steps + steps + 1],
                last_reward=blk.last_reward[:cfg.burn_in_steps + steps + 1],
                action=blk.action[:steps], n_step_reward=blk.n_step_reward[:steps],
                gamma=blk.gamma[:steps], hidden=blk.hidden[:keep],
                burn_in_steps=blk.burn_in_steps[:keep], learning_steps=blk.learning_steps[:keep],
                forward_steps=blk.forward_steps[:keep])
        prios = rng.uniform(0.2, 3.0, cfg.seqs_per_block).astype(np.float32)
        out.append((blk, prios, float(rng.normal()) if i % 3 == 2 else None))
    return out


def _ref_block(blk):
    return RefBlock(**{k: v for k, v in dataclasses.asdict(blk).items() if k in _REF_FIELDS})


def _add(port, ref, blocks):
    for blk, p, ep in blocks:
        port.add_block(blk, p, ep)
        ref.add_block(_ref_block(blk), p, ep)


def _add_batch(port, ref, cfg, blocks):
    padded = [DeviceReplayBuffer.pad_block_fields(cfg, blk) for blk, _, _ in blocks]
    args = (np.asarray([b.num_sequences for b, _, _ in blocks]),
            np.asarray([b.learning_steps.sum() for b, _, _ in blocks]),
            np.stack([p for _, p, _ in blocks]),
            np.asarray([0.0 if ep is None else ep for _, _, ep in blocks]),
            np.asarray([ep is not None for _, _, ep in blocks]))
    port.add_blocks_batch({k: torch.stack([state_tensor(p[k]) for p in padded])
                           for k in padded[0]}, *args)
    ref.add_blocks_batch({k: jnp.stack([jnp.asarray(p[k]) for p in padded])
                          for k in padded[0]}, *args)


def _assert_same(port, ref):
    assert port._rr == ref._rr and len(port) == len(ref) and port.env_steps == ref.env_steps
    assert port.episode_totals() == ref.episode_totals()
    for k in port.stores[0]:
        got, want = torch.cat([st[k] for st in port.stores]), np.asarray(ref.stores[k])
        if got.dtype == torch.bfloat16:  # compare the bits
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    for a, b in zip(port.shards, ref.shards):
        assert (a.block_ptr, a.ptr_advances, a.size) == (b.block_ptr, b.ptr_advances, b.size)
        np.testing.assert_array_equal(a.tree.leaves(), b.tree.leaves())
        np.testing.assert_array_equal(a.num_seq_store, b.num_seq_store)


@pytest.mark.parametrize("dp", [2, 4])
def test_single_adds_match_jax_bit_for_bit(dp):
    cfg, port, ref = _pair(dp)
    _add(port, ref, _blocks(cfg, 2 * dp + 1, seed=dp))
    _assert_same(port, ref)
    # a full lap of every shard's ring
    _add(port, ref, _blocks(cfg, 16, seed=50 + dp))
    _assert_same(port, ref)


@pytest.mark.parametrize("dp", [2, 4])
def test_batch_adds_from_every_cursor_match_jax_and_sequential_adds(dp):
    """add_blocks_batch from each round-robin cursor, E a multiple of dp plus
    a remainder: JAX's slab deal bit for bit, and (no ring wraps here) the
    stores and trees of E single adds."""
    big = dict(buffer_capacity=16 * 64)
    cfg, port, ref = _pair(dp, **big)
    _, seq, _ = _pair(dp, **big)
    for rr in range(dp):
        while port._rr != rr:
            lead = _blocks(cfg, 1, seed=10 + rr)
            _add(port, ref, lead)
            seq.add_block(*lead[0])
        E = dp + 1 if rr % 2 == 0 else 2 * dp + dp - 1
        batch = _blocks(cfg, E, seed=20 + rr)
        _add_batch(port, ref, cfg, batch)
        for blk, p, ep in batch:
            seq.add_block(blk, p, ep)
        _assert_same(port, ref)
        for k in port.stores[0]:
            for a, b in zip(port.stores, seq.stores):
                assert torch.equal(a[k], b[k]), k
        for a, b in zip(port.shards, seq.shards):
            np.testing.assert_array_equal(a.tree.leaves(), b.tree.leaves())
    assert max(sh.ptr_advances for sh in port.shards) < port.blocks_per_shard


@pytest.mark.parametrize("dp", [2, 4])
def test_draws_and_priority_round_trip_match_jax_bit_for_bit(dp):
    cfg, port, ref = _pair(dp)
    _add(port, ref, _blocks(cfg, 3 * dp, seed=7))
    for seed in range(3):
        si = port.sample_indices(np.random.default_rng(seed))
        sj = ref.sample_indices(np.random.default_rng(seed))
        for name in ("b", "s", "is_weights", "idxes"):
            a, b = getattr(si, name), getattr(sj, name)
            assert a.dtype == b.dtype and a.shape == (dp, cfg.batch_size // dp), name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert (si.old_ptrs, si.old_advances, si.env_steps) == (
            sj.old_ptrs, sj.old_advances, sj.env_steps)
        td = np.random.default_rng(100 + seed).uniform(0.0, 2.0, si.idxes.shape)
        port.update_priorities(si.idxes, td, si.old_ptrs, si.old_advances)
        ref.update_priorities(sj.idxes, td, sj.old_ptrs, sj.old_advances)
        # a lap of one shard's ring between draw and write-back: that
        # shard's rows are dropped, the others land
        _add(port, ref, _blocks(cfg, dp, seed=200 + seed))
        _assert_same(port, ref)


def _port_state(cfg, tree):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(tree))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


def _assert_params_close(state, jstate):
    for port, want in ((state.net, jstate.params), (state.target_net, jstate.target_params)):
        flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(port))[0])
        for path, v in flat_w:
            np.testing.assert_allclose(flat_g[path], v, rtol=RTOL, atol=ATOL,
                                       err_msg=jax.tree_util.keystr(path))


def _filled(dp, n=None, **kw):
    cfg, port, ref = _pair(dp, grad_norm=0.05, target_net_update_interval=1, **kw)
    _add(port, ref, _blocks(cfg, n or 3 * dp, seed=3))
    return cfg, port, ref


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_step_matches_jax_with_the_clip_active(dp):
    cfg, port, ref = _filled(dp)
    jcfg = ref.cfg
    jmesh = ref.mesh
    jnet, jstate0 = jax_init_train_state(jcfg, jax.random.PRNGKey(dp))
    tree = jax.tree.map(np.asarray, jstate0.params)
    si = port.sample_indices(np.random.default_rng(11))
    jstep = jax_sharded_step(jcfg, jnet, jmesh, donate=False)
    jstate, jm, jp = jstep(jstate0, ref.stores, jnp.asarray(si.b), jnp.asarray(si.s),
                           jnp.asarray(si.is_weights))
    state, m, p = port.run_with_stores(lambda st: make_sharded_fused_train_step(cfg)(
        _port_state(cfg, tree), st, si.b, si.s, si.is_weights))
    assert float(m["grad_norm"]) > cfg.grad_norm  # the clip scales the update
    for k in ("loss", "grad_norm", "q_mean", "target_mean", "td_abs_mean"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    assert p.shape == (dp, cfg.batch_size // dp)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    _assert_params_close(state, jstate)


def test_k_updates_in_one_dispatch_are_k_single_steps_bit_for_bit():
    cfg, port, _ = _filled(4)
    tree = params_to_flax(R2D2Network.from_config(cfg, device="cpu"))
    rng = np.random.default_rng(5)
    draws = [port.sample_indices(rng) for _ in range(2)]
    b, s, w = (np.stack([getattr(d, f) for d in draws]) for f in ("b", "s", "is_weights"))
    a, ma, pa = make_sharded_fused_multi_train_step(cfg, 2)(
        _port_state(cfg, tree), port.stores, b, s, w)
    single = make_sharded_fused_train_step(cfg)
    c = _port_state(cfg, tree)
    pc = []
    for k in range(2):
        c, mc, p = single(c, port.stores, b[k], s[k], w[k])
        pc.append(p)
    assert a.step == c.step == 2
    assert torch.equal(pa, torch.stack(pc)) and torch.equal(ma["loss"], mc["loss"])
    for x, y in zip(a.net.parameters(), c.net.parameters()):
        assert torch.equal(x, y)


def test_dp4_step_is_the_unsharded_step_on_the_concatenated_batch():
    cfg, port, _ = _filled(4)
    tree = params_to_flax(R2D2Network.from_config(cfg, device="cpu"))
    si = port.sample_indices(np.random.default_rng(9))
    shards = make_sharded_gather_step(cfg)(port.stores, si.b, si.s, si.is_weights)
    whole = DeviceBatch(*(torch.cat(x) for x in zip(*shards)))
    a, ma, pa = make_sharded_fused_train_step(cfg)(_port_state(cfg, tree), port.stores,
                                                   si.b, si.s, si.is_weights)
    b, mb, pb = make_train_step(cfg)(_port_state(cfg, tree), whole)
    assert float(ma["grad_norm"]) > cfg.grad_norm
    for k in ma:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(pa.reshape(-1).numpy(), pb.numpy(), rtol=RTOL, atol=ATOL)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=RTOL, atol=ATOL)


def test_priorities_normalised_in_the_step_equal_the_host_weights():
    cfg, port, _ = _filled(4)
    tree = params_to_flax(R2D2Network.from_config(cfg, device="cpu"))
    si = port.sample_indices(np.random.default_rng(4))
    raw = np.stack([sh.tree.priorities_of(row) for sh, row in zip(port.shards, si.idxes)])
    assert np.unique(raw).size > 1  # weights below 1 somewhere
    a, ma, pa = make_sharded_fused_train_step(cfg, is_from_priorities=True)(
        _port_state(cfg, tree), port.stores, si.b, si.s, raw.astype(np.float32))
    b, mb, pb = make_sharded_fused_train_step(cfg)(
        _port_state(cfg, tree), port.stores, si.b, si.s, si.is_weights)
    for k in ma:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-5, atol=1e-7)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-7)


def test_replicas_give_the_shared_module_bits_and_stay_identical():
    cfg, port, _ = _filled(4)
    tree = params_to_flax(R2D2Network.from_config(cfg, device="cpu"))
    rng = np.random.default_rng(8)
    draws = [port.sample_indices(rng) for _ in range(3)]
    shared, replicated = (make_sharded_fused_train_step(cfg, replicate=r) for r in (False, True))
    a, b = _port_state(cfg, tree), _port_state(cfg, tree)
    for d in draws:
        a, ma, pa = shared(a, port.stores, d.b, d.s, d.is_weights)
        b, mb, pb = replicated(b, port.stores, d.b, d.s, d.is_weights)
        assert torch.equal(pa, pb) and torch.equal(ma["loss"], mb["loss"])
    assert len(replicated.replicas) == 3 and not shared.replicas
    for net, target in replicated.replicas.values():
        for x, y in zip(net.parameters(), b.net.parameters()):
            assert torch.equal(x, y)
        for x, y in zip(target.parameters(), b.target_net.parameters()):
            assert torch.equal(x, y)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_sharded_snapshots_cross_both_ways_bit_for_bit(tmp_path, precision):
    dp = 4
    cfg, port, ref = _pair(dp, precision=precision)
    _add(port, ref, _blocks(cfg, 11, seed=21))
    port.update_priorities(*(lambda si: (si.idxes, np.full(si.idxes.shape, 1.7),
                                         si.old_ptrs, si.old_advances))(
        port.sample_indices(np.random.default_rng(0))))
    save_replay(port, str(tmp_path / "port.npz"), extra={"carry": np.arange(3)})
    _, _, fresh_ref = _pair(dp, precision=precision)
    jax_restore(fresh_ref, str(tmp_path / "port.npz"))
    jax_save(ref, str(tmp_path / "jax.npz"))
    _, fresh_port, _ = _pair(dp, precision=precision)
    extras = restore_replay(fresh_port, str(tmp_path / "jax.npz"))
    assert extras == {}
    # the port's file in JAX holds the port's replay; JAX's file in the port
    # holds JAX's (which saw no write-back)
    _assert_same(port, fresh_ref)
    for k in port.stores[0]:
        for a, b in zip(fresh_port.stores, port.stores):
            assert torch.equal(a[k].view(torch.int16) if a[k].dtype == torch.bfloat16 else a[k],
                               b[k].view(torch.int16) if b[k].dtype == torch.bfloat16 else b[k])
    for a, b in zip(fresh_port.shards, ref.shards):
        np.testing.assert_array_equal(a.tree.leaves(), b.tree.leaves())
        assert (a.block_ptr, a.size, a.ptr_advances) == (b.block_ptr, b.size, b.ptr_advances)
    si = fresh_port.sample_indices(np.random.default_rng(3))
    sj = ref.sample_indices(np.random.default_rng(3))
    np.testing.assert_array_equal(si.idxes, sj.idxes)
    # another dp: TopologyMismatch in both packages
    _, other_port, other_ref = _pair(2, precision=precision)
    with pytest.raises(TopologyMismatch):
        restore_replay(other_port, str(tmp_path / "jax.npz"))
    with pytest.raises(JaxTopologyMismatch):
        jax_restore(other_ref, str(tmp_path / "port.npz"))
    with pytest.raises(TopologyMismatch):
        restore_replay(DeviceReplayBuffer(cfg.replace(replay_plane="device", dp_size=1), "cpu"),
                       str(tmp_path / "port.npz"))


def test_multihost_snapshot_round_trip(tmp_path):
    from r2d2_tpu_torch.parallel.multihost import make_global_mesh

    cfg = tiny_test().replace(buffer_capacity=16 * 16, learning_starts=16)
    mh = MultiHostShardedReplay(cfg, make_global_mesh(["cpu"] * 4), seed=5)
    for blk, p, ep in _blocks(cfg, 9, seed=31):
        mh.add_block(blk, p, ep)
    with mh.lock:
        mh.sample_global_k(3)
    save_replay(mh, str(tmp_path / "p0.npz"))
    back = MultiHostShardedReplay(cfg, make_global_mesh(["cpu"] * 4), seed=5)
    restore_replay(back, str(tmp_path / "p0.npz"))
    assert back._rr == mh._rr and back.env_steps == mh.env_steps
    assert back.local_ids == mh.local_ids == [0, 1, 2, 3]
    for j in range(len(mh.local_ids)):
        for k, t in mh.stores[j].items():
            assert torch.equal(back.stores[j][k], t), k
        np.testing.assert_array_equal(back.shards[j].tree.leaves(), mh.shards[j].tree.leaves())
    from r2d2_tpu_torch.replay.snapshot import read_manifest

    topo = read_manifest(str(tmp_path / "p0.npz"))
    assert (topo["plane"], topo["dp"], topo["local_ids"], topo["rng_seed"], topo["rng_epoch"]) == (
        "multihost", 4, [0, 1, 2, 3], 5, 3)
    two = MultiHostShardedReplay(cfg, make_global_mesh(["cpu"] * 2), seed=5)
    with pytest.raises(TopologyMismatch):
        restore_replay(two, str(tmp_path / "p0.npz"))
