"""The port's replay snapshots (r2d2_tpu_torch/replay/snapshot.py): a round
trip is bit-identical and samples the same stream afterwards, a mismatch
raises before the buffer is touched, bf16 carries survive, and the file is
the JAX package's: a snapshot written by either package restores into the
other's ReplayBuffer, which then draws the same batches from the same numpy
Generator, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.replay import snapshot as jsnap
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as RefReplay
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.replay import snapshot
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.utils import faults

torch.set_num_threads(1)

BATCH_FIELDS = ("obs", "last_action", "last_reward", "hidden", "action", "n_step_reward",
                "gamma", "burn_in_steps", "learning_steps", "forward_steps", "is_weights",
                "idxes")


def _cfgs(**kw):
    """(port config, JAX config) with the same replay geometry, both on the
    numpy replay paths (the native core computes td^alpha with C++'s pow,
    numpy with its own: the leaves may differ in the last bit;
    test_torch_native.py holds the native core)."""
    port = tiny_test().replace(use_native_replay=False, **kw)
    shared = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    return port, jax_tiny_test().replace(**shared)


def _stream(cfg, seed, n_episodes=14):
    rng = np.random.default_rng(seed)
    for _ in range(n_episodes):
        length = int(rng.choice([3, cfg.learning_steps, 11, cfg.block_length + 5, 37]))
        first = rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8)
        steps = [(int(rng.integers(cfg.action_dim)), float(rng.choice([0.0, 1.0, -1.0, 0.37])),
                  rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8),
                  rng.normal(size=cfg.action_dim).astype(np.float32),
                  rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
                 for _ in range(length)]
        boot = rng.normal(size=(length, cfg.action_dim)).astype(np.float32)
        yield first, steps, boot


def _fill(buf, acc, cfg, seed):
    for first, steps, boot in _stream(cfg, seed):
        acc.reset(first)
        for i, step in enumerate(steps):
            acc.add(*step)
            if i == len(steps) - 1:
                buf.add_block(*acc.finish(last_qval=None))
            elif len(acc) == cfg.block_length:
                buf.add_block(*acc.finish(last_qval=boot[i]))


def _port(cfg, seed=0, updates=True):
    buf = ReplayBuffer(cfg)
    _fill(buf, SequenceAccumulator(cfg), cfg, seed)
    if updates:
        rng = np.random.default_rng(seed + 100)
        for _ in range(3):
            b = buf.sample_batch(rng)
            buf.update_priorities(b.idxes, rng.random(len(b.idxes)).astype(np.float32),
                                  b.old_ptr, b.old_advances)
    return buf


def _jax(cfg, seed=0):
    buf = RefReplay(cfg)
    _fill(buf, RefAccumulator(cfg), cfg, seed)
    return buf


def _bits(x):
    """An array, with JAX's ml_dtypes bfloat16 as the port's uint16 bits."""
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


def _assert_batches_equal(a, b, what):
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(a, name)), _bits(getattr(b, name)),
                                      err_msg=f"{what}: {name}")
    assert (a.old_ptr, a.env_steps, a.old_advances) == (b.old_ptr, b.env_steps,
                                                        b.old_advances), what


def _assert_same_stream(a, b, draws=4, seed=5):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(draws):
        sa, sb = a.sample_batch(ra), b.sample_batch(rb)
        _assert_batches_equal(sa, sb, f"draw {i}")
        td = np.random.default_rng(i).random(len(sa.idxes)).astype(np.float32)
        a.update_priorities(sa.idxes, td, sa.old_ptr, sa.old_advances)
        b.update_priorities(sb.idxes, td, sb.old_ptr, sb.old_advances)
    np.testing.assert_array_equal(a.tree.tree, b.tree.tree)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_round_trip_is_bit_identical_and_samples_alike(tmp_path, precision):
    cfg = tiny_test().replace(precision=precision)
    src = _port(cfg)
    path = str(tmp_path / "snap.npz")
    snapshot.save_replay(src, path, extra={"note": np.arange(3)})
    dst = ReplayBuffer(cfg)
    extra = snapshot.restore_replay(dst, path)
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    for k in snapshot.STORE_FIELDS:
        got, want = getattr(dst, k + "_store"), getattr(src, k + "_store")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("learning_sum", "occupied", "num_seq_store"):
        np.testing.assert_array_equal(getattr(dst, k), getattr(src, k))
    for k in snapshot._COUNTERS:
        assert getattr(dst, k) == getattr(src, k), k
    np.testing.assert_array_equal(dst.tree.tree, src.tree.tree)
    _assert_same_stream(src, dst)


def test_bf16_carries_survive_under_the_jax_marker(tmp_path):
    cfg = tiny_test().replace(precision="bf16")
    src = _port(cfg)
    assert src.hidden_store.dtype == np.uint16
    path = str(tmp_path / "snap.npz")
    carry = torch.randn(3, 5).to(torch.bfloat16)
    snapshot.save_replay(src, path, extra={"carry_h": carry, "plain": torch.arange(4)})
    with np.load(path) as d:
        assert sorted(str(k) for k in d["bf16_keys"]) == ["store_hidden", "x_carry_h"]
        assert d["store_hidden"].dtype == np.uint16
    dst = ReplayBuffer(cfg)
    extra = snapshot.restore_replay(dst, path)
    np.testing.assert_array_equal(dst.hidden_store, src.hidden_store)
    back = torch.from_numpy(extra["carry_h"].view(np.int16)).view(torch.bfloat16)
    assert torch.equal(back, carry)
    np.testing.assert_array_equal(extra["plain"], np.arange(4))


@pytest.mark.parametrize("change", [dict(hidden_dim=16), dict(buffer_capacity=320),
                                    dict(obs_shape=(10, 12, 1)), dict(precision="bf16")])
def test_a_mismatch_raises_and_leaves_the_buffer_untouched(tmp_path, change):
    cfg = tiny_test()
    path = str(tmp_path / "snap.npz")
    snapshot.save_replay(_port(cfg), path)
    other = tiny_test().replace(**change)
    dst = _port(other, seed=9)
    before = {k: getattr(dst, k + "_store").copy() for k in snapshot.STORE_FIELDS}
    tree, counters = dst.tree.tree.copy(), [getattr(dst, k) for k in snapshot._COUNTERS]
    with pytest.raises(ValueError):
        snapshot.restore_replay(dst, path)
    for k, v in before.items():
        np.testing.assert_array_equal(getattr(dst, k + "_store"), v)
    np.testing.assert_array_equal(dst.tree.tree, tree)
    assert [getattr(dst, k) for k in snapshot._COUNTERS] == counters


def test_another_plane_kind_is_a_topology_mismatch(tmp_path):
    cfg = tiny_test()
    path = str(tmp_path / "snap.npz")
    snapshot.save_replay(_port(cfg), path)
    with np.load(path) as d:
        payload = {k: d[k] for k in d.files}
    payload["kind"] = np.asarray("device")
    np.savez(path, **payload)
    with pytest.raises(snapshot.TopologyMismatch, match="kind 'device'"):
        snapshot.restore_replay(ReplayBuffer(cfg), path)


def test_a_failed_write_leaves_no_file(tmp_path):
    faults.install(faults.FaultPlane(schedule={"snapshot.write": {1: "error"}}))
    path = str(tmp_path / "snap.npz")
    try:
        with pytest.raises(faults.InjectedFault):
            snapshot.save_replay(_port(tiny_test()), path)
    finally:
        faults.uninstall()
    assert os.listdir(tmp_path) == []


def test_manifest_and_keys_are_the_jax_writers(tmp_path):
    port_cfg, jax_cfg = _cfgs(precision="bf16")
    pp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    snapshot.save_replay(_port(port_cfg, updates=False), pp)
    jsnap.save_replay(_jax(jax_cfg), jp)
    assert snapshot.read_manifest(pp) == jsnap.read_manifest(jp)
    with np.load(pp) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_port_snapshot_restores_in_jax_and_both_draw_alike(tmp_path, precision):
    port_cfg, jax_cfg = _cfgs(precision=precision)
    src = _port(port_cfg)
    path = str(tmp_path / "port.npz")
    snapshot.save_replay(src, path)
    ref = RefReplay(jax_cfg)
    jsnap.restore_replay(ref, path)
    np.testing.assert_array_equal(_bits(ref.hidden_store), src.hidden_store)
    _assert_same_stream(src, ref)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_jax_snapshot_restores_in_the_port_and_both_draw_alike(tmp_path, precision):
    port_cfg, jax_cfg = _cfgs(precision=precision)
    ref = _jax(jax_cfg)
    path = str(tmp_path / "jax.npz")
    jsnap.save_replay(ref, path)
    dst = ReplayBuffer(port_cfg)
    snapshot.restore_replay(dst, path)
    for k in snapshot.STORE_FIELDS:
        np.testing.assert_array_equal(getattr(dst, k + "_store"),
                                      _bits(getattr(ref, k + "_store")), err_msg=k)
    _assert_same_stream(dst, ref)
