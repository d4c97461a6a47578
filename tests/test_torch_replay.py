"""The port's host replay plane (r2d2_tpu_torch/replay) against the JAX
package's numpy replay path, bit for bit.

One synthetic transition stream (episodes that end, episodes cut at
block_length, carried burn-in tails) goes through both SequenceAccumulators;
the blocks go into both ReplayBuffers; both sample with the same seeded numpy
Generator, take the same priority updates (stale ones included) and sample
again. Blocks, sampled windows, indices, IS weights and the sum tree must be
bitwise equal throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as RefReplay
from r2d2_tpu.replay.sum_tree import SumTree as RefSumTree
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.sum_tree import SumTree

torch.set_num_threads(1)


def _stream(cfg, seed, n_episodes):
    """Per-episode lists of (action, reward, next_obs, q, hidden) plus the
    episode's first obs and the bootstrap q of every cut."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_episodes):
        length = int(rng.choice([1, 3, cfg.learning_steps, 11, cfg.block_length + 5, 40]))
        steps = [
            (
                int(rng.integers(cfg.action_dim)),
                float(rng.choice([0.0, 0.0, 1.0, -1.0, 0.37])),
                rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8),
                rng.normal(size=cfg.action_dim).astype(np.float32),
                rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32),
            )
            for _ in range(length)
        ]
        first = rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8)
        boot = rng.normal(size=(length, cfg.action_dim)).astype(np.float32)
        out.append((first, steps, boot))
    return out


def _blocks(acc, cfg, stream):
    """Drive one accumulator the way the actor does: cut at block_length
    with a bootstrap Q, finish(None) at the episode's end."""
    for first, steps, boot in stream:
        acc.reset(first)
        for i, step in enumerate(steps):
            acc.add(*step)
            last = i == len(steps) - 1
            if last:
                yield acc.finish(last_qval=None)
            elif len(acc) == cfg.block_length:
                yield acc.finish(last_qval=boot[i])


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def cfgs():
    ref = jax_tiny_test().replace(use_native_replay=False, batch_size=16)
    # the numpy paths of both (the native core: test_torch_native.py)
    port = tiny_test().replace(use_native_replay=False, batch_size=16)
    shared = {f.name for f in dataclasses.fields(port)}
    for name in shared:
        assert getattr(port, name) == getattr(ref, name), name
    return ref, port


@pytest.fixture(scope="module")
def streams(cfgs):
    ref, port = cfgs
    stream = _stream(port, seed=0, n_episodes=30)
    ref_blocks = list(_blocks(RefAccumulator(ref), ref, stream))
    port_blocks = list(_blocks(SequenceAccumulator(port), port, stream))
    return ref_blocks, port_blocks


def test_accumulators_pack_identical_blocks(streams):
    ref_blocks, port_blocks = streams
    assert len(ref_blocks) == len(port_blocks) > 30  # cuts happened
    assert any(b.burn_in_steps[0] > 0 for b, _, _ in port_blocks)  # carried tails
    for i, ((rb, rp, rr), (pb, pp, pr)) in enumerate(zip(ref_blocks, port_blocks)):
        for f in dataclasses.fields(pb):
            _assert_same(getattr(pb, f.name), getattr(rb, f.name), f"block {i}.{f.name}")
        _assert_same(pp, rp, f"block {i} priorities")
        assert pr == rr


def test_replay_buffers_sample_and_update_identically(cfgs, streams):
    ref_cfg, port_cfg = cfgs
    ref, port = RefReplay(ref_cfg), ReplayBuffer(port_cfg)
    ref_blocks, port_blocks = streams
    # more blocks than num_blocks: the ring wraps and evicts
    feed = (port_blocks * 2)[: port_cfg.num_blocks + 7]
    ref_feed = (ref_blocks * 2)[: port_cfg.num_blocks + 7]
    rng_ref, rng_port = np.random.default_rng(3), np.random.default_rng(3)
    td_rng = np.random.default_rng(4)
    pending = []
    for i, (r, p) in enumerate(zip(ref_feed, feed)):
        ref.add_block(*r)
        port.add_block(*p)
        if len(port) < 48 or i % 3:
            continue
        rb, pb = ref.sample_batch(rng_ref), port.sample_batch(rng_port)
        for f in dataclasses.fields(pb):
            _assert_same(getattr(pb, f.name), getattr(rb, f.name), f"sample {i}.{f.name}")
        td = td_rng.uniform(0.0, 3.0, size=port_cfg.batch_size).astype(np.float32)
        pending.append((pb.idxes, td, pb.old_ptr, pb.old_advances))
        # write priorities back one round late, so some land on slots that
        # were overwritten meanwhile and must be dropped by both
        if len(pending) > 1:
            args = pending.pop(0)
            ref.update_priorities(*args)
            port.update_priorities(*args)
        np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)
    assert len(port) == len(ref) and port.env_steps == ref.env_steps
    assert port.block_ptr == ref.block_ptr and port.ptr_advances == ref.ptr_advances
    assert port.episode_totals() == ref.episode_totals()


def test_full_lap_rejects_a_whole_stale_batch(cfgs, streams):
    ref_cfg, port_cfg = cfgs
    ref, port = RefReplay(ref_cfg), ReplayBuffer(port_cfg)
    ref_blocks, port_blocks = streams
    for r, p in zip(ref_blocks[:10], port_blocks[:10]):
        ref.add_block(*r)
        port.add_block(*p)
    pb = port.sample_batch(np.random.default_rng(0))
    for k in range(port_cfg.num_blocks):
        ref.add_block(*ref_blocks[k % len(ref_blocks)])
        port.add_block(*port_blocks[k % len(port_blocks)])
    td = np.full(port_cfg.batch_size, 9.0, np.float32)
    before = port.tree.tree.copy()
    port.update_priorities(pb.idxes, td, pb.old_ptr, pb.old_advances)
    ref.update_priorities(pb.idxes, td, pb.old_ptr, pb.old_advances)
    np.testing.assert_array_equal(port.tree.tree, before)
    np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)


@pytest.mark.parametrize("capacity", [1, 5, 16, 100])
def test_sum_tree_update_and_sample_bitwise(capacity):
    rng = np.random.default_rng(capacity)
    ref, port = RefSumTree(capacity, 0.9, 0.6), SumTree(capacity, 0.9, 0.6)
    for _ in range(5):
        idx = rng.integers(0, capacity, size=7)
        td = rng.uniform(0.0, 2.0, size=7)
        td[0] = 0.0
        ref.update(idx, td)
        port.update(idx, td)
        np.testing.assert_array_equal(port.tree, ref.tree)
        if ref.total > 0:
            a, b = np.random.default_rng(1), np.random.default_rng(1)
            (ri, rw), (pi, pw) = ref.sample(9, a), port.sample(9, b)
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pw, rw)
            assert pw.dtype == rw.dtype and pi.dtype == ri.dtype
