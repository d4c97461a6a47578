"""The port's device sum tree (r2d2_tpu_torch/replay/device_sum_tree.py) and
the control plane's device-plane hooks, against the JAX package.

Where the math is sums the port's tree equals JAX's bit for bit: trees built
from the same leaves, descents fed JAX's own uniforms, the stale mask.
td**alpha and the IS weights' power are held to 1e-6 relative (torch and
XLA may round a pow differently by an ulp). The f32 tree stays within the
JAX package's three-way bound of the port's float64 host trees (numpy and
native). The ring reservations of a batched writer match JAX's control
plane operation by operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.replay import device_sum_tree as jdst
from r2d2_tpu.replay.control_plane import ReplayControlPlane as RefControlPlane
from r2d2_tpu_torch._native import load_native
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.replay import device_sum_tree as dst
from r2d2_tpu_torch.replay.control_plane import ReplayControlPlane
from r2d2_tpu_torch.replay.sum_tree import SumTree

torch.set_num_threads(1)


def _leaves(tree, cap):
    L = dst.tree_layers(cap)
    off = dst.leaf_offset(L)
    return np.asarray(tree[off:off + cap])


def test_layout_helpers_match_jax():
    for cap in (1, 2, 3, 16, 17, 200, 50_000):
        L = dst.tree_layers(cap)
        assert L == jdst.tree_layers(cap)
        assert dst.leaf_offset(L) == jdst.leaf_offset(L)
        assert dst.tree_size(L) == jdst.tree_size(L) == dst.tree_init(cap).numel()


@pytest.mark.parametrize("cap", [16, 200])
def test_tree_from_leaves_is_jax_bits(cap):
    leaves = np.random.default_rng(cap).uniform(0, 3, cap).astype(np.float32)
    leaves[::7] = 0.0
    np.testing.assert_array_equal(dst.tree_from_leaves(leaves, cap).numpy(),
                                  np.asarray(jdst.tree_from_leaves(leaves, cap)))


def test_update_with_duplicates_and_mask_matches_jax():
    cap = 16
    L = dst.tree_layers(cap)
    base = np.full(cap, 2.0, np.float32)
    idx = np.asarray([3, 5, 3, 7, 3, 9, 9], np.int32)
    tds = np.asarray([1.0, 4.0, 9.0, 16.0, 25.0, 0.0, 36.0], np.float32)
    mask = np.asarray([True, True, True, False, False, True, True])
    for m in (None, mask):
        ours = dst.tree_update(dst.tree_from_leaves(base, cap), L, torch.from_numpy(idx),
                               torch.from_numpy(tds), 0.5,
                               mask=None if m is None else torch.from_numpy(m))
        theirs = jdst.tree_update(jdst.tree_from_leaves(base, cap), L, jnp.asarray(idx),
                                  jnp.asarray(tds), 0.5,
                                  mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)
        # internal nodes are exact sums of the port's own leaves
        np.testing.assert_array_equal(ours.numpy(),
                                      dst.tree_from_leaves(_leaves(ours, cap), cap).numpy())
    want = base.copy()
    want[3], want[5], want[9] = 3.0, 2.0, 6.0  # last VALID duplicate wins
    np.testing.assert_allclose(_leaves(ours, cap), want, rtol=1e-6)


def test_update_is_deterministic_under_deterministic_algorithms():
    cap = 64
    L = dst.tree_layers(cap)
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, cap, 200))  # many duplicates
    tds = torch.from_numpy(rng.uniform(0, 4, 200).astype(np.float32))
    free = dst.tree_update(dst.tree_init(cap), L, idx, tds, 0.9)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = dst.tree_update(dst.tree_init(cap), L, idx, tds, 0.9)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(free, det)


@pytest.mark.parametrize("n", [1, 8, 33])
def test_descent_with_jax_uniforms_samples_jax_leaves(n):
    cap = 200
    leaves = np.random.default_rng(n).uniform(0, 2, cap).astype(np.float32)
    leaves[10:30] = 0.0
    L = dst.tree_layers(cap)
    jt = jdst.tree_from_leaves(leaves, cap)
    key = jax.random.PRNGKey(40 + n)
    u = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    want = np.asarray(jdst.tree_sample(jt, L, n, key))
    got = dst.tree_descend(dst.tree_from_leaves(leaves, cap), L, torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_is_weights_with_zero_leaves_match_jax():
    cap = 32
    leaves = np.random.default_rng(3).uniform(0.1, 2, cap).astype(np.float32)
    leaves[[2, 5, 9]] = 0.0
    L = dst.tree_layers(cap)
    for idx in (np.asarray([2, 5, 9, 1, 4]), np.asarray([2, 5, 9])):
        got = dst.is_weights(dst.tree_from_leaves(leaves, cap), L, torch.from_numpy(idx), 0.6)
        want = jdst.is_weights(jdst.tree_from_leaves(leaves, cap), L, jnp.asarray(idx), 0.6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert np.isfinite(got.numpy()).all()
    # only zero leaves sampled: every weight is 1, not NaN
    np.testing.assert_array_equal(got.numpy(), np.ones(3, np.float32))


def test_stale_mask_matches_host_window_verdict_and_jax():
    S, nb = 4, 6
    idxes = np.arange(nb * S)
    for old_ptr in range(nb):
        for ptr in range(nb):
            for adv in (0, nb - 1, nb, nb + 3):
                got = dst.stale_mask(torch.from_numpy(idxes), old_ptr, ptr, S, 0, adv,
                                     nb).numpy()
                if adv >= nb:
                    want = np.zeros(len(idxes), bool)
                elif ptr > old_ptr:
                    want = (idxes < old_ptr * S) | (idxes >= ptr * S)
                elif ptr < old_ptr:
                    want = (idxes < old_ptr * S) & (idxes >= ptr * S)
                else:
                    want = np.ones(len(idxes), bool)
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(
                    got, np.asarray(jdst.stale_mask(idxes, old_ptr, ptr, S, 0, adv, nb)))


def _arms(cap, **kw):
    return {
        "host_f64": SumTree(cap, **kw),
        "native_f64": SumTree(cap, native=load_native(), **kw),
        "device_f32": dst.DeviceSumTree(cap, **kw),
        "jax_device_f32": jdst.DeviceSumTree(cap, **kw),
    }


def _total(t):
    return t.total if hasattr(t, "total") else float(t.tree[0])


def test_three_way_update_parity_with_f32_drift_bound():
    cap = 200
    arms = _arms(cap, prio_exponent=0.9, is_exponent=0.6)
    rng = np.random.default_rng(11)
    for _ in range(30):
        m = int(rng.integers(1, 64))
        idxes = rng.integers(0, cap, size=m)  # duplicates likely
        tds = rng.uniform(0.0, 8.0, size=m)
        for t in arms.values():
            t.update(idxes, tds)
        ref = arms["host_f64"].leaves()
        for name, t in arms.items():
            f32 = "f32" in name
            np.testing.assert_allclose(np.asarray(t.leaves()), ref,
                                       rtol=1e-5 if f32 else 1e-9, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(_total(t), _total(arms["host_f64"]),
                                       rtol=1e-4 if f32 else 1e-9, err_msg=name)
    np.testing.assert_allclose(arms["device_f32"].leaves(), arms["jax_device_f32"].leaves(),
                               rtol=1e-6)


def test_f32_drift_stays_bounded_over_many_updates():
    cap = 256
    host = SumTree(cap, 0.9, 0.6)
    dev = dst.DeviceSumTree(cap, 0.9, 0.6)
    rng = np.random.default_rng(13)
    for _ in range(300):
        m = int(rng.integers(1, 32))
        idxes = rng.integers(0, cap, size=m)
        tds = rng.uniform(0.0, 10.0, size=m)
        host.update(idxes, tds)
        dev.update(idxes, tds)
    np.testing.assert_allclose(dev.leaves(), host.leaves(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dev.total, float(host.tree[0]), rtol=1e-4)


def test_handle_samples_stratified_and_reproducibly_and_round_trips_leaves():
    cap, n, beta = 128, 32, 0.6
    t = dst.DeviceSumTree(cap, prio_exponent=1.0, is_exponent=beta)
    tds = np.random.default_rng(12).uniform(0.1, 4.0, size=cap)
    t.update(np.arange(cap), tds)
    idx, w = t.sample(n, torch.Generator().manual_seed(3))
    idx2, _ = t.sample(n, torch.Generator().manual_seed(3))
    assert torch.equal(idx, idx2)
    idx = idx.numpy()
    assert (idx >= 0).all() and (idx < cap).all()
    cum = np.cumsum(t.leaves().astype(np.float64))
    p = t.priorities_of(idx).astype(np.float64)
    stratum = cum[-1] / n
    assert (cum[idx] + 1e-4 >= np.arange(n) * stratum * (1 - 1e-5)).all()
    assert (cum[idx] - p * 1.001 - 1e-4 <= (np.arange(n) + 1) * stratum * (1 + 1e-5)).all()
    min_p = p[p > 0].min()
    np.testing.assert_allclose(w.numpy(), (np.maximum(p, min_p) / min_p) ** -beta, rtol=1e-4)
    other = dst.DeviceSumTree(cap, prio_exponent=1.0, is_exponent=beta)
    other.load_leaves(t.leaves())
    assert torch.equal(other.tree, t.tree)
    with pytest.raises(ValueError):
        other.load_leaves(np.zeros(cap - 1, np.float32))


# --- the control plane's device hooks ---------------------------------------

SMALL = dict(obs_shape=(3, 3, 1), action_dim=3, hidden_dim=4, burn_in_steps=4,
             learning_steps=4, forward_steps=2, block_length=12, buffer_capacity=96,
             learning_starts=12, batch_size=5)


def _planes(native=True):
    ours = ReplayControlPlane(tiny_test().replace(use_native_replay=native, **SMALL))
    theirs = RefControlPlane(jax_tiny_test().replace(use_native_replay=False, **SMALL))
    ours.attach_device_tree(dst.DeviceSumTree(ours.cfg.num_sequences, ours.cfg.prio_exponent,
                                              ours.cfg.is_exponent))
    theirs.attach_device_tree(jdst.DeviceSumTree(theirs.cfg.num_sequences,
                                                 theirs.cfg.prio_exponent,
                                                 theirs.cfg.is_exponent))
    return ours, theirs


def _same(ours, theirs):
    for k in ("block_ptr", "ptr_advances", "size", "env_steps", "num_episodes",
              "total_episodes"):
        assert getattr(ours, k) == getattr(theirs, k), k
    assert ours.episode_reward_sum == pytest.approx(theirs.episode_reward_sum)
    for k in ("learning_sum", "occupied", "num_seq_store"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k), err_msg=k)
    np.testing.assert_allclose(ours.tree.leaves(), theirs.tree.leaves(), rtol=1e-12)
    np.testing.assert_allclose(ours.dtree.leaves(), np.asarray(theirs.dtree.leaves()),
                               rtol=1e-6)
    np.testing.assert_allclose(ours.dtree.leaves(), ours.tree.leaves(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("native", [True, False])
def test_reservations_and_deferred_accounting_match_jax(native):
    ours, theirs = _planes(native)
    nb, S = ours.cfg.num_blocks, ours.cfg.seqs_per_block
    rng = np.random.default_rng(7)
    for it in range(40):
        E = int(rng.integers(1, 4))
        num_seq = rng.integers(1, S + 1, E)
        learn = num_seq * ours.cfg.learning_steps - rng.integers(0, 3, E)
        prios = rng.uniform(0.1, 3.0, (E, S))
        ep = rng.normal(size=E)
        dones = rng.random(E) < 0.5
        op = it % 3
        for cp in (ours, theirs):
            with cp.lock:
                if op == 0:
                    cp._reserve_contiguous(E)
                    cp._account_blocks(num_seq, learn, prios, ep, dones)
                elif op == 1:
                    ptr0 = cp._reserve_advance(E)
                    cp._account_blocks_at(ptr0, num_seq, learn, prios, ep, dones)
                else:
                    cp._account_add(int(num_seq[0]), int(learn[0]), prios[0],
                                    float(ep[0]) if dones[0] else None)
        _same(ours, theirs)
        if it % 4 == 3:
            idx = rng.integers(0, nb * S, 6)
            td = rng.uniform(0, 2, 6)
            old = (int(rng.integers(0, nb)), ours.ptr_advances - int(rng.integers(0, nb + 2)))
            for cp in (ours, theirs):
                cp.update_priorities(idx, td, *old)
            _same(ours, theirs)
