"""The port's device replay plane (r2d2_tpu_torch/replay/device_store.py) and
the learner steps over it (learner.make_store_gather, make_fused_train_step,
make_fused_multi_train_step), against the port's host plane and the JAX
package.

From the same blocks and Generator: the device plane draws the host plane's
coordinates, its in-step gather is the host plane's batch bit for bit and
JAX's make_store_gather's bit for bit; a fused step is make_train_step on
the host batch bit for bit and JAX's fused step at rtol 1e-4 / atol 1e-5;
K fused steps in one dispatch are K single ones bit for bit and JAX's
K-step at the same tolerance. A device snapshot written by either package
restores in the other (float32 and bfloat16 carries, with the device tree's
leaves). The device plane trains through the Trainer in every mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import R2D2Config as RefConfig
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_fused_multi_train_step as jax_multi_step
from r2d2_tpu.learner import make_fused_train_step as jax_fused_step
from r2d2_tpu.learner import make_store_gather as jax_store_gather
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.device_store import DeviceReplayBuffer as RefDeviceBuffer
from r2d2_tpu.replay.snapshot import restore_replay as jax_restore
from r2d2_tpu.replay.snapshot import save_replay as jax_save
from r2d2_tpu_torch.config import R2D2Config, tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    TrainState,
    make_fused_multi_train_step,
    make_fused_train_step,
    make_gather_step,
    make_optimizer,
    make_store_gather,
    make_train_step,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.snapshot import restore_replay, save_replay

torch.set_num_threads(1)

SMALL = dict(obs_shape=(3, 3, 1), action_dim=3, hidden_dim=4, burn_in_steps=4,
             learning_steps=4, forward_steps=2, block_length=12, buffer_capacity=48,
             learning_starts=12, batch_size=5)


def _fill(buf, acc_cls, cfg, n=6, seed=0, lengths=(12, 12, 7, 12, 5, 12)):
    """Full, short and terminal blocks: every clamp of the window gather."""
    for i in range(n):
        steps = lengths[i % len(lengths)]
        acc = acc_cls(cfg)
        acc.reset(np.full(cfg.obs_shape, 7, dtype=np.uint8))
        rng = np.random.default_rng(seed + i)
        for k in range(steps):
            t = 13 * i + k
            acc.add(action=t % 3, reward=float(rng.normal()),
                    next_obs=rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8),
                    q_value=rng.normal(size=3).astype(np.float32),
                    hidden=rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
        buf.add_block(*acc.finish(last_qval=None if i % 3 == 2
                                  else rng.normal(size=3).astype(np.float32)))


# one lap of the 4-block ring: the host plane keeps a rewritten slot's old
# tail rows, the device plane zero-pads them (as in the JAX package), so the
# bit-for-bit gather holds on blocks written into fresh slots
FRESH = dict(n=4, lengths=(12, 5, 7, 12))


def _host_and_device(**kw):
    cfg = tiny_test().replace(**{**SMALL, **kw})
    host, dev = ReplayBuffer(cfg), DeviceReplayBuffer(cfg.replace(replay_plane="device"), "cpu")
    for buf in (host, dev):
        _fill(buf, SequenceAccumulator, cfg, **FRESH)
    return cfg, host, dev


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_in_step_gather_is_the_host_batch_and_jax_gather_bit_for_bit(precision):
    cfg, host, dev = _host_and_device(precision=precision)
    jcfg = jax_tiny_test().replace(**SMALL, precision=precision, replay_plane="device")
    jbuf = RefDeviceBuffer(jcfg)
    _fill(jbuf, RefAccumulator, jcfg, **FRESH)
    gather = make_store_gather(cfg)
    for seed in range(4):
        hb = host.sample_batch(np.random.default_rng(seed))
        si = dev.sample_indices(np.random.default_rng(seed))
        np.testing.assert_array_equal(hb.idxes, si.idxes)
        np.testing.assert_array_equal(hb.is_weights, si.is_weights)
        assert (hb.old_ptr, hb.old_advances) == (si.old_ptr, si.old_advances)
        want = DeviceBatch.from_sampled(hb, "cpu")
        got = dev.run_with_stores(lambda st: gather(st, *(torch.from_numpy(x) for x in (
            si.b, si.s, si.is_weights))))
        assert got.hidden.dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)
        for name in DeviceBatch._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
        jb = jax_store_gather(jcfg)(jbuf.stores, jnp.asarray(si.b), jnp.asarray(si.s),
                                    jnp.asarray(si.is_weights))
        for name, jname in (("obs", "obs"), ("last_action", "last_action"),
                            ("last_reward", "last_reward"), ("action", "action"),
                            ("n_step_reward", "n_step_reward"), ("gamma", "gamma"),
                            ("burn_in_steps", "burn_in_steps"),
                            ("learning_steps", "learning_steps"),
                            ("forward_steps", "forward_steps")):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(jb, jname)), err_msg=name)
        np.testing.assert_array_equal(got.hidden.float().numpy(),
                                      np.asarray(jb.hidden, np.float32))
        # a batch materialized at sample time is a copy of the same bytes
        early = dev.run_with_stores(lambda st: make_gather_step(cfg)(st, *(
            torch.from_numpy(x) for x in (si.b, si.s, si.is_weights))))
        assert early.obs.data_ptr() != dev.stores["obs"].data_ptr()
        assert torch.equal(early.obs, got.obs)


def test_stores_are_jax_device_stores_after_ingestion_and_wrap():
    cfg, _, dev = _host_and_device()
    jcfg = jax_tiny_test().replace(**SMALL, replay_plane="device")
    jbuf = RefDeviceBuffer(jcfg)
    _fill(jbuf, RefAccumulator, jcfg, **FRESH)
    for buf, acc in ((dev, SequenceAccumulator), (jbuf, RefAccumulator)):
        _fill(buf, acc, cfg, n=3, seed=50)  # wraps the 4-block ring
    for k, t in dev.stores.items():
        assert str(t.dtype).split(".")[-1] == str(jbuf.stores[k].dtype), k
        np.testing.assert_array_equal(t.numpy(), np.asarray(jbuf.stores[k]), err_msg=k)
    np.testing.assert_array_equal(dev.tree.leaves(), jbuf.tree.leaves())
    assert (dev.block_ptr, dev.ptr_advances, dev.size) == (
        jbuf.block_ptr, jbuf.ptr_advances, jbuf.size)


def _port_state(cfg, tree):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(tree))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


def _tiny_pair(**kw):
    """Port and JAX tiny_test device planes with the same blocks, and the
    JAX init parameters."""
    kw = dict(target_net_update_interval=2, replay_plane="device", **kw)
    cfg = tiny_test().replace(**kw)
    jcfg = jax_tiny_test().replace(lstm_backend="pallas", **kw)
    dev, jbuf = DeviceReplayBuffer(cfg, "cpu"), RefDeviceBuffer(jcfg)
    for buf, acc in ((dev, SequenceAccumulator), (jbuf, RefAccumulator)):
        for i in range(8):
            acc_ = acc(cfg if buf is dev else jcfg)
            rng = np.random.default_rng(100 + i)
            acc_.reset(rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8))
            for k in range([16, 9, 16, 5][i % 4]):
                acc_.add(action=int(rng.integers(cfg.action_dim)), reward=float(rng.normal()),
                         next_obs=rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8),
                         q_value=rng.normal(size=cfg.action_dim).astype(np.float32),
                         hidden=(rng.normal(size=(2, cfg.hidden_dim)) * 0.5).astype(np.float32))
            buf.add_block(*acc_.finish(last_qval=None if i % 2 else
                                       rng.normal(size=cfg.action_dim).astype(np.float32)))
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, dev, jbuf, net, jstate


def _coords(dev, k, seed):
    rng = np.random.default_rng(seed)
    draws = [dev.sample_indices(rng) for _ in range(k)]
    return [np.stack([getattr(d, f) for d in draws]) for f in ("b", "s", "is_weights")]


def _assert_params_close(pstate, jstate):
    for port, ref in ((pstate.net, jstate.params), (pstate.target_net, jstate.target_params)):
        flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref))[0]
        flat_t = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(port))[0])
        for path, v in flat_j:
            np.testing.assert_allclose(flat_t[path], v, rtol=1e-4, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))


def test_fused_step_is_the_host_batch_step_and_matches_jax():
    cfg, jcfg, dev, jbuf, net, jstate = _tiny_pair()
    tree = jax.tree.map(np.asarray, jstate.params)
    a, b = _port_state(cfg, tree), _port_state(cfg, tree)
    b_, s_, w_ = _coords(dev, 1, 3)
    coords = [torch.from_numpy(x[0]) for x in (b_, s_, w_)]
    a, ma, pa = dev.run_with_stores(lambda st: make_fused_train_step(cfg)(a, st, *coords))
    batch = make_store_gather(cfg)(dev.stores, *coords)
    b, mb, pb = make_train_step(cfg)(b, batch)
    assert torch.equal(pa, pb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(x, y)
    jstate, jm, jp = jax_fused_step(jcfg, net, donate=False)(
        jstate, jbuf.stores, *(jnp.asarray(x[0]) for x in (b_, s_, w_)))
    for k in ("loss", "grad_norm", "q_mean", "td_abs_mean"):
        np.testing.assert_allclose(float(ma[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pa.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-5)
    _assert_params_close(a, jstate)


def test_k_step_dispatch_is_k_single_fused_steps_and_matches_jax():
    K = 3
    cfg, jcfg, dev, jbuf, net, jstate = _tiny_pair()
    tree = jax.tree.map(np.asarray, jstate.params)
    a, b = _port_state(cfg, tree), _port_state(cfg, tree)
    bb, ss, ww = _coords(dev, K, 5)
    a, ma, pa = make_fused_multi_train_step(cfg, K)(
        a, dev.stores, *(torch.from_numpy(x) for x in (bb, ss, ww)))
    one = make_fused_train_step(cfg)
    prios = []
    for k in range(K):
        b, mb, p = one(b, dev.stores, *(torch.from_numpy(x[k]) for x in (bb, ss, ww)))
        prios.append(p)
    assert a.step == b.step == K and pa.shape == (K, cfg.batch_size)
    assert torch.equal(pa, torch.stack(prios)) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(list(a.net.parameters()) + list(a.target_net.parameters()),
                    list(b.net.parameters()) + list(b.target_net.parameters())):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="expected 3"):
        make_fused_multi_train_step(cfg, K)(a, dev.stores, *(torch.from_numpy(x[:2])
                                                             for x in (bb, ss, ww)))
    jstate, jm, jp = jax_multi_step(jcfg, net, K, donate=False)(
        jstate, jbuf.stores, *(jnp.asarray(x) for x in (bb, ss, ww)))
    np.testing.assert_allclose(float(ma["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pa.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-5)
    _assert_params_close(a, jstate)


@pytest.mark.parametrize("precision,priority", [("fp32", "host"), ("bf16", "device")])
def test_device_snapshot_file_is_interchangeable_with_jax(tmp_path, precision, priority):
    kw = dict(**SMALL, precision=precision, replay_plane="device", priority_plane=priority)
    cfg, jcfg = tiny_test().replace(**kw), jax_tiny_test().replace(**kw)
    ours, theirs = DeviceReplayBuffer(cfg, "cpu"), RefDeviceBuffer(jcfg)
    _fill(ours, SequenceAccumulator, cfg, n=7, seed=3)
    _fill(theirs, RefAccumulator, jcfg, n=5, seed=9)
    if priority == "device":
        ours.update_priorities(np.arange(6), np.linspace(0.5, 3, 6), ours.block_ptr)

    def same(p, j):
        for k, t in p.stores.items():
            want = np.asarray(j.stores[k])
            got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
        np.testing.assert_array_equal(p.tree.leaves(), j.tree.leaves())
        for k in ("block_ptr", "size", "env_steps", "ptr_advances", "total_episodes"):
            assert getattr(p, k) == getattr(j, k), k
        np.testing.assert_array_equal(p.num_seq_store, j.num_seq_store)
        if priority == "device":
            np.testing.assert_array_equal(p.dtree.leaves(), np.asarray(j.dtree.leaves()))

    save_replay(ours, str(tmp_path / "port.npz"))
    fresh_j = RefDeviceBuffer(jcfg)
    jax_restore(fresh_j, str(tmp_path / "port.npz"))
    same(ours, fresh_j)
    jax_save(theirs, str(tmp_path / "jax.npz"))
    fresh_p = DeviceReplayBuffer(cfg, "cpu")
    restore_replay(fresh_p, str(tmp_path / "jax.npz"))
    same(fresh_p, theirs)
    # another plane's snapshot is refused before anything is touched
    host = ReplayBuffer(cfg.replace(replay_plane="host", priority_plane="host"))
    with pytest.raises(ValueError, match="snapshot kind 'device'"):
        restore_replay(host, str(tmp_path / "port.npz"))


def test_device_plane_configuration_is_validated_as_jax_validates():
    base = {f.name: getattr(tiny_test(), f.name) for f in dataclasses.fields(R2D2Config)}
    jbase = {f.name: getattr(jax_tiny_test(), f.name) for f in dataclasses.fields(RefConfig)}
    for kw in (dict(priority_plane="tree"), dict(priority_plane="device"),
               dict(replay_plane="device", superstep_dispatches=0),
               dict(replay_plane="device", superstep_dispatches=2),
               dict(replay_plane="device", priority_plane="device", updates_per_dispatch=2,
                    superstep_dispatches=2, training_steps=50),
               dict(updates_per_dispatch=2), dict(collector="gpu"),
               dict(collector="device")):
        with pytest.raises(ValueError) as ours:
            R2D2Config(**{**base, **kw}).validate()
        with pytest.raises(ValueError) as theirs:
            RefConfig(**{**jbase, **kw}).validate()
        assert str(ours.value).split(" (")[0].split(";")[0] == \
            str(theirs.value).split(" (")[0].split(";")[0] or kw in (
                dict(priority_plane="device"), dict(updates_per_dispatch=2),
                dict(collector="device")), (kw, str(ours.value), str(theirs.value))
    cfg = tiny_test().replace(replay_plane="device", priority_plane="device",
                              updates_per_dispatch=5, superstep_dispatches=2,
                              training_steps=50)
    assert (cfg.updates_per_dispatch, cfg.superstep_dispatches) == (5, 2)


@pytest.mark.parametrize("mode", ["inline", "threaded"])
@pytest.mark.parametrize("k", [1, 2])
def test_trainer_trains_on_the_device_plane(tmp_path, mode, k):
    from r2d2_tpu_torch.train import Trainer

    cfg = tiny_test().replace(env_name="catch", replay_plane="device",
                              updates_per_dispatch=k, training_steps=4 * k,
                              metrics_path=str(tmp_path / "m.jsonl"))
    tr = Trainer(cfg, device="cpu")
    getattr(tr, f"run_{mode}")()
    out = tr.metrics()
    assert out["step"] == 4 * k and out["replay_plane"] == "device"
    assert np.isfinite(out["loss"]) and tr.plane._pending is None
    # the learner's priorities reached the tree: leaves off their ingestion values
    assert len(open(tmp_path / "m.jsonl").readlines()) >= 1


def test_device_plane_needs_the_card_unless_asked_for_the_cpu():
    from r2d2_tpu_torch.train import Trainer

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tiny_test().replace(env_name="catch", replay_plane="device")
    with pytest.raises(RuntimeError):
        Trainer(cfg)
