"""The port's tiered replay plane (r2d2_tpu_torch/replay/tiered_store.py)
and its K-update consumer (learner.make_stacked_batch_train_step).

The host plane is the spec: from the same contents and Generator, a K-batch
window stack equals K host samples bit for bit, through fresh arrays and
through a staging ring's buffers, with the numpy and the native gathers;
draws and priority write-backs equal the JAX package's TieredReplayBuffer's,
the sum tree included; the prefetch pipeline delivers the direct stream and
its stop with rewind puts the Generator back exactly. K stacked steps equal
K single steps bit for bit on the CPU, and JAX's stacked step from converted
parameters at the learner parity test's tolerances (rtol 1e-4 / atol 1e-5).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import R2D2Config as RefConfig
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_stacked_batch_train_step as jax_stacked_step
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.tiered_store import TieredReplayBuffer as RefTiered
from r2d2_tpu_torch.config import R2D2Config, tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    TrainState,
    make_optimizer,
    make_stacked_batch_train_step,
    make_train_step,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.tiered_store import (
    STAGED_FIELDS,
    StagingRing,
    TieredPrefetchPipeline,
    TieredReplayBuffer,
    stage_chunk,
    staged_specs,
)
from r2d2_tpu_torch.utils.profiling import TransferTimer

torch.set_num_threads(1)

SMALL = dict(obs_shape=(3, 3, 1), action_dim=3, hidden_dim=4, burn_in_steps=4,
             learning_steps=4, forward_steps=2, block_length=12, buffer_capacity=48,
             learning_starts=12, batch_size=5, replay_plane="tiered")


def small_cfg(cls=R2D2Config, **kw):
    return cls(**{**SMALL, **kw}).validate()


def _fill(buf, acc_cls, cfg, n=6):
    """Full, short and terminal blocks: every clamp of the window gather."""
    for i in range(n):
        steps = [12, 12, 7, 12, 5, 12][i % 6]
        acc = acc_cls(cfg)
        acc.reset(np.full(cfg.obs_shape, 7, dtype=np.uint8))
        rng = np.random.default_rng(i)
        for k in range(steps):
            t = 13 * i + k
            acc.add(action=t % 3, reward=float(rng.normal()),
                    next_obs=rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8),
                    q_value=rng.normal(size=3).astype(np.float32),
                    hidden=rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
        buf.add_block(*acc.finish(last_qval=None if i % 3 == 2
                                  else rng.normal(size=3).astype(np.float32)))


def _pair(**kw):
    cfg = small_cfg(**kw)
    host, tiered = ReplayBuffer(cfg), TieredReplayBuffer(cfg)
    _fill(host, SequenceAccumulator, cfg)
    _fill(tiered, SequenceAccumulator, cfg)
    return cfg, host, tiered


def _assert_stack_is_host_draws(sw, host, rng, k):
    for j in range(k):
        b = host.sample_batch(rng)
        for name in STAGED_FIELDS + ("idxes",):
            np.testing.assert_array_equal(getattr(sw, name)[j], getattr(b, name),
                                          err_msg=f"batch {j} {name}")
        assert (sw.old_ptr, sw.env_steps, sw.old_advances) == (b.old_ptr, b.env_steps,
                                                                b.old_advances)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_window_stack_is_k_host_samples(native, precision, k):
    cfg, host, tiered = _pair(use_native_replay=native, precision=precision)
    rt, rh = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        sw = tiered.sample_window_stack(rt, k)
        assert sw.action.dtype == np.int32
        _assert_stack_is_host_draws(sw, host, rh, k)
    assert rt.bit_generator.state == rh.bit_generator.state


@pytest.mark.parametrize("native", [True, False])
def test_window_stack_into_ring_buffers_is_k_host_samples(native):
    cfg, host, tiered = _pair(use_native_replay=native)
    ring = StagingRing(staged_specs(cfg, 2), "cpu")
    rt, rh = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        i = ring.acquire()
        sw = tiered.sample_window_stack(rt, 2, out=ring.host_np[i])
        assert all(getattr(sw, name) is ring.host_np[i][name] for name in STAGED_FIELDS)
        _assert_stack_is_host_draws(sw, host, rh, 2)
        ring.release(i)


def test_numpy_and_native_gathers_agree():
    _, _, a = _pair(use_native_replay=True)
    _, _, b = _pair(use_native_replay=False)
    assert a.native is not None and b.native is None
    ra, rb = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(3):
        sa, sb = a.sample_window_stack(ra, 4), b.sample_window_stack(rb, 4)
        for name in STAGED_FIELDS + ("idxes",):
            np.testing.assert_array_equal(getattr(sa, name), getattr(sb, name), err_msg=name)


def test_draws_and_writebacks_match_jax():
    """Equal contents and Generator: the port's and JAX's tiered stores draw
    the same stacks and, after the same write-backs, hold the same tree
    (both on the numpy paths; test_torch_native.py holds the native core)."""
    cfg = small_cfg(use_native_replay=False)
    jcfg = small_cfg(RefConfig, use_native_replay=False)
    ours, ref = TieredReplayBuffer(cfg), RefTiered(jcfg)
    _fill(ours, SequenceAccumulator, cfg)
    _fill(ref, RefAccumulator, jcfg)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(5):
        sa, sb = ours.sample_window_stack(ra, 3), ref.sample_window_stack(rb, 3)
        for name in STAGED_FIELDS + ("idxes",):
            np.testing.assert_array_equal(getattr(sa, name), getattr(sb, name), err_msg=name)
        td = np.random.default_rng(i).random(sa.idxes.shape).astype(np.float32)
        for row, idx in zip(td, sa.idxes):
            ours.update_priorities(idx, row, sa.old_ptr, sa.old_advances)
            ref.update_priorities(idx, row, sb.old_ptr, sb.old_advances)
        if i == 2:  # blocks land between two draws on both sides
            _fill(ours, SequenceAccumulator, cfg, 2)
            _fill(ref, RefAccumulator, jcfg, 2)
    np.testing.assert_array_equal(ours.tree.leaves(), ref.tree.leaves())
    np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)


def test_full_lap_writeback_is_rejected():
    cfg, _, tiered = _pair()
    sw = tiered.sample_window_stack(np.random.default_rng(0), 2)
    _fill(tiered, SequenceAccumulator, cfg, cfg.num_blocks)  # one whole lap
    assert tiered.block_ptr == sw.old_ptr
    tree = tiered.tree.tree.copy()
    for idx in sw.idxes:
        tiered.update_priorities(idx, np.full(idx.shape, 50.0, np.float32), sw.old_ptr,
                                 sw.old_advances)
    np.testing.assert_array_equal(tiered.tree.tree, tree)


def test_stage_chunk_is_the_stack_in_ring_order():
    cfg, host, tiered = _pair(precision="bf16")
    ring = StagingRing(staged_specs(cfg, 2), "cpu")
    timer = TransferTimer()
    rt, rh = np.random.default_rng(4), np.random.default_rng(4)
    chunks = [stage_chunk(tiered, rt, 2, ring, timer) for _ in range(2)]
    assert [c.slot for c in chunks] == [0, 1] and timer.chunks == 2
    for c in chunks:
        assert c.event is None
        assert c.batch["hidden"].dtype == torch.int16  # bf16 bits
        batch = DeviceBatch.from_staged(c.batch)
        assert batch.hidden.dtype == torch.bfloat16 and batch.action.dtype == torch.int64
        for j in range(2):
            b = host.sample_batch(rh)
            np.testing.assert_array_equal(batch.obs[j].numpy(), b.obs)
            np.testing.assert_array_equal(batch.action[j].numpy(), b.action)
            np.testing.assert_array_equal(batch.last_action[j].numpy(), b.last_action)
            np.testing.assert_array_equal(
                batch.hidden[j].view(torch.int16).numpy().view(np.uint16), b.hidden)
            np.testing.assert_array_equal(c.idxes[j], b.idxes)
        ring.release(c.slot)
    assert stage_chunk(tiered, rt, 2, ring).slot == 0


def test_pipeline_delivers_the_direct_stream_and_stops_with_rewind():
    cfg, _, tiered = _pair()
    ref = TieredReplayBuffer(cfg)
    _fill(ref, SequenceAccumulator, cfg)
    ring, ref_ring = (StagingRing(staged_specs(cfg, 2), "cpu") for _ in range(2))
    rng, rng_ref = np.random.default_rng(11), np.random.default_rng(11)
    pipe = TieredPrefetchPipeline(tiered, rng, 2, ring, timer=TransferTimer())
    try:
        for _ in range(3):
            got, want = pipe.get(), stage_chunk(ref, rng_ref, 2, ref_ring)
            np.testing.assert_array_equal(got.idxes, want.idxes)
            for name in STAGED_FIELDS:
                assert torch.equal(got.batch[name], want.batch[name]), name
            ring.release(got.slot)
            ref_ring.release(want.slot)
    finally:
        pipe.stop(rewind=True)
    assert not pipe._thread.is_alive()
    # the chunks staged ahead were discarded and their draws rewound: the
    # Generator stands where the consumer's next chunk begins
    assert rng.bit_generator.state == rng_ref.bit_generator.state
    assert all(ring._free)


def test_pipeline_error_surfaces_in_get():
    cfg, _, tiered = _pair()

    def boom(*a, **kw):
        raise RuntimeError("synthetic stage failure")

    tiered.sample_window_stack = boom
    ring = StagingRing(staged_specs(cfg, 2), "cpu")
    pipe = TieredPrefetchPipeline(tiered, np.random.default_rng(0), 2, ring)
    try:
        with pytest.raises(RuntimeError, match="staging thread died"):
            pipe.get()
    finally:
        pipe.stop()
    assert all(ring._free)  # the failed stage handed its slot back


# ------------------------------------------------------ the stacked update

K = 3


def _batches(cfg, seed, k=K):
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    out = []
    for _ in range(k):
        burn = rng.choice([0, 2, cfg.burn_in_steps], size=B).astype(np.int32)
        learn = np.full(B, L, np.int32)
        learn[-1] = L - 1
        out.append(dict(
            obs=rng.integers(0, 256, size=(B, T, *cfg.obs_shape), dtype=np.uint8),
            last_action=rng.integers(0, cfg.action_dim, size=(B, T)).astype(np.int32),
            last_reward=rng.normal(size=(B, T)).astype(np.float32),
            hidden=(rng.normal(size=(B, 2, cfg.hidden_dim)) * 0.5).astype(np.float32),
            action=rng.integers(0, cfg.action_dim, size=(B, L)).astype(np.int32),
            n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
            gamma=np.full((B, L), cfg.gamma ** cfg.forward_steps, np.float32),
            burn_in_steps=burn, learning_steps=learn,
            forward_steps=np.minimum(T - burn - learn, cfg.forward_steps).astype(np.int32),
            is_weights=rng.uniform(0.3, 1.0, size=B).astype(np.float32),
        ))
    return out


class _Sampled:
    task = None

    def __init__(self, d):
        self.__dict__.update(d)


def _stack(dev_batches):
    return type(dev_batches[0])(*(torch.stack(x) for x in zip(*dev_batches)))


def _port_state(cfg, tree):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(tree))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


def test_stacked_step_is_k_single_steps_bit_for_bit():
    cfg = tiny_test().replace(target_net_update_interval=2)
    jcfg = jax_tiny_test().replace(target_net_update_interval=2)
    tree = jax.tree.map(np.asarray, jax_init_train_state(jcfg, jax.random.PRNGKey(0))[1].params)
    a, b = _port_state(cfg, tree), _port_state(cfg, tree)
    batches = [DeviceBatch.from_sampled(_Sampled(d), "cpu") for d in _batches(cfg, 1)]
    a, ma, pa = make_stacked_batch_train_step(cfg, K)(a, _stack(batches))
    one = make_train_step(cfg)
    prios = []
    for batch in batches:
        b, mb, p = one(b, batch)
        prios.append(p)
    assert a.step == b.step == K
    assert torch.equal(pa, torch.stack(prios)) and pa.shape == (K, cfg.batch_size)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in ((a.net, b.net), (a.target_net, b.target_net)):
        for (n, u), v in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(u, v), n
    with pytest.raises(ValueError, match="expected 3"):
        make_stacked_batch_train_step(cfg, K)(a, _stack(batches[:2]))


def test_stacked_step_matches_jax():
    kw = dict(target_net_update_interval=2)
    jcfg = jax_tiny_test().replace(lstm_backend="pallas", **kw)
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    cfg = tiny_test().replace(**kw)
    pstate = _port_state(cfg, jax.tree.map(np.asarray, jstate.params))
    data = _batches(cfg, 7)
    jstacked = jax.tree.map(lambda *x: np.stack(x),
                            *[JaxBatch.from_sampled(_Sampled(d)) for d in data])
    jstate, jm, jprio = jax_stacked_step(jcfg, net, K, donate=False)(jstate, jstacked)
    pstate, pm, pprio = make_stacked_batch_train_step(cfg, K)(
        pstate, _stack([DeviceBatch.from_sampled(_Sampled(d), "cpu") for d in data]))
    for k in ("loss", "grad_norm", "q_mean"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pprio.numpy(), np.asarray(jprio), rtol=1e-4, atol=1e-5)
    assert pstate.step == int(jstate.step) == K
    for port, ref in ((pstate.net, jstate.params), (pstate.target_net, jstate.target_params)):
        flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref))[0]
        flat_t = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(port))[0])
        for path, v in flat_j:
            np.testing.assert_allclose(flat_t[path], v, rtol=1e-4, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))


def test_the_tiered_config_is_validated_as_jax_validates():
    base = {f.name: getattr(tiny_test(), f.name) for f in dataclasses.fields(R2D2Config)}
    # the port has every plane of the JAX package (the sharded one needs a
    # dp mesh, as JAX's does), and any other value is unknown
    with pytest.raises(ValueError, match="unknown replay_plane 'shared'"):
        tiny_test().replace(replay_plane="shared")
    for kw in (dict(replay_plane="sharded"), dict(updates_per_dispatch=0),
               dict(replay_plane="tiered", updates_per_dispatch=3, training_steps=50),
               dict(deterministic_staging=True), dict(snapshot_every=-1),
               dict(snapshot_every=5)):
        with pytest.raises(ValueError) as ours:
            R2D2Config(**{**base, **kw}).validate()
        with pytest.raises(ValueError) as theirs:
            jax_tiny_test().replace(**kw)
        assert str(ours.value).split(" (")[0] == str(theirs.value).split(" (")[0]
    cfg = tiny_test().replace(replay_plane="tiered", updates_per_dispatch=5,
                              deterministic_staging=True, snapshot_replay=True,
                              snapshot_every=10)
    assert cfg.updates_per_dispatch == 5
