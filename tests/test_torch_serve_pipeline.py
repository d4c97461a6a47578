"""The port's depth-2 serve pipeline on the CPU, as
tests/test_serve_pipeline.py holds the JAX package's: pipelined against
serial bit for bit (actions, q, the exploration stream and the written
carries) in fp32 and bf16 and with mixed-task buckets, a mid-pipeline
reload keeping each batch's provenance, one session's back-to-back requests
across the pipeline's depth, the staging buffers reused, and the deferred
serve metrics. tiny_test shapes.

The deterministic drives build batches through the real batcher (submit,
next_batch) and run the pipeline by hand: batch k + 1 is staged and
dispatched before batch k completes, the overlap the completion worker
makes, with a batch composition reproducible enough to compare bit for
bit against the serial path.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.serve import PolicyServer, ServeConfig
from r2d2_tpu_torch.serve.batcher import BucketStaging

torch.set_num_threads(1)

CFG = tiny_test()
SCFG = ServeConfig(buckets=(2, 4, 8), max_wait_ms=3.0, cache_capacity=64, epsilon=0.3)


def _spec_stream(rng, cfg, n_batches, sessions, tasks=None, shapes=None):
    """One batch's (sid, obs, reward, reset, task) rows per entry, sessions
    recurring across consecutive batches."""
    out = []
    for b in range(n_batches):
        rows = []
        for i in range(1 + b % min(4, len(sessions))):
            sid = sessions[(b + i) % len(sessions)]
            shape = tuple(cfg.obs_shape) if shapes is None else shapes[sid]
            rows.append((sid, rng.integers(0, 255, shape, dtype=np.uint8),
                         float(rng.normal()), bool(b > 0 and i == 0 and b % 5 == 0),
                         0 if tasks is None else tasks[sid]))
        out.append(rows)
    return out


def _submit_batch(srv, rows):
    futures = [srv.submit(sid, obs, reward=reward, reset=reset, task=task)
               for sid, obs, reward, reset, task in rows]
    batch = srv.batcher.next_batch(timeout=1.0)
    assert len(batch) == len(rows)
    return batch, futures


def _drive_serial(srv, specs):
    results = []
    for rows in specs:
        batch, futures = _submit_batch(srv, rows)
        srv._run_batch(batch)
        results.append([f.result(timeout=5.0) for f in futures])
    return results


def _drive_pipelined(srv, specs, depth=2):
    """Batch k + 1 staged and dispatched before batch k completes."""
    pending, futures_all = deque(), []
    for rows in specs:
        batch, futures = _submit_batch(srv, rows)
        pending.append(srv._stage_and_dispatch(batch))
        futures_all.append(futures)
        if len(pending) == depth:
            srv._complete(pending.popleft())
    while pending:
        srv._complete(pending.popleft())
    return [[f.result(timeout=5.0) for f in futures] for futures in futures_all]


def _assert_bitwise_equal(res_a, res_b, srv_a, srv_b):
    for batch_a, batch_b in zip(res_a, res_b):
        for ra, rb in zip(batch_a, batch_b):
            assert ra.action == rb.action and ra.bucket == rb.bucket and ra.row == rb.row
            np.testing.assert_array_equal(ra.q, rb.q)
    # the whole exploration stream was drawn alike, not only the draws that
    # happened to pick equal actions
    assert srv_a._rng.bit_generator.state == srv_b._rng.bit_generator.state
    for a, b in zip(srv_a.cache.arrays(), srv_b.cache.arrays()):
        assert torch.equal(a, b)


def _pair(cfg, serve_cfg):
    """A serial and a pipelined server from the same seed: the same
    parameters and exploration stream."""
    srv_ser = PolicyServer(cfg.replace(serve_pipeline=False), serve_cfg, device="cpu")
    srv_pipe = PolicyServer(cfg.replace(serve_pipeline=True), serve_cfg, device="cpu")
    srv_ser.warmup()
    srv_pipe.warmup()
    return srv_ser, srv_pipe


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_pipelined_matches_serial_bitwise(precision):
    """With exploration on (epsilon 0.3: every batch draws), the pipelined
    path answers every request as the serial one does, bit for bit: actions,
    q, the stream's state after the run and the written carries."""
    cfg = CFG.replace(precision=precision)
    srv_ser, srv_pipe = _pair(cfg, SCFG)
    sessions = [f"s{i}" for i in range(6)]
    res_ser = _drive_serial(srv_ser, _spec_stream(np.random.default_rng(7), cfg, 12, sessions))
    res_pipe = _drive_pipelined(srv_pipe,
                                _spec_stream(np.random.default_rng(7), cfg, 12, sessions))
    _assert_bitwise_equal(res_ser, res_pipe, srv_ser, srv_pipe)
    assert srv_pipe.cache.h.dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)


def test_pipelined_matches_serial_mixed_task_buckets():
    """Mixed-task (and mixed-shape) buckets with task-native exploration
    draws, in the same arrival order pipelined."""
    from r2d2_tpu_torch.multitask import build_registry

    cfg, specs = build_registry(CFG, ["drift", "banditgrid"])
    srv_ser, srv_pipe = _pair(cfg, SCFG)
    sessions = [f"mt{i}" for i in range(5)]
    tasks = {sid: i % len(specs) for i, sid in enumerate(sessions)}
    shapes = {sid: tuple(cfg.obs_shape) for sid in sessions}
    shapes[sessions[1]] = (8, 8, 1)  # padded to the union geometry at stage time

    def stream():
        return _spec_stream(np.random.default_rng(3), cfg, 10, sessions, tasks, shapes)

    res_ser = _drive_serial(srv_ser, stream())
    res_pipe = _drive_pipelined(srv_pipe, stream())
    _assert_bitwise_equal(res_ser, res_pipe, srv_ser, srv_pipe)
    for rows, batch in zip(stream(), res_pipe):
        for (sid, *_), res in zip(rows, batch):
            assert res.action < specs[tasks[sid]].action_dim


def test_mid_pipeline_reload_keeps_staged_provenance():
    """A batch dispatched under version v resolves stamped v though a
    reload lands before it completes; the next batch takes the new one."""
    srv = PolicyServer(CFG.replace(serve_pipeline=True), SCFG, device="cpu")
    srv.warmup()
    rng = np.random.default_rng(5)
    old_step, old_version = srv._published[1], srv._published[2]
    rows = [("pv-a", rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8), 0.0, False, 0)]
    batch, futures = _submit_batch(srv, rows)
    rec = srv._stage_and_dispatch(batch)
    srv.publish(srv.served_params(), ckpt_step=old_step + 1)
    srv._complete(rec)
    res = futures[0].result(timeout=5.0)
    assert (res.ckpt_step, res.params_version) == (old_step, old_version)
    batch2, futures2 = _submit_batch(srv, rows)
    srv._complete(srv._stage_and_dispatch(batch2))
    res2 = futures2[0].result(timeout=5.0)
    assert (res2.ckpt_step, res2.params_version) == (old_step + 1, old_version + 1)


def test_same_session_back_to_back_across_pipeline_depth():
    """Immediate submits of one session on a started pipelined server: the
    batcher defers each next one into a later batch, staged while the one
    before completes; every answer sees the previous one's carry (equal to
    the serial server's sequential answers bit for bit)."""
    scfg = ServeConfig(buckets=(2, 4), max_wait_ms=2.0, cache_capacity=16, epsilon=0.3)
    srv_ser, srv_pipe = _pair(CFG, scfg)
    rng = np.random.default_rng(9)
    obs = [rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8) for _ in range(4)]
    ref = []
    for t, o in enumerate(obs):
        b, fs = _submit_batch(srv_ser, [("bb", o, float(t), False, 0)])
        srv_ser._run_batch(b)
        ref.append(fs[0].result(timeout=5.0))
    srv_pipe.start(watch_checkpoints=False)
    try:
        futures = [srv_pipe.submit("bb", o, reward=float(t)) for t, o in enumerate(obs)]
        got = [f.result(timeout=30.0) for f in futures]
    finally:
        srv_pipe.stop()
    for r_ref, r_got in zip(ref, got):
        assert r_ref.action == r_got.action
        np.testing.assert_array_equal(r_ref.q, r_got.q)
    assert srv_pipe.completed_batches == len(obs)
    assert srv_ser._rng.bit_generator.state == srv_pipe._rng.bit_generator.state


def test_staging_reuses_buffers_zero_alloc():
    """A warm bucket's assembly writes into its two buffer sets in turn."""
    staging = BucketStaging((2, 4), num_tasks=1)

    class _Req:
        def __init__(self, r):
            self.reward, self.reset, self.task = r, False, 0

    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 255, (4, 4, 1), dtype=np.uint8) for _ in range(3)]
    reqs = [_Req(float(i)) for i in range(3)]
    ids = []
    for _ in range(6):
        staged = staging.stage(reqs, 4, rows, 0.1)
        ids.append((id(staged.obs), id(staged.rewards), id(staged.slots)))
        np.testing.assert_array_equal(staged.obs[:3], np.stack(rows))
        np.testing.assert_array_equal(staged.obs[3], 0)
        np.testing.assert_array_equal(staged.rewards, np.array([0.0, 1.0, 2.0, 0.0], np.float32))
        assert staged.reset_mask[3]  # pad rows reset
    assert len(set(ids)) == 2
    assert ids[0] == ids[2] == ids[4] and ids[1] == ids[3] == ids[5]


def test_serve_log_interval_defers_metrics():
    """serve_log_interval > 0: a metrics row on the cadence and at every
    params version's first batch, the skipped batches counted; 0.0 logs
    every batch."""

    class _Sink:
        def __init__(self):
            self.rows = []

        def log(self, row):
            self.rows.append(row)

    cfg = CFG.replace(serve_pipeline=False, serve_log_interval=3600.0)
    sink = _Sink()
    srv = PolicyServer(cfg, SCFG, metrics=sink, device="cpu")
    srv.warmup()
    rng = np.random.default_rng(2)
    _drive_serial(srv, _spec_stream(rng, cfg, 5, ["m0", "m1"]))
    assert len(sink.rows) == 1 and srv.metrics_skipped == 4
    assert srv.stats()["metrics_skipped"] == 4 and sink.rows[0]["completed_batches"] == 1
    srv.publish(srv.served_params(), ckpt_step=123)
    _drive_serial(srv, _spec_stream(rng, cfg, 1, ["m0", "m1"]))
    assert len(sink.rows) == 2 and sink.rows[-1]["params_version"] > sink.rows[0]["params_version"]
    sink0 = _Sink()
    srv0 = PolicyServer(CFG.replace(serve_pipeline=False), SCFG, metrics=sink0, device="cpu")
    srv0.warmup()
    _drive_serial(srv0, _spec_stream(np.random.default_rng(2), CFG, 4, ["m0", "m1"]))
    assert len(sink0.rows) == 4 and srv0.metrics_skipped == 0


def test_pipelined_e2e_parity_under_started_server():
    """Started servers over the real threads, one submitter waiting for each
    answer: pipelined and serial answer alike bit for bit."""
    scfg = ServeConfig(buckets=(2, 4), max_wait_ms=2.0, cache_capacity=16)
    srv_ser, srv_pipe = _pair(CFG, scfg)
    rng = np.random.default_rng(13)
    stream = [(f"e2e-{t % 3}", rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8),
               float(rng.normal())) for t in range(9)]
    out = {}
    for name, srv in (("ser", srv_ser), ("pipe", srv_pipe)):
        srv.start(watch_checkpoints=False)
        try:
            out[name] = [srv.submit(sid, obs, reward=rw).result(timeout=30.0)
                         for sid, obs, rw in stream]
        finally:
            srv.stop()
    for a, b in zip(out["ser"], out["pipe"]):
        assert a.action == b.action
        np.testing.assert_array_equal(a.q, b.q)
    assert srv_pipe.completed_batches == srv_ser.completed_batches == len(stream)
