"""The port's serving plane (r2d2_tpu_torch/serve) on the CPU, as
tests/test_serve.py holds the JAX package's: tiny_test shapes.

- against the JAX package: from the same parameters (JAX's init converted
  by interop.params_from_flax), a recorded stream of interleaved sessions
  served by the port matches JAX's reference_act replaying it (Q to 1e-5;
  actions equal wherever the Q gap exceeds that); the micro-batcher forms
  the same batches and deferrals as JAX's from one seeded stream; JAX's
  PolicyClient talks to the port's serve_tcp;
- against itself: every answer bit for bit equal to the port's own
  reference_act at the bucket it was served at, under concurrent sessions,
  evictions, hot reloads, crash recovery, int8 weights and mixed-task
  buckets; the step-shape count bounded by the buckets; a full queue
  failing fast.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu.serve import MicroBatcher as JaxMicroBatcher
from r2d2_tpu.serve import PolicyClient as JaxPolicyClient
from r2d2_tpu.serve import reference_act as jax_reference_act
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.learner import init_train_state
from r2d2_tpu_torch.ops.quantize import dequantize_tree, quantize_tree
from r2d2_tpu_torch.serve import (
    LocalClient,
    MicroBatcher,
    PolicyClient,
    PolicyServer,
    QueueFullError,
    ServeConfig,
    reference_act,
    serve_tcp,
)
from r2d2_tpu_torch.serve.batcher import ServeRequest
from r2d2_tpu_torch.serve.server import _pad_obs
from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache
from r2d2_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

CFG = tiny_test()
CPU = "cpu"


def server(cfg=CFG, serve_cfg=None, **kw):
    return PolicyServer(cfg, serve_cfg or ServeConfig(buckets=(2, 4, 8), max_wait_ms=3.0,
                                                      cache_capacity=64), device=CPU, **kw)


@pytest.fixture(scope="module")
def base_server():
    srv = server()
    srv.warmup()
    srv.start()
    yield srv
    srv.stop()


class SessionReference:
    """The direct per-session acting path: replays a recorded request stream
    through reference_act (the port's, or JAX's), carrying (h, c, last
    action) as the training episode-start rules do."""

    def __init__(self, net, hidden_dim: int, act=reference_act, task=None):
        self.net, self.act = net, act
        self.h = np.zeros((1, hidden_dim), np.float32)
        self.c = np.zeros((1, hidden_dim), np.float32)
        self.last_action = np.zeros(1, np.int32)
        self.task = None if task is None else np.array([task], np.int32)
        self.started = False

    def step(self, params, obs, reward: float, reset: bool, bucket: int = 0, row: int = 0):
        """`bucket` and `row` (ServeResult's) place the session where the
        server ran it; JAX's reference_act takes the bucket alone."""
        if reset or not self.started:
            self.h, self.c = np.zeros_like(self.h), np.zeros_like(self.c)
            self.last_action = np.zeros(1, np.int32)
            reward = 0.0
            self.started = True
        kw = {} if self.task is None else {"task": self.task}
        if self.act is reference_act:
            kw["row"] = row
        q, (h, c) = self.act(self.net, params, obs[None], self.last_action,
                             np.array([reward], np.float32), (self.h, self.c),
                             min_batch=max(int(bucket), 2), **kw)
        self.h, self.c = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                          for x in (h, c))
        q = np.asarray(q.cpu() if isinstance(q, torch.Tensor) else q)[0]
        action = int(np.argmax(q))
        self.last_action = np.array([action], np.int32)
        return q, action


def _interleaved(srv, client, cfg, n_sessions, n_steps, seed, prefix, task_of=None):
    """Concurrent session threads (mixed batch compositions): -> per session
    [(obs, reward, reset, result)]."""
    rng = np.random.default_rng(seed)
    streams = [[(rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8), float(rng.normal()),
                 bool(t == 6 and s == 2)) for t in range(n_steps)] for s in range(n_sessions)]
    records = [[] for _ in range(n_sessions)]
    barrier = threading.Barrier(n_sessions)

    def run(s):
        barrier.wait()
        kw = {} if task_of is None else {"task": task_of(s)}
        for obs, reward, reset in streams[s]:
            res = client.act(f"{prefix}-{s}", obs, reward=reward, reset=reset, **kw)
            records[s].append((obs, reward, reset, res))

    threads = [threading.Thread(target=run, args=(s,)) for s in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert all(len(r) == n_steps for r in records)
    return records


# ------------------------------------------------------- against the JAX package


def _jax_pair(cfg_kw=None, seed=3):
    """JAX's network and parameters, and the port's cfg with them converted."""
    jcfg = jax_tiny_test().replace(**(cfg_kw or {}))
    jnet, jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    return jnet, jparams, tiny_test().replace(**(cfg_kw or {})), params_from_flax(jparams)


def test_served_stream_matches_jax_reference_act():
    """The port's server answers a stream of interleaved sessions as JAX's
    direct acting path does on the same parameters: Q to 1e-5, the action
    wherever the best two Q values are more than 1e-5 apart."""
    jnet, jparams, cfg, params = _jax_pair()
    srv = server(cfg, params=params)
    srv.warmup()
    srv.start()
    try:
        records = _interleaved(srv, LocalClient(srv), cfg, 5, 10, 21, "jx")
    finally:
        srv.stop()
    compared = 0
    for recs in records:
        ref = SessionReference(jnet, cfg.hidden_dim, act=jax_reference_act)
        for obs, reward, reset, res in recs:
            q_ref, a_ref = ref.step(jparams, obs, reward, reset, bucket=res.bucket)
            np.testing.assert_allclose(np.asarray(res.q), q_ref, rtol=0, atol=1e-5)
            top2 = np.sort(q_ref)[-2:]
            if top2[1] - top2[0] > 1e-5:
                assert res.action == a_ref
                compared += 1
            # JAX's reference carried on from its own action: keep both on
            # one trajectory where they tie
            ref.last_action = np.array([res.action], np.int32)
    assert compared > 40


def _request_stream(seed, n=120):
    rng = np.random.default_rng(seed)
    return [(f"s{int(rng.integers(0, 6))}", float(rng.normal()), bool(rng.random() < 0.1))
            for _ in range(n)]


def test_batcher_forms_jax_batches():
    """From one seeded stream, submitted in the same order, the port's
    micro-batcher forms the same batches (sessions, rewards, resets, in
    order) and defers the same second requests as JAX's."""
    stream = _request_stream(5)
    out = {}
    for name, cls in (("port", MicroBatcher), ("jax", JaxMicroBatcher)):
        b = cls(buckets=(2, 4, 8), max_wait_s=0.0, queue_depth=1024)
        for sid, reward, reset in stream:
            b.submit(sid, np.zeros(1), reward=reward, reset=reset)
        batches = []
        while True:
            batch = b.next_batch(timeout=0.01)
            if not batch:
                break
            batches.append([(r.session_id, r.reward, r.reset) for r in batch])
        out[name] = (batches, b.deferrals, b.stats()["mean_batch_occupancy"],
                     [b.bucket_for(n) for n in range(1, 9)])
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0  # the stream made deferrals


def test_jax_client_talks_to_the_port_server(base_server):
    """The wire format is the JAX package's: its PolicyClient against the
    port's serve_tcp."""
    srv = base_server
    tcp, _ = serve_tcp(srv, port=0)
    try:
        obs = np.random.default_rng(4).integers(0, 255, CFG.obs_shape, dtype=np.uint8)
        with JaxPolicyClient(port=tcp.server_address[1]) as remote:
            resp = remote.act("jax-tcp", obs, reset=True, want_q=True)
            ref = SessionReference(srv.net, CFG.hidden_dim)
            q_ref, a_ref = ref.step(srv.served_params(), obs, 0.0, True)
            assert resp["action"] == a_ref
            np.testing.assert_array_equal(np.asarray(resp["q"], np.float32), q_ref)
            remote.evict("jax-tcp")
            assert "jax-tcp" not in srv.cache
    finally:
        tcp.shutdown()
        tcp.server_close()


# ------------------------------------------------------------ against itself


def test_batched_parity_interleaved_sessions(base_server):
    """Concurrent sessions make batches of mixed composition; every answer
    is bit for bit the port's reference_act at the bucket it was served at."""
    srv = base_server
    params = srv.served_params()
    for recs in _interleaved(srv, LocalClient(srv), CFG, 5, 12, 1, "parity"):
        ref = SessionReference(srv.net, CFG.hidden_dim)
        for obs, reward, reset, res in recs:
            q_ref, a_ref = ref.step(params, obs, reward, reset, bucket=res.bucket, row=res.row)
            np.testing.assert_array_equal(q_ref, np.asarray(res.q))
            assert a_ref == res.action


def test_eviction_and_readmission(base_server):
    """A session evicted is admitted fresh: its next answer is the reference
    restarted from the zero state."""
    srv = base_server
    client = LocalClient(srv)
    rng = np.random.default_rng(2)
    obs0, obs1 = (rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8) for _ in range(2))
    client.act("evict-me", obs0, reset=True)
    assert srv.cache.evict("evict-me")
    res = client.act("evict-me", obs1, reward=1.5)
    ref = SessionReference(srv.net, CFG.hidden_dim)
    q_ref, a_ref = ref.step(srv.served_params(), obs1, 1.5, reset=True, bucket=res.bucket,
                            row=res.row)
    np.testing.assert_array_equal(q_ref, np.asarray(res.q))
    assert a_ref == res.action
    client.act("keeper", obs0, reset=True)
    assert not np.array_equal(q_ref, np.asarray(client.act("keeper", obs1, reward=1.5).q))


def test_state_cache_lru():
    cache = RecurrentStateCache(capacity=2, hidden_dim=4, device=CPU)
    cache.assign(["a"])
    cache.assign(["b"])
    cache.assign(["a"])  # b becomes the LRU
    _, fresh_c = cache.assign(["c"])
    assert fresh_c[0]
    assert "b" not in cache and "a" in cache
    _, fresh_b = cache.assign(["b"])
    assert fresh_b[0]
    assert cache.evictions == 2
    with pytest.raises(ValueError):
        cache.assign(["x", "x"])
    assert cache.pad_slot == 2
    assert cache.session_carry_bytes == 2 * 4 * 4
    assert cache.device_bytes() == 3 * (4 + 4) * 4 + 3 * 4 + 3 * 4


def test_step_shapes_bounded_by_buckets(base_server):
    """Warmup ran each bucket once; the module's traffic (parity threads,
    evictions, the TCP round trips) added no step shape."""
    assert base_server.trace_count == len(base_server.batcher.buckets)
    assert base_server.stats()["trace_count"] == base_server.trace_count


# ------------------------------------------------------------ micro-batcher


def test_batcher_same_session_deferred():
    b = MicroBatcher(buckets=(2, 4), max_wait_s=0.01, queue_depth=16)
    b.submit("s", np.zeros(1), reset=True)
    b.submit("s", np.zeros(1))
    b.submit("t", np.zeros(1))
    assert sorted(r.session_id for r in b.next_batch(timeout=0.1)) == ["s", "t"]
    assert [r.session_id for r in b.next_batch(timeout=0.1)] == ["s"]
    assert b.deferrals == 1
    assert b.bucket_for(1) == 2 and b.bucket_for(3) == 4


def _deferred_req(session_id: str) -> ServeRequest:
    return ServeRequest(session_id=session_id, obs=np.zeros(1), reward=0.0, reset=False,
                        future=Future(), t_enqueue=time.monotonic())


def test_take_deferred_duplicate_sessions():
    b = MicroBatcher(buckets=(2, 4), max_wait_s=0.001)
    for sid in ("a", "a", "b", "a", "c"):
        b._deferred.append(_deferred_req(sid))
    batch, seen = [], set()
    b._take_deferred(batch, seen)
    assert [r.session_id for r in batch] == ["a", "b", "c"]
    assert [r.session_id for r in b._deferred] == ["a", "a"]
    batch2 = []
    b._take_deferred(batch2, {"a"})
    assert batch2 == [] and len(b._deferred) == 2
    b2 = MicroBatcher(buckets=(2,))
    for sid in ("x", "y", "z"):
        b2._deferred.append(_deferred_req(sid))
    batch3 = []
    b2._take_deferred(batch3, set())
    assert [r.session_id for r in batch3] == ["x", "y"]
    assert [r.session_id for r in b2._deferred] == ["z"]


def test_drain_under_concurrent_submits():
    """drain() racing submit() threads loses and duplicates no request."""
    b = MicroBatcher(buckets=(2, 4), max_wait_s=0.001, queue_depth=10_000)
    n_threads, n_each = 4, 200
    futures = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads + 1)

    def spam(k):
        start.wait()
        for i in range(n_each):
            futures[k].append(b.submit(f"s{(k * n_each + i) % 3}", np.zeros(1)))

    threads = [threading.Thread(target=spam, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    recovered = []
    for _ in range(20):
        recovered.extend(b.next_batch(timeout=0.001))
        recovered.extend(b.drain())
    for t in threads:
        t.join(timeout=30.0)
    recovered.extend(b.drain())
    all_futs = [f for per in futures for f in per]
    got = [r.future for r in recovered]
    assert len(got) == len(set(got))
    assert set(got) == set(all_futs)
    assert b.stats()["rejected"] == 0 and b.qsize() == 0


def test_batcher_rejects_min_bucket_one():
    with pytest.raises(ValueError):
        MicroBatcher(buckets=(1, 4))


def test_server_rejects_cache_smaller_than_bucket():
    with pytest.raises(ValueError, match="cache_capacity"):
        server(serve_cfg=ServeConfig(buckets=(2, 8), cache_capacity=4))


def test_queue_overload_fails_fast():
    b = MicroBatcher(buckets=(2,), queue_depth=2)
    b.submit("a", np.zeros(1))
    b.submit("b", np.zeros(1))
    with pytest.raises(QueueFullError):
        b.submit("c", np.zeros(1)).result(timeout=1.0)
    assert b.stats()["rejected"] == 1


def test_cuda_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyServer(CFG, ServeConfig(buckets=(2,), cache_capacity=4))


# ------------------------------------------------- hot reload + supervision


def _scaled_state(srv, scale, step):
    """A TrainState like the server's template with its parameters scaled."""
    _, state = init_train_state(srv.cfg, CPU, seed=srv.serve_cfg.seed)
    with torch.no_grad():
        for p in state.net.parameters():
            p.mul_(scale)
    state.step = step
    return state


def test_hot_reload_e2e(tmp_path):
    """Catch sessions played to episode ends through the client while a new
    port checkpoint lands mid-traffic: every answer is the reference's under
    the params version that answered it, none dropped or torn."""
    from r2d2_tpu_torch.envs.catch import CatchHostEnv

    cfg = CFG.replace(action_dim=3)
    ckpt = str(tmp_path / "ckpt")
    srv = server(cfg, ServeConfig(buckets=(2, 4, 8), max_wait_ms=3.0, cache_capacity=64,
                                  poll_interval_s=0.05), checkpoint_dir=ckpt)
    save_checkpoint(ckpt, _scaled_state(srv, 1.0, 1), 0, 0.0)
    assert srv.reload_now()
    by_step = {1: srv.served_params()}
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    n, stop = 4, threading.Event()
    records, episodes, errors = [[] for _ in range(n)], [0] * n, []

    def run(i):
        env = CatchHostEnv(height=cfg.obs_shape[0], width=cfg.obs_shape[1], seed=i)
        obs, reward, reset = env.reset(), 0.0, True
        try:
            while not stop.is_set() or episodes[i] == 0:
                res = client.act(f"sess-{i}", obs, reward=reward, reset=reset)
                records[i].append((obs, reward, reset, res))
                obs, reward, done, _ = env.step(res.action)
                reset = done
                if done:
                    episodes[i] += 1
                    obs, reward = env.reset(), 0.0
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    save_checkpoint(ckpt, _scaled_state(srv, 1.05, 2), 0, 0.0)
    deadline = time.monotonic() + 20.0
    while srv._published[1] != 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv._published[1] == 2, "the watcher never published the new checkpoint"
    by_step[2] = srv.served_params()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        if all(any(r.ckpt_step == 2 for *_, r in rec) for rec in records) and min(episodes):
            break
        time.sleep(0.02)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    srv.check()
    srv.stop()
    assert not errors, errors
    assert srv.stats()["reloads"] == 2
    for i in range(n):
        assert any(r.ckpt_step == 2 for *_, r in records[i])
        ref = SessionReference(srv.net, cfg.hidden_dim)
        for obs, reward, reset, res in records[i]:
            q_ref, a_ref = ref.step(by_step[res.ckpt_step], obs, reward, reset,
                                    bucket=res.bucket, row=res.row)
            np.testing.assert_array_equal(q_ref, np.asarray(res.q))
            assert a_ref == res.action


def test_crash_recovery_preserves_sessions():
    """A raising serve iteration fails only the in-flight futures; the loop
    restarts and the retried request continues from the last written carry."""
    srv = server(serve_cfg=ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=8))
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    params = srv.served_params()
    rng = np.random.default_rng(3)
    obs = [rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8) for _ in range(2)]
    ref = SessionReference(srv.net, CFG.hidden_dim)
    res0 = client.act("s", obs[0], reset=True)
    ref.step(params, obs[0], 0.0, True, bucket=res0.bucket, row=res0.row)
    real = srv._serve_iteration
    armed = threading.Event()

    def bomb():
        armed.set()
        batch = srv.batcher.next_batch(timeout=0.25)
        if batch:
            srv._serve_iteration = real
            srv._inflight = batch
            raise RuntimeError("injected serve fault")

    srv._serve_iteration = bomb
    assert armed.wait(timeout=10.0)
    with pytest.raises(RuntimeError, match="retry"):
        srv.submit("s", obs[1], reward=0.5).result(timeout=10.0)
    deadline = time.monotonic() + 10.0
    while srv._serve_worker.restarts < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.check()["worker_restarts"] >= 1
    res1 = client.act("s", obs[1], reward=0.5)
    q_ref, a_ref = ref.step(params, obs[1], 0.5, False, bucket=res1.bucket,
                            row=res1.row)
    np.testing.assert_array_equal(q_ref, np.asarray(res1.q))
    assert a_ref == res1.action and res0.params_version == res1.params_version
    srv.stop()


def test_tcp_roundtrip(base_server):
    srv = base_server
    tcp, _ = serve_tcp(srv, port=0)
    try:
        obs = np.random.default_rng(4).integers(0, 255, CFG.obs_shape, dtype=np.uint8)
        with PolicyClient(port=tcp.server_address[1]) as remote:
            resp = remote.act("tcp-1", obs, reset=True, want_q=True)
            ref = SessionReference(srv.net, CFG.hidden_dim)
            q_ref, a_ref = ref.step(srv.served_params(), obs, 0.0, True)
            assert resp["action"] == a_ref
            np.testing.assert_array_equal(np.asarray(resp["q"], np.float32), q_ref)
            remote.evict("tcp-1")
            assert "tcp-1" not in srv.cache
    finally:
        tcp.shutdown()
        tcp.server_close()


def test_client_retries_a_transient_fault(base_server):
    """A connection error injected at the serve.client site is retried by
    with_retries and counted."""
    from r2d2_tpu_torch.utils import faults

    srv = base_server
    tcp, _ = serve_tcp(srv, port=0)
    faults.reset_retry_stats()
    faults.install(faults.FaultPlane.from_spec("serve.client@2=error"))
    try:
        obs = np.zeros(CFG.obs_shape, np.uint8)
        with PolicyClient(port=tcp.server_address[1]) as remote:
            for t in range(3):
                remote.act("retry-1", obs, reset=t == 0)
        assert faults.retry_stats()["serve.client"] == 1
    finally:
        faults.uninstall()
        tcp.shutdown()
        tcp.server_close()


# ------------------------------------------------------------ int8 weights


class TestServeInt8:
    """serve_quantization="int8": per-channel int8 encoder and head weights,
    quantized at each publish, dequantized in the step. Served answers equal
    the reference on the dequantized parameters bit for bit; the drift comes
    from the quantization alone, bounded against the float arm."""

    def test_default_off(self, base_server):
        assert tiny_test().serve_quantization == "none"
        assert base_server.quantized_leaves == 0
        assert base_server.stats()["serve_quantization"] == "none"

    def test_bounded_parity_and_self_consistency(self):
        scfg = ServeConfig(buckets=(2, 4), max_wait_ms=2.0, cache_capacity=16)
        srv_fp = server(CFG, scfg)
        srv_q = server(CFG.replace(serve_quantization="int8"), scfg)
        assert srv_q.quantized_leaves > 0
        assert srv_q.stats()["quantized_leaves"] == srv_q.quantized_leaves
        # the same serve seed: the same initial parameters
        deq = dequantize_tree(quantize_tree(srv_fp.served_params())[0])
        for k, v in srv_q.served_params().items():
            assert torch.equal(v, deq[k]), k
        for s in (srv_fp, srv_q):
            s.warmup()
            s.start()
        cl_fp, cl_q = LocalClient(srv_fp), LocalClient(srv_q)
        ref = SessionReference(srv_q.net, CFG.hidden_dim)
        rng = np.random.default_rng(0)
        max_drift = max_q = 0.0
        try:
            for t in range(12):
                obs = rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8)
                reset = t == 0
                r = 0.0 if reset else float(rng.random())
                res_fp = cl_fp.act("s", obs, reward=r, reset=reset)
                res_q = cl_q.act("s", obs, reward=r, reset=reset)
                q_ref, a_ref = ref.step(deq, obs, r, reset, bucket=res_q.bucket, row=res_q.row)
                np.testing.assert_array_equal(q_ref, np.asarray(res_q.q))
                assert a_ref == res_q.action
                max_drift = max(max_drift, float(np.abs(res_q.q - res_fp.q).max()))
                max_q = max(max_q, float(np.abs(res_fp.q).max()))
        finally:
            srv_fp.stop()
            srv_q.stop()
        assert max_drift / max_q < 0.05, (max_drift, max_q)

    def test_reload_requantizes(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        srv = server(CFG.replace(serve_quantization="int8"),
                     ServeConfig(buckets=(2, 4), max_wait_ms=2.0, cache_capacity=16),
                     checkpoint_dir=ckpt)

        def scales():
            return {k: v["scale"].clone() for k, v in srv._published[0].items()
                    if isinstance(v, dict)}

        before = scales()
        save_checkpoint(ckpt, _scaled_state(srv, 2.0, 1), 0, 0.0)
        assert srv.reload_now()
        after = scales()
        assert srv._published[1] == 1 and srv.quantized_leaves == len(after) > 0
        for k in before:
            torch.testing.assert_close(after[k], before[k] * 2.0, rtol=1e-6, atol=0)


# --------------------------------------------------------------- multi-task


def _mt_cfg():
    """tiny_test widened to a 2-task family (drift A=3, banditgrid A=5:
    union action_dim 5, task-conditioned head)."""
    from r2d2_tpu_torch.multitask import build_registry

    return build_registry(CFG, ["drift", "banditgrid"])


@pytest.fixture(scope="module")
def mt_server():
    cfg, specs = _mt_cfg()
    srv = server(cfg)
    srv.warmup()
    srv.start()
    yield srv, cfg, specs
    srv.stop()


def test_mixed_task_bucketed_parity(mt_server):
    """Sessions of two tasks interleave through one bucketed step: every
    answer is the task-conditioned reference's bit for bit, and each task's
    invalid action tail stays floored."""
    srv, cfg, specs = mt_server
    params = srv.served_params()
    records = _interleaved(srv, LocalClient(srv), cfg, 4, 8, 7, "mt", task_of=lambda s: s % 2)
    for s, recs in enumerate(records):
        task = s % 2
        native = specs[task].action_dim
        ref = SessionReference(srv.net, cfg.hidden_dim, task=task)
        for obs, reward, reset, res in recs:
            q_ref, a_ref = ref.step(params, obs, reward, reset, bucket=res.bucket, row=res.row)
            np.testing.assert_array_equal(q_ref, np.asarray(res.q))
            assert a_ref == res.action and res.action < native
            if native < cfg.action_dim:
                assert np.all(np.asarray(res.q)[native:] < -1e8)


def test_mixed_obs_shapes_pad_through_bucket(mt_server):
    srv, cfg, _ = mt_server
    small = np.random.default_rng(9).integers(0, 255, (8, 8, 1), dtype=np.uint8)
    res = LocalClient(srv).act("mt-small", small, reset=True, task=1)
    padded = np.zeros(cfg.obs_shape, np.uint8)
    padded[:8, :8, :] = small
    ref = SessionReference(srv.net, cfg.hidden_dim, task=1)
    q_ref, a_ref = ref.step(srv.served_params(), padded, 0.0, reset=True, bucket=res.bucket,
                            row=res.row)
    np.testing.assert_array_equal(q_ref, np.asarray(res.q))
    assert a_ref == res.action


def test_pad_obs_rejects_oversize():
    with pytest.raises(ValueError):
        _pad_obs(np.zeros((16, 16, 1), np.uint8), (12, 12, 1))


def test_multitask_served_stream_matches_jax():
    """Mixed-task sessions against JAX's task-conditioned reference_act on
    the same parameters (Q to 1e-5)."""
    from r2d2_tpu.multitask import build_registry as jax_build_registry
    from r2d2_tpu_torch.multitask import build_registry

    jcfg, _ = jax_build_registry(jax_tiny_test(), ["drift", "banditgrid"])
    jnet, jparams = jax_init_params(jax.random.PRNGKey(5), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    cfg, _ = build_registry(CFG, ["drift", "banditgrid"])
    srv = server(cfg, params=params_from_flax(jparams))
    srv.warmup()
    srv.start()
    try:
        records = _interleaved(srv, LocalClient(srv), cfg, 4, 6, 11, "mtj",
                               task_of=lambda s: s % 2)
    finally:
        srv.stop()
    for s, recs in enumerate(records):
        ref = SessionReference(jnet, cfg.hidden_dim, act=jax_reference_act, task=s % 2)
        for obs, reward, reset, res in recs:
            q_ref, _ = ref.step(jparams, obs, reward, reset, bucket=res.bucket)
            np.testing.assert_allclose(np.asarray(res.q), q_ref, rtol=0, atol=1e-5)
            ref.last_action = np.array([res.action], np.int32)
