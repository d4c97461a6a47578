"""The port's autoscaler (r2d2_tpu_torch/serve/autoscale.py) on the CPU, as
tests/test_autoscale.py holds the JAX package's (its learner reshard
belongs to another module): tiny_test shapes, fleets on the CPU.

- against the JAX package: SignalWindow's signals and the autoscaler's
  scale decisions, drain choices and stats are JAX's on one seeded trace;
- the hysteresis, bounds, cooldown, idle-held drain and pressure margin
  on a stub fleet; the scale-vs-degrade interlock; a live fleet scaled up
  and drained with every session bit for bit and none lost; an added
  replica following fleet publishes; the router's bound following the
  active set; default off with the JAX package's validation errors; a
  drain that loses sessions while a tap is attached stranding nothing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.serve import AutoscaleConfig as JaxAutoscaleConfig
from r2d2_tpu.serve import Autoscaler as JaxAutoscaler
from r2d2_tpu.serve import SignalWindow as JaxSignalWindow
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.liveloop import LiveLoopPlane
from r2d2_tpu_torch.serve import (
    AutoscaleConfig,
    Autoscaler,
    DegradeConfig,
    DegradeController,
    LocalClient,
    MultiDeviceServer,
    ScenarioSpec,
    ServeConfig,
    SessionRouter,
    SignalWindow,
)
from tests.test_torch_scenarios import _StubServer
from tests.test_torch_serve import SessionReference

torch.set_num_threads(1)


# ------------------------------------------------------------- signal window


def test_signal_window_matches_jax():
    """One seeded latency stream (through a ring of 64 that wraps, with a
    reset half way): the same p99, attainment and sample count as JAX's."""
    rng = np.random.default_rng(0)
    port, ref = SignalWindow(64, 20.0, 8), JaxSignalWindow(64, 20.0, 8)
    for i in range(300):
        lat = float(rng.exponential(0.015))
        port.observe(lat)
        ref.observe(lat)
        if i == 150:
            port.reset()
            ref.reset()
        a, b = port.signals(), ref.signals()
        assert {k: a[k] for k in ("p99_ms", "attainment", "samples")} == \
            {k: b[k] for k in ("p99_ms", "attainment", "samples")}
    np.testing.assert_array_equal(port.snapshot(), ref.snapshot())


def test_signal_window_abstains_cold_then_judges():
    w = SignalWindow(window=16, slo_ms=50.0, min_samples=4)
    cold = w.signals()
    assert (cold["p99_ms"], cold["attainment"], cold["samples"]) == (0.0, 1.0, 0.0)
    assert cold["age_s"] == float("inf")
    for lat in (0.01, 0.02, 0.01, 0.2):
        w.observe(lat)
    sig = w.signals()
    assert sig["samples"] == 4.0 and sig["age_s"] < 60.0
    assert sig["p99_ms"] > 50.0 and sig["attainment"] == 0.75
    w.reset()
    assert w.signals()["samples"] == 0.0


# ------------------------------------------------------------ decision logic


class _ElasticStub(_StubServer):
    """A fleet's surface: the ladder's plus the autoscaler's verbs and the
    per-replica idle triplet (replica 0 looks idle, the others busy)."""

    def __init__(self, n: int = 1, queue_bound: int = 100):
        super().__init__(queue_bound=queue_bound)
        self.n = n
        self.replicas: list = []
        self.events: list = []
        self.ages = None

    def active_replicas(self) -> int:
        return self.n

    def add_replica(self) -> int:
        self.n += 1
        self.events.append("up")
        return self.n - 1

    def kill_replica(self, idx: int) -> dict:
        self.n -= 1
        self.events.append(("down", idx))
        return {"migrated": 0, "lost": 0, "restarted": 0}

    def stats(self) -> dict:
        ages = self.ages if self.ages is not None else [9.0] + [0.01] * (self.n - 1)
        return {"replica_active": [True] * self.n, "replica_inflight": [0] * self.n,
                "replica_last_request_age_s": list(ages[:self.n]),
                "router_counts": [1] * self.n}


_DEFAULTS = dict(min_replicas=1, max_replicas=2, dwell_up=2, dwell_down=3, cooldown_s=0.0,
                 idle_age_s=1.0, min_samples=4)


def _autoscaler(stub=None, cls=Autoscaler, cfg_cls=AutoscaleConfig, **kw):
    stub = stub if stub is not None else _ElasticStub()
    return stub, cls(stub, cfg_cls(**{**_DEFAULTS, **kw}))


@pytest.mark.parametrize("seed,idle", [(0, True), (1, False), (2, True)])
def test_scale_decisions_match_jax(seed, idle):
    """One seeded trace of queue depths, latencies and replica idle ages,
    up to four replicas: every tick's decision, the fleet size, the drain
    victims and the counters are JAX's."""
    rng = np.random.default_rng(seed)
    kw = dict(max_replicas=4, dwell_up=2, dwell_down=3, drain_requires_idle=idle,
              stale_after_s=1e9, window=32)
    (ps, port), (rs, ref) = (_autoscaler(**kw),
                             _autoscaler(cls=JaxAutoscaler, cfg_cls=JaxAutoscaleConfig, **kw))
    trail = ([], [])
    for t in range(600):
        # regimes of 50 ticks: calm, a crest, then a mixed stretch
        regime = (t // 50) % 3
        depth = int(rng.choice([[0, 1, 2], [30, 80, 95], [0, 10, 40]][regime]))
        scale = [0.002, 0.06, float(rng.choice([0.002, 0.03]))][regime]
        lats = rng.exponential(scale, size=int(rng.integers(0, 5)))
        ages = rng.choice([0.01, 0.5, 3.0], size=4).tolist()
        for k, (stub, auto) in enumerate(((ps, port), (rs, ref))):
            stub.depth, stub.ages = depth, ages
            for lat in lats:
                auto.window.observe(float(lat))
            trail[k].append((auto.evaluate_once(), stub.n))
    assert trail[0] == trail[1]
    assert ps.events == rs.events and "up" in ps.events
    assert any(isinstance(e, tuple) for e in ps.events)
    a, b = port.stats(), ref.stats()
    for key in ("autoscale_evaluations", "autoscale_scale_ups", "autoscale_scale_downs",
                "autoscale_drain_holds", "autoscale_drain_log"):
        assert a[key] == b[key], key


def _diurnal_events(spec, ticks=64):
    cap = 1.5 * spec.base_rate
    stub, auto = _autoscaler()
    events = []
    for k in range(ticks):
        over = max(spec.rate_at(spec.duration_s * k / ticks) - cap, 0.0) / cap
        stub.depth = min(stub.queue_bound, int(stub.queue_bound * over))
        ev = auto.evaluate_once()
        if ev is not None:
            events.append((k, ev, stub.n))
    return events


def test_scale_events_deterministic_from_seeded_trace():
    spec = ScenarioSpec(name="d", duration_s=8.0, base_rate=100.0, rate_profile="diurnal",
                        peak_mult=3.0, seed=11)
    events = _diurnal_events(spec)
    assert [e[1] for e in events] == ["up", "down"]
    assert events[0][0] < 32 <= events[1][0]
    assert _diurnal_events(spec) == events


def test_hysteresis_bounds_and_cooldown():
    stub, auto = _autoscaler(dwell_up=2, dwell_down=2)
    for k in range(40):  # oscillating: neither dwell accumulates
        stub.depth = 90 if k % 2 == 0 else 0
        assert auto.evaluate_once() is None
    stub.depth = 10  # the dead band
    for _ in range(20):
        assert auto.evaluate_once() is None
    assert stub.n == 1
    stub, auto = _autoscaler(cooldown_s=60.0)
    stub.depth = 90
    assert [auto.evaluate_once() for _ in range(8)].count("up") == 1 and stub.n == 2
    stub, auto = _autoscaler(dwell_down=2)
    stub.depth = 0
    for _ in range(10):
        auto.evaluate_once()
    assert stub.n == 1 and auto.scale_downs == 0  # floored at min_replicas


def test_drain_holds_until_idle_and_logs_the_victim():
    stub, auto = _autoscaler(_ElasticStub(n=2), dwell_down=2)
    stub.ages = [0.01, 0.01]
    for _ in range(6):
        assert auto.evaluate_once() is None
    assert stub.n == 2 and auto.drain_holds >= 4
    assert auto.stats()["autoscale_drain_log"] == []
    stub.ages = [9.0, 0.01]
    assert auto.evaluate_once() == "down" and stub.events == [("down", 0)]
    assert auto.stats()["autoscale_drain_log"] == [
        {"replica": 0, "idle_age_s": 9.0, "inflight": 0, "affinities": 1}]


def test_concurrent_drains_each_log_their_own_victim():
    """Drains on several threads at once (the autoscaler's worker and a
    direct evaluate_once, say): each drain's log entry names the replica
    that drain killed. The choice used to wait in a shared attribute
    between the pick and the log, so a pick on another thread in between
    logged that thread's victim. A stress run with a short switch
    interval: every thread drains its own replica, and the log's counts
    must be the kills' counts."""
    import collections
    import sys
    import threading

    class PerThread(_ElasticStub):
        def stats(self) -> dict:
            ages = [0.01] * self.n
            ages[int(threading.current_thread().name.rsplit("-", 1)[1])] = 9.0
            return {"replica_active": [True] * self.n, "replica_inflight": [0] * self.n,
                    "replica_last_request_age_s": ages, "router_counts": [1] * self.n}

        def kill_replica(self, idx: int) -> dict:
            self.events.append(("down", idx))  # the fleet keeps its size
            return {"migrated": 0, "lost": 0, "restarted": 0}

    stub, auto = _autoscaler(PerThread(n=4), dwell_down=1)
    rounds = 300

    def drain():
        for _ in range(rounds):
            assert auto._scale_down() == "down"

    threads = [threading.Thread(target=drain, name=f"drain-{i}") for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    logged = collections.Counter(e["replica"] for e in auto.stats()["autoscale_drain_log"])
    killed = collections.Counter(idx for _, idx in stub.events)
    assert logged == killed == {i: rounds for i in range(4)}


def test_pressure_margin_and_stale_window():
    stub, auto = _autoscaler(pressure_margin=0.5)
    for _ in range(8):
        auto.window.observe(0.030)  # over 0.5 x 50 ms, inside the SLO
    assert "up" in [auto.evaluate_once() for _ in range(3)] and stub.n == 2
    stub, auto = _autoscaler(pressure_margin=1.0)
    for _ in range(8):
        auto.window.observe(0.030)
    assert [auto.evaluate_once() for _ in range(6)] == [None] * 6
    stub, auto = _autoscaler(dwell_down=2, stale_after_s=0.0)
    stub.n = 2
    for _ in range(8):
        auto.window.observe(10.0)
    assert "down" in [auto.evaluate_once() for _ in range(3)] and stub.n == 1


# ---------------------------------------------------------------- interlock


def _gated(n=1, **kw):
    stub = _ElasticStub(n=n)
    stub.degrade = DegradeController(stub, DegradeConfig(dwell_up=2, dwell_down=3,
                                                         min_samples=4, eval_interval_s=0.01))
    auto = Autoscaler(stub, AutoscaleConfig(**{**dict(min_replicas=1, max_replicas=2,
                                                      min_samples=4), **kw}))
    return stub, auto, stub.degrade


@pytest.mark.parametrize("case", ["held_until_scaling", "closed_below_max", "open_at_max"])
def test_interlock(case):
    if case == "held_until_scaling":
        stub, auto, ctl = _gated(dwell_up=3, cooldown_s=60.0)
        assert auto.window is ctl.window
        stub.depth = 90
        assert [ctl.evaluate_once() for _ in range(2)] == [None, None]
        assert ctl.rung == 0 and ctl.gated_holds >= 1
        for _ in range(3):
            auto.evaluate_once()
        assert stub.n == 2 and ctl.evaluate_once() == "admit"
        stub.depth = 0
        for _ in range(3):
            ctl.window.observe(0.001)
            ctl.evaluate_once()
        assert ctl.rung == 0  # recovery is never gated
    elif case == "closed_below_max":
        stub, auto, ctl = _gated(max_replicas=3, dwell_up=1, cooldown_s=60.0)
        stub.depth = 90
        assert auto.evaluate_once() == "up" and stub.n == 2
        held = ctl.gated_holds
        assert [ctl.evaluate_once() for _ in range(4)] == [None] * 4
        assert ctl.rung == 0 and ctl.gated_holds > held
    else:
        stub, auto, ctl = _gated(n=2)
        stub.depth = 90
        assert [ctl.evaluate_once() for _ in range(4)] == [None, "admit", None, "bf16"]
        assert ctl.gated_holds == 0


# ------------------------------------------------------- live fleet, bitwise


def test_fleet_scale_up_and_down_bit_exact():
    """A live fleet grows by a replica and drains one, under traffic: no
    session lost, and every answer is its session's reference at the bucket
    and row it was served at, bit for bit, across both events. The
    autoscaler's worker runs (its dwells out of reach); the events go
    through its verbs and its own drain choice."""
    cfg = tiny_test().replace(serve_spill=64, serve_autoscale=True, autoscale_min_replicas=1,
                              autoscale_max_replicas=2, autoscale_dwell_up=10**6,
                              autoscale_dwell_down=10**6,
                              autoscale_drain_requires_idle=False)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2, 4), max_wait_ms=1.0,
                                             cache_capacity=8), devices=["cpu"])
    assert srv.autoscale is not None
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    rng = np.random.default_rng(17)
    refs: dict = {}

    def step_all(sids, first=False):
        for sid in sids:
            if first:
                refs[sid] = SessionReference(srv.replicas[0].net, cfg.hidden_dim)
            obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
            reward = float(rng.normal())
            res = client.act(sid, obs, reward=reward, reset=first)
            q_ref, a_ref = refs[sid].step(srv.replica_for(sid).served_params(), obs, reward,
                                          first, bucket=res.bucket, row=res.row)
            np.testing.assert_array_equal(q_ref, res.q)
            assert a_ref == res.action

    gen_a = [f"ela-{s}" for s in range(8)]
    gen_b = [f"elb-{s}" for s in range(6)]
    try:
        step_all(gen_a, first=True)
        step_all(gen_a)
        assert srv.add_replica() == 1 and srv.active_replicas() == 2
        assert srv.replicas[1].trace_count == len(srv.replicas[1].batcher.buckets)
        step_all(gen_a)
        step_all(gen_b, first=True)
        step_all(gen_a + gen_b)
        assert srv.router.counts()[1] == len(gen_b)
        victim = srv.autoscale._pick_drain_victim()
        assert victim == 1
        assert srv.kill_replica(victim) == {"migrated": len(gen_b), "lost": 0, "restarted": 0}
        assert srv.active_replicas() == 1
        step_all(gen_a + gen_b)
        step_all(gen_a + gen_b)
        srv.check()
    finally:
        srv.stop()
    st = srv.stats()
    assert st["sessions_lost"] == 0 and st["sessions_migrated"] == len(gen_b)
    assert st["replicas_added"] == 1 and st["replicas_killed"] == 1
    assert st["replica_active"] == [True, False] and st["autoscale_evaluations"] >= 0


def test_added_replica_follows_fleet_publish():
    cfg = tiny_test().replace(serve_spill=16)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=8),
                            devices=["cpu"])
    srv.warmup()
    srv.start()
    try:
        srv.publish_params(srv.replicas[0].served_params(), ckpt_step=5)
        srv.add_replica()
        r0, r1 = srv.replicas
        assert r0._published[1:] == r1._published[1:] == (5, 1, "full")
        srv.set_arm("bf16")
        assert r0._published[1:] == r1._published[1:] == (5, 2, "bf16")
    finally:
        srv.stop()


def test_router_bound_tracks_active_set():
    r = SessionRouter(2, max_tracked=8)
    for i in range(8):
        r.route(f"s{i}")
    r.deactivate(1)
    assert r.max_tracked == 4 and len(r._map) == 4 and r.dropped == 4
    r.activate(1)
    assert r.max_tracked == 8
    slot = r.add_slot()
    assert slot == 2 and r.active() == [True, True, False]
    r.activate(slot)
    assert r.max_tracked == 12 and r.active() == [True, True, True]


# ----------------------------------------------------------- config gating


@pytest.mark.parametrize("bad", [
    dict(serve_autoscale=True, serve_devices=4, autoscale_max_replicas=2),
    dict(autoscale_min_replicas=3, autoscale_max_replicas=2),
    dict(autoscale_min_replicas=0),
    dict(autoscale_dwell_up=0),
    dict(autoscale_cooldown_s=-1.0),
    dict(autoscale_interval_s=0.0),
    dict(autoscale_idle_age_s=-0.5),
    dict(autoscale_pressure_margin=1.5),
    dict(serve_devices=0),
    dict(serve_degrade_slo_ms=0.0),
    dict(liveloop_explore_fraction=1.5),
    dict(liveloop_eps_rungs=0),
    dict(liveloop_tap_depth=0),
])
def test_defaults_off_and_validation_matches_jax(bad):
    cfg = tiny_test()
    assert cfg.serve_autoscale is False and cfg.serve_degrade is False and not cfg.liveloop
    with pytest.raises(ValueError) as ours:
        cfg.replace(**bad)
    with pytest.raises(ValueError) as theirs:
        jax_tiny_test().replace(**bad).validate()
    assert str(ours.value) == str(theirs.value)


def test_autoscaler_off_by_default():
    srv = MultiDeviceServer(tiny_test(), ServeConfig(buckets=(2,), max_wait_ms=1.0,
                                                     cache_capacity=4), devices=["cpu"])
    assert srv.autoscale is None and srv.degrade is None


def test_drain_during_active_tap_never_strands_accumulator():
    """A drain that loses sessions (no slab room on the survivor) also
    disconnects them from the fleet's tap: each lost session's partial block
    is cut into the ingest stream and its stream closes."""

    class _Sink:
        def __init__(self):
            self.items = []

        def add_blocks_batch(self, items):
            self.items.extend(items)

    cfg = tiny_test().replace(serve_spill=8, liveloop=True)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=8),
                            devices=["cpu"])
    sink = _Sink()
    plane = LiveLoopPlane(cfg, srv, sink)
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    rng = np.random.default_rng(23)

    def step_all(sids, first=False):
        for sid in sids:
            client.act(sid, rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8), reward=0.1,
                       reset=first)

    gen_a = [f"keep-{i}" for i in range(3)]
    gen_b = [f"lose-{i}" for i in range(3)]
    try:
        step_all(gen_a, first=True)
        srv.add_replica()
        assert srv.replicas[1].tap is plane.tap
        step_all(gen_b, first=True)
        step_all(gen_a + gen_b)
        plane.tap.process_pending(timeout=0.0)
        assert plane.tap.stats()["tap_open_sessions"] == 6
        assert all(srv.router.peek(s) == 1 for s in gen_b)
        srv.replicas[0].cache.import_spilled = lambda *a, **k: False
        assert srv.kill_replica(1)["lost"] == len(gen_b)
        plane.tap.process_pending(timeout=0.0)
        st = plane.tap.stats()
        assert st["tap_open_sessions"] == len(gen_a) and st["tap_emitted_blocks"] == len(gen_b)
        plane.bridge.drain_once()
        assert len(sink.items) == len(gen_b)
    finally:
        plane.stop()
        srv.stop()
    assert srv.stats()["sessions_lost"] == len(gen_b)
