"""The port's scenario engine and degradation ladder on the CPU, as
tests/test_scenarios.py holds the JAX package's: tiny_test shapes, fleets
on ["cpu", "cpu"].

- against the JAX package: `arrival_trace` gives JAX's events bit for bit
  for every built-in spec and more; the port's DegradeController and JAX's
  make the same rung transitions and actions on one seeded signal sequence;
- the ladder's hysteresis, dead band and pinning; the batcher's bounded
  shed budget; `set_arm` keeping the checkpoint provenance, and a reload
  landing inside an arm switch or the other way round; the bf16 arm
  within 5% of the fp32 Q (and equal to the port's reference under the
  upcast weights, bit for bit); every rung pinned on a live fleet; a
  replica kill migrating every session bit for bit; the kill scenario end
  to end; the TCP client's overload budget and error classes.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from dataclasses import replace as dataclasses_replace

import numpy as np
import pytest
import torch

from r2d2_tpu.serve import DegradeConfig as JaxDegradeConfig
from r2d2_tpu.serve import DegradeController as JaxDegradeController
from r2d2_tpu.serve import ScenarioSpec as JaxScenarioSpec
from r2d2_tpu.serve import arrival_trace as jax_arrival_trace
from r2d2_tpu.serve import builtin_scenarios as jax_builtin_scenarios
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.serve import (
    RUNGS,
    DegradeConfig,
    DegradeController,
    LocalClient,
    MicroBatcher,
    MultiDeviceServer,
    PolicyClient,
    PolicyServer,
    QueueFullError,
    ScenarioRunner,
    ScenarioSpec,
    ServeConfig,
    ServeResult,
    arrival_trace,
    builtin_scenarios,
    serve_tcp,
)
from r2d2_tpu_torch.serve.scenarios import _draw_session_length
from tests.test_torch_serve import SessionReference

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]


# ------------------------------------------------------------ arrival traces


def _events(trace):
    return [(ev.t, ev.session, ev.reset, ev.slow) for ev in trace]


_EXTRA = [dict(name="pareto", duration_s=2.0, base_rate=400.0, sessions=16,
               session_tail="pareto", pareto_alpha=1.3, slow_frac=0.5, seed=5),
          dict(name="short", duration_s=1.0, base_rate=300.0, sessions=8,
               session_mean_requests=4.0, seed=3),
          dict(name="diurnal4", duration_s=4.0, base_rate=100.0, rate_profile="diurnal",
               peak_mult=4.0, seed=1)]


@pytest.mark.parametrize("idx", range(6 + len(_EXTRA)))
def test_arrival_trace_matches_jax(idx):
    """Every built-in scenario (at two rates and seeds) and three more: the
    port's events are JAX's, times bit for bit."""
    if idx < 6:
        port = builtin_scenarios(base_rate=80.0, duration_s=2.0, sessions=12, seed=idx)[idx]
        ref = jax_builtin_scenarios(base_rate=80.0, duration_s=2.0, sessions=12, seed=idx)[idx]
    else:
        kw = _EXTRA[idx - 6]
        port, ref = ScenarioSpec(**kw), JaxScenarioSpec(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    got, want = _events(arrival_trace(port)), _events(jax_arrival_trace(ref))
    assert got == want and len(got) > 50


def test_arrival_trace_deterministic():
    spec = ScenarioSpec(name="t", duration_s=2.0, base_rate=200.0, seed=7)
    a, b = arrival_trace(spec), arrival_trace(spec)
    assert a == b and len(a) > 100
    assert arrival_trace(dataclasses_replace(spec, seed=8)) != a


def test_arrival_trace_times_and_resets():
    spec = ScenarioSpec(name="t", duration_s=1.0, base_rate=300.0, sessions=8,
                        session_mean_requests=4.0, seed=3)
    trace = arrival_trace(spec)
    assert all(0.0 <= ev.t < spec.duration_s for ev in trace)
    assert all(trace[i].t <= trace[i + 1].t for i in range(len(trace) - 1))
    seen = set()
    for ev in trace:
        assert ev.reset == (ev.session not in seen)
        seen.add(ev.session)
    assert len(seen) > spec.sessions


def test_arrival_trace_profiles_and_tails():
    flash = ScenarioSpec(name="f", duration_s=4.0, base_rate=100.0, rate_profile="flash",
                         peak_mult=8.0, flash_at=0.4, flash_len=0.2, seed=1)
    trace = arrival_trace(flash)
    assert sum(1.6 <= ev.t < 2.4 for ev in trace) / len(trace) > 0.5
    diurnal = ScenarioSpec(name="d", duration_s=4.0, base_rate=100.0,
                           rate_profile="diurnal", peak_mult=4.0, seed=1)
    assert diurnal.rate_at(2.0) == pytest.approx(400.0)
    assert diurnal.rate_at(0.0) == pytest.approx(100.0)
    with pytest.raises(ValueError, match="rate_profile"):
        ScenarioSpec(name="x", rate_profile="square").rate_at(0.0)
    spec = ScenarioSpec(name="p", duration_s=2.0, base_rate=400.0, sessions=16,
                        session_tail="pareto", pareto_alpha=1.3, slow_frac=0.5, seed=5)
    slow: dict = {}
    for ev in arrival_trace(spec):
        assert slow.setdefault(ev.session, ev.slow) == ev.slow
    assert any(slow.values()) and not all(slow.values())

    def draws(tail):
        rng = np.random.default_rng(5)
        s = dataclasses_replace(spec, session_tail=tail)
        return np.asarray([_draw_session_length(rng, s) for _ in range(2000)])

    pareto, geom = draws("pareto"), draws("geometric")
    assert pareto.min() >= 1
    assert (np.percentile(pareto, 99) / np.median(pareto)
            > 2 * np.percentile(geom, 99) / np.median(geom))
    with pytest.raises(ValueError, match="session_tail"):
        arrival_trace(ScenarioSpec(name="x", session_tail="zipf"))
    with pytest.raises(ValueError, match="events"):
        arrival_trace(ScenarioSpec(name="x", duration_s=10.0, base_rate=1e6))


def test_builtin_scenarios_cover_the_failure_modes():
    specs = builtin_scenarios(base_rate=50.0, duration_s=1.0, seed=4)
    assert [s.name for s in specs] == ["steady", "diurnal", "flash_crowd", "heavy_tail",
                                       "slow_clients", "replica_kill"]
    assert len({s.seed for s in specs}) == len(specs)
    assert specs[-1].kill_at == 0.5


# -------------------------------------------------------------- rung ladder


class _StubServer:
    """The ladder's surface, recording every rung action."""

    def __init__(self, queue_bound: int = 100):
        self.depth = 0
        self.queue_bound = queue_bound
        self.admissions: list = []
        self.arms: list = []
        self.spill_sheds: list = []

    def queue_depth(self) -> int:
        return self.depth

    def set_admission(self, limit, budget=0) -> None:
        self.admissions.append((limit, budget))

    def set_arm(self, arm) -> bool:
        self.arms.append(arm)
        return True

    def shed_spill(self, keep_fraction) -> int:
        self.spill_sheds.append(keep_fraction)
        return 0


def _controller(cls=DegradeController, cfg_cls=DegradeConfig, **kw):
    stub = _StubServer()
    defaults = dict(dwell_up=2, dwell_down=3, min_samples=4, eval_interval_s=0.01)
    defaults.update(kw)
    return stub, cls(stub, cfg_cls(**defaults))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_transitions_match_jax(seed):
    """One seeded sequence of queue depths and latencies, with pins, window
    resets and an interlock gate mixed in, through the port's controller and
    JAX's: the same rung after every tick, the same actions on the server,
    the same counters and transition reasons."""
    rng = np.random.default_rng(seed)
    port = _controller(slo_ms=20.0)
    ref = _controller(JaxDegradeController, JaxDegradeConfig, slo_ms=20.0)
    gate_open = [True]
    for _, ctl in (port, ref):
        ctl.rung_up_gate = lambda: gate_open[0]
    trail = {id(port[1]): [], id(ref[1]): []}
    for t in range(300):
        depth = int(rng.choice([0, 3, 20, 60, 95]))
        lats = rng.exponential(rng.choice([0.002, 0.015, 0.04]), size=int(rng.integers(0, 6)))
        gate_open[0] = bool(rng.random() < 0.7)
        op = rng.random()
        for stub, ctl in (port, ref):
            stub.depth = depth
            for lat in lats:
                ctl.observe(float(lat))
            if op < 0.01:
                ctl.pin(RUNGS[t % 4])
            elif op < 0.03:
                ctl.reset_window()
            trail[id(ctl)].append((ctl.evaluate_once(), ctl.rung, ctl.pinned))
        if port[1].pinned and rng.random() < 0.2:
            for _, ctl in (port, ref):
                ctl._pinned = False  # let it step again
    assert trail[id(port[1])] == trail[id(ref[1])]
    for a, b in ((port[0], ref[0]),):
        assert (a.admissions, a.arms, a.spill_sheds) == (b.admissions, b.arms, b.spill_sheds)
    sa, sb = port[1].stats(), ref[1].stats()
    strip = lambda s: {k: v for k, v in s.items() if k != "degrade_transitions"}  # noqa: E731
    assert strip(sa) == strip(sb)
    assert ([(t["from"], t["to"], t["reason"]) for t in sa["degrade_transitions"]]
            == [(t["from"], t["to"], t["reason"]) for t in sb["degrade_transitions"]])
    assert sa["degrade_rung_ups"] > 0 and sa["degrade_rung_downs"] > 0


def test_ladder_steps_up_and_recovers_with_hysteresis():
    stub, ctl = _controller()
    stub.depth = 90
    assert [ctl.evaluate_once() for _ in range(6)] == [None, "admit", None, "bf16", None,
                                                       "int8"]
    assert ctl.evaluate_once() is None and ctl.rung_name == "int8"
    assert stub.arms[-1] == "int8" and stub.spill_sheds
    stub.depth = 0
    steps = [ctl.evaluate_once() for _ in range(9)]
    assert [s for s in steps if s] == ["bf16", "admit", "full"]
    assert stub.admissions[-1][0] is None
    st = ctl.stats()
    assert st["degrade_rung_ups"] == 3 and st["degrade_rung_downs"] == 3
    assert [t["reason"] for t in st["degrade_transitions"]] == (["pressured"] * 3
                                                                + ["recovered"] * 3)


def test_ladder_does_not_flap_and_parks_in_the_dead_band():
    stub, ctl = _controller()
    for i in range(20):
        stub.depth = 90 if i % 2 == 0 else 0
        assert ctl.evaluate_once() is None
    assert ctl.rung == 0 and ctl.stats()["degrade_transitions"] == []
    stub.depth = 90
    ctl.evaluate_once()
    ctl.evaluate_once()
    assert ctl.rung_name == "admit"
    stub.depth = 20
    for _ in range(20):
        assert ctl.evaluate_once() is None
    assert ctl.rung_name == "admit"


def test_ladder_latency_signal_and_pin():
    stub, ctl = _controller(slo_ms=10.0)
    for _ in range(8):
        ctl.observe(0.05)
    sig = ctl.signals()
    assert sig["p99_ms"] > 10.0 and sig["attainment"] == 0.0
    assert [ctl.evaluate_once() for _ in range(2)] == [None, "admit"]
    ctl.reset_window()
    assert ctl.signals()["samples"] == 0.0
    stub, ctl = _controller()
    ctl.pin("bf16")
    assert ctl.rung_name == "bf16" and ctl.pinned and stub.arms[-1] == "bf16"
    stub.depth = 100
    n = len(stub.admissions)
    for _ in range(5):
        assert ctl.evaluate_once() is None
    assert len(stub.admissions) > n and all(a[0] is not None for a in stub.admissions[n:])


# -------------------------------------------------------- admission control


def test_batcher_bounded_shed_budget():
    b = MicroBatcher(buckets=(2, 4), max_wait_s=0.0, queue_depth=64)
    obs = np.zeros(4, np.uint8)
    for i in range(6):
        assert not b.submit(f"s{i}", obs).done()
    b.set_admission(4, budget=3)
    outcomes = [b.submit(f"t{i}", obs) for i in range(5)]
    assert all(isinstance(f.exception(timeout=0), QueueFullError) for f in outcomes[:3])
    assert not outcomes[3].done() and not outcomes[4].done()
    st = b.stats()
    assert st["shed"] == 3 and st["rejected"] == 3 and st["admit_limit"] == 4
    b.set_admission(None)
    assert not b.submit("u", obs).done()
    b.close()
    exc = b.submit("v", obs).exception(timeout=0)
    assert isinstance(exc, QueueFullError) and "closed" in str(exc)


# ------------------------------------------------------------- weight arms


def test_set_arm_republishes_without_touching_provenance():
    srv = PolicyServer(tiny_test(), ServeConfig(buckets=(2,), max_wait_ms=1.0,
                                                cache_capacity=4), device="cpu")
    params0, step0, version0, arm0 = srv._published
    assert arm0 == "full"
    assert srv.set_arm("bf16")
    params1, step1, version1, arm1 = srv._published
    assert (step1, arm1) == (step0, "bf16") and version1 == version0 + 1
    assert srv.arm_switches == 1
    assert all(v.dtype == torch.bfloat16 for v in params1.values() if v.is_floating_point())
    assert not srv.set_arm("bf16") and srv._published[2] == version1
    # back to full: the raw parameters, not a round trip through bf16
    assert srv.set_arm("full")
    for k, v in params0.items():
        assert torch.equal(srv._published[0][k], v), k
    assert srv.set_arm("int8") and srv.quantized_leaves > 0
    st = srv.stats()
    assert st["serve_arm"] == "int8" and st["arm_switches"] == 3
    with pytest.raises(ValueError, match="arm"):
        srv.set_arm("fp8")


def _interleaved_server(kind):
    """A single server or a two-replica fleet, with the publish and
    arm-switch calls and the parameters a reload brings."""
    sc = ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=4)
    if kind == "server":
        srv = PolicyServer(tiny_test(), sc, device="cpu")
        raw, replicas = srv._params_raw, [srv]
        publish = srv.publish
    else:
        srv = MultiDeviceServer(tiny_test(), sc, devices=CPU2)
        raw, replicas = srv._params_host, srv.replicas
        publish = srv.publish_params
    new = {k: v + 0.01 if v.is_floating_point() else v.clone() for k, v in raw.items()}
    return srv, replicas, publish, new


def _hook_prepare(monkeypatch, replica, when_arm, action):
    """Run `action` once, right after the first prepare_for_publish in
    `when_arm`: a call that lands between a publish's two halves."""
    inner = replica.prepare_for_publish
    fired = []

    def prepare(params, arm=None):
        out = inner(params, arm)
        if not fired and out[2] == when_arm:
            fired.append(True)
            action()
        return out

    monkeypatch.setattr(replica, "prepare_for_publish", prepare)
    return fired


def _assert_serves(replicas, new, step, arm):
    assert {r._published[1:] for r in replicas} == {(step, replicas[0]._published[2], arm)}
    cast = (lambda v: v.to(torch.bfloat16).float()) if arm == "bf16" else (lambda v: v)
    for r in replicas:
        served = r.served_params()
        for k, v in new.items():
            assert torch.equal(served[k], cast(v) if v.is_floating_point() else v), k


@pytest.mark.parametrize("kind", ["server", "fleet"])
def test_reload_during_set_arm_prepares_again(kind, monkeypatch):
    """A reload landing while an arm switch prepares: the switch prepares
    again from the new parameters, so the new step never labels the old
    weights."""
    srv, replicas, publish, new = _interleaved_server(kind)
    fired = _hook_prepare(monkeypatch, replicas[0], "bf16", lambda: publish(new, 7))
    assert srv.set_arm("bf16") and fired
    _assert_serves(replicas, new, 7, "bf16")
    assert srv.set_arm("full")
    _assert_serves(replicas, new, 7, "full")


@pytest.mark.parametrize("kind", ["server", "fleet"])
def test_set_arm_during_reload_keeps_the_rung(kind, monkeypatch):
    """An arm switch landing while a reload prepares: the reload prepares
    again in the new arm, so the rung stays in force and a later switch
    back takes effect."""
    srv, replicas, publish, new = _interleaved_server(kind)
    fired = _hook_prepare(monkeypatch, replicas[0], "full", lambda: srv.set_arm("bf16"))
    publish(new, 7)
    assert fired
    _assert_serves(replicas, new, 7, "bf16")
    assert not srv.set_arm("bf16")
    assert srv.set_arm("full")
    _assert_serves(replicas, new, 7, "full")


def test_bf16_arm_serves_close_to_fp32():
    """The bf16 rung rounds the weights only: served Q within 5% of the fp32
    arm's largest |Q|, and equal bit for bit to the reference under the
    upcast weights the step computes with."""
    cfg = tiny_test()
    srv = PolicyServer(cfg, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=4),
                       device="cpu")
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    obs = np.random.default_rng(2).integers(0, 255, cfg.obs_shape, dtype=np.uint8)
    try:
        q_full = client.act("a", obs, reset=True).q
        assert srv.set_arm("bf16")
        res = client.act("b", obs, reset=True)
    finally:
        srv.stop()
    scale = max(float(np.max(np.abs(q_full))), 1e-9)
    assert float(np.max(np.abs(res.q - q_full))) / scale < 0.05
    assert not np.array_equal(res.q, q_full)  # the rounding is really there
    q_ref, _ = SessionReference(srv.net, cfg.hidden_dim).step(
        srv.served_params(), obs, 0.0, True, bucket=res.bucket, row=res.row)
    np.testing.assert_array_equal(q_ref, res.q)
    assert srv.stats()["serve_arm"] == "bf16"


def test_fleet_ladder_pins_every_rung():
    """A fleet with the ladder: warmup runs all three weight formats; rungs
    pinned 0 -> 3 -> 0 switch both replicas in lockstep (one version each,
    the checkpoint step kept), install the admission watermark, and every
    answer matches its replica's reference under the arm it was served in."""
    cfg = tiny_test().replace(serve_degrade=True, serve_spill=8)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2, 4), max_wait_ms=1.0,
                                             cache_capacity=8), devices=CPU2)
    srv.warmup()
    assert all(r.trace_count == 3 * 2 for r in srv.replicas)
    assert all(r.degrade is srv.degrade and srv.degrade.server is srv for r in srv.replicas)
    srv.start()
    client = LocalClient(srv)
    rng = np.random.default_rng(4)
    refs = {f"l{s}": SessionReference(srv.replicas[0].net, cfg.hidden_dim) for s in range(4)}
    seen = []
    try:
        for rung in [0, 1, 2, 3, 2, 1, 0]:
            srv.degrade.pin(rung)
            arm = {2: "bf16", 3: "int8"}.get(rung, "full")
            assert [r._published[3] for r in srv.replicas] == [arm, arm]
            assert len({r._published[2] for r in srv.replicas}) == 1
            limits = {r.batcher.stats()["admit_limit"] for r in srv.replicas}
            assert limits == ({None} if rung == 0 else {int(
                {1: 0.5, 2: 0.375, 3: 0.25}[rung] * srv.queue_bound)})
            for sid, ref in refs.items():
                obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
                res = client.act(sid, obs, reward=0.5, reset=not ref.started)
                q_ref, a_ref = ref.step(srv.replica_for(sid).served_params(), obs, 0.5,
                                        False, bucket=res.bucket, row=res.row)
                np.testing.assert_array_equal(q_ref, res.q)
                seen.append(res.params_version)
    finally:
        srv.stop()
    st = srv.stats()
    assert st["degrade_rung_ups"] == 3 and st["degrade_rung_downs"] == 3
    assert st["serve_arm"] == "full" and st["ckpt_step"] == -1
    assert st["arm_switches"] == 2 * 4  # full->bf16->int8->bf16->full, per replica
    assert seen == sorted(seen)
    assert all(t["reason"] == "pinned" for t in st["degrade_transitions"])


# --------------------------------------------------------- kill + migration


def test_replica_kill_migrates_every_session_bit_exact():
    """Kill the busier replica in the middle of the traffic: every one of
    its sessions migrates (none lost), and every session's next answers
    continue its carry bit for bit."""
    cfg = tiny_test().replace(serve_spill=64)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2, 4), max_wait_ms=1.0,
                                             cache_capacity=8), devices=CPU2)
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    rng = np.random.default_rng(9)
    n_sessions = 8
    refs = [SessionReference(srv.replicas[0].net, cfg.hidden_dim) for _ in range(n_sessions)]

    def step_all(first):
        for s in range(n_sessions):
            obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
            reward = float(rng.normal())
            res = client.act(f"kc-{s}", obs, reward=reward, reset=first)
            q_ref, a_ref = refs[s].step(srv.replica_for(f"kc-{s}").served_params(), obs,
                                        reward, first, bucket=res.bucket, row=res.row)
            np.testing.assert_array_equal(q_ref, res.q)
            assert a_ref == res.action

    try:
        step_all(True)
        step_all(False)
        counts = srv.router.counts()
        victim = int(np.argmax(counts))
        outcome = srv.kill_replica(victim)
        assert outcome == {"migrated": counts[victim], "lost": 0, "restarted": 0}
        for _ in range(3):
            step_all(False)
    finally:
        srv.stop()
    st = srv.stats()
    assert st["sessions_lost"] == 0 and st["sessions_migrated"] == counts[victim]
    assert st["replicas_killed"] == 1 and st["router_active"].count(True) == 1
    assert st["cache_imports"] == counts[victim]


def test_replica_kill_scenario_end_to_end():
    cfg = tiny_test().replace(serve_spill=64)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2, 4), max_wait_ms=1.0,
                                             cache_capacity=8), devices=CPU2)
    srv.warmup()
    srv.start()
    spec = ScenarioSpec(name="kill", duration_s=1.0, base_rate=60.0, sessions=8, kill_at=0.5,
                        seed=6)
    try:
        row = ScenarioRunner(srv, spec, slo_ms=200.0).run()
    finally:
        srv.stop()
    assert row["replica_kills"] == 1 and row["ok"] > 0
    assert row["errors"]["timeout"] == 0 and row["errors"]["transport"] == 0
    st = srv.stats()
    assert st["sessions_lost"] == 0 and st["replicas_killed"] == 1
    assert st["router_sessions"] == 0  # the runner disconnected every session


# ----------------------------------------------------------- client budget


class _SheddingStub:
    """submit() double: QueueFullError for the first `reject_first` calls."""

    def __init__(self, reject_first: int, error: Exception = None):
        self.reject_first = reject_first
        self.error = error
        self.calls = 0

    def submit(self, session_id, obs, reward=0.0, reset=False) -> Future:
        fut: Future = Future()
        self.calls += 1
        if self.calls <= self.reject_first:
            fut.set_exception(QueueFullError("serve queue full (stub)"))
        elif self.error is not None:
            fut.set_exception(self.error)
        else:
            fut.set_result(ServeResult(1, np.zeros(3, np.float32), 0, 0))
        return fut


@pytest.mark.parametrize("case", ["retries_then_succeeds", "budget_exhausts",
                                  "transport_error"])
def test_client_budget(case):
    reject, err, retries = {"retries_then_succeeds": (2, None, 3),
                            "budget_exhausts": (10, None, 2),
                            "transport_error": (0, ValueError("exploded"), 3)}[case]
    stub = _SheddingStub(reject, err)
    tcp, _ = serve_tcp(stub, port=0)
    host, port = tcp.server_address[:2]
    client = PolicyClient(host=host, port=port, timeout=5.0, queue_retries=retries)
    try:
        if case == "retries_then_succeeds":
            assert client.act("s", [1, 2], reset=True)["action"] == 1
            assert stub.calls == 3
            assert client.error_counts == {"rejected": 0, "timeout": 0, "transport": 0}
        elif case == "budget_exhausts":
            with pytest.raises(QueueFullError):
                client.act("s", [1, 2])
            assert stub.calls == 2 and client.error_counts["rejected"] == 1
        else:
            with pytest.raises(RuntimeError, match="exploded"):
                client.act("s", [1, 2])
            assert client.error_counts["transport"] == 1
            assert client.error_counts["rejected"] == 0
    finally:
        client.close()
        tcp.shutdown()
        tcp.server_close()
