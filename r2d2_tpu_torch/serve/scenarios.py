"""Seeded, declarative traffic scenarios for the serving plane (port of
r2d2_tpu/serve/scenarios.py; host code, and `arrival_trace` gives the JAX
package's events bit for bit).

Traffic is not a constant-rate Poisson process: rates ramp through a day,
flash crowds multiply the load for seconds, session lengths are
heavy-tailed, some clients straggle, and replicas stall or die in the
middle of it. Each of those is a scenario here:

- `ScenarioSpec` names the shape: a rate profile (constant, diurnal,
  flash), a session-length law (geometric or Pareto), a share of slow
  clients, a fault-plane spec and an optional replica kill.
- `arrival_trace(spec)` is a pure function of the spec: the same seed
  gives the same events (time, session, reset, slow) on any host, by
  Lewis-Shedler thinning of a Poisson process at the profile's peak rate.
- `ScenarioRunner` replays a trace against a live server on the wall
  clock, classifies every outcome (`ok`, `rejected`, `timeout`,
  `transport`) and reduces them to a readiness row: p50 / p95 / p99, SLO
  attainment and the error counts.

Chaos goes through the fault plane: the runner installs the spec's
schedule plus the kill, and polls `fault_point("serve.replica_kill")` once
per dispatched event, so a kill scheduled at event N is a
`MultiDeviceServer.kill_replica` of the busiest replica at exactly the
N-th event. Slow clients dispatch from their own thread, so a straggler
delays only itself, never the arrival process.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.serve.batcher import QueueFullError
from r2d2_tpu_torch.utils import faults
from r2d2_tpu_torch.utils.faults import FaultPlane, InjectedFault, fault_point

# hard cap on one trace's event count: a mis-specified rate x duration
# should fail loudly, not materialize gigabytes of arrivals
MAX_EVENTS = 200_000


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative traffic scenario. Everything that shapes load is
    here and seeded; nothing about the serving stack is."""

    name: str
    duration_s: float = 4.0
    base_rate: float = 100.0          # arrivals/s at the profile's floor
    rate_profile: str = "constant"    # "constant" | "diurnal" | "flash"
    peak_mult: float = 1.0            # peak rate = base_rate * peak_mult
    flash_at: float = 0.4             # flash window start, fraction of duration
    flash_len: float = 0.2            # flash window length, fraction
    sessions: int = 32                # concurrent session slots
    session_mean_requests: float = 32.0
    session_tail: str = "geometric"   # "geometric" | "pareto"
    pareto_alpha: float = 1.5         # tail exponent (heavier as -> 1)
    slow_frac: float = 0.0            # fraction of sessions that straggle
    slow_delay_s: float = 0.02        # added client-side delay per request
    faults: str = ""                  # FaultPlane spec string, "" = none
    kill_at: float = 0.0              # kill busiest replica at this event
    #                                   fraction (0 = no kill)
    seed: int = 0

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate at scenario time t."""
        if self.rate_profile == "constant":
            return self.base_rate
        if self.rate_profile == "diurnal":
            # one full day-cycle across the scenario: floor at base_rate,
            # crest at base_rate * peak_mult mid-scenario
            phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.duration_s))
            return self.base_rate * (1.0 + (self.peak_mult - 1.0) * phase)
        if self.rate_profile == "flash":
            start = self.flash_at * self.duration_s
            if start <= t < start + self.flash_len * self.duration_s:
                return self.base_rate * self.peak_mult
            return self.base_rate
        raise ValueError(f"unknown rate_profile {self.rate_profile!r}")

    @property
    def peak_rate(self) -> float:
        if self.rate_profile == "constant":
            return self.base_rate
        return self.base_rate * max(self.peak_mult, 1.0)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire at `t` (seconds from scenario start)
    for `session`; `reset` marks a session's first request; `slow` routes
    it through the straggler dispatch path."""

    t: float
    session: str
    reset: bool
    slow: bool


def _draw_session_length(rng: np.random.Generator, spec: ScenarioSpec) -> int:
    """Requests this session will make before ending. Geometric matches
    a constant per-request stop probability; Pareto gives the heavy tail
    (scale chosen so the mean matches session_mean_requests when the
    mean exists, alpha > 1)."""
    m = max(spec.session_mean_requests, 1.0)
    if spec.session_tail == "geometric":
        return int(rng.geometric(1.0 / m))
    if spec.session_tail == "pareto":
        alpha = spec.pareto_alpha
        x_min = m * (alpha - 1.0) / alpha if alpha > 1.0 else 1.0
        return max(int(x_min * (1.0 + rng.pareto(alpha))), 1)
    raise ValueError(f"unknown session_tail {spec.session_tail!r}")


def arrival_trace(spec: ScenarioSpec) -> List[Arrival]:
    """The scenario's full arrival list — a pure function of the spec.

    Non-homogeneous Poisson arrivals by thinning (Lewis & Shedler 1979):
    draw candidate gaps at the PEAK rate, accept each candidate with
    probability rate(t)/peak. Sessions live in `spec.sessions` slots;
    when a slot's drawn request budget is spent, the next arrival on it
    opens a fresh session (reset=True). Slow-client membership is drawn
    once per session at open."""
    rng = np.random.default_rng(spec.seed)
    peak = max(spec.peak_rate, 1e-9)
    out: List[Arrival] = []
    # per-slot: (session id, remaining requests, slow?)
    slot_sid = [f"s{spec.seed}-{i}-0" for i in range(spec.sessions)]
    slot_gen = [0] * spec.sessions
    slot_left = [_draw_session_length(rng, spec) for _ in range(spec.sessions)]
    slot_slow = [bool(rng.random() < spec.slow_frac) for _ in range(spec.sessions)]
    slot_started = [False] * spec.sessions
    t = 0.0
    while True:
        # host numpy RNG throughout: no device values in the trace
        t += float(rng.exponential(1.0 / peak))  # r2d2: disable=blocking-host-sync-in-serve-step  (a host numpy draw)
        if t >= spec.duration_s:
            break
        if rng.random() >= spec.rate_at(t) / peak:
            continue  # thinned: instantaneous rate is below peak here
        slot = int(rng.integers(0, spec.sessions))  # r2d2: disable=blocking-host-sync-in-serve-step  (a host numpy draw)
        if slot_left[slot] <= 0:
            # session over: open a new one in the slot
            slot_gen[slot] += 1
            slot_sid[slot] = f"s{spec.seed}-{slot}-{slot_gen[slot]}"
            slot_left[slot] = _draw_session_length(rng, spec)
            slot_slow[slot] = bool(rng.random() < spec.slow_frac)  # r2d2: disable=blocking-host-sync-in-serve-step  (a host numpy draw)
            slot_started[slot] = False
        reset = not slot_started[slot]
        slot_started[slot] = True
        slot_left[slot] -= 1
        out.append(Arrival(t, slot_sid[slot], reset, slot_slow[slot]))
        if len(out) > MAX_EVENTS:
            raise ValueError(
                f"scenario {spec.name!r} exceeds {MAX_EVENTS} events; "
                "lower base_rate/duration_s"
            )
    return out


class ScenarioRunner:
    """Replays one scenario trace against a live server and reduces the
    outcomes to a readiness row.

    The runner is the serve plane's chaos conductor: it installs the
    composed FaultPlane for the scenario's lifetime, polls the
    `serve.replica_kill` site once per dispatched event (so a scheduled
    kill lands at a deterministic EVENT, not a wall-clock instant), and
    executes the kill against the busiest replica via
    `MultiDeviceServer.kill_replica` — sessions migrate through the
    spill tier and the row reports what survived.
    """

    def __init__(self, server, spec: ScenarioSpec, slo_ms: float = 50.0,
                 drain_s: float = 2.0, timeline: bool = False):
        self.server = server
        self.spec = spec
        self.slo_ms = slo_ms
        self.drain_s = drain_s
        # timeline=True adds a per-second "miss_timeline" to the row
        # ([{t, submitted, misses, p99_ms}...]), to set SLO misses beside
        # scale events. Default off: the row keeps its shape.
        self.timeline = timeline
        self._lock = threading.Lock()
        # (t_submit_rel, latency_s or None, error class or None)
        self._records: List[Tuple[float, Optional[float], Optional[str]]] = []
        self._submitted = 0
        self._kills = 0
        self._slow_q: "deque[Arrival]" = deque()
        self._slow_wake = threading.Event()
        self._slow_done = threading.Event()
        self._obs = None

    # ------------------------------------------------------------ dispatch

    def _record(self, t_rel: float, fut) -> None:
        def _done(f, t_rel=t_rel, t_sub=time.monotonic()):
            err: Optional[str] = None
            lat: Optional[float] = None
            exc = f.exception()
            if exc is None:
                lat = time.monotonic() - t_sub
            elif isinstance(exc, QueueFullError):
                err = "rejected"
            else:
                err = "transport"
            with self._lock:
                self._records.append((t_rel, lat, err))

        fut.add_done_callback(_done)

    def _dispatch(self, ev: Arrival) -> None:
        with self._lock:
            self._submitted += 1
        fut = self.server.submit(ev.session, self._obs, reward=0.0,
                                 reset=ev.reset)
        self._record(ev.t, fut)

    def _slow_worker(self) -> None:
        """Straggler dispatch: each slow request stalls client-side for
        slow_delay_s (plus any `serve.slow_client` fault action) before
        submitting, without holding up the main arrival clock."""
        while True:
            self._slow_wake.wait(0.05)
            self._slow_wake.clear()
            while True:
                with self._lock:
                    ev = self._slow_q.popleft() if self._slow_q else None
                if ev is None:
                    break
                try:
                    fault_point("serve.slow_client")
                except InjectedFault:
                    with self._lock:
                        self._records.append((ev.t, None, "transport"))
                    continue
                time.sleep(self.spec.slow_delay_s)
                self._dispatch(ev)
            if self._slow_done.is_set() and not self._slow_q:
                return

    def _kill_victim(self) -> None:
        """Execute a scheduled replica kill: the busiest ACTIVE replica
        by routed session count (killing the idlest would be a no-op
        drill). Single-replica servers have no survivor — skip."""
        router = getattr(self.server, "router", None)
        if router is None:
            return
        counts = router.counts()
        active = router.active()
        live = [i for i, a in enumerate(active) if a]
        if len(live) < 2:
            return  # no survivor to migrate to
        victim = max(live, key=lambda i: (counts[i], i))
        self.server.kill_replica(victim)
        with self._lock:
            self._kills += 1

    def _plane(self) -> FaultPlane:
        """The scenario's composed fault plane: the spec's own schedule
        plus the kill event (kill_at as a fraction of the trace length,
        so 'kill mid-scenario' is exact and deterministic)."""
        plane = FaultPlane.from_spec(self.spec.faults, seed=self.spec.seed) \
            if self.spec.faults else FaultPlane(seed=self.spec.seed)
        if self.spec.kill_at > 0.0:
            n = max(int(self.spec.kill_at * len(self.trace)), 1)
            plane.schedule.setdefault("serve.replica_kill", {})[n] = "error"
        return plane

    # ----------------------------------------------------------------- run

    def run(self) -> Dict[str, object]:
        """Replay the trace on the wall clock; block until done + drain.
        Returns the scenario's readiness row."""
        cfg = self.server.cfg
        self.trace = arrival_trace(self.spec)
        self._obs = np.zeros(cfg.obs_shape, np.uint8)
        prev_plane = faults.active()
        plane = self._plane()
        faults.install(plane)
        slow_thread = threading.Thread(
            target=self._slow_worker, name="scenario-slow-client", daemon=True
        )
        slow_thread.start()
        t0 = time.monotonic()
        try:
            for ev in self.trace:
                wait = ev.t - (time.monotonic() - t0)
                if wait > 0:
                    time.sleep(wait)
                # the chaos tick: one poll per event — a scheduled kill
                # fires here as InjectedFault at its exact event number
                try:
                    fault_point("serve.replica_kill")
                except InjectedFault:
                    self._kill_victim()
                if ev.slow:
                    with self._lock:
                        self._slow_q.append(ev)
                    self._slow_wake.set()
                else:
                    self._dispatch(ev)
        finally:
            self._slow_done.set()
            self._slow_wake.set()
            slow_thread.join(timeout=max(self.drain_s, 1.0))
            # bounded drain: anything still unresolved after it is a
            # timeout-class failure, not an infinite wait
            deadline = time.monotonic() + self.drain_s
            while time.monotonic() < deadline:
                with self._lock:
                    done = len(self._records) >= self._submitted
                if done:
                    break
                time.sleep(0.01)
            # scenario clients disconnect at scenario end: free every
            # session's device row, slab row, and route. Back-to-back
            # scenarios (a scenario matrix) must not leak finished
            # sessions into the next cell — a later replica kill would
            # export the dead carries and count them against the
            # survivors' slab capacity as spurious sessions_lost
            # sorted: eviction order drives the tap's block-emission order
            # into replay — set order would make back-to-back runs of one
            # seeded scenario diverge bit-wise
            for sid in sorted({ev.session for ev in self.trace}):
                self.server.evict(sid)
            if prev_plane is not None:
                faults.install(prev_plane)
            else:
                faults.uninstall()
        return self._reduce(time.monotonic() - t0)

    # -------------------------------------------------------------- reduce

    def _reduce(self, wall_s: float) -> Dict[str, object]:
        with self._lock:
            records = list(self._records)
            submitted = self._submitted
            kills = self._kills
        lats = np.asarray(
            [lat for _, lat, _ in records if lat is not None], np.float64
        )
        errors = {"rejected": 0, "timeout": 0, "transport": 0}
        for _, _, err in records:
            if err is not None:
                errors[err] += 1
        errors["timeout"] += max(submitted - len(records), 0)
        ok = int(lats.size)
        row: Dict[str, object] = {
            "scenario": self.spec.name,
            "seed": self.spec.seed,
            "events": len(self.trace),
            "submitted": submitted,
            "ok": ok,
            "errors": errors,
            "errors_total": sum(errors.values()),
            "replica_kills": kills,
            "wall_s": round(wall_s, 3),
            "throughput_rps": round(ok / max(wall_s, 1e-9), 2),
            "slo_ms": self.slo_ms,
        }
        if ok:
            row["p50_latency_ms"] = float(np.percentile(lats, 50) * 1e3)
            row["p95_latency_ms"] = float(np.percentile(lats, 95) * 1e3)
            row["p99_latency_ms"] = float(np.percentile(lats, 99) * 1e3)
            # attainment over every SUBMITTED request: errors and
            # timeouts are SLO misses, not excluded samples
            met = int(np.count_nonzero(lats <= self.slo_ms / 1e3))
            row["slo_attainment"] = met / max(submitted, 1)
        else:
            row["p50_latency_ms"] = row["p95_latency_ms"] = None
            row["p99_latency_ms"] = None
            row["slo_attainment"] = 0.0
        if self.timeline:
            slo_s = self.slo_ms / 1e3
            buckets: Dict[int, List] = {}
            for t_rel, lat, err in records:
                # r2d2: disable=blocking-host-sync-in-serve-step  (t_rel is a host float)
                b = buckets.setdefault(int(t_rel), [0, 0, []])
                b[0] += 1
                if err is not None or lat is None or lat > slo_s:
                    b[1] += 1
                if lat is not None:
                    b[2].append(lat)
            row["miss_timeline"] = [
                {
                    "t": sec,
                    "submitted": b[0],
                    "misses": b[1],
                    "p99_ms": round(
                        float(np.percentile(b[2], 99) * 1e3), 1
                    ) if b[2] else None,
                }
                for sec, b in sorted(buckets.items())
            ]
        return row


def builtin_scenarios(
    base_rate: float = 100.0,
    duration_s: float = 4.0,
    sessions: int = 32,
    seed: int = 0,
) -> List[ScenarioSpec]:
    """The built-in scenario set: one per failure mode the serve plane
    claims to survive, plus the steady control."""
    return [
        ScenarioSpec(
            name="steady", duration_s=duration_s, base_rate=base_rate,
            sessions=sessions, seed=seed,
        ),
        ScenarioSpec(
            name="diurnal", duration_s=duration_s, base_rate=base_rate,
            rate_profile="diurnal", peak_mult=3.0, sessions=sessions,
            seed=seed + 1,
        ),
        ScenarioSpec(
            name="flash_crowd", duration_s=duration_s, base_rate=base_rate,
            rate_profile="flash", peak_mult=8.0, flash_at=0.4, flash_len=0.2,
            sessions=sessions, seed=seed + 2,
        ),
        ScenarioSpec(
            name="heavy_tail", duration_s=duration_s, base_rate=base_rate,
            session_tail="pareto", pareto_alpha=1.3, sessions=sessions,
            seed=seed + 3,
        ),
        ScenarioSpec(
            name="slow_clients", duration_s=duration_s, base_rate=base_rate,
            slow_frac=0.25, slow_delay_s=0.02, sessions=sessions,
            seed=seed + 4,
        ),
        ScenarioSpec(
            name="replica_kill", duration_s=duration_s, base_rate=base_rate,
            sessions=sessions, kill_at=0.5, seed=seed + 5,
        ),
    ]
