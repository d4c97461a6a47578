"""The autoscaler: a control loop that grows and drains the serving fleet
from its own SLO signals (port of r2d2_tpu/serve/autoscale.py; host code,
the same decisions from the same signals).

Its verbs exist on the fleet (serve/multi.py): `add_replica` builds,
warms, publishes and activates a replica, and `kill_replica` migrates a
replica's sessions through the spill slabs with none lost. This loop
drives them from the fleet's windowed signals (queue fraction, p99 and
SLO attainment over the `SignalWindow` it shares with the degradation
ladder), with the ladder's dwell hysteresis and dead band, so an
oscillating signal parks the fleet size.

Each tick:

- pressured (queue_frac >= queue_high, or p99 past `pressure_margin *
  slo_ms`, or attainment < attain_low) for `dwell_up` ticks, below
  `max_replicas`, out of the cooldown: one `add_replica()`. Capacity is
  bought while the SLO still has headroom, since a replica takes seconds
  to land.
- healthy for `dwell_down` ticks, above `min_replicas`, out of the
  cooldown: drain a replica through `kill_replica`. Under
  `drain_requires_idle` (the default) the drain waits until some replica
  is idle (nothing in flight, no request for `idle_age_s`): the signals
  describe the fleet at its present size, not the smaller one.
- after an event the window resets and `cooldown_s` holds every decision.

Scaling takes seconds and the ladder milliseconds, so the autoscaler
installs `degrade.rung_up_gate`: a quality rung up fires only while a
scale-up is in flight or the fleet is at `max_replicas`. Recovery is
never gated.

`_iteration()` runs under the autoscaler's own supervisor ("autoscaler"),
apart from the sub-second watch and ladder ticks. Its state is under one
lock and the scale actions run outside it; locks nest degrade -> autoscale
(the gate) and autoscale -> router, never the other way. Fault sites:
`autoscale.evaluate` (every tick), `autoscale.scale_up` and
`autoscale.scale_down` (at a decision). With `serve_autoscale` False none
of this exists.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from r2d2_tpu_torch.serve.degrade import SignalWindow
from r2d2_tpu_torch.utils.faults import fault_point
from r2d2_tpu_torch.utils.supervision import Supervisor


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Scale thresholds. Same hysteresis vocabulary as DegradeConfig:
    enter/exit bands deliberately apart, dwell counts in consecutive
    evaluation ticks, plus the event-rate bounds (cooldown) scaling needs
    and the ladder doesn't."""

    min_replicas: int = 1
    max_replicas: int = 2
    eval_interval_s: float = 0.25
    window: int = 512           # latency samples (own window only; with a
    min_samples: int = 8        # degrade ladder the ladder's window is shared)
    slo_ms: float = 50.0
    pressure_margin: float = 0.8  # scale-up pressure judges p99 against
                                # margin * slo_ms: buy the replica while
                                # the budget still has headroom (warmup
                                # takes seconds). Healthy/recovery still
                                # judge the FULL SLO.
    queue_high: float = 0.25    # pressured when depth >= high * queue bound
    queue_low: float = 0.05     # healthy requires depth <= low * queue bound
    attain_low: float = 0.95    # pressured when SLO attainment < low
    attain_high: float = 0.98   # healthy requires attainment >= high
    dwell_up: int = 2
    dwell_down: int = 12
    cooldown_s: float = 2.0     # quiet period after any scale event
    idle_age_s: float = 1.0     # drain candidate's request-free threshold
    drain_requires_idle: bool = True  # a drain HOLDS until some replica
                                # is truly idle: fleet health signals
                                # describe the CURRENT size, not the
                                # smaller one, so a comfortable fleet
                                # mid-crest must not drain into the
                                # crest. Off: the dwell alone decides.
    stale_after_s: float = 5.0  # latency signals abstain past this sample
                                # age (an idle fleet's last crest must not
                                # hold a verdict forever)

    @classmethod
    def from_system(cls, cfg) -> "AutoscaleConfig":
        """Derive from the R2D2Config knob block (config.serve_autoscale
        and friends); the SLO target is shared with the degrade ladder."""
        return cls(
            min_replicas=cfg.autoscale_min_replicas,
            max_replicas=cfg.autoscale_max_replicas,
            eval_interval_s=cfg.autoscale_interval_s,
            slo_ms=cfg.serve_degrade_slo_ms,
            pressure_margin=cfg.autoscale_pressure_margin,
            dwell_up=cfg.autoscale_dwell_up,
            dwell_down=cfg.autoscale_dwell_down,
            cooldown_s=cfg.autoscale_cooldown_s,
            idle_age_s=cfg.autoscale_idle_age_s,
            drain_requires_idle=cfg.autoscale_drain_requires_idle,
        )


class Autoscaler:
    """Watches a fleet's overload signals and scales its replica set.

    `server` is a MultiDeviceServer (or a test double exposing the same
    surface): `queue_depth()` / `queue_bound`, `active_replicas()`,
    `add_replica()`, `kill_replica(idx)`, `stats()` with the per-replica
    idle triplet (`replica_active`, `replica_inflight`,
    `replica_last_request_age_s`) and `router_counts`, and optionally
    `.degrade` (whose SignalWindow is then shared and whose
    `rung_up_gate` gets the interlock)."""

    def __init__(self, server, cfg: Optional[AutoscaleConfig] = None):
        self.server = server
        self.cfg = cfg if cfg is not None else AutoscaleConfig.from_system(
            server.cfg
        )
        self._lock = threading.Lock()
        self._up_evals = 0
        self._down_evals = 0
        self._scaling = False          # an add_replica is in flight
        self._cooldown_until = 0.0     # monotonic deadline
        self._t0 = time.monotonic()
        # (monotonic t, active replica count) transition points; seeded at
        # start() so chip_seconds() integrates the whole served interval
        self._trace: List[Tuple[float, int]] = []
        self.evaluations = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_errors = 0
        self.drain_holds = 0
        # per-drain provenance: {replica, idle_age_s, inflight,
        # affinities} for every victim actually killed (guarded by _lock)
        self._drain_log: List[Dict[str, object]] = []
        self.supervisor: Optional[Supervisor] = None
        degrade = getattr(server, "degrade", None)
        if degrade is not None:
            # ONE window for both controllers: the ladder's observe path
            # already feeds it from every replica, and both judge the
            # same latencies — the shared-SignalWindow contract
            self.window = degrade.window
            self._own_window = False
            degrade.rung_up_gate = self._quality_gate
        else:
            self.window = SignalWindow(
                self.cfg.window, self.cfg.slo_ms, self.cfg.min_samples
            )
            self._own_window = True
            for r in getattr(server, "replicas", ()):
                self.attach(r)

    def attach(self, replica) -> None:
        """Wire a replica's completion latencies into the autoscaler's own
        window (no-op when the window is the degrade ladder's — the
        replica's shared `.degrade` already feeds it). add_replica calls
        this for replicas born after the autoscaler."""
        if self._own_window:
            replica._latency_sinks = tuple(replica._latency_sinks) + (
                self.window,
            )

    # ------------------------------------------------------------- interlock

    def _quality_gate(self) -> bool:
        """degrade.rung_up_gate: quality-degrading rung steps are allowed
        only while capacity is mid-answer (a scale-up in flight — the
        ladder is the shock absorber inside the warmup window) or cannot
        answer at all (fleet pinned at max). Deliberately NOT open during
        the post-event cooldown: once the replica lands, added capacity
        is draining the backlog, and an open gate there lets the ladder
        ratchet into the quality arms against a receding queue — a shed
        equilibrium the recovery dwell then has to climb out of."""
        with self._lock:
            scaling = self._scaling
        if scaling:
            return True
        return self.server.active_replicas() >= self.cfg.max_replicas

    # --------------------------------------------------------------- signals

    def signals(self) -> Dict[str, float]:
        out = {"queue_frac": self.server.queue_depth()
               / max(self.server.queue_bound, 1)}
        out.update(self.window.signals())
        return out

    # -------------------------------------------------------------- decision

    def evaluate_once(self) -> Optional[str]:
        """One bounded evaluation tick: read the signals, advance the
        hysteresis dwells, fire at most one scale event. Returns "up" /
        "down" on an event, else None."""
        fault_point("autoscale.evaluate")
        sig = self.signals()
        cfg = self.cfg
        have_lat = (
            sig["samples"] >= cfg.min_samples
            and sig.get("age_s", 0.0) <= cfg.stale_after_s
        )
        pressured = sig["queue_frac"] >= cfg.queue_high or (
            have_lat
            and (sig["p99_ms"] > cfg.slo_ms * cfg.pressure_margin
                 or sig["attainment"] < cfg.attain_low)
        )
        healthy = sig["queue_frac"] <= cfg.queue_low and (
            not have_lat or (sig["p99_ms"] <= cfg.slo_ms
                             and sig["attainment"] >= cfg.attain_high)
        )
        now = time.monotonic()
        decision = None
        with self._lock:
            self.evaluations += 1
            if pressured:
                self._up_evals += 1
                self._down_evals = 0
            elif healthy:
                self._down_evals += 1
                self._up_evals = 0
            # between the bands: hold both dwells (the dead band — an
            # oscillating signal parks the fleet size, never flaps it)
            if now >= self._cooldown_until and not self._scaling:
                n = self.server.active_replicas()
                if self._up_evals >= cfg.dwell_up and n < cfg.max_replicas:
                    self._up_evals = 0
                    self._scaling = True  # opens the quality gate NOW —
                    decision = "up"       # the ladder absorbs the warmup
                elif (
                    self._down_evals >= cfg.dwell_down
                    and n > cfg.min_replicas
                ):
                    # the dwell is NOT reset here: _scale_down may hold
                    # (drain_requires_idle and nobody idle) and must stay
                    # armed for the next tick; a drain that fires resets
                    # it there
                    decision = "down"
        if decision == "up":
            return self._scale_up()
        if decision == "down":
            return self._scale_down()
        return None

    def _scale_up(self) -> str:
        fault_point("autoscale.scale_up")
        try:
            self.server.add_replica()
        except BaseException:
            with self._lock:
                self.scale_errors += 1
                self._scaling = False
            raise  # supervised restart; the dwell re-accumulates
        self._settle("up")
        return "up"

    def _scale_down(self) -> Optional[str]:
        fault_point("autoscale.scale_down")
        victim, info = self._drain_choice()
        if victim is not None:
            # drain provenance: WHICH replica went and how quiet it
            # actually was (idle-age straight from the fleet's stats
            # triplet) — the audit trail for "we never drained a replica
            # that was mid-conversation"
            with self._lock:
                self._drain_log.append(info)
        if victim is None:
            # drain_requires_idle and every replica is still talking:
            # hold — the armed dwell retries next tick (drain_holds
            # counts the waits)
            with self._lock:
                self.drain_holds += 1
            return None
        with self._lock:
            self._down_evals = 0
        try:
            self.server.kill_replica(victim)
        except BaseException:
            with self._lock:
                self.scale_errors += 1
            raise
        self._settle("down")
        return "down"

    def _settle(self, event: str) -> None:
        now = time.monotonic()
        n = self.server.active_replicas()
        with self._lock:
            self._scaling = False
            self._cooldown_until = now + self.cfg.cooldown_s
            if event == "up":
                self.scale_ups += 1
            else:
                self.scale_downs += 1
            self._trace.append((now, n))
        # pre-event latencies must not judge the new fleet size (and a
        # stale pressured window must not fire a second event the instant
        # the cooldown expires)
        self.window.reset()

    def _pick_drain_victim(self) -> Optional[int]:
        return self._drain_choice()[0]

    def _drain_choice(self) -> Tuple[Optional[int], Optional[Dict[str, object]]]:
        """The drain choice, from the fleet's per-replica idle triplet: a
        truly idle replica (nothing in flight, no request for idle_age_s)
        beats everything; ties and non-idle fleets drain the least-loaded
        by affinity count. Under `drain_requires_idle` (default) a
        non-idle fleet returns None instead — the drain holds until some
        replica has demonstrably nothing to say. Returns the replica index
        and its provenance record for the drain log, or (None, None). The
        record is returned, never stored: two callers (the worker and a
        direct evaluate_once) each log their own choice."""
        st = self.server.stats()
        active = st["replica_active"]
        inflight = st["replica_inflight"]
        ages = st["replica_last_request_age_s"]
        counts = st["router_counts"]
        best = None
        for i, a in enumerate(active):
            if not a:
                continue
            idle = 0 if (inflight[i] == 0 and ages[i] >= self.cfg.idle_age_s) \
                else 1
            key = (idle, counts[i], inflight[i], -ages[i], i)
            if best is None or key < best[0]:
                best = (key, i)
        if best is None:
            raise RuntimeError("no active replica to drain")
        if self.cfg.drain_requires_idle and best[0][0] != 0:
            return None, None
        i = best[1]
        return i, {
            "replica": i,
            "idle_age_s": round(float(ages[i]), 3),
            "inflight": int(inflight[i]),
            "affinities": int(counts[i]),
        }

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self.supervisor is not None:
            raise RuntimeError("autoscaler already started")
        now = time.monotonic()
        n = self.server.active_replicas()
        with self._lock:
            self._t0 = now
            self._trace = [(now, n)]
        self.supervisor = Supervisor()
        self.supervisor.spawn(
            "autoscaler",
            lambda: self._iteration(),
            max_restarts=self.server.serve_cfg.max_restarts,
        )

    def _iteration(self) -> None:
        # supervised worker body: one bounded tick, then a stoppable wait
        self.evaluate_once()
        if self.supervisor is not None:
            self.supervisor.stop.wait(self.cfg.eval_interval_s)
        else:
            time.sleep(self.cfg.eval_interval_s)

    def stop(self, timeout: float = 5.0) -> None:
        if self.supervisor is not None:
            self.supervisor.shutdown(timeout)
            self.supervisor = None

    # --------------------------------------------------------------- metrics

    def chip_seconds(self, until: Optional[float] = None) -> float:
        """Integral of the active replica count over time since start(),
        in replica-seconds: what the traffic cost, beside a fleet sized
        for its peak."""
        end = time.monotonic() if until is None else until
        with self._lock:
            pts = list(self._trace)
        total = 0.0
        for (t, n), (t_next, _) in zip(pts, pts[1:] + [(end, 0)]):
            total += n * max(t_next - t, 0.0)
        return total

    def replica_trace(self) -> List[Dict[str, float]]:
        with self._lock:
            t0 = self._t0
            return [
                {"t": round(t - t0, 3), "replicas": n}
                for t, n in self._trace
            ]

    def stats(self) -> Dict[str, object]:
        now = time.monotonic()
        with self._lock:
            return {
                "autoscale_evaluations": self.evaluations,
                "autoscale_scale_ups": self.scale_ups,
                "autoscale_scale_downs": self.scale_downs,
                "autoscale_scale_errors": self.scale_errors,
                "autoscale_drain_holds": self.drain_holds,
                "autoscale_drain_log": [dict(d) for d in self._drain_log],
                "autoscale_in_flight": self._scaling,
                "autoscale_cooldown_active": now < self._cooldown_until,
                "autoscale_trace": [
                    {"t": round(t - self._t0, 3), "replicas": n}
                    for t, n in self._trace[-64:]
                ],
            }
