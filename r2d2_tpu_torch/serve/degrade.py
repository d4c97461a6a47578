"""The degradation ladder of the serving plane (port of
r2d2_tpu/serve/degrade.py; host numpy, the same rung transitions from the
same signals).

Under overload a stateful policy service has three levers, each a measured
trade of latency against quality: shed load before it queues, serve
cheaper weights, and shrink the session memory. The controller pulls them
in order, as a ladder of rungs:

    rung 0  "full"   no shedding, the config's own weights
    rung 1  "admit"  admission control at the micro-batcher: submissions
                     past a queue watermark fail with QueueFullError,
                     within a bounded shed budget per tick
    rung 2  "bf16"   + the weights rounded to bfloat16 (the serve step
                     upcasts them again, so only their rounding drifts)
    rung 3  "int8"   + int8 weights (ops/quantize.py) and the session
                     spill slab shed to its keep watermark

It watches the queue depth, the windowed p99 latency and the windowed SLO
attainment and steps with hysteresis: a rung moves only after `dwell_up`
pressured (or `dwell_down` healthy) evaluations in a row, the enter and
exit bands are apart, and an evaluation between them resets neither
count, so an oscillating signal parks the ladder. Every transition is
stamped into `transitions`.

`observe()` runs once per answered request on the serve completion path;
`evaluate_once()` is one bounded tick of the supervised
"degrade-controller" worker. The controller's state is under one lock, and
a rung's actions (a publish casts or quantizes and copies to the device)
run outside it. `SignalWindow` is shared with the autoscaler
(serve/autoscale.py), which installs `rung_up_gate`: a rung up fires only
while a scale-up is in flight or the fleet is at its largest, so steady
pressure buys a replica, not lower quality. With `serve_degrade` False no
controller exists and the serve path is unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# rung order IS the ladder; index = rung number
RUNGS: Tuple[str, ...] = ("full", "admit", "bf16", "int8")

# admission watermark per rung, as a fraction of the queue bound (rung 0
# installs None: no admission control at all, the bit-identical default)
_ADMIT_FRAC = {"admit": 0.5, "bf16": 0.375, "int8": 0.25}


class SignalWindow:
    """Sliding latency window + derived SLO signals, shared by the degrade
    ladder and the elastic autoscaler (serve/autoscale.py).

    A bounded ring buffer of per-request latencies (seconds) fed by the
    serve completion path; `signals()` derives windowed p99 and SLO
    attainment against `slo_ms`. Below `min_samples` the latency signals
    abstain (p99 0.0, attainment 1.0) so a cold window never pressures a
    controller. Thread-safe: observe() is called from serve loop(s) while
    controllers read concurrently."""

    def __init__(self, window: int, slo_ms: float, min_samples: int = 8):
        self.window = int(window)
        self.slo_ms = float(slo_ms)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self._buf: List[float] = []  # ring buffer of latency seconds
        self._idx = 0
        self._last_observe_t: Optional[float] = None

    def observe(self, latency_s: float) -> None:
        """One answered request's latency (serve-loop thread(s))."""
        with self._lock:
            if len(self._buf) < self.window:
                self._buf.append(latency_s)
            else:
                self._buf[self._idx] = latency_s
                self._idx = (self._idx + 1) % self.window
            self._last_observe_t = time.monotonic()

    def reset(self) -> None:
        """Drop the window (at a scenario boundary)."""
        with self._lock:
            self._buf = []
            self._idx = 0
            self._last_observe_t = None

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._buf, np.float64)

    def signals(self) -> Dict[str, float]:
        lats = self.snapshot()
        with self._lock:
            last = self._last_observe_t
        # sample age lets a controller discount a window that stopped
        # filling (an idle fleet produces no latencies — its last crest's
        # p99 must not hold a pressure verdict forever)
        age = float("inf") if last is None else time.monotonic() - last
        out = {"p99_ms": 0.0, "attainment": 1.0, "samples": float(lats.size),
               "age_s": age}
        if lats.size >= self.min_samples:
            out["p99_ms"] = float(np.percentile(lats, 99) * 1e3)
            out["attainment"] = float(
                np.count_nonzero(lats <= self.slo_ms / 1e3) / lats.size
            )
        return out


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Ladder thresholds. The enter (high/low) pairs are the hysteresis
    bands; dwell counts are consecutive evaluation ticks."""

    slo_ms: float = 50.0
    eval_interval_s: float = 0.25
    window: int = 512           # latency samples the signals are computed over
    min_samples: int = 8        # below this the latency signals abstain
    queue_high: float = 0.5     # pressured when depth >= high * queue bound
    queue_low: float = 0.05     # healthy requires depth <= low * queue bound
    attain_low: float = 0.9     # pressured when SLO attainment < low
    attain_high: float = 0.98   # healthy requires attainment >= high
    dwell_up: int = 2
    dwell_down: int = 8
    shed_budget: int = 256      # max sheds re-armed per evaluation tick
    spill_keep_frac: float = 0.5  # int8 rung: slab shed watermark


class DegradeController:
    """Watches a server's overload signals and steps the rung ladder.

    `server` is a PolicyServer or MultiDeviceServer — both expose the
    same degrade surface: `set_arm(arm)`, `set_admission(limit, budget)`,
    `shed_spill(frac)`, `queue_depth()`, and `queue_bound`.
    """

    def __init__(self, server, cfg: DegradeConfig = DegradeConfig()):
        self.server = server
        self.cfg = cfg
        self._lock = threading.Lock()
        # serializes the rung actions; each applies the rung current when it
        # runs, so a tick's re-arm racing a pin cannot re-publish the rung
        # the pin just left (the JAX controller applies the rung it read)
        self._apply_lock = threading.Lock()
        self.window = SignalWindow(cfg.window, cfg.slo_ms, cfg.min_samples)
        self._up_evals = 0
        self._down_evals = 0
        self._rung = 0
        self._pinned = False
        # scale-vs-degrade interlock (serve/autoscale.py): when installed,
        # a quality-degrading rung step (pressured rung-up) fires only
        # while the gate returns True — i.e. while a scale-up is in flight
        # or the fleet is already at max size. Recovery is never gated.
        # None (default, and whenever no autoscaler exists) keeps the
        # pre-interlock behavior exactly.
        self.rung_up_gate = None
        self.gated_holds = 0  # pressured dwells held back by the gate
        self.evaluations = 0
        self.rung_ups = 0
        self.rung_downs = 0
        # (monotonic t, from_rung, to_rung, reason) — bounded history
        self.transitions: List[Tuple[float, str, str, str]] = []

    # -------------------------------------------------------------- signals

    def observe(self, latency_s: float) -> None:
        """One answered request's latency (serve-loop thread(s))."""
        self.window.observe(latency_s)

    def reset_window(self) -> None:
        """Drop the latency window (at a scenario boundary)."""
        self.window.reset()
        with self._lock:
            self._up_evals = 0
            self._down_evals = 0

    def signals(self) -> Dict[str, float]:
        depth = float(self.server.queue_depth())
        bound = max(float(self.server.queue_bound), 1.0)
        out = {"queue_frac": depth / bound}
        out.update(self.window.signals())
        return out

    # --------------------------------------------------------------- ladder

    @property
    def rung(self) -> int:
        return self._rung

    @property
    def rung_name(self) -> str:
        return RUNGS[self._rung]

    @property
    def pinned(self) -> bool:
        return self._pinned

    def pin(self, rung) -> None:
        """Force a rung and stop auto-stepping (a scenario matrix pins each
        rung so scenario cells measure ONE ladder position)."""
        idx = RUNGS.index(rung) if isinstance(rung, str) else int(rung)
        with self._lock:
            self._pinned = True
            prev = self._rung
            self._rung = idx
            if idx != prev:
                self._stamp(prev, idx, "pinned")
        self._apply()

    def _stamp(self, prev: int, new: int, reason: str) -> None:
        # caller holds self._lock
        self.transitions.append(
            (time.monotonic(), RUNGS[prev], RUNGS[new], reason)
        )
        del self.transitions[:-256]
        if new > prev:
            self.rung_ups += 1
        else:
            self.rung_downs += 1

    def _apply(self) -> None:
        """Install the current rung's actions on the server, under the apply
        lock only: arm publication stages a quantize/cast + device
        transfer."""
        with self._apply_lock:
            with self._lock:
                rung_idx = self._rung
            self._apply_rung(rung_idx)

    def _apply_rung(self, rung_idx: int) -> None:
        name = RUNGS[rung_idx]
        frac = _ADMIT_FRAC.get(name)
        limit = None if frac is None else int(frac * self.server.queue_bound)
        self.server.set_admission(limit, budget=self.cfg.shed_budget)
        self.server.set_arm(name if name in ("bf16", "int8") else "full")
        if name == "int8":
            self.server.shed_spill(self.cfg.spill_keep_frac)

    def evaluate_once(self) -> Optional[str]:
        """One bounded evaluation tick: read the signals, advance the
        hysteresis counters, step at most one rung. Returns the new rung
        name on a transition, else None."""
        sig = self.signals()
        cfg = self.cfg
        have_lat = sig["samples"] >= cfg.min_samples
        pressured = sig["queue_frac"] >= cfg.queue_high or (
            have_lat and (sig["p99_ms"] > cfg.slo_ms
                          or sig["attainment"] < cfg.attain_low)
        )
        healthy = sig["queue_frac"] <= cfg.queue_low and (
            not have_lat or (sig["p99_ms"] <= cfg.slo_ms
                             and sig["attainment"] >= cfg.attain_high)
        )
        # interlock probe BEFORE taking the controller lock: the gate reads
        # autoscaler state under the autoscaler's own lock, and degrade-
        # lock -> autoscale-lock nesting here with the reverse order
        # anywhere else would be a lock-order cycle
        gate = self.rung_up_gate
        gate_open = gate is None or bool(gate())
        apply: Optional[int] = None
        stepped = False
        with self._lock:
            self.evaluations += 1
            if self._pinned:
                # keep the shed allowance of a pinned admit-class rung armed
                apply = self._rung if RUNGS[self._rung] in _ADMIT_FRAC else None
            else:
                if pressured:
                    self._up_evals += 1
                    self._down_evals = 0
                elif healthy:
                    self._down_evals += 1
                    self._up_evals = 0
                # between the bands: hold both counters — the dead band is
                # what keeps an oscillating signal from flapping the ladder
                if self._up_evals >= cfg.dwell_up and self._rung < len(RUNGS) - 1:
                    if gate_open:
                        prev, self._rung = self._rung, self._rung + 1
                        self._up_evals = 0
                        self._stamp(prev, self._rung, "pressured")
                        apply, stepped = self._rung, True
                    else:
                        # scale-vs-degrade interlock: capacity (a pending
                        # scale-up) answers sustained pressure; the dwell
                        # is HELD, not reset, so the rung fires on the
                        # first tick the gate opens
                        self.gated_holds += 1
                elif self._down_evals >= cfg.dwell_down and self._rung > 0:
                    prev, self._rung = self._rung, self._rung - 1
                    self._down_evals = 0
                    self._stamp(prev, self._rung, "recovered")
                    apply, stepped = self._rung, True
                elif RUNGS[self._rung] in _ADMIT_FRAC:
                    apply = self._rung  # re-arm the bounded shed allowance
        if apply is not None:
            self._apply()
        return RUNGS[apply] if stepped else None

    # -------------------------------------------------------------- metrics

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "degrade_rung": self._rung,
                "degrade_rung_name": RUNGS[self._rung],
                "degrade_rung_ups": self.rung_ups,
                "degrade_rung_downs": self.rung_downs,
                "degrade_evaluations": self.evaluations,
                "degrade_pinned": self._pinned,
                "degrade_gated_holds": self.gated_holds,
                "degrade_transitions": [
                    {"t": round(t, 3), "from": a, "to": b, "reason": r}
                    for t, a, b, r in self.transitions[-16:]
                ],
            }
