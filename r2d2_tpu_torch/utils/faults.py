"""Deterministic fault injection and the shared retry/backoff helpers (port
of r2d2_tpu/utils/faults.py; the library carries no JAX, and the port keeps
its own copy, the crc32 schedule included).

Long runs on preemptible machines fail by interruption: a SIGTERM with a
grace window, a flaky host->device transfer, a checkpoint write into a
flaky file system. Each host-side subsystem marks its boundaries with
`fault_point("site")`, which costs one global read and one `is None`
branch when no plane is installed; a test, or an operator through the
R2D2_FAULTS variable, installs a seeded schedule that fires errors, stalls
or a real SIGTERM at exact call counts.

Determinism: a FaultPlane fires as a pure function of (seed, site, the
site's call number), so a drill that kills the trainer at site X call N
reproduces from the spec string alone, and the port fires at exactly the
(site, call) pairs the JAX package fires at for the same spec.

`with_retries` wraps the flaky boundaries (host->device copies, checkpoint
I/O) in bounded exponential backoff and counts every retry per site in
`retry_stats()`, so the metrics stream carries the flake rate.

Registered sites (KNOWN_SITES): the ones wired into the port.
- trainer.update      top of every learner update (SIGTERM injection)
- actor.step          top of every host collection step
- host_plane.h2d      host replay batch lift to the device (train.py)
- tiered.stage_h2d    staged chunk's copy to the device
                      (replay/tiered_store.py)
- checkpoint.save     checkpoint write (utils/checkpoint.py)
- checkpoint.restore  checkpoint read (utils/checkpoint.py)
- snapshot.write      replay snapshot npz write (replay/snapshot.py)
- disk.write          one demoted block's segment-record write, before the
                      bytes land (replay/disk_tier.py)
- disk.promote        one disk-resident block's page-in and decode
                      (replay/disk_tier.py)
- codec.decode        one encoded field's decode (replay/codec.py)
- serve.reload        the serve plane's checkpoint hot reload
                      (serve/server.py)
- serve.replica_stall top of every serve-loop iteration: "stall:S" wedges
                      the serve loop for S seconds, "error" exercises its
                      supervised restart (serve/server.py)
- serve.client        one TCP client round trip (serve/client.py)
- serve.replica_kill  one poll per dispatched scenario event: "error" kills
                      the busiest replica at that event
                      (serve/scenarios.py)
- serve.slow_client   one straggler request before it is sent
                      (serve/scenarios.py)
- liveloop.tap        top of every tap drain (liveloop/loop.py)
- liveloop.ingest     top of every ingest drain (liveloop/loop.py); the
                      bridge's add into replay retries under the same name
- autoscale.evaluate  top of every autoscaler tick (serve/autoscale.py)
- autoscale.scale_up  a scale-up decision, before the replica is added
- autoscale.scale_down a drain decision, before the victim is picked
- transport.connect   the publisher's connect and handshake to the
                      learner's ingest service, retried under jittered
                      backoff (transport/publisher.py)
- transport.send      one framed send on the publisher's socket: an "error"
                      drops the connection, and the unacked spool tail is
                      sent again after the reconnect handshake
- transport.recv      one framed receive (ACK, CKPT, HEARTBEAT) on the
                      publisher's socket
- transport.spool     the publisher's per-block spool write (the
                      at-least-once persistence point; on disk when
                      transport_spool_dir is set)
- ingest.accept       the ingest service's accept of one host connection
                      (transport/ingest.py)
- ingest.dedup        the per-host sequence-number admission check of every
                      received BLOCK frame (the exactly-once seam)
- reshard.gather      the elastic resume's read of every snapshot file
                      (replay/reshard.py)
- reshard.scatter     the elastic resume's re-split into the new layout
                      (replay/reshard.py)
"""

from __future__ import annotations

import os
import signal
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Type

# every site wired into the port; tests/test_torch_faults.py holds this
# tuple and the fault_point("...") literals of the package to each other
KNOWN_SITES = (
    "trainer.update",
    "actor.step",
    "host_plane.h2d",
    "tiered.stage_h2d",
    "checkpoint.save",
    "checkpoint.restore",
    "snapshot.write",
    "disk.write",
    "disk.promote",
    "codec.decode",
    "serve.reload",
    "serve.replica_stall",
    "serve.client",
    "serve.replica_kill",
    "serve.slow_client",
    "liveloop.tap",
    "liveloop.ingest",
    "autoscale.evaluate",
    "autoscale.scale_up",
    "autoscale.scale_down",
    "transport.connect",
    "transport.send",
    "transport.recv",
    "transport.spool",
    "ingest.accept",
    "ingest.dedup",
    "reshard.gather",
    "reshard.scatter",
)


class InjectedFault(RuntimeError):
    """A fault_point fired an 'error' action. Transient for with_retries:
    the injected stand-in for a flaky transfer or file system."""


class FaultPlane:
    """A seeded schedule of named fault sites.

    Two trigger forms, combinable:
    - `schedule={site: {n: action}}` fires `action` on the site's n-th call
      (1-based, counted per site since install);
    - `rates={site: (p, action)}` fires on the calls where a crc32 hash of
      (seed, site, n) maps below p.

    Actions: "error" (raise InjectedFault), "sigterm" (deliver SIGTERM to
    this process; the call returns normally), "stall:S" (sleep S seconds),
    "exit:C" (os._exit(C)). `max_fires` bounds the total firings.
    Thread-safe; counters are per site."""

    def __init__(
        self,
        schedule: Optional[Dict[str, Dict[int, str]]] = None,
        rates: Optional[Dict[str, Tuple[float, str]]] = None,
        seed: int = 0,
        max_fires: Optional[int] = None,
    ):
        self.schedule = {s: dict(m) for s, m in (schedule or {}).items()}
        self.rates = dict(rates or {})
        self.seed = seed
        self.max_fires = max_fires
        self.calls: Dict[str, int] = {}
        self.fired: List[Tuple[str, int, str]] = []  # (site, call_n, action)
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlane":
        """Parse the R2D2_FAULTS format: comma- or semicolon-separated
        clauses `site@N=action` (exact call) or `site%P=action` (seeded
        rate P in [0, 1]), plus `seed=K` and `max_fires=K`:

            R2D2_FAULTS="trainer.update@5=sigterm,tiered.stage_h2d%0.05=error,seed=7"
        """
        schedule: Dict[str, Dict[int, str]] = {}
        rates: Dict[str, Tuple[float, str]] = {}
        max_fires = None
        for clause in spec.replace(";", ",").split(","):
            clause = clause.strip()
            if not clause:
                continue
            key, _, action = clause.partition("=")
            if not action:
                raise ValueError(f"fault spec clause {clause!r} needs '=action'")
            key = key.strip()
            action = action.strip()
            if key == "seed":
                seed = int(action)
            elif key == "max_fires":
                max_fires = int(action)
            elif "@" in key:
                site, _, n = key.partition("@")
                schedule.setdefault(site, {})[int(n)] = action
            elif "%" in key:
                site, _, p = key.partition("%")
                rates[site] = (float(p), action)
            else:
                raise ValueError(
                    f"fault spec clause {clause!r}: expected site@N=action, "
                    "site%P=action, seed=K, or max_fires=K"
                )
        return cls(schedule=schedule, rates=rates, seed=seed, max_fires=max_fires)

    def _decide(self, site: str) -> Optional[Tuple[int, str]]:
        with self._lock:
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            if self.max_fires is not None and len(self.fired) >= self.max_fires:
                return None
            action = self.schedule.get(site, {}).get(n)
            if action is None and site in self.rates:
                p, rate_action = self.rates[site]
                h = zlib.crc32(f"{self.seed}:{site}:{n}".encode())
                if h / 2**32 < p:
                    action = rate_action
            if action is None:
                return None
            self.fired.append((site, n, action))
            return n, action

    def hit(self, site: str) -> None:
        decided = self._decide(site)
        if decided is None:
            return
        n, action = decided
        if action == "error":
            raise InjectedFault(f"injected fault at {site!r} (call {n})")
        if action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if action.startswith("stall:"):
            time.sleep(float(action[6:]))
            return
        if action.startswith("exit:"):
            os._exit(int(action[5:]))
        raise ValueError(f"unknown fault action {action!r} at {site!r}")


# the installed plane; None keeps fault_point at one global read and a branch
_PLANE: Optional[FaultPlane] = None


def fault_point(site: str) -> None:
    """Named fault site. No-op unless a FaultPlane is installed."""
    plane = _PLANE
    if plane is not None:
        plane.hit(site)


def install(plane: FaultPlane) -> FaultPlane:
    global _PLANE
    _PLANE = plane
    return plane


def uninstall() -> None:
    global _PLANE
    _PLANE = None


def active() -> Optional[FaultPlane]:
    return _PLANE


def install_from_env(var: str = "R2D2_FAULTS") -> Optional[FaultPlane]:
    """Entry-point hook (the trainer CLI): install a plane from the
    variable's spec string, if it is set."""
    spec = os.environ.get(var)
    if not spec:
        return None
    return install(FaultPlane.from_spec(spec))


# ------------------------------------------------------------------ retries

# the transient class: injected faults and the OS-level errors of a flaky
# file system or transfer; never a bare Exception, so a logic error is not
# retried into "success"
TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (
    InjectedFault,
    OSError,
    ConnectionError,
)

_retry_lock = threading.Lock()
_retry_counts: Dict[str, int] = {}


def with_retries(
    fn: Callable,
    site: str,
    attempts: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = TRANSIENT_ERRORS,
    sleep: Callable[[float], None] = time.sleep,
    max_elapsed: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
):
    """Run `fn` with bounded exponential backoff on transient errors.

    Every retry counts under `site` in retry_stats(). The last attempt's
    error propagates. `max_elapsed` (seconds) is a second budget on the
    clock: once it has passed, the next failure propagates even with
    attempts left."""
    delay = base_delay
    t0 = clock() if max_elapsed is not None else 0.0
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on:
            if attempt == attempts - 1:
                raise
            if max_elapsed is not None and clock() - t0 >= max_elapsed:
                raise
            with _retry_lock:
                _retry_counts[site] = _retry_counts.get(site, 0) + 1
            sleep(min(delay, max_delay))
            delay *= 2.0


def retry_stats() -> Dict[str, int]:
    """Per-site retry counts since process start (or the last reset)."""
    with _retry_lock:
        return dict(_retry_counts)


def total_retries() -> int:
    with _retry_lock:
        return sum(_retry_counts.values())


def reset_retry_stats() -> None:
    with _retry_lock:
        _retry_counts.clear()


class Backoff:
    """Backoff state for poll loops: fail() escalates and returns the next
    delay (not slept), reset() on success. `jitter` in (0, 1] pulls each
    delay down by up to that share of its headroom above `base`,
    deterministically per (seed, failure number) by the same crc32 the
    FaultPlane rates use; jitter=0 keeps the exact schedule."""

    def __init__(self, base: float = 0.1, factor: float = 2.0,
                 max_delay: float = 30.0, jitter: float = 0.0,
                 seed: int = 0):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.seed = seed
        self.failures = 0

    def fail(self) -> float:
        delay = min(self.base * (self.factor ** self.failures), self.max_delay)
        if self.jitter > 0.0:
            u = zlib.crc32(f"{self.seed}:{self.failures}".encode()) / 2**32
            delay -= self.jitter * u * (delay - self.base)
        self.failures += 1
        return delay

    def reset(self) -> None:
        self.failures = 0
