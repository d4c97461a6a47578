"""Worker supervision: heartbeats, crash restart, stall detection (port of
r2d2_tpu/utils/supervision.py; the library carries no JAX, and the port
keeps its own copy).

Every host-side worker loop of threaded training runs under a Supervisor:

- each loop iteration stamps a heartbeat; a worker whose heartbeat goes
  stale past `heartbeat_timeout` is reported as stalled (Python threads
  cannot be preempted, so stalls are surfaced, not killed); a stall
  beyond `stall_fatal_timeout` escalates to WorkerStalledError, so a
  thread wedged inside a device call fails the run loudly instead of
  letting it limp on;
- a worker that raises has its traceback printed and recorded, its
  `on_restart` recovery hook run (VectorizedActor.resync discards the
  in-flight state a mid-step fault may have left inconsistent), and its
  loop re-entered, up to `max_restarts` times. Past the limit, or if the
  recovery hook itself fails, the worker is fatal and `check()` raises
  WorkerFatalError in the learner loop;
- restart and stall counts flow into the metrics records.

Bodies should do a bounded amount of work per call (one actor step, one
queue-put attempt) so heartbeats stay fresh while blocked resources (a
full queue, a learner building its kernels) are retried across calls.
The preemption exit (SIGTERM, a checkpoint at the cut) is queued with M9.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

# process exit code of the main-thread watchdog: distinct from crashes (1)
# and signals (>128), so an external supervisor can map it to "wedged
# runtime: restart with --resume"
STALL_EXIT_CODE = 86


class SupervisedWorker:
    """One host worker loop: `body()` is called repeatedly until stop."""

    def __init__(
        self,
        name: str,
        body: Callable[[], None],
        stop: threading.Event,
        max_restarts: int = 3,
        on_restart: Optional[Callable[[], None]] = None,
        error_history: int = 5,
    ):
        self.name = name
        self.body = body
        self.stop = stop
        self.max_restarts = max_restarts
        self.on_restart = on_restart
        self.restarts = 0
        self.last_beat = time.monotonic()
        self.errors: List[str] = []  # most recent `error_history` tracebacks
        self._error_history = error_history
        self.fatal = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def last_error(self) -> Optional[str]:
        return self.errors[-1] if self.errors else None

    def _record_error(self, context: str) -> None:
        tb = traceback.format_exc()
        with self._lock:
            self.errors.append(tb)
            del self.errors[: -self._error_history]
        print(f"[supervisor] worker {self.name!r} {context}:\n{tb}", file=sys.stderr)

    def _loop(self) -> None:
        while not self.stop.is_set():
            self.last_beat = time.monotonic()
            try:
                self.body()
            except BaseException:
                exhausted = self.restarts >= self.max_restarts
                self._record_error(
                    f"crashed (restart budget exhausted, {self.restarts}/{self.max_restarts})"
                    if exhausted
                    else f"crashed (restart {self.restarts + 1}/{self.max_restarts})"
                )
                if exhausted:
                    self.fatal = True
                    return
                self.restarts += 1
                if self.on_restart is not None:
                    try:
                        self.on_restart()
                    except BaseException:
                        self._record_error("recovery hook failed; going fatal")
                        self.fatal = True
                        return

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"supervised-{self.name}", daemon=True
        )
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stalled_for(self) -> float:
        return time.monotonic() - self.last_beat


class WorkerFatalError(RuntimeError):
    pass


class WorkerStalledError(WorkerFatalError):
    """A worker thread is WEDGED (e.g. inside a device call that never
    returns). Distinct from a plain fatal crash because the device must be
    presumed unusable: exit paths should skip any cleanup that would block
    on device work.

    Carries `.supervisor` (set by Supervisor.check) so a catcher at ANY
    layer can reach the still-armed watchdog: CLIs call exit_for_stall(e);
    a library caller keeping the process alive calls e.supervisor.disarm().
    """

    supervisor: "Optional[Supervisor]" = None


def exit_for_stall(e: WorkerStalledError) -> None:
    """The CLI exit contract for a wedged runtime, in one place: print the
    error and os._exit(STALL_EXIT_CODE), skipping atexit hooks, whose
    device teardown would block on the same wedged device, so an external
    supervisor maps the code to 'restart with --resume'."""
    print(e, file=sys.stderr, flush=True)
    os._exit(STALL_EXIT_CODE)


class Supervisor:
    def __init__(
        self,
        heartbeat_timeout: float = 120.0,
        stall_fatal_timeout: float = 900.0,
        main_stall_headroom: float = 120.0,
    ):
        """stall_fatal_timeout: a worker stalled this long (stuck thread —
        unkillable from Python) fails the run via check(); 0 disables.

        main_stall_headroom: extra slack added to the MAIN-thread watchdog
        threshold on top of stall_fatal_timeout: one main-loop beat
        interval legitimately spans a whole kernel build or checkpoint
        write, which a worker heartbeat never does."""
        self.heartbeat_timeout = heartbeat_timeout
        self.stall_fatal_timeout = stall_fatal_timeout
        self.main_stall_headroom = main_stall_headroom
        self.workers: List[SupervisedWorker] = []
        self.stop = threading.Event()
        self._stall_reported: Dict[str, bool] = {}
        self._main_beat = time.monotonic()

    # --- main-thread watchdog -------------------------------------------
    #
    # check() escalates WORKER stalls, but it only runs from the main
    # loop, which can itself wedge inside a device call. The watchdog is a tiny daemon thread that hard-exits
    # the process (os._exit, STALL_EXIT_CODE) when the main loop stops
    # stamping main_beat() for stall_fatal_timeout: the wedged thread
    # cannot be interrupted from Python, so a clean unwind is impossible
    # by construction, and a loud fast death (restart with --resume) beats
    # a run that silently hangs forever. Stopped by shutdown()/stop.

    def main_beat(self) -> None:
        self._main_beat = time.monotonic()

    def disarm(self) -> None:
        """Public disarm for the main-thread watchdog. A WorkerStalledError
        unwind leaves the watchdog armed on purpose (to hard-exit a hang in
        atexit teardown); a library caller that catches the error and
        intends to keep the process alive MUST call this (via
        Trainer.disarm_watchdog) — otherwise the watchdog will os._exit
        the process once the timeout elapses."""
        self.stop.set()

    @contextlib.contextmanager
    def armed_watchdog(self):
        """Arm the main-thread watchdog for the enclosed block and disarm
        it on every exit EXCEPT a WorkerStalledError unwind — there the
        backend is presumed wedged and the watchdog must stay armed to
        hard-exit a hang in interpreter-shutdown atexit hooks. The single
        place that owns the arm/disarm lifecycle: run modes wrap their
        warmup, loop and cleanup in this so an exception anywhere inside
        (warmup saturation, a crashed worker, KeyboardInterrupt) cannot
        leak an armed watchdog into a caller that catches it and lives on."""
        self.start_main_watchdog()
        try:
            yield self
        except WorkerStalledError:
            raise
        except BaseException:
            self.stop.set()
            raise
        else:
            self.stop.set()

    def start_main_watchdog(self) -> None:
        if self.stall_fatal_timeout <= 0:
            return
        self._main_beat = time.monotonic()
        threading.Thread(
            target=self._watchdog_loop, name="supervisor-watchdog", daemon=True
        ).start()

    def _watchdog_loop(self) -> None:
        limit = self.stall_fatal_timeout + self.main_stall_headroom
        poll = min(1.0, limit / 4)
        while not self.stop.wait(poll):
            stale = time.monotonic() - self._main_beat
            if stale > limit:
                print(
                    f"[supervisor] MAIN thread stalled for {stale:.0f}s "
                    f"(> {limit:.0f}s), wedged inside a device call; "
                    f"hard-exiting (code {STALL_EXIT_CODE}). Restart with "
                    "--resume.",
                    file=sys.stderr,
                    flush=True,
                )
                os._exit(STALL_EXIT_CODE)

    def spawn(
        self,
        name: str,
        body: Callable[[], None],
        max_restarts: int = 3,
        on_restart: Optional[Callable[[], None]] = None,
    ) -> SupervisedWorker:
        w = SupervisedWorker(
            name, body, self.stop, max_restarts=max_restarts, on_restart=on_restart
        )
        self.workers.append(w)
        w.start()
        return w

    def check(self) -> Dict[str, int]:
        """Raise WorkerFatalError if any worker died for good; return
        restart/stall counters for the metrics stream."""
        restarts = 0
        stalls = 0
        for w in self.workers:
            if w.fatal:
                self.stop.set()
                raise WorkerFatalError(
                    f"worker {w.name!r} died ({w.restarts} restarts used); "
                    f"last error:\n{w.last_error}"
                )
            restarts += w.restarts
            stalled = w.stalled_for()
            if (
                not self.stop.is_set()
                and self.stall_fatal_timeout > 0
                and stalled > self.stall_fatal_timeout
            ):
                # deliberately does NOT set self.stop: the main-thread
                # watchdog must stay armed through the exception unwind;
                # interpreter-shutdown atexit hooks (device teardown) can
                # block on the same wedged device, and the watchdog is then
                # the only thing left that can kill the process
                err = WorkerStalledError(
                    f"worker {w.name!r} stalled for {stalled:.0f}s "
                    f"(> stall_fatal_timeout={self.stall_fatal_timeout:.0f}s) "
                    "- likely wedged inside a device call; the thread "
                    "cannot be recovered in-process. Restart the run "
                    "with --resume."
                )
                err.supervisor = self
                raise err
            if not self.stop.is_set() and stalled > self.heartbeat_timeout:
                stalls += 1
                if not self._stall_reported.get(w.name):
                    self._stall_reported[w.name] = True
                    print(
                        f"[supervisor] worker {w.name!r} heartbeat stale for "
                        f"{w.stalled_for():.0f}s",
                        file=sys.stderr,
                    )
            else:
                self._stall_reported[w.name] = False
        return {"worker_restarts": restarts, "worker_stalls": stalls}

    def shutdown(self, timeout: float = 5.0) -> None:
        self.stop.set()
        for w in self.workers:
            w.join(timeout)
