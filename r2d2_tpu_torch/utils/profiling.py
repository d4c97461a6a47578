"""Tracing and profiling hooks (port of r2d2_tpu/utils/profiling.py).

- `trace_to(dir)` records a bounded torch.profiler trace (host and, on a
  machine with a card, device activity) and exports it as a Chrome trace
  (`--profile-dir` on the trainer CLI traces the updates after the first).
- `span(name)` / `step_span(name, step)` annotate host phases (replay
  sample, learner update) so they line up against device activity in the
  trace: a `torch.profiler.record_function` while a trace runs, and an
  NVTX range on a machine with a card (a no-op unless a tool such as Nsight
  Systems listens). With no trace running a span costs its context enter
  and exit and, with a card, one NVTX push and pop, so the hot paths keep
  them.
- `TransferTimer` accounts host->device staging: how much of the copy time
  is hidden behind update compute, without a trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

import torch

_nvtx: Optional[bool] = None  # whether NVTX ranges are pushed (a card is present)


def _use_nvtx() -> bool:
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    return _nvtx


class TransferTimer:
    """Host->device staging overlap accountant.

    Two accumulators, fed from different threads:
    - `h2d(nbytes)` spans wrap the staging side of a batch (host gather into
      pinned buffers and the copies' issue), on the staging thread, off the
      critical path.
    - `wait()` spans wrap the consumer side: the time the update loop spent
      waiting for a staged batch (the queue, then its stream's wait on the
      copy's event).

    overlap_fraction = 1 - wait/h2d, clamped to [0, 1]: 1.0 means the
    consumer never waited, 0.0 that staging ran serialized ahead of the
    updates. Thread-safe; `reset()` rebases the window so a measurement can
    leave out the first batches."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.h2d_seconds = 0.0
            self.wait_seconds = 0.0
            self.bytes_staged = 0
            self.chunks = 0

    @contextlib.contextmanager
    def h2d(self, nbytes: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.h2d_seconds += dt
                self.bytes_staged += nbytes
                self.chunks += 1

    @contextlib.contextmanager
    def wait(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.wait_seconds += dt

    def overlap_fraction(self) -> float:
        with self._lock:
            return self._fraction(self.h2d_seconds, self.wait_seconds)

    @staticmethod
    def _fraction(h2d: float, wait: float) -> float:
        return 1.0 if h2d <= 0.0 else max(0.0, min(1.0, 1.0 - wait / h2d))

    def stats(self) -> dict:
        """One flat dict for the metrics records."""
        with self._lock:
            h2d, wait = self.h2d_seconds, self.wait_seconds
            chunks, staged = self.chunks, self.bytes_staged
        return {
            "h2d_overlap_fraction": round(self._fraction(h2d, wait), 4),
            "h2d_seconds": round(h2d, 4),
            "h2d_wait_seconds": round(wait, 4),
            "h2d_chunks": chunks,
            "h2d_gbytes_staged": round(staged / 1e9, 3),
        }


def start_trace():
    """A started torch.profiler.profile over the host (every thread, where
    this torch can: the sampler's and actor's spans run on their own) and,
    with a card, the device; stop it with `stop_trace`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option traces the starting thread
        config = None
    prof = profile(activities=acts, experimental_config=config)
    prof.__enter__()
    return prof


def stop_trace(prof, log_dir: str, name: str = "trace") -> str:
    """Stop a trace from `start_trace` and export it as a Chrome trace
    `{log_dir}/{name}.json`. -> its path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[None]:
    """Record a trace into `log_dir` for the duration of the context; None
    disables it (no cost)."""
    if not log_dir:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


class span:
    """Named host-span annotation visible in the trace."""

    __slots__ = ("name", "args", "_rf")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name = name
        self.args = args
        self._rf = None

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name, self.args)
            self._rf.__enter__()
        if _use_nvtx():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if _use_nvtx():
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False


def step_span(name: str, step: int) -> span:
    """Step-correlated span: the work of learner update `step`, under one
    name (the step rides in the record's arguments)."""
    return span(name, f"step={step}")
