"""Micro-batching for the serving plane (port of r2d2_tpu/serve/batcher.py;
host code, the same batches from the same request stream).

Requests from independent sessions wait in a bounded queue; the serve loop
takes a batch as soon as `max_batch` requests wait or the oldest one it
took has waited `max_wait_s`, so an idle server answers a lone request at
the deadline and a loaded one forms full batches with no added wait.

A batch is padded to one of a few bucket sizes, so the serve step runs a
handful of shapes, each the same every time. The smallest bucket is 2: a
batch of one takes cuBLAS's matrix-vector path (XLA's, in the JAX
package), whose sums run in another order than the batched matmul's, while
every shape from 2 up keeps a row's result independent of the other rows,
which is what makes served answers equal the direct reference bit for bit
(server.reference_act at the same bucket).

A session appears at most once a batch: its carry is gathered when the
batch starts, so its second request must see the first one's new carry
and waits for the next batch (FIFO within the session).

The staging side of the pipeline lives here too (`BucketStaging`,
`StagedBatch`): per bucket, two preallocated host buffer sets that batch
assembly writes into, used in turn. The pipeline is at most two batches
deep (server.py's semaphore), so a set is staged again only after the
batch that used it has completed, and a copy to the device still reading
it never sees the next batch's rows.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np


class QueueFullError(RuntimeError):
    """The bounded request queue is full — the client should back off."""


@dataclasses.dataclass
class ServeRequest:
    session_id: str
    obs: np.ndarray
    reward: float
    reset: bool
    future: Future
    t_enqueue: float
    # per-request exploration override: None defers to the server's
    # ServeConfig.epsilon
    epsilon: Optional[float] = None
    # multi-task serving (cfg.num_tasks > 1): the session's task id
    # conditions the dueling head and bounds exploration draws to the
    # task's native actions. 0 is the single-task default.
    task: int = 0


@dataclasses.dataclass
class StagedBatch:
    """One batch staged into preallocated buffers, ready for the copy to the
    device and the serve step. All arrays are bucket-length views of a `BucketStaging`
    buffer set (except `explore`/`randoms`, which are freshly drawn on
    the exploring path to keep the RNG stream bit-exact) — the first `n`
    rows are real, the rest are pads."""

    requests: List["ServeRequest"]
    n: int
    bucket: int
    obs: np.ndarray        # (bucket, *obs_shape), request dtype
    rewards: np.ndarray    # (bucket,) f32
    reset_mask: np.ndarray  # (bucket,) bool — client reset | fresh | pad
    slots: np.ndarray      # (bucket,) i32 — cache rows; pads -> scratch
    task: Optional[np.ndarray]  # (bucket,) i32, or None (single-task)
    eps: np.ndarray        # (bucket,) f32 per-row exploration epsilon
    explore: np.ndarray    # (bucket,) bool
    randoms: np.ndarray    # (bucket,) int — random actions where exploring
    # the set's own host read-back buffers, by name (the server's q, actions
    # and tap rows): they live and die with the set, so a set reallocated
    # for a new geometry starts with none and nothing else holds the old
    host: dict = dataclasses.field(default_factory=dict)


class BucketStaging:
    """Preallocated per-bucket staging arrays for zero-copy batch assembly.

    Two buffer SETS per bucket, used alternately: with the serve pipeline
    bounded to depth 2, the set staged for batch k is not reused before
    batch k has completed, so in-flight H2D reads (which may alias these
    buffers on CPU backends) never observe the next batch's writes.

    `stage()` fills the request-derived rows with single vectorized
    buffer writes — no per-batch `np.stack`/`np.concatenate`/`fromiter`
    allocations once a bucket's buffers are warm. The caller (the serve
    loop) fills the cache/RNG-derived fields (slots, fresh-OR into the
    reset mask, epsilon overrides, exploration draws) into the same
    buffers. Single-threaded by contract: only the serve loop stages.
    """

    def __init__(self, buckets: Sequence[int], num_tasks: int = 1):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.num_tasks = int(num_tasks)
        self._sets: dict = {}   # (bucket, flip) -> buffer dict
        self._flip = {b: 0 for b in self.buckets}

    def warm(self, obs_shape: Sequence[int], dtype) -> None:
        """Preallocate both buffer sets of every bucket at the served obs
        geometry (PolicyServer.warmup), so live batches allocate nothing.
        Buffers already warm at this geometry are kept."""
        row = np.zeros(tuple(obs_shape), dtype)
        for bucket in self.buckets:
            for flip in (0, 1):
                key = (bucket, flip)
                bufs = self._sets.get(key)
                if (
                    bufs is None
                    or bufs["obs"].shape[1:] != row.shape
                    or bufs["obs"].dtype != row.dtype
                ):
                    self._sets[key] = self._alloc(bucket, row)

    def _alloc(self, bucket: int, row: np.ndarray) -> dict:
        return {
            "obs": np.zeros((bucket, *row.shape), row.dtype),
            "rewards": np.zeros(bucket, np.float32),
            "reset": np.zeros(bucket, bool),
            "slots": np.zeros(bucket, np.int32),
            "task": np.zeros(bucket, np.int32),
            "eps": np.zeros(bucket, np.float32),
            "explore": np.zeros(bucket, bool),
            "randoms": np.zeros(bucket, np.int64),
            "host": {},
        }

    def stage(self, requests: List["ServeRequest"], bucket: int,
              obs_rows: List[np.ndarray], default_eps: float) -> StagedBatch:
        """Assemble `requests` (whose obs rows arrive pre-padded to one
        common geometry) into the bucket's next buffer set. Pads zero the
        trailing rows (reset=True so the scratch row's garbage never
        compounds). Buffers are reallocated only when the obs
        shape/dtype changes (first batch, or a served-geometry change)."""
        n = len(requests)
        key = (bucket, self._flip[bucket])
        self._flip[bucket] ^= 1
        bufs = self._sets.get(key)
        row0 = obs_rows[0]
        if (
            bufs is None
            or bufs["obs"].shape[1:] != row0.shape
            or bufs["obs"].dtype != row0.dtype
        ):
            bufs = self._alloc(bucket, row0)
            self._sets[key] = bufs
        obs = bufs["obs"]
        np.stack(obs_rows, out=obs[:n])
        obs[n:] = 0
        rewards = bufs["rewards"]
        rewards[:n] = [r.reward for r in requests]
        rewards[n:] = 0.0
        reset = bufs["reset"]
        reset[:n] = [r.reset for r in requests]
        reset[n:] = True
        task = None
        if self.num_tasks > 1:
            task = bufs["task"]
            task[:n] = [r.task for r in requests]
            task[n:] = 0
        eps = bufs["eps"]
        eps[:] = default_eps
        explore = bufs["explore"]
        explore[:] = False
        randoms = bufs["randoms"]
        randoms[:] = 0
        return StagedBatch(
            requests=requests, n=n, bucket=bucket, obs=obs,
            rewards=rewards, reset_mask=reset, slots=bufs["slots"],
            task=task, eps=eps, explore=explore, randoms=randoms, host=bufs["host"],
        )


class MicroBatcher:
    def __init__(
        self,
        buckets: Sequence[int] = (2, 4, 8, 16, 32),
        max_wait_s: float = 0.002,
        queue_depth: int = 1024,
    ):
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 2:
            raise ValueError(
                "buckets must be >= 2: a batch of one takes the matrix-vector "
                "path and breaks bitwise parity with batched acting"
            )
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[ServeRequest]" = queue.Queue(maxsize=queue_depth)
        # same-session requests deferred out of a batch, FIFO per session
        self._deferred: "deque[ServeRequest]" = deque()
        self._lock = threading.Lock()
        # the degradation ladder's admission watermark (serve/degrade.py):
        # None admits up to the queue bound; an int sheds a submission once
        # the queue holds that many, while the shed allowance lasts (a
        # bounded shed: one decision cannot starve the queue). Written
        # under the lock, read without it (a watermark may be one late)
        self._admit_limit: Optional[int] = None
        self._shed_allowance = 0
        self._closed = False
        # the last submission's arrival (admitted or shed): the idle signal
        # the autoscaler's drain reads
        self.last_submit_t = time.monotonic()
        self.batches = 0
        self.requests = 0
        self.rejected = 0
        self.shed = 0  # rejections by the admission watermark
        self.deferrals = 0
        self.occupancy_sum = 0  # real rows summed over batches
        self.padded_sum = 0  # bucket rows summed over batches

    # ------------------------------------------------------------- enqueue

    def submit(
        self, session_id: str, obs: np.ndarray, reward: float = 0.0,
        reset: bool = False, epsilon: Optional[float] = None,
        task: int = 0,
    ) -> Future:
        """Enqueue one request; the returned Future resolves to the serve
        loop's ServeResult. A full queue fails the future immediately with
        QueueFullError instead of blocking the client thread."""
        fut: Future = Future()
        req = ServeRequest(
            session_id=session_id,
            obs=np.asarray(obs),
            reward=float(reward),
            reset=bool(reset),
            future=fut,
            t_enqueue=time.monotonic(),
            epsilon=None if epsilon is None else float(epsilon),
            task=int(task),
        )
        self.last_submit_t = time.monotonic()
        if self._closed:
            fut.set_exception(QueueFullError("serve queue closed (replica retired)"))
            return fut
        limit = self._admit_limit
        if limit is not None and self._q.qsize() >= limit:
            with self._lock:
                if self._shed_allowance > 0:
                    self._shed_allowance -= 1
                    self.shed += 1
                    self.rejected += 1
                    fut.set_exception(QueueFullError(
                        f"admission control: queue depth >= {limit} "
                        "(degrade-ladder shed)"))
                    return fut
                # the shed budget is spent: admit (the bounded shed)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._lock:
                self.rejected += 1
            fut.set_exception(
                QueueFullError(
                    f"serve queue full ({self._q.maxsize} requests pending)"
                )
            )
        return fut

    def qsize(self) -> int:
        return self._q.qsize() + len(self._deferred)

    def set_admission(self, limit: Optional[int], budget: int = 0) -> None:
        """Install (limit=None: clear) the ladder's admission watermark;
        `budget` re-arms the shed allowance, after which submissions are
        admitted again (the controller re-arms it every tick)."""
        with self._lock:
            self._admit_limit = None if limit is None else max(int(limit), 1)
            self._shed_allowance = max(int(budget), 0)

    def close(self) -> None:
        """Refuse every later submission with QueueFullError: a retired
        replica's queue fails fast instead of stranding futures no serve
        loop will resolve."""
        with self._lock:
            self._closed = True

    # -------------------------------------------------------------- batching

    def _take_deferred(self, batch: List[ServeRequest], seen: set) -> None:
        with self._lock:
            keep: "deque[ServeRequest]" = deque()
            while self._deferred and len(batch) < self.max_batch:
                req = self._deferred.popleft()
                if req.session_id in seen:
                    keep.append(req)
                else:
                    seen.add(req.session_id)
                    batch.append(req)
            keep.extend(self._deferred)
            self._deferred = keep

    def next_batch(self, timeout: float = 0.25) -> List[ServeRequest]:
        """Form one batch: block up to `timeout` for the first request
        (bounded, so a supervised serve loop heartbeats while idle), then
        fill until max_batch or the max_wait deadline. Returns [] on an
        idle interval."""
        batch: List[ServeRequest] = []
        seen: set = set()
        self._take_deferred(batch, seen)
        if not batch:
            try:
                first = self._q.get(timeout=timeout)
            except queue.Empty:
                return []
            seen.add(first.session_id)
            batch.append(first)
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                req = self._q.get(timeout=max(remaining, 0.0)) if remaining > 0 \
                    else self._q.get_nowait()
            except queue.Empty:
                break
            if req.session_id in seen:
                with self._lock:
                    self._deferred.append(req)
                    self.deferrals += 1
            else:
                seen.add(req.session_id)
                batch.append(req)
        # drain()/stats() run on the shutdown/metrics threads while the
        # serve loop is mid-batch: counters share the deferral lock
        with self._lock:
            self.batches += 1
            self.requests += len(batch)
            self.occupancy_sum += len(batch)
            self.padded_sum += self.bucket_for(len(batch))
        return batch

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n <= max_batch by construction)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def drain(self) -> List[ServeRequest]:
        """Remove and return everything still queued (server shutdown —
        the caller fails the futures)."""
        with self._lock:
            out: List[ServeRequest] = list(self._deferred)
            self._deferred.clear()
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def stats(self) -> dict:
        with self._lock:
            batches = max(self.batches, 1)
            return {
                "queue_depth": self.qsize(),
                "last_request_age_s": time.monotonic() - self.last_submit_t,
                "batches": self.batches,
                "requests": self.requests,
                "rejected": self.rejected,
                "shed": self.shed,
                "admit_limit": self._admit_limit,
                "deferrals": self.deferrals,
                "mean_batch_occupancy": self.occupancy_sum / batches,
                # real rows / padded rows: how much of the compiled shapes
                # the traffic actually fills
                "bucket_fill": self.occupancy_sum / max(self.padded_sum, 1),
            }
