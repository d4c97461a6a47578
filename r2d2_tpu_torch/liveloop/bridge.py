"""IngestBridge: a bounded hand-off from the tap's finished blocks to
replay (port of r2d2_tpu/liveloop/bridge.py; host code).

The tap emits (block, priorities, episode_reward) triples on the
liveloop-tap thread, and replay's add path takes the store lock the
learner's sampling takes too. `offer` is a locked append to a bounded
deque (drop-oldest, counted), so producing blocks never waits on replay,
and the supervised "liveloop-ingest" thread drains the deque into the
store: in one `add_blocks_batch` call (one lock acquisition) when the
store has it, else block by block through `add_block`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from r2d2_tpu_torch.utils.faults import with_retries


class IngestBridge:
    def __init__(self, replay, depth: int = 64):
        self.replay = replay
        self.depth = int(depth)
        self._lock = threading.Lock()
        self._q: deque = deque()
        self._wake = threading.Event()
        # counters guarded by _lock
        self.offered_blocks = 0
        self.dropped_blocks = 0
        self.ingested_blocks = 0
        # drop visibility at DRAIN granularity: how many offers were shed
        # since the previous drain_once (the backpressure signal a metrics
        # row can alarm on — a nonzero value means the ingest thread is
        # not keeping up RIGHT NOW, where the cumulative counter can't
        # distinguish an old burst from an ongoing one)
        self.dropped_last_drain = 0
        self._dropped_at_drain = 0

    def offer(self, block, priorities, episode_reward: Optional[float]) -> None:
        """Enqueue one finished block; sheds the OLDEST queued block when
        full (fresh experience beats stale under backpressure)."""
        with self._lock:
            self.offered_blocks += 1
            if len(self._q) >= self.depth:
                self._q.popleft()
                self.dropped_blocks += 1
            self._q.append((block, priorities, episode_reward))
        self._wake.set()

    def drain_once(self, timeout: float = 0.0) -> int:
        """Move every queued block into the replay plane; returns blocks
        ingested. The ingest thread body calls this with a small timeout;
        tests and the stop path call it with timeout=0."""
        if timeout > 0.0 and not self._wake.wait(timeout):
            return 0
        with self._lock:
            items = list(self._q)
            self._q.clear()
            self._wake.clear()
            self.dropped_last_drain = self.dropped_blocks - self._dropped_at_drain
            self._dropped_at_drain = self.dropped_blocks
        if not items:
            return 0

        def push():
            add_batch = getattr(self.replay, "add_blocks_batch", None)
            if add_batch is not None:
                add_batch(items)
            else:
                for block, priorities, episode_reward in items:
                    self.replay.add_block(block, priorities, episode_reward)

        # a flaky add re-pushes the same already-drained items: retries
        # never touch the tap or the queue, so nothing is double-counted
        with_retries(push, "liveloop.ingest")
        with self._lock:
            self.ingested_blocks += len(items)
        return len(items)

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    def stats(self) -> dict:
        with self._lock:
            return {
                "bridge_offered_blocks": self.offered_blocks,
                "bridge_dropped_blocks": self.dropped_blocks,
                "bridge_dropped_last_drain": self.dropped_last_drain,
                "bridge_ingested_blocks": self.ingested_blocks,
                "bridge_queue_depth": len(self._q),
            }
