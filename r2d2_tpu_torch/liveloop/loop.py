"""LiveLoopPlane: the tap, the bridge and the epsilon assigner wired onto a
running server (port of r2d2_tpu/liveloop/loop.py).

One coordinator owns the live loop's threads and installs its hooks on a
serve stack: one `PolicyServer`, or every replica of a
`MultiDeviceServer` (one tap and one assigner for all of them: affinity
keeps a session's records on one replica's serve loop, and replicas only
append to the tap's locked queue). Two supervised workers:

    liveloop-tap     drains batch records into the per-session
                     accumulators (fault site "liveloop.tap")
    liveloop-ingest  drains finished blocks into replay (fault site
                     "liveloop.ingest")

With `liveloop` off nothing of this is built and the serve and train
paths are unchanged.
"""

from __future__ import annotations

from typing import List, Optional

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.liveloop.bridge import IngestBridge
from r2d2_tpu_torch.liveloop.explore import EpsilonAssigner
from r2d2_tpu_torch.liveloop.tap import TransitionTap
from r2d2_tpu_torch.utils.faults import fault_point
from r2d2_tpu_torch.utils.supervision import Supervisor


class LiveLoopPlane:
    def __init__(self, cfg: R2D2Config, server, replay, seed: int = 0):
        self.cfg = cfg
        self.tap = TransitionTap(cfg, depth=cfg.liveloop_tap_depth)
        self.bridge = IngestBridge(replay, depth=cfg.liveloop_queue_depth)
        self.tap.set_emit(self.bridge.offer)
        self.assigner = EpsilonAssigner(cfg, seed=seed)
        self.supervisor: Optional[Supervisor] = None
        # install the capture hooks on every serve loop in the stack
        self._servers: List = list(getattr(server, "replicas", None) or [server])
        for s in self._servers:
            s.tap = self.tap
            s.eps_assigner = self.assigner

    # --------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.supervisor = Supervisor()
        self.supervisor.spawn("liveloop-tap", self._tap_iteration)
        self.supervisor.spawn("liveloop-ingest", self._ingest_iteration)

    def _tap_iteration(self) -> None:
        # chaos drill: an "error" here exercises supervised restart; the
        # record queue is the crash boundary (un-drained records survive)
        fault_point("liveloop.tap")
        self.tap.process_pending(timeout=0.25)

    def _ingest_iteration(self) -> None:
        fault_point("liveloop.ingest")
        self.bridge.drain_once(timeout=0.25)

    def stop(self) -> None:
        """Detach the hooks, stop the workers, then run the final drains
        inline: queued records are accumulated, in-flight partial blocks
        are cut (bootstrapped from their pending Q), and everything
        emitted lands in replay before this returns."""
        for s in self._servers:
            s.tap = None
            s.eps_assigner = None
        if self.supervisor is not None:
            self.supervisor.stop.set()
            for w in self.supervisor.workers:
                w.join(timeout=5.0)
            self.supervisor = None
        self.tap.process_pending(timeout=0.0)
        self.tap.flush()
        self.bridge.drain_once(timeout=0.0)

    def check(self) -> dict:
        """Surface worker restart/stall counters (raises if a liveloop
        worker died for good — same loud-failure contract as the learner)."""
        return self.supervisor.check() if self.supervisor is not None else {}

    def stats(self) -> dict:
        out = {}
        out.update(self.tap.stats())
        out.update(self.bridge.stats())
        out.update(self.assigner.stats())
        return out
