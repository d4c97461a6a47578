"""The live loop (port of r2d2_tpu/liveloop/): serve -> replay -> learn ->
publish. A TransitionTap and an IngestBridge turn served traffic into
replay blocks, a LiveLoopTrainer trains against that store, and the
serving fleet's checkpoint watcher hot-reloads what it wrote."""

from r2d2_tpu_torch.liveloop.bridge import IngestBridge
from r2d2_tpu_torch.liveloop.explore import EpsilonAssigner
from r2d2_tpu_torch.liveloop.loop import LiveLoopPlane
from r2d2_tpu_torch.liveloop.tap import BatchRecord, TransitionTap, gather_carry_rows
from r2d2_tpu_torch.liveloop.trainer import LiveLoopTrainer

__all__ = [
    "BatchRecord",
    "EpsilonAssigner",
    "IngestBridge",
    "LiveLoopPlane",
    "LiveLoopTrainer",
    "TransitionTap",
    "gather_carry_rows",
]
