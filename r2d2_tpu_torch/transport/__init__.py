"""The block-stream transport (port of r2d2_tpu/transport/): serve hosts
stream finished blocks to a learner in another process, and the learner
broadcasts checkpoints back on the same sockets.

- `framing`: length-prefixed CRC frames, the versioned handshake, the BLOCK
  and CKPT codecs (the JAX package's wire, byte for byte)
- `BlockStreamPublisher`: the serve side; spools finished blocks, streams
  them at least once with resume on reconnect, applies checkpoints
- `IngestService`: the learner side; N host connections, sequence dedup,
  skew and lag stamps, replay fan-in, the checkpoint broadcast
- `podloop`: the two process bodies (`--role serve|learner`)
"""

from r2d2_tpu_torch.transport import framing
from r2d2_tpu_torch.transport.ingest import IngestService
from r2d2_tpu_torch.transport.publisher import BlockStreamPublisher

__all__ = ["framing", "BlockStreamPublisher", "IngestService"]
