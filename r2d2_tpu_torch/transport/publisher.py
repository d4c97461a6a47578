"""BlockStreamPublisher: the serve host's end of the pod-loop stream (port
of r2d2_tpu/transport/publisher.py; host code).

The publisher has the replay-sink surface the live loop's bridge drains
into (`add_blocks_batch`, `add_block`), so a serve process moves from the
one-process live loop to the pod loop by passing it as
`LiveLoopPlane(cfg, server, replay=publisher)`: the tap, the bridge and
their fault sites stay as they are, and only the last hop changes from
"write the local replay store" to "spool and stream to the learner".

Delivery (an at-least-once spool, an exactly-once effect):

- every offered block takes the host's next sequence number and is
  spooled before it may be sent (`transport.spool`; on disk under
  `transport_spool_dir`, so a SIGKILLed host resumes its numbering and its
  unacked tail from disk: the numbering past the entries still there and
  past the `hwm` file, the highest number an ack pruned, which the JAX
  package's publisher does not keep);
- the spool is bounded (`transport_spool_depth`): when full, the OLDEST
  unacked block is shed and counted; the ingest side tolerates the gap;
- a supervised worker, "transport-publish", owns the socket: it connects
  (`transport.connect`, two attempts under `with_retries` with a
  `max_elapsed` below the supervision heartbeat, then a jittered backoff),
  sends HELLO and learns from HELLO_ACK the highest sequence number the
  learner holds, and sends only past it: a reconnect delivers no
  duplicate;
- acks prune the spool; a torn connection (TRANSIENT_ERRORS out of
  `transport.send` or `transport.recv`) marks the stream disconnected and
  the next pass reconnects: the restart budget is kept for real faults;
- CKPT frames on the same socket (the learner's hot-reload broadcast) are
  decoded and handed to `on_checkpoint(leaves, step, version)` on the
  worker thread.

One writer: only the worker touches the socket. The producer (the bridge's
ingest worker) and the worker share the spool and the counters under one
lock, and no call that blocks runs under it.
"""

from __future__ import annotations

import os
import select
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay import codec as blockcodec
from r2d2_tpu_torch.transport import framing
from r2d2_tpu_torch.utils.faults import TRANSIENT_ERRORS, Backoff, fault_point, with_retries
from r2d2_tpu_torch.utils.supervision import Supervisor

# blocks sent per worker pass: one body call's work stays bounded (the
# supervision contract) and bursts still drain fast
SEND_BATCH = 64

# The on-disk spool entry, v1: header + BLOCK payload.
#
#     magic    4 bytes  b"R2SP"
#     version  1 byte   spool format version (1)
#     codec    1 byte   index into replay/codec.CODECS the payload was
#                       written under
#     obs_crc  4 bytes  crc32 of the DECODED obs bytes: an entry this
#                       binary's codec would misdecode fails on load and is
#                       dropped, where it would otherwise enter replay
#     length   4 bytes  payload byte count
#
# A file without the magic is either an older spool (a bare npz starting
# b"PK", still a valid payload: adopted and counted legacy) or damage
# (dropped and counted).
SPOOL_MAGIC = b"R2SP"
SPOOL_VERSION = 1
SPOOL_HEADER = struct.Struct(">4sBBII")
# The highest sequence number an ack pruned from the spool directory, as
# text, written before the pruned files go: once every block is acked the
# directory holds no entry, and a relaunched host must still number past
# them (the learner's mark would drop a reused number as held).
SPOOL_HWM = "hwm"


class BlockStreamPublisher:
    def __init__(
        self,
        cfg: R2D2Config,
        address: Tuple[str, int],
        host_id: str,
        audit_source: Optional[Callable[[], Optional[dict]]] = None,
        on_checkpoint: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.address = address
        self.host_id = host_id
        # called on the producer thread right after a block is offered: the
        # tap's newest audit-tail entry, which by the tap's emit order is
        # this block's (epsilon, params_version) stamps; None: no tap
        self.audit_source = audit_source
        self.on_checkpoint = on_checkpoint
        self._lock = threading.Lock()
        # (seq, payload) awaiting an ack, oldest first
        self._spool: Deque[Tuple[int, bytes]] = deque()
        self._next_seq = 1
        self._sent_up_to = 0  # highest seq sent on this connection
        self._acked = 0       # highest seq the service acknowledged
        self._sock: Optional[socket.socket] = None
        self._last_send = 0.0
        self._backoff = Backoff(base=0.05, factor=2.0, max_delay=2.0, jitter=0.5, seed=seed)
        self.supervisor: Optional[Supervisor] = None
        # the codec agreed with the current peer (worker thread only)
        self._wire_codec = "none"
        # counters, under _lock
        self.spooled_blocks = 0
        self.sent_blocks = 0
        self.acked_blocks = 0
        self.spool_dropped = 0
        self.reconnects = 0
        self.connect_failures = 0
        self.ckpts_applied = 0
        self.bytes_pre_codec = 0   # the spooled payloads as they would be raw
        self.bytes_post_codec = 0  # the spooled payloads as encoded
        self.bytes_on_wire = 0     # frame bytes sent (after any transcode)
        self.spool_legacy = 0           # headerless spool files adopted
        self.spool_corrupt_dropped = 0  # spool files failing the header checks
        self._spool_path = None
        if cfg.transport_spool_dir:
            self._spool_path = os.path.join(cfg.transport_spool_dir, host_id)
            os.makedirs(self._spool_path, exist_ok=True)
            entries, self._next_seq = self._load_spool()
            self._spool.extend(entries)

    # ------------------------------------------------------------ spool disk

    def _parse_spool_entry(self, raw: bytes) -> Optional[bytes]:
        """One spool file -> its BLOCK payload, or None when it must be
        dropped: a v1 entry checked against its decoded-obs CRC, a legacy
        bare npz adopted, anything else damage."""
        if raw[:4] == SPOOL_MAGIC:
            try:
                _, version, codec_id, crc, length = SPOOL_HEADER.unpack_from(raw)
            except struct.error:
                return None
            payload = raw[SPOOL_HEADER.size:]
            if (version != SPOOL_VERSION or codec_id >= len(blockcodec.CODECS)
                    or len(payload) != length):
                return None
            try:
                return payload if framing.obs_crc(payload) == crc else None
            except framing.FrameError:
                return None
        if raw[:2] == b"PK":
            self.spool_legacy += 1
            return raw
        return None

    def _load_spool(self) -> Tuple[List[Tuple[int, bytes]], int]:
        """Crash resume: the unacked tail, in sequence order, and the next
        number to issue, past everything ever spooled here. Entries failing the v1 checks are dropped,
        unlinked and counted: a dropped block is a gap the ingest side
        tolerates, a misdecoded one would corrupt replay."""
        entries = []
        # over every file, the dropped ones too: a dropped entry's number
        # is never issued again (the ingest mark would discard it)
        max_seq = 0
        # names are zero-padded numbers: sorted is sequence order
        for name in sorted(os.listdir(self._spool_path)):
            if not name.endswith(".blk"):
                continue
            seq = int(name[:-4])
            max_seq = max(max_seq, seq)
            path = os.path.join(self._spool_path, name)
            with open(path, "rb") as f:
                payload = self._parse_spool_entry(f.read())
            if payload is None:
                self.spool_corrupt_dropped += 1
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            entries.append((seq, payload))
        try:
            with open(os.path.join(self._spool_path, SPOOL_HWM)) as f:
                max_seq = max(max_seq, int(f.read()))
        except (OSError, ValueError):
            pass  # no ack pruned here yet (or an older spool)
        return sorted(entries), max_seq + 1

    def _spool_file(self, seq: int) -> str:
        return os.path.join(self._spool_path, f"{seq:012d}.blk")

    # --------------------------------------------------------- replay surface

    def add_block(self, block, priorities, episode_reward) -> None:
        """The bridge's per-block sink: number, encode, persist, enqueue.
        Never waits on the network: the worker streams the spool."""
        audit = self.audit_source() if self.audit_source is not None else None
        eps = audit.get("epsilon") if audit else None
        ver = audit.get("params_version") if audit else None
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        cstats: dict = {}
        payload = framing.encode_block(
            block, priorities, episode_reward, seq=seq, t_serve=time.time(),
            eps_stamps=eps, ver_stamps=ver, codec=self.cfg.block_codec, stats_out=cstats)
        fault_point("transport.spool")
        if self._spool_path is not None:
            # persist, then enqueue: a crash between the two sends a spooled
            # block again (at least once) and never leaves a gap
            crc = zlib.crc32(np.ascontiguousarray(block.obs).tobytes())
            header = SPOOL_HEADER.pack(SPOOL_MAGIC, SPOOL_VERSION,
                                       blockcodec.CODECS.index(self.cfg.block_codec),
                                       crc, len(payload))
            tmp = self._spool_file(seq) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(header + payload)
            os.replace(tmp, self._spool_file(seq))
        shed = None
        with self._lock:
            if len(self._spool) >= self.cfg.transport_spool_depth:
                shed, _ = self._spool.popleft()
                self.spool_dropped += 1
            self._spool.append((seq, payload))
            self.spooled_blocks += 1
            # only the obs entry differs between the raw and coded payloads
            self.bytes_post_codec += len(payload)
            self.bytes_pre_codec += (len(payload) - cstats["obs_enc_bytes"]
                                     + cstats["obs_raw_bytes"])
        if shed is not None:
            self._drop_spool_file(shed)

    def add_blocks_batch(self, items) -> None:
        for block, priorities, episode_reward in items:
            self.add_block(block, priorities, episode_reward)

    def _drop_spool_file(self, seq: int) -> None:
        if self._spool_path is None:
            return
        try:
            os.unlink(self._spool_file(seq))
        except OSError:
            pass  # pruned already, or the directory is gone at teardown

    # ------------------------------------------------------------- connection

    def _connect_once(self) -> socket.socket:
        fault_point("transport.connect")
        timeout = self.cfg.transport_connect_timeout_s
        sock = socket.create_connection(self.address, timeout=timeout)
        try:
            sock.settimeout(timeout)
            with self._lock:
                next_seq = self._next_seq
            framing.send_frame(sock, framing.HELLO, framing.encode_json({
                "proto": framing.PROTO_VERSION, "host": self.host_id,
                "next_seq": next_seq, "codec": self.cfg.block_codec,
            }))
            ftype, payload = framing.recv_frame(sock)
            if ftype != framing.HELLO_ACK:
                raise framing.FrameError(f"expected HELLO_ACK, got frame type {ftype}")
            hello = framing.decode_json(payload)
            if hello.get("proto") != framing.PROTO_VERSION:
                raise framing.FrameError(
                    f"protocol version mismatch: peer speaks {hello.get('proto')}, we speak "
                    f"{framing.PROTO_VERSION}")
            last_seq = int(hello.get("last_seq", 0))
            # a service that omits the codec is read as "none": spooled
            # payloads are then transcoded raw at send time
            self._wire_codec = str(hello.get("codec", "none"))
        except BaseException:
            sock.close()
            raise
        self._on_ack(last_seq, resume=True)
        return sock

    def _on_ack(self, seq: int, resume: bool = False) -> None:
        """Prune the spool through `seq`; on a handshake (`resume`) also
        send from just past it: the learner holds everything up to it."""
        dropped: List[int] = []
        with self._lock:
            while self._spool and self._spool[0][0] <= seq:
                dropped.append(self._spool.popleft()[0])
            self._acked = max(self._acked, seq)
            if resume:
                self._sent_up_to = seq
            self.acked_blocks += len(dropped)
        if dropped and self._spool_path is not None:
            tmp = os.path.join(self._spool_path, SPOOL_HWM + ".tmp")
            with open(tmp, "w") as f:
                f.write(str(max(dropped)))
            os.replace(tmp, os.path.join(self._spool_path, SPOOL_HWM))
        for s in dropped:
            self._drop_spool_file(s)

    def connected(self) -> bool:
        return self._sock is not None

    def _disconnect(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # ---------------------------------------------------------------- pumping

    def pump(self, timeout: float = 0.25) -> None:
        """One bounded unit of work: make sure of a connection, drain the
        inbound control frames, send the unsent spool tail, prove liveness.
        The supervised worker's body; tests and the stop path's flush call
        it directly."""
        if self._sock is None:
            try:
                # two quick attempts a pass, bounded on the clock so a
                # black-holed connect never starves the heartbeat; across
                # passes the jittered Backoff escalates
                sock = with_retries(self._connect_once, "transport.connect", attempts=2,
                                    base_delay=0.05,
                                    max_elapsed=2 * self.cfg.transport_connect_timeout_s)
            except TRANSIENT_ERRORS:
                with self._lock:
                    self.connect_failures += 1
                wait = self._backoff.fail()
                if self.supervisor is not None:
                    self.supervisor.stop.wait(wait)
                else:
                    time.sleep(wait)
                return
            self._backoff.reset()
            with self._lock:
                self._sock = sock
                self.reconnects += 1
                self._last_send = time.monotonic()
        try:
            self._drain_inbound(timeout)
            self._send_tail()
            self._maybe_heartbeat()
        except TRANSIENT_ERRORS:
            # a torn stream (real, or injected at transport.send/recv): the
            # next pass reconnects and the handshake resumes the sequence
            self._disconnect()

    def _drain_inbound(self, timeout: float) -> None:
        while True:
            ready, _, _ = select.select([self._sock], [], [], timeout)
            if not ready:
                return
            timeout = 0.0  # only the first wait blocks; then drain dry
            fault_point("transport.recv")
            ftype, payload = framing.recv_frame(self._sock)
            if ftype == framing.ACK:
                self._on_ack(int(framing.decode_json(payload)["seq"]))
            elif ftype == framing.CKPT:
                leaves, step, version = framing.decode_ckpt(payload)
                with self._lock:
                    self.ckpts_applied += 1
                if self.on_checkpoint is not None:
                    self.on_checkpoint(leaves, step, version)
            elif ftype != framing.HEARTBEAT:
                raise framing.FrameError(f"unexpected frame type {ftype} on publisher stream")

    def _send_tail(self) -> None:
        with self._lock:
            tail = [(seq, payload) for seq, payload in self._spool
                    if seq > self._sent_up_to][:SEND_BATCH]
        for seq, payload in tail:
            fault_point("transport.send")
            if self._wire_codec == "none" and self.cfg.block_codec != "none":
                # the peer did not take our codec: undo it for the wire
                # copy only (the spool on disk stays encoded)
                payload = framing.transcode_raw(payload)
            framing.send_frame(self._sock, framing.BLOCK, payload)
            with self._lock:
                self._last_send = time.monotonic()
                self._sent_up_to = max(self._sent_up_to, seq)
                self.sent_blocks += 1
                self.bytes_on_wire += len(payload) + framing.HEADER.size

    def _maybe_heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_send >= self.cfg.transport_heartbeat_s:
            fault_point("transport.send")
            framing.send_frame(self._sock, framing.HEARTBEAT,
                               framing.encode_json({"t": time.time()}))
            with self._lock:
                self._last_send = now

    # --------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.supervisor = Supervisor()
        self.supervisor.spawn("transport-publish", lambda: self.pump(0.25))

    def check(self) -> dict:
        return self.supervisor.check() if self.supervisor is not None else {}

    def flush(self, deadline_s: float = 5.0) -> bool:
        """Best-effort final drain (the stop path): pump until the spool is
        acknowledged or the deadline passes. -> whether everything offered
        was delivered and acknowledged."""
        limit = time.monotonic() + deadline_s
        while time.monotonic() < limit:
            with self._lock:
                if not self._spool:
                    return True
            self.pump(timeout=0.05)
        with self._lock:
            return not self._spool

    def stop(self, flush_deadline_s: float = 5.0) -> None:
        if self.supervisor is not None:
            self.supervisor.shutdown(timeout=5.0)
            self.supervisor = None
        self.flush(flush_deadline_s)
        self._disconnect()

    def stats(self) -> dict:
        with self._lock:
            return {
                "transport_spooled_blocks": self.spooled_blocks,
                "transport_sent_blocks": self.sent_blocks,
                "transport_acked_blocks": self.acked_blocks,
                "transport_spool_dropped": self.spool_dropped,
                "transport_spool_depth": len(self._spool),
                "transport_reconnects": self.reconnects,
                "transport_connect_failures": self.connect_failures,
                "transport_ckpts_applied": self.ckpts_applied,
                "transport_acked_seq": self._acked,
                "transport_next_seq": self._next_seq,
                "transport_connected": self._sock is not None,
                "transport_bytes_pre_codec": self.bytes_pre_codec,
                "transport_bytes_post_codec": self.bytes_post_codec,
                "transport_bytes_on_wire": self.bytes_on_wire,
                "transport_codec_ratio": (self.bytes_pre_codec / self.bytes_post_codec
                                          if self.bytes_post_codec else 0.0),
                "transport_spool_legacy": self.spool_legacy,
                "transport_spool_corrupt_dropped": self.spool_corrupt_dropped,
                "transport_wire_codec": self._wire_codec,
            }
