"""IngestService: the learner's end of the pod-loop block stream (port of
r2d2_tpu/transport/ingest.py; host code).

One supervised worker, "transport-ingest", owns a listening socket and
every accepted host connection in a single select loop: accepts, frame
reads, reaping and the checkpoint broadcast all run on that thread, so the
peer table needs no lock and each host's blocks are ingested in its
sequence order (which keeps the chaos sweep's replay streams bit for bit
reproducible).

Per host connection:

- the HELLO/HELLO_ACK handshake answers with the highest sequence number
  ever ingested from that host id, kept across reconnects, so a
  SIGKILL-restarted publisher resumes just past what the learner holds;
- every BLOCK frame passes the admission check (`ingest.dedup`): a seq at
  or below the host's mark is acknowledged and dropped (counted in
  `duplicate_blocks`: 0 on the happy path, where the handshake already
  de-duplicated the stream); a newer one is ingested and moves the mark
  (gaps are tolerated: a publisher that shed spool counted the loss);
- the blocks admitted in one select pass go into replay in one
  `add_blocks_batch` call (one store-lock acquisition per burst, as the
  in-process bridge does);
- each block's learner-side stamps go into a bounded audit tail: host, ε
  stamps, params_version stamps, the version skew against the learner's
  current version, and the ingest lag (sender spool time to trainable
  time, taken when `add_blocks_batch` returns), the pod loop's health
  metric;
- a host silent past `transport_dead_peer_s` (heartbeats count) is
  reaped; its mark stays for its next connection.

Checkpoints flow the other way on the same sockets:
`broadcast_checkpoint(leaves, step, version)` (from any thread) queues the
payload under a lock, and the worker sends the CKPT frame to every
connected host on its next pass; a slow pass coalesces broadcasts to the
newest.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay import codec as blockcodec
from r2d2_tpu_torch.transport import framing
from r2d2_tpu_torch.utils.faults import TRANSIENT_ERRORS, fault_point
from r2d2_tpu_torch.utils.supervision import Supervisor


class _Peer:
    __slots__ = ("sock", "host", "last_heard")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.host: Optional[str] = None  # set by HELLO
        self.last_heard = time.monotonic()


class IngestService:
    def __init__(
        self,
        cfg: R2D2Config,
        replay,
        host: str = "127.0.0.1",
        port: int = 0,
        version_source=None,
        audit_tail_len: int = 256,
    ):
        self.cfg = cfg
        self.replay = replay
        # -> the learner's current params_version, for the per-block version
        # skew; None stamps a skew of 0
        self.version_source = version_source
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.setblocking(False)
        # the select loop's own state
        self._peers: List[_Peer] = []
        self._host_seq: Dict[str, int] = {}  # per-host high-water mark
        self.supervisor: Optional[Supervisor] = None
        self._lock = threading.Lock()
        # counters and the cross-thread hand-offs, under _lock
        self.ingested_blocks = 0
        self.duplicate_blocks = 0
        self.accepted_conns = 0
        self.dead_peers = 0
        self.ckpts_broadcast = 0
        self.bytes_on_wire = 0  # BLOCK frame bytes as received (coded)
        self.bytes_decoded = 0  # the same blocks raw
        self._pending_ckpt: Optional[bytes] = None
        self._lag_samples: deque = deque(maxlen=512)  # seconds
        self.audit_tail: deque = deque(maxlen=audit_tail_len)

    @property
    def address(self):
        return self._listener.getsockname()

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    # ----------------------------------------------------------- select loop

    def poll_once(self, timeout: float = 0.25) -> int:
        """One bounded pass: accept, read every ready peer, ingest the
        batch, ack, reap, send a queued checkpoint. -> blocks ingested. The
        supervised worker's body; tests drive it directly."""
        socks = [self._listener] + [p.sock for p in self._peers]
        try:
            ready, _, _ = select.select(socks, [], [], timeout)
        except OSError:
            # a peer socket died between passes: reap, retry on the next
            self._reap(force_dead=True)
            return 0
        batch: List = []  # (peer, decoded) admitted this pass
        for sock in ready:
            if sock is self._listener:
                self._accept()
                continue
            peer = next((p for p in self._peers if p.sock is sock), None)
            if peer is None:
                continue
            try:
                self._read_peer(peer, batch)
            except TRANSIENT_ERRORS:
                self._drop_peer(peer, dead=False)
        ingested = self._ingest(batch) if batch else 0
        self._reap()
        self._broadcast_pending()
        return ingested

    def _accept(self) -> None:
        try:
            fault_point("ingest.accept")
            sock, _ = self._listener.accept()
        except BlockingIOError:
            return
        sock.settimeout(self.cfg.transport_connect_timeout_s)
        with self._lock:
            self._peers.append(_Peer(sock))
            self.accepted_conns += 1

    def _read_peer(self, peer: _Peer, batch: List) -> None:
        """Drain every complete frame the peer has ready (the first read is
        of a socket select already signalled)."""
        first = True
        while True:
            if not first and not select.select([peer.sock], [], [], 0.0)[0]:
                return
            first = False
            ftype, payload = framing.recv_frame(peer.sock)
            peer.last_heard = time.monotonic()
            if ftype == framing.HELLO:
                hello = framing.decode_json(payload)
                if hello.get("proto") != framing.PROTO_VERSION:
                    raise framing.FrameError(f"protocol version mismatch from {hello.get('host')}")
                peer.host = str(hello.get("host"))
                # the codec: the publisher's request if this binary knows
                # it, else raw frames
                req = str(hello.get("codec", "none"))
                framing.send_frame(peer.sock, framing.HELLO_ACK, framing.encode_json({
                    "proto": framing.PROTO_VERSION,
                    "last_seq": self._host_seq.get(peer.host, 0),
                    "codec": req if req in blockcodec.CODECS else "none",
                }))
            elif ftype == framing.BLOCK:
                if peer.host is None:
                    raise framing.FrameError("BLOCK before HELLO")
                cstats: Dict = {}
                decoded = framing.decode_block(payload, stats_out=cstats)
                fault_point("ingest.dedup")
                with self._lock:
                    self.bytes_on_wire += len(payload) + framing.HEADER.size
                    self.bytes_decoded += (len(payload) + cstats.get("obs_raw_bytes", 0)
                                           - cstats.get("obs_enc_bytes", 0))
                    if decoded["seq"] <= self._host_seq.get(peer.host, 0):
                        self.duplicate_blocks += 1
                        decoded = None
                    else:
                        self._host_seq[peer.host] = decoded["seq"]
                if decoded is not None:
                    batch.append((peer, decoded))
            elif ftype != framing.HEARTBEAT:  # a heartbeat only refreshed last_heard
                raise framing.FrameError(f"unexpected frame type {ftype} on ingest stream")

    def _ingest(self, batch: List) -> int:
        """One pass's admitted blocks into replay (one lock acquisition),
        then the skew and lag stamps, and one ack per source host at its
        new mark."""
        self.replay.add_blocks_batch(
            [(d["block"], d["priorities"], d["episode_reward"]) for _, d in batch])
        t_trainable = time.time()
        version = int(self.version_source()) if self.version_source is not None else 0
        ack_to: Dict[str, tuple] = {}
        with self._lock:
            for peer, d in batch:
                self.ingested_blocks += 1
                lag = max(t_trainable - d["t_serve"], 0.0)
                self._lag_samples.append(lag)
                vers = d["ver_stamps"]
                self.audit_tail.append({
                    "host": peer.host,
                    "seq": d["seq"],
                    "epsilon": d["eps_stamps"],
                    "params_version": vers,
                    "version_skew": version - int(vers.max()) if len(vers) else 0,
                    "ingest_lag_s": lag,
                })
                ack_to[peer.host] = (peer, self._host_seq[peer.host])
        for peer, seq in ack_to.values():
            try:
                framing.send_frame(peer.sock, framing.ACK, framing.encode_json({"seq": seq}))
            except TRANSIENT_ERRORS:
                self._drop_peer(peer, dead=False)
        return len(batch)

    def _drop_peer(self, peer: _Peer, dead: bool) -> None:
        try:
            peer.sock.close()
        except OSError:
            pass
        with self._lock:
            if peer in self._peers:
                self._peers.remove(peer)
            if dead:
                self.dead_peers += 1

    def _reap(self, force_dead: bool = False) -> None:
        now = time.monotonic()
        for peer in list(self._peers):
            broken = False
            if force_dead:
                # select refused the set: find the closed socket(s)
                try:
                    peer.sock.fileno()
                    select.select([peer.sock], [], [], 0.0)
                except (OSError, ValueError):
                    broken = True
            if broken or now - peer.last_heard > self.cfg.transport_dead_peer_s:
                self._drop_peer(peer, dead=True)

    # ---------------------------------------------------- checkpoint broadcast

    def broadcast_checkpoint(self, leaves, step: int, version: int) -> None:
        """Queue a CKPT frame for every connected host (any thread); the
        select loop sends it on its next pass. Only the newest queued
        checkpoint survives: a slow pass coalesces, never builds a backlog
        of stale parameters."""
        payload = framing.encode_ckpt([np.asarray(x) for x in leaves], step, version)
        with self._lock:
            self._pending_ckpt = payload

    def _broadcast_pending(self) -> None:
        with self._lock:
            payload, self._pending_ckpt = self._pending_ckpt, None
        if payload is None:
            return
        for peer in list(self._peers):
            if peer.host is None:
                continue
            try:
                framing.send_frame(peer.sock, framing.CKPT, payload)
            except TRANSIENT_ERRORS:
                self._drop_peer(peer, dead=False)
        with self._lock:
            self.ckpts_broadcast += 1

    # --------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.supervisor = Supervisor()
        self.supervisor.spawn("transport-ingest", lambda: self.poll_once(0.25))

    def check(self) -> dict:
        return self.supervisor.check() if self.supervisor is not None else {}

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.shutdown(timeout=5.0)
            self.supervisor = None
        for peer in list(self._peers):
            self._drop_peer(peer, dead=False)
        try:
            self._listener.close()
        except OSError:
            pass

    # ----------------------------------------------------------------- stats

    def lag_quantiles_ms(self) -> Dict[str, Optional[float]]:
        with self._lock:
            samples = np.asarray(self._lag_samples, np.float64)
        if samples.size == 0:
            return {"ingest_lag_p50_ms": None, "ingest_lag_p95_ms": None,
                    "ingest_lag_max_ms": None}
        ms = samples * 1e3
        return {
            "ingest_lag_p50_ms": round(float(np.percentile(ms, 50)), 3),
            "ingest_lag_p95_ms": round(float(np.percentile(ms, 95)), 3),
            "ingest_lag_max_ms": round(float(ms.max()), 3),
        }

    def stats(self) -> dict:
        with self._lock:
            out = {
                "ingest_blocks": self.ingested_blocks,
                "ingest_duplicate_blocks": self.duplicate_blocks,
                "ingest_accepted_conns": self.accepted_conns,
                "ingest_connected_hosts": sum(1 for p in self._peers if p.host is not None),
                "ingest_dead_peers": self.dead_peers,
                "ingest_ckpts_broadcast": self.ckpts_broadcast,
                "ingest_bytes_on_wire": self.bytes_on_wire,
                "ingest_bytes_decoded": self.bytes_decoded,
                "ingest_codec_ratio": (round(self.bytes_decoded / self.bytes_on_wire, 3)
                                       if self.bytes_on_wire else 0.0),
                "ingest_host_seq": dict(self._host_seq),
            }
        out.update(self.lag_quantiles_ms())
        return out
