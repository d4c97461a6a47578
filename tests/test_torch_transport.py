"""The port's block-stream transport (r2d2_tpu_torch/transport) on the CPU,
case for case as tests/test_transport.py and the transport cases of
tests/test_disk_tier.py hold the JAX package's: the frame codec's
integrity, publisher -> ingest delivery over loopback with ack pruning and
audit stamps, the reconnect resume without duplicates, the on-disk spool's
crash resume, the bounded spool's shedding across a sequence gap, the
reaping of a silent peer, the checkpoint broadcast, the codec negotiation
against a peer that omits the key, and the spool's v1 header with legacy
and corrupt entries. All loopback sockets, tiny_test shapes.

Then the pod loop's process bodies: `--role learner` and `--role serve`
refuse a machine with no card unless given `--device cpu`, and the pod
(a learner and two serve hosts as subprocesses, closed-loop catch sessions
over TCP) runs on the CPU through a SIGKILL of a host and its relaunch from
its spool, with no duplicate block and no session lost.
"""

from __future__ import annotations

import json
import os
import socket
import time
import zlib

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.replay.block import Block
from r2d2_tpu_torch.transport import framing
from r2d2_tpu_torch.transport import podloop
from r2d2_tpu_torch.transport.ingest import IngestService
from r2d2_tpu_torch.transport.publisher import (
    SPOOL_HEADER,
    SPOOL_MAGIC,
    BlockStreamPublisher,
)
from r2d2_tpu_torch.utils import faults
from torch_podloop import pod_failures, run_pod

torch.set_num_threads(1)

pytestmark = pytest.mark.transport


@pytest.fixture(autouse=True)
def _clean_plane():
    faults.uninstall()
    faults.reset_retry_stats()
    yield
    faults.uninstall()
    faults.reset_retry_stats()


def _cfg(**over):
    base = dict(env_name="catch", action_dim=3, liveloop=True,
                transport_connect_timeout_s=2.0, transport_heartbeat_s=0.2,
                transport_dead_peer_s=1.0)
    base.update(over)
    return tiny_test().replace(**base)


def mk_block(i: int, T: int = 12) -> Block:
    rng = np.random.default_rng(i)
    B = 1
    return Block(
        obs=rng.normal(size=(T, B, 5, 5)).astype(np.float32),
        last_action=rng.integers(0, 3, (T, B)).astype(np.int32),
        last_reward=rng.normal(size=(T, B)).astype(np.float32),
        action=rng.integers(0, 3, (T, B)).astype(np.int32),
        n_step_reward=rng.normal(size=(T, B)).astype(np.float32),
        gamma=np.ones((T, B), np.float32),
        hidden=rng.normal(size=(2, B, 8)).astype(np.float32),
        num_sequences=B,
        burn_in_steps=np.zeros((B,), np.int32),
        learning_steps=np.full((B,), T, np.int32),
        forward_steps=np.zeros((B,), np.int32),
    )


def mk_u8_block(i: int, T: int = 12, fill=None) -> Block:
    """A block with a uint8 obs plane (what the delta-zlib codec encodes)."""
    r = np.random.default_rng(i)
    obs = np.zeros((T, 1, 5, 5), np.uint8)
    if fill is None:
        obs[:, 0, 2:4, 2:4] = (i % 200) + 1
    else:
        obs[:, 0, 1, 1] = fill
    return Block(
        obs=obs,
        last_action=r.integers(0, 3, (T, 1)).astype(np.int32),
        last_reward=r.normal(size=(T, 1)).astype(np.float32),
        action=r.integers(0, 3, (T, 1)).astype(np.int32),
        n_step_reward=r.normal(size=(T, 1)).astype(np.float32),
        gamma=np.ones((T, 1), np.float32),
        hidden=r.normal(size=(2, 1, 8)).astype(np.float32),
        num_sequences=1,
        burn_in_steps=np.zeros((1,), np.int32),
        learning_steps=np.full((1,), T, np.int32),
        forward_steps=np.zeros((1,), np.int32))


class FakeReplay:
    def __init__(self):
        self.items = []

    def add_blocks_batch(self, items):
        self.items.extend(items)


def _pump_until(pub, cond, deadline_s=15.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if cond():
            return True
        pub.pump(timeout=0.05)
    return cond()


@pytest.fixture()
def loop():
    """A running IngestService and a publisher pumped by the test."""
    cfg = _cfg()
    replay = FakeReplay()
    svc = IngestService(cfg, replay, version_source=lambda: 7)
    svc.start()
    applied = []
    pub = BlockStreamPublisher(
        cfg, ("127.0.0.1", svc.port), "h0", seed=1,
        on_checkpoint=lambda leaves, step, ver: applied.append((leaves, step, ver)))
    yield cfg, replay, svc, pub, applied
    pub.stop(flush_deadline_s=1.0)
    svc.stop()


# ------------------------------------------------------------- frame codec


def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        framing.send_frame(a, framing.HELLO, framing.encode_json({"x": 1}))
        payload = framing.encode_block(mk_block(0), np.ones((1,), np.float32), 0.25, seq=3,
                                       t_serve=1.5)
        framing.send_frame(a, framing.BLOCK, payload)
        ftype, got = framing.recv_frame(b)
        assert ftype == framing.HELLO
        assert framing.decode_json(got) == {"x": 1}
        ftype, got = framing.recv_frame(b)
        assert ftype == framing.BLOCK
        assert got == payload
    finally:
        a.close()
        b.close()


def test_frame_crc_rejects_corruption():
    frame = bytearray(framing.encode_frame(framing.BLOCK, b"payload-bytes"))
    frame[-3] ^= 0xFF  # flip a payload bit
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(framing.FrameError, match="crc"):
            framing.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_frame_bad_magic_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall(b"NOPE" + b"\x00" * 9)
        with pytest.raises(framing.FrameError, match="magic"):
            framing.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_block_codec_roundtrip_bit_exact():
    block = mk_block(4)
    prios = np.asarray([0.7], np.float32)
    eps = np.asarray([0.1, 0.2], np.float32)
    ver = np.asarray([3, 3], np.int64)
    payload = framing.encode_block(block, prios, 1.25, seq=9, t_serve=2.5, eps_stamps=eps,
                                   ver_stamps=ver)
    d = framing.decode_block(payload)
    for f in framing.BLOCK_ARRAYS:
        np.testing.assert_array_equal(getattr(d["block"], f), getattr(block, f))
        assert getattr(d["block"], f).dtype == getattr(block, f).dtype
    assert d["block"].num_sequences == block.num_sequences
    np.testing.assert_array_equal(d["priorities"], prios)
    assert d["episode_reward"] == 1.25
    assert d["seq"] == 9 and d["t_serve"] == 2.5
    np.testing.assert_array_equal(d["eps_stamps"], eps)
    np.testing.assert_array_equal(d["ver_stamps"], ver)
    # a None episode reward survives the has_episode_reward flag
    d2 = framing.decode_block(framing.encode_block(block, prios, None, seq=1, t_serve=0.0))
    assert d2["episode_reward"] is None


def test_ckpt_codec_roundtrip():
    leaves = [np.arange(6.0).reshape(2, 3), np.ones((4,), np.float32)]
    got, step, version = framing.decode_ckpt(framing.encode_ckpt(leaves, step=40, version=2))
    assert step == 40 and version == 2
    assert len(got) == 2
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)


def test_malformed_payloads_raise_frame_error():
    with pytest.raises(framing.FrameError):
        framing.decode_block(b"not an npz")
    with pytest.raises(framing.FrameError):
        framing.decode_ckpt(b"garbage")
    with pytest.raises(framing.FrameError):
        framing.decode_json(b"\xff\xfe")


# ------------------------------------------------------------ loopback path


def test_loopback_delivery_acks_and_stamps(loop):
    cfg, replay, svc, pub, _ = loop
    stamps = iter([{"epsilon": np.asarray([0.3], np.float32),
                    "params_version": np.asarray([5], np.int64)}] * 3)
    pub.audit_source = lambda: next(stamps)
    for i in range(3):
        pub.add_block(mk_block(i), np.ones((1,), np.float32), float(i))
    assert _pump_until(pub, lambda: len(replay.items) == 3)
    # acks prune the spool to nothing
    assert _pump_until(pub, lambda: pub.stats()["transport_spool_depth"] == 0)
    st = svc.stats()
    assert st["ingest_blocks"] == 3
    assert st["ingest_duplicate_blocks"] == 0
    assert st["ingest_host_seq"] == {"h0": 3}
    # the learner-side stamps: host, epsilon, the version skew against the
    # learner's version_source (7 - 5 = 2)
    tail = list(svc.audit_tail)
    assert [e["seq"] for e in tail] == [1, 2, 3]
    assert all(e["host"] == "h0" for e in tail)
    assert all(e["version_skew"] == 2 for e in tail)
    assert all(e["ingest_lag_s"] >= 0.0 for e in tail)
    np.testing.assert_array_equal(tail[0]["epsilon"], np.asarray([0.3], np.float32))
    # delivered bit for bit
    np.testing.assert_array_equal(replay.items[0][0].obs, mk_block(0).obs)
    assert [er for (_, _, er) in replay.items] == [0.0, 1.0, 2.0]


def test_reconnect_resumes_without_duplicates(loop):
    cfg, replay, svc, pub, _ = loop
    for i in range(4):
        pub.add_block(mk_block(i), np.ones((1,), np.float32), None)
    assert _pump_until(pub, lambda: len(replay.items) == 4)
    pub._disconnect()  # a torn stream mid-run
    for i in range(4, 6):
        pub.add_block(mk_block(i), np.ones((1,), np.float32), None)
    assert _pump_until(pub, lambda: len(replay.items) == 6)
    st = svc.stats()
    assert st["ingest_blocks"] == 6
    assert st["ingest_duplicate_blocks"] == 0
    assert st["ingest_host_seq"] == {"h0": 6}
    assert pub.stats()["transport_reconnects"] == 2


def test_ckpt_broadcast_reaches_publisher(loop):
    cfg, replay, svc, pub, applied = loop
    pub.add_block(mk_block(0), np.ones((1,), np.float32), None)
    assert _pump_until(pub, lambda: len(replay.items) == 1)
    leaves = [np.arange(4.0), np.full((2, 2), 7.0)]
    svc.broadcast_checkpoint(leaves, step=20, version=3)
    assert _pump_until(pub, lambda: len(applied) == 1)
    got, step, version = applied[0]
    assert (step, version) == (20, 3)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)
    assert pub.stats()["transport_ckpts_applied"] == 1


def test_spool_shed_oldest_counted_gap_tolerated():
    """A bounded spool under a dead learner sheds its OLDEST unacked
    blocks; once connected, the learner ingests the surviving tail across
    the sequence gap without wedging or counting twice."""
    cfg = _cfg(transport_spool_depth=3)
    replay = FakeReplay()
    svc = IngestService(cfg, replay, version_source=None)
    pub = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=2)
    try:
        for i in range(5):  # 5 offers into a depth-3 spool: 2 shed
            pub.add_block(mk_block(i), np.ones((1,), np.float32), None)
        st = pub.stats()
        assert st["transport_spool_dropped"] == 2
        assert st["transport_spool_depth"] == 3
        svc.start()
        assert _pump_until(pub, lambda: len(replay.items) == 3)
        st = svc.stats()
        # seq 3..5 arrive over the 1..2 gap; the mark lands on 5
        assert st["ingest_host_seq"] == {"h0": 5}
        assert st["ingest_duplicate_blocks"] == 0
        np.testing.assert_array_equal(replay.items[0][0].obs, mk_block(2).obs)
    finally:
        pub.stop(flush_deadline_s=1.0)
        svc.stop()


def test_spool_crash_resume_from_disk(tmp_path):
    """A publisher dies with an unacked spool on disk; a fresh one with the
    same host id and spool dir resumes the numbering and delivers the
    tail, and the handshake keeps the learner free of duplicates."""
    cfg = _cfg(transport_spool_dir=str(tmp_path))
    replay = FakeReplay()
    svc = IngestService(cfg, replay, version_source=None)
    svc.start()
    pub = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=3)
    for i in range(3):
        pub.add_block(mk_block(i), np.ones((1,), np.float32), None)
    assert _pump_until(pub, lambda: len(replay.items) == 3)
    # two more the learner never sees, then vanish (no stop, no flush)
    pub._disconnect()
    for i in range(3, 5):
        pub.add_block(mk_block(i), np.ones((1,), np.float32), None)
    del pub

    pub2 = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=4)
    try:
        # numbered past everything ever spooled here
        assert pub2.stats()["transport_next_seq"] == 6
        pub2.add_block(mk_block(5), np.ones((1,), np.float32), None)
        assert _pump_until(pub2, lambda: len(replay.items) == 6)
        st = svc.stats()
        assert st["ingest_blocks"] == 6
        assert st["ingest_duplicate_blocks"] == 0
        assert st["ingest_host_seq"] == {"h0": 6}
        # each delivered once, in sequence order
        for i in range(6):
            np.testing.assert_array_equal(replay.items[i][0].obs, mk_block(i).obs)
    finally:
        pub2.stop(flush_deadline_s=1.0)
        svc.stop()


def test_spool_resume_after_every_block_was_acked(tmp_path):
    """Every block acked, so no entry is left on disk: a relaunched
    publisher still numbers past them (the spool's hwm file), and its
    blocks reach the learner instead of being pruned as already held."""
    cfg = _cfg(transport_spool_dir=str(tmp_path))
    replay = FakeReplay()
    svc = IngestService(cfg, replay, version_source=None)
    svc.start()
    pub = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=3)
    for i in range(3):
        pub.add_block(mk_block(i), np.ones((1,), np.float32), None)
    assert _pump_until(pub, lambda: pub.stats()["transport_acked_seq"] == 3)
    assert not [n for n in os.listdir(tmp_path / "h0") if n.endswith(".blk")]
    pub._disconnect()
    del pub  # SIGKILL: no stop, no flush

    pub2 = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=4)
    try:
        assert pub2.stats()["transport_next_seq"] == 4
        pub2.add_block(mk_block(3), np.ones((1,), np.float32), None)
        assert _pump_until(pub2, lambda: len(replay.items) == 4)
        assert svc.stats()["ingest_host_seq"] == {"h0": 4}
        np.testing.assert_array_equal(replay.items[3][0].obs, mk_block(3).obs)
    finally:
        pub2.stop(flush_deadline_s=1.0)
        svc.stop()


def test_dead_peer_reaped_and_mark_survives():
    """A host silent past transport_dead_peer_s is reaped; its mark
    survives for its next connection."""
    cfg = _cfg(transport_dead_peer_s=0.4, transport_heartbeat_s=0.1)
    svc = IngestService(cfg, FakeReplay(), version_source=None)
    svc.start()
    # a hand-rolled host: handshake, one block, then silence without a
    # close (a wedged process, not a clean disconnect)
    sock = socket.create_connection(("127.0.0.1", svc.port), timeout=2.0)
    try:
        framing.send_frame(sock, framing.HELLO, framing.encode_json(
            {"proto": framing.PROTO_VERSION, "host": "h0", "next_seq": 1}))
        sock.settimeout(2.0)
        ftype, _ = framing.recv_frame(sock)
        assert ftype == framing.HELLO_ACK
        framing.send_frame(sock, framing.BLOCK, framing.encode_block(
            mk_block(0), np.ones((1,), np.float32), None, seq=1, t_serve=time.time()))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and svc.stats()["ingest_dead_peers"] < 1:
            time.sleep(0.05)
        st = svc.stats()
        assert st["ingest_blocks"] == 1
        assert st["ingest_dead_peers"] >= 1
        assert st["ingest_connected_hosts"] == 0
        assert st["ingest_host_seq"] == {"h0": 1}  # the mark survives
    finally:
        sock.close()
        svc.stop()


def test_protocol_version_mismatch_rejected():
    svc = IngestService(_cfg(), FakeReplay(), version_source=None)
    svc.start()
    try:
        sock = socket.create_connection(("127.0.0.1", svc.port), timeout=2.0)
        try:
            framing.send_frame(sock, framing.HELLO, framing.encode_json(
                {"proto": framing.PROTO_VERSION + 1, "host": "hX", "next_seq": 1}))
            sock.settimeout(2.0)
            # the service drops the connection instead of answering
            with pytest.raises((ConnectionError, socket.timeout, OSError)):
                framing.recv_frame(sock)
        finally:
            sock.close()
    finally:
        svc.stop()


# -------------------------------------------- wire negotiation + spool v1


def test_hello_codec_negotiation_and_old_peer_interop(monkeypatch):
    """Publisher and learner agree on delta-zlib; a learner that omits the
    codec key (an older binary) downgrades the publisher to raw frames,
    transcoded at send time."""
    cfg = _cfg(block_codec="delta-zlib")

    def run_pair(strip_ack_codec):
        replay = FakeReplay()
        svc = IngestService(cfg, replay)
        svc.start()
        orig = framing.encode_json
        if strip_ack_codec:
            def stripped(obj):
                if isinstance(obj, dict) and "last_seq" in obj:
                    obj = {k: v for k, v in obj.items() if k != "codec"}
                return orig(obj)
            monkeypatch.setattr(framing, "encode_json", stripped)
        try:
            pub = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=1)
            for i in range(3):
                pub.add_block(mk_u8_block(i), np.ones((1,), np.float32), 0.25)
            assert _pump_until(pub, lambda: len(replay.items) == 3, deadline_s=20.0)
            for i, (blk, _, _) in enumerate(replay.items):
                np.testing.assert_array_equal(blk.obs, mk_u8_block(i).obs)
            stats = pub.stats()
            pub.stop(flush_deadline_s=1.0)
            svc.stop()
            return stats, svc.stats()
        finally:
            monkeypatch.setattr(framing, "encode_json", orig)

    new_stats, new_svc = run_pair(strip_ack_codec=False)
    assert new_stats["transport_wire_codec"] == "delta-zlib"
    assert new_stats["transport_bytes_on_wire"] > 0
    assert new_svc["ingest_bytes_decoded"] > new_svc["ingest_bytes_on_wire"]

    old_stats, old_svc = run_pair(strip_ack_codec=True)
    assert old_stats["transport_wire_codec"] == "none"
    # the raw transcode costs more wire bytes than the negotiated codec
    assert old_stats["transport_bytes_on_wire"] >= new_stats["transport_bytes_on_wire"]
    # raw frames: what arrived is what it decodes to, less the headers
    assert old_svc["ingest_bytes_decoded"] == old_svc["ingest_bytes_on_wire"] - 3 * 13


def test_ingest_answers_unknown_codec_with_none():
    svc = IngestService(_cfg(), None)
    try:
        sock = socket.create_connection(("127.0.0.1", svc.port), timeout=2)
        sock.settimeout(2)
        framing.send_frame(sock, framing.HELLO, framing.encode_json({
            "proto": framing.PROTO_VERSION, "host": "hX", "codec": "future-zstd-9000"}))
        # the first poll accepts the connection, a later one reads the HELLO
        for _ in range(10):
            svc.poll_once(0.2)
        ftype, payload = framing.recv_frame(sock)
        assert ftype == framing.HELLO_ACK
        assert json.loads(payload.decode("utf-8"))["codec"] == "none"
        sock.close()
    finally:
        svc.stop()


def test_spool_v1_header_detects_legacy_and_corruption(tmp_path):
    """Spool entries carry magic, version, codec and the CRC of the decoded
    obs; a bare-npz spool file is adopted (legacy), a damaged one is
    dropped and unlinked, and dropped sequence numbers are never issued
    again."""
    spool_root = str(tmp_path / "spool")
    cfg = _cfg(transport_spool_dir=spool_root, block_codec="delta-zlib",
               transport_connect_timeout_s=0.3)
    # a publisher with no live service: everything stays in the spool
    pub = BlockStreamPublisher(cfg, ("127.0.0.1", 1), "hS", seed=3)
    for i in range(3):
        pub.add_block(mk_u8_block(i, fill=i + 1), np.ones((1,), np.float32), None)
    spool_dir = os.path.join(spool_root, "hS")
    files = sorted(os.listdir(spool_dir))
    assert len(files) == 3
    with open(os.path.join(spool_dir, files[0]), "rb") as f:
        raw = f.read()
    magic, version, codec_id, crc, plen = SPOOL_HEADER.unpack_from(raw)
    assert magic == SPOOL_MAGIC and version == 1 and codec_id == 1
    payload = raw[SPOOL_HEADER.size:]
    assert len(payload) == plen
    # the CRC covers the DECODED obs: checked apart from the header
    d = framing.decode_block(payload)
    assert crc == zlib.crc32(np.ascontiguousarray(d["block"].obs, np.uint8).tobytes())
    pub.stop(flush_deadline_s=0.1)

    # legacy: a raw npz payload, no header, the highest seq on disk
    with open(os.path.join(spool_dir, f"{9:012d}.blk"), "wb") as f:
        f.write(framing.encode_block(mk_u8_block(7, fill=8), np.ones((1,), np.float32), None,
                                     seq=9, t_serve=time.time()))
    # corrupt 1: sound framing, but the stored CRC no longer matches the
    # decoded obs (the round trip the header pins)
    bad = bytearray(raw)
    bad[:SPOOL_HEADER.size] = SPOOL_HEADER.pack(magic, version, codec_id, crc ^ 0xDEADBEEF, plen)
    bad_path = os.path.join(spool_dir, f"{10:012d}.blk")
    with open(bad_path, "wb") as f:
        f.write(bytes(bad))
    # corrupt 2: a sound header, the payload cut mid-npz (decode raises)
    cut = raw[: SPOOL_HEADER.size + plen // 2]
    cut_path = os.path.join(spool_dir, f"{11:012d}.blk")
    with open(cut_path, "wb") as f:
        f.write(SPOOL_HEADER.pack(magic, version, codec_id, crc, len(cut) - SPOOL_HEADER.size)
                + cut[SPOOL_HEADER.size:])

    pub2 = BlockStreamPublisher(cfg, ("127.0.0.1", 1), "hS", seed=4)
    st = pub2.stats()
    assert st["transport_spool_legacy"] == 1
    assert st["transport_spool_corrupt_dropped"] == 2
    assert not os.path.exists(bad_path)  # dropped AND unlinked
    assert not os.path.exists(cut_path)
    assert st["transport_spool_depth"] == 4  # 3 v1 + 1 legacy
    # numbering continues past every file seen, the dropped ones included
    assert st["transport_next_seq"] == 12
    pub2.stop(flush_deadline_s=0.1)


# ------------------------------------------------------------- the config


@pytest.mark.parametrize("over,match", [
    (dict(transport_spool_depth=0), "transport_spool_depth"),
    (dict(transport_heartbeat_s=0.0), "transport_heartbeat_s"),
    (dict(transport_connect_timeout_s=-1.0), "transport_connect_timeout_s"),
    (dict(transport_heartbeat_s=2.0, transport_dead_peer_s=2.0), "transport_dead_peer_s"),
])
def test_transport_config_checks(over, match):
    with pytest.raises(ValueError, match=match):
        tiny_test().replace(**over)


def test_podloop_config_lays_the_pod_fields_over_the_preset():
    cfg = podloop.podloop_config("atari", checkpoint_dir="ck", spool_dir="sp",
                                 overrides=["buffer_capacity=16000", "learning_starts=2000"])
    assert (cfg.hidden_dim, cfg.obs_shape, cfg.compute_dtype) == (512, (84, 84, 1), "bfloat16")
    assert (cfg.env_name, cfg.action_dim, cfg.liveloop, cfg.save_interval) == (
        "catch", 3, True, 20)
    assert (cfg.buffer_capacity, cfg.learning_starts) == (16000, 2000)
    assert (cfg.checkpoint_dir, cfg.transport_spool_dir) == ("ck", "sp")
    tiny = podloop.podloop_config()
    assert (tiny.hidden_dim, tiny.learning_starts, tiny.buffer_capacity) == (32, 128, 4096)


# --------------------------------------------------------------- the pod


def test_pod_roles_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        podloop.main(["--role", "learner"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        podloop.main(["--role", "serve", "--learner-port", "1"])


def test_pod_on_the_cpu_through_a_sigkill(tmp_path):
    """A learner and two serve hosts as processes, eight closed-loop catch
    sessions over TCP, h0 SIGKILLed at 40% of a 20 s window and relaunched
    with its id, spool and port (the window stretches to give it 10 s
    after its relaunch): no duplicate block, no session lost, the learner
    trains through the outage, h0's mark passes its value at the kill and
    takes every block the relaunched h0 numbered, and every host reloads a
    broadcast checkpoint."""
    res = run_pod(str(tmp_path), device="cpu", preset="tiny_test", sessions=8, rate=10.0,
                  seconds=20.0)
    assert pod_failures(res) == [], json.dumps(res, default=str)[:4000]
    assert res["learner"]["lstm_launches"] == {}  # CPU tensors never reach a kernel
