"""The port's block-stream transport against the JAX package's, across the
wire (r2d2_tpu_torch/transport vs r2d2_tpu/transport), on the CPU.

- frames: the same header and control JSON bytes; each side decodes the
  other's BLOCK and CKPT payloads to the same arrays bit for bit (the npz
  archives' zip timestamps may differ);
- streams over loopback: a JAX publisher into the port's IngestService and
  the port's publisher into JAX's deliver the same fixed blocks to the sink
  bit for bit in order, with ingest_blocks, ingest_bytes_on_wire and
  ingest_bytes_decoded equal to the one-package runs, under "none" and
  "delta-zlib";
- checkpoints: a port learner's CKPT broadcast, unflattened against a JAX
  template (jax.tree), equals interop.params_to_flax of the port's
  parameters exactly, and a JAX learner's, rebuilt by the port, equals
  interop.params_from_flax of JAX's; both over sockets, at tiny_test and
  at the atari widths (conv kernels HWIO, the LSTM's wi and wh);
- a spool directory written by one package's publisher resumes in the
  other's and delivers the same blocks;
- bf16 carries: the port's uint16 bf16 bits and an ml_dtypes bfloat16
  array each cross to the other side and land in a bf16 carry slab with
  the same bits.
"""

from __future__ import annotations

import os
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from r2d2_tpu.config import default_atari as jax_atari
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu.replay.block import Block as JaxBlock
from r2d2_tpu.transport import framing as jframing
from r2d2_tpu.transport.ingest import IngestService as JaxIngestService
from r2d2_tpu.transport.publisher import BlockStreamPublisher as JaxPublisher
from r2d2_tpu_torch import interop
from r2d2_tpu_torch.config import default_atari, tiny_test
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.replay.block import Block, to_state_host
from r2d2_tpu_torch.transport import framing
from r2d2_tpu_torch.transport.ingest import IngestService
from r2d2_tpu_torch.transport.publisher import BlockStreamPublisher

torch.set_num_threads(1)

pytestmark = pytest.mark.transport

FIELDS = framing.BLOCK_ARRAYS
OVER = dict(env_name="catch", action_dim=3, liveloop=True, transport_connect_timeout_s=2.0,
            transport_heartbeat_s=0.2, transport_dead_peer_s=5.0)


def _cfgs(**over):
    kw = {**OVER, **over}
    return tiny_test().replace(**kw), jax_tiny_test().replace(**kw).validate()


def _fields(i, T=12, hidden=None):
    r = np.random.default_rng(i)
    obs = np.zeros((T, 1, 5, 5), np.uint8)
    obs[:, 0, 1:4, 2] = r.integers(1, 255, (T, 3))
    return dict(
        obs=obs,
        last_action=r.integers(0, 3, (T,)).astype(np.uint8),
        last_reward=r.normal(size=(T,)).astype(np.float32),
        action=r.integers(0, 3, (T,)).astype(np.uint8),
        n_step_reward=r.normal(size=(T,)).astype(np.float32),
        gamma=np.full((T,), 0.99, np.float32),
        hidden=r.normal(size=(1, 2, 8)).astype(np.float32) if hidden is None else hidden,
        num_sequences=1,
        burn_in_steps=np.zeros((1,), np.int32),
        learning_steps=np.full((1,), T - 1, np.int32),
        forward_steps=np.zeros((1,), np.int32),
    )


def _meta(d):
    return (d["seq"], d["t_serve"], d["episode_reward"], d["block"].num_sequences,
            d["block"].task)


def _same_decoded(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a["block"], f)), np.asarray(getattr(b["block"], f))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    for k in ("priorities", "eps_stamps", "ver_stamps"):
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert _meta(a) == _meta(b)


class _Sink:
    def __init__(self):
        self.items = []

    def add_blocks_batch(self, items):
        self.items.extend(items)


def _pump_until(pub, cond, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and not cond():
        pub.pump(timeout=0.05)
    return cond()


# ------------------------------------------------------------------ frames


def test_headers_and_control_json_are_the_same_bytes():
    for ftype in (framing.HELLO, framing.HELLO_ACK, framing.BLOCK, framing.ACK,
                  framing.HEARTBEAT, framing.CKPT):
        for payload in (b"", b"payload-bytes"):
            assert framing.encode_frame(ftype, payload) == jframing.encode_frame(ftype, payload)
    for obj in ({"proto": 1, "host": "h0", "next_seq": 7, "codec": "delta-zlib"},
                {"seq": 12}, {"t": 1.25}, {"proto": 1, "last_seq": 0, "codec": "none"}):
        assert framing.encode_json(obj) == jframing.encode_json(obj)
    assert (framing.MAGIC, framing.PROTO_VERSION, framing.MAX_FRAME_BYTES) == (
        jframing.MAGIC, jframing.PROTO_VERSION, jframing.MAX_FRAME_BYTES)
    assert framing.HEADER.format == jframing._HEADER.format


@pytest.mark.parametrize("codec", ["none", "delta-zlib"])
def test_each_side_decodes_the_others_block_payload(codec):
    eps = np.asarray([0.1, 0.4], np.float32)
    ver = np.asarray([2, 3], np.int64)
    prio = np.asarray([0.5], np.float32)
    for i, er in enumerate((0.75, None)):
        f = _fields(i)
        args = dict(seq=5 + i, t_serve=123.5, eps_stamps=eps, ver_stamps=ver, codec=codec)
        ours = framing.encode_block(Block(**f), prio, er, **args)
        theirs = jframing.encode_block(JaxBlock(**f), prio, er, **args)
        # the same entries, names, dtypes and bytes: the payloads differ at
        # most in the zip timestamps, so their lengths are equal
        assert len(ours) == len(theirs)
        _same_decoded(framing.decode_block(ours), jframing.decode_block(ours))
        _same_decoded(framing.decode_block(theirs), jframing.decode_block(theirs))
        _same_decoded(framing.decode_block(ours), framing.decode_block(theirs))
        assert framing.obs_crc(ours) == jframing.obs_crc(ours) == framing.obs_crc(theirs)
        raw = framing.transcode_raw(ours)
        _same_decoded(jframing.decode_block(jframing.transcode_raw(theirs)),
                      framing.decode_block(raw))


def test_each_side_decodes_the_others_ckpt_payload():
    leaves = [np.arange(6.0, dtype=np.float32).reshape(2, 3), np.ones((4,), np.float64),
              np.full((2, 2, 1, 3), -0.5, np.float32)]
    for enc, dec in ((framing.encode_ckpt, jframing.decode_ckpt),
                     (jframing.encode_ckpt, framing.decode_ckpt)):
        got, step, version = dec(enc(leaves, 40, 2))
        assert (step, version) == (40, 2)
        for a, b in zip(got, leaves, strict=True):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------- loopback streams


def _stream(pub_cls, svc_cls, codec, tag, n=5):
    """n fixed blocks from a publisher of `pub_cls` to an ingest service of
    `svc_cls`, each built from its own package's config."""
    cfg, jcfg = _cfgs(block_codec=codec)
    sink = _Sink()
    svc = svc_cls(cfg if svc_cls is IngestService else jcfg, sink, version_source=lambda: 3)
    svc.start()
    ours = pub_cls is BlockStreamPublisher
    pub = pub_cls(cfg if ours else jcfg, ("127.0.0.1", svc.port), f"h-{tag}", seed=0)
    block_cls = Block if ours else JaxBlock
    try:
        stamps = {"epsilon": np.asarray([0.2] * 11, np.float32),
                  "params_version": np.asarray([1] * 11, np.int64)}
        pub.audit_source = lambda: stamps
        for i in range(n):
            pub.add_block(block_cls(**_fields(i)), np.asarray([0.5 + i], np.float32),
                          float(i) if i % 2 else None)
        assert _pump_until(pub, lambda: len(sink.items) == n)
        assert _pump_until(pub, lambda: pub.stats()["transport_spool_depth"] == 0)
        return sink.items, svc.stats(), pub.stats()
    finally:
        pub.stop(flush_deadline_s=1.0)
        svc.stop()


_STATS = ("ingest_blocks", "ingest_bytes_on_wire", "ingest_bytes_decoded",
          "ingest_duplicate_blocks")


@pytest.mark.parametrize("codec", ["none", "delta-zlib"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_streams_cross_the_packages(codec, direction):
    if direction == "jax->port":
        cross = _stream(JaxPublisher, IngestService, codec, "x")
    else:
        cross = _stream(BlockStreamPublisher, JaxIngestService, codec, "x")
    same = _stream(JaxPublisher, JaxIngestService, codec, "j")
    port = _stream(BlockStreamPublisher, IngestService, codec, "p")
    for items in (cross[0], port[0]):
        assert len(items) == len(same[0]) == 5
        for (b, p, er), (wb, wp, wer) in zip(items, same[0]):
            for f in FIELDS:
                x, y = np.asarray(getattr(b, f)), np.asarray(getattr(wb, f))
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
            assert p.tobytes() == wp.tobytes() and er == wer
    for key in _STATS:
        assert cross[1][key] == same[1][key] == port[1][key], key
    assert cross[2]["transport_wire_codec"] == same[2]["transport_wire_codec"] == codec
    for key in ("transport_bytes_on_wire", "transport_bytes_pre_codec",
                "transport_bytes_post_codec", "transport_acked_seq"):
        assert cross[2][key] == same[2][key] == port[2][key], key


# ------------------------------------------------------------- checkpoints


def _nets(preset):
    over = dict(env_name="catch", action_dim=3)
    if preset == "atari":
        cfg, jcfg = default_atari().replace(**over), jax_atari().replace(**over).validate()
    else:
        cfg, jcfg = tiny_test().replace(**over), jax_tiny_test().replace(**over).validate()
    _, jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    net = R2D2Network.from_config(cfg, device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(2)
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return cfg, jcfg, jparams, net


def _broadcast(svc_cls, pub_cls, leaves):
    """`leaves` broadcast by an ingest service of `svc_cls` to a publisher
    of `pub_cls` over loopback -> the leaves its on_checkpoint received."""
    cfg, jcfg = _cfgs()
    got = []
    svc = svc_cls(cfg if svc_cls is IngestService else jcfg, _Sink(), version_source=None)
    svc.start()
    pub = pub_cls(cfg if pub_cls is BlockStreamPublisher else jcfg, ("127.0.0.1", svc.port),
                  "h0", seed=0,
                  on_checkpoint=lambda lv, step, ver: got.append((lv, step, ver)))
    try:
        assert _pump_until(pub, lambda: svc.stats()["ingest_connected_hosts"] == 1)
        svc.broadcast_checkpoint(leaves, step=40, version=2)
        assert _pump_until(pub, lambda: got)
    finally:
        pub.stop(flush_deadline_s=0.5)
        svc.stop()
    assert got[0][1:] == (40, 2)
    return got[0][0]


@pytest.mark.parametrize("preset", ["tiny_test", "atari"])
def test_checkpoint_leaves_cross_the_packages(preset):
    cfg, _, jparams, net = _nets(preset)
    treedef = jax.tree.structure(jparams)
    # the port learner's broadcast, applied by a JAX host: the JAX host
    # rebuilds against its own treedef (r2d2_tpu/transport/podloop.py)
    leaves = _broadcast(IngestService, JaxPublisher, framing.params_to_leaves(net))
    rebuilt = jax.tree.unflatten(treedef, leaves)
    want = interop.params_to_flax(net)
    assert jax.tree.structure(want) == treedef
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # a JAX learner's broadcast (jax.tree.leaves), applied by a port host
    leaves = _broadcast(JaxIngestService, BlockStreamPublisher, jax.tree.leaves(jparams))
    sd = framing.params_from_leaves(leaves, net.state_dict())
    want = interop.params_from_flax(jparams)
    assert sd.keys() == want.keys()
    for k in sd:
        assert sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k]), k
    # a template of another network is refused, not misread
    other = R2D2Network.from_config(cfg.replace(hidden_dim=cfg.hidden_dim + 8), device="cpu")
    with pytest.raises(ValueError, match="different networks"):
        framing.params_from_leaves(leaves, other.state_dict())


# ------------------------------------------------------------------- spool


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_spool_resumes_in_the_other_package(tmp_path, writer):
    cfg, jcfg = _cfgs(block_codec="delta-zlib", transport_spool_dir=str(tmp_path),
                      transport_connect_timeout_s=0.3)
    if writer == "port":
        w, r, block_cls, svc_cls, rcfg = BlockStreamPublisher, JaxPublisher, Block, \
            JaxIngestService, jcfg
    else:
        w, r, block_cls, svc_cls, rcfg = JaxPublisher, BlockStreamPublisher, JaxBlock, \
            IngestService, cfg
    pub = w(cfg if w is BlockStreamPublisher else jcfg, ("127.0.0.1", 1), "hS", seed=0)
    for i in range(3):
        pub.add_block(block_cls(**_fields(i)), np.asarray([1.0], np.float32), None)
    del pub  # no stop, no flush: the spool on disk is all that is left
    assert len(os.listdir(tmp_path / "hS")) == 3
    sink = _Sink()
    svc = svc_cls(rcfg, sink)
    svc.start()
    pub = r(rcfg, ("127.0.0.1", svc.port), "hS", seed=1)
    try:
        st = pub.stats()
        assert (st["transport_spool_depth"], st["transport_next_seq"]) == (3, 4)
        assert st["transport_spool_corrupt_dropped"] == st["transport_spool_legacy"] == 0
        assert _pump_until(pub, lambda: len(sink.items) == 3)
        for i, (b, _, _) in enumerate(sink.items):
            for f, want in _fields(i).items():
                if f != "num_sequences":
                    assert np.array_equal(getattr(b, f), want), f
        assert svc.stats()["ingest_host_seq"] == {"hS": 3}
    finally:
        pub.stop(flush_deadline_s=0.5)
        svc.stop()


# -------------------------------------------------------------- bf16 carries


def _bf16_store(pkg, payload):
    """A BLOCK payload decoded by `pkg` and written into a bf16 carry slab
    as that package's replay store writes one (the port:
    `to_state_host(block.hidden, bfloat16)`, replay_buffer.py; JAX: a slab
    assignment into an ml_dtypes bfloat16 array) -> the stored bits."""
    if pkg == "port":
        return to_state_host(framing.decode_block(payload)["block"].hidden, torch.bfloat16)
    slab = np.zeros((1, 2, 8), ml_dtypes.bfloat16)
    slab[:] = jframing.decode_block(payload)["block"].hidden
    return slab.view(np.uint16)


def test_bf16_carries_keep_their_bits_both_ways():
    rng = np.random.default_rng(5)
    bits = rng.normal(size=(1, 2, 8)).astype(np.float32).astype(ml_dtypes.bfloat16).view(
        np.uint16)
    assert bits.dtype == np.uint16
    # the port's bf16 carries (uint16 bits) go on the wire as float32
    ours = framing.encode_block(Block(**_fields(0, hidden=bits.copy())),
                                np.ones((1,), np.float32), None, seq=1, t_serve=0.0)
    theirs_view = jframing.decode_block(ours)["block"].hidden
    assert theirs_view.dtype == np.float32
    assert np.array_equal(theirs_view.astype(ml_dtypes.bfloat16).view(np.uint16), bits)
    assert np.array_equal(_bf16_store("jax", ours), bits)
    assert np.array_equal(_bf16_store("port", ours), bits)
    # JAX carries held as ml_dtypes bfloat16 (an npz gives them back as |V2)
    theirs = jframing.encode_block(
        JaxBlock(**_fields(0, hidden=bits.view(ml_dtypes.bfloat16).copy())),
        np.ones((1,), np.float32), None, seq=1, t_serve=0.0)
    ours_view = framing.decode_block(theirs)["block"].hidden
    assert ours_view.dtype == np.float32
    assert np.array_equal(ours_view.view(np.uint32) >> 16, bits.astype(np.uint32))
    assert np.array_equal(_bf16_store("port", theirs), bits)
    # and float32 carries (what either accumulator packs at precision fp32)
    # round to the same bits in both stores
    f32 = _fields(1)
    ours = framing.encode_block(Block(**f32), np.ones((1,), np.float32), None, seq=1,
                                t_serve=0.0)
    theirs = jframing.encode_block(JaxBlock(**f32), np.ones((1,), np.float32), None, seq=1,
                                   t_serve=0.0)
    want = f32["hidden"].astype(ml_dtypes.bfloat16).view(np.uint16)
    for payload in (ours, theirs):
        assert np.array_equal(_bf16_store("port", payload), want)
        assert np.array_equal(_bf16_store("jax", payload), want)


def test_hidden_widening_is_exact():
    bits = np.arange(0, 65536, 97, dtype=np.uint16)
    bits = bits[(bits & 0x7F80) != 0x7F80]  # finite values only
    wide = framing.wire_hidden(bits)
    assert wide.dtype == np.float32
    assert np.array_equal(wide.astype(ml_dtypes.bfloat16).view(np.uint16), bits)
    assert np.array_equal(framing.wire_hidden(bits.view("V2")), wide)
    f = np.linspace(-3, 3, 11, dtype=np.float32)
    assert framing.wire_hidden(f) is f
