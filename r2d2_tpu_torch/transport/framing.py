"""Wire format of the block-stream transport (port of
r2d2_tpu/transport/framing.py): length-prefixed CRC frames, byte for byte
the JAX package's, so either package's publisher streams to either
package's ingest service.

One frame = a fixed 13-byte header + payload:

    magic   4 bytes  b"R2DB": a mismatch means the peer does not speak this
                     protocol (or the stream tore mid-frame)
    type    1 byte   frame type (HELLO .. CKPT below)
    length  4 bytes  big-endian u32 payload byte count
    crc     4 bytes  big-endian u32 crc32 of the payload

The CRC checks the payload end to end: a flipped bit anywhere in a
spooled-then-streamed block surfaces as a FrameError at the receiver, not
as a corrupted replay write. FrameError is a ConnectionError on purpose:
a framing violation leaves the stream unrecoverable mid-connection, so the
shared retry policy (`with_retries`, TRANSIENT_ERRORS) treats it as a torn
socket: drop the connection, reconnect, resume from the handshake.

Handshake: the publisher opens with HELLO `{"proto": PROTO_VERSION, "host":
<host-id>, "next_seq": N, "codec": <name>}` and the service answers
HELLO_ACK `{"proto": ..., "last_seq": M, "codec": <accepted>}`, M being the
highest sequence number it has ingested from that host. The publisher then
sends only seq > M, so a reconnecting (or SIGKILL-restarted) host never
sends again what the learner already holds. The codec is the one the
service accepts of the publisher's request ("none" for a name it does not
know); a service that omits the key is read as "none".

Control payloads (HELLO, HELLO_ACK, ACK, HEARTBEAT) are canonical JSON
(sorted keys, no spaces); BLOCK and CKPT payloads are npz archives loaded
with allow_pickle=False. Under a negotiated codec a BLOCK payload carries
the obs plane as `obs_enc` (a replay/codec.py encoded field) in place of
the raw `obs`; decode_block reads either.

Recurrent carries: the port's blocks hold bf16 carries as their uint16
bits (replay/block.py), the JAX package's hold float32 (its accumulator
packs float32) and, in an ml_dtypes bfloat16 array, come back from an npz
as the void dtype `|V2`. A BLOCK's `hidden` goes on the wire as float32,
as the JAX package's does: a bf16 carry widens exactly (its bits in the
high half of a float32), and the receiving store rounds it back to the
same bits. decode_block widens a 2-byte `hidden` (`<u2` or `|V2`) the same
way, so either package's frame decodes to float32 carries.

CKPT leaves are the JAX package's `jax.tree.leaves(params)`: the flax
parameter tree (interop.params_to_flax) flattened with dict keys sorted,
in flax layouts (Dense kernels (in, out), conv kernels HWIO, the LSTM's
wi (D, 4H) and wh (H, 4H)); `params_to_leaves` and `params_from_leaves`
cross that order.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
import zlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from r2d2_tpu_torch import interop
from r2d2_tpu_torch.replay import codec as blockcodec
from r2d2_tpu_torch.replay.block import Block

MAGIC = b"R2DB"
PROTO_VERSION = 1

# frame types
HELLO = 1       # publisher -> service: {proto, host, next_seq, codec}
HELLO_ACK = 2   # service -> publisher: {proto, last_seq, codec}
BLOCK = 3       # publisher -> service: npz (one Block + stream metadata)
ACK = 4         # service -> publisher: {seq}, the highest ingested
HEARTBEAT = 5   # either direction: {t}, liveness on an idle stream
CKPT = 6        # service -> publisher: npz (flattened parameter leaves)

HEADER = struct.Struct(">4sBII")

# a length past this is a torn or garbage header, not an allocation request
# (a CKPT at the atari widths is tens of MB)
MAX_FRAME_BYTES = 256 * 1024 * 1024


class FrameError(ConnectionError):
    """Framing violation: bad magic, CRC mismatch, absurd length, or a
    protocol-version mismatch. The stream cannot be resynchronized
    mid-connection; transient, so retry wrappers reconnect."""


def encode_frame(ftype: int, payload: bytes) -> bytes:
    return HEADER.pack(MAGIC, ftype, len(payload), zlib.crc32(payload)) + payload


def send_frame(sock, ftype: int, payload: bytes) -> None:
    sock.sendall(encode_frame(ftype, payload))


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock) -> Tuple[int, bytes]:
    """Read one complete frame; FrameError on any violation and
    ConnectionError on EOF (both transient)."""
    magic, ftype, length, crc = HEADER.unpack(_recv_exact(sock, HEADER.size))
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {length} exceeds {MAX_FRAME_BYTES}")
    payload = _recv_exact(sock, length) if length else b""
    if zlib.crc32(payload) != crc:
        raise FrameError(f"payload crc mismatch on frame type {ftype}")
    return ftype, payload


# ------------------------------------------------------------- JSON control


def encode_json(obj: Dict) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def decode_json(payload: bytes) -> Dict:
    try:
        obj = json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"malformed control payload: {e}") from e
    if not isinstance(obj, dict):
        raise FrameError("control payload must be a JSON object")
    return obj


# ------------------------------------------------------------- block codec

# the metadata rides in the same npz as the arrays: one archive is the frame
BLOCK_ARRAYS = (
    "obs", "last_action", "last_reward", "action", "n_step_reward",
    "gamma", "hidden", "burn_in_steps", "learning_steps", "forward_steps",
)

_NPZ_ERRORS = (ValueError, OSError, KeyError, zlib.error, zipfile.BadZipFile)


def wire_hidden(hidden) -> np.ndarray:
    """Carries as they go on the wire and leave decode_block: float32. A
    2-byte carry (the port's uint16 bf16 bits, or the `|V2` an ml_dtypes
    bfloat16 array loads back as) widens exactly: its bits become the high
    half of a float32."""
    h = np.asarray(hidden)
    if h.dtype.itemsize == 2 and h.dtype.kind in "uV":
        bits = np.ascontiguousarray(h).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    return h


def _save(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load(payload: bytes, what: str) -> Dict[str, np.ndarray]:
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as d:
            return {k: np.asarray(d[k]) for k in d.files}
    except _NPZ_ERRORS as e:
        raise FrameError(f"malformed {what} payload: {e}") from e


def _decode_obs(enc: np.ndarray) -> np.ndarray:
    # codec damage is payload damage: classified as a CRC miss is
    try:
        return blockcodec.decode_field(enc.tobytes())[0]
    except blockcodec.CodecError as e:
        raise FrameError(f"BLOCK obs codec damage: {e}") from e


def encode_block(
    block: Block,
    priorities: np.ndarray,
    episode_reward: Optional[float],
    seq: int,
    t_serve: float,
    eps_stamps: Optional[np.ndarray] = None,
    ver_stamps: Optional[np.ndarray] = None,
    codec: str = "none",
    stats_out: Optional[Dict] = None,
) -> bytes:
    """One finished Block, its replay-add arguments and the stream
    metadata as an npz payload. `t_serve` (the sender's wall clock at spool
    time) anchors the ingest lag; `eps_stamps` and `ver_stamps` are the
    block's per-transition audit stamps (the tap's audit-tail entry), so
    the learner stamps skew without trusting the sender's aggregate.

    `codec` ("none": the raw wire) names a replay/codec.py codec; under a
    compressing one the uint8 obs plane ships as `obs_enc`. `stats_out`,
    when given, gets `obs_raw_bytes` and `obs_enc_bytes`."""
    arrays = {k: np.asarray(getattr(block, k)) for k in BLOCK_ARRAYS}
    arrays["hidden"] = wire_hidden(arrays["hidden"])
    if stats_out is not None:
        stats_out["obs_raw_bytes"] = int(arrays["obs"].nbytes)
        stats_out["obs_enc_bytes"] = int(arrays["obs"].nbytes)
    if codec != "none":
        enc = blockcodec.encode_field(arrays.pop("obs"), codec)
        arrays["obs_enc"] = np.frombuffer(enc, np.uint8)
        if stats_out is not None:
            stats_out["obs_enc_bytes"] = len(enc)
    arrays["num_sequences"] = np.asarray(block.num_sequences, np.int64)
    arrays["task"] = np.asarray(block.task, np.int64)
    arrays["priorities"] = np.asarray(priorities)
    arrays["has_episode_reward"] = np.asarray(int(episode_reward is not None), np.int64)
    arrays["episode_reward"] = np.asarray(
        0.0 if episode_reward is None else float(episode_reward), np.float64)
    arrays["seq"] = np.asarray(int(seq), np.int64)
    arrays["t_serve"] = np.asarray(float(t_serve), np.float64)
    arrays["eps_stamps"] = np.asarray([] if eps_stamps is None else eps_stamps, np.float32)
    arrays["ver_stamps"] = np.asarray([] if ver_stamps is None else ver_stamps, np.int64)
    return _save(arrays)


def decode_block(payload: bytes, stats_out: Optional[Dict] = None) -> Dict:
    """Inverse of encode_block -> {block, priorities, episode_reward, seq,
    t_serve, eps_stamps, ver_stamps}; the block's carries float32
    (wire_hidden). `stats_out` gets `obs_enc_bytes` (obs as this payload
    carries it) and `obs_raw_bytes` (decoded)."""
    arrays = _load(payload, "BLOCK")
    if "obs_enc" in arrays:
        enc = arrays.pop("obs_enc")
        arrays["obs"] = _decode_obs(enc)
        if stats_out is not None:
            stats_out["obs_enc_bytes"] = int(enc.nbytes)
            stats_out["obs_raw_bytes"] = int(arrays["obs"].nbytes)
    elif stats_out is not None and "obs" in arrays:
        stats_out["obs_enc_bytes"] = stats_out["obs_raw_bytes"] = int(arrays["obs"].nbytes)
    try:
        fields = {k: arrays[k] for k in BLOCK_ARRAYS}
        fields["hidden"] = wire_hidden(fields["hidden"])
        return {
            "block": Block(**fields, num_sequences=int(arrays["num_sequences"][()]),
                           task=int(arrays["task"][()])),
            "priorities": arrays["priorities"],
            "episode_reward": (float(arrays["episode_reward"][()])
                               if int(arrays["has_episode_reward"][()]) else None),
            "seq": int(arrays["seq"][()]),
            "t_serve": float(arrays["t_serve"][()]),
            "eps_stamps": arrays["eps_stamps"],
            "ver_stamps": arrays["ver_stamps"],
        }
    except KeyError as e:
        raise FrameError(f"BLOCK payload missing field {e}") from e


def obs_crc(payload: bytes) -> int:
    """crc32 of a BLOCK payload's DECODED obs bytes, the spool header's
    check: over decoded bytes, so an entry that this binary's codec would
    decode differently fails on load instead of entering replay."""
    arrays = _load(payload, "BLOCK")
    if "obs_enc" in arrays:
        obs = _decode_obs(arrays["obs_enc"])
    elif "obs" in arrays:
        obs = arrays["obs"]
    else:
        raise FrameError("malformed BLOCK payload: no obs")
    return zlib.crc32(np.ascontiguousarray(obs).tobytes())


def transcode_raw(payload: bytes) -> bytes:
    """A BLOCK payload with its codec undone (`obs_enc` back to a raw
    `obs`), for a peer that negotiated "none": the spool on disk stays
    encoded, only the wire copy is raw. A raw payload passes through."""
    arrays = _load(payload, "BLOCK")
    if "obs_enc" not in arrays:
        return payload
    arrays["obs"] = _decode_obs(arrays.pop("obs_enc"))
    return _save(arrays)


# -------------------------------------------------------- checkpoint codec


def encode_ckpt(leaves: List[np.ndarray], step: int, version: int) -> bytes:
    """Flattened parameter leaves and their provenance as one npz payload.
    The receiver rebuilds against its own template (both ends build the
    same network from the same config), so only the leaf order crosses the
    wire, never a pickled structure."""
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["n_leaves"] = np.asarray(len(leaves), np.int64)
    arrays["step"] = np.asarray(int(step), np.int64)
    arrays["version"] = np.asarray(int(version), np.int64)
    return _save(arrays)


def decode_ckpt(payload: bytes) -> Tuple[List[np.ndarray], int, int]:
    arrays = _load(payload, "CKPT")
    try:
        n = int(arrays["n_leaves"][()])
        return ([arrays[f"leaf_{i}"] for i in range(n)], int(arrays["step"][()]),
                int(arrays["version"][()]))
    except KeyError as e:
        raise FrameError(f"malformed CKPT payload: missing {e}") from e


def _sorted_leaves(tree: Mapping) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    for key in sorted(tree):
        sub = tree[key]
        out.extend(_sorted_leaves(sub) if isinstance(sub, Mapping) else [np.asarray(sub)])
    return out


def _rebuild(template: Mapping, leaves: List[np.ndarray], at: List[int]) -> dict:
    out = {}
    for key in sorted(template):
        sub = template[key]
        if isinstance(sub, Mapping):
            out[key] = _rebuild(sub, leaves, at)
        else:
            leaf = np.asarray(leaves[at[0]])
            if leaf.shape != np.shape(sub):
                raise ValueError(f"CKPT leaf {at[0]} ({key!r}) has shape {leaf.shape}, the "
                                 f"template {np.shape(sub)}: the learner's and this host's "
                                 "configs build different networks")
            out[key] = leaf
            at[0] += 1
    return out


def params_to_leaves(params) -> List[np.ndarray]:
    """A network's parameters (a module or its state_dict) as CKPT leaves:
    the flax tree's leaves in the JAX package's order."""
    return _sorted_leaves(interop.params_to_flax(params))


def params_from_leaves(leaves: List[np.ndarray], template) -> Dict:
    """CKPT leaves -> a state_dict (CPU tensors), rebuilt against the flax
    tree of `template` (a module or state_dict of the same network)."""
    flax = interop.params_to_flax(template)
    n = len(_sorted_leaves(flax))
    if len(leaves) != n:
        raise ValueError(f"CKPT carries {len(leaves)} leaves, the template {n}: the "
                         "learner's and this host's configs build different networks")
    return interop.params_from_flax(_rebuild(flax, list(leaves), [0]))
