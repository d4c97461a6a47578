"""Per-field block codec: delta-then-deflate for uint8 observation planes
(port of r2d2_tpu/replay/codec.py; the encoded bytes are the JAX codec's,
byte for byte).

Game frames are temporally redundant: a wrapping first difference along
the time axis turns near-identical rows into near-zero rows, and zlib at
level 1 collapses them. Only uint8 fields are transformed; everything else
rides raw.

Encoded field layout:

    method   1 byte   RAW=0 | DELTA_ZLIB=1
    dtype    1 byte   index into _DTYPES
    ndim     1 byte
    dims     ndim x 4 bytes  big-endian u32
    length   4 bytes  big-endian u32 payload byte count
    payload  `length` bytes

An encoding never exceeds the raw bytes plus this header: a DELTA_ZLIB
attempt that does not shrink the field is discarded and the field ships
raw, so the disk tier sizes its record slots once from `encoded_max_len`.
Decoding is the fault site ``codec.decode`` and runs on the staging
thread, never in the learner's loop.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from r2d2_tpu_torch.utils.faults import fault_point

# config.block_codec values; "none" transforms nothing
CODECS = ("none", "delta-zlib")

RAW = 0
DELTA_ZLIB = 1

_ZLIB_LEVEL = 1

_DTYPES = (
    np.dtype(np.uint8), np.dtype(np.int8), np.dtype(np.uint16),
    np.dtype(np.int32), np.dtype(np.int64),
    np.dtype(np.float32), np.dtype(np.float64),
)
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

_FIXED = struct.Struct(">BBB")  # method, dtype code, ndim
_DIM = struct.Struct(">I")
_LEN = struct.Struct(">I")


class CodecError(ValueError):
    """Corrupt or foreign encoded-field bytes: a bad method or dtype code,
    a truncated header or payload, deflate damage."""


def header_len(ndim: int) -> int:
    return _FIXED.size + ndim * _DIM.size + _LEN.size


def encoded_max_len(shape: Tuple[int, ...], dtype) -> int:
    """Upper bound of encode_field's output for a field of this geometry:
    raw bytes plus the header (a disk record slot's size per field)."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return header_len(len(shape)) + nbytes


def _delta_u8(arr: np.ndarray) -> np.ndarray:
    """Wrapping first difference along axis 0 (uint8 modular arithmetic,
    undone exactly by a modular cumulative sum)."""
    d = arr.copy()
    if arr.shape[0] > 1:
        d[1:] = arr[1:] - arr[:-1]
    return d


def encode_field(arr: np.ndarray, codec: str = "delta-zlib") -> bytes:
    """One array -> self-describing encoded bytes. DELTA_ZLIB is tried only
    for uint8 arrays under a compressing codec, and kept only if it beats
    RAW."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPE_CODE:
        raise CodecError(f"codec does not carry dtype {arr.dtype}")
    method, payload = RAW, arr.tobytes()
    if codec == "delta-zlib" and arr.dtype == np.uint8 and arr.size:
        comp = zlib.compress(_delta_u8(arr).tobytes(), _ZLIB_LEVEL)
        if len(comp) < len(payload):
            method, payload = DELTA_ZLIB, comp
    parts = [_FIXED.pack(method, _DTYPE_CODE[arr.dtype], arr.ndim)]
    parts += [_DIM.pack(d) for d in arr.shape]
    parts.append(_LEN.pack(len(payload)))
    parts.append(payload)
    return b"".join(parts)


def decode_field(buf, offset: int = 0) -> Tuple[np.ndarray, int]:
    """Inverse of encode_field: (array, end offset), so a caller can walk
    concatenated fields. Raises CodecError on damage."""
    fault_point("codec.decode")
    buf = memoryview(buf)
    try:
        method, dcode, ndim = _FIXED.unpack_from(buf, offset)
    except struct.error as e:
        raise CodecError(f"truncated field header: {e}") from e
    if method not in (RAW, DELTA_ZLIB):
        raise CodecError(f"unknown codec method {method}")
    if dcode >= len(_DTYPES):
        raise CodecError(f"unknown dtype code {dcode}")
    pos = offset + _FIXED.size
    try:
        shape = tuple(
            _DIM.unpack_from(buf, pos + i * _DIM.size)[0] for i in range(ndim)
        )
        pos += ndim * _DIM.size
        (length,) = _LEN.unpack_from(buf, pos)
        pos += _LEN.size
    except struct.error as e:
        raise CodecError(f"truncated field header: {e}") from e
    end = pos + length
    if end > len(buf):
        raise CodecError("truncated field payload")
    payload = buf[pos:end]
    dtype = _DTYPES[dcode]
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if method == RAW:
        if length != expect:
            raise CodecError(f"raw field length {length} != {expect}")
        arr = np.frombuffer(payload, dtype).reshape(shape).copy()
    else:
        try:
            raw = zlib.decompress(bytes(payload))
        except zlib.error as e:
            raise CodecError(f"deflate damage: {e}") from e
        if len(raw) != expect:
            raise CodecError(f"inflated length {len(raw)} != {expect}")
        arr = np.frombuffer(raw, dtype).reshape(shape).copy()
        if arr.shape[0] > 1:
            # the modular cumulative sum undoes the wrapping delta exactly
            np.add.accumulate(arr, axis=0, dtype=np.uint8, out=arr)
    return arr, end
