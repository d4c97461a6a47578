"""Memory-mapped disk tier below the tiered plane's host slab (port of
r2d2_tpu/replay/disk_tier.py; its records are the JAX tier's, byte for
byte).

Fixed-geometry segment files hold demoted blocks' per-step fields, encoded
by replay/codec.py. The tiered store owns the policy (the victim, the
control-plane accounting, the decode cache); this module owns only the
bytes on disk.

A record is one demoted block:

    directory   len(DISK_FIELDS) x u32   encoded byte length per field
    fields      the encode_field outputs, in DISK_FIELDS order
    slack       up to record_size, untouched

Every record slot is `record_size` bytes: the directory plus the codec's
bound per field, so any encoding fits any slot and a rewrite never shifts
its neighbours. Records pack `seg_blocks` to a segment file
`seg_{k:06d}.dat`, created at its first write, so an empty tier costs
nothing.

Crash order: the fault site ``disk.write`` fires before the record's
bytes land, and the caller retires the slot's old occupant first and
accounts the new one last, so nothing references a half-written slot.
Page-in passes ``disk.promote``, then decodes on the staging thread.
"""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

from r2d2_tpu_torch.replay import codec
from r2d2_tpu_torch.replay.block import DISK_FIELDS, disk_field_specs
from r2d2_tpu_torch.utils.faults import fault_point

# records per segment file
SEG_BLOCKS = 64


class DiskTier:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dir = cfg.replay_disk_dir
        self.disk_blocks = cfg.replay_disk_capacity // cfg.block_length
        self.codec = cfg.block_codec
        self.specs = disk_field_specs(cfg)
        self._dir_struct = struct.Struct(f">{len(DISK_FIELDS)}I")
        self._field_max = {
            name: codec.encoded_max_len(shape, dt)
            for name, (shape, dt) in self.specs.items()
        }
        self.record_size = self._dir_struct.size + sum(self._field_max.values())
        self.seg_blocks = min(self.disk_blocks, SEG_BLOCKS)
        self._maps: Dict[int, np.memmap] = {}
        os.makedirs(self.dir, exist_ok=True)
        # counters, read under the owning buffer's lock (stats())
        self.writes = 0
        self.reads = 0
        self.bytes_raw = 0   # raw bytes of every record written
        self.bytes_enc = 0   # encoded bytes written

    def _segment_path(self, k: int) -> str:
        return os.path.join(self.dir, f"seg_{k:06d}.dat")

    def _segment(self, k: int) -> np.memmap:
        mm = self._maps.get(k)
        if mm is None:
            path = self._segment_path(k)
            size = self.seg_blocks * self.record_size
            mode = "r+" if (
                os.path.exists(path) and os.path.getsize(path) == size
            ) else "w+"
            mm = np.memmap(path, dtype=np.uint8, mode=mode, shape=(size,))
            self._maps[k] = mm
        return mm

    def _locate(self, slot: int):
        if not (0 <= slot < self.disk_blocks):
            raise IndexError(f"disk slot {slot} out of range")
        return self._segment(slot // self.seg_blocks), (
            slot % self.seg_blocks
        ) * self.record_size

    def write_block(self, slot: int, fields: Dict[str, np.ndarray]) -> None:
        """Encode and write one demoted block's per-step fields into record
        slot `slot` (fields in disk_field_specs' geometry, as the slab
        rows are)."""
        lengths, payloads, raw = [], [], 0
        for name in DISK_FIELDS:
            shape, dt = self.specs[name]
            arr = np.ascontiguousarray(fields[name], dtype=dt).reshape(shape)
            enc = codec.encode_field(arr, self.codec)
            if len(enc) > self._field_max[name]:  # encode_field guarantees not
                raise codec.CodecError(f"{name} encoding exceeds record slot")
            lengths.append(len(enc))
            payloads.append(enc)
            raw += arr.nbytes
        buf = self._dir_struct.pack(*lengths) + b"".join(payloads)
        fault_point("disk.write")
        mm, off = self._locate(slot)
        mm[off : off + len(buf)] = np.frombuffer(buf, np.uint8)
        self.writes += 1
        self.bytes_raw += raw
        self.bytes_enc += len(buf)

    def read_block(self, slot: int) -> Dict[str, np.ndarray]:
        """Page in and decode record slot `slot` (staging thread only)."""
        fault_point("disk.promote")
        mm, off = self._locate(slot)
        lengths = self._dir_struct.unpack(
            bytes(mm[off : off + self._dir_struct.size])
        )
        pos = off + self._dir_struct.size
        out = {}
        view = memoryview(mm)
        for name, ln in zip(DISK_FIELDS, lengths):
            arr, end = codec.decode_field(view, pos)
            if end - pos != ln:
                raise codec.CodecError(
                    f"{name} record length {end - pos} != directory {ln}"
                )
            out[name] = arr
            pos = end
        self.reads += 1
        return out

    def record_bytes(self, slot: int) -> np.ndarray:
        """The used bytes of record `slot` (directory and encoded fields),
        verbatim: snapshots carry these, so a restore rewrites the segments
        without a decode and re-encode."""
        mm, off = self._locate(slot)
        lengths = self._dir_struct.unpack(
            bytes(mm[off : off + self._dir_struct.size])
        )
        used = self._dir_struct.size + sum(lengths)
        return np.array(mm[off : off + used])

    def write_record_bytes(self, slot: int, buf: np.ndarray) -> None:
        """Inverse of record_bytes."""
        buf = np.asarray(buf, dtype=np.uint8)
        if len(buf) > self.record_size:
            raise codec.CodecError("record bytes exceed slot geometry")
        mm, off = self._locate(slot)
        mm[off : off + len(buf)] = buf

    def flush(self) -> None:
        for mm in self._maps.values():
            mm.flush()

    def stats(self) -> Dict[str, float]:
        return {
            "disk_blocks": self.disk_blocks,
            "disk_writes": self.writes,
            "disk_reads": self.reads,
            "disk_bytes_raw": self.bytes_raw,
            "disk_bytes_enc": self.bytes_enc,
            "disk_codec_ratio": (
                self.bytes_raw / self.bytes_enc if self.bytes_enc else 0.0
            ),
        }
