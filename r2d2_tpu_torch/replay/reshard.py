"""Elastic resume: re-split replay snapshots across a changed topology (port
of r2d2_tpu/replay/reshard.py).

A snapshot records the layout that wrote it (snapshot.snapshot_topology);
this module restores its files into a replay of ANOTHER layout: another dp,
another process count, another plane family. A preempted dp=4 run then
restarts on whatever it is given back.

Two phases, each a fault site:

1. GATHER (``reshard.gather``): read every snapshot file of the old run (one
   per process on the multihost plane, one otherwise) into the LOGICAL
   replay: per global shard its control state and store slabs. Read only: a
   crash leaves the files as they were.
2. SCATTER (``reshard.scatter``): re-split the logical state over the new
   layout.
   - EXACT: the same dp, capacity and sequences per block. Every shard's
     ring (pointer, lap stamp, tree leaves, device-tree leaves, slabs)
     carries over bit for bit, however the shards regroup over processes.
   - RE-DEAL: otherwise. Occupied blocks are replayed in global arrival
     order (oldest first in each shard, interleaved as the round-robin
     writers dealt them) and dealt round robin over the new shards with
     their per-sequence priorities; a smaller layout keeps the newest.
     Counters come from per-block accounting; what that cannot attribute
     (evicted blocks' env steps, the episode tallies) goes to shard 0, so
     the global totals are kept exactly.

Moves across the host/device families cast the action fields between the
host plane's uint8 and the device planes' int32 (lossless: actions are
below 256). The returned extras keep only the carry keys that do not
depend on the layout (the cut step, the sampling Generator, the published
parameters); the actor's and envs' episode streams and the deferred
write-backs are dropped, and the new layout's collectors start fresh ones.

The device tree (priority_plane="device") is restored from the snapshot's
``dtree_leaves`` on the exact path, re-dealt with its blocks where every
shard saved one, and seeded from the host leaves otherwise. The JAX
package's scatter leaves the device tree alone; the host tree, the stores
and the counters are the same in both packages.

CLI: ``python -m r2d2_tpu_torch.replay.reshard CKPT_DIR [--expect-dp N
...]`` prints every snapshot manifest of a checkpoint directory as JSON
and exits 2 on an expectation it misses or incoherent shard coverage, 0
otherwise.
"""

from __future__ import annotations

import glob
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.multihost_store import MultiHostShardedReplay
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from r2d2_tpu_torch.replay.snapshot import (
    STORE_FIELDS,
    _Bf16NpzView,
    _COUNTERS,
    _EXTRA_PREFIX,
    _host_dtype,
    _load_into,
    _topology_from,
    read_manifest,
)
from r2d2_tpu_torch.utils.faults import fault_point

# carry prefixes bound to the layout (Trainer._carry_payload): the episode
# streams and the deferred write-backs
_LAYOUT_BOUND_CARRY = ("pend_", "actor_", "env_")


def snapshot_paths(ckpt_dir: str) -> List[str]:
    """Every replay snapshot file of `ckpt_dir`: replay_snapshot.npz, then
    the per-process files by process index."""
    out = []
    single = os.path.join(ckpt_dir, "replay_snapshot.npz")
    if os.path.exists(single):
        out.append(single)
    per_proc = sorted(glob.glob(os.path.join(ckpt_dir, "replay_snapshot_p*.npz")))

    def _pidx(p: str) -> int:
        m = re.search(r"replay_snapshot_p(\d+)\.npz$", p)
        return int(m.group(1)) if m else 0

    out.extend(sorted(per_proc, key=_pidx))
    return out


def _read_shard(d, prefix: str, store_prefix: str) -> Dict:
    """One logical shard's control state and stores out of an open npz
    view."""
    names = d.files
    out: Dict = {"tree_leaves": np.asarray(d[prefix + "tree_leaves"])}
    if prefix + "dtree_leaves" in names:
        out["dtree_leaves"] = np.asarray(d[prefix + "dtree_leaves"], np.float32)
    for k in _COUNTERS:
        if prefix + k in names:
            v = d[prefix + k][()]
            out[k] = float(v) if "reward" in k else int(v)
        else:
            out[k] = 0.0 if "reward" in k else 0
    for k in ("learning_sum", "occupied", "num_seq_store"):
        out[k] = np.asarray(d[prefix + k])
    out["stores"] = {k: np.asarray(d[store_prefix + k]) for k in STORE_FIELDS}
    return out


def _flatten_disk_tier(d, shard: Dict) -> None:
    """A host snapshot with a disk tier holds slab rows in store_* and the
    demoted blocks as encoded records: decode every record and append its
    rows to the stores, so the shard is one plain host plane whose store
    rows match its (already extended) occupancy arrays. Empty disk slots
    append zero rows."""
    from r2d2_tpu_torch.replay import codec
    from r2d2_tpu_torch.replay.block import DISK_FIELDS

    db = int(d["disk_blocks"][()])
    if db <= 0:
        return
    stores = shard["stores"]
    ext = {k: np.zeros((db, *stores[k].shape[1:]), stores[k].dtype) for k in DISK_FIELDS}
    dir_size = struct.calcsize(f">{len(DISK_FIELDS)}I")
    for i in np.asarray(d["disk_occupied_slots"], np.int64):
        buf = np.asarray(d[f"disk_rec_{int(i)}"], np.uint8).tobytes()
        pos = dir_size
        for name in DISK_FIELDS:
            arr, pos = codec.decode_field(buf, pos)
            ext[name][int(i)] = arr
    for k in DISK_FIELDS:
        stores[k] = np.concatenate([stores[k], ext[k]], axis=0)


def gather_logical(paths: List[str]) -> Tuple[Dict, Dict[int, Dict], Dict]:
    """Phase 1: every snapshot file, read into the logical replay.

    -> (meta, shards, extras): meta the saved layout (plane, dp, num_blocks,
    seqs_per_block, the draw streams' seed and epoch), shards the global
    shard id -> _read_shard dict, extras the carry of the file with the
    lowest process index. Read only."""
    fault_point("reshard.gather")
    if not paths:
        raise ValueError("no snapshot files to gather")
    shards: Dict[int, Dict] = {}
    meta: Dict = {}
    extras: Dict[str, np.ndarray] = {}
    extras_pidx: Optional[int] = None
    for path in paths:
        with np.load(path, allow_pickle=False) as npz:
            d = _Bf16NpzView(npz)
            kind = str(d["kind"])
            topo = _topology_from(d)
            file_shards: Dict[int, Dict] = {}
            if kind in ("host", "device"):
                file_shards[0] = _read_shard(d, "", "store_")
                if kind == "host" and "disk_blocks" in d.files:
                    _flatten_disk_tier(d, file_shards[0])
                dp = 1
            elif kind == "sharded":
                dp = topo["dp"] if topo else sum(
                    1 for k in d.files if k.startswith("shard") and k.endswith("_block_ptr"))
                bps = d["store_" + STORE_FIELDS[0]].shape[0] // dp
                for i in range(dp):
                    sh = _read_shard(d, f"shard{i}_", "store_")
                    sh["stores"] = {k: np.asarray(d["store_" + k][i * bps:(i + 1) * bps])
                                    for k in STORE_FIELDS}
                    file_shards[i] = sh
            elif kind == "multihost":
                dp = topo["dp"] if topo else None
                for g in [int(x) for x in d["local_ids"]]:
                    file_shards[g] = _read_shard(d, f"g{g}_", f"g{g}_store_")
            else:
                raise ValueError(f"unknown snapshot kind {kind!r} in {path}")
            dup = set(file_shards) & set(shards)
            if dup:
                raise ValueError(
                    f"global shard(s) {sorted(dup)} appear in more than one "
                    f"snapshot file (stale per-process files in the dir?)")
            shards.update(file_shards)
            if not meta:
                meta = {
                    "plane": kind,
                    "dp": dp,
                    "seed": topo["rng_seed"] if topo else None,
                    "epoch": topo["rng_epoch"] if topo else 0,
                    "seqs_per_block": topo["seqs_per_block"] if topo else None,
                    "topo": topo,
                }
            elif kind != meta["plane"]:
                raise ValueError(f"snapshot files disagree on plane kind: "
                                 f"{meta['plane']} vs {kind} ({path})")
            if topo:
                meta["epoch"] = max(meta["epoch"], topo["rng_epoch"])
            pidx = topo["process_index"] if topo else 0
            if extras_pidx is None or pidx < extras_pidx:
                file_extras = {k[len(_EXTRA_PREFIX):]: np.asarray(d[k])
                               for k in d.files if k.startswith(_EXTRA_PREFIX)}
                if file_extras or extras_pidx is None:
                    extras = file_extras
                    extras_pidx = pidx
    ids = sorted(shards)
    if meta["dp"] is None:
        meta["dp"] = len(ids)
    if ids != list(range(meta["dp"])):
        raise ValueError(f"gathered shards {ids} do not cover the saved dp={meta['dp']} "
                         "layout — a per-process snapshot file is missing")
    bps_old = len(shards[ids[0]]["occupied"])
    meta["num_blocks"] = bps_old * meta["dp"]
    if meta["seqs_per_block"] is None:
        meta["seqs_per_block"] = len(shards[ids[0]]["tree_leaves"]) // max(bps_old, 1)
    return meta, shards, extras


# --------------------------------------------------------------- re-deal


def _logical_blocks(meta: Dict, shards: Dict[int, Dict]) -> List[Dict]:
    """Occupied blocks in global arrival order: oldest first in each shard
    (the ring pointer points at the oldest slot), interleaved over the
    shards as the round-robin writers dealt them."""
    S = meta["seqs_per_block"]
    with_dtree = all("dtree_leaves" in sh for sh in shards.values())
    per_shard: Dict[int, List[Dict]] = {}
    for g in sorted(shards):
        sh = shards[g]
        nb = len(sh["occupied"])
        ptr = sh["block_ptr"] % nb if nb else 0
        blocks = []
        for off in range(nb):
            slot = (ptr + off) % nb
            if not sh["occupied"][slot]:
                continue
            blk = {
                "num_seq": int(sh["num_seq_store"][slot]),
                "learning": int(sh["learning_sum"][slot]),
                "leaves": sh["tree_leaves"][slot * S:(slot + 1) * S],
                "stores": {k: sh["stores"][k][slot] for k in STORE_FIELDS},
            }
            if with_dtree:
                blk["dleaves"] = sh["dtree_leaves"][slot * S:(slot + 1) * S]
            blocks.append(blk)
        per_shard[g] = blocks
    out: List[Dict] = []
    gs = sorted(per_shard)
    depth = max((len(b) for b in per_shard.values()), default=0)
    for j in range(depth):
        for g in gs:
            if j < len(per_shard[g]):
                out.append(per_shard[g][j])
    return out


def _empty_dest(meta: Dict, bps_new: int, with_dtree: bool) -> Dict:
    S = meta["seqs_per_block"]
    d: Dict = {
        "tree_leaves": np.zeros(bps_new * S, np.float64),
        "learning_sum": np.zeros(bps_new, np.int64),
        "occupied": np.zeros(bps_new, bool),
        "num_seq_store": np.zeros(bps_new, np.int32),
        "stores": None,  # allocated for the destinations this process holds
    }
    if with_dtree:
        d["dtree_leaves"] = np.zeros(bps_new * S, np.float32)
    for k in _COUNTERS:
        d[k] = 0.0 if "reward" in k else 0
    return d


def _redeal(meta: Dict, shards: Dict[int, Dict], dp_new: int, bps_new: int,
            only: Optional[set] = None) -> Tuple[Dict[int, Dict], int]:
    """Deal the logical blocks round robin over dp_new shards of bps_new
    slots, keeping the newest when they hold fewer. `only`: the destination
    shards whose store slabs to build (a multihost process holds its own);
    every destination's counters are computed, so every process derives the
    same global accounting from the same files. -> (per_dest, dropped)."""
    S = meta["seqs_per_block"]
    blocks = _logical_blocks(meta, shards)
    with_dtree = all("dtree_leaves" in sh for sh in shards.values())
    cap = dp_new * bps_new
    dropped = max(0, len(blocks) - cap)
    if dropped:
        blocks = blocks[dropped:]
    dest = {i: _empty_dest(meta, bps_new, with_dtree) for i in range(dp_new)}
    placed = np.zeros(dp_new, np.int64)
    src_sample = shards[sorted(shards)[0]]["stores"]
    for i in range(dp_new):
        if only is None or i in only:
            dest[i]["stores"] = {k: np.zeros((bps_new, *v.shape[1:]), v.dtype)
                                 for k, v in src_sample.items()}
    for j, blk in enumerate(blocks):
        i, slot = j % dp_new, j // dp_new
        d = dest[i]
        d["tree_leaves"][slot * S:(slot + 1) * S] = blk["leaves"]
        if with_dtree:
            d["dtree_leaves"][slot * S:(slot + 1) * S] = blk["dleaves"]
        d["occupied"][slot] = True
        d["learning_sum"][slot] = blk["learning"]
        d["num_seq_store"][slot] = blk["num_seq"]
        d["size"] += blk["learning"]
        placed[i] += 1
        if d["stores"] is not None:
            for k in STORE_FIELDS:
                d["stores"][k][slot] = blk["stores"][k]
    for i in range(dp_new):
        dest[i]["block_ptr"] = int(placed[i]) % bps_new
        dest[i]["ptr_advances"] = int(placed[i])
        dest[i]["env_steps"] = dest[i]["size"]
    # the global totals exactly: what per-block accounting cannot attribute
    # lands on shard 0 (consumers only ever sum these over the shards)
    env_total = sum(sh["env_steps"] for sh in shards.values())
    dest[0]["env_steps"] += env_total - sum(d["env_steps"] for d in dest.values())
    for k in ("num_episodes", "total_episodes"):
        dest[0][k] = sum(sh[k] for sh in shards.values())
    for k in ("episode_reward_sum", "total_reward_sum"):
        dest[0][k] = float(sum(sh[k] for sh in shards.values()))
    return dest, dropped


# ---------------------------------------------------------------- scatter


def _apply_plane(plane, d: Dict) -> None:
    """One shard dict into a live control plane (and its device tree).
    Caller holds the plane's lock."""
    plane.tree.load_leaves(np.asarray(d["tree_leaves"], np.float64))
    if plane.dtree is not None:
        leaves = d.get("dtree_leaves")
        plane.dtree.load_leaves(np.asarray(d["tree_leaves"] if leaves is None else leaves,
                                           np.float32))
    for k in _COUNTERS:
        setattr(plane, k, d[k])
    plane.learning_sum[:] = d["learning_sum"]
    plane.occupied[:] = d["occupied"]
    plane.num_seq_store[:] = d["num_seq_store"]


def _cast_stores(stores: Dict[str, np.ndarray], targets: Dict[str, Tuple]) -> Dict[str, np.ndarray]:
    """Shapes checked against the destination, dtypes cast across the
    host/device family boundary (uint8 <-> int32 actions). Raises before
    the caller mutates anything."""
    out = {}
    for k in STORE_FIELDS:
        shape, dtype = targets[k]
        v = stores[k]
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"store {k}: snapshot slab {v.shape} != destination {shape} "
                             "(incompatible config, not just topology)")
        out[k] = v if v.dtype == dtype else v.astype(dtype)
    return out


def _dest_layout(replay) -> Tuple[str, int, int]:
    """(plane, dp, blocks per shard) of the destination replay."""
    if isinstance(replay, MultiHostShardedReplay):
        return "multihost", replay.dp, replay.blocks_per_shard
    if isinstance(replay, ShardedDeviceReplay):
        return "sharded", replay.dp, replay.blocks_per_shard
    if isinstance(replay, DeviceReplayBuffer):
        return "device", 1, replay.cfg.num_blocks
    if isinstance(replay, ReplayBuffer):
        return "host", 1, replay.cfg.num_blocks
    raise TypeError(f"unknown replay type {type(replay).__name__}")


def reshard_replay(replay, paths: List[str]) -> Dict[str, np.ndarray]:
    """Restore snapshot files written under ANY topology into `replay`:
    gather them into logical order, then re-split over `replay`'s layout
    (exact when the logical shard set is the same, a round-robin re-deal
    otherwise). Everything is validated before anything is mutated.
    -> the layout-free part of the saved carry."""
    meta, shards, extras = gather_logical(paths)
    plane_kind, dp_new, bps_new = _dest_layout(replay)
    cfg = replay.cfg
    exact = (meta["dp"] == dp_new and meta["num_blocks"] == cfg.num_blocks
             and meta["seqs_per_block"] == cfg.seqs_per_block)
    fault_point("reshard.scatter")
    if exact:
        per_dest, dropped = shards, 0
    else:
        only = set(replay.local_ids) if plane_kind == "multihost" else set(range(dp_new))
        per_dest, dropped = _redeal(meta, shards, dp_new, bps_new, only=only)
    if dropped:
        print(f"[reshard] new layout holds {dp_new * bps_new} blocks < "
              f"{meta['num_blocks']} saved; dropped the {dropped} oldest")
    _scatter(replay, plane_kind, per_dest, meta)
    return {k: v for k, v in extras.items() if not k.startswith(_LAYOUT_BOUND_CARRY)}


def _targets(stores, blocks: Optional[int] = None) -> Dict[str, Tuple]:
    """(shape, numpy dtype) of each store field (tensors: bfloat16 as
    uint16 bits), with `blocks` leading rows in place of theirs."""
    out = {}
    for k in STORE_FIELDS:
        t = stores[k]
        dtype = t.dtype if isinstance(t, np.ndarray) else _host_dtype(t)
        shape = tuple(t.shape) if blocks is None else (blocks, *t.shape[1:])
        out[k] = (shape, np.dtype(dtype))
    return out


def _scatter(replay, plane_kind: str, per_dest: Dict[int, Dict], meta: Dict) -> None:
    """Phase 2: install each destination shard's state into the live replay.
    Every payload is cast and checked before the first mutation."""
    if plane_kind in ("multihost", "sharded"):
        held = list(zip(replay.local_ids, replay.shards, replay.stores))
        with replay.lock:
            cast = {g: _cast_stores(per_dest[g]["stores"], _targets(store))
                    for g, _, store in held}
            for g, shard, store in held:
                with shard.lock:
                    _apply_plane(shard, per_dest[g])
                    for k in STORE_FIELDS:
                        _load_into(store[k], cast[g][k])
            replay._rr = 0
            if plane_kind == "multihost":
                replay._epoch = meta["epoch"]
                if meta["seed"] is not None:
                    replay._seed = meta["seed"]
                replay._pending = None
    elif plane_kind == "device":
        with replay.lock:
            cast = _cast_stores(per_dest[0]["stores"], _targets(replay.stores))
            _apply_plane(replay, per_dest[0])
            for k in STORE_FIELDS:
                _load_into(replay.stores[k], cast[k])
    else:  # host / tiered
        current = {k: getattr(replay, k + "_store") for k in STORE_FIELDS}
        with replay.lock:
            cast = _cast_stores(per_dest[0]["stores"], _targets(current))
            _apply_plane(replay, per_dest[0])
            for k in STORE_FIELDS:
                current[k][:] = cast[k]


# -------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    """Print every snapshot manifest of a checkpoint directory as JSON and
    check them. Exit 0: no snapshot, or coherent manifests that meet every
    --expect-*; 2: a mismatch or incoherent coverage."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(prog="python -m r2d2_tpu_torch.replay.reshard",
                                description="inspect/assert replay snapshot topology manifests")
    p.add_argument("ckpt_dir")
    p.add_argument("--expect-dp", type=int, default=None)
    p.add_argument("--expect-tp", type=int, default=None)
    p.add_argument("--expect-process-count", type=int, default=None)
    args = p.parse_args(argv)

    paths = snapshot_paths(args.ckpt_dir)
    manifests = {os.path.basename(q): read_manifest(q) for q in paths}
    print(json.dumps({"ckpt_dir": args.ckpt_dir, "manifests": manifests}, indent=2))
    if not paths:
        return 0  # nothing to assert: --resume refills replay from scratch

    problems = []
    topos = [m for m in manifests.values() if m is not None]
    if len(topos) != len(manifests):
        legacy = [k for k, m in manifests.items() if m is None]
        problems.append(f"pre-manifest snapshot file(s): {legacy}")
    expects = {"dp": args.expect_dp, "tp": args.expect_tp,
               "process_count": args.expect_process_count}
    if topos:
        t0 = topos[0]
        for key in ("plane", "dp", "tp", "num_blocks", "process_count"):
            vals = {t.get(key) for t in topos}
            if len(vals) > 1:
                problems.append(f"files disagree on {key}: {sorted(map(str, vals))}")
        covered = sorted(g for t in topos for g in t["local_ids"])
        if covered != list(range(t0["dp"])):
            problems.append(f"shard coverage {covered} != saved dp={t0['dp']} layout "
                            "(missing or stale per-process files)")
        for key, want in expects.items():
            if want is not None and t0.get(key) != want:
                problems.append(f"manifest {key}={t0.get(key)} != expected {want} — "
                                "resume with --reshard or fix the layout")
    elif any(v is not None for v in expects.values()):
        problems.append("cannot assert expectations against pre-manifest snapshots")
    for prob in problems:
        print(f"topology assert failed: {prob}", file=sys.stderr)
    return 2 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
