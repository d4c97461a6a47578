"""Replay snapshots: the whole replay state on disk, for a true resume (port
of r2d2_tpu/replay/snapshot.py: the host, device, sharded and multihost
kinds; the tiered store is a ReplayBuffer and snapshots as one, its disk
tier's manifest included; replay/reshard.py re-splits a snapshot across
another layout).
The device kind copies the card's stores to the host (at the paper's 2M
transitions that is 15.6 GB of frames) and, under priority_plane="device",
the device tree's float32 leaves (`dtree_leaves`), which are what sampling
reads there.

A snapshot holds the control plane (the sum tree's leaves, the ring
pointer, the size, env-step and episode counters, per-slot sequence counts,
the lap stamp) and a copy of every store field, under the key layout of the
JAX package's file. bfloat16 carries are written as their uint16 bits and
named in the `bf16_keys` marker, as the JAX writer does, and the port keeps
bf16 carries as those bits anyway (replay/block.py), so a host-plane
snapshot file restores in either package. Caller state (the trainer's
mid-run carry) rides in the same file under the `x_` prefix and the
topology manifest under `topo_`; the `x_` carry is the port's own.

The payload is captured under the buffer lock and written after release,
to a temp file that `os.replace` moves into place: a crash mid-write never
leaves a truncated snapshot. A restore checks every shape and dtype before
it touches the buffer, so a failed restore leaves it as constructed.
"""

from __future__ import annotations

import os
import types
from typing import Dict, Optional

import numpy as np
import torch

from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.multihost_store import MultiHostShardedReplay
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from r2d2_tpu_torch.utils.faults import fault_point

STORE_FIELDS = (
    "obs", "last_action", "last_reward", "action", "n_step_reward",
    "gamma", "hidden", "burn_in", "learning", "forward",
)

# ptr_advances is the lap stamp deferred write-backs compare against; a
# snapshot without it restores 0
_COUNTERS = (
    "block_ptr", "size", "env_steps", "num_episodes", "episode_reward_sum",
    "total_episodes", "total_reward_sum", "ptr_advances",
)

# the caller's state (the trainer's mid-run carry), so snapshot and carry
# land or are lost together
_EXTRA_PREFIX = "x_"

# the topology manifest: the layout that wrote the snapshot
_TOPO_PREFIX = "topo_"

# names the keys whose uint16 arrays are bfloat16 bits
_BF16_KEYS = "bf16_keys"


class TopologyMismatch(ValueError):
    """A snapshot's recorded topology differs from the replay restoring it.
    `saved` and `current` are the two manifests as plain dicts."""

    def __init__(self, saved: Dict, current: Dict, detail: str = ""):
        self.saved = dict(saved)
        self.current = dict(current)

        def _fmt(t: Dict) -> str:
            return (
                f"plane={t.get('plane')} dp={t.get('dp')} tp={t.get('tp')} "
                f"process_count={t.get('process_count')} "
                f"local_ids={t.get('local_ids')}"
            )

        msg = f"snapshot topology [{_fmt(self.saved)}] != current [{_fmt(self.current)}]"
        if detail:
            msg += f" ({detail})"
        msg += (" — pass --reshard (cfg.reshard_on_resume) to re-split the snapshot "
                "over this layout (replay/reshard.py)")
        super().__init__(msg)


def _kind(replay) -> str:
    if isinstance(replay, MultiHostShardedReplay):
        return "multihost"
    if isinstance(replay, ShardedDeviceReplay):
        return "sharded"
    if isinstance(replay, DeviceReplayBuffer):
        return "device"
    if isinstance(replay, ReplayBuffer):
        return "host"
    raise TypeError(f"unknown replay type {type(replay).__name__}")


def snapshot_topology(replay, tp: int = 1) -> Dict[str, np.ndarray]:
    """The topology manifest a snapshot embeds: the plane, its dp shards
    and blocks per shard, the process layout and the global shard ids this
    file holds, their global block ranges, and the draw streams' identity
    (the multihost plane's are keyed (seed, global shard id, epoch))."""
    from r2d2_tpu_torch.parallel.multihost import process_count, process_index

    plane = _kind(replay)
    cfg = replay.cfg
    nb = cfg.num_blocks
    disk = getattr(replay, "disk", None)
    dp, local_ids, bps, seed, epoch = 1, [0], nb, 0, 0
    procs, pid = 1, 0
    if plane == "multihost":
        dp, local_ids, bps = replay.dp, list(replay.local_ids), replay.blocks_per_shard
        seed, epoch = replay._seed, replay._epoch
        procs, pid = process_count(), process_index()
    elif plane == "sharded":
        dp, local_ids, bps = replay.dp, list(replay.local_ids), replay.blocks_per_shard
    return {
        "plane": np.asarray(plane),
        "dp": np.asarray(dp, np.int64),
        "tp": np.asarray(tp, np.int64),
        "process_count": np.asarray(procs, np.int64),
        "process_index": np.asarray(pid, np.int64),
        "num_blocks": np.asarray(nb, np.int64),
        "blocks_per_shard": np.asarray(bps, np.int64),
        "seqs_per_block": np.asarray(cfg.seqs_per_block, np.int64),
        "local_ids": np.asarray(local_ids, np.int64),
        "slab_ranges": np.asarray([[g * bps, (g + 1) * bps] for g in local_ids],
                                  np.int64).reshape(len(local_ids), 2),
        "rng_streams": np.asarray(local_ids, np.int64),
        "rng_seed": np.asarray(seed, np.int64),
        "rng_epoch": np.asarray(epoch, np.int64),
        "disk_blocks": np.asarray(disk.disk_blocks if disk is not None else 0, np.int64),
    }


def _plain(topo: Dict) -> Dict:
    """A manifest as plain python scalars and lists."""
    out = {}
    for k, v in topo.items():
        v = np.asarray(v)
        if v.dtype.kind in ("U", "S"):
            out[k] = str(v)
        elif v.ndim == 0:
            out[k] = int(v)
        else:
            out[k] = v.tolist()
    return out


def _topology_from(d) -> Optional[Dict]:
    names = d.files
    if _TOPO_PREFIX + "plane" not in names:
        return None
    return _plain({k[len(_TOPO_PREFIX):]: d[k] for k in names if k.startswith(_TOPO_PREFIX)})


def read_manifest(path: str) -> Optional[Dict]:
    """The topology manifest of a snapshot file, as plain python values;
    None for a snapshot without one."""
    with np.load(path, allow_pickle=False) as npz:
        return _topology_from(npz)


def _plane_state(plane, prefix: str = "") -> Dict[str, np.ndarray]:
    d = {prefix + "tree_leaves": plane.tree.leaves()}
    if plane.dtree is not None:
        # priority_plane="device": the float32 device tree is what sampling
        # reads and what the learner writes back to (the host tree only
        # sees ingestion there)
        d[prefix + "dtree_leaves"] = np.asarray(plane.dtree.leaves(), np.float32)
    for k in _COUNTERS:
        d[prefix + k] = np.asarray(getattr(plane, k))
    d[prefix + "learning_sum"] = plane.learning_sum.copy()
    d[prefix + "occupied"] = plane.occupied.copy()
    d[prefix + "num_seq_store"] = plane.num_seq_store.copy()
    return d


def _restore_plane(plane, d, prefix: str = "") -> None:
    plane.tree.load_leaves(d[prefix + "tree_leaves"])
    if plane.dtree is not None:
        # a snapshot written without a device tree seeds it from the host
        # leaves (float64 -> float32)
        key = "dtree_leaves" if prefix + "dtree_leaves" in d.files else "tree_leaves"
        plane.dtree.load_leaves(np.asarray(d[prefix + key], np.float32))
    for k in _COUNTERS:
        if prefix + k not in d.files:
            setattr(plane, k, 0)
            continue
        v = d[prefix + k][()]
        setattr(plane, k, float(v) if "reward" in k else int(v))
    plane.learning_sum[:] = d[prefix + "learning_sum"]
    plane.occupied[:] = d[prefix + "occupied"]
    plane.num_seq_store[:] = d[prefix + "num_seq_store"]


def _validated_stores(d, current: Dict[str, np.ndarray],
                      prefix: str = "store_") -> Dict[str, np.ndarray]:
    """Every store field read from the npz once, its shape and dtype checked
    against the live buffer before anything is mutated."""
    out = {}
    for k in STORE_FIELDS:
        cur = current[k]
        val = d[prefix + k]
        if val.shape != cur.shape or val.dtype != cur.dtype:
            raise ValueError(
                f"store {prefix}{k}: snapshot {val.shape}/{val.dtype} != "
                f"buffer {cur.shape}/{cur.dtype}"
            )
        out[k] = val
    return out


def _host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a device store field is saved in (bfloat16 as
    uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _host_array(v):
    """(numpy array, whether it holds bfloat16 bits) of a payload value: a
    bfloat16 tensor becomes its uint16 bits, another tensor its numpy
    array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), True
        return v.numpy(), False
    return np.asarray(v), False


class _Bf16NpzView:
    """The npz's arrays without the marker key; bf16 keys stay uint16 bits,
    the port's host form of bfloat16."""

    def __init__(self, npz):
        self._npz = npz
        self.bf16 = (
            {str(k) for k in npz[_BF16_KEYS]} if _BF16_KEYS in npz.files else set()
        )
        self.files = [k for k in npz.files if k != _BF16_KEYS]

    def __getitem__(self, k):
        v = self._npz[k]
        if k in self.bf16 and v.dtype != np.uint16:
            raise ValueError(f"snapshot key {k!r} is marked bfloat16 but holds {v.dtype}")
        return v


def _atomic_savez(path: str, payload: Dict[str, np.ndarray], bf16_keys) -> None:
    # the temp name keeps the .npz suffix: np.savez appends it otherwise
    fault_point("snapshot.write")
    tmp = path + ".tmp.npz"
    out = dict(payload)
    if bf16_keys:
        out[_BF16_KEYS] = np.asarray(sorted(bf16_keys))
    np.savez(tmp, **out)
    os.replace(tmp, path)


def save_replay(
    replay,
    path: str,
    extra: Optional[Dict] = None,
    topology: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Snapshot a host, tiered or device replay to `path`.

    The payload (control state and a copy of every store) is captured under
    the buffer lock; the npz is written after release. `extra` (arrays or
    tensors) rides under the `x_` prefix and restore_replay hands it back.
    `topology` defaults to snapshot_topology(replay)."""
    bf16 = set()
    kind = _kind(replay)
    if kind in ("sharded", "multihost"):
        _save_sharded(replay, path, kind, bf16, extra, topology)
        return
    if kind == "device":
        with replay.lock:
            payload = {"kind": np.asarray("device")}
            payload.update(_plane_state(replay))
            for k in STORE_FIELDS:
                arr, is_bf16 = _host_array(replay.stores[k])
                payload["store_" + k] = arr
                if is_bf16:
                    bf16.add("store_" + k)
        _finish_payload(replay, path, payload, bf16, extra, topology)
        return
    with replay.lock:
        payload: Dict[str, np.ndarray] = {"kind": np.asarray("host")}
        payload.update(_plane_state(replay))
        for k in STORE_FIELDS:
            # a copy: the live stores go on changing under collection
            payload["store_" + k] = getattr(replay, k + "_store").copy()
        if replay.cfg.state_dtype == torch.bfloat16:
            bf16.add("store_hidden")
        disk = getattr(replay, "disk", None)
        if disk is not None:
            # occupied disk records ride verbatim as their encoded segment
            # bytes, so a restore rewrites the segments bit for bit (and
            # heals a record torn by a kill mid-demotion)
            payload["disk_blocks"] = np.asarray(disk.disk_blocks, np.int64)
            payload["disk_ptr"] = np.asarray(replay._disk_ptr, np.int64)
            payload["slot_stamp"] = replay.slot_stamp.copy()
            occ = np.nonzero(replay.occupied[replay.cfg.num_blocks:])[0]
            payload["disk_occupied_slots"] = occ.astype(np.int64)
            for i in occ:
                payload[f"disk_rec_{int(i)}"] = disk.record_bytes(int(i))
    _finish_payload(replay, path, payload, bf16, extra, topology)


def _save_sharded(replay, path, kind, bf16, extra, topology) -> None:
    """The sharded kind: every shard's control plane under ``shard{i}_`` and
    each store field as the global (num_blocks, ...) array, shard i's slots
    at rows [i*bps, (i+1)*bps), the JAX package's layout. The multihost
    kind, one file per process: its local shards' planes and stores under
    ``g{g}_`` (global shard ids) and ``local_ids``."""
    with replay.lock:
        payload = {"kind": np.asarray(kind), "rr": np.asarray(replay._rr)}
        if kind == "multihost":
            payload["local_ids"] = np.asarray(replay.local_ids, np.int64)
            for g, shard, store in zip(replay.local_ids, replay.shards, replay.stores):
                with shard.lock:
                    payload.update(_plane_state(shard, prefix=f"g{g}_"))
                    for k in STORE_FIELDS:
                        arr, is_bf16 = _host_array(store[k])
                        payload[f"g{g}_store_{k}"] = arr
                        if is_bf16:
                            bf16.add(f"g{g}_store_{k}")
        else:
            for i, shard in enumerate(replay.shards):
                with shard.lock:
                    payload.update(_plane_state(shard, prefix=f"shard{i}_"))
            for k in STORE_FIELDS:
                arr, is_bf16 = _host_array(torch.cat([st[k].cpu() for st in replay.stores]))
                payload["store_" + k] = arr
                if is_bf16:
                    bf16.add("store_" + k)
    _finish_payload(replay, path, payload, bf16, extra, topology)


def _load_into(t: torch.Tensor, v: np.ndarray) -> None:
    """A store tensor takes a validated numpy array (bfloat16 as its bits)."""
    v = np.ascontiguousarray(v)
    src = (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
           if t.dtype == torch.bfloat16 else torch.from_numpy(v))
    t.copy_(src)


def _store_specs(stores: Dict[str, torch.Tensor], blocks: Optional[int] = None):
    """The numpy shapes and dtypes of store tensors (bfloat16 as uint16),
    with `blocks` leading rows in place of theirs."""
    return {k: types.SimpleNamespace(
        shape=tuple(t.shape) if blocks is None else (blocks, *t.shape[1:]),
        dtype=_host_dtype(t)) for k, t in stores.items()}


def _restore_sharded(replay, d, kind, saved_topo) -> None:
    """Restore the sharded or multihost kind; a snapshot of another dp or
    of other shards raises TopologyMismatch before anything is touched."""
    current = _plain(snapshot_topology(replay))
    if kind == "multihost":
        saved_ids = [int(x) for x in d["local_ids"]]
        if saved_ids != list(replay.local_ids) or (
                saved_topo is not None and saved_topo["dp"] != replay.dp):
            raise TopologyMismatch(
                saved_topo or {"plane": kind, "local_ids": saved_ids}, current,
                f"snapshot owns global shards {saved_ids} of dp "
                f"{saved_topo['dp'] if saved_topo else '?'}, this process owns "
                f"{list(replay.local_ids)} of dp {replay.dp}")
        with replay.lock:
            held = list(zip(replay.local_ids, replay.shards, replay.stores))
            vals = {}
            for g, shard, store in held:
                if len(d[f"g{g}_tree_leaves"]) != shard.tree.capacity:
                    raise ValueError(f"shard {g}: tree size mismatch")
                vals[g] = _validated_stores(d, _store_specs(store), prefix=f"g{g}_store_")
            replay._rr = int(d["rr"][()])
            for g, shard, store in held:
                with shard.lock:
                    _restore_plane(shard, d, prefix=f"g{g}_")
                    for k in STORE_FIELDS:
                        _load_into(store[k], vals[g][k])
        return
    saved_dp = saved_topo["dp"] if saved_topo else sum(
        1 for k in d.files if k.startswith("shard") and k.endswith("_block_ptr"))
    if saved_dp != replay.dp:
        raise TopologyMismatch(saved_topo or {"plane": kind, "dp": saved_dp}, current,
                               f"snapshot holds {saved_dp} dp shards, replay has {replay.dp}")
    with replay.lock:
        vals = _validated_stores(d, _store_specs(replay.stores[0], replay.cfg.num_blocks))
        for i, shard in enumerate(replay.shards):
            if len(d[f"shard{i}_tree_leaves"]) != shard.tree.capacity:
                raise ValueError(f"shard {i}: tree size mismatch")
        replay._rr = int(d["rr"][()])
        bps = replay.blocks_per_shard
        for i, shard in enumerate(replay.shards):
            with shard.lock:
                _restore_plane(shard, d, prefix=f"shard{i}_")
                for k in STORE_FIELDS:
                    _load_into(replay.stores[i][k], vals[k][i * bps:(i + 1) * bps])


def _finish_payload(replay, path, payload, bf16, extra, topology) -> None:
    """Add the caller's extras and the manifest, and write atomically."""
    for k, v in (extra or {}).items():
        arr, is_bf16 = _host_array(v)
        payload[_EXTRA_PREFIX + k] = arr
        if is_bf16:
            bf16.add(_EXTRA_PREFIX + k)
    topo = topology if topology is not None else snapshot_topology(replay)
    for k, v in topo.items():
        payload[_TOPO_PREFIX + k] = np.asarray(v)
    _atomic_savez(path, payload, bf16)


def restore_replay(replay, path: str) -> Dict[str, np.ndarray]:
    """Restore a snapshot into a freshly built replay of the same config.

    Every mismatch raises before any state is touched: another plane kind
    raises TopologyMismatch, another capacity, observation shape, hidden
    size or disk tier a ValueError. Returns the `extra` dict the snapshot
    was saved with (bfloat16 values as their uint16 bits)."""
    want = _kind(replay)
    with np.load(path, allow_pickle=False) as npz:
        d = _Bf16NpzView(npz)
        kind = str(d["kind"])
        saved_topo = _topology_from(d)
        if kind != want:
            raise TopologyMismatch(
                saved_topo or {"plane": kind}, _plain(snapshot_topology(replay)),
                f"snapshot kind {kind!r} != replay plane {want!r}",
            )
        extras = {
            k[len(_EXTRA_PREFIX):]: np.asarray(d[k])
            for k in d.files
            if k.startswith(_EXTRA_PREFIX)
        }
        if want in ("sharded", "multihost"):
            _restore_sharded(replay, d, want, saved_topo)
            return extras
        if want == "device":
            with replay.lock:
                # checked against the live stores before anything is touched
                vals = _validated_stores(d, _store_specs(replay.stores))
                if len(d["tree_leaves"]) != replay.tree.capacity:
                    raise ValueError("tree size mismatch")
                _restore_plane(replay, d)
                for k in STORE_FIELDS:
                    _load_into(replay.stores[k], vals[k])
            return extras
        with replay.lock:
            current = {k: getattr(replay, k + "_store") for k in STORE_FIELDS}
            vals = _validated_stores(d, current)
            if len(d["tree_leaves"]) != replay.tree.capacity:
                raise ValueError("tree size mismatch")
            disk = getattr(replay, "disk", None)
            saved_db = int(d["disk_blocks"][()]) if "disk_blocks" in d.files else 0
            live_db = disk.disk_blocks if disk is not None else 0
            if saved_db != live_db:
                raise ValueError(
                    f"disk tier mismatch: snapshot holds {saved_db} disk "
                    f"blocks, replay configured for {live_db}"
                )
            _restore_plane(replay, d)
            for k in STORE_FIELDS:
                current[k][:] = vals[k]
            if disk is not None:
                replay._disk_ptr = int(d["disk_ptr"][()])
                replay.slot_stamp[:] = d["slot_stamp"]
                replay._disk_cache.clear()
                for i in d["disk_occupied_slots"]:
                    disk.write_record_bytes(int(i), d[f"disk_rec_{int(i)}"])
                disk.flush()
    return extras
