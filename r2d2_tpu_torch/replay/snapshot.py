"""Replay snapshots: the whole replay state on disk, for a true resume (port
of r2d2_tpu/replay/snapshot.py, the host and device kinds; the tiered store
is a ReplayBuffer and snapshots as one, its disk tier's manifest included).
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
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
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
        super().__init__(msg)


def _kind(replay) -> str:
    if isinstance(replay, DeviceReplayBuffer):
        return "device"
    if isinstance(replay, ReplayBuffer):
        return "host"
    raise TypeError(f"unknown replay type {type(replay).__name__}")


def snapshot_topology(replay, tp: int = 1) -> Dict[str, np.ndarray]:
    """The topology manifest a snapshot embeds, for the one-process host
    and device planes: one logical shard holding every block."""
    plane = _kind(replay)
    cfg = replay.cfg
    nb = cfg.num_blocks
    disk = getattr(replay, "disk", None)
    return {
        "plane": np.asarray(plane),
        "dp": np.asarray(1, np.int64),
        "tp": np.asarray(tp, np.int64),
        "process_count": np.asarray(1, np.int64),
        "process_index": np.asarray(0, np.int64),
        "num_blocks": np.asarray(nb, np.int64),
        "blocks_per_shard": np.asarray(nb, np.int64),
        "seqs_per_block": np.asarray(cfg.seqs_per_block, np.int64),
        "local_ids": np.asarray([0], np.int64),
        "slab_ranges": np.asarray([[0, nb]], np.int64),
        "rng_streams": np.asarray([0], np.int64),
        "rng_seed": np.asarray(0, np.int64),
        "rng_epoch": np.asarray(0, np.int64),
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


def _plane_state(plane) -> Dict[str, np.ndarray]:
    d = {"tree_leaves": plane.tree.leaves()}
    if plane.dtree is not None:
        # priority_plane="device": the float32 device tree is what sampling
        # reads and what the learner writes back to (the host tree only
        # sees ingestion there)
        d["dtree_leaves"] = np.asarray(plane.dtree.leaves(), np.float32)
    for k in _COUNTERS:
        d[k] = np.asarray(getattr(plane, k))
    d["learning_sum"] = plane.learning_sum.copy()
    d["occupied"] = plane.occupied.copy()
    d["num_seq_store"] = plane.num_seq_store.copy()
    return d


def _restore_plane(plane, d) -> None:
    plane.tree.load_leaves(d["tree_leaves"])
    if plane.dtree is not None:
        # a snapshot written without a device tree seeds it from the host
        # leaves (float64 -> float32)
        key = "dtree_leaves" if "dtree_leaves" in d.files else "tree_leaves"
        plane.dtree.load_leaves(np.asarray(d[key], np.float32))
    for k in _COUNTERS:
        if k not in d.files:
            setattr(plane, k, 0)
            continue
        v = d[k][()]
        setattr(plane, k, float(v) if "reward" in k else int(v))
    plane.learning_sum[:] = d["learning_sum"]
    plane.occupied[:] = d["occupied"]
    plane.num_seq_store[:] = d["num_seq_store"]


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
    if _kind(replay) == "device":
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
        if want == "device":
            with replay.lock:
                # the live stores' numpy shapes and dtypes (bfloat16 as its
                # uint16 bits), checked before anything is touched
                specs = {k: types.SimpleNamespace(shape=tuple(t.shape), dtype=_host_dtype(t))
                         for k, t in replay.stores.items()}
                vals = _validated_stores(d, specs)
                if len(d["tree_leaves"]) != replay.tree.capacity:
                    raise ValueError("tree size mismatch")
                _restore_plane(replay, d)
                for k in STORE_FIELDS:
                    t = replay.stores[k]
                    v = np.ascontiguousarray(vals[k])
                    if t.dtype == torch.bfloat16:
                        src = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                    else:
                        src = torch.from_numpy(v)
                    t.copy_(src)
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
