"""dp-sharded device replay (port of r2d2_tpu/replay/sharded_store.py).

- Control plane: one host ReplayControlPlane per shard, on the 1/dp view of
  the config (control_plane.shard_config): its sum tree over the shard's
  sequence slots, its ring pointer and staleness window. Blocks go round
  robin over the shards, so each shard holds a uniform 1/dp slice of the
  stream.
- Data plane: per shard, one store tensor per field of blocks_per_shard
  slots on the shard's device (mesh.devices[i]). The JAX package keeps one
  global array per field sharded over dp; shard i's slots here are its
  global block rows [i*bps, (i+1)*bps).
- Sampling: each shard draws batch_size/dp sequences from its own tree
  under its lock; the IS weights are normalised to the minimum priority
  over the whole batch, as one tree over the same draws would weigh them.
- Training: learner.make_sharded_fused_train_step gathers each shard's
  rows from its own store and sums the shards' gradients.
- priority_plane="device": each shard's float32 DeviceSumTree lives on the
  shard's device beside its store (the JAX package stacks them into one
  (dp, tree size) array sharded over dp; ``dtree_stack`` gives that view),
  kept in step with the shard's host tree by every ingestion and
  retirement. The sharded superstep (megastep.make_sharded_priority_
  superstep) samples, trains and writes back against them, dispatched
  through superstep_run.

Every consumer of the stores dispatches under the buffer lock
(run_with_stores, sample_and_run), and every write is issued under it, as
on the device plane: a card runs one stream in issue order. ShardSet holds
the shard bookkeeping both this plane and the multihost plane
(replay/multihost_store.py) keep.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.replay.block import Block, state_tensor, store_field_specs
from r2d2_tpu_torch.replay.control_plane import ReplayControlPlane, shard_config
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer


@dataclasses.dataclass
class ShardedSampleIdx:
    """Per-shard stacked sample coordinates (host side)."""

    b: np.ndarray           # (dp, B/dp) int32 block slot local to each shard
    s: np.ndarray           # (dp, B/dp) int32 sequence in block
    is_weights: np.ndarray  # (dp, B/dp) float32, normalised over the batch
    idxes: np.ndarray       # (dp, B/dp) sequence slots local to each shard
    old_ptrs: List[int]     # each shard's block pointer at the draw
    old_advances: List[int]  # each shard's ptr_advances stamp (lap detection)
    env_steps: int


def shard_stores(cfg: R2D2Config, blocks: int, device) -> Dict[str, torch.Tensor]:
    """One shard's store tensors: `blocks` slots of every field, zeroed."""
    return {k: torch.zeros((blocks, *shape), dtype=dt, device=device)
            for k, (shape, dt) in store_field_specs(cfg).items()}


class ShardSet:
    """The dp shards one process holds: a control plane (on the 1/dp view
    of the config) and a store per shard, each store on its shard's device.
    ``local_ids`` are the shards' global ids along dp, in the order of
    ``shards`` and ``stores``; single blocks go round robin over them
    (``_rr``). Every write is issued under ``lock``, and a shard's
    accounting under that shard's lock as well."""

    def __init__(self, cfg: R2D2Config, mesh: Mesh, local_ids):
        dp = mesh.dp
        if cfg.num_blocks % dp != 0:
            raise ValueError(f"num_blocks {cfg.num_blocks} not divisible by dp {dp}")
        if cfg.batch_size % dp != 0:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by dp {dp}")
        self.cfg = cfg
        self.mesh = mesh
        self.dp = dp
        self.blocks_per_shard = cfg.num_blocks // dp
        self.local_ids: List[int] = list(local_ids)
        self.shard_cfg = shard_config(cfg, dp)
        self.shards = [ReplayControlPlane(self.shard_cfg) for _ in self.local_ids]
        self.stores: List[Dict[str, torch.Tensor]] = [
            shard_stores(cfg, self.blocks_per_shard, mesh.devices[g]) for g in self.local_ids]
        self._rr = 0  # round-robin write cursor over the held shards
        self.lock = threading.Lock()

    def nbytes(self) -> int:
        """Bytes of one shard's stores."""
        return sum(t.numel() * t.element_size() for t in self.stores[0].values())

    # ---------------------------------------------------------------- state

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def env_steps(self) -> int:
        return sum(s.env_steps for s in self.shards)

    def pop_episode_stats(self):
        n = r = 0
        for sh in self.shards:
            ni, ri = sh.pop_episode_stats()
            n += ni
            r += ri
        return n, r

    def episode_totals(self):
        n = r = 0
        for sh in self.shards:
            ni, ri = sh.episode_totals()
            n += ni
            r += ri
        return n, r

    # ------------------------------------------------------------------ add

    def _write_next(self, vals: Dict[str, torch.Tensor], num_sequences: int,
                    learning_total: int, priorities: np.ndarray,
                    episode_reward: Optional[float]) -> None:
        """One block into the next held shard of the round robin, at that
        shard's ring pointer (data first, accounting last). Caller holds
        self.lock."""
        shard, store = self.shards[self._rr], self.stores[self._rr]
        with shard.lock:
            ptr = shard.block_ptr
            for k, t in store.items():
                t[ptr].copy_(vals[k])
            shard._account_add(num_sequences, learning_total, priorities, episode_reward)
        self._rr = (self._rr + 1) % len(self.shards)

    def add_block(self, block: Block, priorities: np.ndarray,
                  episode_reward: Optional[float]) -> None:
        vals = {k: state_tensor(v) for k, v in
                DeviceReplayBuffer.pad_block_fields(self.cfg, block).items()}
        with self.lock:
            self._write_next(vals, block.num_sequences, int(block.learning_steps.sum()),
                             priorities, episode_reward)

    # ------------------------------------------------------------ round trip

    def update_priorities(self, idxes, td_errors, old_ptrs: List[int],
                          old_advances: Optional[List[int]] = None) -> None:
        """idxes, td_errors: one (B/dp,) row per held shard, as drawn and
        trained; each row under its shard's own pointer window and lap
        stamp."""
        advances = old_advances if old_advances is not None else [None] * len(self.shards)
        for shard, idx_row, td_row, old_ptr, old_adv in zip(
                self.shards, idxes, np.asarray(td_errors), old_ptrs, advances):
            shard.update_priorities(idx_row, td_row, old_ptr, old_adv)

    def run_with_stores(self, fn: Callable):
        """fn(stores) under the buffer lock."""
        with self.lock:
            return fn(self.stores)


class ShardedDeviceReplay(ShardSet):
    """Every dp shard, in one process."""

    def __init__(self, cfg: R2D2Config, mesh: Mesh):
        super().__init__(cfg, mesh, range(mesh.dp))
        if cfg.priority_plane == "device":
            from r2d2_tpu_torch.replay.device_sum_tree import DeviceSumTree

            sc = self.shard_cfg
            for g, sh in zip(self.local_ids, self.shards):
                sh.attach_device_tree(DeviceSumTree(sc.num_sequences, cfg.prio_exponent,
                                                    cfg.is_exponent, device=mesh.devices[g]))

    @property
    def dtree_stack(self) -> Optional[torch.Tensor]:
        """The shards' device trees stacked (dp, tree size) on the first
        shard's device (the JAX package's layout), or None."""
        if self.shards[0].dtree is None:
            return None
        dev = self.shards[0].dtree.device
        return torch.stack([sh.dtree.tree.to(dev) for sh in self.shards])

    def superstep_run(self, fn: Callable):
        """Dispatch a sharded superstep under one buffer-lock hold:
        fn(stores, trees, num_seq_store) -> (trees', rest), per shard. The
        output trees are installed before the lock is released, so every
        later ingestion write is issued after the superstep. -> rest."""
        with self.lock:
            nss = [torch.from_numpy(sh.num_seq_store.copy()).to(sh.dtree.device)
                   for sh in self.shards]
            trees_out, rest = fn(self.stores, [sh.dtree.tree for sh in self.shards], nss)
            for sh, t in zip(self.shards, trees_out):
                sh.dtree.swap(t)
            return rest

    def can_sample(self) -> bool:
        return (len(self) >= self.cfg.learning_starts
                and all(s.tree.total > 0 for s in self.shards))

    def add_blocks_batch(self, fields: Dict[str, torch.Tensor], num_seq: np.ndarray,
                         learning_totals: np.ndarray, priorities: np.ndarray,
                         episode_rewards: np.ndarray, dones: np.ndarray) -> None:
        """E packed blocks dealt round robin from the cursor: block i goes to
        shard (rr + i) mod dp. The first floor(E/dp)*dp blocks land as one
        contiguous slab per shard (shard sid takes blocks (sid - rr) mod dp,
        + dp, ...; at consecutive local slots from _reserve_contiguous); the
        remainder goes through the single write. As E sequential add_block
        calls until a shard's ring wraps: from then on the slab retires the
        tail slots to stay contiguous."""
        E = len(num_seq)
        dp, bps = self.dp, self.blocks_per_shard
        if E > dp * bps:
            raise ValueError(f"{E} blocks per batch exceeds {dp * bps} slots")
        per = E // dp
        Em = per * dp  # the slab-written prefix
        with self.lock:
            rr = self._rr
            # every shard's lock across write and accounting, in ascending
            # order (the other paths hold one at a time): a draw between the
            # slab write and the accounting would pair new data with the
            # evicted blocks' tree
            if Em:
                with contextlib.ExitStack() as locks:
                    for sh in self.shards:
                        locks.enter_context(sh.lock)
                    starts = [sh._reserve_contiguous(per) for sh in self.shards]
                    for sid, st in enumerate(self.stores):
                        first = (sid - rr) % dp
                        for k, t in st.items():
                            t[starts[sid]:starts[sid] + per].copy_(fields[k][first:Em:dp])
                    for i in range(Em):
                        self.shards[(rr + i) % dp]._account_add(
                            int(num_seq[i]), int(learning_totals[i]), priorities[i],
                            float(episode_rewards[i]) if dones[i] else None)
            # the cursor is still rr (Em is a multiple of dp)
            for i in range(Em, E):
                self._write_next({k: v[i] for k, v in fields.items()}, int(num_seq[i]),
                                 int(learning_totals[i]), priorities[i],
                                 float(episode_rewards[i]) if dones[i] else None)

    # --------------------------------------------------------------- sample

    def sample_indices(self, rng: np.random.Generator, locked: bool = False) -> ShardedSampleIdx:
        """Each shard draws B/dp sequences under its lock (the caller's, with
        locked=True); the IS weights are normalised to the batch's minimum
        positive priority."""
        bs, ss, idxs, prios, old_ptrs, old_advances = [], [], [], [], [], []
        for shard in self.shards:
            with shard.lock if not locked else contextlib.nullcontext():
                b, s, idxes, _ = shard._draw(rng)
                old_ptrs.append(shard.block_ptr)
                old_advances.append(shard.ptr_advances)
                # read under the draw's lock: an add would rewrite the leaves
                prios.append(shard.tree.priorities_of(idxes))
            bs.append(b)
            ss.append(s)
            idxs.append(idxes)
        p = np.stack(prios)
        positive = p[p > 0.0]
        min_p = positive.min() if positive.size else 1.0
        w = np.power(np.maximum(p, min_p) / min_p, -self.cfg.is_exponent)
        return ShardedSampleIdx(
            b=np.stack(bs).astype(np.int32), s=np.stack(ss).astype(np.int32),
            is_weights=w.astype(np.float32), idxes=np.stack(idxs), old_ptrs=old_ptrs,
            old_advances=old_advances, env_steps=self.env_steps)

    def sample_and_run(self, rng: np.random.Generator, k: int, fn: Callable):
        """Draw k per-shard coordinate sets and dispatch fn(stores, draws)
        under one buffer-lock hold (the K-update dispatch): no add can
        retarget a drawn slot first. -> (draws, fn's result)."""
        with self.lock:
            draws = [self.sample_indices(rng) for _ in range(k)]
            return draws, fn(self.stores, draws)

