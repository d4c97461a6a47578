"""Multi-process dp-sharded replay (port of r2d2_tpu/replay/multihost_store.py;
megastep.MultiHostFusedRunner reserves, draws and drains through it, on the
local stores themselves where JAX assembles global arrays).

Each process owns the control planes and device stores of its local shards
(parallel/multihost.local_axis_indices), and its collectors write blocks
round robin into those shards only: no replay byte crosses processes. The
train step is the sharded step over the local shards, every process calling
it in lockstep; the gradients, the loss denominator and the minimum sampled
priority are reduced across processes inside it
(learner.make_sharded_train_step with parallel/multihost.Collectives).

Draws: shard g's Generator for draw epoch e is
``np.random.default_rng((seed, g, e))``, the same stream whichever process
holds g, so one process with every shard and several with some of them
draw the same coordinates. Raw priorities go into the step, which
normalises them against the batch-global minimum (a MIN across processes):
single-tree IS semantics with no control traffic between processes.
Sampling opens per process: every local shard needs learning_starts/dp
transitions. The shards' stores, control planes, single write and
write-backs are sharded_store.ShardSet's, as on the sharded plane.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.learner import finish_read_back, start_read_back
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.parallel.multihost import local_axis_indices
from r2d2_tpu_torch.replay.sharded_store import ShardSet


class MultiHostShardedReplay(ShardSet):
    """This process's shards of the dp mesh (``local_ids``), with their
    draw streams and the collective step's dispatch."""

    def __init__(self, cfg: R2D2Config, mesh: Mesh, seed: int = 0):
        local_ids = local_axis_indices(mesh, "dp")
        if not local_ids:
            raise ValueError("this process owns no dp shards")
        super().__init__(cfg, mesh, local_ids)
        self._seed = seed
        self._epoch = 0  # draw epochs so far (part of every draw's seed)
        self._pending = None  # run_step_k's deferred (priorities, draws)

    def can_sample(self) -> bool:
        """Every local shard can serve its rows (no cross-process traffic)."""
        return all(len(s) >= self.shard_cfg.learning_starts and s.tree.total > 0
                   for s in self.shards)

    def add_blocks_batch(self, fields, num_seq: np.ndarray, learning_totals: np.ndarray,
                         priorities: np.ndarray, episode_rewards: np.ndarray,
                         dones: np.ndarray) -> None:
        """E packed blocks round robin over the local shards, one at a time
        (the JAX package's multihost write; no slab deal)."""
        with self.lock:
            for i in range(len(num_seq)):
                self._write_next({k: v[i] for k, v in fields.items()}, int(num_seq[i]),
                                 int(learning_totals[i]), priorities[i],
                                 float(episode_rewards[i]) if dones[i] else None)

    # --------------------------------------------------------------- sample

    def _draw_local(self, k: int):
        """k draw epochs for every local shard: -> ((b, s, w) (k, n, B/dp)
        host arrays, w the raw priorities; k records of the drawn idxes,
        pointers and lap stamps, one entry per local shard, for
        update_priorities). Caller holds self.lock."""
        Bs = self.cfg.batch_size // self.dp
        n = len(self.local_ids)
        epoch0 = self._epoch
        self._epoch += k
        bk = np.empty((k, n, Bs), np.int32)
        sk = np.empty((k, n, Bs), np.int32)
        wk = np.empty((k, n, Bs), np.float32)
        draws = [{"idxes": [], "old_ptrs": [], "old_advances": []} for _ in range(k)]
        for j, (g, shard) in enumerate(zip(self.local_ids, self.shards)):
            with shard.lock:
                for i in range(k):
                    rng = np.random.default_rng((self._seed, g, epoch0 + i))
                    b, s, idxes, _ = shard._draw(rng)
                    bk[i, j], sk[i, j] = b, s
                    wk[i, j] = shard.tree.priorities_of(idxes)
                    draws[i]["idxes"].append(idxes)
                    draws[i]["old_ptrs"].append(shard.block_ptr)
                    draws[i]["old_advances"].append(shard.ptr_advances)
        return (bk, sk, wk), draws

    def sample_global(self):
        """One draw epoch: -> (b, s, raw priorities) (n, B/dp) host arrays
        for the local shards, then idxes, old_ptrs and old_advances, one
        entry per local shard. Caller holds self.lock."""
        (b, s, w), (d,) = self._draw_local(1)
        return b[0], s[0], w[0], d["idxes"], d["old_ptrs"], d["old_advances"]

    def sample_global_k(self, k: int):
        """k draw epochs stacked for one K-update dispatch; the i-th uses the
        seed the i-th sample_global call would. Caller holds self.lock."""
        return self._draw_local(k)

    # ------------------------------------------------------------- dispatch

    def run_step(self, step_fn: Callable, state):
        """One collective update: draw the local rows, run the step (every
        process calls this in the same order), apply the local priorities.
        step_fn: learner.make_sharded_fused_train_step(cfg,
        is_from_priorities=True, collectives=...)."""
        with self.lock:
            b, s, w, idxes, old_ptrs, old_adv = self.sample_global()
            new_state, metrics, priorities = step_fn(state, self.stores, b, s, w)
        self.update_priorities(idxes, priorities.cpu().numpy(), old_ptrs, old_adv)
        return new_state, metrics

    def run_step_k(self, multi_fn: Callable, state, k: int):
        """K collective updates in one dispatch, the priorities read back one
        dispatch late (applied while the next dispatch runs): the previous
        dispatch's are drained here. multi_fn:
        learner.make_sharded_fused_multi_train_step(cfg, k,
        is_from_priorities=True, collectives=...)."""
        with self.lock:
            (b, s, w), draws = self.sample_global_k(k)
            new_state, metrics, priorities = multi_fn(state, self.stores, b, s, w)
        prev, self._pending = self._pending, (start_read_back(priorities), draws)
        if prev is not None:
            self.drain_pending(prev)
        return new_state, metrics

    def drain_pending(self, pending=None) -> None:
        """Apply a deferred (priorities, draws) pair, row i under draw i's
        stamps; with no argument the one in flight (a run mode's exit)."""
        if pending is None:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        prios, draws = pending
        for row, d in zip(finish_read_back(prios), draws):
            self.update_priorities(d["idxes"], row, d["old_ptrs"], d["old_advances"])
