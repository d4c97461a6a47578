"""Host replay control plane (port of r2d2_tpu/replay/control_plane.py,
the part the host plane runs): sum-tree priorities, the circular block
pointer, eviction and size accounting, clamped stratified sampling of
sequence coordinates, the stale-priority pointer-window rejection (with
full-lap detection), and the per-slot stamp clock that replaces that
window under the tiered plane's disk tier. With ``cfg.use_native_replay``
(the default) the sum tree runs in the native core
(``r2d2_tpu_torch._native``), which is built at first use; a failed build
raises.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay.sum_tree import SumTree


class ReplayControlPlane:
    def __init__(self, cfg: R2D2Config):
        self.cfg = cfg
        self.native = None
        if cfg.use_native_replay:
            from r2d2_tpu_torch._native import load_native

            self.native = load_native()
        self.tree = SumTree(cfg.num_sequences, cfg.prio_exponent, cfg.is_exponent,
                            native=self.native)
        self.block_ptr = 0
        # monotone count of ring-pointer advances: a full lap between draw
        # and write-back leaves the wrapped pointer where it was
        self.ptr_advances = 0
        self.size = 0
        self.env_steps = 0
        # since the last pop_episode_stats (the metrics stream) and over
        # the run
        self.num_episodes = 0
        self.episode_reward_sum = 0.0
        self.total_episodes = 0
        self.total_reward_sum = 0.0
        self.learning_sum = np.zeros(cfg.num_blocks, np.int64)
        self.occupied = np.zeros(cfg.num_blocks, bool)
        self.num_seq_store = np.zeros(cfg.num_blocks, np.int32)
        # disk-tier mode only (the tiered store allocates it over the host
        # and disk blocks): each slot's last mutation in ptr_advances clock
        # units. Demotion moves blocks between arbitrary slots, so there
        # update_priorities compares stamps instead of the pointer window;
        # None everywhere else, and the window mask is untouched
        self.slot_stamp = None
        self.lock = threading.Lock()

    def __len__(self) -> int:
        return self.size

    def can_sample(self) -> bool:
        return self.size >= self.cfg.learning_starts

    # --- accounting (call with self.lock held) ----------------------------

    def _account_add(
        self, num_sequences: int, learning_total: int, priorities: np.ndarray,
        episode_reward: Optional[float],
    ) -> int:
        """Tree + counters for a block landing at block_ptr; returns the
        slot written. Caller holds the lock and writes the data plane."""
        ptr = self.block_ptr
        S = self.cfg.seqs_per_block
        self.tree.update(np.arange(ptr * S, (ptr + 1) * S, dtype=np.int64), priorities)
        if self.occupied[ptr]:
            self.size -= int(self.learning_sum[ptr])
        self.learning_sum[ptr] = learning_total
        self.occupied[ptr] = True
        self.num_seq_store[ptr] = num_sequences
        self.size += learning_total
        self.env_steps += learning_total
        if episode_reward is not None:
            self.num_episodes += 1
            self.episode_reward_sum += episode_reward
            self.total_episodes += 1
            self.total_reward_sum += episode_reward
        self.block_ptr = (ptr + 1) % self.cfg.num_blocks
        self.ptr_advances += 1
        if self.slot_stamp is not None:
            self.slot_stamp[ptr] = self.ptr_advances
        return ptr

    def _retire_slots(self, slots: np.ndarray) -> None:
        """Evict the blocks at `slots` from the tree and the size
        accounting (priorities zeroed). Caller holds the lock."""
        occ = slots[self.occupied[slots]]
        if occ.size:
            S = self.cfg.seqs_per_block
            idxes = (occ[:, None] * S + np.arange(S)[None, :]).ravel()
            self.tree.update(idxes, np.zeros(idxes.size, np.float32))
            self.size -= int(self.learning_sum[occ].sum())
            self.learning_sum[occ] = 0
            self.occupied[occ] = False
            self.num_seq_store[occ] = 0
        if self.slot_stamp is not None and slots.size:
            # disk mode: a retirement is a mutation like any other, so
            # in-flight write-backs to these slots are dropped
            self.ptr_advances += 1
            self.slot_stamp[slots] = self.ptr_advances

    def _draw(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Stratified draw of batch_size sequence coordinates, with the
        zero-leaf clamp reflected into the returned global idxes. Caller
        holds the lock. Returns (b, s, idxes, is_weights)."""
        S = self.cfg.seqs_per_block
        idxes, is_weights = self.tree.sample(self.cfg.batch_size, rng)
        b = idxes // S
        s = np.minimum(idxes % S, np.maximum(self.num_seq_store[b] - 1, 0))
        return b, s, b * S + s, is_weights

    # --- priorities -------------------------------------------------------

    def update_priorities(
        self, idxes: np.ndarray, td_errors: np.ndarray, old_ptr: int,
        old_advances: Optional[int] = None,
    ) -> None:
        """Apply learner priorities, discarding any index overwritten during
        the sample -> train round trip; a full ring lap (old_advances)
        rejects the whole batch."""
        S = self.cfg.seqs_per_block
        with self.lock:
            if self.slot_stamp is not None and old_advances is not None:
                # disk mode: keep an index iff its slot has not mutated
                # since the draw (the window and the full-lap check assume
                # ring-order overwrites, which demotion breaks)
                mask = self.slot_stamp[idxes // S] <= old_advances
                self.tree.update(idxes[mask], td_errors[mask])
                return
            if (
                old_advances is not None
                and self.ptr_advances - old_advances >= self.cfg.num_blocks
            ):
                return
            ptr = self.block_ptr
            if ptr > old_ptr:
                mask = (idxes < old_ptr * S) | (idxes >= ptr * S)
            elif ptr < old_ptr:
                mask = (idxes < old_ptr * S) & (idxes >= ptr * S)
            else:
                mask = np.ones_like(idxes, dtype=bool)
            self.tree.update(idxes[mask], td_errors[mask])

    def pop_episode_stats(self):
        """(episodes, reward sum) since the last call, and reset them."""
        with self.lock:
            n, r = self.num_episodes, self.episode_reward_sum
            self.num_episodes = 0
            self.episode_reward_sum = 0.0
        return n, r

    def episode_totals(self):
        """Run-lifetime (episodes, reward sum), unaffected by
        pop_episode_stats."""
        with self.lock:
            return self.total_episodes, self.total_reward_sum
