"""Host replay control plane (port of r2d2_tpu/replay/control_plane.py,
the part the host plane runs): sum-tree priorities, the circular block
pointer, eviction and size accounting, clamped stratified sampling of
sequence coordinates, the stale-priority pointer-window rejection (with
full-lap detection), and the per-slot stamp clock that replaces that
window under the tiered plane's disk tier; ``shard_config``, the 1/dp
view of a config that each shard of the sharded planes runs on; the device
planes' hooks: a
device sum tree kept in step with every host tree write (``dtree``,
``priority_plane="device"``) and the contiguous ring reservations of a
batched block writer (``_reserve_contiguous``, ``_reserve_advance``). With
``cfg.use_native_replay``
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


def shard_config(cfg: R2D2Config, dp: int) -> R2D2Config:
    """The per-shard (1/dp) view of a config, for the dp-sharded replay
    planes: each shard's control plane sees its slice of capacity and batch
    and knows nothing of the mesh (collection and dispatch are the parent
    plane's)."""
    return cfg.replace(
        buffer_capacity=cfg.buffer_capacity // dp,
        learning_starts=max(cfg.learning_starts // dp, 1),
        batch_size=cfg.batch_size // dp,
        dp_size=1,
        replay_plane="host",
        collector="host",
        updates_per_dispatch=1,
        priority_plane="host",
        superstep_dispatches=1,
    )


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
        # priority_plane="device": the float32 device tree
        # (replay/device_sum_tree.DeviceSumTree) attached by the data plane.
        # Every host tree write goes through _tree_write, under self.lock,
        # the lock the data plane holds while it dispatches a superstep and
        # installs its output tree: ingestion issued after a superstep lands
        # on top of its write-backs in stream order, the verdict the host
        # pointer-window mask reaches for overwritten slots
        self.dtree = None
        self.lock = threading.Lock()

    def attach_device_tree(self, dtree) -> None:
        self.dtree = dtree

    def _tree_write(self, idxes: np.ndarray, td_errors: np.ndarray) -> None:
        """The one funnel of host-initiated tree writes (ingestion,
        retirement, drained priorities). Caller holds the lock."""
        self.tree.update(idxes, td_errors)
        if self.dtree is not None:
            self.dtree.update(idxes, td_errors)

    def __len__(self) -> int:
        return self.size

    def can_sample(self) -> bool:
        return self.size >= self.cfg.learning_starts

    # --- accounting (call with self.lock held) ----------------------------

    # r2d2: guarded-by(lock)  (every caller holds self.lock, as the docstring says)
    def _account_block_at(
        self, slot: int, num_sequences: int, learning_total: int,
        priorities: np.ndarray, episode_reward: Optional[float],
    ) -> None:
        """Tree + counters for a block at an explicit slot; does not move
        the ring pointer (the caller owns that). Caller holds the lock."""
        S = self.cfg.seqs_per_block
        self._tree_write(np.arange(slot * S, (slot + 1) * S, dtype=np.int64), priorities)
        if self.occupied[slot]:
            self.size -= int(self.learning_sum[slot])
        self.learning_sum[slot] = learning_total
        self.occupied[slot] = True
        self.num_seq_store[slot] = num_sequences
        self.size += learning_total
        self.env_steps += learning_total
        if episode_reward is not None:
            self.num_episodes += 1
            self.episode_reward_sum += episode_reward
            self.total_episodes += 1
            self.total_reward_sum += episode_reward

    def _account_add(
        self, num_sequences: int, learning_total: int, priorities: np.ndarray,
        episode_reward: Optional[float],
    ) -> int:
        """Tree + counters for a block landing at block_ptr; returns the
        slot written. Caller holds the lock and writes the data plane."""
        ptr = self.block_ptr
        self._account_block_at(ptr, num_sequences, learning_total, priorities, episode_reward)
        self.block_ptr = (ptr + 1) % self.cfg.num_blocks
        self.ptr_advances += 1
        if self.slot_stamp is not None:
            self.slot_stamp[ptr] = self.ptr_advances
        return ptr

    def _account_blocks(self, num_seq: np.ndarray, learning_totals: np.ndarray,
                        priorities: np.ndarray, episode_rewards: np.ndarray,
                        dones: np.ndarray) -> None:
        """Account a batch of blocks written at consecutive ring slots; a
        truncated chunk (dones False) is not a finished episode. Caller
        holds the lock and has written the data plane."""
        for i in range(len(num_seq)):
            self._account_add(int(num_seq[i]), int(learning_totals[i]), priorities[i],
                              float(episode_rewards[i]) if dones[i] else None)

    def _retire_slots(self, slots: np.ndarray) -> None:
        """Evict the blocks at `slots` from the tree and the size
        accounting (priorities zeroed). Caller holds the lock."""
        occ = slots[self.occupied[slots]]
        if occ.size:
            S = self.cfg.seqs_per_block
            idxes = (occ[:, None] * S + np.arange(S)[None, :]).ravel()
            self._tree_write(idxes, np.zeros(idxes.size, np.float32))
            self.size -= int(self.learning_sum[occ].sum())
            self.learning_sum[occ] = 0
            self.occupied[occ] = False
            self.num_seq_store[occ] = 0
        if self.slot_stamp is not None and slots.size:
            # disk mode: a retirement is a mutation like any other, so
            # in-flight write-backs to these slots are dropped
            self.ptr_advances += 1
            self.slot_stamp[slots] = self.ptr_advances

    def _reserve_contiguous(self, n: int) -> int:
        """Wrap the ring pointer to 0 when fewer than n slots remain before
        the end, and return it: the caller writes slots [ptr, ptr+n) as one
        contiguous slab. The skipped tail slots are retired (leaves zeroed,
        transitions out of the size), so a steady n-batch writer holds
        floor(num_blocks/n)*n blocks; the pointer-window mask treats the
        tail as overwritten (over-rejection, never wrong). Caller holds the
        lock."""
        nb = self.cfg.num_blocks
        if self.block_ptr + n > nb:
            self._retire_slots(np.arange(self.block_ptr, nb))
            # the jump crosses the tail: it counts toward lap detection
            self.ptr_advances += nb - self.block_ptr
            self.block_ptr = 0
        return self.block_ptr

    def _reserve_advance(self, n: int) -> int:
        """Reserve n contiguous slots and advance the pointer past them,
        retiring their blocks now, for a writer whose accounting lands later
        (the fused runner's one-dispatch-late read-back): no draw can target
        the reserved slots, and the window mask already rejects stale rows
        aimed at them. Caller holds the lock."""
        ptr0 = self._reserve_contiguous(n)
        self._retire_slots(np.arange(ptr0, ptr0 + n))
        self.block_ptr = (ptr0 + n) % self.cfg.num_blocks
        self.ptr_advances += n
        return ptr0

    def _account_blocks_at(self, ptr0: int, num_seq: np.ndarray, learning_totals: np.ndarray,
                           priorities: np.ndarray, episode_rewards: np.ndarray,
                           dones: np.ndarray) -> None:
        """The late accounting of blocks written at [ptr0, ptr0+E), reserved
        by _reserve_advance (the pointer is past them already). Caller
        holds the lock."""
        for i in range(len(num_seq)):
            self._account_block_at(ptr0 + i, int(num_seq[i]), int(learning_totals[i]),
                                   priorities[i],
                                   float(episode_rewards[i]) if dones[i] else None)

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
                self._tree_write(idxes[mask], td_errors[mask])
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
            self._tree_write(idxes[mask], td_errors[mask])

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
