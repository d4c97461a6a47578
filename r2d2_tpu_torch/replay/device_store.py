"""Device-resident replay data plane (port of r2d2_tpu/replay/device_store.py).

The control plane (sum tree, ring pointer, staleness windows, accounting)
stays on the host (replay/control_plane.py, shared with the host plane);
the data lives on the card: one preallocated tensor per store field
(replay/block.store_field_specs), written once per block. An update ships
only its (B,) sample coordinates and gathers its windows from the stores
inside the step (learner.make_fused_train_step).

At the paper's 2,000,000 transitions (5,000 blocks of 441 frame slots of
84x84x1) the frames take about 15.6 GB, a fifth of an 80 GB card.

Concurrency: the stores are written in place (the JAX package donates them
instead), so the lock contract is the same. Every consumer dispatches under
the buffer lock (`run_with_stores`, `sample_and_run`, `superstep_run`), and
every write is issued under it too: the card runs one stream in issue
order, so a gather reads exactly the contents its coordinates were drawn
against. No caller may hold coordinates across an add_block; a batch
materialized at sample time (learner.make_gather_step) is a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay.block import (
    Block,
    state_host_dtype,
    state_tensor,
    store_field_specs,
    to_state_host,
)
from r2d2_tpu_torch.replay.control_plane import ReplayControlPlane


@dataclasses.dataclass
class SampleIdx:
    """Host-side sample coordinates; everything else stays on the card."""

    b: np.ndarray           # (B,) int32 block slot
    s: np.ndarray           # (B,) int32 sequence in block
    is_weights: np.ndarray  # (B,) float32
    idxes: np.ndarray       # (B,) global sequence slots (priority updates)
    old_ptr: int
    env_steps: int
    # the draw-time ptr_advances stamp (lap detection)
    old_advances: Optional[int] = None


class DeviceReplayBuffer(ReplayControlPlane):
    def __init__(self, cfg: R2D2Config, device="cuda"):
        super().__init__(cfg)
        self.device = torch.device(device)
        if cfg.priority_plane == "device":
            from r2d2_tpu_torch.replay.device_sum_tree import DeviceSumTree

            # the float32 twin of the host tree on the card: ingestion and
            # retirement keep it in step (_tree_write); the superstep samples
            # and writes priorities back on it
            self.attach_device_tree(DeviceSumTree(cfg.num_sequences, cfg.prio_exponent,
                                                  cfg.is_exponent, device=self.device))
        nb = cfg.num_blocks
        self.stores: Dict[str, torch.Tensor] = {
            k: torch.zeros((nb, *shape), dtype=dt, device=self.device)
            for k, (shape, dt) in store_field_specs(cfg).items()
        }

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.stores.values())

    # ------------------------------------------------------------------ add

    @staticmethod
    def pad_block_fields(cfg: R2D2Config, block: Block) -> Dict[str, np.ndarray]:
        """Every block field padded with zeros to its store-slot shape, on
        the host, in the store's dtype (bfloat16 carries as uint16 bits)."""
        S, slot, bl = cfg.seqs_per_block, cfg.block_slot_len, cfg.block_length

        def pad(a, length, dtype):
            out = np.zeros((length, *a.shape[1:]), dtype)
            out[: len(a)] = a
            return out

        out = {
            "obs": pad(block.obs, slot, np.uint8),
            "last_action": pad(block.last_action.astype(np.int32), slot, np.int32),
            "last_reward": pad(block.last_reward, slot, np.float32),
            "action": pad(block.action.astype(np.int32), bl, np.int32),
            "n_step_reward": pad(block.n_step_reward, bl, np.float32),
            "gamma": pad(block.gamma, bl, np.float32),
            "hidden": pad(to_state_host(block.hidden, cfg.state_dtype), S,
                          state_host_dtype(cfg.state_dtype)),
            "burn_in": pad(block.burn_in_steps, S, np.int32),
            "learning": pad(block.learning_steps, S, np.int32),
            "forward": pad(block.forward_steps, S, np.int32),
        }
        if cfg.num_tasks > 1:
            # the block's task broadcast per sequence (store_field_specs'
            # multi-task field)
            out["task"] = np.full((S,), block.task, np.int32)
        return out

    def add_block(self, block: Block, priorities: np.ndarray,
                  episode_reward: Optional[float]) -> None:
        vals = {k: state_tensor(v) for k, v in self.pad_block_fields(self.cfg, block).items()}
        with self.lock:
            # data first, accounting last: a malformed block raises before
            # the tree or the pointer move
            ptr = self.block_ptr
            for k, t in self.stores.items():
                t[ptr].copy_(vals[k])
            self._account_add(block.num_sequences, int(block.learning_steps.sum()),
                              priorities, episode_reward)

    def add_blocks_batch(self, fields: Dict[str, torch.Tensor], num_seq: np.ndarray,
                         learning_totals: np.ndarray, priorities: np.ndarray,
                         episode_rewards: np.ndarray, dones: np.ndarray) -> None:
        """Write E collector-packed blocks (collect.py) as one contiguous
        slab per field. `fields` are (E, ...) device tensors keyed as the
        stores; the rest are small host arrays for the tree and the
        counters. episode_rewards[i] counts only where dones[i]."""
        E = len(num_seq)
        if E > self.cfg.num_blocks:
            raise ValueError(f"{E} blocks per batch exceeds store of {self.cfg.num_blocks} slots")
        with self.lock:
            start = self._reserve_contiguous(E)
            for k, t in self.stores.items():
                t[start:start + E].copy_(fields[k])
            self._account_blocks(num_seq, learning_totals, priorities, episode_rewards, dones)

    # --------------------------------------------------------------- sample

    def _draw_sample_idx(self, rng: np.random.Generator) -> SampleIdx:
        """One tree draw as SampleIdx. Caller holds self.lock."""
        b, s, idxes, is_weights = self._draw(rng)
        return SampleIdx(b=b.astype(np.int32), s=s.astype(np.int32), is_weights=is_weights,
                         idxes=idxes, old_ptr=self.block_ptr, env_steps=self.env_steps,
                         old_advances=self.ptr_advances)

    def sample_indices(self, rng: np.random.Generator) -> SampleIdx:
        """A tree draw only: the kilobyte an update ships."""
        with self.lock:
            return self._draw_sample_idx(rng)

    def sample_and_run(self, rng: np.random.Generator, k: int, fn: Callable):
        """Draw k coordinate sets and dispatch fn(stores, draws) under one
        lock hold (the K-update dispatch): no add can retarget a drawn slot
        before the dispatch's gathers run. -> (draws, fn's result)."""
        with self.lock:
            draws = [self._draw_sample_idx(rng) for _ in range(k)]
            return draws, fn(self.stores, draws)

    def superstep_run(self, fn: Callable):
        """Dispatch a superstep under one lock hold (priority_plane="device"):
        fn(stores, tree, num_seq_store) -> (tree_out, rest). The output
        tree is installed before the lock is released, so every later
        ingestion write is issued after the superstep. -> rest."""
        with self.lock:
            nss = torch.from_numpy(self.num_seq_store).to(self.device)
            tree_out, rest = fn(self.stores, self.dtree.tree, nss)
            self.dtree.swap(tree_out)
            return rest

    def run_with_stores(self, fn: Callable):
        """fn(stores) under the buffer lock: every reader of the stores
        dispatches through here."""
        with self.lock:
            return fn(self.stores)
