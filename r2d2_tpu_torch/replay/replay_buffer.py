"""Central sequence-prioritized replay, host data plane (port of
r2d2_tpu/replay/replay_buffer.py).

Every block field lives in one preallocated numpy array; a batch is one
gather per field, giving fixed-shape (batch, seq_len) windows with clamped
rows: by default the native core's memcpy gather
(``_native/replay_core.cpp`` ``gather_windows``, OpenMP over the windows,
the interpreter lock released), else (``use_native_replay=False``) a numpy
fancy index. Both give the same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay.block import Block, state_host_dtype, to_state_host
from r2d2_tpu_torch.replay.control_plane import ReplayControlPlane


@dataclasses.dataclass
class SampledBatch:
    """Fixed-shape training batch (host numpy)."""

    obs: np.ndarray            # (B, seq_len, *obs_shape) uint8
    last_action: np.ndarray    # (B, seq_len) uint8
    last_reward: np.ndarray    # (B, seq_len) float32
    hidden: np.ndarray         # (B, 2, H) state dtype's host storage (block.py)
    action: np.ndarray         # (B, L) int32
    n_step_reward: np.ndarray  # (B, L) float32
    gamma: np.ndarray          # (B, L) float32
    burn_in_steps: np.ndarray  # (B,) int32
    learning_steps: np.ndarray # (B,) int32
    forward_steps: np.ndarray  # (B,) int32
    is_weights: np.ndarray     # (B,) float32
    idxes: np.ndarray          # (B,) int64 sequence slots, for priority updates
    old_ptr: int               # block pointer at sample time (staleness check)
    env_steps: int
    old_advances: Optional[int] = None
    # (B,) int32 per-sequence task ids, set on multi-task configs only: an
    # attribute, not a field, so a single-task batch keeps its fields
    task = None


class ReplayBuffer(ReplayControlPlane):
    def __init__(self, cfg: R2D2Config):
        super().__init__(cfg)
        S = cfg.seqs_per_block
        nb, slot = cfg.num_blocks, cfg.block_slot_len
        self.obs_store = np.zeros((nb, slot, *cfg.obs_shape), dtype=np.uint8)
        self.last_action_store = np.zeros((nb, slot), dtype=np.uint8)
        self.last_reward_store = np.zeros((nb, slot), dtype=np.float32)
        self.action_store = np.zeros((nb, cfg.block_length), dtype=np.uint8)
        self.n_step_reward_store = np.zeros((nb, cfg.block_length), dtype=np.float32)
        self.gamma_store = np.zeros((nb, cfg.block_length), dtype=np.float32)
        # the state dtype: float32, or bf16 bits under precision="bf16"
        self.hidden_store = np.zeros((nb, S, 2, cfg.hidden_dim),
                                     dtype=state_host_dtype(cfg.state_dtype))
        self.burn_in_store = np.zeros((nb, S), dtype=np.int32)
        self.learning_store = np.zeros((nb, S), dtype=np.int32)
        self.forward_store = np.zeros((nb, S), dtype=np.int32)
        # one task id per block (one actor collects one task), beside the
        # native core's stores; read by sampling only on multi-task configs
        self.task_store = np.zeros((nb,), dtype=np.int32)

    def _write_block_locked(self, block: Block, ptr: int) -> None:
        S = self.cfg.seqs_per_block
        steps = block.stored_steps
        self.obs_store[ptr, :steps] = block.obs
        self.last_action_store[ptr, :steps] = block.last_action
        self.last_reward_store[ptr, :steps] = block.last_reward
        T = len(block.action)
        self.action_store[ptr, :T] = block.action
        self.n_step_reward_store[ptr, :T] = block.n_step_reward
        self.gamma_store[ptr, :T] = block.gamma
        ns = block.num_sequences
        self.hidden_store[ptr, :ns] = to_state_host(block.hidden, self.cfg.state_dtype)
        self.burn_in_store[ptr, :S] = 0
        self.learning_store[ptr, :S] = 0
        self.forward_store[ptr, :S] = 0
        self.burn_in_store[ptr, :ns] = block.burn_in_steps
        self.learning_store[ptr, :ns] = block.learning_steps
        self.forward_store[ptr, :ns] = block.forward_steps
        self.task_store[ptr] = block.task

    def add_block(
        self, block: Block, priorities: np.ndarray, episode_reward: Optional[float]
    ) -> None:
        """Write one block and refresh its leaves; `priorities` is padded to
        seqs_per_block. Data first, accounting last: a malformed block
        raises before the tree or the pointer move."""
        with self.lock:
            self._write_block_locked(block, self.block_ptr)
            self._account_add(
                block.num_sequences, int(block.learning_steps.sum()), priorities, episode_reward
            )

    def add_blocks_batch(self, items) -> None:
        """Write (block, priorities, episode_reward) triples in order under
        one lock acquisition, as add_block would one by one (the live
        loop's ingest bridge drains a burst this way)."""
        with self.lock:
            for block, priorities, episode_reward in items:
                self._write_block_locked(block, self.block_ptr)
                self._account_add(block.num_sequences, int(block.learning_steps.sum()),
                                  priorities, episode_reward)

    def sample_batch(self, rng: np.random.Generator) -> SampledBatch:
        """Draw a fixed-shape batch by stratified prioritized sampling."""
        cfg = self.cfg
        L = cfg.learning_steps
        with self.lock:
            b, s, idxes, is_weights = self._draw(rng)
            burn = self.burn_in_store[b, s]
            learn = self.learning_store[b, s]
            fwd = self.forward_store[b, s]
            first_burn = self.burn_in_store[b, 0]
            start = first_burn + s * L  # buffer coords of learning start
            win_start = start - burn

            if self.native is not None:
                g = self.native.gather_windows
                T = cfg.seq_len
                obs = g(self.obs_store, b, win_start, T)
                last_action = g(self.last_action_store, b, win_start, T)
                last_reward = g(self.last_reward_store, b, win_start, T)
                lstart = s * L
                action = g(self.action_store, b, lstart, L)
                n_step_reward = g(self.n_step_reward_store, b, lstart, L)
                gamma = g(self.gamma_store, b, lstart, L)
            else:
                t = np.arange(cfg.seq_len)
                rows = win_start[:, None] + t[None, :]
                np.clip(rows, 0, cfg.block_slot_len - 1, out=rows)
                bcol = b[:, None]
                tl = np.arange(L)
                lrows = s[:, None] * L + tl[None, :]
                np.clip(lrows, 0, cfg.block_length - 1, out=lrows)
                obs = self.obs_store[bcol, rows]
                last_action = self.last_action_store[bcol, rows]
                last_reward = self.last_reward_store[bcol, rows]
                action = self.action_store[bcol, lrows]
                n_step_reward = self.n_step_reward_store[bcol, lrows]
                gamma = self.gamma_store[bcol, lrows]

            out = SampledBatch(
                obs=obs,
                last_action=last_action,
                last_reward=last_reward,
                hidden=self.hidden_store[b, s],
                action=action.astype(np.int32),
                n_step_reward=n_step_reward,
                gamma=gamma,
                burn_in_steps=burn.astype(np.int32),
                learning_steps=learn.astype(np.int32),
                forward_steps=fwd.astype(np.int32),
                is_weights=is_weights,
                idxes=idxes,
                old_ptr=self.block_ptr,
                env_steps=self.env_steps,
                old_advances=self.ptr_advances,
            )
            if cfg.num_tasks > 1:
                out.task = self.task_store[b]
            return out
