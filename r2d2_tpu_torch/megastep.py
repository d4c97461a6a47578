"""Dispatches that keep the host out of the learner's loop (port of
r2d2_tpu/megastep.py, the single-card parts).

The fused megastep (``--mode fused``): one dispatch runs K updates gathered
from the device store, one collection chunk (collect.make_collect_core)
with the parameters the dispatch began with, and the slab write of the
chunk's E blocks into the store; the host's per-dispatch work is sum-tree
bookkeeping over a few kilobytes, read back one dispatch late
(FusedSystemRunner). PyTorch updates the online network in place, so the
chunk is collected first, into fields of its own, with the entry
parameters; the K updates then gather from the store as it was, and the
slab write is issued after them. The slots the slab overwrites were
reserved and retired before the draws (ReplayControlPlane.
_reserve_advance), so no update reads them.

The priority superstep (priority_plane="device"): N dispatches of K updates
each, with stratified sampling, IS weights, the store gather, the update
and the priority write-back all on the card against the device sum tree
(replay/device_sum_tree.py). The host re-enters every N*K updates, for
ingestion, metrics and snapshots, instead of drawing before each dispatch
and draining priorities after it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.collect import CollectDraws, default_chunk_len, make_collect_core
from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.learner import (
    TrainState,
    finish_read_back,
    make_fused_multi_train_step,
    make_multi_update_core,
    start_read_back,
)
from r2d2_tpu_torch.replay import device_sum_tree as dst


def make_megastep(cfg: R2D2Config, fn_env, num_envs: int, chunk_len: int, num_updates: int):
    """Build the fused dispatch:

      mega(state, stores, env_state, epsilons, draws, b, s, w, ptr0) ->
        (state, metrics, priorities (K, B),
         (chunk_prios, num_seq, sizes, dones, ep_rewards), next_env_state)

    b / s / w are (K, B) coordinates drawn on the host against the tree;
    ptr0 is the first of the E contiguous slots reserved for the chunk.
    The same as make_fused_multi_train_step on the coordinates, then the
    collector with the entry parameters and the same draws, then
    DeviceReplayBuffer.add_blocks_batch. Nothing in it reads back to the
    host."""
    collect_core = make_collect_core(cfg, fn_env, num_envs, chunk_len)
    multi_core = make_multi_update_core(cfg, num_updates)

    def mega(state: TrainState, stores, env_state, epsilons, draws, b, s, w, ptr0: int):
        # collected first, with the entry parameters, into its own fields
        fields, chunk_prios, num_seq, sizes, dones, ep_rewards, fresh = collect_core(
            state.net, env_state, epsilons, draws)
        # the updates gather from the store before the slab lands on it
        state, metrics, priorities = multi_core(state, stores, b, s, w)
        for k, t in stores.items():
            t[ptr0:ptr0 + num_envs].copy_(fields[k])
        return (state, metrics, priorities, (chunk_prios, num_seq, sizes, dones, ep_rewards),
                fresh)

    return mega


class FusedSystemRunner:
    """Drives the megastep against a DeviceReplayBuffer (the Trainer's fused
    mode goes through here). Per dispatch:

    1. under the replay lock: reserve the chunk's E slots (retiring their
       blocks and moving the pointer past them), draw K x B coordinates,
       dispatch the megastep;
    2. start the read-backs of the K priority rows and of the chunk's
       bookkeeping, and collect the previous dispatch's: the chunk's
       accounting lands at its reserved slots, then each priority row under
       its draw's staleness window.

    Both read-backs are one dispatch late, so the host never waits for the
    dispatch it has just issued. samples_per_insert > 0 decides per
    dispatch whether to collect, from the consumed and inserted counters;
    else every collect_every-th dispatch collects, the others run the
    K-update dispatch alone."""

    def __init__(self, cfg: R2D2Config, device, fn_env, replay, epsilons: torch.Tensor,
                 env_state, draws: CollectDraws, collect_every: int = 1,
                 chunk_len: Optional[int] = None,
                 sample_rng: Optional[np.random.Generator] = None,
                 samples_per_insert: float = 0.0):
        self.cfg = cfg
        self.replay = replay
        self.E = cfg.num_actors
        self.K = cfg.updates_per_dispatch
        self.chunk = int(chunk_len or default_chunk_len(cfg))
        if cfg.max_episode_steps > self.chunk:
            raise ValueError(
                f"fused megastep: max_episode_steps={cfg.max_episode_steps} exceeds the "
                f"collection chunk ({self.chunk}); episodes would be truncated at every "
                "chunk and their tails never collected. Size block_length >= "
                "max_episode_steps or use collector='device' with the threaded/inline "
                "modes (cross-chunk episode carry)."
            )
        # between a draw and its write-back (one dispatch later) at most two
        # chunks land, each advancing the ring by E plus a wrap skip below E;
        # a full lap would alias the pointer window
        chunks_between = 2 if collect_every == 1 or samples_per_insert > 0 else 1
        max_advance = chunks_between * (2 * self.E - 1)
        if max_advance >= cfg.num_blocks:
            raise ValueError(
                f"store too small for deferred priorities: {cfg.num_blocks} block slots "
                f"but up to {max_advance} can be overwritten between a draw and its "
                f"application (E={self.E}); grow buffer_capacity or reduce num_actors")
        if collect_every < 1:
            raise ValueError("collect_every must be >= 1")
        self.collect_every = collect_every
        self.samples_per_insert = samples_per_insert
        self._consumed = 0
        self._inserted0 = replay.env_steps
        self._dispatch_count = 0
        self.total_env_steps = 0
        self._pending = None        # the deferred (priorities, draws) read-back
        self._pending_chunk = None  # the deferred (ptr0, chunk bookkeeping)
        self.replay_rng = sample_rng if sample_rng is not None else np.random.default_rng(0)
        self.device = torch.device(device)
        self.epsilons = epsilons
        self.env_state = env_state
        self.draws = draws
        self._mega = make_megastep(cfg, fn_env, self.E, self.chunk, self.K)
        self._multi = make_fused_multi_train_step(cfg, self.K)

    def _dispatch(self, state: TrainState, collect: bool):
        replay = self.replay
        ptr0 = chunk = None
        with replay.lock:
            if collect:
                # reserve before drawing: the draws can target neither the
                # chunk's slots nor produce rows the window mask would miss
                ptr0 = replay._reserve_advance(self.E)
            draws = [replay._draw_sample_idx(self.replay_rng) for _ in range(self.K)]
            b, s, w = (torch.from_numpy(np.stack([getattr(d, f) for d in draws])).to(self.device)
                       for f in ("b", "s", "is_weights"))
            if collect:
                state, m, prios, chunk, self.env_state = self._mega(
                    state, replay.stores, self.env_state, self.epsilons, self.draws,
                    b, s, w, ptr0)
            else:
                state, m, prios = self._multi(state, replay.stores, b, s, w)
        return state, m, prios, draws, ptr0, chunk

    def step(self, state: TrainState):
        """One dispatch (K updates, and the chunk on a collecting one) ->
        (state, metrics, env steps recorded). With the read-backs one
        dispatch late, `recorded` is the previous chunk's (0 on the first)."""
        self._consumed += self.K * self.cfg.batch_size * self.cfg.learning_steps
        if self.samples_per_insert > 0:
            inserted = max(self.replay.env_steps - self._inserted0, 1)
            collect = self._consumed / inserted >= self.samples_per_insert
        else:
            collect = self._dispatch_count % self.collect_every == 0
        self._dispatch_count += 1
        state, m, prios, draws, ptr0, chunk = self._dispatch(state, collect)
        recorded = 0
        prev_chunk = self._pending_chunk
        self._pending_chunk = (ptr0, [start_read_back(t) for t in chunk]) if collect else None
        if prev_chunk is not None:
            recorded = self._drain_chunk(prev_chunk)
        prev, self._pending = self._pending, (start_read_back(prios), draws)
        if prev is not None:
            self._drain(prev)
        return state, m, recorded

    def _drain_chunk(self, pending) -> int:
        ptr0, started = pending
        chunk_prios, num_seq, sizes, dones, ep_rewards = map(finish_read_back, started)
        # episode-aligned chunks: every recorded transition is a learning step
        with self.replay.lock:
            self.replay._account_blocks_at(ptr0, num_seq, sizes, chunk_prios, ep_rewards, dones)
        recorded = int(sizes.sum())
        self.total_env_steps += recorded
        return recorded

    def _drain(self, pending) -> None:
        started, draws = pending
        prios = finish_read_back(started)
        for row, d in zip(prios, draws):
            self.replay.update_priorities(d.idxes, row, d.old_ptr, d.old_advances)

    def finish(self) -> int:
        """Apply the last read-backs (the chunk's accounting first, then the
        priorities); call once when the loop stops. -> the env steps the
        last chunk recorded."""
        recorded = 0
        pending_chunk, self._pending_chunk = self._pending_chunk, None
        if pending_chunk is not None:
            recorded = self._drain_chunk(pending_chunk)
        pending, self._pending = self._pending, None
        if pending is not None:
            self._drain(pending)
        return recorded


def superstep_generators(seed: int, counter: int, num_dispatches: int, device) -> List[torch.Generator]:
    """The N generators of superstep number `counter`, one per dispatch in
    dispatch order, each seeded as a pure function of (seed, counter, d):
    a resume at step c*N*K derives superstep c's draws again with nothing
    carried. Superstep-N on these equals N superstep-1 calls, the d-th on
    the d-th generator."""
    gens = []
    for d in range(num_dispatches):
        word = np.random.SeedSequence([seed, counter, d]).generate_state(2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed(int(word[0]) << 31 ^ int(word[1]))
        gens.append(g)
    return gens


def superstep_uniforms(generators: List[torch.Generator], num_updates: int, batch: int,
                       device) -> torch.Tensor:
    """(N, K, B) float32 uniforms of the N dispatches' K stratified draws,
    drawn on `device` from one generator per dispatch."""
    return torch.stack([
        torch.rand((num_updates, batch), generator=g, device=device, dtype=torch.float32)
        for g in generators
    ])


def make_priority_superstep(cfg: R2D2Config, num_dispatches: int, num_updates: int):
    """Build the single-card superstep:

      superstep(state, stores, tree, num_seq_store, uniforms) ->
        (state, tree', metrics of the last update)

    `tree` is the DeviceSumTree's flat float32 tensor, `num_seq_store` the
    (num_blocks,) per-slot sequence counts on the card (the zero-leaf
    clamp's input), `uniforms` (N, K, B) the strata's draws
    (superstep_uniforms). Semantics, as the JAX package's:

    - the K draws of a dispatch are made against the tree at dispatch
      entry; the weights come from the unclamped sampled leaves, then s is
      clamped by num_seq_store; the K updates' priorities are written back
      after the K updates, row by row (the last write of a leaf wins);
    - dispatch d+1 samples the tree dispatch d left, so superstep-N on
      uniforms u equals N superstep-1 calls on u[d:d+1].

    Nothing in it reads back to the host."""
    multi_core = make_multi_update_core(cfg, num_updates)
    L = dst.tree_layers(cfg.num_sequences)
    S = cfg.seqs_per_block

    def superstep(state: TrainState, stores, tree, num_seq_store, uniforms):
        if uniforms.shape[:2] != (num_dispatches, num_updates):
            raise ValueError(f"uniforms {tuple(uniforms.shape)} for a superstep of "
                             f"{num_dispatches} x {num_updates}")
        metrics = None
        nss = num_seq_store.to(tree.device, torch.int64)
        for d in range(num_dispatches):
            leaf = torch.stack([dst.tree_descend(tree, L, u) for u in uniforms[d]])
            w = torch.stack([dst.is_weights(tree, L, li, cfg.is_exponent) for li in leaf])
            b = leaf // S
            s = torch.minimum(leaf % S, torch.clamp(nss[b] - 1, min=0))
            state, metrics, prios = multi_core(state, stores, b, s, w)
            idxes = b * S + s  # the clamped global slots, as the host drain's
            for k in range(num_updates):
                tree = dst.tree_update(tree, L, idxes[k], prios[k], cfg.prio_exponent)
        return state, tree, metrics

    return superstep
