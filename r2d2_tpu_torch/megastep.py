"""Dispatches that keep the host out of the learner's loop (port of
r2d2_tpu/megastep.py).

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

Over dp shards: make_sharded_megastep (each shard collects its pinned env
slots and writes its own ring; the K updates are the sharded step's, the
gradients summed), ShardedFusedRunner on the sharded plane and
MultiHostFusedRunner across processes, both on the _DeferredDrainRunner
protocol FusedSystemRunner uses; make_sharded_priority_superstep, a device
sum tree a shard.
"""

from __future__ import annotations

import contextlib
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
    make_sharded_fused_multi_train_step,
    make_sharded_gather_step,
    make_sharded_train_step,
    start_read_back,
)
from r2d2_tpu_torch.replay import device_sum_tree as dst


def make_megastep(cfg: R2D2Config, fn_env, num_envs: int, chunk_len: int, num_updates: int,
                  mesh=None):
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
    multi_core = make_multi_update_core(cfg, num_updates, mesh)

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


class _DeferredDrainRunner:
    """The deferred-drain protocol shared by the fused runners (the JAX
    package's class of the same name): samples_per_insert pacing on the
    actual consumed and inserted counters, the read-backs of the priorities
    and of the chunk's bookkeeping one dispatch late, the aliasing guard,
    finish(). A subclass supplies

      _dispatch(state, collect) -> (state, metrics, priorities, draws,
                                    token, chunk)
        the reservation, the draws and the dispatch under the plane's
        locks (token: the reserved slots; chunk: the bookkeeping tensors;
        both None when collect is False);
      _account_chunk(token, arrays) -> env steps recorded
        a drained chunk's accounting into the tree(s);
      _apply_priorities(draw, row)
        one priority row under its draw's staleness stamps."""

    def _init_protocol(self, cfg: R2D2Config, replay, collect_every: int,
                       samples_per_insert: float, sample_rng, chunk_len, ring_slots: int,
                       ring_envs: int) -> None:
        """ring_slots / ring_envs: one ring's slots and writer batch (the
        whole store on one card; one shard's on a dp plane)."""
        self.cfg = cfg
        self.replay = replay
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
        max_advance = chunks_between * (2 * ring_envs - 1)
        if max_advance >= ring_slots:
            raise ValueError(
                f"store too small for deferred priorities: {ring_slots} block slots per "
                f"ring but up to {max_advance} can be overwritten between a draw and its "
                f"application (ring E={ring_envs}); grow buffer_capacity or reduce "
                "num_actors")
        if collect_every < 1:
            raise ValueError("collect_every must be >= 1")
        self.collect_every = collect_every
        self.samples_per_insert = samples_per_insert
        self._consumed = 0
        self._inserted0 = replay.env_steps
        self._dispatch_count = 0
        self.total_env_steps = 0
        self._pending = None        # the deferred (priorities, draws) read-back
        self._pending_chunk = None  # the deferred (token, chunk bookkeeping)
        self.replay_rng = sample_rng if sample_rng is not None else np.random.default_rng(0)

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
        state, m, prios, draws, token, chunk = self._dispatch(state, collect)
        recorded = 0
        prev_chunk = self._pending_chunk
        self._pending_chunk = (token, [start_read_back(t) for t in chunk]) if collect else None
        if prev_chunk is not None:
            recorded = self._drain_chunk(prev_chunk)
        prev, self._pending = self._pending, (start_read_back(prios), draws)
        if prev is not None:
            self._drain(prev)
        return state, m, recorded

    def _drain_chunk(self, pending) -> int:
        token, started = pending
        recorded = self._account_chunk(token, tuple(map(finish_read_back, started)))
        self.total_env_steps += recorded
        return recorded

    def _drain(self, pending) -> None:
        started, draws = pending
        for row, d in zip(finish_read_back(started), draws):
            self._apply_priorities(d, row)

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


class FusedSystemRunner(_DeferredDrainRunner):
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
                 samples_per_insert: float = 0.0, mesh=None):
        self.E = cfg.num_actors
        self._init_protocol(cfg, replay, collect_every, samples_per_insert, sample_rng,
                            chunk_len, ring_slots=cfg.num_blocks, ring_envs=self.E)
        self.device = torch.device(device)
        self.epsilons = epsilons
        self.env_state = env_state
        self.draws = draws
        self._mega = make_megastep(cfg, fn_env, self.E, self.chunk, self.K, mesh)
        self._multi = make_fused_multi_train_step(cfg, self.K, mesh)

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

    def _account_chunk(self, ptr0: int, arrays) -> int:
        chunk_prios, num_seq, sizes, dones, ep_rewards = arrays
        # episode-aligned chunks: every recorded transition is a learning step
        with self.replay.lock:
            self.replay._account_blocks_at(ptr0, num_seq, sizes, chunk_prios, ep_rewards, dones)
        return int(sizes.sum())

    def _apply_priorities(self, d, row) -> None:
        self.replay.update_priorities(d.idxes, row, d.old_ptr, d.old_advances)


# ---------------------------------------------------------------------------
# the fused megastep over dp shards
# ---------------------------------------------------------------------------


def env_rows(env_state, rows: slice, device):
    """Rows `rows` of an env state (a NamedTuple of (E, ...) tensors), on
    `device`."""
    return type(env_state)(*(t[rows].to(device) for t in env_state))


def env_concat(states, device):
    """Per-shard env states concatenated along their env rows on `device`."""
    return type(states[0])(*(torch.cat([t.to(device) for t in ts]) for ts in zip(*states)))


def make_sharded_megastep(cfg: R2D2Config, fn_env, devices, num_envs: int, chunk_len: int,
                          num_updates: int, is_from_priorities: bool = False,
                          collectives=None, mesh=None):
    """The fused dispatch over the n dp shards of `devices` (all of them,
    or one process's): per shard, a collection chunk of its E/dp pinned env
    slots with the entry parameters, then K sharded updates, each shard
    gathering from its own store and the gradients summed, then each
    shard's slab write of its E/dp blocks at its own reserved slots:

      mega(state, stores, env_states, epsilons, draws, policies, b, s, w,
           starts) -> (state, metrics, priorities (K, n, B/dp),
                       (chunk_prios, num_seq, sizes, dones, ep_rewards)
                       each (n*E/dp, ...) on the first shard's device,
                       next env_states)

    env_states, epsilons, draws (CollectDraws) and policies (the network on
    each shard's device, holding the entry parameters) are per shard;
    b / s / w (K, n, B/dp) the draws, local to each shard (w raw priorities
    with is_from_priorities); starts the shards' first reserved slots.
    Shard s always collects env rows [s*E/dp, (s+1)*E/dp) and writes to
    its own ring, as in the JAX package."""
    n = len(devices)
    E_local = num_envs // n
    collect_core = make_collect_core(cfg, fn_env, E_local, chunk_len)
    multi = make_sharded_fused_multi_train_step(cfg, num_updates, is_from_priorities,
                                                collectives, mesh=mesh)

    def mega(state: TrainState, stores, env_states, epsilons, draws, policies, b, s, w, starts):
        outs = [collect_core(policies[i], env_states[i], epsilons[i], draws[i])
                for i in range(n)]
        state, metrics, prios = multi(state, stores, b, s, w)
        for st, out, p0 in zip(stores, outs, starts):
            for k, t in st.items():
                t[p0:p0 + E_local].copy_(out[0][k])
        home = devices[0]
        chunk = tuple(torch.cat([o[j].to(home) for o in outs]) for j in range(1, 6))
        return state, metrics, prios, chunk, [o[6] for o in outs]

    return mega


class _ShardedRunnerBase(_DeferredDrainRunner):
    """The env slots, draws and policies of the dp runners: shard i (of the
    n this process holds) collects env rows [i*E/dp, (i+1)*E/dp) on its
    device with a CollectDraws of its own, and acts with a copy of the
    network on its device (the state's own where the devices agree)."""

    def _init_shards(self, cfg: R2D2Config, fn_env, devices, E: int, dp: int,
                     collectives=None, is_from_priorities=False, mesh=None):
        if E % dp:
            raise ValueError(f"num_actors {E} not divisible by dp {dp}")
        self.devices = list(devices)
        self.E_local = E // dp
        self._policies: dict = {}
        self._mega = make_sharded_megastep(cfg, fn_env, self.devices, len(self.devices) *
                                           self.E_local, self.chunk, self.K,
                                           is_from_priorities, collectives, mesh)
        self._multi = make_sharded_fused_multi_train_step(cfg, self.K, is_from_priorities,
                                                          collectives, mesh=mesh)

    def _policies_for(self, state: TrainState):
        home = next(state.net.parameters()).device
        out = []
        for dev in self.devices:
            if dev == home:
                out.append(state.net)
                continue
            pol = self._policies.get(dev)
            if pol is None:
                import copy

                pol = self._policies[dev] = copy.deepcopy(state.net).to(dev).requires_grad_(False)
            else:
                with torch.no_grad():
                    for a, b in zip(pol.parameters(), state.net.parameters()):
                        a.copy_(b)
            out.append(pol)
        return out

    def _mega_call(self, state, stores, b, s, w, starts):
        state, m, prios, chunk, self.env_states = self._mega(
            state, stores, self.env_states, self.epsilons, self.draws,
            self._policies_for(state), b, s, w, starts)
        return state, m, prios, chunk

    def _account_local(self, shards, starts, arrays) -> int:
        chunk_prios, num_seq, sizes, dones, ep_rewards = arrays
        El = self.E_local
        recorded = 0
        for i, shard in enumerate(shards):
            sl = slice(i * El, (i + 1) * El)
            with shard.lock:
                # r2d2: disable=host-sync-in-hot-path  (starts are host slot numbers)
                shard._account_blocks_at(int(starts[i]), num_seq[sl], sizes[sl],
                                         chunk_prios[sl], ep_rewards[sl], dones[sl])
            recorded += int(sizes[sl].sum())  # r2d2: disable=host-sync-in-hot-path  (the chunk's host read-back)
        return recorded

    def env_state_on(self, device):
        """The shards' env states as one (E, ...) state on `device` (the
        collector's form, for handing the episodes back)."""
        return env_concat(self.env_states, device)


class ShardedFusedRunner(_ShardedRunnerBase):
    """The fused megastep against a ShardedDeviceReplay (the multi-card
    FusedSystemRunner): under every shard's lock, each shard reserves its
    E/dp slots, K per-shard draw sets are made, one dispatch; the next
    step drains the previous chunk's accounting into each shard's tree at
    its reserved slots and the previous priorities under each shard's
    staleness window. `env_state` and `epsilons` are the collector's (E,)
    rows, split over the shards; `draws_seed` seeds each shard's
    CollectDraws (shard i: SeedSequence((draws_seed, i)))."""

    def __init__(self, cfg: R2D2Config, fn_env, replay, epsilons: torch.Tensor, env_state,
                 draws_seed: int, collect_every: int = 1, chunk_len: Optional[int] = None,
                 sample_rng: Optional[np.random.Generator] = None,
                 samples_per_insert: float = 0.0, mesh=None):
        dp = replay.dp
        E = cfg.num_actors
        self._init_protocol(cfg, replay, collect_every, samples_per_insert, sample_rng,
                            chunk_len, ring_slots=replay.blocks_per_shard,
                            ring_envs=E // max(dp, 1))
        devices = [replay.mesh.devices[g] for g in replay.local_ids]
        self._init_shards(cfg, fn_env, devices, E, dp, mesh=mesh)
        El = self.E_local
        self.epsilons = [epsilons[i * El:(i + 1) * El].to(d) for i, d in enumerate(devices)]
        self.env_states = [env_rows(env_state, slice(i * El, (i + 1) * El), d)
                           for i, d in enumerate(devices)]
        self.draws = [CollectDraws(_seeded(d, draws_seed, i)) for i, d in enumerate(devices)]

    def _dispatch(self, state: TrainState, collect: bool):
        replay = self.replay
        starts = chunk = None
        with replay.lock:
            with contextlib.ExitStack() as locks:
                for sh in replay.shards:
                    locks.enter_context(sh.lock)
                if collect:
                    starts = [sh._reserve_advance(self.E_local) for sh in replay.shards]
                draws = [replay.sample_indices(self.replay_rng, locked=True)
                         for _ in range(self.K)]
            b, s, w = (np.stack([getattr(d, f) for d in draws]) for f in ("b", "s", "is_weights"))
            if collect:
                state, m, prios, chunk = self._mega_call(state, replay.stores, b, s, w, starts)
            else:
                state, m, prios = self._multi(state, replay.stores, b, s, w)
        return state, m, prios, draws, starts, chunk

    def _account_chunk(self, starts, arrays) -> int:
        return self._account_local(self.replay.shards, starts, arrays)

    def _apply_priorities(self, d, row) -> None:
        self.replay.update_priorities(d.idxes, row, d.old_ptrs, d.old_advances)


class MultiHostFusedRunner(_ShardedRunnerBase):
    """The fused megastep over a MultiHostShardedReplay: every process calls
    step() in lockstep (the updates are collective: the gradients summed
    within the process by tree_sum and across processes by a gloo
    all_reduce, learner.make_sharded_train_step); the reservation, the
    draws (replay.sample_global_k: raw priorities, normalised in the step
    by a MIN across processes), the chunk accounting and the priority drain
    touch this process's shards only.

    cfg.num_actors is the global env count, E/dp per shard; global shard g
    collects env rows [g*E/dp, (g+1)*E/dp), its episodes reset from a
    generator seeded (seed, g) and its CollectDraws seeded (seed, 10000+g),
    the same whichever process holds g. samples_per_insert becomes a fixed
    every-n-dispatches cadence here, the same on every process (a ratio on
    process-local counters could make processes disagree about collecting
    and so dispatch different collectives)."""

    def __init__(self, cfg: R2D2Config, fn_env, replay, epsilons, seed: int, collectives,
                 collect_every: int = 1, chunk_len: Optional[int] = None,
                 sample_rng: Optional[np.random.Generator] = None,
                 samples_per_insert: float = 0.0):
        dp = replay.dp
        E = cfg.num_actors
        if samples_per_insert > 0:
            chunk0 = int(chunk_len or default_chunk_len(cfg))
            consumed = cfg.updates_per_dispatch * cfg.batch_size * cfg.learning_steps
            collect_every = max(1, round(samples_per_insert * E * chunk0 / consumed))
            samples_per_insert = 0.0
        self._init_protocol(cfg, replay, collect_every, samples_per_insert, sample_rng,
                            chunk_len, ring_slots=replay.blocks_per_shard,
                            ring_envs=E // max(dp, 1))
        devices = [replay.mesh.devices[g] for g in replay.local_ids]
        self._init_shards(cfg, fn_env, devices, E, dp, collectives, is_from_priorities=True)
        El = self.E_local
        eps = torch.as_tensor(np.asarray(epsilons, np.float32))
        if len(eps) != E:
            raise ValueError(f"epsilons must be the global (E={E},) ladder")
        self.epsilons, self.env_states, self.draws = [], [], []
        for g, d in zip(replay.local_ids, devices):
            self.epsilons.append(eps[g * El:(g + 1) * El].to(d))
            self.env_states.append(fn_env.reset(El, _seeded(d, seed, g), d))
            self.draws.append(CollectDraws(_seeded(d, seed, 10_000 + g)))

    def _dispatch(self, state: TrainState, collect: bool):
        replay = self.replay
        starts = chunk = None
        with replay.lock:
            if collect:
                starts = []
                for sh in replay.shards:
                    with sh.lock:
                        starts.append(sh._reserve_advance(self.E_local))
            (b, s, w), draws = replay.sample_global_k(self.K)
            if collect:
                state, m, prios, chunk = self._mega_call(state, replay.stores, b, s, w, starts)
            else:
                state, m, prios = self._multi(state, replay.stores, b, s, w)
        return state, m, prios, draws, starts, chunk

    def _account_chunk(self, starts, arrays) -> int:
        return self._account_local(self.replay.shards, starts, arrays)

    def _apply_priorities(self, d, row) -> None:
        self.replay.update_priorities(d["idxes"], row, d["old_ptrs"], d["old_advances"])


def _seed_word(key) -> int:
    """A 63-bit torch seed as a pure function of the integers in `key`."""
    word = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
    return int(word[0]) << 31 ^ int(word[1])


def _seeded(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` seeded as a pure function of (seed, stream)."""
    return torch.Generator(device=device).manual_seed(_seed_word([seed, stream]))


def superstep_generators(seed: int, counter: int, num_dispatches: int, device,
                         shard: Optional[int] = None) -> List[torch.Generator]:
    """The N generators of superstep number `counter`, one per dispatch in
    dispatch order, each seeded as a pure function of (seed, counter, d),
    or of (seed, counter, shard, d) for dp shard `shard`'s own stream: a
    resume at step c*N*K derives superstep c's draws again with nothing
    carried. Superstep-N on these equals N superstep-1 calls, the d-th on
    the d-th generator."""
    gens = []
    for d in range(num_dispatches):
        key = [seed, counter, d] if shard is None else [seed, counter, shard, d]
        gens.append(torch.Generator(device=device).manual_seed(_seed_word(key)))
    return gens


def superstep_uniforms(generators: List[torch.Generator], num_updates: int, batch: int,
                       device) -> torch.Tensor:
    """(N, K, B) float32 uniforms of the N dispatches' K stratified draws,
    drawn on `device` from one generator per dispatch."""
    return torch.stack([
        torch.rand((num_updates, batch), generator=g, device=device, dtype=torch.float32)
        for g in generators
    ])


def make_priority_superstep(cfg: R2D2Config, num_dispatches: int, num_updates: int,
                            mesh=None):
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

    The final tree is written back into `tree` (the JAX package donates
    it), which the call returns: the device tree keeps one storage across
    supersteps. Nothing in it reads back to the host."""
    multi_core = make_multi_update_core(cfg, num_updates, mesh)
    L = dst.tree_layers(cfg.num_sequences)
    S = cfg.seqs_per_block

    def superstep(state: TrainState, stores, tree, num_seq_store, uniforms):
        if uniforms.shape[:2] != (num_dispatches, num_updates):
            raise ValueError(f"uniforms {tuple(uniforms.shape)} for a superstep of "
                             f"{num_dispatches} x {num_updates}")
        metrics = None
        entry = tree
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
        return state, entry.copy_(tree), metrics

    return superstep


def make_sharded_priority_superstep(cfg: R2D2Config, mesh, num_dispatches: int,
                                    num_updates: int):
    """Build the dp-sharded superstep (the JAX package's, under shard_map
    over dp):

      superstep(state, stores, trees, num_seq_store, uniforms) ->
        (state, trees', metrics of the last update)

    per shard i: `trees[i]` its DeviceSumTree tensor, `num_seq_store[i]`
    its (blocks per shard,) sequence counts, `uniforms[i]` (N, K, B/dp)
    its strata's draws (superstep_generators(..., shard=i)), all on the
    shard's device. Each shard draws its B/dp sequences from its own tree
    and writes its priorities back to it; the draws' raw priorities go into
    the update, which normalises the IS weights against the minimum over
    every shard (make_sharded_train_step(is_from_priorities=True), JAX's
    pmin), as the host sharded plane weighs them. The same dispatch rules
    as make_priority_superstep: K draws against the dispatch-entry tree,
    K updates, the write-back row by row; dispatch d+1 samples the trees
    dispatch d left."""
    from r2d2_tpu_torch.replay.control_plane import shard_config

    scfg = shard_config(cfg, mesh.dp)
    step = make_sharded_train_step(cfg, is_from_priorities=True, mesh=mesh)
    gather = make_sharded_gather_step(cfg)
    L = dst.tree_layers(scfg.num_sequences)
    S = scfg.seqs_per_block

    def superstep(state: TrainState, stores, trees, num_seq_store, uniforms):
        trees = list(trees)
        n = len(trees)
        for u in uniforms:
            if u.shape[:2] != (num_dispatches, num_updates):
                raise ValueError(f"uniforms {tuple(u.shape)} for a superstep of "
                                 f"{num_dispatches} x {num_updates}")
        nss = [x.to(t.device, torch.int64) for x, t in zip(num_seq_store, trees)]
        metrics = None
        for d in range(num_dispatches):
            bs, ss, ps = [], [], []
            for i in range(n):
                leaf = torch.stack([dst.tree_descend(trees[i], L, u) for u in uniforms[i][d]])
                ps.append(torch.stack([dst.priorities_of(trees[i], L, li) for li in leaf]))
                b = leaf // S
                bs.append(b)
                ss.append(torch.minimum(leaf % S, torch.clamp(nss[i][b] - 1, min=0)))
            prios = []
            for k in range(num_updates):
                state, metrics, p = step(state, gather(stores, [b[k] for b in bs],
                                                       [s[k] for s in ss], [p[k] for p in ps]))
                prios.append(p)
            for i in range(n):
                idxes = bs[i] * S + ss[i]  # the clamped slots, as the host drain's
                for k in range(num_updates):
                    trees[i] = dst.tree_update(trees[i], L, idxes[k], prios[k][i].to(trees[i].device),
                                               cfg.prio_exponent)
        return state, trees, metrics

    return superstep
