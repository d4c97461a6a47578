"""Training orchestrator and CLI (port of r2d2_tpu/train.py).

The main path: catch env -> VectorizedActor (acting through the fused
ε-greedy act tail) -> SequenceAccumulator -> host ReplayBuffer with
sum-tree PER (the native C++ core by default) -> the learner step ->
checkpoint -> evaluate
(``r2d2_tpu_torch.evaluate``). Two run modes:

- ``run_inline``: strict actor/learner alternation, k env steps then one
  update; batches copied from pageable host memory.
- ``run_threaded``: an actor thread and a sampler thread under a
  ``Supervisor`` (restart on a crash, heartbeat, stall watchdog), a queue of
  8 batches and the ``samples_per_insert`` throttle. On the card the
  sampler stages each batch through pinned host buffers and a side stream
  (``learner.PinnedStager``); the acting forward and the update share the
  default stream.

Cadences: publish weights every `publish_interval` updates, actor pull
every `actor_update_interval` env steps, target sync every
`target_net_update_interval` updates (inside the step), a checkpoint every
`save_interval` updates into `checkpoint_dir` (``--resume`` continues from
the latest), a metrics record every `log_interval` seconds (0: every
update) into `metrics_path`, stop at `training_steps`, sampling gated on
`learning_starts`. ``--profile-dir`` traces the updates after the first
(``utils/profiling.py``; the spans ``replay/sample`` (host and device
planes), ``replay/staged_chunk`` (tiered plane), ``learner_update`` and
``fused_megastep`` (fused mode)).

Replay planes (``--replay``): ``host`` ships one batch per update; ``tiered``
(``replay/tiered_store.py``) holds the full-capacity store and stages K
batches at a time (``--updates-per-dispatch K``) through a pinned ring into
two device slabs on a side stream, the K updates of one dispatch running on
one slab while the next is copied (``--set deterministic_staging=true``
stages on the consumer's thread instead, for a reproducible draw stream;
``--set replay_disk_capacity=N --set replay_disk_dir=D`` adds the disk tier
below the host slab, ``--set block_codec=delta-zlib`` compresses its
records); ``device`` (``replay/device_store.py``) holds the store on the
card, each update gathering its windows there from its sample coordinates
(``--updates-per-dispatch K`` per dispatch); with ``--set
priority_plane=device`` the sum tree is on the card too and ``--set
superstep_dispatches=N`` runs N x K updates per host re-entry
(``megastep.make_priority_superstep``).

Data parallelism (``parallel/``): ``--dp N`` splits the batch over N shards
whose gradients are summed before one clipped Adam step. ``--replay sharded``
(``replay/sharded_store.py``; the ``atari_v4_8`` preset's plane) keeps one
device store per shard, each shard gathering its rows from its own;
``--replay host``, ``tiered`` or ``device`` with ``--dp`` splits each batch
over the shards. ``--device`` lists
one device per shard, and may repeat one: ``--device
cuda:0,cuda:0,cuda:0,cuda:0`` runs ``--preset atari_v4_8`` on one card (a
plain ``cuda`` means cuda:0 .. cuda:N-1 and raises when fewer cards are
there). ``--distributed --replay multihost`` (``replay/multihost_store.py``)
joins the process group torchrun's variables describe (gloo) and trains
one model across processes, each owning the shards of its ``--device``
list; rank 0 writes the checkpoints and the metrics file, every rank its
own replay snapshot. ``--tp`` and ``--fsdp`` grow the mesh to (dp, tp,
fsdp), ``--device`` then naming every position: each batch shard runs
through its tp group (``models/tp.py``) and the Adam moments shard over
fsdp (``learner.ShardedAdam``); ``partitioning="manual"`` (the tp x fsdp
default, host plane) also splits the batch over fsdp. ``--resume
--reshard`` re-splits a replay snapshot of another topology
(``replay/reshard.py``); ``Trainer.reshard_live`` does it in process.

Collection on the card: ``--collector device`` (``collect.DeviceCollector``:
policy, env dynamics and block packing over a tensor env core, one chunk
per call) in either mode above, and ``--mode fused`` (``run_fused``: on
the device plane ``megastep.FusedSystemRunner``, on the sharded and
multihost planes ``ShardedFusedRunner`` and ``MultiHostFusedRunner``): one
dispatch runs K updates and a collection chunk, whose blocks land in the
store (each shard's) as one slab.

Preemption: a SIGTERM (delivered by the scheduler, or by ``R2D2_FAULTS=
"trainer.update@5=sigterm"``, utils/faults.py) cuts the run at the next
loop boundary. With ``--snapshot-replay`` the run then writes the replay
snapshot with its mid-run carry (the sampling Generator, the published
parameters, the actor's and envs' episode streams, the deferred priority
write-back), then a finalized checkpoint at the cut step, and the CLI
exits with 85 (utils/supervision.PREEMPT_EXIT_CODE). ``--resume`` then
continues bit for bit: every later update, draw and replay write equals an
uninterrupted run's.

    python -m r2d2_tpu_torch.train --preset atari --env catch --mode threaded \\
        --steps 100 --set checkpoint_dir=runs/ckpt --metrics runs/m.jsonl

trains the atari preset in its own bfloat16 compute (``--set
compute_dtype=float32`` for the reference's float32 numerics; ``--set
precision=bf16`` also stores the replayed carries in bfloat16).

Every backward arm of the JAX package runs: ``--set backward_arm=fused_dwh``
or ``--set backward_arm=ckpt`` forces one, ``--set fused_sequence=false``
trains through the seamless backward, and ``--model-preset xl`` (hidden
2048) resolves to the checkpointed arm under the default residual budget;
in bf16, ``--model-preset wide --set batch_size=96`` resolves to the
fused-dWh arm. Every arm runs in both compute dtypes, at any hidden size.

The long-context path: ``--preset long_context`` trains the multi-ball
memory catch (``memory_catch:10:8:4``, 26x26) through the IMPALA encoder
and the LRU core at seq_len 581 (64/512/5), in bf16 (``--set
compute_dtype=float32`` for float32; ``--set lru_chunk=128`` unrolls the
LRU by chunked matmuls). The LRU launches none of the LSTM kernels.

The procgen path: ``--preset procgen_impala`` trains the procedurally
generated maze (``procmaze``, 64x64x3) through the IMPALA encoder
(16, 32, 32) and the LSTM 512 in bf16, the maze a tensor core on the
Trainer's device (``FnVecEnv`` for the host collector, the core itself for
``--collector device`` / ``--mode fused``); the multi-task family's cores
(``keydoor``, ``drift``, ``banditgrid``) train the same way, and
``r2d2_tpu_torch.sweep --multitask`` trains one learner over them.

runs on the CUDA device; ``--device cpu`` runs the plain versions of the
kernels on the CPU instead.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import queue
import signal
import sys
import threading
import time
import types
from typing import List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.actor import (
    HostEnvPool,
    ParamStore,
    ThreadedHostEnvPool,
    VectorizedActor,
)
from r2d2_tpu_torch.collect import DeviceCollector
from r2d2_tpu_torch.config import (
    PRESETS,
    R2D2Config,
    apply_model_preset,
    parse_overrides,
    resolve_device,
)
from r2d2_tpu_torch.envs import family_factory, make_env
from r2d2_tpu_torch.envs.catch import CatchVecEnv, TensorCatchEnv, catch_params, is_catch_name
from r2d2_tpu_torch.envs.fake import ScriptedFnEnv
from r2d2_tpu_torch.envs.functional import FnVecEnv
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    PinnedStager,
    finish_read_back,
    init_train_state,
    make_batch_train_step,
    make_fused_multi_train_step,
    make_fused_train_step,
    make_gather_step,
    make_sharded_fused_multi_train_step,
    make_sharded_fused_train_step,
    make_sharded_gather_step,
    make_sharded_train_step,
    make_stacked_batch_train_step,
    make_train_step,
    shard_optimizer,
    start_read_back,
)
from r2d2_tpu_torch.megastep import (
    FusedSystemRunner,
    MultiHostFusedRunner,
    ShardedFusedRunner,
    make_priority_superstep,
    make_sharded_priority_superstep,
    superstep_generators,
    superstep_uniforms,
)
from r2d2_tpu_torch.ops.epsilon import epsilon_ladder
from r2d2_tpu_torch.parallel.mesh import make_mesh, parse_devices
from r2d2_tpu_torch.parallel.multihost import (
    Collectives,
    initialize_distributed,
    make_global_mesh,
    process_index,
)
from r2d2_tpu_torch.replay.block import state_tensor
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.multihost_store import MultiHostShardedReplay
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from r2d2_tpu_torch.replay.tiered_store import (
    StagedChunk,
    StagingRing,
    TieredPrefetchPipeline,
    TieredReplayBuffer,
    stage_chunk,
    staged_specs,
)
from r2d2_tpu_torch.utils.checkpoint import (
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)
from r2d2_tpu_torch.utils.faults import (
    fault_point,
    install_from_env,
    total_retries,
    with_retries,
)
from r2d2_tpu_torch.utils.metrics import MetricsLogger
from r2d2_tpu_torch.utils.profiling import (
    TransferTimer,
    span,
    start_trace,
    step_span,
    stop_trace,
)
from r2d2_tpu_torch.utils.supervision import PREEMPT_EXIT_CODE, Supervisor, WorkerStalledError

# threaded mode's batch queue, and the pinned slots beyond it: the
# sampler's pending batch and the one whose copy is being issued
QUEUE_DEPTH = 8
_STAGING_SLOTS = QUEUE_DEPTH + 2


def _build_family_env(cfg: R2D2Config, name: str):
    """The tensor core of a procmaze or multi-task family name, or None."""
    build = family_factory(name)
    return None if build is None else build(cfg.obs_shape, cfg.max_episode_steps, name)


def build_vec_env(cfg: R2D2Config, seed: int = 0, device="cpu"):
    """One vectorized env spanning cfg.num_actors slots: catch on host
    numpy, the tensor cores of procmaze and the multi-task family through
    FnVecEnv on `device`, any other name as a pool of host envs
    (ThreadedHostEnvPool when cfg.env_pool_workers > 0, else the serial
    HostEnvPool)."""
    name = cfg.env_name.lower()
    if is_catch_name(name):
        return CatchVecEnv(
            num_envs=cfg.num_actors, height=cfg.obs_shape[0], width=cfg.obs_shape[1],
            seed=seed, **catch_params(name),
        )
    family_env = _build_family_env(cfg, name)
    if family_env is not None:
        return FnVecEnv(family_env, num_envs=cfg.num_actors, seed=seed, device=device)
    envs = [make_env(cfg, seed=seed + i) for i in range(cfg.num_actors)]
    if cfg.env_pool_workers > 0:
        return ThreadedHostEnvPool(envs, workers=cfg.env_pool_workers)
    return HostEnvPool(envs)


def build_fn_env(cfg: R2D2Config):
    """The tensor env core of the on-device collector: the catch family,
    procmaze, the multi-task family and "scripted[:A]"."""
    name = cfg.env_name.lower()
    if is_catch_name(name):
        return TensorCatchEnv(height=cfg.obs_shape[0], width=cfg.obs_shape[1],
                              **catch_params(name))
    family_env = _build_family_env(cfg, name)
    if family_env is not None:
        return family_env
    if name == "scripted" or name.startswith("scripted:"):
        # "scripted:A" pins the action count (the make_env rule)
        adim = int(name.split(":", 1)[1]) if ":" in name else cfg.action_dim
        return ScriptedFnEnv(obs_shape=cfg.obs_shape, action_dim=adim)
    raise ValueError(
        f"env {cfg.env_name!r} has no tensor core; use collector='host' for "
        "emulator/host-protocol envs"
    )


class _HostPlane:
    """Host numpy replay: one batch drawn, gathered and shipped to the
    device per update (pageable copies inline; the pinned ring and the side
    stream of `learner.PinnedStager` in threaded mode on the card). The
    batch is copied out of the store at sample time, so a queued item never
    goes stale. With a mesh the trainer's step (make_train_step(cfg,
    mesh)) splits the batch's rows over the batch shards: the dp shards,
    or the dp x fsdp ones under partitioning="manual" (ZeRO-2), each
    running through its tp group when tp > 1."""

    steps_per_update = 1

    def __init__(self, tr: "Trainer"):
        self.tr = tr
        self.replay = ReplayBuffer(tr.cfg)
        self.stager: Optional[PinnedStager] = None

    def _draw_and_lift(self, lift_fn):
        with span("replay/sample"):
            b = self.replay.sample_batch(self.tr.sample_rng)

            def lift():
                fault_point("host_plane.h2d")
                return lift_fn(b)

            # a failed copy lifts the already-drawn batch again: a retry
            # never touches the sampling Generator
            return b, with_retries(lift, "host_plane.h2d")

    def sample(self, pipelined: bool = False):
        """One batch, on the device, from pageable host memory (copied out
        of the store at sample time, so pipelined or not is the same)."""
        b, dev = self._draw_and_lift(lambda b: DeviceBatch.from_sampled(b, self.tr.device))
        return dev, None, b.idxes, (b.old_ptr, b.old_advances)

    def sample_staged(self):
        """One batch through the pinned ring and the side stream; the
        learner waits for its copy's event."""
        b, (dev, event) = self._draw_and_lift(self.stager.stage)
        return dev, event, b.idxes, (b.old_ptr, b.old_advances)

    def update(self, state, item):
        dev, event, idxes, (old_ptr, old_adv) = item
        if event is not None:
            with self.tr.xfer.wait():
                dev = PinnedStager.consume(dev, event)
        state, m, priorities = self.tr.step_fn(state, dev)
        self.replay.update_priorities(idxes, priorities.cpu().numpy(), old_ptr, old_adv)
        return state, m


class _TieredPlane:
    """The full-capacity host store with K batches staged per dispatch
    (replay/tiered_store.py): a staging thread (or, with
    deterministic_staging, the consumer's own thread) draws K batches under
    one lock hold, gathers their windows into a pinned ring slot and copies
    them on a side stream into a device slab, while the learner's K updates
    (learner.make_stacked_batch_train_step) run on the other slab. The
    priority read-back is deferred one dispatch: its copy lands while the
    next dispatch runs."""

    def __init__(self, tr: "Trainer"):
        self.tr = tr
        self.replay = TieredReplayBuffer(tr.cfg)
        self.K = self.steps_per_update = tr.cfg.updates_per_dispatch
        self.multi_fn = make_stacked_batch_train_step(tr.cfg, self.K, tr.mesh)
        # r2d2: ephemeral(pinned staging buffers, built lazily by `ring`; capture_pending stops the pipeline and drops every chunk in them, so no replayed state lives here)
        self._ring: Optional[StagingRing] = None
        # r2d2: ephemeral(lazily rebuilt by _ensure_pipeline on the next sample; capture_pending stops it with an RNG rewind so the resumed pipeline re-draws identically)
        self._pipe: Optional[TieredPrefetchPipeline] = None
        self._pending = None  # the deferred (priorities, chunk) pair

    @property
    def ring(self) -> StagingRing:
        if self._ring is None:
            self._ring = StagingRing(staged_specs(self.tr.cfg, self.K), self.tr.device)
        return self._ring

    def _ensure_pipeline(self) -> TieredPrefetchPipeline:
        # started at the first sample (after warmup opened the sampling
        # gate), and again after a drain stopped it
        if self._pipe is None:
            self._pipe = TieredPrefetchPipeline(self.replay, self.tr.sample_rng, self.K,
                                                self.ring, timer=self.tr.xfer)
        return self._pipe

    def sample(self, pipelined: bool = False):
        with span("replay/staged_chunk"):
            if self.tr.cfg.deterministic_staging:
                # staged on this thread: no staging thread races the
                # write-backs for the Generator, so the stream reproduces
                return stage_chunk(self.replay, self.tr.sample_rng, self.K, self.ring,
                                   self.tr.xfer)
            return self._ensure_pipeline().get()

    def update(self, state, chunk: StagedChunk):
        if chunk.event is not None:
            torch.cuda.current_stream(self.tr.device).wait_event(chunk.event)
        state, m, priorities = self.multi_fn(state, DeviceBatch.from_staged(chunk.batch))
        self.ring.release(chunk.slot)
        prev, self._pending = self._pending, (start_read_back(priorities), chunk)
        if prev is not None:
            self.drain_pending(prev)
        return state, m

    def drain_pending(self, pending=None) -> None:
        """Apply a deferred (priorities, chunk) pair: the previous one at
        each update; with no argument (a run mode's exit) the one left, and
        the staging thread stops (a staged chunk not consumed is dropped:
        its bytes were copied out, no tree write waits on it)."""
        if pending is None:
            if self._pipe is not None:
                self._pipe.stop()
                self._pipe = None
            pending, self._pending = self._pending, None
        if pending is None:
            return
        prios, chunk = pending
        for row, idx in zip(finish_read_back(prios), chunk.idxes):
            self.replay.update_priorities(idx, row, chunk.old_ptr, chunk.old_advances)

    def capture_pending(self) -> Optional[dict]:
        """The preemption's capture: the deferred write-back serialized,
        not applied. In an uninterrupted run the next draw comes before it
        lands, so applying it here would give the resumed draw a tree the
        uninterrupted run never had; restore_pending queues it again. Also
        stops the staging thread with a rewind of the Generator: the chunks
        not consumed are drawn again after the resume."""
        if self._pipe is not None:
            self._pipe.stop(rewind=True)
            self._pipe = None
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        prios, chunk = pending
        return {
            "prios": finish_read_back(prios),
            "idxes": np.asarray(chunk.idxes),
            "old_ptr": np.asarray(chunk.old_ptr, np.int64),
            "old_advances": np.asarray(chunk.old_advances, np.int64),
        }

    def restore_pending(self, d: dict) -> None:
        chunk = StagedChunk(
            batch=None,  # consumed before the cut; only the stamps remain
            idxes=np.asarray(d["idxes"]),
            old_ptr=int(np.asarray(d["old_ptr"])[()]),
            old_advances=int(np.asarray(d["old_advances"])[()]),
        )
        self._pending = (np.asarray(d["prios"]), chunk)

    def log_extras(self) -> dict:
        return {**self.tr.xfer.stats(), **self.replay.disk_stats()}


class _DevicePlane:
    """The replay store on the card (replay/device_store.py). K=1: the
    sampled coordinates go to the card and the fused step gathers at update
    time (threaded mode gathers at sample time instead, so a queued batch
    is a copy no block write can change). K>1: K draws and the K-update
    dispatch under one lock hold, the priorities read back one dispatch
    late. priority_plane="device": N x K updates per superstep, sampling
    and write-back on the card, nothing drawn or drained on the host."""

    def __init__(self, tr: "Trainer"):
        self.tr = tr
        cfg = tr.cfg
        self.replay = DeviceReplayBuffer(cfg, tr.device)
        self.K = self.steps_per_update = cfg.updates_per_dispatch
        self._pending = None  # the deferred (priorities, draws) pair
        self.device_priority = cfg.priority_plane == "device"
        if self.device_priority:
            self.N = cfg.superstep_dispatches
            self.steps_per_update = self.N * self.K
            self.superstep_fn = make_priority_superstep(cfg, self.N, self.K, tr.mesh)
        elif self.K > 1:
            self.multi_fn = make_fused_multi_train_step(cfg, self.K, tr.mesh)
        self.step_fn = make_fused_train_step(cfg, tr.mesh)
        self.gather_fn = make_gather_step(cfg)
        self.batch_step_fn = make_batch_train_step(cfg, tr.mesh)

    def _superstep_update(self, state):
        """One superstep (megastep.make_priority_superstep). Its draws come
        from generators derived from the step counter, so a resume at this
        step draws them again."""
        cfg, dev = self.tr.cfg, self.replay.device
        gens = superstep_generators(cfg.seed + 4, self.tr._step // self.steps_per_update,
                                    self.N, dev)
        u = superstep_uniforms(gens, self.K, cfg.batch_size, dev)

        def dispatch(stores, tree, nss):
            new_state, tree_out, m = self.superstep_fn(state, stores, tree, nss, u)
            return tree_out, (new_state, m)

        return self.replay.superstep_run(dispatch)

    def sample(self, pipelined: bool = False):
        if self.device_priority:
            # drawn on the card at update time, from the live tree
            return ("superstep", None, None, None)
        if self.K > 1:
            # drawn at update time, under the dispatch's lock hold: queued
            # coordinates could be retargeted by the adds meanwhile
            return ("multi", None, None, None)
        with span("replay/sample"):
            si = self.replay.sample_indices(self.tr.sample_rng)
            dev = self.replay.device
            coords = tuple(torch.from_numpy(x).to(dev) for x in (si.b, si.s, si.is_weights))
            stamp = (si.old_ptr, si.old_advances)
            if pipelined:
                batch = self.replay.run_with_stores(lambda stores: self.gather_fn(stores, *coords))
                return "batch", batch, si.idxes, stamp
            return "coords", coords, si.idxes, stamp

    def _multi_update(self, state):
        dev = self.replay.device

        def dispatch(stores, draws):
            b, s, w = (torch.from_numpy(np.stack([getattr(d, f) for d in draws])).to(dev)
                       for f in ("b", "s", "is_weights"))
            return self.multi_fn(state, stores, b, s, w)

        draws, (new_state, m, priorities) = self.replay.sample_and_run(
            self.tr.sample_rng, self.K, dispatch)
        prev, self._pending = self._pending, (start_read_back(priorities), draws)
        if prev is not None:
            self.drain_pending(prev)
        return new_state, m

    def drain_pending(self, pending=None) -> None:
        """Apply a deferred (priorities, draws) pair: the previous one at
        each K-update dispatch; with no argument (a run mode's exit) the one
        left."""
        if pending is None:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        prios, draws = pending
        for row, d in zip(finish_read_back(prios), draws):
            self.replay.update_priorities(d.idxes, row, d.old_ptr, d.old_advances)

    def capture_pending(self) -> Optional[dict]:
        """The preemption's capture of the deferred write-back (as
        _TieredPlane.capture_pending)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        prios, draws = pending
        return {
            "prios": finish_read_back(prios),
            "idxes": np.stack([np.asarray(d.idxes) for d in draws]),
            "old_ptr": np.asarray([d.old_ptr for d in draws], np.int64),
            "old_advances": np.asarray([d.old_advances for d in draws], np.int64),
        }

    def restore_pending(self, d: dict) -> None:
        draws = [types.SimpleNamespace(idxes=np.asarray(idx), old_ptr=int(p), old_advances=int(a))
                 for idx, p, a in zip(d["idxes"], d["old_ptr"], d["old_advances"])]
        self._pending = (np.asarray(d["prios"]), draws)

    def update(self, state, item):
        kind, payload, idxes, stamp = item
        if kind == "superstep":
            return self._superstep_update(state)
        if kind == "multi":
            return self._multi_update(state)
        if kind == "batch":
            state, m, priorities = self.batch_step_fn(state, payload)
        else:
            state, m, priorities = self.replay.run_with_stores(
                lambda stores: self.step_fn(state, stores, *payload))
        old_ptr, old_adv = stamp
        self.replay.update_priorities(idxes, priorities.cpu().numpy(), old_ptr, old_adv)
        return state, m


class _ShardedPlane:
    """dp-sharded device replay in one process (replay/sharded_store.py):
    one store per shard, each shard gathering its rows from its own store
    and the shards' gradients summed (learner.make_sharded_fused_train_step;
    through each shard's tp group when tp > 1). K=1 as the device plane:
    coordinates, gathered at update time (inline) or at sample time
    (threaded, a copy no write can change); K>1: K draws and the K-update
    dispatch under one lock hold, the priorities read back one dispatch
    late. priority_plane="device": N x K updates per sharded superstep,
    each shard sampling and writing back against its own device tree."""

    def __init__(self, tr: "Trainer"):
        if tr.mesh is None:
            raise ValueError("replay_plane='sharded' needs dp_size * tp_size > 1")
        self.tr = tr
        cfg, mesh = tr.cfg, tr.mesh
        self.replay = ShardedDeviceReplay(cfg, mesh)
        self.K = self.steps_per_update = cfg.updates_per_dispatch
        self._pending = None  # the deferred (priorities, draws) pair
        self.device_priority = cfg.priority_plane == "device"
        if self.device_priority:
            self.N = cfg.superstep_dispatches
            self.steps_per_update = self.N * self.K
            self.superstep_fn = make_sharded_priority_superstep(cfg, mesh, self.N, self.K)
        elif self.K > 1:
            self.multi_fn = make_sharded_fused_multi_train_step(cfg, self.K, mesh=mesh)
        self.step_fn = make_sharded_fused_train_step(cfg, mesh=mesh)
        self.gather_fn = make_sharded_gather_step(cfg)
        self.batch_step_fn = make_sharded_train_step(cfg, mesh=mesh)

    def _superstep_update(self, state):
        """One sharded superstep; shard i's draws come from generators
        derived from (seed, the superstep counter, i), so a resume at this
        step draws them again."""
        cfg = self.tr.cfg
        ctr = self.tr._step // self.steps_per_update
        u = []
        for i, sh in enumerate(self.replay.shards):
            dev = sh.dtree.device
            gens = superstep_generators(cfg.seed + 4, ctr, self.N, dev, shard=i)
            u.append(superstep_uniforms(gens, self.K, cfg.batch_size // self.replay.dp, dev))

        def dispatch(stores, trees, nss):
            new_state, trees_out, m = self.superstep_fn(state, stores, trees, nss, u)
            return trees_out, (new_state, m)

        return self.replay.superstep_run(dispatch)

    def sample(self, pipelined: bool = False):
        if self.device_priority:
            return ("superstep", None, None, None)
        if self.K > 1:
            # drawn at update time, under the dispatch's lock hold
            return ("multi", None, None, None)
        with span("replay/sample"):
            si = self.replay.sample_indices(self.tr.sample_rng)
            coords = (si.b, si.s, si.is_weights)
            stamp = (si.old_ptrs, si.old_advances)
            if pipelined:
                batch = self.replay.run_with_stores(lambda stores: self.gather_fn(stores, *coords))
                return "batch", batch, si.idxes, stamp
            return "coords", coords, si.idxes, stamp

    def _multi_update(self, state):
        def dispatch(stores, draws):
            b, s, w = (np.stack([getattr(d, f) for d in draws]) for f in ("b", "s", "is_weights"))
            return self.multi_fn(state, stores, b, s, w)

        draws, (new_state, m, priorities) = self.replay.sample_and_run(
            self.tr.sample_rng, self.K, dispatch)
        prev, self._pending = self._pending, (start_read_back(priorities), draws)
        if prev is not None:
            self.drain_pending(prev)
        return new_state, m

    def drain_pending(self, pending=None) -> None:
        """Apply a deferred (priorities (K, dp, B/dp), draws) pair: the
        previous one at each K-update dispatch; with no argument the one
        left."""
        if pending is None:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        prios, draws = pending
        for row, d in zip(finish_read_back(prios), draws):
            self.replay.update_priorities(d.idxes, row, d.old_ptrs, d.old_advances)

    def capture_pending(self) -> Optional[dict]:
        """The preemption's capture of the deferred write-back (as
        _TieredPlane.capture_pending)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        prios, draws = pending
        return {
            "prios": finish_read_back(prios),
            "idxes": np.stack([np.asarray(d.idxes) for d in draws]),
            "old_ptr": np.asarray([d.old_ptrs for d in draws], np.int64),
            "old_advances": np.asarray([d.old_advances for d in draws], np.int64),
        }

    def restore_pending(self, d: dict) -> None:
        draws = [types.SimpleNamespace(idxes=np.asarray(idx), old_ptrs=[int(x) for x in p],
                                       old_advances=[int(x) for x in a])
                 for idx, p, a in zip(d["idxes"], d["old_ptr"], d["old_advances"])]
        self._pending = (np.asarray(d["prios"]), draws)

    def update(self, state, item):
        kind, payload, idxes, stamp = item
        if kind == "superstep":
            return self._superstep_update(state)
        if kind == "multi":
            return self._multi_update(state)
        if kind == "batch":
            state, m, priorities = self.batch_step_fn(state, payload)
        else:
            state, m, priorities = self.replay.run_with_stores(
                lambda stores: self.step_fn(state, stores, *payload))
        old_ptrs, old_adv = stamp
        self.replay.update_priorities(idxes, priorities.cpu().numpy(), old_ptrs, old_adv)
        return state, m


class _MultiHostPlane:
    """This process's shards of a dp mesh across processes
    (replay/multihost_store.py): every process runs the same loop, and the
    updates are collective, so the processes stay in lockstep through them;
    collection, the draws and the priority write-backs are local. K>1 folds
    K collective updates into one dispatch with the read-back deferred one
    dispatch (replay.run_step_k)."""

    def __init__(self, tr: "Trainer"):
        if tr.mesh is None:
            raise ValueError("the multihost plane needs a mesh")
        self.tr = tr
        cfg = tr.cfg
        self.replay = MultiHostShardedReplay(cfg, tr.mesh, seed=cfg.seed + 3)
        self.K = self.steps_per_update = cfg.updates_per_dispatch
        if self.K > 1:
            self.multi_fn = make_sharded_fused_multi_train_step(
                cfg, self.K, is_from_priorities=True, collectives=tr.collectives)
        self.step_fn = make_sharded_fused_train_step(cfg, is_from_priorities=True,
                                                     collectives=tr.collectives)

    def sample(self, pipelined: bool = False):
        # drawn inside run_step(_k), with the dispatch
        return ("multihost", None, None, None)

    def update(self, state, item):
        if self.K > 1:
            return self.replay.run_step_k(self.multi_fn, state, self.K)
        return self.replay.run_step(self.step_fn, state)

    def drain_pending(self, pending=None) -> None:
        self.replay.drain_pending(pending)

    def log_extras(self) -> dict:
        return self.tr.collectives.stats()


_PLANES = {"host": _HostPlane, "tiered": _TieredPlane, "device": _DevicePlane,
           "sharded": _ShardedPlane, "multihost": _MultiHostPlane}


def build_mesh(cfg: R2D2Config, device):
    """The (dp, tp, fsdp) mesh a config asks for, or None: on the multihost
    plane the mesh over every process's shards, `device` listing this
    process's (one each); elsewhere, with dp*tp*fsdp = n > 1, `device`
    either lists the n positions' devices in (dp, tp, fsdp) order (they may
    repeat) or is a single CUDA device, which means cuda:0 .. cuda:n-1 and
    raises when fewer cards are visible."""
    devices = parse_devices(device)
    if cfg.replay_plane == "multihost":
        return make_global_mesh(devices, dp=cfg.dp_size if cfg.dp_size > 1 else None)
    n = cfg.dp_size * cfg.tp_size * cfg.fsdp_size
    if n <= 1:
        if len(devices) > 1:
            raise ValueError(f"{len(devices)} devices given for dp_size=1")
        return None
    if len(devices) == 1:
        if devices[0].type != "cuda":
            raise ValueError(
                f"a mesh of dp*tp*fsdp = {n} positions needs {n} devices; list them "
                f"(--device {','.join([str(devices[0])] * n)})")
        return make_mesh(cfg.dp_size, tp=cfg.tp_size, fsdp=cfg.fsdp_size)
    return make_mesh(cfg.dp_size, devices, tp=cfg.tp_size, fsdp=cfg.fsdp_size)


class Trainer:
    def __init__(self, cfg: R2D2Config, vec_env=None, device="cuda", resume: bool = False,
                 metrics: Optional[MetricsLogger] = None, profile_dir: Optional[str] = None,
                 profile_steps: int = 20, fn_env=None):
        # the dp mesh, and the device of this process's first shard, which
        # holds the learner state (and the actors and the envs' tensors)
        self.collectives = Collectives()
        self.mesh = build_mesh(cfg, device)
        if self.mesh is not None:
            self.device = self.mesh.devices[self.mesh.processes.index(process_index())]
        else:
            self.device = resolve_device(parse_devices(device)[0])
        self.vec_env = self.fn_env = None
        if cfg.collector == "device":
            self.fn_env = fn_env if fn_env is not None else build_fn_env(cfg)
            env_action_dim = self.fn_env.NUM_ACTIONS
        else:
            self.vec_env = vec_env if vec_env is not None else build_vec_env(
                cfg, seed=cfg.seed, device=self.device)
            env_action_dim = self.vec_env.action_dim
        if env_action_dim != cfg.action_dim:
            cfg = cfg.replace(action_dim=env_action_dim)
        self.cfg = cfg
        # trace the `profile_steps` updates after the first (the first builds
        # the kernels)
        self.profile_dir = profile_dir
        self._profile_remaining = profile_steps if profile_dir else 0
        self._prof = None
        self.backward_arm = cfg.resolve_backward_arm(device=self.device.type)
        self.net, self.state = init_train_state(cfg, self.device)
        if self.mesh is not None and self.mesh.fsdp > 1:
            # the Adam moments on the fsdp members (learner.ShardedAdam); a
            # checkpoint holds them whole, so any layout restores it
            shard_optimizer(cfg, self.state, self.mesh)
        self.env_steps_offset = 0
        self.wall_minutes_offset = 0.0
        self.resumed = False
        if resume and latest_checkpoint_step(cfg.checkpoint_dir) is not None:
            self.state, self.env_steps_offset, self.wall_minutes_offset = restore_checkpoint(
                cfg.checkpoint_dir, self.state, map_location=self.device)
            self.resumed = True
        self._initial_step = self._step = self.state.step
        quantum = cfg.updates_per_dispatch * cfg.superstep_dispatches
        if self._initial_step % quantum != 0:
            raise ValueError(
                f"resumed step {self._initial_step} is not a multiple of "
                f"updates_per_dispatch*superstep_dispatches={quantum}; resume with the "
                "N and K the checkpoint was trained with (or N=K=1)"
            )
        self.sample_rng = np.random.default_rng(cfg.seed + 2)
        self.step_fn = make_train_step(cfg, self.mesh)
        self.xfer = TransferTimer()
        # the preemption protocol: request_preempt (SIGTERM, inside a run
        # mode) sets the event; the run loop honours it at its next
        # iteration, snapshots replay and the mid-run carry, and writes a
        # finalized checkpoint; the CLI then exits with PREEMPT_EXIT_CODE
        self.preempted = False
        self._preempt = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None
        self._resume_carry: dict = {}
        self.plane = _PLANES[cfg.replay_plane](self)
        self.replay = self.plane.replay
        if self.resumed and cfg.snapshot_replay:
            # the restored env steps are in the checkpoint's count already.
            # Across processes every rank takes part in the count and in
            # the verdict (a rank without a snapshot adds 0; a failed
            # restore on any rank fails them all)
            restored, error = 0, None
            try:
                if self._restore_replay_snapshot():
                    restored = self.replay.env_steps
            except Exception as e:  # noqa: BLE001 — agreed below
                error = e
            if self.collectives.any(error is not None, "restore"):
                if error is not None:
                    raise error
                raise RuntimeError("replay snapshot restore failed on another process")
            self.env_steps_offset -= self.collectives.sum_int(restored, "restore")
        self.param_store = ParamStore(self.state.net)
        if cfg.collector == "device":
            self.actor = DeviceCollector(cfg, copy.deepcopy(self.state.net), self.param_store,
                                         self.fn_env, self.replay, seed=cfg.seed + 1,
                                         device=self.device)
        else:
            self.actor = VectorizedActor(
                cfg,
                copy.deepcopy(self.state.net),
                self.param_store,
                self.vec_env,
                epsilon_ladder(cfg.num_actors, cfg.base_eps, cfg.eps_alpha),
                self.replay.add_block,
                seed=cfg.seed + 1,
                device=self.device,
            )
        # across processes, rank 0 writes the metrics file (every rank logs
        # to stderr)
        self.metrics_logger = metrics or MetricsLogger(
            cfg.metrics_path if process_index() == 0 else None, cfg.log_interval)
        # the latest un-emitted (metrics, step, extra); see _log
        self._pending_log = None
        self._last_log_emit = 0.0
        self._sup: Optional[Supervisor] = None
        self.last_metrics: Optional[dict] = None
        # host clock around each dispatch of learner updates, and at its end
        # (for rates over the wall); a dispatch ends in the device -> host
        # copy of its priorities (on the tiered plane the copy is deferred)
        self.update_seconds: List[float] = []
        self.update_ends: List[float] = []
        self.reset_clock()
        if self.resumed:
            self._maybe_restore_carry()

    # ------------------------------------------------------ preemption, carry

    def request_preempt(self, signum=None, frame=None) -> None:
        """Ask the run loop to cut at its next iteration boundary. Safe in a
        signal handler: it sets an event and returns, touching no device,
        so an update in flight finishes and the cut lands between steps."""
        self._preempt.set()

    def _preempt_now(self) -> bool:
        """Checked once per run-loop iteration. Across processes every rank
        takes part (the loops are in lockstep through the collective
        updates), so one rank's SIGTERM cuts them all at the same step."""
        if self.collectives.any(self._preempt.is_set(), "preempt"):
            self.preempted = True
        return self.preempted

    @contextlib.contextmanager
    def _sigterm_to_preempt(self):
        """Route SIGTERM into the preemption protocol for the enclosed run.
        Only on the main thread (signal.signal raises elsewhere: a caller
        driving a Trainer from another thread keeps its own handler and
        calls request_preempt itself); the previous handler comes back on
        exit."""
        try:
            prev = signal.signal(signal.SIGTERM, lambda s, f: self.request_preempt(s, f))
        except ValueError:
            prev = None
        try:
            yield
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def _carry_payload(self) -> dict:
        """What the next iteration reads outside the replay tree and the
        learner state: the cut step, the sampling Generator, the published
        parameters, the deferred priority write-back, the actor's and the
        envs' episode streams. With the replay snapshot it rides in and the
        finalized checkpoint, --resume restores the exact program point."""
        carry = {
            "carry_step": np.asarray(self._step, np.int64),
            "sample_rng": np.asarray(json.dumps(self.sample_rng.bit_generator.state)),
        }
        params, version = self.param_store.latest()
        carry["pub_version"] = np.asarray(version, np.int64)
        for j, v in enumerate(params.values()):
            carry[f"pub_{j}"] = v.detach().cpu()
        capture = getattr(self.plane, "capture_pending", None)
        if capture is not None:
            pend = capture()
            for k, v in (pend or {}).items():
                carry[f"pend_{k}"] = v
        if self.cfg.collector == "device":
            # the collector's carry holds its env states and generator
            for k, v in self.actor.carry_state().items():
                carry[f"actor_{k}"] = v
        elif hasattr(self.vec_env, "get_state"):
            # the actor's carry is of use only if the envs resume exactly
            # too; pools without get_state start fresh episodes
            for k, v in self.actor.carry_state().items():
                carry[f"actor_{k}"] = v
            for k, v in self.vec_env.get_state().items():
                carry[f"env_{k}"] = v
        return carry

    def _capture_carry_safe(self) -> Optional[dict]:
        """The preemption's carry, for the run modes' cleanup: a failure to
        capture degrades to a snapshot without one (still a valid resume of
        the data), never masking the unwind. Runs before finish_updates,
        which would apply the deferred write-back capture_pending keeps."""
        if not (self.preempted and self.cfg.snapshot_replay):
            return None
        try:
            return self._carry_payload()
        except Exception:  # noqa: BLE001 — degrade, don't mask
            import traceback

            traceback.print_exc()
            return None

    def _maybe_restore_carry(self) -> None:
        """Rehydrate the mid-run carry of a preemption snapshot. A carry is
        valid only at the step it was cut at: a snapshot behind the
        checkpoint is restored as data (above), its carry discarded, and the
        run starts fresh episode streams."""
        carry = self._resume_carry
        if "carry_step" not in carry:
            return
        carry_step = int(np.asarray(carry["carry_step"])[()])
        if carry_step != self._initial_step:
            print(f"[resume] discarding mid-run carry cut at step {carry_step} (checkpoint "
                  f"is at step {self._initial_step}); resuming with fresh episode streams",
                  file=sys.stderr)
            return
        self.sample_rng.bit_generator.state = json.loads(str(np.asarray(carry["sample_rng"])[()]))
        with self.param_store._lock:
            current = self.param_store._params
            self.param_store._params = {
                k: _carried(carry[f"pub_{j}"], v) for j, (k, v) in enumerate(current.items())}
            self.param_store.version = int(np.asarray(carry["pub_version"])[()])
        pend = {k[len("pend_"):]: v for k, v in carry.items() if k.startswith("pend_")}
        restore_pending = getattr(self.plane, "restore_pending", None)
        if pend and restore_pending is not None:
            restore_pending(pend)
        act = {k[len("actor_"):]: v for k, v in carry.items() if k.startswith("actor_")}
        if act:
            self.actor.restore_carry(act)
        envd = {k[len("env_"):]: v for k, v in carry.items() if k.startswith("env_")}
        if envd and hasattr(self.vec_env, "set_state"):
            self.vec_env.set_state(envd)

    def _finalize_preempt(self) -> None:
        """The preemption's commit: a finalized checkpoint at the cut step,
        written after the replay snapshot and its carry. A resume keys off
        the latest finalized checkpoint, so a crash between the two leaves
        the previous pair in force."""
        # the cadence may have checkpointed this step already. Rank 0 writes
        # the checkpoints, so its view decides, on every rank alike: the
        # save below is a collective
        written = (process_index() == 0
                   and latest_checkpoint_step(self.cfg.checkpoint_dir) == self._step)
        if self.collectives.any(written, "finalize"):
            return
        self._save_checkpoint()

    def _save_checkpoint(self) -> None:
        """A checkpoint of the learner state with the run's global env
        steps. Every process takes part in the count; rank 0 writes (the
        state is the same on every rank)."""
        env_steps = self._global_env_steps()
        if process_index() == 0:
            save_checkpoint(self.cfg.checkpoint_dir, self.state, env_steps,
                            self.wall_minutes_offset + (time.time() - self._start_time) / 60.0)

    # -------------------------------------------------------- replay snapshot

    def _replay_snapshot_path(self) -> str:
        # the multihost plane snapshots per process (each owns its shards)
        if self.cfg.replay_plane == "multihost":
            return os.path.join(self.cfg.checkpoint_dir,
                                f"replay_snapshot_p{process_index()}.npz")
        return os.path.join(self.cfg.checkpoint_dir, "replay_snapshot.npz")

    def _restore_replay_snapshot(self) -> bool:
        """Restore this run's replay snapshot, if there is one; its extras
        are the mid-run carry. A snapshot of another topology (a
        TopologyMismatch, or no file of this process's name while other
        snapshot files exist: a changed process layout) is re-split over
        this layout when cfg.reshard_on_resume (replay/reshard.py), and
        raises otherwise. -> whether replay was restored."""
        from r2d2_tpu_torch.replay.reshard import reshard_replay, snapshot_paths
        from r2d2_tpu_torch.replay.snapshot import (
            TopologyMismatch,
            _plain,
            read_manifest,
            restore_replay,
            snapshot_topology,
        )

        snap = self._replay_snapshot_path()
        if os.path.exists(snap):
            try:
                self._resume_carry = restore_replay(self.replay, snap)
                return True
            except TopologyMismatch:
                if not self.cfg.reshard_on_resume:
                    raise
        else:
            others = snapshot_paths(self.cfg.checkpoint_dir)
            if not others:
                return False  # no snapshot: refill from scratch
            if not self.cfg.reshard_on_resume:
                raise TopologyMismatch(
                    read_manifest(others[0]) or {},
                    _plain(snapshot_topology(self.replay, tp=self.cfg.tp_size)),
                    f"no snapshot named {os.path.basename(snap)} for this process, but "
                    f"{len(others)} snapshot file(s) exist — a changed process layout")
        t0 = time.perf_counter()
        paths = snapshot_paths(self.cfg.checkpoint_dir)
        self._resume_carry = reshard_replay(self.replay, paths)
        self.reshard_stats = {"reshard_s": time.perf_counter() - t0,
                              "reshard_bytes": sum(os.path.getsize(q) for q in paths)}
        return True

    def save_replay_snapshot(self, extra: Optional[dict] = None) -> str:
        """Write the whole replay (replay/snapshot.py), with `extra` (the
        preemption carry) in the same atomic write; the manifest records the
        mesh's tp. -> its path."""
        from r2d2_tpu_torch.replay.snapshot import save_replay, snapshot_topology

        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        path = self._replay_snapshot_path()
        save_replay(self.replay, path, extra=extra,
                    topology=snapshot_topology(self.replay, tp=self.cfg.tp_size))
        return path

    _RESHARD_LIVE_KEYS = ("dp_size", "tp_size", "fsdp_size", "replay_plane")

    def reshard_live(self, devices=None, **topology) -> dict:
        """Re-split the replay plane over a new dp / tp / fsdp topology in
        this process: drain every deferred write-back, snapshot the replay
        through the preemption's atomic writer, take the new config and
        mesh (`devices`: its positions' devices; by default this trainer's
        device repeated), move the optimizer onto the new fsdp layout,
        rebuild the plane and re-deal the snapshot over it
        (replay/reshard.py), and point the actor at the new replay. The
        actor, its streams and the parameters carry straight through, and
        the replay round-trips losslessly, so the run goes on as one that
        resumed from that snapshot would. Only the topology keys; one
        process only (the multihost plane reshards through exit and
        resume, cfg.reshard_on_resume). -> a summary."""
        from r2d2_tpu_torch.parallel.multihost import process_count
        from r2d2_tpu_torch.replay.reshard import reshard_replay, snapshot_paths

        unknown = set(topology) - set(self._RESHARD_LIVE_KEYS)
        if unknown:
            raise ValueError(f"reshard_live accepts {self._RESHARD_LIVE_KEYS}, "
                             f"got {sorted(unknown)}")
        if (process_count() > 1 or self.cfg.replay_plane == "multihost"
                or topology.get("replay_plane") == "multihost"):
            raise NotImplementedError(
                "live reshard is single-process; multihost topologies reshard "
                "through exit + resume (cfg.reshard_on_resume)")
        t0 = time.perf_counter()
        self.finish_updates()
        snap = self.save_replay_snapshot()
        before_env_steps, before_size = self.replay.env_steps, len(self.replay)
        cfg = self.cfg.replace(**topology)
        n = cfg.dp_size * cfg.tp_size * cfg.fsdp_size
        self.mesh = build_mesh(cfg, [self.device] * n if devices is None else devices)
        self.cfg = cfg
        self.backward_arm = cfg.resolve_backward_arm(device=self.device.type)
        shard_optimizer(cfg, self.state, self.mesh)
        self.step_fn = make_train_step(cfg, self.mesh)
        self.plane = _PLANES[cfg.replay_plane](self)
        self.replay = self.plane.replay
        paths = snapshot_paths(cfg.checkpoint_dir)
        self._resume_carry = reshard_replay(self.replay, paths)
        # the restored counters equal the ones before: env_steps_offset holds
        if hasattr(self.actor, "push_block"):
            self.actor.push_block = self.replay.add_block
        if hasattr(self.actor, "replay"):
            self.actor.replay = self.replay
        return {
            "snapshot": snap, "replay_plane": cfg.replay_plane, "dp_size": cfg.dp_size,
            "tp_size": cfg.tp_size, "fsdp_size": cfg.fsdp_size,
            "env_steps": self.replay.env_steps, "env_steps_before": before_env_steps,
            "replay_size": len(self.replay), "replay_size_before": before_size,
            "seconds": time.perf_counter() - t0,
            "bytes": sum(os.path.getsize(q) for q in paths),
        }

    def _snapshot_async(self) -> None:
        """A periodic (snapshot_every) snapshot on a background thread; if
        the previous one is still being written this crossing is skipped.
        The atomic write keeps the previous file valid until the new one
        lands."""
        if self._snap_thread is not None and self._snap_thread.is_alive():
            return
        t = threading.Thread(target=self._snapshot_on_exit, name="replay-snapshot",
                             daemon=True)
        self._snap_thread = t
        t.start()

    def _snapshot_on_exit(self, extra: Optional[dict] = None) -> None:
        """A snapshot whose failure (a full disk) is printed, not raised: it
        must not replace the run's own exception or outcome."""
        t = self._snap_thread
        if t is not None and t is not threading.current_thread() and t.is_alive():
            t.join(timeout=60.0)  # a periodic write would race ours on the path
        try:
            self.save_replay_snapshot(extra=extra)
        except Exception as e:  # noqa: BLE001 — log and go on
            import traceback

            print(f"replay snapshot failed: {e!r}", file=sys.stderr)
            traceback.print_exc()

    # ------------------------------------------------------------- updates

    def sample(self, pipelined: bool = False):
        """One item of the replay plane: a batch on the device (host plane;
        from pageable memory), a staged chunk (tiered plane), or coordinates
        or a batch gathered on the card (device plane; `pipelined`: gathered
        now, for a queue)."""
        return self.plane.sample(pipelined)

    def _sample_staged(self):
        """One host-plane batch through the pinned ring and the side stream
        (threaded mode on the card)."""
        return self.plane.sample_staged()

    def _one_update(self, item):
        fault_point("trainer.update")
        self._profile_gate()
        prev = self._step
        t0 = time.perf_counter()
        with step_span("learner_update", prev):
            self.state, m = self.plane.update(self.state, item)
        t1 = time.perf_counter()
        self.update_seconds.append(t1 - t0)
        self.update_ends.append(t1)
        n = self.plane.steps_per_update
        self._step += n
        self.last_metrics = m
        self._profile_tick(n)
        self._cadences(prev, self._step)
        return m, self._step

    def _cadences(self, prev: int, step: int) -> None:
        """Publish, checkpoint and snapshot on interval CROSSINGS (a
        K-update dispatch may jump past the multiple)."""
        cfg = self.cfg
        if step // cfg.publish_interval > prev // cfg.publish_interval:
            self.param_store.publish(self.state.net)
        if step // cfg.save_interval > prev // cfg.save_interval:
            self._save_checkpoint()
        if cfg.snapshot_every > 0 and step // cfg.snapshot_every > prev // cfg.snapshot_every:
            # the record before a snapshot lands in the metrics file first
            self._flush_log()
            self._snapshot_async()

    @property
    def env_steps(self) -> int:
        """Run-total env steps: this run's and the resumed checkpoint's (this
        process's shards only on the multihost plane)."""
        return self.replay.env_steps + self.env_steps_offset

    def _global_env_steps(self) -> int:
        """Run-total env steps over every process: a sum across them, which
        every rank reaches in lockstep (a checkpoint crossing). The offset,
        restored from a checkpoint, is a global total already."""
        return self.collectives.sum_int(self.replay.env_steps, "env_steps") + self.env_steps_offset

    def finish_updates(self) -> None:
        """Apply the plane's deferred work (the tiered plane's last
        priority write-back) and emit the deferred metrics record; every
        loop that drives updates calls this once when it stops."""
        drain = getattr(self.plane, "drain_pending", None)
        if drain is not None:
            drain()
        self._flush_log()

    # ------------------------------------------------------------- logging

    def _log(self, m, step, extra: Optional[dict] = None) -> None:
        """Queue this update's metrics without reading them back: a float()
        of a device tensor waits for the device. Only the latest record is
        kept, and it is read and written when the log cadence fires
        (cfg.log_interval seconds; 0 writes every update) or at a cut point
        (finish_updates)."""
        self._pending_log = (m, step, extra)
        if time.time() - self._last_log_emit >= self.cfg.log_interval:
            self._flush_log()

    def _flush_log(self) -> None:
        pend, self._pending_log = self._pending_log, None
        if pend is None:
            return
        m, step, extra = pend
        self._last_log_emit = time.time()
        log_extras = getattr(self.plane, "log_extras", None)
        if log_extras is not None:
            extra = {**(extra or {}), **log_extras()}
        retries = total_retries()
        if retries:
            extra = {**(extra or {}), "io_retries": retries}
        n_ep, r_sum = self.replay.pop_episode_stats()
        arm, stride = self.backward_arm
        self.metrics_logger.log({
            "step": step,
            "env_steps": self.env_steps,
            "replay_size": len(self.replay),
            "loss": float(m["loss"]),
            "q_mean": float(m["q_mean"]),
            "episodes": n_ep,
            "mean_return": (r_sum / n_ep) if n_ep else None,
            "backward_arm": arm,
            **({"backward_arm_stride": stride} if arm == "ckpt" else {}),
            **(extra or {}),
        })

    # ------------------------------------------------------------- profile

    def _profile_gate(self) -> None:
        """Start the trace after the first update of this run: the first
        builds the kernels."""
        if self._profile_remaining > 0 and self._prof is None and (
                self._step >= self._initial_step + 1):
            self._prof = start_trace()

    def _profile_tick(self, n: int = 1) -> None:
        if self._prof is not None:
            self._profile_remaining -= n
            if self._profile_remaining <= 0:
                self._stop_profile()

    def _stop_profile(self) -> None:
        """Finish an in-flight trace; safe to call repeatedly."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self._profile_remaining = 0
            stop_trace(prof, self.profile_dir, f"trace_step{self._step}")

    # --------------------------------------------------------------- modes

    def reset_clock(self) -> None:
        """(Re)start the wall-minutes clock the checkpoints stamp."""
        self._start_time = time.time()

    def _make_supervisor(self) -> Supervisor:
        return Supervisor(heartbeat_timeout=self.cfg.heartbeat_timeout,
                          stall_fatal_timeout=self.cfg.stall_fatal_timeout)

    def disarm_watchdog(self) -> None:
        """For callers that catch WorkerStalledError and keep the process
        alive: the watchdog stays armed through that unwind on purpose."""
        if self._sup is not None:
            self._sup.disarm()

    def warmup(self, max_steps: Optional[int] = None, beat=None) -> None:
        """Collect until sampling opens (replay holds learning_starts).
        `beat` (Supervisor.main_beat) is stamped between collection steps.
        Raises once twice the ring's capacity has been recorded without
        sampling opening: learning_starts is then out of the ring's reach.
        A preemption request ends it early (the run loop then cuts)."""
        steps = 0
        inserted0 = last_inserted = self.replay.env_steps
        progress_mark = 0  # attempted steps at the last recorded insertion
        saturation = 2 * self.cfg.buffer_capacity + self.cfg.learning_starts
        while not self.replay.can_sample():
            if self._preempt.is_set():
                self.preempted = True
                return
            self.actor.step()
            if beat is not None:
                beat()
            steps += self.actor.steps_per_call
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError("warmup exceeded max_steps without filling replay")
            if self.replay.env_steps != last_inserted:
                last_inserted = self.replay.env_steps
                progress_mark = steps
            if self.replay.env_steps - inserted0 >= saturation:
                raise RuntimeError(
                    f"replay saturated at {len(self.replay)} transitions, below "
                    f"learning_starts={self.cfg.learning_starts}: lower "
                    "learning_starts or grow buffer_capacity"
                )
            if steps - progress_mark >= saturation:
                # recording has stalled (e.g. episodes that never end within
                # the collector's chunks): the guard above would never fire
                raise RuntimeError(
                    f"warmup recorded no insertions over {saturation} attempted env steps "
                    f"(replay stuck at {len(self.replay)} transitions): episodes may never "
                    "complete within the collector's chunks — check max_episode_steps vs "
                    "chunk/block length"
                )

    def run_inline(self, env_steps_per_update: Optional[int] = None) -> None:
        """Strict alternation: k env steps, one dispatch (of K updates on
        the tiered plane, after k*K env steps)."""
        cfg = self.cfg
        self.reset_clock()
        k = (env_steps_per_update or max(cfg.num_actors, 1)) * self.plane.steps_per_update
        # one thread: the main-thread watchdog is the only stall protection
        sup = self._sup = self._make_supervisor()
        with self._sigterm_to_preempt(), sup.armed_watchdog():
            self.warmup(beat=sup.main_beat)
            try:
                while self._step < cfg.training_steps:
                    sup.main_beat()
                    if self._preempt_now():
                        break
                    for _ in range(max(k // self.actor.steps_per_call, 1)):
                        self.actor.step()
                    m, step = self._one_update(self.sample())
                    self._log(m, step)
            finally:
                sup.stop.set()  # the drain below is not a stall
                self._stop_profile()
                # the carry before finish_updates: capture_pending keeps the
                # deferred write-back the drain would apply
                carry = self._capture_carry_safe()
                self.finish_updates()
                if cfg.snapshot_replay:
                    self._snapshot_on_exit(extra=carry)
        if self.preempted:
            self._finalize_preempt()

    def run_threaded(self) -> None:
        """Actor thread + sampler thread + learner loop, the workers under a
        Supervisor: a crashed actor or sampler iteration is restarted (the
        actor through VectorizedActor.resync) with its traceback recorded,
        and a worker that stays dead or stalls fails the run. Not on the
        multihost plane: a rank waiting on its queue would fall out of the
        ranks' lockstep collectives (run_inline keeps them in step)."""
        if self.cfg.replay_plane == "multihost":
            raise ValueError("run_threaded does not run on the multihost plane: its ranks "
                             "make their collectives in lockstep; use run_inline (--mode inline)")
        self.reset_clock()
        batch_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        sup = self._sup = self._make_supervisor()
        with self._sigterm_to_preempt(), sup.armed_watchdog():
            self._run_threaded_body(sup, batch_q)
        if self.preempted:
            self._finalize_preempt()

    def _run_threaded_body(self, sup: Supervisor, batch_q: "queue.Queue") -> None:
        cfg = self.cfg
        self.warmup(beat=sup.main_beat)
        # host plane on the card: batches through the pinned ring
        staged = self.device.type == "cuda" and isinstance(self.plane, _HostPlane)
        if staged and self.plane.stager is None:
            self.plane.stager = PinnedStager(self.device, _STAGING_SLOTS, self.xfer)
        sample = self._sample_staged if staged else (lambda: self.sample(pipelined=True))

        spi = cfg.samples_per_insert
        consumed_per_update = cfg.batch_size * cfg.learning_steps
        inserted0 = self.replay.env_steps

        def actor_body():
            if spi > 0 and self.replay.can_sample():
                consumed = (self._step - self._initial_step) * consumed_per_update
                inserted = max(self.replay.env_steps - inserted0, 1)
                if consumed / inserted < spi:
                    # data is plentiful relative to optimization: yield to
                    # the learner (a bounded sleep keeps the heartbeat fresh)
                    time.sleep(0.05)
                    return
            self.actor.step()

        # one sample and one bounded put attempt per call: a full queue (the
        # learner building kernels or checkpointing) retries across calls,
        # and the shutdown waits at most one attempt
        pending = [None]

        def sampler_body():
            if pending[0] is None:
                pending[0] = sample()
            try:
                batch_q.put(pending[0], timeout=0.1)
                pending[0] = None
            except queue.Full:
                pass

        def sampler_recover():
            pending[0] = None  # a half-built item may be inconsistent

        sup.spawn("actor", actor_body, max_restarts=cfg.worker_max_restarts,
                  on_restart=self.actor.resync)
        sup.spawn("sampler", sampler_body, max_restarts=cfg.worker_max_restarts,
                  on_restart=sampler_recover)
        last_health: Optional[dict] = None

        def cleanup():
            # shutdown first: it stops the watchdog and joins the workers, so
            # the carry below sees quiescent accumulators and a still replay
            sup.shutdown()
            self._stop_profile()
            carry = self._capture_carry_safe()
            self.finish_updates()
            if cfg.snapshot_replay:
                self._snapshot_on_exit(extra=carry)

        try:
            while self._step < cfg.training_steps:
                sup.main_beat()
                if self._preempt_now():
                    break
                try:
                    # the tiered plane's pipeline times its own waits
                    with self.xfer.wait() if staged else contextlib.nullcontext():
                        item = batch_q.get(timeout=2.0)
                except queue.Empty:
                    # raises WorkerFatalError on a dead worker; health
                    # changes reach the metrics even with no update flowing
                    stats = sup.check()
                    if stats != last_health:
                        last_health = stats
                        self.metrics_logger.log({"step": self._step, **stats})
                    continue
                m, step = self._one_update(item)
                last_health = sup.check()
                extra = {**last_health, **(self.xfer.stats() if staged else {})}
                self._log(m, step, extra=extra)
        except WorkerStalledError:
            # the device is presumed wedged: skip every cleanup that could
            # block on it, and leave the watchdog armed
            raise
        except BaseException:
            cleanup()
            raise
        else:
            cleanup()

    def run_fused(self, collect_every: Optional[int] = None) -> None:
        """One dispatch per iteration: K updates and, every collect_every-th
        dispatch, a collection chunk and its slab write (megastep.py), with
        no worker threads. collect_every=None paces collection from
        cfg.samples_per_insert on the actual counters (0: every dispatch)."""
        cfg = self.cfg
        if cfg.collector != "device" or cfg.replay_plane not in ("device", "sharded",
                                                                   "multihost"):
            raise ValueError(
                "run_fused needs collector='device' and replay_plane 'device', 'sharded' "
                f"or 'multihost' (got {cfg.collector!r}, {cfg.replay_plane!r})"
            )
        self.reset_clock()
        # the main-thread watchdog, armed before the warmup: a wedged
        # read-back would otherwise hang this loop silently
        sup = self._sup = self._make_supervisor()
        with self._sigterm_to_preempt(), sup.armed_watchdog():
            self._run_fused_body(sup, collect_every)
        if self.preempted:
            self._finalize_preempt()

    def _run_fused_body(self, sup: Supervisor, collect_every: Optional[int]) -> None:
        cfg = self.cfg
        self.warmup(beat=sup.main_beat)
        pacing = dict(collect_every=1 if collect_every is None else collect_every,
                      chunk_len=self.actor.chunk, sample_rng=self.sample_rng,
                      samples_per_insert=cfg.samples_per_insert if collect_every is None
                      else 0.0)
        if cfg.replay_plane == "sharded":
            # the collector's env slots split over the shards, each with a
            # draw stream of its own
            runner = ShardedFusedRunner(cfg, self.fn_env, self.replay, self.actor.epsilons,
                                        self.actor.env_state, cfg.seed + 5, mesh=self.mesh,
                                        **pacing)
        elif cfg.replay_plane == "multihost":
            # global env slots, pinned per global shard (the same streams
            # whichever process holds a shard)
            runner = MultiHostFusedRunner(
                cfg, self.fn_env, self.replay,
                epsilon_ladder(cfg.num_actors, cfg.base_eps, cfg.eps_alpha),
                cfg.seed + 5, self.collectives, **pacing)
        else:
            runner = FusedSystemRunner(cfg, self.device, self.fn_env, self.replay,
                                       self.actor.epsilons, self.actor.env_state,
                                       self.actor.draws, mesh=self.mesh, **pacing)
        self.fused_runner = runner
        pending_log = None
        try:
            # the log lags one dispatch: reading a dispatch's loss at once
            # would wait for it, the wait the deferred read-backs avoid
            while self._step < cfg.training_steps:
                sup.main_beat()
                if self._preempt_now():
                    break
                self._profile_gate()
                prev = self._step
                t0 = time.perf_counter()
                with step_span("fused_megastep", prev):
                    self.state, m, recorded = runner.step(self.state)
                t1 = time.perf_counter()
                self.update_seconds.append(t1 - t0)
                self.update_ends.append(t1)
                self._step += cfg.updates_per_dispatch
                self.last_metrics = m
                self._profile_tick(cfg.updates_per_dispatch)
                self._cadences(prev, self._step)
                if recorded and pending_log is not None:
                    self._log(*pending_log)
                pending_log = (m, self._step)
        finally:
            sup.stop.set()  # the drain below is not a stall
            self._stop_profile()
            runner.finish()
            if pending_log is not None:
                self._log(*pending_log)
            self._flush_log()
            # the collector continues from the runner's episodes and draws
            if isinstance(runner, ShardedFusedRunner):
                self.actor.env_state = runner.env_state_on(self.device)
            elif isinstance(runner, FusedSystemRunner):
                self.actor.env_state = runner.env_state
            self.actor.total_steps += runner.total_env_steps
            if cfg.snapshot_replay:
                # the carry after the hand-back, so it holds the runner's state
                self._snapshot_on_exit(extra=self._capture_carry_safe())

    # ------------------------------------------------------------- summary

    def metrics(self) -> dict:
        """The last update's metrics as host floats, plus run counters."""
        m = {k: float(v) for k, v in (self.last_metrics or {}).items()}
        episodes, reward_sum = self.replay.episode_totals()
        return {
            "step": self._step,
            "env_steps": self.env_steps,
            "replay_size": len(self.replay),
            "episodes": episodes,
            "mean_return": reward_sum / episodes if episodes else None,
            "compute_dtype": self.cfg.resolved_compute_dtype,
            "replay_plane": self.cfg.replay_plane,
            "backward_arm": self.backward_arm[0],
            **({"backward_arm_stride": self.backward_arm[1]}
               if self.backward_arm[0] == "ckpt" else {}),
            **m,
        }


def params_digest(net: torch.nn.Module) -> str:
    """SHA-256 of a network's parameters' bytes, in order: equal digests on
    two ranks mean bit-identical replicas."""
    import hashlib

    h = hashlib.sha256()
    for p in net.parameters():
        t = p.detach().cpu().contiguous()
        h.update(t.view(torch.uint8).numpy().tobytes() if t.dtype == torch.bfloat16
                 else t.numpy().tobytes())
    return h.hexdigest()


def _carried(x, like: torch.Tensor) -> torch.Tensor:
    """A carried published parameter (a tensor, or a snapshot's numpy array
    with bfloat16 as uint16 bits) on `like`'s device, in its dtype."""
    t = x if isinstance(x, torch.Tensor) else state_tensor(np.asarray(x))
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"carried parameter {tuple(t.shape)}/{t.dtype} != "
                         f"{tuple(like.shape)}/{like.dtype}")
    return t.to(like.device)


def main(argv=None):
    p = argparse.ArgumentParser(description="r2d2_tpu_torch trainer")
    p.add_argument("--preset", default="atari", choices=sorted(PRESETS))
    p.add_argument("--env", default=None, help="override env name (e.g. catch)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--mode", default="inline", choices=["inline", "threaded", "fused"],
                   help="inline: strict actor/learner alternation; threaded: actor and "
                        "sampler threads under a supervisor, batches staged through "
                        "pinned memory on the card; fused: one dispatch = K updates + a "
                        "collection chunk on the card (collector and replay 'device')")
    p.add_argument("--collector", default=None, choices=["host", "device"],
                   help="experience collection: the host actor, or whole chunks on the "
                        "card (collect.py; tensor env cores only)")
    p.add_argument("--replay", default=None,
                   choices=["host", "tiered", "device", "sharded", "multihost"],
                   help="replay data plane (default: the preset's replay_plane): host "
                        "ships one batch per update; tiered stages K batches per dispatch "
                        "through pinned memory (replay/tiered_store.py); device holds the "
                        "store on the card and gathers in the step (replay/device_store.py); "
                        "sharded holds one device store per dp shard "
                        "(replay/sharded_store.py); multihost does so across the processes "
                        "of --distributed (replay/multihost_store.py)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel shards (overrides the preset's dp_size)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel mesh size (overrides the preset's tp_size)")
    p.add_argument("--fsdp", type=int, default=None,
                   help="fsdp mesh-axis size (overrides the preset's fsdp_size): the Adam "
                        "moments shard over it; under partitioning=manual the batch does "
                        "too. Checkpoints hold whole moments, so --resume crosses layouts")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun's variables describe "
                        "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; gloo) before building "
                        "the trainer; pair with --replay multihost")
    p.add_argument("--updates-per-dispatch", type=int, default=None,
                   help="K learner updates per dispatch (tiered and device planes; alone, "
                        "it moves the host plane to the device plane)")
    p.add_argument("--model-preset", default=None,
                   help="named model-size preset (config.MODEL_PRESETS: wide/xl "
                        "widen the LSTM, deep/deep_wide add encoder layers) applied "
                        "over the run preset; --set still wins on single fields")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in checkpoint_dir")
    p.add_argument("--reshard", action="store_true",
                   help="with --resume: re-split a replay snapshot of another topology "
                        "(dp, process count, plane) over this one (replay/reshard.py) "
                        "instead of raising TopologyMismatch")
    p.add_argument("--snapshot-replay", action="store_true",
                   help="save the whole replay at the end of the run (and, when "
                        "preempted, the mid-run carry with it) and restore it on "
                        "--resume (replay/snapshot.py)")
    p.add_argument("--metrics", default=None, help="jsonl metrics file (metrics_path)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field (repeatable)")
    p.add_argument("--profile-dir", default=None,
                   help="write a Chrome trace of the updates after the first here")
    p.add_argument("--profile-steps", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu; or a comma-separated "
                        "list, one device per local dp shard (they may repeat: "
                        "cuda:0,cuda:0,cuda:0,cuda:0 runs four shards on one card); a plain "
                        "cuda with dp > 1 means cuda:0 .. cuda:dp-1")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    if args.mode == "threaded" and (args.distributed or args.replay == "multihost"):
        p.error("--distributed and --replay multihost run --mode inline or fused (the "
                "ranks' collectives stay in lockstep there; threaded would let a rank "
                "waiting on its queue fall out of step)")
    if args.distributed and not initialize_distributed():
        raise SystemExit("--distributed: no process group to join (WORLD_SIZE unset or 1)")
    device = resolve_device(parse_devices(args.device)[0])
    if device.type == "cuda":
        # init_train_state sets the card's numerics (config.set_fp32_numerics)
        print("TF32 is off for cuBLAS matmuls and cuDNN convolutions; bf16 matmuls sum "
              "in f32", file=sys.stderr)
    cfg = PRESETS[args.preset]()
    if args.model_preset:
        cfg = apply_model_preset(cfg, args.model_preset)
    overrides = {}
    if args.env:
        overrides["env_name"] = args.env
    if args.steps:
        overrides["training_steps"] = args.steps
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.metrics:
        overrides["metrics_path"] = args.metrics
    if args.replay:
        overrides["replay_plane"] = args.replay
    if args.dp is not None:
        overrides["dp_size"] = args.dp
    if args.tp is not None:
        overrides["tp_size"] = args.tp
    if args.fsdp is not None:
        overrides["fsdp_size"] = args.fsdp
    if args.reshard:
        overrides["reshard_on_resume"] = True
    if args.mode == "fused" and args.collector is None:
        args.collector = "device"  # the only collector run_fused takes
    if args.collector:
        overrides["collector"] = args.collector
        if args.collector == "device" and args.replay is None:
            overrides["replay_plane"] = "device"
    if args.updates_per_dispatch is not None:
        overrides["updates_per_dispatch"] = args.updates_per_dispatch
        # the JAX CLI's convenience for the single-card default: K > 1 on
        # the host plane takes the device plane; an explicit plane stays
        if (args.updates_per_dispatch > 1 and args.replay is None
                and args.collector != "device" and cfg.replay_plane == "host"):
            overrides["replay_plane"] = "device"
    if args.snapshot_replay:
        overrides["snapshot_replay"] = True
    overrides.update(parse_overrides(args.set))
    if overrides:
        cfg = cfg.replace(**overrides)

    # deterministic fault injection for drills (R2D2_FAULTS; utils/faults.py),
    # a no-op when the variable is unset
    install_from_env()
    trainer = Trainer(cfg, device=args.device, resume=args.resume,
                      profile_dir=args.profile_dir, profile_steps=args.profile_steps)
    t0 = time.perf_counter()
    try:
        if args.mode == "threaded":
            trainer.run_threaded()
        elif args.mode == "fused":
            trainer.run_fused()
        else:
            trainer.run_inline()
    except WorkerStalledError as e:
        # a wedged runtime exits with STALL_EXIT_CODE: restart with --resume
        from r2d2_tpu_torch.utils.supervision import exit_for_stall

        exit_for_stall(e)
    finally:
        trainer.metrics_logger.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    out = trainer.metrics()
    out["seconds"] = time.perf_counter() - t0
    out["mode"] = args.mode
    out["resumed_from"] = trainer._initial_step if trainer.resumed else None
    out["preempted"] = trainer.preempted
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ends = trainer.update_ends
    if len(ends) > 1:
        # the dispatches' host clock: ms per update between the first
        # dispatch's end and the last's (acting included), and the median
        # dispatch (the learner_update span) per update
        n = trainer.plane.steps_per_update
        out["ms_per_update_wall"] = (ends[-1] - ends[0]) * 1e3 / ((len(ends) - 1) * n)
        out["update_span_ms_p50"] = float(np.median(trainer.update_seconds)) * 1e3 / n
    if trainer.mesh is not None:
        out["dp"] = trainer.mesh.dp
        out["local_devices"] = [str(trainer.mesh.devices[g])
                                for g, p in enumerate(trainer.mesh.processes)
                                if p == process_index()]
    if cfg.replay_plane == "multihost":
        out["process_index"] = process_index()
        out["process_count"] = trainer.collectives.world
        out.update(trainer.collectives.stats())
    if trainer.mesh is not None:
        out["params_sha256"] = params_digest(trainer.state.net)
        out["tp"], out["fsdp"] = trainer.mesh.tp, trainer.mesh.fsdp
    out.update(getattr(trainer, "reshard_stats", {}))
    if device.type == "cuda":
        from r2d2_tpu_torch.ops import lstm_kernel

        out["kernel_launches"] = {k: v for k, v in lstm_kernel.launch_counts.items() if v}
    print(json.dumps(out))
    if trainer.preempted:
        # the SIGTERM became a clean cut: replay snapshot, carry and a
        # finalized checkpoint are on disk; rerun with --resume
        sys.exit(PREEMPT_EXIT_CODE)


if __name__ == "__main__":
    main()
