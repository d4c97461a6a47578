"""The tiered replay plane: the full-capacity host store, with K batches at
a time staged to the device through pinned memory (port of
r2d2_tpu/replay/tiered_store.py).

- The resident tier is the host ReplayBuffer's slab store, unchanged.
  `np.zeros` allocates lazily, so the paper's 2,000,000-transition store
  costs pages only for its filled prefix; nothing here touches the whole
  store.
- `sample_window_stack` draws K batches under one lock hold (K stratified
  tree draws in order, the stream `sample_batch` would consume) and gathers
  all their windows in one pass: the (K, B) coordinates are flattened and
  each field group crosses into the native core once
  (`gather_windows_multi`), writing straight into the staging buffers.
- The staging ring (`StagingRing`) has two slots. On the card a slot is a
  set of pinned host buffers (the numpy views of `pin_memory=True`
  tensors, which the gather fills) and a device slab of K batches; the
  copy runs `non_blocking` on a side stream, and an event marks it done.
  The consumer's stream waits on that event, runs the K updates, and
  records a second event: a slot's slab is refilled only after the copy
  stream has waited on it, and its pinned buffers only after their last
  copy is done. Only the ring is pinned, never the store.
- `TieredPrefetchPipeline` stages chunk k+1 on a thread while the
  learner's K-update dispatch consumes chunk k; `stop(rewind=True)` puts
  the sampling Generator back to its state before the earliest chunk not
  delivered, so a resumed run draws the same stream.

Staleness is settled at stage time: the gather copies bytes out of the
store under the lock, and the chunk carries the lock hold's pointer and lap
stamps for the deferred priority write-back, which drops the rows whose
slots were overwritten in between.

The disk tier (cfg.replay_disk_capacity > 0): logical blocks
[num_blocks, num_blocks + disk_blocks) live in memory-mapped segment
records (replay/disk_tier.py). The control plane covers both ranges (one
sum tree, extended per-sequence metadata), so a demoted block samples like
any other; its six per-step fields are paged in through a decode cache on
the staging thread. Demotion takes the lowest-priority host block, not the
oldest, and switches the write-back check to per-slot stamps.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from r2d2_tpu_torch.replay.disk_tier import DiskTier
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer, SampledBatch
from r2d2_tpu_torch.replay.block import state_host_dtype
from r2d2_tpu_torch.replay.sum_tree import SumTree
from r2d2_tpu_torch.utils.faults import fault_point, with_retries

# decoded disk records kept on the staging thread
_DISK_CACHE_RECORDS = 64

# the staged fields, in learner.DeviceBatch order
STAGED_FIELDS = (
    "obs", "last_action", "last_reward", "hidden", "action", "n_step_reward",
    "gamma", "burn_in_steps", "learning_steps", "forward_steps", "is_weights",
)


@dataclasses.dataclass
class StagedWindows:
    """K sample batches' windows stacked (K, B, ...) on the host, and the
    stamps of the one lock hold that drew them all."""

    obs: np.ndarray            # (K, B, seq_len, *obs_shape) uint8
    last_action: np.ndarray    # (K, B, seq_len) uint8
    last_reward: np.ndarray    # (K, B, seq_len) float32
    hidden: np.ndarray         # (K, B, 2, H) the state dtype's host storage
    action: np.ndarray         # (K, B, L) int32 (uint8 when gathered into a ring)
    n_step_reward: np.ndarray  # (K, B, L) float32
    gamma: np.ndarray          # (K, B, L) float32
    burn_in_steps: np.ndarray  # (K, B) int32
    learning_steps: np.ndarray # (K, B) int32
    forward_steps: np.ndarray  # (K, B) int32
    is_weights: np.ndarray     # (K, B) float32
    idxes: np.ndarray          # (K, B) int64, for the priority write-back
    old_ptr: int
    env_steps: int
    old_advances: int


@dataclasses.dataclass
class StagedChunk:
    """A StagedWindows lifted to the device: `batch` maps each staged field
    to its (K, B, ...) tensor in the store's dtype (learner.DeviceBatch.
    from_staged makes the stacked batch). On the card the tensors are a
    ring slot's slab, `event` marks their copy done, and `ring.release`
    hands the slot back after the updates that read it."""

    batch: Optional[Dict[str, torch.Tensor]]
    idxes: np.ndarray
    old_ptr: int
    old_advances: int
    # the sampling Generator's state before this chunk's draws: the rewind
    # point if the chunk is discarded at a preemption
    rng_state: Optional[dict] = None
    event: Optional[object] = None
    slot: Optional[int] = None


def staged_specs(cfg, k: int) -> Dict[str, tuple]:
    """{field: ((K, B, ...), numpy dtype)} of a staged chunk, in the store's
    dtypes."""
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    return {
        "obs": ((k, B, T, *cfg.obs_shape), np.uint8),
        "last_action": ((k, B, T), np.uint8),
        "last_reward": ((k, B, T), np.float32),
        "hidden": ((k, B, 2, cfg.hidden_dim), state_host_dtype(cfg.state_dtype)),
        "action": ((k, B, L), np.uint8),
        "n_step_reward": ((k, B, L), np.float32),
        "gamma": ((k, B, L), np.float32),
        "burn_in_steps": ((k, B), np.int32),
        "learning_steps": ((k, B), np.int32),
        "forward_steps": ((k, B), np.int32),
        "is_weights": ((k, B), np.float32),
    }


class StagingStopped(Exception):
    """A wait for a free ring slot was cut by the pipeline's stop."""


class StagingRing:
    """Two (or `slots`) staging slots of one chunk geometry.

    On a CUDA device each slot holds pinned host buffers and a device slab,
    and copies run on the ring's side stream: `lift` issues them after the
    stream waits on the slot's last consumer event, and records the copy's
    event; `release` records the consumer event on the current stream (the
    one that ran the updates). On the CPU a slot is host tensors and `lift`
    hands out their copies. Slots are taken in ring order, so chunks are
    consumed in the order they were staged."""

    def __init__(self, specs: Dict[str, tuple], device, slots: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.host, self.host_np, self.dev = [], [], []
        for _ in range(slots):
            host, views, dev = {}, {}, {}
            for name, (shape, dt) in specs.items():
                tdt = _torch_dtype(dt)
                host[name] = torch.empty(shape, dtype=tdt, pin_memory=self.cuda)
                views[name] = host[name].numpy().view(dt)
                if self.cuda:
                    dev[name] = torch.empty(shape, dtype=tdt, device=self.device)
            self.host.append(host)
            self.host_np.append(views)
            self.dev.append(dev)
        self.copied = [None] * slots     # each slot's last copy
        self.consumed = [None] * slots   # each slot's last consumer
        self._free = [True] * slots
        self._next = 0
        self._cv = threading.Condition()

    def nbytes(self) -> int:
        """Bytes of one slot's buffers (pinned host, and again on the card)."""
        return sum(t.numel() * t.element_size() for t in self.host[0].values())

    def acquire(self, stop: Optional[threading.Event] = None) -> int:
        """The next slot in ring order, once it is free; its pinned buffers
        are then no longer read by a copy."""
        with self._cv:
            i = self._next
            while not self._free[i]:
                if stop is not None and stop.is_set():
                    raise StagingStopped()
                self._cv.wait(timeout=0.1)
            self._free[i] = False
            self._next = (i + 1) % len(self._free)
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        return i

    def lift(self, i: int):
        """(slot i's tensors on the device, the copy's event or None)."""
        if not self.cuda:
            return {k: v.clone() for k, v in self.host[i].items()}, None
        with torch.cuda.stream(self.stream):
            if self.consumed[i] is not None:
                self.stream.wait_event(self.consumed[i])
            for name, dst in self.dev[i].items():
                dst.copy_(self.host[i][name], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.copied[i] = event
        return self.dev[i], event

    def release(self, i: int, consumed: bool = True) -> None:
        """Hand slot i back; `consumed`: after the updates that read its
        slab were issued on the current stream."""
        if self.cuda and consumed:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.consumed[i] = event
        with self._cv:
            self._free[i] = True
            self._cv.notify_all()

    def wake(self) -> None:
        with self._cv:
            self._cv.notify_all()


def _torch_dtype(dt) -> torch.dtype:
    """The tensor dtype whose numpy view holds `dt` (bf16 bits: int16)."""
    dt = np.dtype(dt)
    if dt == np.uint16:
        return torch.int16
    return torch.from_numpy(np.zeros(0, dt)).dtype


class TieredReplayBuffer(ReplayBuffer):
    """ReplayBuffer (the full-capacity host data plane and its control
    plane) plus the K-batch window gather the staging tier feeds on.

    `sample_batch` is the inherited one while the disk tier is off: the
    reference `sample_window_stack` matches bit for bit (the same Generator
    consumption, clamps and stamps)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.disk: Optional[DiskTier] = None
        self._disk_ptr = 0
        self._demotions = 0
        self._evictions = 0
        self._disk_cache: "collections.OrderedDict[int, dict]" = collections.OrderedDict()
        if cfg.replay_disk_capacity <= 0:
            return
        self.disk = DiskTier(cfg)
        nb, S = cfg.num_blocks, cfg.seqs_per_block
        total = nb + self.disk.disk_blocks
        # the control plane grows over the disk-resident sequences: their
        # leaves stay live in the tree, and the per-sequence metadata
        # resolves draws without touching a segment. The extra leaves start
        # at zero, so draws are the plain tree's until something demotes.
        self.tree = SumTree(total * S, cfg.prio_exponent, cfg.is_exponent, native=self.native)
        self.learning_sum = np.zeros(total, np.int64)
        self.occupied = np.zeros(total, bool)
        self.num_seq_store = np.zeros(total, np.int32)
        self.slot_stamp = np.zeros(total, np.int64)
        self.hidden_store = np.zeros((total, S, 2, cfg.hidden_dim),
                                     dtype=state_host_dtype(cfg.state_dtype))
        self.burn_in_store = np.zeros((total, S), dtype=np.int32)
        self.learning_store = np.zeros((total, S), dtype=np.int32)
        self.forward_store = np.zeros((total, S), dtype=np.int32)
        self.task_store = np.zeros((total,), dtype=np.int32)

    # ------------------------------------------------------- disk-tier spill

    def add_block(self, block, priorities, episode_reward) -> None:
        if self.disk is None:
            super().add_block(block, priorities, episode_reward)
            return
        with self.lock:
            if self.occupied[self.block_ptr]:
                self._spill_lowest(self.block_ptr)
            self._write_block_locked(block, self.block_ptr)
            self._account_add(block.num_sequences, int(block.learning_steps.sum()),
                              priorities, episode_reward)

    def _spill_lowest(self, ptr: int) -> None:
        """Demote the lowest-priority occupied host block to the disk ring,
        leaving slab slot `ptr` free for the incoming block. Caller holds
        the lock. Order: retire the disk slot's old occupant, write the
        segment record, then move the accounting, so a kill at any point
        leaves every referenced record whole."""
        cfg = self.cfg
        nb, S = cfg.num_blocks, cfg.seqs_per_block
        leaf = self.tree.priorities_of(np.arange(nb * S, dtype=np.int64)).reshape(nb, S)
        score = np.where(self.occupied[:nb], leaf.max(axis=1), np.inf)
        victim = int(np.argmin(score))
        dslot = self._disk_ptr
        dl = nb + dslot
        if self.occupied[dl]:
            # true eviction: the disk ring wrapped onto a live record
            self._retire_slots(np.array([dl]))
            self._evictions += 1
        self._disk_cache.pop(dslot, None)
        # the victim is still accounted at its host slot if the process
        # dies in here (disk.write fires before the bytes land)
        self.disk.write_block(dslot, {
            "obs": self.obs_store[victim],
            "last_action": self.last_action_store[victim],
            "last_reward": self.last_reward_store[victim],
            "action": self.action_store[victim],
            "n_step_reward": self.n_step_reward_store[victim],
            "gamma": self.gamma_store[victim],
        })
        # leaves move raw (already ^alpha)
        vidx = np.arange(victim * S, (victim + 1) * S, dtype=np.int64)
        self.tree.set_raw(np.arange(dl * S, (dl + 1) * S, dtype=np.int64),
                          self.tree.priorities_of(vidx))
        self.learning_sum[dl] = self.learning_sum[victim]
        self.occupied[dl] = True
        self.num_seq_store[dl] = self.num_seq_store[victim]
        self.hidden_store[dl] = self.hidden_store[victim]
        self.burn_in_store[dl] = self.burn_in_store[victim]
        self.learning_store[dl] = self.learning_store[victim]
        self.forward_store[dl] = self.forward_store[victim]
        self.task_store[dl] = self.task_store[victim]
        if victim != ptr:
            # the pointer's occupant moves into the victim's freed slab
            # slot, so the incoming block lands at the pointer as every
            # writer assumes
            for name in ("obs", "last_action", "last_reward", "action",
                         "n_step_reward", "gamma", "hidden", "burn_in",
                         "learning", "forward", "task"):
                store = getattr(self, name + "_store")
                store[victim] = store[ptr]
            pidx = np.arange(ptr * S, (ptr + 1) * S, dtype=np.int64)
            self.tree.set_raw(vidx, self.tree.priorities_of(pidx))
            self.tree.set_raw(pidx, np.zeros(S))
            self.learning_sum[victim] = self.learning_sum[ptr]
            self.num_seq_store[victim] = self.num_seq_store[ptr]
        else:
            self.tree.set_raw(vidx, np.zeros(S))
        self.learning_sum[ptr] = 0
        self.num_seq_store[ptr] = 0
        self.occupied[ptr] = False
        # the size stays: the demoted block remains sampleable. Every
        # touched slot stamps the clock, so write-backs aimed at its old
        # occupant are dropped.
        self.ptr_advances += 1
        self.slot_stamp[[victim, dl, ptr]] = self.ptr_advances
        self._disk_ptr = (dslot + 1) % self.disk.disk_blocks
        self._demotions += 1

    def _disk_record(self, dslot: int) -> dict:
        """The decoded record of disk slot `dslot`, through the LRU cache.
        Caller holds the lock."""
        rec = self._disk_cache.get(dslot)
        if rec is None:
            rec = self.disk.read_block(dslot)
            self._disk_cache[dslot] = rec
            while len(self._disk_cache) > _DISK_CACHE_RECORDS:
                self._disk_cache.popitem(last=False)
        else:
            self._disk_cache.move_to_end(dslot)
        return rec

    def _fill_disk_rows(self, b, win_start, lstart, obs, last_action,
                        last_reward, action, n_step_reward, gamma) -> None:
        """Overwrite the gathered rows whose draws landed on disk-resident
        blocks from their decoded records, with the slab gather's clamps:
        a window from a demoted block is the same window as before."""
        cfg = self.cfg
        nb = cfg.num_blocks
        t = np.arange(cfg.seq_len)
        tl = np.arange(cfg.learning_steps)
        for i in np.nonzero(b >= nb)[0]:
            rec = self._disk_record(int(b[i]) - nb)
            rows = np.clip(win_start[i] + t, 0, cfg.block_slot_len - 1)
            obs[i] = rec["obs"][rows]
            last_action[i] = rec["last_action"][rows]
            last_reward[i] = rec["last_reward"][rows]
            lrows = np.clip(lstart[i] + tl, 0, cfg.block_length - 1)
            action[i] = rec["action"][lrows]
            n_step_reward[i] = rec["n_step_reward"][lrows]
            gamma[i] = rec["gamma"][lrows]

    def sample_batch(self, rng: np.random.Generator) -> SampledBatch:
        if self.disk is None:
            return super().sample_batch(rng)
        # a one-batch stack: the same Generator consumption, clamps and
        # stamps as the inherited path, plus the disk rows
        sw = self.sample_window_stack(rng, 1)
        out = SampledBatch(
            obs=sw.obs[0], last_action=sw.last_action[0], last_reward=sw.last_reward[0],
            hidden=sw.hidden[0], action=sw.action[0], n_step_reward=sw.n_step_reward[0],
            gamma=sw.gamma[0], burn_in_steps=sw.burn_in_steps[0],
            learning_steps=sw.learning_steps[0], forward_steps=sw.forward_steps[0],
            is_weights=sw.is_weights[0], idxes=sw.idxes[0], old_ptr=sw.old_ptr,
            env_steps=sw.env_steps, old_advances=sw.old_advances,
        )
        if self.cfg.num_tasks > 1:
            # the draws' blocks (a demoted block keeps its task at its disk slot)
            out.task = self.task_store[sw.idxes[0] // self.cfg.seqs_per_block]
        return out

    def disk_stats(self) -> dict:
        """The disk tier's counters ({} when it is off)."""
        if self.disk is None:
            return {}
        with self.lock:
            st = self.disk.stats()
            st["disk_occupied"] = int(self.occupied[self.cfg.num_blocks:].sum())
            st["disk_demotions"] = self._demotions
            st["disk_evictions"] = self._evictions
        return st

    def sample_window_stack(self, rng: np.random.Generator, k: int,
                            out: Optional[Dict[str, np.ndarray]] = None) -> StagedWindows:
        """K batches drawn under one lock hold. `out` (staged_specs'
        arrays, a ring slot's pinned buffers) receives the gather in the
        store's dtypes; without it fresh arrays are returned, the actions
        as int32."""
        cfg = self.cfg
        L, T, B = cfg.learning_steps, cfg.seq_len, cfg.batch_size
        with self.lock:
            draws = [self._draw(rng) for _ in range(k)]
            # flattened (K*B,) coordinates: one gather per field group
            b = np.concatenate([d[0] for d in draws])
            s = np.concatenate([d[1] for d in draws])
            idxes = np.stack([d[2] for d in draws])
            is_weights = np.stack([d[3] for d in draws])

            burn = self.burn_in_store[b, s]
            learn = self.learning_store[b, s]
            fwd = self.forward_store[b, s]
            first_burn = self.burn_in_store[b, 0]
            win_start = first_burn + s * L - burn
            lstart = s * L

            # disk mode: the bulk gather reads row 0 of the slab for
            # disk-resident draws, which the decoded records overwrite
            bg = b if self.disk is None else np.minimum(b, cfg.num_blocks - 1)
            flat = None if out is None else {
                name: out[name].reshape(k * B, *out[name].shape[2:])
                for name in ("obs", "last_action", "last_reward", "action",
                             "n_step_reward", "gamma")}
            if self.native is not None:
                obs, last_action, last_reward = self.native.gather_windows_multi(
                    [self.obs_store, self.last_action_store, self.last_reward_store],
                    bg, win_start, T,
                    outs=None if flat is None else [flat["obs"], flat["last_action"],
                                                     flat["last_reward"]],
                )
                action, n_step_reward, gamma = self.native.gather_windows_multi(
                    [self.action_store, self.n_step_reward_store, self.gamma_store],
                    bg, lstart, L,
                    outs=None if flat is None else [flat["action"], flat["n_step_reward"],
                                                     flat["gamma"]],
                )
            else:
                t = np.arange(T)
                rows = win_start[:, None] + t[None, :]
                np.clip(rows, 0, cfg.block_slot_len - 1, out=rows)
                bcol = bg[:, None]
                tl = np.arange(L)
                lrows = lstart[:, None] + tl[None, :]
                np.clip(lrows, 0, cfg.block_length - 1, out=lrows)
                gathered = {
                    "obs": self.obs_store[bcol, rows],
                    "last_action": self.last_action_store[bcol, rows],
                    "last_reward": self.last_reward_store[bcol, rows],
                    "action": self.action_store[bcol, lrows],
                    "n_step_reward": self.n_step_reward_store[bcol, lrows],
                    "gamma": self.gamma_store[bcol, lrows],
                }
                if flat is not None:
                    for name, v in gathered.items():
                        flat[name][...] = v
                    gathered = flat
                obs, last_action, last_reward, action, n_step_reward, gamma = (
                    gathered[n] for n in ("obs", "last_action", "last_reward", "action",
                                          "n_step_reward", "gamma"))

            if self.disk is not None:
                self._fill_disk_rows(b, win_start, lstart, obs, last_action, last_reward,
                                     action, n_step_reward, gamma)

            hidden = self.hidden_store[b, s]
            old_ptr = self.block_ptr
            env_steps = self.env_steps
            old_advances = self.ptr_advances

        def kb(x):
            return x.reshape(k, B, *x.shape[1:])

        fields = dict(
            obs=kb(obs), last_action=kb(last_action), last_reward=kb(last_reward),
            hidden=kb(hidden), action=kb(action), n_step_reward=kb(n_step_reward),
            gamma=kb(gamma), burn_in_steps=kb(burn.astype(np.int32)),
            learning_steps=kb(learn.astype(np.int32)),
            forward_steps=kb(fwd.astype(np.int32)), is_weights=is_weights,
        )
        if out is None:
            fields["action"] = fields["action"].astype(np.int32)
        else:
            for name in ("hidden", "burn_in_steps", "learning_steps", "forward_steps",
                         "is_weights"):
                out[name][...] = fields[name]
            fields = {name: out[name] for name in STAGED_FIELDS}
        return StagedWindows(**fields, idxes=idxes, old_ptr=old_ptr, env_steps=env_steps,
                             old_advances=old_advances)


def stage_chunk(replay: TieredReplayBuffer, rng: np.random.Generator, k: int,
                ring: StagingRing, timer=None,
                stop: Optional[threading.Event] = None) -> StagedChunk:
    """Draw and gather one K-batch chunk into the next ring slot's buffers
    and start its copy to the device. The slot is taken before the draw, so
    a stop while waiting for it draws nothing. A failed copy is retried from
    the already-gathered buffers (the fault site ``tiered.stage_h2d``): a
    retry never draws again. `timer` (utils.profiling.TransferTimer) times
    the gather and the copies' issue."""
    i = ring.acquire(stop)
    try:
        cm = timer.h2d(ring.nbytes()) if timer is not None else contextlib.nullcontext()
        with cm:
            pre_state = rng.bit_generator.state
            sw = replay.sample_window_stack(rng, k, out=ring.host_np[i])

            def lift():
                fault_point("tiered.stage_h2d")
                return ring.lift(i)

            batch, event = with_retries(lift, "tiered.stage_h2d")
    except BaseException:
        ring.release(i, consumed=False)
        raise
    return StagedChunk(batch=batch, idxes=sw.idxes, old_ptr=sw.old_ptr,
                       old_advances=sw.old_advances,
                       rng_state=pre_state, event=event, slot=i)


class TieredPrefetchPipeline:
    """Double-buffered staging: a thread stages chunk k+1 (the gather into
    a pinned slot and the copy on the side stream) while the consumer's K
    updates run on chunk k. The ring's two slots are the backpressure: the
    thread waits for the slot the consumer hands back. A crash on the
    staging thread is raised again from get()."""

    def __init__(self, replay: TieredReplayBuffer, rng: np.random.Generator, k: int,
                 ring: StagingRing, timer=None, depth: int = 1):
        self.replay = replay
        self.rng = rng
        self.k = k
        self.ring = ring
        self.timer = timer
        self.q: "queue.Queue[StagedChunk]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        # the Generator's state before the draw of a chunk staged but not yet
        # queued: the rewind point if stop(rewind=True) catches it in flight
        self._inflight_state: Optional[dict] = None
        self._inflight: Optional[StagedChunk] = None
        self._thread = threading.Thread(target=self._run, name="tiered-stage", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                if not self.replay.can_sample():
                    time.sleep(0.01)
                    continue
                self._inflight_state = self.rng.bit_generator.state
                # r2d2: disable=cross-thread-unguarded-write  (this thread's own; stop() writes it only after joining this thread)
                self._inflight = stage_chunk(self.replay, self.rng, self.k, self.ring,
                                             self.timer, self._stop)
                while not self._stop.is_set():
                    try:
                        self.q.put(self._inflight, timeout=0.1)
                        self._inflight = None  # r2d2: disable=cross-thread-unguarded-write  (this thread's own, as above)
                        self._inflight_state = None
                        break
                    except queue.Full:
                        pass
        except StagingStopped:
            pass
        except BaseException as e:  # noqa: BLE001 — raised again from get()
            self._err = e

    def get(self) -> StagedChunk:
        """The next staged chunk; the time blocked here is TransferTimer
        wait (the part of the staging the updates did not hide)."""
        cm = self.timer.wait() if self.timer is not None else contextlib.nullcontext()
        with cm:
            while True:
                if self._err is not None:
                    raise RuntimeError("tiered staging thread died") from self._err
                try:
                    return self.q.get(timeout=0.5)
                except queue.Empty:
                    if not self._thread.is_alive() and self._err is None:
                        raise RuntimeError("tiered staging thread exited")

    def stop(self, rewind: bool = False) -> None:
        """Stop the staging thread and discard the chunks not delivered
        (their slots go back to the ring). With rewind=True (the preemption
        path) the sampling Generator goes back to its state before the
        earliest of them, so a resumed run draws them again identically."""
        self._stop.set()
        self.ring.wake()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("tiered staging thread did not stop")
        if self.ring.stream is not None:
            # a discarded chunk's copy may still be landing in its slab
            self.ring.stream.synchronize()
        states = []
        while True:  # in draw order
            try:
                chunk = self.q.get_nowait()
            except queue.Empty:
                break
            states.append(chunk.rng_state)
            self.ring.release(chunk.slot, consumed=False)
        if self._inflight is not None:
            self.ring.release(self._inflight.slot, consumed=False)
            # r2d2: disable=cross-thread-unguarded-write  (after the join above: the staging thread is gone)
            self._inflight = None
        states.append(self._inflight_state)
        if rewind:
            for st in states:
                if st is not None:
                    self.rng.bit_generator.state = st
                    break
