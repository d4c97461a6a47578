"""Learner: the double-Q, value-rescaled, prioritized update (port of
r2d2_tpu/learner.py, host-batch path).

Per update: the online unroll (one fused forward launch, one seam-backward
launch through autograd) and the target unroll under ``torch.no_grad()``
(one forward launch).

- double-Q target: a* = argmax_a Q_online(s_{t+n}, a) with no gradient,
  evaluated by the target net; y = h(R_n + gamma_n * h^-1(Q_target)).
- IS-weighted masked MSE over the global count of valid learning steps.
- the float32 island of the JAX learner (``r2d2_tpu/learner.py:153-173``):
  the target, value rescaling, TD, priorities, IS weights and the loss are
  float32 whatever the compute dtype.
- mixed per-sequence TD priorities, computed on the device.
- optimizer: a global-norm clip written out by hand — optax's
  ``clip_by_global_norm`` has no epsilon in its denominator, while
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 — then Adam with
  ``eps=cfg.adam_eps``. The cosine schedule is written out as well.
- target sync: the target parameters take the online ones every
  ``target_net_update_interval`` updates, inside the step.

PyTorch updates the networks and the optimizer state in place; the step
returns the same TrainState object.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config, resolve_device, set_fp32_numerics
from r2d2_tpu_torch.models.r2d2 import R2D2Network, init_params
from r2d2_tpu_torch.ops.act_tail import first_argmax
from r2d2_tpu_torch.ops.priority import mixed_td_priorities
from r2d2_tpu_torch.ops.value_rescale import inverse_value_rescale, value_rescale
from r2d2_tpu_torch.replay.block import state_tensor


# the device dtype of each DeviceBatch field made from a SampledBatch; None
# keeps the stored one (obs uint8; the carry float32, or bf16 bits viewed as
# bfloat16: replay.block.state_tensor)
_FIELD_DTYPES = {
    "obs": None, "last_action": torch.int64, "last_reward": torch.float32, "hidden": None,
    "action": torch.int64, "n_step_reward": torch.float32, "gamma": torch.float32,
    "burn_in_steps": torch.int32, "learning_steps": torch.int32,
    "forward_steps": torch.int32, "is_weights": torch.float32,
}


class _BatchFields(NamedTuple):
    """The tensor fields of a DeviceBatch, in their order."""

    obs: torch.Tensor            # (B, T, *obs_shape) uint8
    last_action: torch.Tensor    # (B, T) int64
    last_reward: torch.Tensor    # (B, T) float32
    hidden: torch.Tensor         # (B, 2, H) in the state dtype (float32 or bfloat16)
    action: torch.Tensor         # (B, L) int64
    n_step_reward: torch.Tensor  # (B, L) float32
    gamma: torch.Tensor          # (B, L) float32
    burn_in_steps: torch.Tensor  # (B,) int32
    learning_steps: torch.Tensor # (B,) int32
    forward_steps: torch.Tensor  # (B,) int32
    is_weights: torch.Tensor     # (B,) float32


class DeviceBatch(_BatchFields):
    """The device-side view of a replay SampledBatch: the eleven fields of
    the single-task path as a NamedTuple, plus `task`, the multi-task
    plane's (B,) int32 per-sequence task id (None on single-task configs),
    as an attribute outside the tuple, so a single-task batch iterates,
    unpacks and names its fields as before (``DeviceBatch(*fields)``)."""

    task: Optional[torch.Tensor] = None

    def __new__(cls, *fields, task: Optional[torch.Tensor] = None, **named):
        self = super().__new__(cls, *fields, **named)
        self.task = task
        return self

    def _replace(self, **kw) -> "DeviceBatch":
        task = kw.pop("task", self.task)
        return DeviceBatch(*super()._replace(**kw), task=task)

    @classmethod
    def from_sampled(cls, b, device) -> "DeviceBatch":
        """Copied from pageable host memory (the copy waits for the host)."""
        out = []
        for name, dtype in _FIELD_DTYPES.items():
            t = state_tensor(getattr(b, name))
            if dtype is not None:
                t = t.to(dtype)
            out.append(t.to(device, non_blocking=True))
        task = getattr(b, "task", None)
        if task is not None:
            task = torch.from_numpy(np.asarray(task, np.int32)).to(device, non_blocking=True)
        return cls(*out, task=task)

    def rows(self, sl: slice, device=None) -> "DeviceBatch":
        """Rows `sl` of every field (a dp shard's slice), on `device`."""
        return DeviceBatch(*(x[sl].to(device or x.device) for x in self),
                           task=None if self.task is None else self.task[sl].to(
                               device or self.task.device))

    def tensors(self):
        """The batch's tensors, the task's where there is one."""
        return [*self] + ([] if self.task is None else [self.task])

    def at(self, k: int) -> "DeviceBatch":
        """Slice k of a stacked (K, B, ...) batch."""
        return DeviceBatch(*(x[k] for x in self),
                           task=None if self.task is None else self.task[k])

    @classmethod
    def from_staged(cls, fields: dict) -> "DeviceBatch":
        """A staged chunk's tensors ((K, B, ...) in the host store's dtypes,
        on their device; bf16 carries as int16 bits) as a stacked
        DeviceBatch: the index fields widened, the carry bits viewed as
        bfloat16, on the device and the current stream."""
        out = []
        for name, dtype in _FIELD_DTYPES.items():
            t = fields[name]
            if t.dtype == torch.int16:
                t = t.view(torch.bfloat16)
            out.append(t if dtype is None or t.dtype == dtype else t.to(dtype))
        return cls(*out, task=fields.get("task"))


class PinnedStager:
    """Host->device staging of sampled batches through a ring of pinned host
    buffers and a side CUDA stream, so the copies overlap the updates.

    `stage(b)` (the sampler's thread) casts each field of a SampledBatch
    into the next slot's pinned buffers, in its device dtype, issues the
    copies on the side stream and records an event: -> (DeviceBatch,
    event). A slot is rewritten only after its last copy's event has
    completed, so a ring of `slots` holds the batch queue's items plus
    those in flight. `consume(batch, event)` (the learner's thread) makes
    the current stream wait for the event on the device (no host sync) and
    records the batch's tensors on it, so the caching allocator keeps them
    until the update that reads them is done. The staging is timed by
    `timer.h2d` (gather and copy issue)."""

    def __init__(self, device, slots: int, timer):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.timer = timer
        self._buffers: list = [None] * slots
        self._events: list = [None] * slots
        self._next = 0

    def _slot(self, specs):
        """(index, pinned buffers) of the next slot, for [(shape, dtype)]."""
        i = self._next
        self._next = (i + 1) % len(self._buffers)
        if self._events[i] is not None:
            self._events[i].synchronize()  # its last copy has left the buffers
        bufs = self._buffers[i]
        if bufs is None or [(p.shape, p.dtype) for p in bufs] != specs:
            bufs = self._buffers[i] = [torch.empty(shape, dtype=dt, pin_memory=True)
                                       for shape, dt in specs]
        return i, bufs

    def stage(self, b):
        srcs = [state_tensor(getattr(b, name)) for name in _FIELD_DTYPES]
        dtypes = [dt or t.dtype for dt, t in zip(_FIELD_DTYPES.values(), srcs)]
        task = getattr(b, "task", None)
        if task is not None:
            srcs.append(torch.from_numpy(np.asarray(task, np.int32)))
            dtypes.append(torch.int32)
        nbytes = sum(t.numel() * dt.itemsize for t, dt in zip(srcs, dtypes))
        with self.timer.h2d(nbytes):
            i, bufs = self._slot([(t.shape, dt) for t, dt in zip(srcs, dtypes)])
            for buf, src in zip(bufs, srcs):
                buf.copy_(src)
            with torch.cuda.stream(self.stream):
                dev = [buf.to(self.device, non_blocking=True) for buf in bufs]
                event = torch.cuda.Event()
                event.record(self.stream)
            self._events[i] = event
        return DeviceBatch(*dev[:len(_FIELD_DTYPES)],
                           task=dev[-1] if task is not None else None), event

    @staticmethod
    def consume(batch: "DeviceBatch", event) -> "DeviceBatch":
        stream = torch.cuda.current_stream(batch.obs.device)
        stream.wait_event(event)
        for t in batch.tensors():
            t.record_stream(stream)
        return batch


def start_read_back(t: torch.Tensor):
    """Start a tensor's copy to the host without waiting for it: (pinned
    tensor, event) on the card, the array itself on the CPU. A dispatch's
    priorities are read back this way and collected (finish_read_back) a
    dispatch later, while the next one runs."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def finish_read_back(started) -> np.ndarray:
    """The host array of a start_read_back (or an array as it is)."""
    if isinstance(started, tuple):
        host, event = started
        event.synchronize()
        return host.numpy()
    return np.asarray(started)


@dataclasses.dataclass
class TrainState:
    net: R2D2Network          # online network (trained)
    target_net: R2D2Network   # target network (no gradients)
    optimizer: torch.optim.Optimizer
    step: int = 0             # updates applied so far


def lr_at(cfg: R2D2Config, count: int) -> float:
    """The learning rate of update number `count` (0-based): constant, or
    optax's cosine_decay_schedule over training_steps, holding at
    lr * lr_final_frac past the horizon."""
    if cfg.lr_schedule != "cosine":
        return cfg.lr
    steps = max(cfg.training_steps, 1)
    frac = min(count, steps) / steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return cfg.lr * ((1.0 - cfg.lr_final_frac) * cosine + cfg.lr_final_frac)


def make_optimizer(cfg: R2D2Config, params) -> torch.optim.Optimizer:
    """Adam(lr, eps=adam_eps); the clip before it is clip_by_global_norm_."""
    return torch.optim.Adam(params, lr=cfg.lr, eps=cfg.adam_eps)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g -> g / norm * max_norm when
    norm >= max_norm, with no epsilon. Returns the pre-clip norm. No host
    synchronisation: the choice is a select on the device."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def init_train_state(cfg: R2D2Config, device="cuda", seed=None) -> Tuple[R2D2Network, TrainState]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_numerics()
    net = init_params(cfg, cfg.seed if seed is None else seed, dev)
    target = copy.deepcopy(net).requires_grad_(False)
    return net, TrainState(net, target, make_optimizer(cfg, net.parameters()), 0)


def make_loss_fn(cfg: R2D2Config):
    """(net, target_net, batch, denom) -> (loss, (priorities, aux))."""
    eps = cfg.value_rescale_eps

    def loss_fn(net, target_net, b: DeviceBatch, denom):
        # b.task is None on single-task configs; a multi-task batch
        # conditions both networks' heads per sequence
        args = (b.obs, b.last_action, b.last_reward, b.hidden,
                b.burn_in_steps, b.learning_steps, b.forward_steps, b.task)
        q_learn, q_boot_online, mask = net(*args)
        # float32 island: the heads emit float32 (R2D2Network._dueling); the
        # casts pin the contract, as in the JAX learner
        with torch.no_grad():
            _, q_boot_target, _ = target_net(*args)
            # double-Q: online selects, target evaluates
            a_star = first_argmax(q_boot_online.detach())
            q_tgt = torch.gather(q_boot_target, -1, a_star[..., None].long())[..., 0].float()
            y = value_rescale(
                b.n_step_reward.float() + b.gamma.float() * inverse_value_rescale(q_tgt, eps),
                eps,
            )
        q_taken = torch.gather(q_learn, -1, b.action[..., None])[..., 0].float()
        td = y - q_taken
        w = b.is_weights.float()[:, None]
        loss = torch.sum(w * torch.square(td) * mask) / denom

        with torch.no_grad():
            q_taken = q_taken.detach()
            abs_td = torch.abs(td.detach()) * mask
            priorities = mixed_td_priorities(abs_td, mask, cfg.td_mix_eta)
            aux = {
                "q_mean": torch.sum(q_taken * mask) / denom,
                "target_mean": torch.sum(y * mask) / denom,
                "td_abs_mean": torch.sum(abs_td) / denom,
            }
        return loss, (priorities, aux)

    return loss_fn


def make_train_step(cfg: R2D2Config, mesh=None):
    """(state, batch) -> (state, metrics, priorities); updates `state` in
    place. Metrics and priorities stay on the device. With a `mesh` (the
    host, tiered and device planes, whose one store feeds every shard) the
    batch's rows split over the batch shards' devices (the dp shards, or
    dp x fsdp under partitioning="manual", ZeRO-2) and the update is
    make_sharded_train_step's: the shards' gradients summed, each through
    its tp group, Adam on the fsdp moment shards."""
    if mesh is not None:
        from r2d2_tpu_torch.parallel.mesh import (
            data_shard_devices,
            manual_data_axes,
            shard_slices,
        )

        axes = manual_data_axes(mesh) if cfg.resolved_partitioning == "manual" else ("dp",)
        sharded = make_sharded_train_step(cfg, mesh=mesh, data_axes=axes)
        devices = [mesh.device_at(d, 0, f) for d, f in data_shard_devices(mesh, axes)]

        def split_step(state: TrainState, b: DeviceBatch):
            parts = [b.rows(sl, dev) for sl, dev in
                     zip(shard_slices(b.obs.shape[0], len(devices)), devices)]
            state, metrics, priorities = sharded(state, parts)
            return state, metrics, priorities.reshape(-1)

        return split_step
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, b: DeviceBatch):
        if cfg.zero_state_replay:
            b = b._replace(hidden=torch.zeros_like(b.hidden))
        denom = torch.clamp(b.learning_steps.sum().float(), min=1.0)
        params = list(state.net.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        loss, (priorities, aux) = loss_fn(state.net, state.target_net, b, denom)
        loss.backward()
        g_norm = _apply_gradients(cfg, state, params)
        metrics = {"loss": loss.detach(), "grad_norm": g_norm, **aux}
        return state, metrics, priorities

    return train_step


def _apply_gradients(cfg: R2D2Config, state: TrainState, params) -> torch.Tensor:
    """The optimizer half of an update, on the gradients in `params`' .grad:
    the global-norm clip, one Adam step at this update's learning rate, the
    step count and the target sync. -> the pre-clip gradient norm."""
    g_norm = clip_by_global_norm_([p.grad for p in params], cfg.grad_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = lr_at(cfg, state.step)
    state.optimizer.step()
    state.step += 1
    if state.step % cfg.target_net_update_interval == 0:
        with torch.no_grad():
            for t, p in zip(state.target_net.parameters(), params):
                t.copy_(p)
    return g_norm


def make_stacked_batch_train_step(cfg: R2D2Config, num_steps: int, mesh=None):
    """K train steps in one dispatch over a staged stacked batch (the
    tiered plane's consumer; r2d2_tpu/learner.py's function of the same
    name): (state, DeviceBatch with (K, B, ...) leaves) -> (state, the
    last step's metrics, priorities (K, B)). Step k trains on the k-th
    slice of every leaf, exactly as K make_train_step calls would."""
    step = make_train_step(cfg, mesh)

    def multi(state: TrainState, stacked: DeviceBatch):
        if stacked.obs.shape[0] != num_steps:
            raise ValueError(
                f"staged batch has {stacked.obs.shape[0]} steps, expected {num_steps}"
            )
        prios = []
        for k in range(num_steps):
            state, metrics, p = step(state, stacked.at(k))
            prios.append(p)
        return state, metrics, torch.stack(prios)

    return multi


def make_store_gather(cfg: R2D2Config):
    """(stores, b, s, is_weights) -> DeviceBatch: the clamped-window gather
    straight out of the device stores (replay/device_store.py), by advanced
    indexing with int64 indices: rows clip(win + t, 0, slot-1), learning
    rows clip(s*L + l, 0, bl-1). The index fields widen to the DeviceBatch
    dtypes; the bytes are the host plane's gather of the same contents."""
    L, T = cfg.learning_steps, cfg.seq_len
    slot, bl = cfg.block_slot_len, cfg.block_length

    def gather_batch(stores, b, s, is_weights) -> DeviceBatch:
        dev = stores["obs"].device
        b = b.to(dev, torch.int64)
        s = s.to(dev, torch.int64)
        burn = stores["burn_in"][b, s]
        first_burn = stores["burn_in"][b, 0]
        win = (first_burn + s * L - burn).long()
        rows = torch.clamp(win[:, None] + torch.arange(T, device=dev)[None, :], 0, slot - 1)
        bcol = b[:, None]
        lrow = torch.clamp(s[:, None] * L + torch.arange(L, device=dev)[None, :], 0, bl - 1)
        return DeviceBatch(
            obs=stores["obs"][bcol, rows],
            last_action=stores["last_action"][bcol, rows].long(),
            last_reward=stores["last_reward"][bcol, rows],
            hidden=stores["hidden"][b, s],
            action=stores["action"][bcol, lrow].long(),
            n_step_reward=stores["n_step_reward"][bcol, lrow],
            gamma=stores["gamma"][bcol, lrow],
            burn_in_steps=burn,
            learning_steps=stores["learning"][b, s],
            forward_steps=stores["forward"][b, s],
            is_weights=is_weights.to(dev, torch.float32),
            # the task store exists only on multi-task configs
            task=stores["task"][b, s] if "task" in stores else None,
        )

    return gather_batch


def make_fused_train_step(cfg: R2D2Config, mesh=None):
    """(state, stores, b, s, is_weights) -> (state, metrics, priorities):
    the update over the device store, its windows gathered inside the step,
    so only the (B,) coordinates cross to the card. The same numbers as
    make_train_step on the same batch assembled on the host."""
    step = make_train_step(cfg, mesh)
    gather = make_store_gather(cfg)

    def fused(state: TrainState, stores, b, s, is_weights):
        return step(state, gather(stores, b, s, is_weights))

    return fused


def make_multi_update_core(cfg: R2D2Config, num_steps: int, mesh=None):
    """K updates over (K, B) coordinate stacks, each gathering its batch
    from the store: (state, stores, b, s, w) -> (state, the last step's
    metrics, priorities (K, B)). The same as the K single fused steps on the
    same coordinates; nothing in it reads back to the host."""
    step = make_fused_train_step(cfg, mesh)

    def multi(state: TrainState, stores, b, s, w):
        if b.shape[0] != num_steps:
            raise ValueError(f"coordinate stack has {b.shape[0]} steps, expected {num_steps}")
        prios = []
        for k in range(num_steps):
            state, metrics, p = step(state, stores, b[k], s[k], w[k])
            prios.append(p)
        return state, metrics, torch.stack(prios)

    return multi


def make_fused_multi_train_step(cfg: R2D2Config, num_steps: int, mesh=None):
    """K train steps in one dispatch over the device store (the device
    plane's K > 1 consumer); see make_multi_update_core."""
    return make_multi_update_core(cfg, num_steps, mesh)


def make_gather_step(cfg: R2D2Config):
    """(stores, b, s, is_weights) -> DeviceBatch materialized at sample time
    (threaded mode): a queued item then holds a copy, which a later block
    write cannot change."""
    return make_store_gather(cfg)


def make_batch_train_step(cfg: R2D2Config, mesh=None):
    """(state, DeviceBatch) -> (state, metrics, priorities) over a batch
    gathered at sample time (make_gather_step)."""
    return make_train_step(cfg, mesh)


# --------------------------------------------------------------------------
# data parallelism (r2d2_tpu/learner.py's sharded steps)
# --------------------------------------------------------------------------


def tree_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over halves, recursively: ((x0 + x1) + (x2 + x3)) for four. A
    process owning an aligned half of the shards sums its half in the same
    order, so the sum over two processes (one addition, which commutes
    exactly) has the bits of the sum in one process."""
    if len(xs) == 1:
        return xs[0]
    h = (len(xs) + 1) // 2
    return tree_sum(xs[:h]) + tree_sum(xs[h:])


def make_sharded_train_step(cfg: R2D2Config, is_from_priorities: bool = False,
                            collectives=None, replicate: bool = False, mesh=None,
                            data_axes: Sequence[str] = ("dp",)):
    """(state, batches) -> (state, metrics, priorities (n, B/n)): one update
    over the n batch shards this process owns, `batches` holding each
    shard's DeviceBatch on its shard's device (r2d2_tpu/learner.py
    ``_raw_train_step(axis_name="dp")`` under shard_map, and
    ``make_manual_train_step``):

    - the loss denominator (valid learning steps) is summed over every
      shard of every process before any loss is formed, so each shard's
      loss is its part of the global loss;
    - each shard's gradient, loss and aux are taken apart, summed over this
      process's shards (tree_sum) and then across processes (`collectives`,
      parallel/multihost.Collectives; none in one process): a sum, not
      torch DDP's mean, since the per-shard mask sums differ;
    - one global-norm clip and one Adam step on the summed gradient, and
      the target sync, as make_train_step.

    ``is_from_priorities``: the batches' is_weights carry raw tree
    priorities, normalised here against the minimum positive priority over
    every shard (a MIN across processes), in float32 as JAX's pmin form.

    ``mesh`` with tp > 1: each batch shard runs through its tp group
    (models/tp.TPView: column- and row-parallel slices on the members'
    devices, the LSTM on the gathered gate columns), the shards being the
    mesh's (d, f) coordinates over ``data_axes`` in order: ("dp",) for the
    gspmd form, ("dp", "fsdp") for the manual (ZeRO-2) form. Replicated
    leaves are computed once per shard, so their gradient needs no sum over
    tp. With fsdp > 1 the state's optimizer is a ShardedAdam, which hands
    each fsdp member its slice of the summed gradient.

    A shard off the state's device runs on a replica of the networks on its
    device, made at its first update and given the stepped parameters after
    each; shards on the state's device run on the state's networks in turn.
    ``step.replicas`` holds them. ``replicate=True`` gives every shard but
    the first a replica even on one device: a test seam, so that one CPU or
    one card runs the path the shards of several cards take."""
    loss_fn = make_loss_fn(cfg)
    replicas: dict = {}
    synced: dict = {}  # the state.step each replica last took
    groups = None
    if mesh is not None and mesh.tp > 1:
        from r2d2_tpu_torch.parallel.mesh import data_shard_devices

        groups = [mesh.tp_devices(d, f) for d, f in data_shard_devices(mesh, data_axes)]
    split: dict = {}

    def nets_of(state: TrainState, i: int, device):
        key = i if replicate else device
        primary = 0 if replicate else next(state.net.parameters()).device
        if key == primary:
            return state.net, state.target_net
        if key not in replicas:
            replicas[key] = (copy.deepcopy(state.net).to(device),
                             copy.deepcopy(state.target_net).to(device).requires_grad_(False))
            synced[key] = state.step
        elif synced[key] != state.step:
            # another step function moved the state since this replica's sync
            _copy_params(replicas[key], state)
            synced[key] = state.step
        return replicas[key]

    def reduce(t: torch.Tensor, what: str, op: str = "sum") -> torch.Tensor:
        if collectives is None:
            return t
        return (collectives.sum_ if op == "sum" else collectives.min_)(t, what)

    def step(state: TrainState, batches: Sequence[DeviceBatch]):
        params = list(state.net.parameters())
        home = params[0].device
        if cfg.zero_state_replay:
            batches = [b._replace(hidden=torch.zeros_like(b.hidden)) for b in batches]
        # the valid learning steps summed on the device (an exact int64 sum)
        steps = tree_sum([b.learning_steps.sum().to(home) for b in batches])
        denom = torch.clamp(reduce(steps.reshape(1), "denominator")[0].float(), min=1.0)
        if is_from_priorities:
            pos = torch.stack([torch.where(b.is_weights > 0, b.is_weights.float(),
                                           torch.tensor(float("inf"), device=b.is_weights.device)
                                           ).min().to(home) for b in batches])
            min_p = reduce(pos.min().reshape(1), "min_priority", op="min")[0]
            min_p = torch.where(torch.isfinite(min_p), min_p, torch.ones_like(min_p))
            batches = [b._replace(is_weights=torch.pow(
                torch.maximum(b.is_weights.float(), min_p.to(b.is_weights.device))
                / min_p.to(b.is_weights.device), -cfg.is_exponent)) for b in batches]
        if groups is not None and not split:
            from r2d2_tpu_torch.parallel.sharding_map import tp_split_leaves

            split.update(tp_split_leaves(state.net, mesh))
        flats, stats, prios = [], [], []
        for i, b in enumerate(batches):
            dev = b.obs.device
            net, target = nets_of(state, i, dev)
            net.zero_grad(set_to_none=True)
            online = net
            if groups is not None:
                from r2d2_tpu_torch.models.tp import TPView

                online = TPView(net, groups[i], split, trainable=True)
                target = TPView(target, groups[i], split, trainable=False)
            loss, (priorities, aux) = loss_fn(online, target, b, denom.to(dev))
            loss.backward()
            grads = [online.grad(k) if k in split else p.grad
                     for k, p in net.named_parameters()]
            flats.append(torch.cat([g.reshape(-1) for g in grads]).to(home))
            stats.append(torch.stack([loss.detach(), aux["q_mean"], aux["target_mean"],
                                      aux["td_abs_mean"]]).to(home))
            prios.append(priorities.to(home))
        grad = reduce(tree_sum(flats), "gradient")
        summed = reduce(tree_sum(stats), "loss")
        state.net.zero_grad(set_to_none=True)
        offset = 0
        for p in params:
            p.grad = grad[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()
        g_norm = _apply_gradients(cfg, state, params)
        for key, pair in replicas.items():
            pair[0].zero_grad(set_to_none=True)
            _copy_params(pair, state)
            synced[key] = state.step
        metrics = {"loss": summed[0], "grad_norm": g_norm, "q_mean": summed[1],
                   "target_mean": summed[2], "td_abs_mean": summed[3]}
        return state, metrics, torch.stack(prios)

    step.replicas = replicas
    return step


@torch.no_grad()
def _copy_params(pair, state: TrainState) -> None:
    """A replica (net, target) takes the state's parameters."""
    for dst, src in zip(pair[0].parameters(), state.net.parameters()):
        dst.copy_(src)
    for dst, src in zip(pair[1].parameters(), state.target_net.parameters()):
        dst.copy_(src)


def make_sharded_gather_step(cfg: R2D2Config):
    """(stores, b, s, w) -> one DeviceBatch per shard: shard i's rows
    gathered from its own store `stores[i]` with its (B/dp,) coordinates
    b[i], s[i], w[i] (b local to the shard), on the shard's device."""
    gather = make_store_gather(cfg)

    def gather_shards(stores, b, s, w):
        return [gather(st, torch.as_tensor(b[i]), torch.as_tensor(s[i]), torch.as_tensor(w[i]))
                for i, st in enumerate(stores)]

    return gather_shards


def make_sharded_fused_train_step(cfg: R2D2Config, is_from_priorities: bool = False,
                                  collectives=None, replicate: bool = False, mesh=None):
    """(state, stores, b, s, w) -> (state, metrics, priorities (n, B/dp)):
    the update over dp-sharded device stores (replay/sharded_store.py), each
    shard gathering its rows from its own store, then
    make_sharded_train_step. b, s, w are (n, B/dp) per-shard coordinates,
    b local to each shard; with is_from_priorities, w holds raw priorities."""
    step = make_sharded_train_step(cfg, is_from_priorities, collectives, replicate, mesh)
    gather = make_sharded_gather_step(cfg)

    def fused(state: TrainState, stores, b, s, w):
        return step(state, gather(stores, b, s, w))

    fused.replicas = step.replicas
    return fused


def make_sharded_fused_multi_train_step(cfg: R2D2Config, num_steps: int,
                                        is_from_priorities: bool = False,
                                        collectives=None, mesh=None):
    """K sharded updates in one dispatch (the axis form of
    make_multi_update_core): (state, stores, b, s, w) with (K, n, B/dp)
    coordinates -> (state, the last step's metrics, priorities
    (K, n, B/dp)); the same as K make_sharded_fused_train_step calls."""
    step = make_sharded_fused_train_step(cfg, is_from_priorities, collectives, mesh=mesh)

    def multi(state: TrainState, stores, b, s, w):
        if len(b) != num_steps:
            raise ValueError(f"coordinate stack has {len(b)} steps, expected {num_steps}")
        prios = []
        for k in range(num_steps):
            state, metrics, p = step(state, stores, b[k], s[k], w[k])
            prios.append(p)
        return state, metrics, torch.stack(prios)

    multi.replicas = step.replicas
    return multi


# --------------------------------------------------------------------------
# fsdp: Adam on moment shards (r2d2_tpu/learner.py make_manual_train_step's
# ZeRO tail; parallel/sharding_map.moment_spec_for)
# --------------------------------------------------------------------------


class ShardedAdam:
    """Adam whose moments live in fsdp shards, standing in for
    ``state.optimizer``. Each parameter's mu and nu split along their fsdp
    dim (sharding_map.moment_spec_for; whole on member 0 where no dim
    divides), shard f on ``mesh.fsdp_devices()[f]``. step() hands member f
    its slice of the (summed, clipped) gradient, updates its moment shards
    and its slice of the parameter there, and writes the slice back into
    the whole parameter (JAX's reduce-scatter, Adam on the shard and
    all-gather of the update). The update is optax's scale_by_adam then
    -lr: mu_hat / (sqrt(nu_hat) + eps).

    state_dict() / load_state_dict() speak torch Adam's format with whole
    moments, so a checkpoint holds whole moments and resumes into any
    tp / fsdp layout."""

    def __init__(self, params, mesh, names: Sequence[str], lr: float, eps: float,
                 betas: Tuple[float, float] = (0.9, 0.999)):
        from r2d2_tpu_torch.parallel.sharding_map import moment_spec_for

        self.params = list(params)
        self.mesh = mesh
        self.names = list(names)
        self.b1, self.b2 = betas
        self.eps = eps
        # the torch Adam whose state_dict format this one reads and writes
        self._shell = torch.optim.Adam(self.params, lr=lr, eps=eps, betas=betas)
        self.devices = mesh.fsdp_devices()
        self.fdims = [moment_spec_for(n, tuple(p.shape), mesh).dim("fsdp")
                      for n, p in zip(self.names, self.params)]
        self.count = 0
        self.mu = [self._zeros(p, fd) for p, fd in zip(self.params, self.fdims)]
        self.nu = [self._zeros(p, fd) for p, fd in zip(self.params, self.fdims)]

    @property
    def param_groups(self):
        return self._shell.param_groups

    def _pieces(self, t: torch.Tensor, fd: Optional[int]) -> List[torch.Tensor]:
        """The fsdp members' slices of a parameter-shaped tensor (views)."""
        if fd is None:
            return [t]
        n = t.shape[fd] // len(self.devices)
        return [t.narrow(fd, f * n, n) for f in range(len(self.devices))]

    def _zeros(self, p: torch.Tensor, fd: Optional[int]) -> List[torch.Tensor]:
        return [torch.zeros_like(piece, device=dev)
                for piece, dev in zip(self._pieces(p.detach(), fd), self.devices)]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._shell.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        lr = self.param_groups[0]["lr"]
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, fd, mus, nus in zip(self.params, self.fdims, self.mu, self.nu):
            for g, w, mu, nu in zip(self._pieces(p.grad, fd), self._pieces(p, fd), mus, nus):
                g = g.to(mu.device)
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
                u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
                w.add_((u * -lr).to(w.device))

    def moment_shards(self) -> Dict[str, List[Tuple[int, ...]]]:
        """Each parameter's mu shard shapes, by name."""
        return {n: [tuple(m.shape) for m in mus] for n, mus in zip(self.names, self.mu)}

    def _whole(self, shards: List[torch.Tensor], fd: Optional[int], like: torch.Tensor):
        if fd is None:
            return shards[0].to(like.device).clone()
        return torch.cat([s.to(like.device) for s in shards], dim=fd)

    def state_dict(self) -> dict:
        if self.count:
            step = float(self.count)
            for p, fd, mus, nus in zip(self.params, self.fdims, self.mu, self.nu):
                self._shell.state[p] = {
                    "step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": self._whole(mus, fd, p),
                    "exp_avg_sq": self._whole(nus, fd, p),
                }
        return self._shell.state_dict()

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self._shell.load_state_dict(sd)
        self.count = 0
        for p, fd, mus, nus in zip(self.params, self.fdims, self.mu, self.nu):
            st = self._shell.state.get(p)
            if not st:
                continue
            self.count = int(st["step"])  # r2d2: disable=host-sync-in-hot-path  (a loaded host tensor)
            for dst, src in zip(mus, self._pieces(st["exp_avg"], fd)):
                dst.copy_(src)
            for dst, src in zip(nus, self._pieces(st["exp_avg_sq"], fd)):
                dst.copy_(src)
        self._shell.state.clear()


def shard_optimizer(cfg: R2D2Config, state: TrainState, mesh) -> None:
    """Put `state` on the mesh's fsdp layout: a ShardedAdam over the
    network's parameters when fsdp > 1 (its moments taken over from the
    state's optimizer), the torch Adam otherwise."""
    names = [n for n, _ in state.net.named_parameters()]
    params = list(state.net.parameters())
    sd = state.optimizer.state_dict()
    if mesh is not None and mesh.fsdp > 1:
        opt = ShardedAdam(params, mesh, names, cfg.lr, cfg.adam_eps)
    else:
        opt = make_optimizer(cfg, params)
    opt.load_state_dict(sd)
    state.optimizer = opt
