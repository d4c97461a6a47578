"""Graph checks over the port's canonical entry points (port of
r2d2_tpu/analysis/jaxpr_rules.py).

The AST rules catch what the *source* says; these catch what a step
actually *executes*. torch has no jaxpr, so each entry point (the stacked
train step, the act steps, the sequence unroll, the backward arms, the
manual tp x fsdp step, the priority superstep, the serve steps and the
live-loop gather) is run for real at small shapes, once to warm it (Adam's
moments, cached tensors) and once under an op recorder, and the recorded
program is held to the contracts the precision policy promises:

- no float64 or complex128 tensor is produced, at either precision;
- the fp32 golden path is bf16-free (bit-exactness contract);
- the bf16 path keeps its fp32 islands (loss/target/priority math) AND
  actually computes in bf16 (otherwise the precision knob is dead);
- no host sync inside a step: no read of a data-derived value to the host
  (``aten::_local_scalar_dense``), no copy of device data to the host, no
  op whose output shape depends on the data (``nonzero``, ``masked_select``
  and the like);
- the LSTM kernels are dispatched exactly 2 forwards + 1 backward of the
  arm's form per update, one per unroll, none when acting;
- the int8 serve arm carries int8 weights into the step and dequantizes
  them there;
- what JAX donates keeps its storage: every parameter and Adam moment of
  the TrainState, the superstep's tree and the serve cache's stores are
  updated in place (same storage, shape and dtype), so no second copy of
  the model stays resident;
- host-padded block fields agree exactly with ``store_field_specs``, and
  the serve step runs one shape per bucket and weight arm.

How a step is observed:

- ``OpRecorder``, a ``TorchDispatchMode``, records every aten op of the
  call (forward, ``loss.backward()`` and ``optimizer.step()``): its name,
  its outputs' dtypes, shapes and devices, its inputs' devices, and whether
  an input derives from the step's parameters, batch or stores (the
  *taint*, carried op to op). A host read is judged by that taint, not by
  the tensor's device: on the CPU every tensor is a host tensor, and
  torch's Adam reads its own step counter (``state["step"]``, a host
  tensor) with ``.item()``, which is not a sync of the step's data.
- The kernels' ctypes launches are invisible to the recorder, so the
  wrappers count them: ``ops/lstm_kernel.dispatch_counts`` (every call of a
  kernel form, on any device) beside ``launch_counts`` (the launches). On
  the card the gate also requires dispatches == launches, form by form: no
  plain version ran there.
- On the card every recorded call also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, which is the final word on
  syncs: a synchronizing CUDA call is a ``graph-host-sync`` finding.

Never printed text: the reference's gate counts ``pallas_call`` in printed
jaxpr text, where a shared sub-jaxpr prints once (2 in the text for 3
equations in the fp32 kernel train step). Counts here come from the
wrappers.

Differences from the JAX gate:

- ``graph-host-sync`` (JAX's ``jaxpr-host-callback``) applies to every entry
  point, the train step and the superstep included: in torch a host sync is
  the failure a callback stands for, and with the training wall held by
  launches it is the one that costs;
- the port's train step runs through the kernel wrappers on every device
  (their plain versions on the CPU), so ``fused_train_step`` is the train
  step's own trace;
- donation is checked in place (storage pointers) instead of as an
  output-(shape, dtype) multiset;
- devices may repeat, so the resharded (dp=2), manual (dp2 x tp2 x fsdp2)
  and multi-serve entries always run, where JAX's are no-ops on fewer
  devices.

Traces are cached per (entry, precision, device), so the tier-1 gate and
the per-rule tests share one run per entry point. Findings use path
"<graph:LABEL>" with line 0; graph findings take no suppression comments.

torch and the port's model stack import lazily inside the helpers, so
``python -m r2d2_tpu_torch.analysis`` without ``--graph`` stays
stdlib-only.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import sys
import weakref
from typing import Dict, List, NamedTuple, Sequence, Tuple

from r2d2_tpu_torch.analysis.findings import Finding


def _finding(rule: str, label: str, message: str, hint: str = "",
             severity: str = "error") -> Finding:
    return Finding(
        rule=rule, severity=severity, path=f"<graph:{label}>",
        line=0, col=0, message=message, hint=hint,
    )


# ------------------------------------------------------------ observation


class OpRecord(NamedTuple):
    """One aten op a recorded call executed."""

    name: str                       # schema name, e.g. "aten::mm"
    out_dtypes: Tuple[str, ...]     # "float32", "bfloat16", ...
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_devices: Tuple[str, ...]    # device types
    in_devices: Tuple[str, ...]
    tainted: bool = False           # an input derives from the step's data
    consumes: Tuple[str, ...] = ()  # watched inputs (the int8 weights) it reads
    where: str = ""                 # the port's source line of a host read


@dataclasses.dataclass
class Trace:
    """A recorded call of an entry point: its ops, the kernel forms it
    dispatched and launched, a synchronizing CUDA call if one raised, and
    what the scan reads beside them (output dtypes, the storage of what
    must be kept, the watched int8 weights)."""

    ops: List[OpRecord] = dataclasses.field(default_factory=list)
    dispatches: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    device: str = "cpu"
    sync_error: str = ""
    updates: int = 0
    outputs: Dict[str, str] = dataclasses.field(default_factory=dict)
    kept: Tuple[dict, dict] = ({}, {})
    int8: Tuple[str, ...] = ()
    expected: Dict[str, int] = dataclasses.field(default_factory=dict)


def _dtype(dt) -> str:
    """A torch or numpy dtype's name ("float32", "bfloat16", ...)."""
    s = str(dt)
    if s.startswith("torch."):
        return s[len("torch."):]
    import numpy as np

    return str(np.dtype(dt))


# the ops that read a value back to the host or size their output by the
# data (both wait for the device)
_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::nonzero_numpy",
    "aten::argwhere", "aten::masked_select", "aten::_unique", "aten::_unique2",
    "aten::unique_dim", "aten::unique_consecutive", "aten::unique_dim_consecutive",
})


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_frame() -> str:
    """'path:line' of the innermost caller in the port outside this
    module, or ''."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.endswith("graph_rules.py"):
            return f"{os.path.relpath(path, os.path.dirname(_PKG))}:{f.f_lineno}"
        f = f.f_back
    return ""


@functools.lru_cache(maxsize=None)
def _recorder_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpRecorder(TorchDispatchMode):
        """Records each aten op of the calls under it (OpRecord), carrying
        the taint of `sources` (the step's parameters, batch and stores)
        from inputs to outputs. `watch` names tensors whose consumers are
        noted. Tensors are followed by identity with weak references, so
        nothing recorded is kept alive."""

        def __init__(self, sources, watch):
            super().__init__()
            self.ops: List[OpRecord] = []
            self._taint: Dict[int, weakref.ref] = {}
            self._watch = list(watch.items())
            for t in sources:
                self._mark(t)

        def _mark(self, t) -> None:
            i = id(t)
            if i not in self._taint:
                self._taint[i] = weakref.ref(t, lambda _r, i=i, d=self._taint: d.pop(i, None))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func._schema.name
            if name.startswith("profiler::"):
                return out
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            tainted = any(id(t) in self._taint for t in ins)
            if tainted:
                for t in outs:
                    self._mark(t)
            where = _port_frame() if tainted and name in _SYNC_OPS else ""
            self.ops.append(OpRecord(
                name,
                tuple(_dtype(t.dtype) for t in outs),
                tuple(tuple(t.shape) for t in outs),
                tuple(t.device.type for t in outs),
                tuple(t.device.type for t in ins),
                tainted,
                tuple(name for t in ins for name, w in self._watch if t is w),
                where,
            ))
            return out

    return OpRecorder


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def observe(fn, sources, device, watch=None) -> Tuple[Trace, object]:
    """Run fn() once under the op recorder (and, on the card, under
    set_sync_debug_mode("error")): -> (Trace, fn's result, None when a
    synchronizing CUDA call raised). The kernel counts are read as
    differences, so other counters' users are not disturbed."""
    import torch

    from r2d2_tpu_torch.ops import lstm_kernel as K

    cuda = torch.device(device).type == "cuda"
    rec = _recorder_class()(_tensors(sources), watch or {})
    d0, l0 = dict(K.dispatch_counts), dict(K.launch_counts)
    out, sync_error = None, ""
    if cuda:
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with rec:
            out = fn()
    except RuntimeError as e:
        if not cuda or "synchroniz" not in str(e):
            raise
        sync_error = str(e).splitlines()[0]
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
    if cuda:
        torch.cuda.synchronize()

    def delta(now, before):
        return {k: now[k] - before[k] for k in now if now[k] != before[k]}

    trace = Trace(ops=rec.ops, dispatches=delta(K.dispatch_counts, d0),
                  launches=delta(K.launch_counts, l0), device=torch.device(device).type,
                  sync_error=sync_error)
    return trace, out


def storage_specs(named) -> Dict[str, Tuple[int, Tuple[int, ...], str]]:
    """name -> (storage pointer, shape, dtype) of each tensor."""
    return {k: (t.untyped_storage().data_ptr(), tuple(t.shape), _dtype(t.dtype))
            for k, t in named.items()}


def state_tensors(state) -> dict:
    """Every parameter (online and target) and Adam moment of a
    TrainState, by name: torch Adam's exp_avg / exp_avg_sq, or a
    ShardedAdam's moment shards."""
    out = {f"net.{n}": p for n, p in state.net.named_parameters()}
    out.update({f"target.{n}": p for n, p in state.target_net.named_parameters()})
    opt = state.optimizer
    if hasattr(opt, "mu"):  # learner.ShardedAdam
        for n, mus, nus in zip(opt.names, opt.mu, opt.nu):
            for f, (m, v) in enumerate(zip(mus, nus)):
                out[f"mu.{n}.{f}"], out[f"nu.{n}.{f}"] = m, v
        return out
    for n, p in state.net.named_parameters():
        st = opt.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in st:
                out[f"{key}.{n}"] = st[key]
    return out


# ------------------------------------------------------------- configs


@functools.lru_cache(maxsize=None)
def _cfg(precision: str):
    from r2d2_tpu_torch.config import tiny_test

    return tiny_test().replace(precision=precision)


_NUM_STEPS = 2  # K of the stacked train step: >1 so the loop over K is real


def _multitask_cfg(precision: str):
    """2 tasks over a union action space: the task leaf exists in the batch
    and the head carries the one-hot task and per-task masking."""
    return _cfg(precision).replace(
        num_tasks=2,
        action_dim=5,
        multitask_envs=("drift", "banditgrid"),
        task_action_dims=(3, 5),
        task_gammas=(0.997, 0.99),
    )


# ckpt segment length for the tiny_test trace: seq_len = 4+4+2 = 10, so 5
# walks two real segments
_CKPT_S = 5


def _backward_arm_cfg(precision: str, arm: str):
    """tiny config with one alternative backward arm armed: 'fused_dwh'
    forms dWh in the kernel, 'ckpt' checkpoints every _CKPT_S-th carry."""
    cfg = _cfg(precision).replace(lstm_backend="pallas")
    if arm == "fused_dwh":
        return cfg.replace(seq_fused_dwh=True)
    if arm == "ckpt":
        return cfg.replace(seq_grad_checkpoint=_CKPT_S)
    raise ValueError(f"unknown backward arm {arm!r}")


_SUPERSTEP_N = 2  # dispatches: >1 so the loop over dispatches is real


@functools.lru_cache(maxsize=None)
def _superstep_cfg(precision: str):
    """tiny_test on the device priority plane."""
    return _cfg(precision).replace(
        replay_plane="device",
        priority_plane="device",
        superstep_dispatches=_SUPERSTEP_N,
        updates_per_dispatch=_NUM_STEPS,
        training_steps=_SUPERSTEP_N * _NUM_STEPS,
    )


@functools.lru_cache(maxsize=None)
def _manual_cfg(precision: str, dp: int, tp: int, fsdp: int):
    """tiny_test on the dp x tp x fsdp cell (partitioning resolves to
    manual: ZeRO-2 batch shards over dp x fsdp, each through its tp
    group)."""
    return _cfg(precision).replace(dp_size=dp, tp_size=tp, fsdp_size=fsdp)


# Budget-discriminable shapes for backward_arm="auto": at tiny_test
# geometry (T=10, B=8, H=32) every arm fits inside the 1 MB budget floor
# and auto always resolves to "default".
_AUTO_ARM_H = 512
_AUTO_ARM_B = 32
_AUTO_ARM_BUDGET_MB = {
    # Integer-MB budgets that land choose_backward_arm on each arm at
    # (T=10, B=32, H=512): bf16 thresholds are default 3.44 MB / fused
    # 2.19 MB; fp32 default and fused coincide at 3.75 MB (fused buys
    # nothing at fp32, auto skips it by design, so the fp32 fused cell pins
    # the arm via backward_arm="fused_dwh").
    ("fp32", "ckpt"): 3,
    ("bf16", "fused_dwh"): 3,
    ("bf16", "ckpt"): 2,
}


def _auto_arm_cfg(precision: str, arm: str):
    """tiny config whose `backward_arm` knob RESOLVES to the given arm."""
    cfg = _cfg(precision).replace(
        lstm_backend="pallas", hidden_dim=_AUTO_ARM_H, batch_size=_AUTO_ARM_B
    )
    mb = _AUTO_ARM_BUDGET_MB.get((precision, arm))
    if mb is None:
        return cfg.replace(backward_arm=arm)
    return cfg.replace(backward_arm="auto", backward_residual_budget_mb=mb)


def update_forms(cfg, device) -> Dict[str, int]:
    """The kernel forms one update dispatches: 2 forwards (online and target
    unroll) + 1 backward of the resolved arm's form, in the compute dtype."""
    import torch

    from r2d2_tpu_torch.ops.lstm_kernel import _form

    arm, _ = cfg.resolve_backward_arm(device=torch.device(device).type)
    bwd = {"default": "lstm_seq_bwd", "fused_dwh": "lstm_seq_bwd_fused",
           "ckpt": "lstm_seq_bwd_ckpt"}[arm] if cfg.fused_sequence else "lstm_bwd"
    dt = cfg.torch_compute_dtype
    return {_form("lstm_fwd", dt): 2, _form(bwd, dt): 1}


def _scaled(forms: Dict[str, int], n: int) -> Dict[str, int]:
    return {k: v * n for k, v in forms.items()}


# ------------------------------------------------------------- inputs


def _batch(cfg, lead: Tuple[int, ...], device, seed: int = 0):
    """A DeviceBatch with leading dims `lead` ((K, B) stacked, or (B,)),
    its values drawn from a seeded numpy generator."""
    import numpy as np
    import torch

    from r2d2_tpu_torch.learner import DeviceBatch

    rng = np.random.default_rng(seed)
    T, L, H = cfg.seq_len, cfg.learning_steps, cfg.hidden_dim
    acts = min(cfg.task_action_dims) if cfg.task_action_dims else cfg.action_dim

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    hidden = torch.from_numpy(rng.normal(0.0, 0.1, (*lead, 2, H)).astype(np.float32))
    task = (t(rng.integers(0, cfg.num_tasks, lead).astype(np.int32))
            if cfg.num_tasks > 1 else None)
    return DeviceBatch(
        obs=t(rng.integers(0, 256, (*lead, T, *cfg.obs_shape), dtype=np.uint8)),
        last_action=t(rng.integers(0, acts, (*lead, T))),
        last_reward=t(rng.normal(size=(*lead, T)).astype(np.float32)),
        hidden=hidden.to(cfg.state_dtype).to(device),
        action=t(rng.integers(0, acts, (*lead, L))),
        n_step_reward=t(rng.normal(size=(*lead, L)).astype(np.float32)),
        gamma=t(np.full((*lead, L), 0.99, np.float32)),
        burn_in_steps=t(np.full(lead, cfg.burn_in_steps, np.int32)),
        learning_steps=t(np.full(lead, L, np.int32)),
        forward_steps=t(np.full(lead, cfg.forward_steps, np.int32)),
        is_weights=t(rng.uniform(0.3, 1.0, lead).astype(np.float32)),
        task=task,
    )


def _stores(cfg, num_blocks: int, device, seed: int = 0) -> dict:
    """Device-store tensors (store_field_specs) of `num_blocks` blocks,
    filled from a seeded numpy generator with full sequences."""
    import numpy as np
    import torch

    from r2d2_tpu_torch.replay.block import store_field_specs

    rng = np.random.default_rng(seed)
    fill = {"burn_in": cfg.burn_in_steps, "learning": cfg.learning_steps,
            "forward": cfg.forward_steps, "gamma": 0.99}
    out = {}
    for k, (shape, dt) in store_field_specs(cfg).items():
        full = (num_blocks, *shape)
        if k == "obs":
            a = rng.integers(0, 256, full, dtype=np.uint8)
        elif k in ("last_action", "action"):
            a = rng.integers(0, cfg.action_dim, full).astype(np.int32)
        elif k == "task":
            a = rng.integers(0, cfg.num_tasks, full).astype(np.int32)
        elif k in fill:
            a = np.full(full, fill[k])
        else:
            a = rng.normal(0.0, 0.1, full).astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)
    return out


def _coords(cfg, lead: Tuple[int, ...], num_blocks: int, device, seed: int = 0):
    """(b, s, w) sample coordinates with leading dims `lead`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = rng.integers(0, num_blocks, lead)
    s = rng.integers(0, cfg.seqs_per_block, lead)
    w = rng.uniform(0.3, 1.0, lead).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (b, s, w))


# --------------------------------------------------------- entry points


def _train_trace(cfg, device, num_steps: int = _NUM_STEPS, wrap=None) -> Trace:
    """The stacked train step (learner.make_stacked_batch_train_step) on
    `cfg`: one warm call, then one recorded call on the same batch.
    `wrap` (step -> step) is the seam the seeded-fault tests use."""
    from r2d2_tpu_torch.learner import init_train_state, make_stacked_batch_train_step

    _, state = init_train_state(cfg, device, seed=0)
    step = make_stacked_batch_train_step(cfg, num_steps)
    if wrap is not None:
        step = wrap(step)
    batch = _batch(cfg, (num_steps, cfg.batch_size), device)
    step(state, batch)
    before = storage_specs(state_tensors(state))
    sources = [list(state_tensors(state).values()), batch.tensors()]
    trace, out = observe(lambda: step(state, batch), sources, device)
    trace.kept = (before, storage_specs(state_tensors(state)))
    trace.updates = num_steps
    trace.expected = _scaled(update_forms(cfg, device), num_steps)
    if out is not None:
        _, metrics, prios = out
        trace.outputs = {"priorities": _dtype(prios.dtype),
                         **{f"metric {k!r}": _dtype(v.dtype) for k, v in metrics.items()}}
    return trace


@functools.lru_cache(maxsize=None)
def train_step_trace(precision: str, device: str = "cpu") -> Trace:
    """The stacked-batch train step (the canonical learner entry point:
    every other step builder shares make_train_step's body)."""
    return _train_trace(_cfg(precision), device)


@functools.lru_cache(maxsize=None)
def multitask_train_step_trace(precision: str, device: str = "cpu") -> Trace:
    """The task-conditioned stacked train step (num_tasks > 1): the (K, B)
    task leaf drives the one-hot head widening and the per-task mask."""
    return _train_trace(_multitask_cfg(precision), device)


@functools.lru_cache(maxsize=None)
def backward_arm_train_step_trace(precision: str, arm: str, device: str = "cpu") -> Trace:
    return _train_trace(_backward_arm_cfg(precision, arm), device)


@functools.lru_cache(maxsize=None)
def auto_backward_arm_train_step_trace(precision: str, arm: str,
                                       device: str = "cpu") -> Trace:
    return _train_trace(_auto_arm_cfg(precision, arm), device)


@functools.lru_cache(maxsize=None)
def resharded_train_step_trace(precision: str, dp: int = 2, device: str = "cpu") -> Trace:
    """The sharded fused train step (learner.make_sharded_fused_train_step)
    on a reshard-target layout of dp stores, each shard gathering from its
    own store; the shards' devices repeat `device`."""
    from r2d2_tpu_torch.learner import init_train_state, make_sharded_fused_train_step
    from r2d2_tpu_torch.replay.control_plane import shard_config

    cfg = _cfg(precision).replace(replay_plane="sharded", dp_size=dp)
    nb = shard_config(cfg, dp).num_blocks
    _, state = init_train_state(cfg, device, seed=0)
    step = make_sharded_fused_train_step(cfg)
    stores = [_stores(cfg, nb, device, seed=i) for i in range(dp)]
    coords = _coords(cfg, (dp, cfg.batch_size // dp), nb, device)
    step(state, stores, *coords)
    before = storage_specs(state_tensors(state))
    sources = [list(state_tensors(state).values()), stores, coords]
    trace, _ = observe(lambda: step(state, stores, *coords), sources, device)
    trace.kept = (before, storage_specs(state_tensors(state)))
    trace.updates = 1
    trace.expected = _scaled(update_forms(cfg, device), dp)
    return trace


@functools.lru_cache(maxsize=None)
def manual_train_step_trace(precision: str, dp: int = 2, tp: int = 2, fsdp: int = 2,
                            device: str = "cpu") -> Trace:
    """The manual (ZeRO-2) train step on the dp x tp x fsdp mesh, its
    positions all `device`: each of the dp x fsdp batch shards through its
    tp group, Adam on fsdp moment shards (learner.ShardedAdam)."""
    from r2d2_tpu_torch.learner import init_train_state, make_train_step, shard_optimizer
    from r2d2_tpu_torch.parallel.mesh import make_mesh

    cfg = _manual_cfg(precision, dp, tp, fsdp)
    mesh = make_mesh(dp, [device] * (dp * tp * fsdp), tp=tp, fsdp=fsdp)
    _, state = init_train_state(cfg, device, seed=0)
    shard_optimizer(cfg, state, mesh)
    step = make_train_step(cfg, mesh)
    batch = _batch(cfg, (cfg.batch_size,), device)
    step(state, batch)
    before = storage_specs(state_tensors(state))
    sources = [list(state_tensors(state).values()), batch.tensors()]
    trace, _ = observe(lambda: step(state, batch), sources, device)
    trace.kept = (before, storage_specs(state_tensors(state)))
    trace.updates = 1
    trace.expected = _scaled(update_forms(cfg, device), dp * fsdp)
    return trace


def _acting_inputs(cfg, device, num_envs: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    E, H = num_envs, cfg.hidden_dim

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(rng.integers(0, 256, (E, *cfg.obs_shape), dtype=np.uint8)),
            t(rng.integers(0, cfg.action_dim, E).astype(np.int32)),
            t(rng.normal(size=E).astype(np.float32)),
            (t(rng.normal(0.0, 0.1, (E, H)).astype(np.float32)),
             t(rng.normal(0.0, 0.1, (E, H)).astype(np.float32))))


@functools.lru_cache(maxsize=None)
def _net(precision: str, device: str):
    from r2d2_tpu_torch.learner import init_train_state

    net, _ = init_train_state(_cfg(precision), device, seed=0)
    return net


def _net_trace(precision: str, device: str, call, inputs) -> Tuple[Trace, object]:
    import torch

    net = _net(precision, device)
    with torch.no_grad():
        call(net, *inputs)
        trace, out = observe(lambda: call(net, *inputs),
                             [list(net.parameters()), inputs], device)
    return trace, out


@functools.lru_cache(maxsize=None)
def act_trace(precision: str, device: str = "cpu", num_envs: int = 4) -> Trace:
    """The batched act step (VectorizedActor's policy call: one net.act
    over the env fleet)."""
    inputs = _acting_inputs(_cfg(precision), device, num_envs)
    trace, _ = _net_trace(precision, device, lambda n, *a: n.act(*a), inputs)
    return trace


@functools.lru_cache(maxsize=None)
def act_select_trace(precision: str, device: str = "cpu", num_envs: int = 4) -> Trace:
    """The fused act tail (net.act_select: core step + dueling combine +
    ε-greedy select, the body the actor, the collector and the serve step
    share)."""
    import torch

    obs, la, lr, carry = _acting_inputs(_cfg(precision), device, num_envs)
    explore = torch.tensor([True, False] * (num_envs // 2), device=device)
    rand_a = torch.arange(num_envs, dtype=torch.int32, device=device) % 2
    trace, out = _net_trace(precision, device, lambda n, *a: n.act_select(*a),
                            (obs, la, lr, carry, explore, rand_a))
    if out is not None:
        trace.outputs = {"actions": _dtype(out[1].dtype)}
    return trace


@functools.lru_cache(maxsize=None)
def fused_unroll_trace(precision: str, device: str = "cpu") -> Trace:
    """The forward sequence unroll (R2D2Network.unroll through
    ops/lstm_kernel.lstm_seq_unroll): the fused-sequence kernel's entry."""
    cfg = _cfg(precision)
    b = _batch(cfg, (cfg.batch_size,), device)
    inputs = (b.obs, b.last_action, b.last_reward, b.hidden, b.burn_in_steps,
              b.learning_steps, b.forward_steps)
    trace, _ = _net_trace(precision, device, lambda n, *a: n(*a), inputs)
    return trace


@functools.lru_cache(maxsize=None)
def priority_superstep_trace(precision: str, device: str = "cpu") -> Trace:
    """The N x K priority superstep (megastep.make_priority_superstep): the
    sum-tree descent, IS weights, K store-gathered updates and the priority
    write-back chained over N dispatches."""
    import numpy as np
    import torch

    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.megastep import make_priority_superstep
    from r2d2_tpu_torch.replay import device_sum_tree as dst

    cfg = _superstep_cfg(precision)
    _, state = init_train_state(cfg, device, seed=0)
    ss = make_priority_superstep(cfg, _SUPERSTEP_N, _NUM_STEPS)
    rng = np.random.default_rng(0)
    stores = _stores(cfg, cfg.num_blocks, device)
    tree = dst.tree_from_leaves(rng.uniform(0.1, 1.0, cfg.num_sequences), cfg.num_sequences,
                                device)
    nss = torch.full((cfg.num_blocks,), cfg.seqs_per_block, dtype=torch.int32, device=device)
    u = torch.from_numpy(rng.random((_SUPERSTEP_N, _NUM_STEPS, cfg.batch_size),
                                    dtype=np.float32)).to(device)
    ss(state, stores, tree, nss, u)

    def kept():
        return storage_specs({**state_tensors(state), "tree": tree})

    before = kept()
    sources = [list(state_tensors(state).values()), stores, tree, nss, u]
    trace, out = observe(lambda: ss(state, stores, tree, nss, u), sources, device)
    after = kept()
    if out is not None:
        after["tree"] = storage_specs({"tree": out[1]})["tree"]
    trace.kept = (before, after)
    trace.updates = _SUPERSTEP_N * _NUM_STEPS
    trace.expected = _scaled(update_forms(cfg, device), trace.updates)
    return trace


@functools.lru_cache(maxsize=None)
def _serve_server(precision: str, quantization: str = "none", device: str = "cpu",
                  degrade: bool = False):
    """The smallest serve plane: one bucket, cache == bucket; never started.
    With `degrade` the ladder's three weight arms are warmed too."""
    from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig

    cfg = _cfg(precision).replace(serve_quantization=quantization, serve_degrade=degrade)
    srv = PolicyServer(cfg, ServeConfig(buckets=(2,), cache_capacity=2), device=device)
    srv.warmup()
    return srv


def _serve_trace(srv, device) -> Trace:
    """One served batch through PolicyServer._step on rows 0 and 1 of the
    cache (one of them starting fresh), after warmup."""
    import numpy as np
    import torch

    from r2d2_tpu_torch.ops.quantize import is_qleaf

    cfg = srv.cfg
    bucket = srv.batcher.buckets[0]
    params, _, _, arm = srv._published
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (t(rng.integers(0, 256, (bucket, *cfg.obs_shape), dtype=np.uint8)),
            t(rng.normal(size=bucket).astype(np.float32)),
            torch.arange(bucket, dtype=torch.long, device=device),
            t(np.arange(bucket) == 0),
            t(np.arange(bucket) == 1),
            t(np.zeros(bucket, np.int32)),
            None)
    watch = {f"{k}.q8": v["q8"] for k, v in params.items()
             if is_qleaf(v) and v["q8"].dtype == torch.int8}
    stores = dict(zip(("h", "c", "last_action", "last_reward"), srv.cache.arrays()))
    before = storage_specs(stores)
    trace, out = observe(lambda: srv._step(params, arm, bucket, *args),
                         [params, list(stores.values()), args], device, watch)
    trace.kept = (before, storage_specs(dict(zip(stores, srv.cache.arrays()))))
    trace.int8 = tuple(watch)
    if out is not None:
        trace.outputs = {"q": _dtype(out[0].dtype)}
    return trace


@functools.lru_cache(maxsize=None)
def serve_step_trace(precision: str, quantization: str = "none",
                     device: str = "cpu") -> Trace:
    """The serve step (PolicyServer._step) at the smallest bucket."""
    return _serve_trace(_serve_server(precision, quantization, device), device)


@functools.lru_cache(maxsize=None)
def _multi_serve_server(precision: str, quantization: str = "none", dp: int = 2,
                        device: str = "cpu"):
    from r2d2_tpu_torch.serve.multi import MultiDeviceServer
    from r2d2_tpu_torch.serve.server import ServeConfig

    cfg = _cfg(precision).replace(serve_quantization=quantization, serve_devices=dp,
                                  serve_spill=4)
    fleet = MultiDeviceServer(cfg, ServeConfig(buckets=(2,), cache_capacity=2),
                              devices=[device] * dp)
    fleet.warmup()
    return fleet


@functools.lru_cache(maxsize=None)
def multi_serve_step_trace(precision: str, quantization: str = "none", dp: int = 2,
                           replica: int = 0, device: str = "cpu") -> Trace:
    """One replica's serve step in the multi-device server (serve/multi.py)
    at the smallest bucket. Call once per replica: the recorded programs
    must agree."""
    fleet = _multi_serve_server(precision, quantization, dp, device)
    return _serve_trace(fleet.replicas[replica], device)


@functools.lru_cache(maxsize=None)
def liveloop_gather_trace(precision: str, device: str = "cpu") -> Trace:
    """The live-loop tap's device program: the batch's carry rows gathered
    off the session stores (liveloop/tap.gather_carry_rows)."""
    import torch

    from r2d2_tpu_torch.liveloop.tap import gather_carry_rows

    cfg = _cfg(precision)
    g = torch.Generator().manual_seed(0)
    # capacity + 1 rows (the scratch slot included), a 2-row batch gather
    h, c = (torch.randn((5, cfg.hidden_dim), generator=g).to(cfg.state_dtype).to(device)
            for _ in range(2))
    slots = torch.tensor([3, 1], dtype=torch.int32).to(device)
    trace, out = observe(lambda: gather_carry_rows(h, c, slots), [h, c, slots], device)
    if out is not None:
        trace.outputs = {"h-carry rows": _dtype(out[0].dtype),
                         "c-carry rows": _dtype(out[1].dtype)}
    return trace


# ----------------------------------------------------------- dtype checkers


def _dtypes(trace: Trace) -> set:
    return {d for op in trace.ops for d in op.out_dtypes}


def check_no_float64(trace: Trace, label: str) -> List[Finding]:
    """No float64 or complex128 tensor produced, either precision."""
    wide = {"float64", "complex128"} & _dtypes(trace)
    if wide:
        ops = sorted({op.name for op in trace.ops if wide & set(op.out_dtypes)})
        return [
            _finding(
                "graph-float64", label,
                f"the step produces {sorted(wide)} tensors ({', '.join(ops[:4])}): f64 "
                "doubles memory and runs at a fraction of the card's f32 rate",
                hint="find the widening op (a numpy float64 scalar or array reaching "
                "a torch op is the usual source) and pin float32",
            )
        ]
    return []


def check_no_bf16(trace: Trace, label: str) -> List[Finding]:
    """The fp32 golden path must be bf16-free (bit-exactness contract)."""
    if "bfloat16" in _dtypes(trace):
        return [
            _finding(
                "graph-bf16-in-fp32", label,
                "bf16 tensors inside the fp32 golden path: the bit-exact "
                "contract (precision='fp32') is broken",
                hint="a cast to cfg.torch_compute_dtype is leaking; the golden "
                "path must stay float32 end to end",
            )
        ]
    return []


def check_fp32_island(trace: Trace, label: str) -> List[Finding]:
    """Under bf16 the step must BOTH compute in bf16 (else the precision
    knob is dead) AND keep f32 ops (the loss/target/priority islands)."""
    out: List[Finding] = []
    dts = _dtypes(trace)
    if "bfloat16" not in dts:
        out.append(
            _finding(
                "graph-no-bf16-under-bf16", label,
                "precision='bf16' ran a step with no bf16 tensors: the compute "
                "plane silently stayed float32",
                hint="check torch_compute_dtype reaches the model cores",
            )
        )
    if "float32" not in dts:
        out.append(
            _finding(
                "graph-missing-fp32-island", label,
                "no float32 ops under bf16: the fp32 correctness islands "
                "(Q-target/value-rescale/TD/loss math) have been narrowed",
                hint="learner.make_loss_fn must cast target/TD math to float32 "
                "regardless of compute dtype",
            )
        )
    return out


def check_no_host_sync(trace: Trace, label: str) -> List[Finding]:
    """No host sync inside a step: a data-derived value read to the host, a
    copy of device data to the host, an op sized by the data, or (on the
    card) any call set_sync_debug_mode("error") refuses. Each one stops the
    host until the device has caught up, and the launches behind it wait."""
    hits = []
    if trace.sync_error:
        hits.append(f"a synchronizing CUDA call ({trace.sync_error})")
    for op in trace.ops:
        if op.name in _SYNC_OPS and op.tainted:
            hits.append(f"{op.name} at {op.where}" if op.where else op.name)
        elif "cuda" in op.in_devices and "cpu" in op.out_devices:
            hits.append(f"{op.name} (device to host)")
    if hits:
        uniq = list(dict.fromkeys(hits))
        return [
            _finding(
                "graph-host-sync", label,
                f"the step syncs with the host {len(hits)} time(s): "
                f"{', '.join(uniq[:4])}{'...' if len(uniq) > 4 else ''}",
                hint="keep the value on the device (torch.where instead of a "
                "branch, a device sum instead of int()); read results back after "
                "the step, through pinned buffers",
            )
        ]
    return []


def check_output_dtypes(outputs: Dict[str, str], want: str, label: str,
                        hint: str = "") -> List[Finding]:
    """Each named output leaves the step as `want`."""
    return [
        _finding(
            "graph-output-dtype", label,
            f"{name} leaves the step as {dt}, expected {want}", hint=hint,
        )
        for name, dt in outputs.items() if dt != want
    ]


# ---------------------------------------------------- kernel-launch checker


def check_kernel_launch_count(trace: Trace, label: str, expected: Dict[str, int],
                              what: str) -> List[Finding]:
    """The fused-sequence contract: one kernel dispatch per unroll (a train
    step is exactly 2 forwards + 1 backward of its arm's form per update).
    More means the sequence got split back into per-step launches; fewer,
    or another form, means a path fell off the kernels. On the card every
    dispatch must also be a launch (no plain version ran)."""
    got = {k: v for k, v in trace.dispatches.items() if v}
    want = {k: v for k, v in expected.items() if v}
    out: List[Finding] = []
    if got != want:
        out.append(
            _finding(
                "graph-kernel-launch-count", label,
                f"{what}: expected kernel dispatches {want}, found {got}",
                hint="the sequence kernel must stay fused: one dispatch per unroll "
                "(ops/lstm_kernel.py), never per timestep or segment",
            )
        )
    if trace.device == "cuda":
        launched = {k: v for k, v in trace.launches.items() if v}
        if launched != got:
            out.append(
                _finding(
                    "graph-kernel-launch-count", label,
                    f"{what}: dispatched {got} but launched {launched} on the card: "
                    "a plain version ran there",
                    hint="a kernel wrapper must launch on a CUDA tensor, never "
                    "fall back",
                )
            )
    return out


def check_int8_weights(trace: Trace, label: str) -> List[Finding]:
    """The int8 serve arm must carry int8 weights into the step (else the
    quantization knob is dead), and each must be first read by the
    dequantization (ops/quantize.dequantize_tree: a cast to a float
    compute dtype, never float64)."""
    if not trace.int8:
        return [
            _finding(
                "graph-no-int8-under-int8", label,
                "serve_quantization='int8' ran a step with no int8 weights: the "
                "quantized publish path is not reaching the step",
                hint="PolicyServer.prepare_for_publish must quantize at every "
                "publish point, and _step dequantize",
            )
        ]
    first: Dict[str, OpRecord] = {}
    for op in trace.ops:
        for name in op.consumes:
            first.setdefault(name, op)
    bad = []
    for name in trace.int8:
        op = first.get(name)
        if op is None:
            bad.append(f"{name} never read")
        elif op.name != "aten::_to_copy" or op.out_dtypes[0] not in (
                "float32", "bfloat16", "float16"):
            bad.append(f"{name} first read by {op.name} -> {op.out_dtypes}")
    if bad:
        return [
            _finding(
                "graph-no-int8-under-int8", label,
                f"int8 weights not dequantized in the step: {'; '.join(bad[:4])}",
                hint="_step must dequantize (q8.float() * scale) before use",
            )
        ]
    return []


# -------------------------------------------------------- donation checkers


def compare_kept_storage(before: dict, after: dict, label: str) -> List[Finding]:
    """The port's counterpart of donation: every tensor JAX donates (the
    TrainState's parameters and Adam moments, the superstep's tree, the
    serve cache's stores) keeps its storage, shape and dtype across the
    call, so no second copy of it stays resident."""
    moved = sorted(k for k in before if after.get(k) != before[k])
    if moved:
        return [
            _finding(
                "graph-donation-mismatch", label,
                f"{len(moved)} tensor(s) not updated in place: "
                f"{moved[:4]}{'...' if len(moved) > 4 else ''} — a new tensor "
                "replaced the kept one, so the step holds two copies",
                hint="update in place (copy_, add_, index_copy_), never rebind",
            )
        ]
    return []


def compare_store_fields(vals, specs, label: str) -> List[Finding]:
    """Core of the store-dtype rule, on any (padded vals, field specs) pair,
    numpy arrays and dtypes or torch tensors and dtypes: the device store's
    in-place writes need an exact shape+dtype match per field."""
    out: List[Finding] = []
    for k, (shape, dtype) in specs.items():
        if k not in vals:
            out.append(
                _finding(
                    "graph-store-field-mismatch", label,
                    f"store field {k!r} has a spec but pad_block_fields does not "
                    "produce it",
                    hint="extend pad_block_fields alongside store_field_specs",
                )
            )
            continue
        got = vals[k]
        if _dtype(got.dtype) != _dtype(dtype) or tuple(got.shape) != tuple(shape):
            out.append(
                _finding(
                    "graph-store-field-mismatch", label,
                    f"store field {k!r}: padded block gives {_dtype(got.dtype)}"
                    f"{list(got.shape)}, store expects {_dtype(dtype)}{list(shape)} "
                    "— the in-place store write needs an exact match",
                    hint="pad with the spec's dtype/shape from store_field_specs "
                    "(single source of truth)",
                )
            )
    for k in vals:
        if k not in specs:
            out.append(
                _finding(
                    "graph-store-field-mismatch", label,
                    f"pad_block_fields produces {k!r} with no store spec",
                    hint="extend store_field_specs alongside pad_block_fields",
                )
            )
    return out


def check_store_field_dtypes(precision: str) -> List[Finding]:
    """pad_block_fields, as the store writes it (bf16 bits viewed as
    bfloat16, replay/block.state_tensor), must agree with
    store_field_specs exactly (the bug class of an f32 hidden slab
    against a bf16 store)."""
    import numpy as np

    from r2d2_tpu_torch.replay.block import Block, state_tensor, store_field_specs
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer

    label = f"store_write[{precision}].dtypes"
    cfg = _cfg(precision)
    S, n, bl = cfg.seqs_per_block, cfg.block_slot_len - 1, cfg.block_length
    # accumulator-packed dtypes: uint8 actions, float32 hidden (the store
    # rounds at write time)
    block = Block(
        obs=np.zeros((n, *cfg.obs_shape), np.uint8),
        last_action=np.zeros(n, np.uint8),
        last_reward=np.zeros(n, np.float32),
        action=np.zeros(bl, np.uint8),
        n_step_reward=np.zeros(bl, np.float32),
        gamma=np.zeros(bl, np.float32),
        hidden=np.zeros((S, 2, cfg.hidden_dim), np.float32),
        num_sequences=S,
        burn_in_steps=np.full(S, cfg.burn_in_steps, np.int32),
        learning_steps=np.full(S, cfg.learning_steps, np.int32),
        forward_steps=np.full(S, cfg.forward_steps, np.int32),
    )
    vals = {k: state_tensor(v) for k, v in DeviceReplayBuffer.pad_block_fields(cfg, block).items()}
    return compare_store_fields(vals, store_field_specs(cfg), label)


def check_trace_budget(trace_count: int, buckets: Sequence[int],
                       label: str = "serve_step", arms: int = 1) -> List[Finding]:
    """The serve step may run at most one shape per batch bucket PER weight
    arm (`arms` > 1 when a degrade ladder warms its quality arms); more
    means some input's shape or dtype varies per request."""
    if trace_count > arms * len(buckets):
        return [
            _finding(
                "graph-trace-budget", label,
                f"serve step ran {trace_count} shapes for {len(buckets)} bucket "
                f"shape(s) x {arms} arm(s): some input's shape/dtype is varying per "
                "call",
                hint="pad requests to the bucket shapes; keep every other input's "
                "shape and dtype fixed",
            )
        ]
    return []


def check_auto_arm_resolution(cfg, arm: str, label: str, device: str = "cpu") -> List[Finding]:
    """A pinned budget must land backward_arm='auto' on its arm."""
    import torch

    resolved, _stride = cfg.resolve_backward_arm(device=torch.device(device).type)
    if resolved != arm:
        return [
            _finding(
                "graph-auto-arm-resolution", label,
                f"backward_arm={cfg.backward_arm!r} with budget="
                f"{cfg.backward_residual_budget_mb}MB resolved to {resolved!r}, "
                f"expected {arm!r} — the residual accounting moved under the gate's "
                "pinned budgets",
                hint="re-derive _AUTO_ARM_BUDGET_MB from "
                "ops/lstm_kernel.seq_backward_residual_bytes",
            )
        ]
    return []


def check_replica_divergence(traces: Sequence[Trace], label: str) -> List[Finding]:
    """Every replica runs the same program (op names, dtypes, shapes;
    devices aside): per-session results are then placement-independent."""
    programs = {tuple((op.name, op.out_dtypes, op.out_shapes) for op in t.ops)
                for t in traces}
    if len(programs) > 1:
        return [
            _finding(
                "graph-replica-divergence", label,
                f"the {len(traces)} serve replicas ran different programs: a "
                "replica's step closed over device- or index-dependent state, so "
                "per-session results depend on placement",
                hint="the step must be a pure function of (params, stores, batch "
                "inputs); placement belongs to the buffers, not the program",
            )
        ]
    return []


# ----------------------------------------------------------- entry scans


def _step_checks(trace: Trace, label: str, precision: str,
                      island: bool = True) -> List[Finding]:
    """No f64; the fp32 plane bf16-free; the bf16 plane computing in bf16
    and (`island`: where there is a loss) keeping its f32 islands."""
    out = check_no_float64(trace, label) + check_no_host_sync(trace, label)
    if precision == "fp32":
        out += check_no_bf16(trace, label)
    else:
        out += [f for f in check_fp32_island(trace, label)
                if island or f.rule == "graph-no-bf16-under-bf16"]
    return out


def _train_checks(trace: Trace, label: str, precision: str, what: str) -> List[Finding]:
    return (_step_checks(trace, label, precision)
            + check_kernel_launch_count(trace, label, trace.expected, what)
            + compare_kept_storage(*trace.kept, f"{label}.donation"))


_TRAIN_WHAT = "train step (online fwd + target fwd + one backward kernel per update)"


def scan_train_step(precision: str, device: str = "cpu") -> List[Finding]:
    label = f"train_step[{precision}]"
    trace = train_step_trace(precision, device)
    out = _step_checks(trace, label, precision)
    # metrics and priorities leave the step float32 at either precision
    # (the priority trees and the jsonl metrics assume it)
    out += check_output_dtypes(trace.outputs, "float32", f"{label}.outputs",
                               hint="mixed_td_priorities and the metrics are loss-"
                               "island values; keep them f32")
    return out


def scan_multitask_train_step(precision: str, device: str = "cpu") -> List[Finding]:
    """The task-conditioned train step under the golden path's contracts:
    the task one-hot and the valid-action mask must not smuggle in a wider
    dtype or a host read."""
    return _step_checks(multitask_train_step_trace(precision, device),
                             f"multitask_train_step[{precision}]", precision)


def scan_resharded_train_step(precision: str, dp: int = 2, device: str = "cpu") -> List[Finding]:
    """The sharded train step on a reshard-target layout (dp=2)."""
    label = f"resharded_train_step[dp={dp},{precision}]"
    return _step_checks(resharded_train_step_trace(precision, dp, device), label,
                             precision)


def scan_act(precision: str, device: str = "cpu") -> List[Finding]:
    label = f"act[{precision}]"
    trace = act_trace(precision, device)
    # act has no loss island: only the no-silent-fp32 half applies
    return (_step_checks(trace, label, precision, island=False)
            + check_kernel_launch_count(trace, label, {}, "act step (no kernel)"))


def scan_act_select(precision: str, device: str = "cpu") -> List[Finding]:
    label = f"act_select[{precision}]"
    trace = act_select_trace(precision, device)
    out = _step_checks(trace, label, precision, island=False)
    out += check_kernel_launch_count(trace, label, {}, "act_select step (no kernel)")
    # the selected actions leave as int32 (models/r2d2.py act_select; every
    # caller stores them into int32 slabs)
    out += check_output_dtypes(trace.outputs, "int32", label)
    return out


def scan_fused_unroll(precision: str, device: str = "cpu") -> List[Finding]:
    """One kernel dispatch per unroll: the forward sequence unroll is one
    forward; the train step (its own trace: the port's train step always
    runs through the wrappers) 2 forwards + 1 backward per update."""
    from r2d2_tpu_torch.ops.lstm_kernel import _form

    label = f"fused_unroll[{precision}]"
    trace = fused_unroll_trace(precision, device)
    out = check_no_float64(trace, label)
    out += check_kernel_launch_count(
        trace, label, {_form("lstm_fwd", _cfg(precision).torch_compute_dtype): 1},
        "forward sequence unroll")
    ts = train_step_trace(precision, device)
    out += check_kernel_launch_count(ts, f"fused_train_step[{precision}]", ts.expected,
                                     _TRAIN_WHAT)
    return out


def scan_backward_arms(precision: str, device: str = "cpu") -> List[Finding]:
    """The alternative backward arms (fused_dwh, ckpt): each holds the same
    3-dispatch budget (no extra launches bought with the memory savings),
    the precision contracts and the in-place TrainState."""
    out: List[Finding] = []
    for arm in ("fused_dwh", "ckpt"):
        out += _train_checks(backward_arm_train_step_trace(precision, arm, device),
                             f"backward_arm[{arm}][{precision}]", precision, _TRAIN_WHAT)
    return out


def scan_auto_backward_arms(precision: str, device: str = "cpu") -> List[Finding]:
    """backward_arm='auto' end to end: for each non-default arm, a config
    whose budget (or explicit knob, for the fp32 fused cell auto cannot
    reach) resolves to it, under the same contracts as the arms above. A
    selection drift is itself a finding."""
    out: List[Finding] = []
    for arm in ("fused_dwh", "ckpt"):
        label = f"auto_backward_arm[{arm}][{precision}]"
        miss = check_auto_arm_resolution(_auto_arm_cfg(precision, arm), arm, label, device)
        if miss:
            out += miss
            continue
        out += _train_checks(auto_backward_arm_train_step_trace(precision, arm, device),
                             label, precision, _TRAIN_WHAT)
    return out


def scan_manual_train_step(precision: str, dp: int = 2, tp: int = 2, fsdp: int = 2,
                           device: str = "cpu") -> List[Finding]:
    """The manual tp x fsdp step: the golden path's contracts, 2 + 1
    dispatches per batch shard (dp x fsdp of them) and the in-place state,
    moment shards included."""
    label = f"manual_train_step[dp={dp},tp={tp},fsdp={fsdp},{precision}]"
    return _train_checks(manual_train_step_trace(precision, dp, tp, fsdp, device), label,
                         precision, "manual step (2 forwards + 1 backward per batch shard)")


def scan_superstep(precision: str, device: str = "cpu") -> List[Finding]:
    """The N x K priority superstep: no f64 in the tree math, the precision
    contracts, N·K·(2 + 1) dispatches, and the TrainState and the tree kept
    in place across the N dispatches."""
    label = f"priority_superstep[N{_SUPERSTEP_N}xK{_NUM_STEPS},{precision}]"
    return _train_checks(priority_superstep_trace(precision, device), label, precision,
                         "superstep (2 forwards + 1 backward per update)")


def scan_serve_step(precision: str, device: str = "cpu") -> List[Finding]:
    label = f"serve_step[{precision}]"
    trace = serve_step_trace(precision, "none", device)
    out = _step_checks(trace, label, precision, island=False)
    # q comes back f32 for the host-side audit path
    out += check_output_dtypes(trace.outputs, "float32", label,
                               hint="the dueling head is an fp32 island")
    out += compare_kept_storage(*trace.kept, f"{label}.donation")
    return out


def scan_serve_step_int8(precision: str = "fp32", device: str = "cpu") -> List[Finding]:
    """The int8 serve arm: int8 weights present and dequantized in the step,
    no f64, the fp32 arm bf16-free."""
    label = f"serve_step[int8,{precision}]"
    trace = serve_step_trace(precision, "int8", device)
    return (_step_checks(trace, label, precision, island=False)
            + check_int8_weights(trace, label))


def scan_trace_budget(precision: str, device: str = "cpu") -> List[Finding]:
    """After warmup over the buckets and the ladder's three arms, the serve
    step has run no more shapes than buckets x arms."""
    srv = _serve_server(precision, "none", device, degrade=True)
    return check_trace_budget(srv.trace_count, srv.batcher.buckets,
                              f"serve_step[{precision}].trace_budget", arms=3)


def scan_multi_serve_step(precision: str, quantization: str = "none", dp: int = 2,
                          device: str = "cpu") -> List[Finding]:
    """Each replica of the fleet keeps the single server's contracts, and
    all replicas run the identical program."""
    out: List[Finding] = []
    traces = []
    for i in range(dp):
        label = f"multi_serve_step[d{i}/{dp},{quantization},{precision}]"
        trace = multi_serve_step_trace(precision, quantization, dp, i, device)
        traces.append(trace)
        out += _step_checks(trace, label, precision, island=False)
        if quantization == "int8":
            out += check_int8_weights(trace, label)
    out += check_replica_divergence(traces, f"multi_serve_step[{quantization},{precision}]")
    return out


def scan_liveloop_gather(precision: str, device: str = "cpu") -> List[Finding]:
    """The live-loop tap's gather: the serve step's hygiene (no f64, no
    host sync), and float32 carries whatever the cache dtype."""
    label = f"liveloop_gather[{precision}]"
    trace = liveloop_gather_trace(precision, device)
    out = check_no_float64(trace, label) + check_no_host_sync(trace, label)
    out += check_output_dtypes(trace.outputs, "float32", label,
                               hint="gather_carry_rows must cast to float32 after the "
                               "gather — the cache may hold bf16")
    return out


def scan_donation(precision: str, device: str = "cpu") -> List[Finding]:
    """The train step's TrainState kept in place, and the store fields."""
    label = f"train_step[{precision}].donation"
    return (compare_kept_storage(*train_step_trace(precision, device).kept, label)
            + check_store_field_dtypes(precision))


def scan_entry_points(precisions: Sequence[str] = ("fp32", "bf16"),
                      device: str = "cuda") -> List[Finding]:
    """The full graph gate: every canonical entry point at every precision
    on `device`, plus the store-field and trace-budget contracts. Zero
    findings on a healthy tree (tier-1 asserts this on the CPU; chip_smoke
    phase 30 on the card)."""
    from r2d2_tpu_torch.config import resolve_device

    device = str(resolve_device(device))
    out: List[Finding] = []
    for p in precisions:
        out += scan_train_step(p, device)
        out += scan_multitask_train_step(p, device)
        out += scan_resharded_train_step(p, device=device)
        out += scan_act(p, device)
        out += scan_act_select(p, device)
        out += scan_fused_unroll(p, device)
        out += scan_backward_arms(p, device)
        out += scan_auto_backward_arms(p, device)
        out += scan_manual_train_step(p, device=device)
        out += scan_superstep(p, device)
        out += scan_serve_step(p, device)
        out += scan_trace_budget(p, device)
        out += scan_multi_serve_step(p, device=device)
        out += scan_liveloop_gather(p, device)
        out += scan_donation(p, device)
    # the quantized arm composes with precision the same way everywhere;
    # one run on the golden path keeps the gate's runtime bounded
    out += scan_serve_step_int8("fp32", device)
    out += scan_multi_serve_step("fp32", "int8", device=device)
    out.sort(key=Finding.sort_key)
    return out


# --------------------------------------- any config (chip_smoke's full widths)


def scan_train_config(cfg, device, label: str, num_steps: int = 1) -> Tuple[List[Finding], Trace]:
    """The train step on any config (the atari widths on the card): the
    precision contracts, the outputs, the dispatches and the in-place
    state. -> (findings, trace)."""
    precision = "bf16" if cfg.resolved_compute_dtype == "bfloat16" else "fp32"
    trace = _train_trace(cfg, device, num_steps)
    out = _train_checks(trace, label, precision, _TRAIN_WHAT)
    out += check_output_dtypes(trace.outputs, "float32", f"{label}.outputs")
    return out, trace


def scan_serve_config(cfg, device, label: str) -> Tuple[List[Finding], Trace]:
    """The serve step on any config (serve_quantization as it says): one
    bucket of 2 after warmup. -> (findings, trace)."""
    from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig

    precision = "bf16" if cfg.resolved_compute_dtype == "bfloat16" else "fp32"
    srv = PolicyServer(cfg, ServeConfig(buckets=(2,), cache_capacity=2), device=device)
    srv.warmup()
    trace = _serve_trace(srv, device)
    out = _step_checks(trace, label, precision, island=False)
    out += check_output_dtypes(trace.outputs, "float32", label)
    out += check_kernel_launch_count(trace, label, {}, "serve step (no kernel)")
    out += compare_kept_storage(*trace.kept, f"{label}.donation")
    if cfg.serve_quantization == "int8":
        out += check_int8_weights(trace, label)
    return out, trace


# -------------------------------------------------- source-keyed result cache

# Everything the entry points can reach: the recorded programs are
# functions of these sources (plus torch itself, which the fast local loop
# does not version). Directories are walked recursively.
_ENTRY_POINT_SOURCES = (
    "config.py",
    "learner.py",
    "megastep.py",
    "models",
    "ops",
    "parallel",
    "replay/block.py",
    "replay/control_plane.py",
    "replay/device_store.py",
    "replay/device_sum_tree.py",
    "serve/batcher.py",
    "serve/degrade.py",
    "serve/multi.py",
    "serve/server.py",
    "serve/state_cache.py",
    "liveloop/tap.py",
    "analysis/graph_rules.py",  # the checkers are inputs too
)


def entry_point_source_files() -> List[str]:
    """Absolute paths of every source file the entry points (and the
    checkers) depend on."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: List[str] = []
    for rel in _ENTRY_POINT_SOURCES:
        p = os.path.join(pkg, rel)
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
        elif os.path.exists(p):
            out.append(p)
    return sorted(out)


def source_fingerprint(device: str = "") -> str:
    """sha256 over (relative path, bytes) of every entry-point source, in
    sorted order, and the device: identical tree and device, identical
    fingerprint, regardless of mtimes or checkout location."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    h.update(device.encode())
    h.update(b"\0")
    for path in entry_point_source_files():
        h.update(os.path.relpath(path, pkg).replace(os.sep, "/").encode())
        h.update(b"\0")
        with open(path, "rb") as fh:
            h.update(fh.read())
        h.update(b"\0")
    return h.hexdigest()


def scan_entry_points_cached(cache_path: str, precisions: Sequence[str] = ("fp32", "bf16"),
                             device: str = "cuda") -> List[Finding]:
    """scan_entry_points with a result cache keyed on
    source_fingerprint(device): when none of the entry points' sources
    changed, the cached findings are returned without importing torch or
    running anything. A corrupt, stale or missing cache falls through to a
    real scan."""
    fp = source_fingerprint(device)
    try:
        with open(cache_path, encoding="utf-8") as fh:
            data = json.load(fh)
        if data.get("fingerprint") == fp:
            return [Finding(**d) for d in data["findings"]]
    except (OSError, ValueError, KeyError, TypeError):
        pass
    findings = scan_entry_points(precisions, device)
    tmp = f"{cache_path}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"fingerprint": fp, "findings": [f.to_dict() for f in findings]}, fh)
        os.replace(tmp, cache_path)
    except OSError:
        pass  # the cache is an optimization; the scan result stands
    return findings
