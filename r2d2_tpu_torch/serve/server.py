"""The serve loop: supervised batched acting with checkpoint hot reload (port
of r2d2_tpu/serve/server.py).

One thread owns the device and the session cache: it pulls micro-batches
from the batcher, advances every session of a batch in one serve step
(``R2D2Network.act_select``: the encoder, one core step, the dueling head
and the ε-greedy tail) and resolves each request's Future with its action.
The workers run under ``utils/supervision.Supervisor`` as the training
workers do:

- ``serve-loop``: batch formation, STAGE (assembly into the batcher's
  preallocated buffers, the exploration draws in arrival order) and
  DISPATCH (the copies to the device, the step, the cache rows written in
  place, and the read-back of q and the actions started into pinned
  buffers with a CUDA event); a raising iteration fails only the in-flight
  requests (its recovery hook) and the loop restarts with the cache
  intact;
- ``serve-complete`` (cfg.serve_pipeline, the default): waits on each
  dispatched batch's event in dispatch order, resolves its futures and
  logs its metrics, while the serve thread stages and dispatches the next
  batch. A depth-2 semaphore bounds how far staging runs ahead: a staging
  set and its read-back buffers are handed out again only after the batch
  that used them completed. With serve_pipeline=False the serve loop
  completes each batch itself; both share one stage/dispatch body and
  complete in dispatch order, so their answers are the same bit for bit;
- ``ckpt-watcher``: polls the checkpoint series (utils/checkpoint.py) and
  publishes new parameters;
- ``degrade-controller`` (cfg.serve_degrade): one tick of the degradation
  ladder (serve/degrade.py) at its cadence.

Hot reload is one attribute swap: the parameters travel as one ``(params,
ckpt_step, version, arm)`` tuple, read once a batch, so every request of a
batch is answered by one checkpoint and one weight format, and in-flight
batches complete under the parameters they were dispatched with. The
parameters are the network's state_dict, cloned onto the serving device at
publish in the arm's format: "full" as the config says (the encoder's and
head's weights as int8 and a scale under serve_quantization="int8",
ops/quantize.py), "bf16" every float tensor rounded to bfloat16, "int8"
quantized whatever the config. The step dequantizes int8 and upcasts bf16
back to float32 (where JAX promotes a bf16 weight against f32 activations;
torch's linear and conv refuse mixed dtypes), so only the weights' rounding
drifts, never the activations. It runs the network through
``torch.func.functional_call`` on this server's own module, so a publish
never writes into a module another thread uses, and no two replicas of a
fleet (serve/multi.py) share one.

The live loop (liveloop/) hangs two hooks here: ``eps_assigner`` gives
each session its sticky exploration epsilon at staging, and ``tap``
records every served batch. The step writes the cache's tensors in place,
so the tap's gather of the batch's new carries runs at dispatch, on the
serving stream right after the write and before the next batch's step,
into new float32 tensors copied to pinned buffers behind the batch's
event; the completion side hands them to the tap.

The JAX package counts the step's traces (one per bucket shape and weight
format); the port compiles nothing, and ``trace_count`` counts the
distinct (weight format, bucket) step shapes it has run instead: ``warmup``
runs each bucket once (in every arm the ladder may publish, when it is
on), so traffic adds none.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from r2d2_tpu_torch.config import R2D2Config, resolve_device, set_fp32_numerics
from r2d2_tpu_torch.learner import init_train_state
from r2d2_tpu_torch.ops.quantize import dequantize_tree, quantize_tree
from r2d2_tpu_torch.serve.batcher import BucketStaging, MicroBatcher, ServeRequest, StagedBatch
from r2d2_tpu_torch.serve.degrade import DegradeConfig, DegradeController
from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache
from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step, restore_checkpoint
from r2d2_tpu_torch.utils.faults import Backoff, InjectedFault, fault_point, total_retries
from r2d2_tpu_torch.utils.metrics import MetricsLogger
from r2d2_tpu_torch.utils.supervision import Supervisor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-plane knobs (the network's config stays R2D2Config)."""

    buckets: Tuple[int, ...] = (2, 4, 8, 16, 32)
    max_wait_ms: float = 2.0
    queue_depth: int = 1024
    cache_capacity: int = 4096
    poll_interval_s: float = 0.5  # checkpoint watcher cadence
    epsilon: float = 0.0  # serving default: greedy
    max_restarts: int = 3
    seed: int = 0


class ServeResult:
    """One answered request: the action, its Q row, and the provenance
    (checkpoint step, params version, the bucket it was served at and its
    row in that batch: a reference padded to the same bucket with the
    session at the same row runs the same shapes, which makes bit parity
    structural)."""

    __slots__ = ("action", "q", "ckpt_step", "params_version", "bucket", "row")

    def __init__(self, action: int, q: np.ndarray, ckpt_step: int,
                 params_version: int, bucket: int = 0, row: int = 0):
        self.action = action
        self.q = q
        self.ckpt_step = ckpt_step
        self.params_version = params_version
        self.bucket = bucket
        self.row = row

    def __repr__(self) -> str:
        return (f"ServeResult(action={self.action}, ckpt_step={self.ckpt_step}, "
                f"params_version={self.params_version})")


@dataclasses.dataclass
class _PipelineRecord:
    """One dispatched batch between DISPATCH and COMPLETE: its provenance,
    q and the actions (device tensors), their host copies in the staging
    set's buffers (pinned on the card), and the event after those copies
    (on the card; None on the CPU). `staged`
    is its staging set (handed out again only after this record
    completes); `tap` the tap it was dispatched under and `tap_rows` the
    batch's new carries gathered for it (host tensors once `event` has
    passed)."""

    batch: List[ServeRequest]
    n: int
    bucket: int
    ckpt_step: int
    version: int
    arm: str
    q: torch.Tensor
    action: torch.Tensor
    q_host: torch.Tensor
    action_host: torch.Tensor
    event: Optional[object]
    staged: StagedBatch
    tap: Optional[object] = None
    tap_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


ARMS = ("full", "bf16", "int8")


class _Acting(nn.Module):
    """The network's acting forward as a module's forward, for
    functional_call (parameter names prefixed "net.")."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, obs, last_action, last_reward, carry, explore, random_actions, task):
        return self.net.act_select(obs, last_action, last_reward, carry, explore,
                                   random_actions, task=task)


def _call(acting: _Acting, params: Mapping[str, torch.Tensor], *args):
    return functional_call(acting, {f"net.{k}": v for k, v in params.items()}, args)


# reference_act's own acting module per network and thread: functional_call
# swaps a module's parameters while it runs, so no two threads share one
_REF_MODULES: "weakref.WeakKeyDictionary[nn.Module, Dict[int, _Acting]]" = (
    weakref.WeakKeyDictionary())


def _pad_obs(obs: np.ndarray, target: Tuple[int, ...]) -> np.ndarray:
    """Zero-pad one request's obs up to the serving geometry (a multi-task
    family of mixed shapes: a smaller task's frame sits in the top-left
    corner of the union canvas, where the training side renders it)."""
    target = tuple(target)
    if obs.shape == target:
        return obs
    if obs.ndim != len(target) or any(s > t for s, t in zip(obs.shape, target)):
        raise ValueError(f"request obs shape {obs.shape} does not fit the serve "
                         f"obs_shape {target}")
    return np.pad(obs, [(0, t - s) for s, t in zip(obs.shape, target)])


def _host_buffer(staged: StagedBatch, name: str, shape, dtype, pin: bool) -> torch.Tensor:
    """The staging set's host buffer `name` (pinned on the card), made at
    its first use at this shape and dtype. It belongs to the set: a set's
    buffers are never handed to another set, and go with it."""
    buf = staged.host.get(name)
    if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
        buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
        staged.host[name] = buf
    return buf


@torch.no_grad()
def reference_act(net, params, obs, last_action, last_reward, carry, min_batch: int = 2,
                  task=None, row: int = 0):
    """The direct acting path the tests and the chip check compare the
    server with: ``net.act`` on exactly the given sessions, under `params`
    (the network's state_dict, or a dequantized one), from batch row `row`
    on, with zero rows around them up to `min_batch`. cuBLAS picks its
    algorithm by shape, as XLA does, and a batch of one takes the
    matrix-vector path; the CPU's matmuls also sum a row by its position
    (a block's last rows in another kernel). Rows never see each other's
    values, so the bucket and row the server answered at
    (``ServeResult.bucket``, ``.row``) run what the server ran. `task`
    ((B,) int, multi-task serving) conditions the head as the server does.
    -> (q (B, A), (h, c)) of the B real rows, on the network's device."""
    dev = next(net.parameters()).device
    per_thread = _REF_MODULES.setdefault(net, {})
    acting = per_thread.get(threading.get_ident())
    if acting is None:
        acting = per_thread[threading.get_ident()] = _Acting(copy.deepcopy(net))
    obs = torch.as_tensor(np.asarray(obs)).to(dev)
    la = torch.as_tensor(np.asarray(last_action, np.int32)).to(dev)
    lr = torch.as_tensor(np.asarray(last_reward, np.float32)).to(dev)
    h, c = (torch.as_tensor(x).to(dev) for x in carry)
    if task is not None:
        task = torch.as_tensor(np.asarray(task, np.int32)).to(dev)
    B = obs.shape[0]
    after = max(min_batch - B - row, 0)

    def pad(t):
        return torch.cat([t.new_zeros((row, *t.shape[1:])), t, t.new_zeros((after, *t.shape[1:]))])

    obs, la, lr, h, c = map(pad, (obs, la, lr, h, c))
    if task is not None:
        task = pad(task)
    zeros = torch.zeros(obs.shape[0], dtype=torch.bool, device=dev)
    q, _, (h_out, c_out) = _call(acting, params, obs, la, lr, (h, c), zeros,
                                 torch.zeros_like(la), task)
    real = slice(row, row + B)
    return q[real], (h_out[real], c_out[real])


class PolicyServer:
    """Session-stateful batched policy service over a trained checkpoint.

    Lifecycle: construct (the parameters given, or restored from the latest
    checkpoint under `checkpoint_dir`, or a fresh init from
    ServeConfig.seed), `warmup()`, `start()`, submit requests (or use a
    serve.client wrapper), `stop()`. `check()` passes the supervisor's
    restart and stall counters on and raises if a worker died for good.
    `device` is the serving device (the card unless the caller asks for the
    CPU). `mesh` (parallel/mesh.Mesh) instead places every published
    parameter set by sharding_map.serve_param_shardings, int8 trees
    included: each tp member holds its slice on its device, and the step
    gathers the slices onto the mesh's first device, where it serves."""

    def __init__(
        self,
        cfg: R2D2Config,
        serve_cfg: ServeConfig = ServeConfig(),
        params: Optional[Mapping[str, torch.Tensor]] = None,
        checkpoint_dir: Optional[str] = None,
        metrics: Optional[MetricsLogger] = None,
        device=None,
        name: str = "",
        template=None,
        degrade: Optional[DegradeController] = None,
        mesh=None,
    ):
        if mesh is not None and device is not None:
            raise ValueError("pass device= or mesh=, not both")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.checkpoint_dir = checkpoint_dir
        self.metrics = metrics
        self.mesh = mesh
        self.device = resolve_device(mesh.device_at(0) if mesh is not None
                                     else "cuda" if device is None else device)
        self.name = name  # the workers' name suffix
        # the template restores checkpoints (a fleet passes its own, built
        # once); the acting module is this server's alone, on its device
        # (functional_call swaps its parameters while it runs)
        if template is None:
            _, template = init_train_state(cfg, self.device, seed=serve_cfg.seed)
        elif self.device.type == "cuda":
            set_fp32_numerics()
        self._template = template
        self.net = copy.deepcopy(template.net).to(self.device).requires_grad_(False)
        self._acting = _Acting(self.net)
        ckpt_step = -1
        if params is None:
            if checkpoint_dir is not None and latest_checkpoint_step(checkpoint_dir) is not None:
                state, _, _ = restore_checkpoint(checkpoint_dir, self._template,
                                                 map_location=self.device)
                params, ckpt_step = state.net.state_dict(), int(state.step)
            else:
                params = self._template.net.state_dict()  # fresh init (smoke serving)
        self.quantized_leaves = 0
        # guards the publish cell, the counters and the in-flight handoff
        # between the serve loop, the completion worker, the watcher, the
        # ladder and stop(); the slow half of a publish (clone, cast,
        # quantize, copy to the device) runs outside
        self._state_lock = threading.Lock()
        # the hot-reload cell: one attribute holding one tuple (params,
        # ckpt_step, version, arm), read once a batch
        self._published: Tuple[Dict[str, object], int, int, str] = ({}, ckpt_step, -1, "full")
        # the parameters as given, which every arm is prepared from (a
        # bf16 -> int8 switch must not round twice)
        self._params_raw = params
        self.arm_switches = 0
        self.publish(params, ckpt_step, version=0)

        if serve_cfg.cache_capacity < max(serve_cfg.buckets):
            # a batch's own admissions must never evict a co-batched session
            raise ValueError(
                f"cache_capacity ({serve_cfg.cache_capacity}) must be >= the "
                f"largest batch bucket ({max(serve_cfg.buckets)})")
        # carries in cfg.state_dtype (bfloat16 under precision="bf16");
        # cfg.serve_spill > 0 adds the host spill slab
        self.cache = RecurrentStateCache(serve_cfg.cache_capacity, cfg.hidden_dim,
                                         dtype=cfg.state_dtype,
                                         spill_capacity=cfg.serve_spill, device=self.device)
        self.batcher = MicroBatcher(buckets=serve_cfg.buckets,
                                    max_wait_s=serve_cfg.max_wait_ms / 1000.0,
                                    queue_depth=serve_cfg.queue_depth)
        self._rng = np.random.default_rng(serve_cfg.seed)
        self._staging = BucketStaging(serve_cfg.buckets, num_tasks=cfg.num_tasks)
        # the pipeline's depth bound: taken before a batch stages, given back
        # when it completes
        self._depth_sem = threading.Semaphore(2)
        self._complete_q: "queue.Queue[_PipelineRecord]" = queue.Queue()
        self._complete_worker = None
        self.completed_batches = 0
        self.metrics_skipped = 0
        self._metrics_last_t = float("-inf")
        self._metrics_last_version: Optional[int] = None
        self._metrics_last_arm: Optional[str] = None
        self._task_dims = (np.asarray(cfg.task_action_dims, np.int64)
                           if cfg.task_action_dims else None)
        self._step_shapes: set = set()
        # the live loop's hooks (liveloop/loop.py installs both; None serves
        # as before): the tap records served batches, the assigner gives
        # each session its sticky exploration epsilon
        self.tap = None
        self.eps_assigner = None
        self.reloads = 0
        self.reload_errors = 0
        self._watch_backoff = Backoff(base=serve_cfg.poll_interval_s, factor=2.0,
                                      max_delay=max(30.0, serve_cfg.poll_interval_s))
        self._inflight: List[ServeRequest] = []
        # the degradation ladder (serve/degrade.py), off by default; a
        # fleet passes its one shared controller in and runs its worker
        # itself
        self.degrade = degrade
        if degrade is None and cfg.serve_degrade:
            self.degrade = DegradeController(self, DegradeConfig(slo_ms=cfg.serve_degrade_slo_ms))
        # more per-request latency observers (the autoscaler's own window
        # when there is no ladder to share one with)
        self._latency_sinks: tuple = ()
        self.supervisor: Optional[Supervisor] = None
        self._serve_worker = None
        self._watch_worker = None

    # -------------------------------------------------------------- publish

    @property
    def trace_count(self) -> int:
        """The distinct (weight format, bucket) step shapes run so far."""
        return len(self._step_shapes)

    def _int8(self, arm: str) -> bool:
        """Whether an arm's weights are int8 (the int8 arm, or the full arm
        under serve_quantization="int8")."""
        return arm == "int8" or (arm == "full" and self.cfg.serve_quantization == "int8")

    def prepare_for_publish(self, params: Mapping[str, torch.Tensor], arm: Optional[str] = None):
        """The slow half of a publish, with no lock held: the arm's weight
        format (int8 quantization or the bf16 cast, on the host) and a copy
        of every tensor on the serving device. `arm` None keeps the
        published one. -> (params, the number of quantized leaves, arm), for
        install_prepared."""
        if arm is None:
            arm = self._published[3]
        if arm not in ARMS:
            raise ValueError(f"unknown serve arm {arm!r}")
        host = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
        leaves = 0
        if self._int8(arm):
            host, leaves = quantize_tree(host)
        elif arm == "bf16":
            host = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                    for k, v in host.items()}
        if self.mesh is not None:
            from r2d2_tpu_torch.parallel.sharding_map import place_params

            return place_params(host, self.mesh), leaves, arm
        out = {k: ({kk: vv.to(self.device) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(self.device)) for k, v in host.items()}
        return out, leaves, arm

    # r2d2: guarded-by(_state_lock)  (install_prepared's body; every caller holds the lock)
    def _install(self, prepared, ckpt_step: int, version: Optional[int], raw_params) -> None:
        params, leaves, arm = prepared
        self.quantized_leaves = leaves
        if raw_params is not None:
            self._params_raw = raw_params
        if version is None:
            version = self._published[2] + 1
        self._published = (params, int(ckpt_step), version, arm)

    def install_prepared(self, prepared, ckpt_step: int, version: Optional[int] = None,
                         raw_params=None) -> None:
        """The O(1) half of a publish, under the lock: swap the publish cell
        and bump the version (or take the fleet's). `raw_params` renews the
        parameters the arms are prepared from."""
        with self._state_lock:
            self._install(prepared, ckpt_step, version, raw_params)

    def publish(self, params: Mapping[str, torch.Tensor], ckpt_step: int,
                version: Optional[int] = None, arm: Optional[str] = None) -> None:
        """Publish a parameter set: prepare it outside the lock, then swap
        the publish cell in one guarded write. With `arm` None it is
        prepared in the live arm, and again if an arm switch landed
        meanwhile: a reload never undoes the ladder's rung."""
        while True:
            live = self._published[3]
            prepared = self.prepare_for_publish(params, live if arm is None else arm)
            with self._state_lock:
                if arm is None and self._published[3] != live:
                    continue
                self._install(prepared, ckpt_step, version, params)
            return

    def set_arm(self, arm: str) -> bool:
        """Switch the ladder's weight format: prepare the raw parameters in
        `arm` outside every lock and swap the cell, keeping ckpt_step and
        bumping the version. -> False when `arm` is already live, checked
        again under the lock (two switches to one arm bump it once). A
        reload that lands while it prepares makes it prepare again from the
        new parameters, never label the old ones with the new step."""
        while True:
            with self._state_lock:
                raw, live = self._params_raw, self._published[3]
            if arm == live:
                return False
            params, leaves, _ = self.prepare_for_publish(raw, arm)
            with self._state_lock:
                _, ckpt_step, version, live = self._published
                if arm == live:
                    return False
                if self._params_raw is not raw:
                    continue  # a reload landed meanwhile
                self.quantized_leaves = leaves
                self._published = (params, ckpt_step, version + 1, arm)
                self.arm_switches += 1
            return True

    def _compute_params(self, params, arm: str) -> Dict[str, torch.Tensor]:
        """A published set as the step computes with it: int8 dequantized,
        bf16 upcast to float32 (the weights' rounding stays, the
        activations keep their dtype); a mesh's placed slices gathered onto
        the serving device first."""
        if self.mesh is not None:
            from r2d2_tpu_torch.parallel.sharding_map import gather_params

            params = gather_params(params, self.device)
        if self._int8(arm):
            return dequantize_tree(params)
        if arm == "bf16":
            return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in params.items()}
        return dict(params)

    def served_params(self) -> Dict[str, torch.Tensor]:
        """The float parameters the published set serves with (dequantized
        under int8, upcast under bf16): what reference_act takes to hold the
        server to."""
        params, _, _, arm = self._published
        return self._compute_params(params, arm)

    # -------------------------------------------------- degrade surface
    # (serve/degrade.py drives these; serve/multi.py has the same)

    @property
    def queue_bound(self) -> int:
        return self.serve_cfg.queue_depth

    def queue_depth(self) -> int:
        return self.batcher.qsize()

    def set_admission(self, limit: Optional[int], budget: int = 0) -> None:
        self.batcher.set_admission(limit, budget=budget)

    def shed_spill(self, keep_fraction: float) -> int:
        return self.cache.shed_spill(keep_fraction)

    # ------------------------------------------------------------ the step

    @torch.no_grad()
    def _step(self, params, arm: str, bucket: int, obs, rewards, slots, reset_mask, explore,
              random_actions, task):
        """Gather the batch's rows, zero the rows that start fresh, act, and
        write the new rows back into the cache in place. Pad rows all use
        the scratch row (their writes collide there harmlessly; the real
        rows are unique)."""
        # a record of the shapes served, read by checks; warmup and the serve
        # loop may both add to it, and set.add is atomic under the GIL
        # r2d2: disable=cross-thread-unguarded-write  (an atomic set.add; stats only)
        self._step_shapes.add(("int8" if self._int8(arm) else arm, bucket))
        params = self._compute_params(params, arm)
        h_store, c_store, la_store, _ = self.cache.arrays()
        zero = reset_mask[:, None]
        h = torch.where(zero, 0, h_store.index_select(0, slots))
        c = torch.where(zero, 0, c_store.index_select(0, slots))
        la = torch.where(reset_mask, 0, la_store.index_select(0, slots))
        lr = torch.where(reset_mask, 0.0, rewards)
        q, action, (h_new, c_new) = _call(self._acting, params, obs, la, lr, (h, c),
                                          explore, random_actions, task)
        self.cache.write(slots, h_new, c_new, action, lr)
        return q, action

    # -------------------------------------------------------------- serving

    def submit(self, session_id: str, obs, reward: float = 0.0, reset: bool = False,
               epsilon: Optional[float] = None, task: int = 0) -> Future:
        return self.batcher.submit(session_id, obs, reward=reward, reset=reset,
                                   epsilon=epsilon, task=task)

    def reset_session(self, session_id: str) -> None:
        self.cache.reset(session_id)

    def evict(self, session_id: str) -> None:
        """Disconnect: free the session's device row and any slab row, and
        release its live-loop epsilon and partial block (MultiDeviceServer
        has the same surface)."""
        self.cache.evict(session_id)
        if self.eps_assigner is not None:
            self.eps_assigner.forget(session_id)
        if self.tap is not None:
            self.tap.observe_evict(session_id)

    def _run_batch(self, batch: List[ServeRequest]) -> None:
        # the batch joins the in-flight set before any work: a crash past
        # this line reaches _serve_recover, which fails these futures
        with self._state_lock:
            self._inflight = self._inflight + list(batch)
        if self.cfg.serve_pipeline and self._complete_worker is not None:
            # at most 2 batches between stage and complete; bounded waits, so
            # a wedged completion worker cannot pin this thread at shutdown
            while not self._depth_sem.acquire(timeout=0.25):
                if self.supervisor is not None and self.supervisor.stop.is_set():
                    raise RuntimeError("server stopping; batch not staged")
            try:
                rec = self._stage_and_dispatch(batch)
            except BaseException:
                self._depth_sem.release()
                raise
            self._complete_q.put(rec)
        else:
            self._complete(self._stage_and_dispatch(batch))

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device, non_blocking=True)

    def _stage_and_dispatch(self, batch: List[ServeRequest]) -> _PipelineRecord:
        """STAGE + DISPATCH, on the serve thread: assemble the batch into the
        staging buffers (the exploration draws in arrival order, the stream
        the serial path draws), run the step, and start the read-back of q
        and the actions. Nothing here waits for the device; _complete
        does."""
        # one read of the publish cell: the whole batch, and its results'
        # provenance, come from one parameter set in one format
        params, ckpt_step, version, arm = self._published
        n = len(batch)
        bucket = self.batcher.bucket_for(n)
        slots, fresh = self.cache.assign([r.session_id for r in batch])
        obs_rows = [r.obs for r in batch]
        target = tuple(self.cfg.obs_shape)
        if any(o.shape != target for o in obs_rows):
            obs_rows = [_pad_obs(o, target) for o in obs_rows]
        staged = self._staging.stage(batch, bucket, obs_rows, self.serve_cfg.epsilon)
        # a row starts from the zero state when the client asked for a reset
        # or the cache admitted it fresh; pad rows were staged as resets
        staged.reset_mask[:n] |= fresh
        staged.slots[:n] = slots
        staged.slots[n:] = self.cache.pad_slot
        # per-row exploration: a request's override, else the session's
        # live-loop epsilon, else ServeConfig.epsilon; the coin and
        # random-action draws happen iff any row explores, in the JAX
        # package's order and count (the assigner draws in arrival order)
        assigner = self.eps_assigner
        if assigner is not None:
            staged.eps[:n] = [r.epsilon if r.epsilon is not None
                              else assigner.epsilon_for(r.session_id) for r in batch]
        elif any(r.epsilon is not None for r in batch):
            staged.eps[:n] = [self.serve_cfg.epsilon if r.epsilon is None else r.epsilon
                              for r in batch]
        if float(staged.eps.max()) > 0.0:
            staged.explore[:] = self._rng.random(bucket) < staged.eps
            if staged.task is not None and self._task_dims is not None:
                # a drawn action stays legal for the row's task
                staged.randoms[:] = self._rng.integers(0, self._task_dims[staged.task])
            else:
                staged.randoms[:] = self._rng.integers(0, self.cfg.action_dim, bucket)
        task = None if staged.task is None else self._to_device(staged.task)
        slots_dev = self._to_device(staged.slots, torch.long)
        q, action = self._step(
            params, arm, bucket, self._to_device(staged.obs), self._to_device(staged.rewards),
            slots_dev, self._to_device(staged.reset_mask),
            self._to_device(staged.explore), self._to_device(staged.randoms, torch.int32),
            task)
        tap = self.tap
        tap_rows = None
        if tap is not None:
            # the batch's new carries, gathered now: the step wrote them in
            # place, and the next batch's step writes the cache again (the
            # stream orders this gather between the two)
            h_store, c_store, _, _ = self.cache.arrays()
            tap_rows = tap.gather_rows(h_store, c_store, slots_dev[:n])
        # the read-back into this staging set's own host buffers (pinned on
        # the card, with an event after it: _complete waits on the event,
        # nothing else); the set is staged again only after this record
        # completes
        pin = self.device.type == "cuda"
        q_host = _host_buffer(staged, "q", q.shape, q.dtype, pin)
        action_host = _host_buffer(staged, "action", action.shape, action.dtype, pin)
        q_host.copy_(q, non_blocking=pin)
        action_host.copy_(action, non_blocking=pin)
        if tap_rows is not None:
            shape = (bucket, tap_rows[0].shape[1])
            tap_rows = tuple(
                _host_buffer(staged, name, shape, torch.float32, pin)[:n].copy_(
                    rows, non_blocking=pin)
                for name, rows in (("tap_h", tap_rows[0]), ("tap_c", tap_rows[1])))
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
        return _PipelineRecord(batch=batch, n=n, bucket=bucket, ckpt_step=ckpt_step,
                               version=version, arm=arm, q=q, action=action, q_host=q_host,
                               action_host=action_host, event=event, staged=staged, tap=tap,
                               tap_rows=tap_rows)

    def _complete(self, rec: _PipelineRecord) -> None:
        """COMPLETE: wait for the batch's read-back (the only wait on the
        device in the serve path), resolve its futures, retire it from the
        in-flight set, log its metrics. On the completion worker when
        pipelined, inline on the serve thread when serial; in dispatch
        order either way."""
        if rec.event is not None:
            rec.event.synchronize()
        # copies: the staging set's buffers are written again two batches on
        q_np, act_np = rec.q_host.numpy().copy(), rec.action_host.numpy().copy()
        t_done = time.monotonic()
        for i, r in enumerate(rec.batch):
            # _serve_recover may have failed these futures already
            if not r.future.done():
                r.future.set_result(ServeResult(int(act_np[i]), q_np[i], rec.ckpt_step,
                                                rec.version, bucket=rec.bucket, row=i))
        with self._state_lock:
            done = set(map(id, rec.batch))
            self._inflight = [r for r in self._inflight if id(r) not in done]
            self.completed_batches += 1
        n = rec.n
        if rec.tap is not None:
            # the live loop's capture, after the clients have their answers:
            # copies of the staging rows and the carry rows (their buffers
            # are staged again once this record retires)
            staged = rec.staged
            h_rows, c_rows = (t.numpy().copy() for t in rec.tap_rows)
            rec.tap.observe_batch(
                [r.session_id for r in rec.batch], staged.obs[:n].copy(), act_np[:n],
                q_np[:n], staged.rewards[:n].copy(), staged.reset_mask[:n].copy(),
                staged.eps[:n].copy(), rec.ckpt_step, rec.version, None, None,
                staged.slots[:n].copy(), rows=(h_rows, c_rows))
        if self.degrade is not None or self._latency_sinks:
            # the ladder's latency window and any other sinks: each answered
            # request's queue-to-answer latency, as its client saw it
            for r in rec.batch:
                lat = t_done - r.t_enqueue
                if self.degrade is not None:
                    self.degrade.observe(lat)
                for sink in self._latency_sinks:
                    sink.observe(lat)
        if self.metrics is not None:
            self._log_serve_metrics(rec, t_done)

    def _log_serve_metrics(self, rec: _PipelineRecord, t_done: float) -> None:
        """cfg.serve_log_interval=0.0 logs every batch; a positive interval
        logs on that cadence plus the first batch of every params version
        and arm, and counts the batches it skips."""
        interval = self.cfg.serve_log_interval
        with self._state_lock:
            force = (rec.arm != self._metrics_last_arm
                     or rec.version != self._metrics_last_version)
            due = interval <= 0.0 or (t_done - self._metrics_last_t) >= interval
            if not (due or force):
                self.metrics_skipped += 1
                return
            self._metrics_last_t = t_done
            self._metrics_last_arm = rec.arm
            self._metrics_last_version = rec.version
            completed, skipped = self.completed_batches, self.metrics_skipped
        self.metrics.log({
            "plane": "serve",
            "batch_occupancy": rec.n,
            "bucket": rec.bucket,
            "queue_depth": self.batcher.qsize(),
            "latency_s_oldest": t_done - rec.batch[0].t_enqueue,
            "ckpt_step": rec.ckpt_step,
            "params_version": rec.version,
            "serve_arm": rec.arm,
            "reloads": self.reloads,
            "trace_count": self.trace_count,
            "completed_batches": completed,
            "metrics_skipped": skipped,
            **self.cache.stats(),
        })

    def _fail_record(self, rec: _PipelineRecord) -> None:
        """Retire a record whose completion raised: its unresolved futures
        fail so the clients retry (the carries were written at dispatch)."""
        with self._state_lock:
            dead = set(map(id, rec.batch))
            self._inflight = [r for r in self._inflight if id(r) not in dead]
        for r in rec.batch:
            if not r.future.done():
                r.future.set_exception(RuntimeError("serve completion failed; retry the request"))

    def _complete_iteration(self) -> None:
        """The serve-complete worker's body: one dispatched batch, with a
        bounded wait; the depth slot is given back whatever happens."""
        try:
            rec = self._complete_q.get(timeout=0.25)
        except queue.Empty:
            return
        try:
            self._complete(rec)
        except BaseException:
            self._fail_record(rec)
            raise
        finally:
            self._depth_sem.release()

    def _serve_iteration(self) -> None:
        # "stall:S" wedges this serve loop; "error" drills its restart
        fault_point("serve.replica_stall")
        batch = self.batcher.next_batch(timeout=0.25)
        if batch:
            self._run_batch(batch)

    def _degrade_iteration(self) -> None:
        """The degrade-controller worker's body: one evaluation tick, then
        the cadence's wait on the stop event."""
        self.degrade.evaluate_once()
        if self.supervisor is not None:
            self.supervisor.stop.wait(self.degrade.cfg.eval_interval_s)
        else:
            time.sleep(self.degrade.cfg.eval_interval_s)

    def _serve_recover(self) -> None:
        """Restart hook: fail the in-flight futures so no client waits
        forever. The cache needs no repair: a batch writes its rows only
        after its step, so each session is at its last written state and a
        retry runs on from there."""
        with self._state_lock:
            inflight, self._inflight = self._inflight, []
        for r in inflight:
            if not r.future.done():
                r.future.set_exception(RuntimeError("serve iteration failed; retry the request"))

    # ----------------------------------------------------------- hot reload

    def _watch_iteration(self) -> None:
        try:
            self.reload_now()
        except (OSError, InjectedFault):
            # the step vanished between listing and restore, or the
            # directory is briefly unreachable: count it, back off
            with self._state_lock:
                self.reload_errors += 1
            wait = self._watch_backoff.fail()
        else:
            self._watch_backoff.reset()
            wait = self.serve_cfg.poll_interval_s
        if self.supervisor is not None:
            self.supervisor.stop.wait(wait)
        else:
            time.sleep(wait)

    def reload_now(self) -> bool:
        """One reload check (the watcher's body; also for callers without a
        watcher). -> whether new parameters were published."""
        fault_point("serve.reload")
        step = latest_checkpoint_step(self.checkpoint_dir)
        if step is None or step == self._published[1]:
            return False
        state, _, _ = restore_checkpoint(self.checkpoint_dir, self._template, step,
                                         map_location=self.device)
        self.publish(state.net.state_dict(), int(state.step))
        with self._state_lock:
            self.reloads += 1
        return True

    # ------------------------------------------------------------ lifecycle

    def warmup(self) -> None:
        """Run every bucket's step once on a pad-only batch (writes touch
        only the scratch row), with the staging buffers allocated, so live
        traffic meets no first-call cost and adds no step shape. With a
        ladder, the bf16 and int8 arms run too (from prepared copies; the
        publish cell does not move): an arm switch fires under overload,
        where a first call's cost hurts most."""
        self._staging.warm(self.cfg.obs_shape, np.uint8)
        params, _, _, arm = self._published
        warm = [(arm, params)]
        if self.degrade is not None:
            for rung_arm in ("bf16", "int8"):
                if rung_arm != arm:
                    warm.append((rung_arm, self.prepare_for_publish(self._params_raw,
                                                                    rung_arm)[0]))
        dev = self.device
        for (warm_arm, warm_params), bucket in itertools.product(warm, self.batcher.buckets):
            task = (torch.zeros(bucket, dtype=torch.int32, device=dev)
                    if self.cfg.num_tasks > 1 else None)
            q, _ = self._step(
                warm_params, warm_arm, bucket,
                torch.zeros((bucket, *self.cfg.obs_shape), dtype=torch.uint8, device=dev),
                torch.zeros(bucket, device=dev),
                torch.full((bucket,), self.cache.pad_slot, dtype=torch.long, device=dev),
                torch.ones(bucket, dtype=torch.bool, device=dev),
                torch.zeros(bucket, dtype=torch.bool, device=dev),
                torch.zeros(bucket, dtype=torch.int32, device=dev), task)
            q.cpu()

    def start(self, watch_checkpoints: Optional[bool] = None) -> None:
        if self.supervisor is not None:
            raise RuntimeError("server already started")
        if watch_checkpoints is None:
            watch_checkpoints = self.checkpoint_dir is not None
        self.supervisor = Supervisor()
        suffix = f"-{self.name}" if self.name else ""
        if self.cfg.serve_pipeline:
            # before the serve loop, so its first batch is pipelined
            self._complete_worker = self.supervisor.spawn(
                "serve-complete" + suffix, lambda: self._complete_iteration(),
                max_restarts=self.serve_cfg.max_restarts)
        # lambdas, so tests can patch _serve_iteration on the live worker
        self._serve_worker = self.supervisor.spawn(
            "serve-loop" + suffix, lambda: self._serve_iteration(),
            max_restarts=self.serve_cfg.max_restarts, on_restart=self._serve_recover)
        if watch_checkpoints:
            self._watch_worker = self.supervisor.spawn(
                "ckpt-watcher" + suffix, lambda: self._watch_iteration(),
                max_restarts=self.serve_cfg.max_restarts)
        if self.degrade is not None and self.degrade.server is self:
            # a fleet's replicas share its controller and run no worker
            self.supervisor.spawn(
                "degrade-controller" + suffix, lambda: self._degrade_iteration(),
                max_restarts=self.serve_cfg.max_restarts)

    def check(self) -> Dict[str, int]:
        """The supervisor's restart and stall counters; raises
        WorkerFatalError when a worker is out of restarts."""
        if self.supervisor is None:
            return {"worker_restarts": 0, "worker_stalls": 0}
        return self.supervisor.check()

    def stop(self, timeout: float = 5.0) -> None:
        if self.supervisor is not None:
            self.supervisor.shutdown(timeout)
            self.supervisor = None
        self._complete_worker = None
        # dispatched batches the completion worker did not reach are
        # completed here: their steps ran, their clients get answers
        while True:
            try:
                rec = self._complete_q.get_nowait()
            except queue.Empty:
                break
            try:
                self._complete(rec)
            except Exception:
                self._fail_record(rec)
            finally:
                self._depth_sem.release()
        for r in self.batcher.drain():
            if not r.future.done():
                r.future.set_exception(RuntimeError("server stopped"))
        self._serve_recover()

    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "reloads": self.reloads,
            "reload_errors": self.reload_errors,
            "io_retries": total_retries(),
            "trace_count": self.trace_count,
            "ckpt_step": self._published[1],
            "params_version": self._published[2],
            "serve_arm": self._published[3],
            "arm_switches": self.arm_switches,
            "serve_quantization": self.cfg.serve_quantization,
            "quantized_leaves": self.quantized_leaves,
            "completed_batches": self.completed_batches,
            "metrics_skipped": self.metrics_skipped,
            "inflight_depth": len(self._inflight),
        }
        out.update(self.batcher.stats())
        out.update(self.cache.stats())
        if self.eps_assigner is not None:
            out.update(self.eps_assigner.stats())
        if self.tap is not None:
            out.update(self.tap.stats())
        if self.degrade is not None and self.degrade.server is self:
            out.update(self.degrade.stats())
        return out
