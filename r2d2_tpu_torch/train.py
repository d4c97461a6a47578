"""Training orchestrator and CLI (port of r2d2_tpu/train.py, host plane).

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
(``utils/profiling.py``; the spans ``replay/sample`` and
``learner_update``).

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

runs on the CUDA device; ``--device cpu`` runs the plain versions of the
kernels on the CPU instead.
"""

from __future__ import annotations

import argparse
import copy
import json
import queue
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.actor import HostEnvPool, ParamStore, VectorizedActor
from r2d2_tpu_torch.config import (
    PRESETS,
    R2D2Config,
    apply_model_preset,
    parse_overrides,
    resolve_device,
)
from r2d2_tpu_torch.envs import make_env
from r2d2_tpu_torch.envs.catch import CatchVecEnv, catch_params, is_catch_name
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    PinnedStager,
    init_train_state,
    make_train_step,
)
from r2d2_tpu_torch.ops.epsilon import epsilon_ladder
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.utils.checkpoint import (
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)
from r2d2_tpu_torch.utils.metrics import MetricsLogger
from r2d2_tpu_torch.utils.profiling import (
    TransferTimer,
    span,
    start_trace,
    step_span,
    stop_trace,
)
from r2d2_tpu_torch.utils.supervision import Supervisor, WorkerStalledError

# threaded mode's batch queue, and the pinned slots beyond it: the
# sampler's pending batch and the one whose copy is being issued
QUEUE_DEPTH = 8
_STAGING_SLOTS = QUEUE_DEPTH + 2


def build_vec_env(cfg: R2D2Config, seed: int = 0):
    """One vectorized env spanning cfg.num_actors slots."""
    name = cfg.env_name.lower()
    if is_catch_name(name):
        return CatchVecEnv(
            num_envs=cfg.num_actors, height=cfg.obs_shape[0], width=cfg.obs_shape[1],
            seed=seed, **catch_params(name),
        )
    return HostEnvPool([make_env(cfg, seed=seed + i) for i in range(cfg.num_actors)])


class Trainer:
    def __init__(self, cfg: R2D2Config, vec_env=None, device="cuda", resume: bool = False,
                 metrics: Optional[MetricsLogger] = None, profile_dir: Optional[str] = None,
                 profile_steps: int = 20):
        self.device = resolve_device(device)
        self.vec_env = vec_env if vec_env is not None else build_vec_env(cfg, seed=cfg.seed)
        if self.vec_env.action_dim != cfg.action_dim:
            cfg = cfg.replace(action_dim=self.vec_env.action_dim)
        self.cfg = cfg
        # trace the `profile_steps` updates after the first (the first builds
        # the kernels)
        self.profile_dir = profile_dir
        self._profile_remaining = profile_steps if profile_dir else 0
        self._prof = None
        self.backward_arm = cfg.resolve_backward_arm(device=self.device.type)
        self.net, self.state = init_train_state(cfg, self.device)
        self.env_steps_offset = 0
        self.wall_minutes_offset = 0.0
        self.resumed = False
        if resume and latest_checkpoint_step(cfg.checkpoint_dir) is not None:
            self.state, self.env_steps_offset, self.wall_minutes_offset = restore_checkpoint(
                cfg.checkpoint_dir, self.state, map_location=self.device)
            self.resumed = True
        self._initial_step = self._step = self.state.step
        self.sample_rng = np.random.default_rng(cfg.seed + 2)
        # host numpy replay; each update ships its batch host -> device
        self.replay = ReplayBuffer(cfg)
        self.step_fn = make_train_step(cfg)
        self.param_store = ParamStore(self.state.net)
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
        self.metrics_logger = metrics or MetricsLogger(cfg.metrics_path, cfg.log_interval)
        # the latest un-emitted (metrics, step, extra); see _log
        self._pending_log = None
        self._last_log_emit = 0.0
        self.xfer = TransferTimer()
        self._stager: Optional[PinnedStager] = None
        self._sup: Optional[Supervisor] = None
        self.last_metrics: Optional[dict] = None
        # host clock around each learner update, and at its end (for rates
        # over the wall); an update ends in the device -> host copy of its
        # priorities, so it includes device time
        self.update_seconds: List[float] = []
        self.update_ends: List[float] = []
        self.reset_clock()

    # ------------------------------------------------------------- updates

    def sample(self):
        """One batch, copied out of the store at sample time, on the device
        (from pageable host memory)."""
        with span("replay/sample"):
            b = self.replay.sample_batch(self.sample_rng)
            dev = DeviceBatch.from_sampled(b, self.device)
        return dev, None, b.idxes, (b.old_ptr, b.old_advances)

    def _sample_staged(self):
        """One batch through the pinned ring and the side stream (threaded
        mode on the card); the learner waits for its copy's event."""
        with span("replay/sample"):
            b = self.replay.sample_batch(self.sample_rng)
            dev, event = self._stager.stage(b)
        return dev, event, b.idxes, (b.old_ptr, b.old_advances)

    def _one_update(self, item):
        dev, event, idxes, (old_ptr, old_adv) = item
        self._profile_gate()
        prev = self._step
        t0 = time.perf_counter()
        with step_span("learner_update", prev):
            if event is not None:
                with self.xfer.wait():
                    dev = PinnedStager.consume(dev, event)
            self.state, m, priorities = self.step_fn(self.state, dev)
            self.replay.update_priorities(idxes, priorities.cpu().numpy(), old_ptr, old_adv)
        t1 = time.perf_counter()
        self.update_seconds.append(t1 - t0)
        self.update_ends.append(t1)
        self._step += 1
        self.last_metrics = m
        self._profile_tick()
        self._cadences(prev, self._step)
        return m, self._step

    def _cadences(self, prev: int, step: int) -> None:
        """Publish and checkpoint on interval CROSSINGS."""
        cfg = self.cfg
        if step // cfg.publish_interval > prev // cfg.publish_interval:
            self.param_store.publish(self.state.net)
        if step // cfg.save_interval > prev // cfg.save_interval:
            save_checkpoint(cfg.checkpoint_dir, self.state, self.env_steps,
                            self.wall_minutes_offset + (time.time() - self._start_time) / 60.0)

    @property
    def env_steps(self) -> int:
        """Run-total env steps: this run's and the resumed checkpoint's."""
        return self.replay.env_steps + self.env_steps_offset

    def finish_updates(self) -> None:
        """Emit the deferred metrics record; every loop that drives updates
        calls this once when it stops."""
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

    def _profile_tick(self) -> None:
        if self._prof is not None:
            self._profile_remaining -= 1
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
        sampling opening: learning_starts is then out of the ring's reach."""
        steps = 0
        inserted0 = self.replay.env_steps
        saturation = 2 * self.cfg.buffer_capacity + self.cfg.learning_starts
        while not self.replay.can_sample():
            self.actor.step()
            if beat is not None:
                beat()
            steps += self.actor.steps_per_call
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError("warmup exceeded max_steps without filling replay")
            if self.replay.env_steps - inserted0 >= saturation:
                raise RuntimeError(
                    f"replay saturated at {len(self.replay)} transitions, below "
                    f"learning_starts={self.cfg.learning_starts}: lower "
                    "learning_starts or grow buffer_capacity"
                )

    def run_inline(self, env_steps_per_update: Optional[int] = None) -> None:
        """Strict alternation: k env steps, one update."""
        cfg = self.cfg
        self.reset_clock()
        k = env_steps_per_update or max(cfg.num_actors, 1)
        # one thread: the main-thread watchdog is the only stall protection
        sup = self._sup = self._make_supervisor()
        with sup.armed_watchdog():
            self.warmup(beat=sup.main_beat)
            try:
                while self._step < cfg.training_steps:
                    sup.main_beat()
                    for _ in range(max(k // self.actor.steps_per_call, 1)):
                        self.actor.step()
                    m, step = self._one_update(self.sample())
                    self._log(m, step)
            finally:
                sup.stop.set()  # the drain below is not a stall
                self._stop_profile()
                self.finish_updates()

    def run_threaded(self) -> None:
        """Actor thread + sampler thread + learner loop, the workers under a
        Supervisor: a crashed actor or sampler iteration is restarted (the
        actor through VectorizedActor.resync) with its traceback recorded,
        and a worker that stays dead or stalls fails the run."""
        self.reset_clock()
        batch_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        sup = self._sup = self._make_supervisor()
        with sup.armed_watchdog():
            self._run_threaded_body(sup, batch_q)

    def _run_threaded_body(self, sup: Supervisor, batch_q: "queue.Queue") -> None:
        cfg = self.cfg
        self.warmup(beat=sup.main_beat)
        staged = self.device.type == "cuda"
        if staged and self._stager is None:
            self._stager = PinnedStager(self.device, _STAGING_SLOTS, self.xfer)
        sample = self._sample_staged if staged else self.sample

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
            # shutdown first: it stops the watchdog and joins the workers
            sup.shutdown()
            self._stop_profile()
            self.finish_updates()

        try:
            while self._step < cfg.training_steps:
                sup.main_beat()
                try:
                    with self.xfer.wait():
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
            "backward_arm": self.backward_arm[0],
            **({"backward_arm_stride": self.backward_arm[1]}
               if self.backward_arm[0] == "ckpt" else {}),
            **m,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description="r2d2_tpu_torch trainer")
    p.add_argument("--preset", default="atari", choices=sorted(PRESETS))
    p.add_argument("--env", default=None, help="override env name (e.g. catch)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--mode", default="inline", choices=["inline", "threaded"],
                   help="inline: strict actor/learner alternation; threaded: actor and "
                        "sampler threads under a supervisor, batches staged through "
                        "pinned memory on the card")
    p.add_argument("--model-preset", default=None,
                   help="named model-size preset (config.MODEL_PRESETS: wide/xl "
                        "widen the LSTM, deep/deep_wide add encoder layers) applied "
                        "over the run preset; --set still wins on single fields")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in checkpoint_dir")
    p.add_argument("--metrics", default=None, help="jsonl metrics file (metrics_path)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field (repeatable)")
    p.add_argument("--profile-dir", default=None,
                   help="write a Chrome trace of the updates after the first here")
    p.add_argument("--profile-steps", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
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
    overrides.update(parse_overrides(args.set))
    if overrides:
        cfg = cfg.replace(**overrides)

    trainer = Trainer(cfg, device=device, resume=args.resume, profile_dir=args.profile_dir,
                      profile_steps=args.profile_steps)
    t0 = time.perf_counter()
    try:
        if args.mode == "threaded":
            trainer.run_threaded()
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
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
