"""Training orchestrator and CLI (port of r2d2_tpu/train.py, inline mode).

The main path: catch env -> VectorizedActor (acting through the fused
ε-greedy act tail) -> SequenceAccumulator -> host ReplayBuffer with
sum-tree PER -> the learner step, in strict
actor/learner alternation (`Trainer.run_inline`). Cadences: publish
weights every `publish_interval` updates, actor pull every
`actor_update_interval` env steps, target sync every
`target_net_update_interval` updates (inside the step), stop at
`training_steps`, sampling gated on `learning_starts`.

Threaded mode, checkpoints, metrics files and evaluation are queued (M6).

    python -m r2d2_tpu_torch.train --preset atari --env catch --mode inline \
        --steps 100

trains the atari preset in its own bfloat16 compute (``--set
compute_dtype=float32`` for the reference's float32 numerics; ``--set
precision=bf16`` also stores the replayed carries in bfloat16).

Every backward arm of the JAX package runs: ``--set backward_arm=fused_dwh``
or ``--set backward_arm=ckpt`` forces one, ``--set fused_sequence=false``
trains through the seamless backward, and ``--model-preset xl`` (hidden
2048) resolves to the checkpointed arm under the default residual budget.

runs on the CUDA device; ``--device cpu`` runs the plain versions of the
kernels on the CPU instead.
"""

from __future__ import annotations

import argparse
import copy
import json
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
    require_ported,
    resolve_device,
)
from r2d2_tpu_torch.envs import make_env
from r2d2_tpu_torch.envs.catch import CatchVecEnv, catch_params, is_catch_name
from r2d2_tpu_torch.learner import DeviceBatch, init_train_state, make_train_step
from r2d2_tpu_torch.ops.epsilon import epsilon_ladder
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer


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
    def __init__(self, cfg: R2D2Config, vec_env=None, device="cuda"):
        self.device = resolve_device(device)
        self.vec_env = vec_env if vec_env is not None else build_vec_env(cfg, seed=cfg.seed)
        if self.vec_env.action_dim != cfg.action_dim:
            cfg = cfg.replace(action_dim=self.vec_env.action_dim)
        require_ported(cfg, self.device)
        self.cfg = cfg
        self.backward_arm = cfg.resolve_backward_arm(device=self.device.type)
        self.net, self.state = init_train_state(cfg, self.device)
        self._step = self.state.step
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
        self.last_metrics: Optional[dict] = None
        # host clock around each learner update; an update ends in the
        # device -> host copy of its priorities, so it includes device time
        self.update_seconds: List[float] = []

    def sample(self):
        """One batch, copied out of the store at sample time, on the device."""
        b = self.replay.sample_batch(self.sample_rng)
        return DeviceBatch.from_sampled(b, self.device), b.idxes, (b.old_ptr, b.old_advances)

    def _one_update(self, item):
        dev, idxes, (old_ptr, old_adv) = item
        prev = self._step
        self.state, m, priorities = self.step_fn(self.state, dev)
        self.replay.update_priorities(idxes, priorities.cpu().numpy(), old_ptr, old_adv)
        self._step += 1
        if self._step // self.cfg.publish_interval > prev // self.cfg.publish_interval:
            self.param_store.publish(self.state.net)
        return m

    def warmup(self, max_steps: Optional[int] = None) -> None:
        """Collect until sampling opens (replay holds learning_starts).
        Raises once twice the ring's capacity has been recorded without
        sampling opening: learning_starts is then out of the ring's reach."""
        steps = 0
        inserted0 = self.replay.env_steps
        saturation = 2 * self.cfg.buffer_capacity + self.cfg.learning_starts
        while not self.replay.can_sample():
            self.actor.step()
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
        k = env_steps_per_update or max(cfg.num_actors, 1)
        self.warmup()
        while self._step < cfg.training_steps:
            for _ in range(max(k // self.actor.steps_per_call, 1)):
                self.actor.step()
            item = self.sample()
            t0 = time.perf_counter()
            m = self._one_update(item)
            self.update_seconds.append(time.perf_counter() - t0)
            self.last_metrics = m

    def metrics(self) -> dict:
        """The last update's metrics as host floats, plus run counters."""
        m = {k: float(v) for k, v in (self.last_metrics or {}).items()}
        episodes, reward_sum = self.replay.episode_totals()
        return {
            "step": self._step,
            "env_steps": self.replay.env_steps,
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
    p.add_argument("--mode", default="inline", choices=["inline"],
                   help="inline: strict actor/learner alternation (threaded mode is queued, M6)")
    p.add_argument("--model-preset", default=None,
                   help="named model-size preset (config.MODEL_PRESETS: wide/xl "
                        "widen the LSTM, deep/deep_wide add encoder layers) applied "
                        "over the run preset; --set still wins on single fields")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field (repeatable)")
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
    overrides.update(parse_overrides(args.set))
    if overrides:
        cfg = cfg.replace(**overrides)

    trainer = Trainer(cfg, device=device)
    t0 = time.perf_counter()
    trainer.run_inline()
    if device.type == "cuda":
        torch.cuda.synchronize()
    out = trainer.metrics()
    out["seconds"] = time.perf_counter() - t0
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
