"""MultiTaskTrainer — one task-conditioned learner over per-task fleets (port
of r2d2_tpu/multitask/trainer.py).

T per-task actor fleets (VectorizedActor over each task's vec env, the task
id stamped into every Block) feed T per-task host replay buffers; one train
step consumes a task-stratified batch (an equal share drawn from every
task's buffer, concatenated, the per-sequence task vector conditioning the
dueling head), and its priorities are split back to each task's sum tree.
The learner, the parameter store and the publish cadence are shared.

Stratified, not proportional, sampling: a dense-reward task fills its
buffer far faster than a sparse one, and priority-proportional sampling
across tasks would starve the slow task's gradient. Within a task,
sampling stays priority-proportional.

The seeds are the JAX package's: the sampling Generator seed + 2, task t's
envs seed + 101 (t + 1), its actor seed + 7 (t + 1), and the per-task draws
in task order.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from r2d2_tpu_torch.actor import ParamStore, VectorizedActor
from r2d2_tpu_torch.config import R2D2Config, resolve_device
from r2d2_tpu_torch.learner import DeviceBatch, init_train_state, make_train_step
from r2d2_tpu_torch.models.r2d2 import R2D2Network, initial_carry
from r2d2_tpu_torch.multitask.registry import TaskSpec, build_registry
from r2d2_tpu_torch.ops.act_tail import first_argmax
from r2d2_tpu_torch.ops.epsilon import multitask_epsilon_ladders
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer, SampledBatch
from r2d2_tpu_torch.utils.metrics import MetricsLogger

# the SampledBatch fields concatenated over the tasks' draws
_BATCH_FIELDS = ("obs", "last_action", "last_reward", "hidden", "action", "n_step_reward",
                 "gamma", "burn_in_steps", "learning_steps", "forward_steps", "is_weights",
                 "idxes")


def _split_even(total: int, parts: int) -> List[int]:
    """`total` in `parts` near-equal positive chunks, the first ones taking
    the remainder."""
    base, rem = divmod(total, parts)
    out = [base + (1 if i < rem else 0) for i in range(parts)]
    if min(out) < 1:
        raise ValueError(f"cannot split {total} into {parts} positive parts")
    return out


@torch.no_grad()
def rollout_returns(
    cfg: R2D2Config,
    net: Optional[R2D2Network],
    params,
    spec: TaskSpec,
    episodes: int = 8,
    horizon: Optional[int] = None,
    seed: int = 0,
    policy: str = "greedy",
    device="cuda",
) -> np.ndarray:
    """(episodes,) first-episode returns of `policy` on one task.
    "greedy": the task-conditioned argmax of `net` with the parameters
    `params` (a state_dict; the mask keeps it in the native range);
    "random": uniform over the task's native actions, no net. A slot stops
    scoring at its first terminal; a continuing env (drift) scores the
    whole horizon."""
    from r2d2_tpu_torch.train import build_vec_env

    dev = resolve_device(device)
    E = episodes
    H = int(horizon or cfg.max_episode_steps)
    env = build_vec_env(cfg.replace(env_name=spec.env_name, num_actors=E), seed=seed,
                        device=dev)
    rng = np.random.default_rng(seed)
    obs = np.array(env.reset_all())
    la = np.zeros(E, np.int32)
    lr = np.zeros(E, np.float32)
    carry = initial_carry(E, cfg.hidden_dim, dev, cfg.carry_dtype)
    task = torch.full((E,), spec.task_id, dtype=torch.int32, device=dev) \
        if cfg.num_tasks > 1 else None
    if policy == "greedy":
        net = copy.deepcopy(net).to(dev)
        net.load_state_dict(params)
    returns = np.zeros(E, np.float64)
    alive = np.ones(E, bool)
    for _ in range(H):
        if policy == "greedy":
            q, carry = net.act(torch.from_numpy(obs).to(dev), torch.from_numpy(la).to(dev),
                               torch.from_numpy(lr).to(dev), carry, task)
            actions = first_argmax(q).cpu().numpy().astype(np.int32)
        else:
            actions = rng.integers(0, spec.action_dim, size=E).astype(np.int32)
        term_obs, rewards, dones, next_obs = env.step(actions)
        dones = np.asarray(dones, bool)
        returns += np.where(alive, np.asarray(rewards, np.float64), 0.0)
        done_now = dones & alive
        alive &= ~dones
        obs = np.where(done_now.reshape(-1, *([1] * (obs.ndim - 1))), next_obs, term_obs)
        la = np.where(alive, actions, 0).astype(np.int32)
        lr = np.where(alive, np.asarray(rewards, np.float32), 0.0).astype(np.float32)
        if not alive.any():
            break
    return returns


class MultiTaskTrainer:
    """One learner, T tasks, in inline alternation (collect, then update),
    as the Trainer's inline mode. `vec_envs` hands in one vec env per task
    (the tests give both packages the same env streams); else each task's
    is built on `device`."""

    def __init__(
        self,
        cfg: R2D2Config,
        task_names: Sequence[str],
        metrics: Optional[MetricsLogger] = None,
        device="cuda",
        vec_envs: Optional[Sequence] = None,
    ):
        from r2d2_tpu_torch.train import build_vec_env

        self.device = resolve_device(device)
        cfg, specs = build_registry(cfg, task_names)
        self.cfg = cfg
        self.specs = specs
        T = len(specs)
        bl = cfg.block_length
        self.net, self.state = init_train_state(cfg, self.device)
        self.param_store = ParamStore(self.state.net)
        self.step_fn = make_train_step(cfg)
        self.sample_rng = np.random.default_rng(cfg.seed + 2)
        self.metrics = metrics

        apt = max(1, cfg.num_actors // T)
        eps = multitask_epsilon_ladders(T, apt, cfg.base_eps, cfg.eps_alpha)
        self.batch_split = _split_even(cfg.batch_size, T)
        # each task's ring: an equal share of the capacity in whole blocks,
        # never below 4 blocks
        cap_t = max((cfg.buffer_capacity // T) // bl, 4) * bl
        ls_t = max(cfg.learning_starts // T, max(self.batch_split))

        self.replays: List[ReplayBuffer] = []
        self.actors: List[VectorizedActor] = []
        self.task_cfgs: List[R2D2Config] = []
        for spec in specs:
            t = spec.task_id
            cfg_t = cfg.replace(env_name=spec.env_name, num_actors=apt,
                                batch_size=self.batch_split[t], buffer_capacity=cap_t,
                                learning_starts=ls_t, gamma=spec.gamma)
            self.task_cfgs.append(cfg_t)
            replay = ReplayBuffer(cfg_t)
            env = (vec_envs[t] if vec_envs is not None
                   else build_vec_env(cfg_t, seed=cfg.seed + 101 * (t + 1), device=self.device))
            actor = VectorizedActor(
                cfg_t, copy.deepcopy(self.state.net), self.param_store, env, eps[t],
                replay.add_block, seed=cfg.seed + 7 * (t + 1), device=self.device, task_id=t,
                action_dim=spec.action_dim, gamma=spec.gamma)
            self.replays.append(replay)
            self.actors.append(actor)
        self._updates = 0

    # ------------------------------------------------------------- phases

    def warmup(self, max_steps_per_task: int = 1_000_000) -> None:
        """Collect task by task until every task's buffer opens its sampling
        gate: no task trains on another task's warmup."""
        for t, (actor, replay) in enumerate(zip(self.actors, self.replays)):
            steps = 0
            while not replay.can_sample():
                actor.step()
                steps += actor.steps_per_call
                if steps >= max_steps_per_task:
                    raise RuntimeError(
                        f"task {t} ({self.specs[t].env_name}) warmup exceeded "
                        f"{max_steps_per_task} steps without filling replay"
                    )

    def draw_stratified(self):
        """One equal-share draw per task, in task order, concatenated into
        one host batch with the per-sequence task vector -> (the batch, the
        per-task (count, idxes, old_ptr, old_advances) segments of the split
        write-back)."""
        parts = [r.sample_batch(self.sample_rng) for r in self.replays]
        segs = [(len(b.idxes), b.idxes, b.old_ptr, b.old_advances) for b in parts]
        cat = SampledBatch(
            **{f: np.concatenate([getattr(b, f) for b in parts]) for f in _BATCH_FIELDS},
            old_ptr=-1, env_steps=sum(b.env_steps for b in parts))
        cat.task = np.concatenate([b.task for b in parts])
        return cat, segs

    def _sample_stratified(self):
        """draw_stratified's batch on the device -> (DeviceBatch, segments)."""
        cat, segs = self.draw_stratified()
        return DeviceBatch.from_sampled(cat, self.device), segs

    def update(self) -> Dict[str, torch.Tensor]:
        """One stratified train step and its split priority write-back."""
        dev, segs = self._sample_stratified()
        self.state, m, priorities = self.step_fn(self.state, dev)
        prios = priorities.float().cpu().numpy()
        off = 0
        for replay, (n, idxes, old_ptr, old_adv) in zip(self.replays, segs):
            replay.update_priorities(idxes, prios[off:off + n], old_ptr, old_adv)
            off += n
        self._updates += 1
        if self._updates % self.cfg.publish_interval == 0:
            self.param_store.publish(self.state.net)
        return m

    def train(self, num_updates: int, collect_steps_per_update: int = 1):
        """Inline alternation: collect_steps_per_update actor steps on every
        task's fleet before each update; a metrics row every 10 updates;
        the weights published at the end."""
        last_m = None
        for _ in range(num_updates):
            for actor in self.actors:
                for _ in range(collect_steps_per_update):
                    actor.step()
            last_m = self.update()
            if self.metrics is not None and self._updates % 10 == 0:
                self.metrics.log(self._metrics_row(last_m))
        self.param_store.publish(self.state.net)
        return last_m

    # ------------------------------------------------------------ reporting

    def _metrics_row(self, m) -> dict:
        row = {"step": self._updates, "loss": float(m["loss"]), "q_mean": float(m["q_mean"])}
        for t, replay in enumerate(self.replays):
            n_ep, r_sum = replay.pop_episode_stats()
            row[f"task{t}_env_steps"] = replay.env_steps
            row[f"task{t}_episodes"] = n_ep
            row[f"task{t}_mean_return"] = (r_sum / n_ep) if n_ep else None
        return row

    def evaluate(self, episodes: int = 8, horizon: Optional[int] = None,
                 seed: int = 1234) -> List[dict]:
        """One greedy row per task (the bar is per task, never an average)."""
        params, _ = self.param_store.latest()
        rows = []
        for spec in self.specs:
            rets = rollout_returns(self.cfg, self.state.net, params, spec, episodes=episodes,
                                   horizon=horizon, seed=seed + spec.task_id,
                                   policy="greedy", device=self.device)
            rows.append({
                "task": spec.task_id,
                "env": spec.env_name,
                "episodes": episodes,
                "mean_return": float(np.mean(rets)),
                "min_return": float(np.min(rets)),
                "max_return": float(np.max(rets)),
            })
        return rows
