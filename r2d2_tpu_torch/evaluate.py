"""Offline evaluation (port of the host half of r2d2_tpu/evaluate.py).

Walks the checkpoint series, runs near-greedy episodes per checkpoint
(epsilon = cfg.test_epsilon = 0.001) on a vectorized env, and emits the
learning curve as jsonl: mean reward against env frames (env_steps x 4)
and against wall-clock hours. The device-side evaluator of the JAX package
(``evaluate_params_device``, ``make_eval_collect_fn``) runs on its
functional envs and is queued with them (M11).

    python -m r2d2_tpu_torch.evaluate --preset tiny_test --env catch \\
        --set checkpoint_dir=runs/ckpt --out runs/eval.jsonl --plot runs/eval.png

runs on the CUDA device; ``--device cpu`` evaluates on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import PRESETS, R2D2Config, parse_overrides, resolve_device
from r2d2_tpu_torch.learner import init_train_state
from r2d2_tpu_torch.models.r2d2 import initial_carry
from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps, restore_checkpoint


def make_policy(net):
    """The acting forward of `net` (its parameters as they are at each
    call), without gradients: (obs, last_action, last_reward, carry) ->
    (q, carry)."""

    @torch.no_grad()
    def policy(obs, last_action, last_reward, carry):
        return net.act(obs, last_action, last_reward, carry)

    return policy


def evaluate_params(
    cfg: R2D2Config,
    net,
    vec_env,
    seed: int = 0,
    max_steps: Optional[int] = None,
    policy=None,
    episodes_per_slot: int = 1,
) -> float:
    """Mean episodic reward of `net` (its current parameters, on its
    device) over `episodes_per_slot` episodes per env slot. Slots whose
    episode ends roll straight into the next one via the vec env's
    auto-reset; the recurrent state, last action and last reward are
    re-zeroed per slot at each episode boundary, as at training episode
    starts.

    max_steps is a PER-EPISODE budget: the loop runs at most max_steps *
    episodes_per_slot env steps. If the budget expires, a slot that has
    completed no episode contributes its partial return once; slots with a
    finished episode contribute only their finished returns."""
    E = vec_env.num_envs
    dev = next(net.parameters()).device
    rng = np.random.default_rng(seed)
    if policy is None:
        policy = make_policy(net)

    obs = vec_env.reset_all()
    last_action = np.zeros(E, np.int32)
    last_reward = np.zeros(E, np.float32)
    carry = initial_carry(E, cfg.hidden_dim, dev, cfg.carry_dtype)
    cur_reward = np.zeros(E)
    completed = np.zeros(E, np.int64)
    finished_returns: list = []
    steps = 0
    max_steps = (max_steps or cfg.max_episode_steps) * episodes_per_slot

    while (completed < episodes_per_slot).any() and steps < max_steps:
        q, carry = policy(torch.from_numpy(np.asarray(obs)).to(dev),
                          torch.from_numpy(last_action).to(dev),
                          torch.from_numpy(last_reward).to(dev), carry)
        greedy = q.cpu().numpy().argmax(1)
        explore = rng.random(E) < cfg.test_epsilon
        actions = np.where(explore, rng.integers(0, cfg.action_dim, E), greedy).astype(np.int32)
        term_obs, rewards, dones, next_obs = vec_env.step(actions)
        active = completed < episodes_per_slot
        cur_reward += np.where(active, rewards, 0.0)
        for i in np.nonzero(dones & active)[0]:
            finished_returns.append(cur_reward[i])
            completed[i] += 1
            cur_reward[i] = 0.0
        # episode boundary: the fresh episode's obs, zero recurrent state,
        # NOOP last action and zero last reward
        obs = next_obs
        keep = torch.from_numpy(~np.asarray(dones, bool)).to(dev)[:, None]
        carry = tuple(torch.where(keep, c, torch.zeros_like(c)) for c in carry)
        last_action = np.where(dones, 0, actions).astype(np.int32)
        last_reward = np.where(dones, 0.0, rewards).astype(np.float32)
        steps += 1
    for i in np.nonzero(completed == 0)[0]:
        finished_returns.append(cur_reward[i])
    return float(np.mean(finished_returns))


def evaluate_series(
    cfg: R2D2Config,
    vec_env,
    out_path: Optional[str] = None,
    seed: int = 0,
    episodes_per_slot: int = 1,
    device="cuda",
):
    """Evaluate every finalized checkpoint under cfg.checkpoint_dir, in
    step order, on the host vec env: one row per checkpoint with step,
    env_steps, env_frames (env_steps x 4, the frameskip), hours,
    mean_reward, the episodes behind the mean and the evaluator that
    produced it ("host": completed episodes only). Rows are printed as
    jsonl and written to `out_path` when there are any."""
    dev = resolve_device(device)
    net, template = init_train_state(cfg, dev)
    policy = make_policy(net)
    rows = []
    for step in list_checkpoint_steps(cfg.checkpoint_dir):
        _, env_steps, wall_minutes = restore_checkpoint(cfg.checkpoint_dir, template, step,
                                                        map_location=dev)
        reward = evaluate_params(cfg, net, vec_env, seed=seed, policy=policy,
                                 episodes_per_slot=episodes_per_slot)
        row = {
            "step": step,
            "env_steps": env_steps,
            "env_frames": env_steps * 4,
            "hours": wall_minutes / 60.0,
            "mean_reward": reward,
            "episodes": episodes_per_slot * vec_env.num_envs,
            "evaluator": "host",
        }
        rows.append(row)
        print(json.dumps(row))
    if out_path and rows:
        # no rows -> out_path untouched: an evaluation of a run whose
        # checkpoints are gone must not truncate earlier results
        with open(out_path, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    elif out_path and os.path.exists(out_path):
        print(f"WARNING: no checkpoints evaluated; {out_path} left untouched: its "
              "contents are from an earlier evaluation", file=sys.stderr)
    return rows


def plot_series(rows, out_path: str) -> str:
    """The two learning-curve panels, mean reward against env frames and
    against wall-clock hours, saved as one image (format from the
    extension). Needs matplotlib, imported here only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    reward = [r["mean_reward"] for r in rows]
    ax1.plot([r["env_frames"] for r in rows], reward, marker="o")
    ax1.set_xlabel("environment frames")
    ax1.set_ylabel("mean episode reward")
    ax2.plot([r["hours"] for r in rows], reward, marker="o")
    ax2.set_xlabel("training time (hours)")
    ax2.set_ylabel("mean episode reward")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    from r2d2_tpu_torch.train import build_vec_env

    p = argparse.ArgumentParser(description="r2d2_tpu_torch checkpoint-series evaluator")
    p.add_argument("--preset", default="atari", choices=sorted(PRESETS))
    p.add_argument("--env", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--plot", default=None,
                   help="save the two-panel learning curve (reward vs frames / vs hours) "
                        "to this image path")
    p.add_argument("--episodes", type=int, default=1,
                   help="completed episodes per env slot per checkpoint")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field (repeatable; must match the "
                        "training run, e.g. --set checkpoint_dir=runs/x/ckpt)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    cfg = PRESETS[args.preset]()
    if args.env:
        cfg = cfg.replace(env_name=args.env)
    if args.set:
        cfg = cfg.replace(**parse_overrides(args.set))
    vec_env = build_vec_env(cfg, seed=123)
    cfg = cfg.replace(action_dim=vec_env.action_dim)
    rows = evaluate_series(cfg, vec_env, out_path=args.out, episodes_per_slot=args.episodes,
                           device=args.device)
    if args.plot and rows:
        plot_series(rows, args.plot)


if __name__ == "__main__":
    main()
