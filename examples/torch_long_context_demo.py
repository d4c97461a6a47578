"""Long-context demo of the PyTorch port: seq-581 stored-state burn-in, end
to end (port of examples/long_context_demo.py, the same recipe and flags).

The long_context preset (BASELINE.json config 5) trains 512-step learning
windows with a 64-step burn-in on the multi-ball slow-fall flashing-cue
catch ('memory_catch:10:8:4', 26x26, 768-step episodes), the IMPALA encoder
and the LRU core; each replay block holds two windows, so the second
replays from a stored recurrent state. The demo runs Trainer.run_fused
(collection and replay on the card, K=2), then evaluates every checkpoint
with the device evaluator. The JAX run of this default never solved its
task (runs/README.md, long_context/): it shows a stable run, not learning.

    python examples/torch_long_context_demo.py --out runs/torch_long_context --steps 12000

Artifacts as torch_catch_demo's: {out}/metrics.jsonl, eval.jsonl,
curve.jpg, checkpoints under {out}/ckpt. Runs on the card unless --device
cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def demo_config(out: str, steps: int, actors: int, batch: int, env=None):
    """The JAX demo's config (examples/long_context_demo.py:68-93)."""
    from r2d2_tpu_torch.config import long_context

    K = 2
    steps = max(steps // K, 1) * K
    cfg = long_context(env) if env else long_context()
    return cfg.replace(
        num_actors=actors,
        batch_size=batch,
        # one-card budget: 200 block slots, each episode-aligned block
        # holding up to 1024 steps
        buffer_capacity=1024 * 200,
        learning_starts=60_000,
        collector="device",
        replay_plane="device",
        updates_per_dispatch=K,
        # n-step 20: the terminal-only reward must propagate ~900 steps
        forward_steps=20,
        target_net_update_interval=250,
        samples_per_insert=30.0,
        training_steps=steps,
        save_interval=max(steps // 8, K),
        checkpoint_dir=os.path.join(out, "ckpt"),
        metrics_path=os.path.join(out, "metrics.jsonl"),
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="runs/torch_long_context")
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--actors", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--env", default=None,
                   help="catch-family env overriding the preset's memory_catch:10:8:4")
    p.add_argument("--eval-episodes", type=int, default=2,
                   help="episodes per eval slot per checkpoint (16 slots)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ablate-zero-state", action="store_true",
                   help="zero-state replay ablation (burn_in=0)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field on top of the demo config")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from torch_catch_demo import plot_curve

    from r2d2_tpu_torch.config import apply_cli_overrides
    from r2d2_tpu_torch.envs.catch import TensorCatchEnv, catch_params
    from r2d2_tpu_torch.evaluate import (
        evaluate_params_device,
        evaluate_series,
        make_eval_collect_fn,
    )
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.supervision import WorkerStalledError, exit_for_stall

    cfg = demo_config(args.out, args.steps, args.actors, args.batch, args.env)
    cfg = apply_cli_overrides(cfg, args.set, args.ablate_zero_state)
    trainer = Trainer(cfg, device=args.device, resume=args.resume)
    try:
        trainer.run_fused()
    except WorkerStalledError as e:
        exit_for_stall(e)

    h = cfg.obs_shape[0]
    fn_env = TensorCatchEnv(height=h, width=h, **catch_params(cfg.env_name))
    collect_fn = make_eval_collect_fn(cfg, fn_env, num_envs=16)

    def reward_fn(net):
        return evaluate_params_device(cfg, net, fn_env, num_envs=16, seed=1234,
                                      collect_fn=collect_fn, episodes_per_slot=args.eval_episodes)

    rows = evaluate_series(cfg, None, out_path=os.path.join(args.out, "eval.jsonl"),
                           reward_fn=reward_fn, device=args.device,
                           episodes_per_checkpoint=16 * args.eval_episodes,
                           evaluator_label="device")
    if rows:
        plot_curve(rows, os.path.join(args.out, "curve.jpg"))
        print(f"final mean reward: {rows[-1]['mean_reward']:.3f}")
    return rows, trainer


if __name__ == "__main__":
    main()
