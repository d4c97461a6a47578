"""Learning demo of the PyTorch port on one GPU: the full pipeline solves
catch (port of examples/catch_demo.py, the same recipe and flags).

Default configuration: 26x26 catch rendered on the card, the IMPALA
encoder, a 128-unit LSTM, bf16, collection on the card (64 envs a chunk,
collect.DeviceCollector), the replay store on the card, K=8 updates a
dispatch. The JAX demo reached eval 1.0 at update 1504 of 4000 on one TPU
v5e (runs/catch_demo/eval.jsonl). Its config names IMPALA channels (8, 16),
but the JAX package's make_encoder does not pass them on, so that run
trained (16, 32, 32); this demo names (16, 32, 32) to train the network the
JAX curve came from.

--full switches to the Atari-scale system (84x84, Nature trunk, 512-unit
LSTM), which needs tens of thousands of updates (`--full --steps 100000
--mode fused`). --mode threaded (the default, as in the JAX demo: the
device collector on an actor thread beside the learner) or fused (one
dispatch of K updates and a collection chunk, paced by samples_per_insert).

    python examples/torch_catch_demo.py --out runs/torch_catch_demo

Artifacts: {out}/metrics.jsonl, {out}/eval.jsonl, {out}/curve.jpg,
checkpoints under {out}/ckpt. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the channels the JAX demo's network ran (see the module docstring)
IMPALA_CHANNELS = (16, 32, 32)


def plot_curve(rows, path: str) -> None:
    """evaluate.plot_series, or a note where matplotlib is not installed
    (the curve can be drawn later from eval.jsonl: plot_series(rows, path)
    on a machine that has it)."""
    from r2d2_tpu_torch.evaluate import plot_series

    try:
        plot_series(rows, path)
    except ImportError as e:
        print(f"no {os.path.basename(path)}: {e}; eval.jsonl holds the curve's rows")


def demo_config(out: str, steps: int, actors: int, full: bool, env: str = "catch",
                size: int = 26):
    """The JAX demo's demo_config (examples/catch_demo.py:32-89), field for
    field, with the IMPALA channels its network actually ran."""
    from r2d2_tpu_torch.config import R2D2Config, default_atari

    K = 16 if full else 8
    steps = max(steps // K, 1) * K  # round to the dispatch multiple
    common = dict(
        env_name=env,
        action_dim=3,
        compute_dtype="bfloat16",
        collector="device",
        replay_plane="device",
        num_actors=actors,
        training_steps=steps,
        save_interval=max(steps // 8, 16),
        checkpoint_dir=os.path.join(out, "ckpt"),
        metrics_path=os.path.join(out, "metrics.jsonl"),
    )
    if full:
        return default_atari().replace(
            max_episode_steps=82,  # catch: the ball lands after height - 2 steps
            updates_per_dispatch=16,
            buffer_capacity=400_000,
            learning_starts=40_000,
            # a target sync every 500 updates (the preset's 2000 needs ~32k
            # updates before returns move over the 82-step horizon)
            target_net_update_interval=500,
            **common,
        )
    # the mid-scale recipe at a chosen resolution: episodes of size - 2
    # steps, blocks rounded up to the 20-step learning windows
    episode = size - 2
    block = ((episode + 19) // 20) * 20
    return R2D2Config(
        obs_shape=(size, size, 1),
        encoder="impala",
        impala_channels=IMPALA_CHANNELS,
        hidden_dim=128,
        max_episode_steps=episode,
        updates_per_dispatch=8,
        burn_in_steps=10,
        learning_steps=20,
        forward_steps=5,
        block_length=block,
        buffer_capacity=2000 * block,
        learning_starts=10_000,
        gamma=0.99,
        target_net_update_interval=100,
        **common,
    ).validate()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="runs/torch_catch_demo")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--actors", type=int, default=64)
    p.add_argument("--full", action="store_true",
                   help="the Atari-scale config (needs --steps 50000+)")
    p.add_argument("--size", type=int, default=26,
                   help="mid-scale obs resolution (ignored with --full)")
    p.add_argument("--env", default="catch",
                   help="catch | memory_catch[:K] (the flashing-cue variant)")
    p.add_argument("--ablate-zero-state", action="store_true",
                   help="zero-state ablation: burn_in=0 and replayed sequences start "
                        "from the zero state (config.zero_state_replay)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the checkpoints under --out")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: evaluate the checkpoint series under --out "
                        "(pass the flags the run used)")
    p.add_argument("--eval-episodes", type=int, default=4,
                   help="episodes per eval slot per checkpoint (16 slots)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field on top of the demo config")
    p.add_argument("--mode", default="threaded", choices=["threaded", "fused"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from r2d2_tpu_torch.config import apply_cli_overrides
    from r2d2_tpu_torch.envs.catch import (
        CatchVecEnv,
        TensorCatchEnv,
        catch_params,
        is_catch_name,
    )

    if not is_catch_name(args.env):
        p.error(f"--env must be catch or memory_catch[:K], got {args.env!r}")
    if catch_params(args.env).get("fall_every", 1) != 1:
        p.error("memory_catch:K:F (slow fall) needs the long-context sizing: use "
                "examples/torch_long_context_demo.py")
    os.makedirs(args.out, exist_ok=True)

    from r2d2_tpu_torch.evaluate import (
        evaluate_params_device,
        evaluate_series,
        make_eval_collect_fn,
    )
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.supervision import WorkerStalledError, exit_for_stall

    cfg = demo_config(args.out, args.steps, args.actors, args.full, env=args.env,
                      size=args.size)
    if args.mode == "fused":
        # pace collection to the threaded run's consumed:inserted ratio
        cfg = cfg.replace(samples_per_insert=15.0)
    cfg = apply_cli_overrides(cfg, args.set, args.ablate_zero_state)
    if not args.eval_only:
        trainer = Trainer(cfg, device=args.device, resume=args.resume)
        try:
            if args.mode == "fused":
                trainer.run_fused()
            else:
                trainer.run_threaded()
        except WorkerStalledError as e:
            exit_for_stall(e)  # a wedged device: exit with the --resume code

    h = cfg.obs_shape[0]
    params_kw = catch_params(cfg.env_name)
    reward_fn = None
    if args.full or args.size > 26:
        # long episodes: the device evaluator, one chunk per slot
        fn_env = TensorCatchEnv(height=h, width=h, **params_kw)
        collect_fn = make_eval_collect_fn(cfg, fn_env, num_envs=16)

        def reward_fn(net):
            return evaluate_params_device(cfg, net, fn_env, num_envs=16, seed=1234,
                                          collect_fn=collect_fn,
                                          episodes_per_slot=args.eval_episodes)

    vec = None if reward_fn else CatchVecEnv(num_envs=16, height=h, width=h, seed=1234,
                                             **params_kw)
    rows = evaluate_series(
        cfg, vec, out_path=os.path.join(args.out, "eval.jsonl"), reward_fn=reward_fn,
        episodes_per_slot=args.eval_episodes, device=args.device,
        episodes_per_checkpoint=16 * args.eval_episodes,
        evaluator_label="device" if reward_fn else "host",
    )
    if not rows:
        print("no checkpoints to evaluate (steps < save_interval?)")
        return rows
    plot_curve(rows, os.path.join(args.out, "curve.jpg"))
    print(f"final mean reward: {rows[-1]['mean_reward']:.3f}")
    return rows


if __name__ == "__main__":
    main()
