"""Serve a torch_catch_demo run's checkpoint and play catch through TCP.

    python examples/torch_serve_catch.py --run runs/torch_catch_demo

Starts ``python -m r2d2_tpu_torch.serve`` on the run's ``ckpt/`` (the
demo's network given as --set pairs), waits until it listens, then plays
catch at epsilon 0 through PolicyClient over TCP on the host env the
demo's evaluator uses (CatchVecEnv, 16 slots, seed 1234), --episodes
episodes in all (--episodes / 16 a slot, counted as evaluate_params counts
them), one session a slot, reset at every episode start. Beside the served
mean it prints the evaluator's row for the served checkpoint from
eval.jsonl and the evaluator itself run in-process at epsilon 0 on a fresh
env of the same seed; the last line is one JSON object with all three.
The server is stopped with SIGTERM. Runs the server on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the fields that make the demo's network (serving reads no other)
NET_FIELDS = ("obs_shape", "encoder", "impala_channels", "hidden_dim", "action_dim",
              "compute_dtype", "precision", "recurrent_core", "encoder_depth")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _set_pairs(cfg):
    pairs = []
    for name in NET_FIELDS:
        v = getattr(cfg, name)
        pairs.append(f"{name}={','.join(map(str, v)) if isinstance(v, tuple) else v}")
    return pairs


def play(port: int, cfg, episodes: int, seed: int = 1234):
    """Mean reward of `episodes` catch episodes played through PolicyClient
    over TCP at epsilon 0."""
    from r2d2_tpu_torch.envs.catch import CatchVecEnv, catch_params
    from r2d2_tpu_torch.serve import PolicyClient

    h = cfg.obs_shape[0]
    vec = CatchVecEnv(num_envs=16, height=h, width=h, seed=seed, **catch_params(cfg.env_name))
    per_slot = max(episodes // vec.num_envs, 1)
    obs = vec.reset_all()
    last_reward = np.zeros(vec.num_envs)
    reset = np.ones(vec.num_envs, bool)
    cur, completed, returns = np.zeros(vec.num_envs), np.zeros(vec.num_envs, int), []
    with PolicyClient(port=port, timeout=60.0) as client:
        while (completed < per_slot).any():
            actions = np.array([
                client.act(f"slot-{i}", obs[i], reward=float(last_reward[i]),
                           reset=bool(reset[i]), epsilon=0.0)["action"]
                for i in range(vec.num_envs)], np.int32)
            _, rewards, dones, obs = vec.step(actions)
            active = completed < per_slot
            cur += np.where(active, rewards, 0.0)
            for i in np.nonzero(dones & active)[0]:
                returns.append(cur[i])
                completed[i] += 1
                cur[i] = 0.0
            reset, last_reward = dones, np.where(dones, 0.0, rewards)
    return float(np.mean(returns)), len(returns)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="runs/torch_catch_demo", help="the demo's --out")
    p.add_argument("--episodes", type=int, default=64)
    p.add_argument("--full", action="store_true", help="the run used --full")
    p.add_argument("--size", type=int, default=26, help="the run's --size")
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds to wait for the server to listen")
    args = p.parse_args(argv)

    import torch_catch_demo
    from r2d2_tpu_torch.envs.catch import CatchVecEnv, catch_params
    from r2d2_tpu_torch.evaluate import evaluate_params
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step, restore_checkpoint

    cfg = torch_catch_demo.demo_config(args.run, 4000, 64, args.full, size=args.size)
    ckpt = os.path.join(args.run, "ckpt")
    step = latest_checkpoint_step(ckpt)
    if step is None:
        raise SystemExit(f"no checkpoint under {ckpt}")
    port = _free_port()
    cmd = [sys.executable, "-m", "r2d2_tpu_torch.serve", "--preset", "tiny_test", "--set",
           *_set_pairs(cfg), "--ckpt", ckpt, "--port", str(port), "--device", args.device]
    print("[serve-catch] " + " ".join(cmd), flush=True)
    server = subprocess.Popen(cmd, cwd=HERE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + args.timeout
        for line in server.stderr:
            print(line.rstrip(), flush=True)
            if "listening on" in line:
                break
            if time.monotonic() > deadline:
                raise SystemExit("the server did not come up in time")
        else:
            raise SystemExit(f"the server exited {server.wait()}")
        t0 = time.perf_counter()
        served, n = play(port, cfg, args.episodes)
        play_s = time.perf_counter() - t0
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()

    rows = []
    eval_path = os.path.join(args.run, "eval.jsonl")
    if os.path.exists(eval_path):
        with open(eval_path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    row = next((r for r in rows if r["step"] == step), None)
    _, state = init_train_state(cfg, args.device)
    restore_checkpoint(ckpt, state, step, map_location=args.device)
    h = cfg.obs_shape[0]
    greedy = evaluate_params(cfg.replace(test_epsilon=0.0), state.net,
                             CatchVecEnv(num_envs=16, height=h, width=h, seed=1234,
                                         **catch_params(cfg.env_name)),
                             episodes_per_slot=max(args.episodes // 16, 1))
    out = {"ckpt_step": step, "served_mean_reward": served, "served_episodes": n,
           "play_seconds": play_s,
           "evaluator_mean_reward": None if row is None else row["mean_reward"],
           "evaluator_epsilon0_fresh_env": greedy}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
