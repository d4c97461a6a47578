"""The live loop closed on catch under live load, for the CPU suite
(tests/test_torch_liveloop.py, slow) and the card's (tests/test_torch_cuda.py):
imports nothing of JAX."""

from __future__ import annotations

import threading
import time

import numpy as np

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import CatchHostEnv
from r2d2_tpu_torch.liveloop import LiveLoopPlane, LiveLoopTrainer
from r2d2_tpu_torch.serve import LocalClient, MultiDeviceServer, ServeConfig


def run_liveloop_catch(tmp_path, device, seconds=30.0, sessions=6, rate=48.0):
    """The closed loop under live load: a two-replica fleet on one device
    serves catch sessions, the tap feeds the trainer's replay, the trainer's
    checkpoints hot-reload the fleet. -> (fleet stats, loop stats, episodes
    [(t, return)])."""
    cfg = tiny_test().replace(
        env_name="catch", action_dim=3, liveloop=True, checkpoint_dir=str(tmp_path / "ckpt"),
        save_interval=20, learning_starts=128, buffer_capacity=4096,
        training_steps=1_000_000, serve_spill=4 * sessions)
    serve_cfg = ServeConfig(buckets=(2, 4, 8), max_wait_ms=2.0, cache_capacity=16,
                            poll_interval_s=0.25)
    trainer = LiveLoopTrainer(cfg, device=device)
    server = MultiDeviceServer(cfg, serve_cfg, checkpoint_dir=cfg.checkpoint_dir,
                               devices=[device, device])
    plane = LiveLoopPlane(cfg, server, trainer.replay, seed=0)
    server.warmup()
    server.start(watch_checkpoints=True)
    plane.start()
    stop, lock, episodes = threading.Event(), threading.Lock(), []
    t0 = time.perf_counter()

    def session_body(idx):
        rng = np.random.default_rng(100 + idx)
        env = CatchHostEnv(height=cfg.obs_shape[0], width=cfg.obs_shape[1], seed=100 + idx)
        client = LocalClient(server)
        obs, reward, reset, ep_ret = env.reset(), 0.0, True, 0.0
        while not stop.is_set():
            res = client.act(f"s{idx}", obs, reward=reward, reset=reset)
            reset = False
            obs, reward, done, _ = env.step(res.action)
            ep_ret += reward
            if done:
                with lock:
                    episodes.append((time.perf_counter() - t0, ep_ret))
                obs, reset, ep_ret = env.reset(), True, 0.0
            time.sleep(rng.exponential(sessions / rate))

    threads = [threading.Thread(target=session_body, args=(i,), daemon=True)
               for i in range(sessions)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + seconds
    try:
        while time.monotonic() < deadline:
            plane.check()
            server.check()
            if trainer.can_train():
                trainer.train(8, deadline=deadline)
            else:
                time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        plane.stop()
        trainer.finish()
        stats = server.stats()
        server.stop()
    return stats, plane.stats(), episodes
