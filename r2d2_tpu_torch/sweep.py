"""Atari-57 sweep driver and the multi-task launcher (port of
r2d2_tpu/sweep.py).

`run_sweep` trains each game of the suite (or any subset) in sequence
through the same Trainer, one run per game with its own checkpoint
directory and metrics file, plus a combined summary jsonl. `run_multitask`
trains ONE learner over a task family (multitask/MultiTaskTrainer) and
writes one summary row per task.

    python -m r2d2_tpu_torch.sweep --games Breakout Seaquest --steps 1000
    python -m r2d2_tpu_torch.sweep --multitask --steps 30   # maze,drift,bandit + catch

As in the JAX package, `--multitask` maps `--preset atari` (the default)
to `tiny_test`; the full-width family runs through
MultiTaskTrainer(default_atari().replace(...), names). Runs on the CUDA
device; `--device cpu` runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

from r2d2_tpu_torch.config import PRESETS, R2D2Config, parse_overrides
from r2d2_tpu_torch.utils.supervision import WorkerStalledError

# the canonical 57-game ALE suite of the R2D2 paper's evaluation
ATARI_57: tuple = (
    "Alien", "Amidar", "Assault", "Asterix", "Asteroids", "Atlantis",
    "BankHeist", "BattleZone", "BeamRider", "Berzerk", "Bowling", "Boxing",
    "Breakout", "Centipede", "ChopperCommand", "CrazyClimber", "Defender",
    "DemonAttack", "DoubleDunk", "Enduro", "FishingDerby", "Freeway",
    "Frostbite", "Gopher", "Gravitar", "Hero", "IceHockey", "Jamesbond",
    "Kangaroo", "Krull", "KungFuMaster", "MontezumaRevenge", "MsPacman",
    "NameThisGame", "Phoenix", "Pitfall", "Pong", "PrivateEye", "Qbert",
    "Riverraid", "RoadRunner", "Robotank", "Seaquest", "Skiing", "Solaris",
    "SpaceInvaders", "StarGunner", "Surround", "Tennis", "TimePilot",
    "Tutankham", "UpNDown", "Venture", "VideoPinball", "WizardOfWor",
    "YarsRevenge", "Zaxxon",
)


def sweep_config(game: str, preset: str = "atari", root: str = "sweep", **overrides) -> R2D2Config:
    """Per-game config: the preset with game-scoped checkpoint and metrics
    paths; explicit overrides win."""
    cfg = PRESETS[preset]()
    kw = dict(
        env_name=game,
        checkpoint_dir=os.path.join(root, game, "checkpoints"),
        metrics_path=os.path.join(root, game, "metrics.jsonl"),
    )
    kw.update(overrides)
    return cfg.replace(**kw)


def run_sweep(
    games: Sequence[str],
    preset: str = "atari",
    root: str = "sweep",
    steps: Optional[int] = None,
    mode: str = "threaded",
    resume: bool = False,
    trainer_factory=None,
    cfg_overrides: Optional[dict] = None,
    device="cuda",
) -> List[dict]:
    """Train each game in sequence; returns (and appends to
    {root}/summary.jsonl) one row per game: final step, env steps, the
    run-lifetime mean episode return and wall minutes.
    `trainer_factory(cfg)` is injectable for tests."""
    from r2d2_tpu_torch.train import Trainer

    os.makedirs(root, exist_ok=True)
    summary_path = os.path.join(root, "summary.jsonl")
    rows = []
    factory = trainer_factory or (lambda cfg: Trainer(cfg, device=device, resume=resume))
    for game in games:
        overrides = {"training_steps": steps} if steps else {}
        overrides.update(cfg_overrides or {})
        cfg = sweep_config(game, preset=preset, root=root, **overrides)
        os.makedirs(os.path.dirname(cfg.metrics_path), exist_ok=True)
        t0 = time.time()
        trainer = factory(cfg)
        if mode == "inline":
            trainer.run_inline()
        else:
            trainer.run_threaded()
        n_ep, r_sum = trainer.replay.episode_totals()
        row = {
            "game": game,
            "steps": int(trainer.state.step),
            "env_steps": trainer.replay.env_steps + trainer.env_steps_offset,
            "episodes": n_ep,
            "mean_return": (r_sum / n_ep) if n_ep else None,
            "wall_minutes": (time.time() - t0) / 60.0,
        }
        rows.append(row)
        with open(summary_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        print(json.dumps(row))
    return rows


def run_multitask(
    task_spec: str = "maze,drift,bandit",
    preset: str = "tiny_test",
    root: str = "sweep",
    steps: Optional[int] = None,
    eval_episodes: int = 8,
    cfg_overrides: Optional[dict] = None,
    device="cuda",
) -> List[dict]:
    """ONE learner over the task family plus catch (the family's anchor,
    added unless listed): warmup, training_steps updates, then one greedy
    evaluation row PER TASK, appended to {root}/summary.jsonl."""
    from r2d2_tpu_torch.multitask import MultiTaskTrainer
    from r2d2_tpu_torch.multitask.registry import resolve_task_names
    from r2d2_tpu_torch.utils.metrics import MetricsLogger

    names = resolve_task_names(task_spec)
    if "catch" not in names:
        names.append("catch")
    os.makedirs(root, exist_ok=True)
    summary_path = os.path.join(root, "summary.jsonl")
    kw = dict(
        checkpoint_dir=os.path.join(root, "multitask", "checkpoints"),
        metrics_path=os.path.join(root, "multitask", "metrics.jsonl"),
    )
    if steps:
        kw["training_steps"] = steps
    kw.update(cfg_overrides or {})
    cfg = PRESETS[preset]().replace(**kw)
    os.makedirs(os.path.dirname(cfg.metrics_path), exist_ok=True)

    t0 = time.time()
    logger = MetricsLogger(cfg.metrics_path, cfg.log_interval)
    try:
        trainer = MultiTaskTrainer(cfg, names, metrics=logger, device=device)
        trainer.warmup()
        trainer.train(cfg.training_steps)
        rows = trainer.evaluate(episodes=eval_episodes)
    finally:
        logger.close()
    wall = (time.time() - t0) / 60.0
    with open(summary_path, "a") as fh:
        for row in rows:
            row = {**row, "mode": "multitask", "steps": trainer._updates, "wall_minutes": wall}
            fh.write(json.dumps(row) + "\n")
            print(json.dumps(row))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="r2d2_tpu_torch Atari-57 sweep")
    p.add_argument("--games", nargs="*", default=None, help="subset of games")
    p.add_argument("--all", action="store_true", help="run the full Atari-57 suite")
    p.add_argument("--preset", default="atari", choices=sorted(PRESETS))
    p.add_argument("--root", default="sweep")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--mode", default="threaded", choices=["threaded", "inline"])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--allow-any-env", action="store_true",
                   help="accept env names outside the Atari-57 suite "
                        "(e.g. 'catch' on images without ALE)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any R2D2Config field for every game "
                        "(repeatable, typed by the field)")
    p.add_argument("--multitask", nargs="?", const="maze,drift,bandit",
                   default=None, metavar="TASKS",
                   help="train ONE learner over a comma-separated task "
                        "family (aliases: maze/drift/bandit; catch is "
                        "auto-included). Default family: maze,drift,bandit")
    p.add_argument("--eval-episodes", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    overrides = parse_overrides(args.set) if args.set else None
    if args.multitask is not None:
        run_multitask(
            args.multitask,
            # the JAX package's mapping: the atari preset runs the family
            # at tiny_test
            preset=args.preset if args.preset != "atari" else "tiny_test",
            root=args.root,
            steps=args.steps,
            eval_episodes=args.eval_episodes,
            cfg_overrides=overrides,
            device=args.device,
        )
        return
    games = list(ATARI_57) if args.all else (args.games or ["MsPacman"])
    unknown = [g for g in games if g not in ATARI_57]
    if unknown and not args.allow_any_env:
        p.error(f"not in the Atari-57 suite: {unknown} (--allow-any-env to override)")
    try:
        run_sweep(games, preset=args.preset, root=args.root, steps=args.steps, mode=args.mode,
                  resume=args.resume, cfg_overrides=overrides, device=args.device)
    except WorkerStalledError as e:
        # a wedged runtime exits with STALL_EXIT_CODE: restart with --resume
        from r2d2_tpu_torch.utils.supervision import exit_for_stall

        exit_for_stall(e)


if __name__ == "__main__":
    main()
