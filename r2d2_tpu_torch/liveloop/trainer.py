"""LiveLoopTrainer: continuous learning against the live replay (port of
r2d2_tpu/liveloop/trainer.py).

Thin on purpose: it builds a full `Trainer` (the same update, replay plane
and publish and checkpoint cadences) whose actors are never stepped; the
store fills from served traffic through the tap and the bridge. `train()`
drives the stock `_one_update(plane.sample())` loop, so every crossing of
`save_interval` writes a checkpoint into `cfg.checkpoint_dir`, the
directory the serving fleet's watcher polls: the fleet hot-reloads the
policy its own traffic trained, params_version rises on every replica, and
the transitions captured next carry the new stamp. At the atari widths an
update launches the LSTM kernels as the main path does (K1 twice, K2
once, or their bf16 forms).
"""

from __future__ import annotations

import time
from typing import Optional

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.train import Trainer


class LiveLoopTrainer:
    def __init__(self, cfg: R2D2Config, trainer: Optional[Trainer] = None, device="cuda"):
        self.cfg = cfg
        self.trainer = trainer if trainer is not None else Trainer(cfg, device=device)
        # _cadences stamps wall-minutes into checkpoints relative to the
        # trainer's run clock, which only the run modes start; the live
        # loop is its own run mode
        self.trainer.reset_clock()
        self.updates_done = 0

    @property
    def replay(self):
        return self.trainer.replay

    def can_train(self) -> bool:
        return self.trainer.replay.can_sample()

    def train(self, max_updates: int, deadline: Optional[float] = None) -> int:
        """Run up to `max_updates` updates (stopping at `deadline`,
        time.monotonic-based, if given); returns updates performed. Bounded
        work per call so callers can interleave training with stats polls
        and stop checks — the live-loop analog of one superstep."""
        done = 0
        tr = self.trainer
        while done < max_updates and tr.replay.can_sample():
            if deadline is not None and time.monotonic() >= deadline:
                break
            tr._one_update(tr.plane.sample())
            done += tr.plane.steps_per_update
        self.updates_done += done
        return done

    @property
    def step(self) -> int:
        return self.trainer._step

    def finish(self) -> None:
        """Drain deferred per-plane work (stock contract for any external
        update-driving loop)."""
        self.trainer.finish_updates()

    def stats(self) -> dict:
        return {
            "learner_step": self.trainer._step,
            "learner_updates": self.updates_done,
            "replay_env_steps": self.trainer.replay.env_steps,
            "replay_can_sample": bool(self.trainer.replay.can_sample()),
        }
