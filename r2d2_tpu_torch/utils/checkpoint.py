"""Checkpoints with a full resume path (port of
r2d2_tpu/utils/checkpoint.py).

A checkpoint carries the complete TrainState (online and target networks,
the optimizer's state_dict, the update count) plus env_steps and
wall_minutes, and `restore_checkpoint` rebuilds the learner exactly: every
tensor bit for bit. Collection state (replay contents, the actor's and the
sampler's random streams) is not in a checkpoint: the trainer's replay
snapshot carries it (``replay/snapshot.py``, ``--snapshot-replay``).

Layout: {dir}/step_{N}/state.pt (torch.save) and a finalize marker written
last. A save is written into {dir}/.tmp_step_{N} and renamed into place, so
a reader lists either the complete checkpoint or nothing. The write and the
read are the fault sites ``checkpoint.save`` and ``checkpoint.restore``,
each retried on transient errors (``utils/faults.with_retries``); a retried
save rewrites the same temp dir.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional

import torch

from r2d2_tpu_torch.utils.faults import fault_point, with_retries

# written last inside a completed save: a step dir without it (a crashed
# save) is invisible to readers
_FINALIZED_MARKER = "_CHECKPOINT_METADATA"
_PAYLOAD = "state.pt"


def _payload(state, env_steps: int, wall_minutes: float) -> dict:
    return {
        "net": state.net.state_dict(),
        "target_net": state.target_net.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "env_steps": int(env_steps),
        "wall_minutes": float(wall_minutes),
    }


def save_checkpoint(ckpt_dir: str, state, env_steps: int, wall_minutes: float) -> str:
    """Write `state` as step_{state.step} under `ckpt_dir`, atomically for
    concurrent readers; a step that already exists is replaced. -> its path."""
    step = int(state.step)
    base = os.path.abspath(ckpt_dir)
    final = os.path.join(base, f"step_{step}")
    tmp = os.path.join(base, f".tmp_step_{step}")
    os.makedirs(base, exist_ok=True)

    def write():
        fault_point("checkpoint.save")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)  # leftover from a crashed or retried save
        os.makedirs(tmp)
        torch.save(_payload(state, env_steps, wall_minutes), os.path.join(tmp, _PAYLOAD))
        with open(os.path.join(tmp, _FINALIZED_MARKER), "w") as f:
            json.dump({"step": step, "env_steps": int(env_steps),
                       "wall_minutes": float(wall_minutes)}, f)

    with_retries(write, "checkpoint.save")
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_checkpoint_steps(ckpt_dir: str) -> List[int]:
    """Finalized checkpoints only, sorted: temp dirs (`.tmp_step_*`) and
    `step_*` dirs without the finalize marker are skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    # sorted: the filesystem's order varies per host
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[5:])
        except ValueError:
            continue
        if os.path.exists(os.path.join(ckpt_dir, name, _FINALIZED_MARKER)):
            steps.append(step)
    return sorted(steps)


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template_state, step: Optional[int] = None,
                       map_location=None):
    """Load a checkpoint (the latest when `step` is None) into
    `template_state` (from init_train_state: the same networks and an Adam
    over the same parameters, in the same order) and return (that state,
    env_steps, wall_minutes). Tensors land on `map_location`."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", _PAYLOAD)

    def read():
        fault_point("checkpoint.restore")
        return torch.load(path, map_location=map_location, weights_only=True)

    p = with_retries(read, "checkpoint.restore")
    opt = p["optimizer"]
    if not any(g.get("capturable") or g.get("fused") for g in opt["param_groups"]):
        # torch's Adam keeps its step counts on the host unless capturable or
        # fused (its load_state_dict leaves them where they arrive), and
        # map_location moved them with the rest
        for st in opt["state"].values():
            if "step" in st:
                st["step"] = st["step"].cpu()
    template_state.net.load_state_dict(p["net"])
    template_state.target_net.load_state_dict(p["target_net"])
    template_state.optimizer.load_state_dict(opt)
    template_state.step = p["step"]
    return template_state, p["env_steps"], p["wall_minutes"]
