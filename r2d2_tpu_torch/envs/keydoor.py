"""KeyDoor — the partially observable keyed-door corridor of the multi-task
family, as a tensor core (port of r2d2_tpu/envs/keydoor.py).

A key colour shows for the first `cue_steps` frames only; the agent walks a
corridor and at the door cell must open with the remembered colour. Actions:
0 NOOP, 1 left, 2 right, 3 + c open with colour c (an open away from the
door, or an action past the union's native range, is a NOOP). Frames are
(H, W, 1) uint8: row 0 the cue (column = colour, while t < cue_steps), row 1
the agent, the bottom row the door cell.

The port's tensor-core protocol (envs/catch.TensorCatchEnv): a reset draws
one colour per env, from `generator` or handed in as `draws` (the tests
hand in the JAX package's); steps draw nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

KEYDOOR_DEFAULTS = dict(length=6, num_colors=2, cue_steps=1)


def keydoor_params(name: str) -> dict:
    """'keydoor[:L[:C[:CUE]]]' -> corridor length, key colours, cue steps.
    Raises on other names and on degenerate values."""
    base, _, suffix = name.lower().partition(":")
    if base != "keydoor":
        raise ValueError(f"not a keydoor family env name: {name!r}")
    out = dict(KEYDOOR_DEFAULTS)
    if suffix:
        parts = suffix.split(":")
        if len(parts) > 3:
            raise ValueError(f"keydoor takes at most :L:C:CUE, got {name!r}")
        for k, v in zip(("length", "num_colors", "cue_steps"), parts):
            out[k] = int(v)
    if out["length"] < 2:
        raise ValueError(f"keydoor length must be >= 2, got {out['length']}")
    if out["num_colors"] < 2:
        raise ValueError(
            f"keydoor num_colors must be >= 2 (1 color has no memory "
            f"demand), got {out['num_colors']}"
        )
    if out["cue_steps"] < 1:
        raise ValueError(f"keydoor cue_steps must be >= 1, got {out['cue_steps']}")
    return out


def is_keydoor_name(name: str) -> bool:
    return name.lower().partition(":")[0] == "keydoor"


def build_keydoor_env(obs_shape, max_episode_steps: int, name: str) -> "KeyDoorEnv":
    """The one factory of every keydoor name: horizon 4 * length + 4,
    capped by the episode budget."""
    p = keydoor_params(name)
    h, w, _ = obs_shape
    return KeyDoorEnv(height=h, width=w, horizon=min(max_episode_steps, 4 * p["length"] + 4),
                      **p)


class KeyDoorState(NamedTuple):
    pos: torch.Tensor    # (E,) int32 corridor cell in [0, length)
    color: torch.Tensor  # (E,) int32 key colour in [0, num_colors)
    t: torch.Tensor      # (E,) int32 step counter (drives the cue window)


class KeyDoorEnv:
    NUM_ACTIONS = 3 + KEYDOOR_DEFAULTS["num_colors"]

    def __init__(self, height: int = 8, width: int = 8, length: int = 6, num_colors: int = 2,
                 cue_steps: int = 1, horizon: int = 28):
        if length < 2 or num_colors < 2 or cue_steps < 1:
            raise ValueError(
                f"degenerate keydoor geometry: length={length}, "
                f"num_colors={num_colors}, cue_steps={cue_steps}"
            )
        if width < max(length, num_colors):
            raise ValueError(
                f"keydoor width {width} cannot render the corridor "
                f"(length {length}) and the cue row ({num_colors} colors)"
            )
        if height < 3:
            raise ValueError(f"keydoor needs height >= 3, got {height}")
        if horizon < length:
            raise ValueError(
                f"keydoor horizon {horizon} ends before the door "
                f"(corridor length {length}) is reachable: every episode "
                "would end reward-free"
            )
        self.h, self.w = height, width
        self.length = length
        self.colors = num_colors
        self.cue = cue_steps
        self.horizon = horizon
        self.NUM_ACTIONS = 3 + num_colors
        self.obs_shape = (height, width, 1)

    def reset(self, n: int, generator: Optional[torch.Generator] = None, device="cpu",
              draws=None) -> KeyDoorState:
        """n fresh episodes; `draws` = the (n,) key colours."""
        if draws is None:
            color = torch.randint(0, self.colors, (n,), generator=generator, device=device)
        else:
            color = torch.as_tensor(draws, device=device)
        color = color.to(torch.int32)
        zero = torch.zeros_like(color)
        return KeyDoorState(zero, color, zero.clone())

    def render(self, s: KeyDoorState) -> torch.Tensor:
        dev = s.pos.device
        ys = torch.arange(self.h, device=dev)[None, :, None]
        xs = torch.arange(self.w, device=dev)[None, None, :]
        cue = (ys == 0) & (xs == s.color[:, None, None]) & (s.t[:, None, None] < self.cue)
        agent = (ys == 1) & (xs == s.pos[:, None, None])
        door = (ys == self.h - 1) & (xs == self.length - 1)
        return ((cue | agent | door).to(torch.uint8) * 255)[..., None]

    def step(self, s: KeyDoorState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None):
        """(state', reward, done): terminal on any open at the door (+1 iff
        the colour matches) or at the horizon; draws nothing."""
        a = action.to(s.pos.device)
        dx = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
        pos = torch.clamp(s.pos + dx, 0, self.length - 1).to(torch.int32)
        t = (s.t + 1).to(torch.int32)
        opening = (s.pos == self.length - 1) & (a >= 3)
        matched = opening & (a - 3 == s.color)
        done = opening | (t >= self.horizon)
        return KeyDoorState(pos, s.color, t), matched.to(torch.float32), done
