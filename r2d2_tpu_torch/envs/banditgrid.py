"""BanditGrid — the stochastic-reward grid of the multi-task family, as a
tensor core (port of r2d2_tpu/envs/banditgrid.py).

The agent walks a g x g grid (0 NOOP, 1 up, 2 down, 3 left, 4 right; other
actions are NOOPs) from the low corner; each step pays the arm mean of its
cell (rising toward the far corner, in [0, 1]) plus Gaussian noise of sigma
0.5, and the episode ends at `horizon`. Frames are (H, W, 1) uint8: the
mean surface at half intensity, the agent at 255.

The port's tensor-core protocol (envs/catch.TensorCatchEnv). A reset draws
nothing; every step draws one standard normal per env, from `generator` or
handed in as `draws` (the tests hand in the JAX package's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BANDITGRID_DEFAULTS = dict(grid=4, horizon=16)
BANDIT_NOISE_SIGMA = 0.5


def banditgrid_params(name: str) -> dict:
    """'banditgrid[:G[:H]]' -> grid side and episode horizon. Raises on
    other names and degenerate values."""
    base, _, suffix = name.lower().partition(":")
    if base != "banditgrid":
        raise ValueError(f"not a banditgrid family env name: {name!r}")
    out = dict(BANDITGRID_DEFAULTS)
    if suffix:
        parts = suffix.split(":")
        if len(parts) > 2:
            raise ValueError(f"banditgrid takes at most :G:H, got {name!r}")
        for k, v in zip(("grid", "horizon"), parts):
            out[k] = int(v)
    if out["grid"] < 2:
        raise ValueError(f"banditgrid grid must be >= 2, got {out['grid']}")
    if out["horizon"] < 2:
        raise ValueError(f"banditgrid horizon must be >= 2, got {out['horizon']}")
    return out


def is_banditgrid_name(name: str) -> bool:
    return name.lower().partition(":")[0] == "banditgrid"


def build_banditgrid_env(obs_shape, max_episode_steps: int, name: str) -> "BanditGridEnv":
    """The one factory of every banditgrid name; the horizon is capped by
    the episode budget."""
    p = banditgrid_params(name)
    h, w, _ = obs_shape
    return BanditGridEnv(height=h, width=w, grid=p["grid"],
                         horizon=min(max_episode_steps, p["horizon"]))


class BanditGridState(NamedTuple):
    pos: torch.Tensor  # (E, 2) int32 row, col
    t: torch.Tensor    # (E,) int32 step counter


class BanditGridEnv:
    NUM_ACTIONS = 5  # 0 NOOP, 1 up, 2 down, 3 left, 4 right

    def __init__(self, height: int = 6, width: int = 6, grid: int = 4, horizon: int = 16,
                 noise: float = BANDIT_NOISE_SIGMA):
        if grid < 2:
            raise ValueError(f"banditgrid grid must be >= 2, got {grid}")
        if height < grid or width < grid:
            raise ValueError(
                f"banditgrid obs canvas {height}x{width} cannot render a "
                f"{grid}x{grid} grid"
            )
        if horizon < 2:
            raise ValueError(f"banditgrid horizon must be >= 2, got {horizon}")
        self.h, self.w = height, width
        self.g = grid
        self.horizon = horizon
        self.noise = noise
        self.obs_shape = (height, width, 1)

    def _means(self, device) -> torch.Tensor:
        """(g, g) float32 arm means in [0, 1], rising toward (g-1, g-1)."""
        idx = torch.arange(self.g, dtype=torch.float32, device=device)
        return (idx[:, None] + idx[None, :]) / (2.0 * (self.g - 1))

    def reset(self, n: int, generator: Optional[torch.Generator] = None, device="cpu",
              draws=None) -> BanditGridState:
        """n fresh episodes at the low corner; draws nothing."""
        zero = torch.zeros(n, dtype=torch.int32, device=device)
        return BanditGridState(torch.zeros((n, 2), dtype=torch.int32, device=device), zero)

    def render(self, s: BanditGridState) -> torch.Tensor:
        dev = s.pos.device
        ys = torch.arange(self.h, device=dev)[:, None]
        xs = torch.arange(self.w, device=dev)[None, :]
        means = torch.zeros((self.h, self.w), dtype=torch.float32, device=dev)
        means[: self.g, : self.g] = self._means(dev)
        surface = torch.where((ys < self.g) & (xs < self.g), means * 128.0, 0.0)
        agent = (ys[None] == s.pos[:, 0, None, None]) & (xs[None] == s.pos[:, 1, None, None])
        return torch.where(agent, 255.0, surface[None]).to(torch.uint8)[..., None]

    def step(self, s: BanditGridState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None):
        """(state', reward = mean(cell') + noise, done at the horizon);
        `draws` = the (E,) standard normals."""
        a = action.to(s.pos.device)
        dr = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
        dc = torch.where(a == 3, -1, torch.where(a == 4, 1, 0))
        pos = torch.clamp(s.pos + torch.stack([dr, dc], -1), 0, self.g - 1).to(torch.int32)
        t = (s.t + 1).to(torch.int32)
        if draws is None:
            z = torch.randn(len(pos), generator=generator, device=pos.device)
        else:
            z = torch.as_tensor(draws, device=pos.device).to(torch.float32)
        mu = self._means(pos.device)[pos[:, 0].long(), pos[:, 1].long()]
        return BanditGridState(pos, t), mu + self.noise * z, t >= self.horizon
