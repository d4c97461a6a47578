"""ProcMaze — the procedurally generated maze of the procgen_impala preset,
as a tensor core (port of r2d2_tpu/envs/procmaze.py).

Every episode is a new level: random walls at `wall_density` on a G x G
grid, then an L-shaped corridor carved from start to goal (the bend order
itself a coin), so every level is solvable. The agent (red) walks
4-connected (0 NOOP, 1 up, 2 down, 3 left, 4 right), walls block, the goal
(green) pays +1 and ends the episode, and `horizon` steps truncate it with
reward 0. Frames are (G*cell, G*cell, 3) uint8: gray walls, red agent,
green goal — 64x64x3 at the default 16 cells of 4 pixels.

The core steps E envs as (E, ...) state tensors on any device, with the
port's tensor-core protocol (envs/catch.TensorCatchEnv): reset(n,
generator, device, draws=None), step(state, action, generator,
draws=None), render(state), NUM_ACTIONS. A level's draws are the wall
uniforms (E, G, G), start and goal cells (E, 2) and the bend coin (E,):
from `generator`, or handed in as `draws` (the tests hand in the JAX
package's). Steps draw nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# the shaped variant's per-step potential delta on the Manhattan distance
# to the goal (it telescopes, so the terminal +1 still dominates)
PROCMAZE_SHAPING_COEF = 0.02


def procmaze_params(name: str) -> dict:
    """ProcMazeEnv kwargs past the geometry from an env name: 'procmaze'
    (sparse), 'procmaze_shaped' (adds the distance shaping), with an
    optional ':G' grid suffix on either. Raises on other names."""
    base, _, suffix = name.lower().partition(":")
    if base == "procmaze":
        out = {}
    elif base == "procmaze_shaped":
        out = {"shaping_coef": PROCMAZE_SHAPING_COEF}
    else:
        raise ValueError(f"not a procmaze family env name: {name!r}")
    if suffix:
        grid = int(suffix)
        if grid < 2:
            raise ValueError(f"procmaze grid must be >= 2, got {grid}")
        out["grid"] = grid
    return out


def is_procmaze_name(name: str) -> bool:
    return name.lower().partition(":")[0] in ("procmaze", "procmaze_shaped")


def procmaze_geometry(obs_shape, max_episode_steps: int, grid: Optional[int] = None):
    """(grid, cell, horizon) rendering exactly `obs_shape` (square, 3
    channels): by default cells of h // 16 pixels (at least 1), else the
    given grid dividing h."""
    h, w, c = obs_shape
    if h != w or c != 3:
        raise ValueError(f"procmaze needs a square 3-channel obs_shape, got {obs_shape}")
    if grid is None:
        cell = max(h // 16, 1)
        if h % cell:
            raise ValueError(f"obs height {h} not divisible by cell {cell}")
        return h // cell, cell, max_episode_steps
    if h % grid:
        raise ValueError(f"obs height {h} not divisible into a {grid}-cell grid")
    return grid, h // grid, max_episode_steps


def build_procmaze_env(obs_shape, max_episode_steps: int, name: str) -> "ProcMazeEnv":
    """The one factory of every 'procmaze[_shaped][:G]' name."""
    params = procmaze_params(name)
    grid, cell, horizon = procmaze_geometry(obs_shape, max_episode_steps,
                                            grid=params.pop("grid", None))
    return ProcMazeEnv(grid, cell, horizon, **params)


class ProcMazeState(NamedTuple):
    walls: torch.Tensor  # (E, G, G) bool
    agent: torch.Tensor  # (E, 2) int32 row, col
    goal: torch.Tensor   # (E, 2) int32
    t: torch.Tensor      # (E,) int32 step counter


class ProcMazeEnv:
    NUM_ACTIONS = 5  # 0 NOOP, 1 up, 2 down, 3 left, 4 right

    def __init__(self, grid: int = 16, cell: int = 4, horizon: int = 96,
                 wall_density: float = 0.3, shaping_coef: float = 0.0):
        self.g = grid
        self.cell = cell
        self.horizon = horizon
        self.density = wall_density
        self.shaping = shaping_coef
        self.obs_shape = (grid * cell, grid * cell, 3)

    def level_draws(self, n: int, generator: Optional[torch.Generator], device):
        """(wall uniforms (n, G, G) float32, start (n, 2), goal (n, 2), bend
        coin (n,) bool) from `generator`."""
        g = self.g
        return (torch.rand((n, g, g), generator=generator, device=device),
                torch.randint(0, g, (n, 2), generator=generator, device=device),
                torch.randint(0, g, (n, 2), generator=generator, device=device),
                torch.rand(n, generator=generator, device=device) < 0.5)

    def reset(self, n: int, generator: Optional[torch.Generator] = None, device="cpu",
              draws=None) -> ProcMazeState:
        """n fresh levels: random walls, then the L-corridor carved start ->
        goal (start's row then goal's column where the bend coin is set,
        else start's column then goal's row); a goal drawn on the start is
        shifted by G // 2 on both axes."""
        if draws is None:
            draws = self.level_draws(n, generator, device)
        u, start, goal, bend = (torch.as_tensor(d, device=device) for d in draws)
        g = self.g
        walls = u < self.density
        start = start.to(torch.int32)
        goal = goal.to(torch.int32)
        goal = torch.where((goal == start).all(-1, keepdim=True), (goal + g // 2) % g, goal)
        rows = torch.arange(g, device=walls.device)

        def span(a, b):  # (n, G): a..b inclusive, either order
            lo, hi = torch.minimum(a, b)[:, None], torch.maximum(a, b)[:, None]
            return (rows[None] >= lo) & (rows[None] <= hi)

        def at(i):  # (n, G): the one index i
            return rows[None] == i[:, None]

        r0, c0, r1, c1 = start[:, 0], start[:, 1], goal[:, 0], goal[:, 1]
        cols, rws = span(c0, c1), span(r0, r1)
        row_first = (at(r0)[:, :, None] & cols[:, None, :]) | (rws[:, :, None] & at(c1)[:, None, :])
        col_first = (rws[:, :, None] & at(c0)[:, None, :]) | (at(r1)[:, :, None] & cols[:, None, :])
        corridor = torch.where(bend.to(torch.bool)[:, None, None], row_first, col_first)
        zero = torch.zeros(walls.shape[0], dtype=torch.int32, device=walls.device)
        return ProcMazeState(walls & ~corridor, start, goal, zero)

    def step(self, s: ProcMazeState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None):
        """(state', reward (E,) float32, done (E,) bool); draws nothing."""
        a = action.to(s.agent.device)
        dr = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
        dc = torch.where(a == 3, -1, torch.where(a == 4, 1, 0))
        nxt = torch.clamp(s.agent + torch.stack([dr, dc], -1), 0, self.g - 1).to(torch.int32)
        idx = torch.arange(len(nxt), device=nxt.device)
        blocked = s.walls[idx, nxt[:, 0].long(), nxt[:, 1].long()]
        agent = torch.where(blocked[:, None], s.agent, nxt)
        t = (s.t + 1).to(torch.int32)
        reached = (agent == s.goal).all(-1)
        done = reached | (t >= self.horizon)
        one = torch.ones_like(t, dtype=torch.float32)
        if self.shaping > 0.0:
            d_old = (s.agent - s.goal).abs().sum(-1)
            d_new = (agent - s.goal).abs().sum(-1)
            reward = torch.where(reached, one, self.shaping * (d_old - d_new).float())
        else:
            reward = torch.where(reached, one, torch.zeros_like(one))
        return ProcMazeState(s.walls, agent, s.goal, t), reward, done

    def render(self, s: ProcMazeState) -> torch.Tensor:
        """(E, G*cell, G*cell, 3) uint8: gray walls, red agent, green goal."""
        rows = torch.arange(self.g, device=s.agent.device)

        def cell_mask(p):  # (E, G, G): the one cell p
            return (rows[None, :, None] == p[:, 0, None, None]) & \
                (rows[None, None, :] == p[:, 1, None, None])

        wall = torch.where(s.walls, 96, 0).to(torch.uint8)
        red = torch.where(cell_mask(s.agent), 255, wall).to(torch.uint8)
        green = torch.where(cell_mask(s.goal), 255, wall).to(torch.uint8)
        img = torch.stack([red, green, wall], -1)
        return img.repeat_interleave(self.cell, 1).repeat_interleave(self.cell, 2)
