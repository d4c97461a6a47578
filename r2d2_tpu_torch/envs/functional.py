"""Host-protocol adapters over a tensor env core (port of
r2d2_tpu/envs/functional.py).

A tensor core (envs/catch.TensorCatchEnv, envs/fake.ScriptedFnEnv,
envs/procmaze.ProcMazeEnv, the multi-task family's keydoor, drift and
banditgrid) steps E envs as (E, ...) state tensors: reset(n, generator,
device, draws=None) -> state, step(state, action, generator, draws=None)
-> (state', reward, done), render(state) -> (E, *obs) uint8, plus
NUM_ACTIONS. A core draws its randomness from the generator, or takes it
as `draws` in its own documented form (the tests hand in the JAX
package's; catch's step calls its draws `respawn`). The on-device
collector (collect.py) drives the core directly; these adapters lift it
into the two host protocols the rest of the port speaks (HostEnvPool's
single env and the vectorized env of the actor), with auto-reset on the
core's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def select_rows(mask: torch.Tensor, a, b):
    """Row-wise select between two states of one core (NamedTuples of (E,)
    tensors): a where mask, else b."""
    return type(a)(*(torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y)
                     for x, y in zip(a, b)))


class FnHostEnv:
    """Single-env host protocol (reset() / step(int)) over a tensor core
    built by `make_env(*env_args, **kwargs)`."""

    def __init__(self, make_env: Callable, env_args: tuple = (), seed: int = 0,
                 kwargs: Optional[dict] = None, device="cpu"):
        self.env = make_env(*env_args, **(kwargs or {}))
        self.action_dim = self.env.NUM_ACTIONS
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = None
        # the frame shape, from a throwaway generator: the env's own draws
        # start at its first reset()
        probe = torch.Generator(device=self.device).manual_seed(0)
        self.obs_shape = tuple(self.env.render(self.env.reset(1, probe, self.device)).shape[1:])

    def reset(self) -> np.ndarray:
        self._state = self.env.reset(1, self.generator, self.device)
        return self.env.render(self._state)[0].cpu().numpy()

    def step(self, action: int):
        a = torch.tensor([action], dtype=torch.int32, device=self.device)
        self._state, reward, done = self.env.step(self._state, a, self.generator)
        return (self.env.render(self._state)[0].cpu().numpy(), float(reward[0]),
                bool(done[0]), {})


class FnVecEnv:
    """E envs of a tensor core stepped together with auto-reset. step()
    returns the terminal-inclusive frame plus the frame that seeds the next
    step (a fresh episode's first frame on done rows): the CatchVecEnv /
    HostEnvPool contract."""

    def __init__(self, fn_env, num_envs: int = 1, seed: int = 0, device="cpu"):
        self.env = fn_env
        self.num_envs = num_envs
        self.action_dim = fn_env.NUM_ACTIONS
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = fn_env.reset(num_envs, self.generator, self.device)
        self.obs_shape = tuple(fn_env.render(self._state).shape[1:])

    def reset_all(self) -> np.ndarray:
        self._state = self.env.reset(self.num_envs, self.generator, self.device)
        return self.env.render(self._state).cpu().numpy()

    def step(self, actions: np.ndarray, draws=None):
        """`draws` = (the step's draws, the fresh episodes' reset draws) of
        the core, handed in; None draws both from the generator."""
        step_draws, reset_draws = draws if draws is not None else (None, None)
        a = torch.as_tensor(np.asarray(actions), device=self.device).to(torch.int32)
        s2, reward, done = self.env.step(self._state, a, self.generator, step_draws)
        term_obs = self.env.render(s2)
        fresh = self.env.reset(self.num_envs, self.generator, self.device, draws=reset_draws)
        self._state = select_rows(done, fresh, s2)
        return (term_obs.cpu().numpy(), reward.cpu().numpy().astype(np.float64),
                done.cpu().numpy(),
                self.env.render(self._state).cpu().numpy())
