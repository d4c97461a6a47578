"""Actor: vectorized ε-greedy experience collection (port of
r2d2_tpu/actor.py: ParamStore, HostEnvPool, VectorizedActor).

One actor steps E environments with one batched policy call per env step
(`R2D2Network.act_select` on the port's device). Per env, as in the JAX
package: ε-greedy on the dueling Q, the recurrent carry held on the device,
every transition into that env's SequenceAccumulator with its Q row and
post-step carry ((h, c), or the LRU's (Re h, Im h)); block cuts at
block_length or at max_episode_steps, deferred one step so the bootstrap Q
comes from the next batched call; on
a terminal, finish(None) and a fresh accumulator. The ε coins and random
actions come from a numpy Generator in the JAX package's stream order.
The carry is held in the acting step's own dtype (``cfg.carry_dtype``: the
LSTM's compute dtype, the LRU's float32), in the same (h, c)-shaped pair
for both cores, and stored through the config's state dtype.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config, resolve_device
from r2d2_tpu_torch.models.r2d2 import R2D2Network, initial_carry
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator


class ParamStore:
    """Published parameter snapshot. `publish` copies the learner's
    parameters (the learner goes on updating its own in place) and swaps
    the reference; readers take the latest snapshot under the lock."""

    def __init__(self, net: torch.nn.Module):
        self._params = self._snapshot(net)
        self.version = 0
        self._lock = threading.Lock()

    @staticmethod
    @torch.no_grad()
    def _snapshot(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    def publish(self, net: torch.nn.Module) -> None:
        snap = self._snapshot(net)
        with self._lock:
            self._params = snap
            self.version += 1

    def latest(self):
        with self._lock:
            return self._params, self.version


class HostEnvPool:
    """Vec adapter over a list of host-protocol envs. step() returns
    (terminal-inclusive obs, rewards, dones, next_obs), where next_obs
    differs from obs only on done rows — the CatchVecEnv contract."""

    def __init__(self, envs: Sequence):
        self.envs = list(envs)
        self.num_envs = len(self.envs)
        self.action_dim = envs[0].action_dim
        self.obs_shape = envs[0].obs_shape

    def reset_all(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions: np.ndarray):
        out = []
        for env, a in zip(self.envs, actions):
            o, r, d, _ = env.step(int(a))
            out.append((o, r, d, env.reset() if d else o))
        obs, rewards, dones, nxt = zip(*out)
        return np.stack(obs), np.asarray(rewards), np.asarray(dones), np.stack(nxt)

    def force_reset(self, i: int) -> np.ndarray:
        """Mid-flight reset of one slot (max_episode_steps truncation)."""
        return self.envs[i].reset()


class VectorizedActor:
    def __init__(
        self,
        cfg: R2D2Config,
        policy: R2D2Network,   # the actor's own network copy on `device`
        param_store: ParamStore,
        env,                   # vec env: num_envs, reset_all(), step(actions)
        epsilons: np.ndarray,  # (E,) per-env ε (the ladder)
        push_block: Callable,  # (block, priorities, episode_reward) -> None
        seed: int = 0,
        device="cuda",
    ):
        E = env.num_envs
        if len(epsilons) != E:
            raise ValueError(f"{len(epsilons)} epsilons for {E} envs")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = policy.requires_grad_(False)
        self.param_store = param_store
        self.env = env
        self.epsilons = np.asarray(epsilons, np.float32)
        self.push_block = push_block
        self.rng = np.random.default_rng(seed)
        self.action_dim = cfg.action_dim
        params, self.param_version = param_store.latest()
        self.policy.load_state_dict(params)
        self._reset_state(np.array(env.reset_all()))
        self.total_steps = 0
        self._steps_since_refresh = 0

    def _reset_state(self, obs: np.ndarray) -> None:
        cfg = self.cfg
        E = self.env.num_envs
        self.accs: List[SequenceAccumulator] = [SequenceAccumulator(cfg) for _ in range(E)]
        for i in range(E):
            self.accs[i].reset(obs[i])
        self.obs = obs
        self.last_action = np.zeros(E, np.int32)
        self.last_reward = np.zeros(E, np.float32)
        self.carry = initial_carry(E, cfg.hidden_dim, self.device, cfg.carry_dtype)
        self.episode_steps = np.zeros(E, np.int64)
        # envs whose accumulator awaits a bootstrap Q from the next call
        self._pending_cut = np.zeros(E, bool)
        self._pending_truncate = np.zeros(E, bool)

    @property
    def steps_per_call(self) -> int:
        return self.env.num_envs

    @torch.no_grad()
    def step(self) -> None:
        cfg = self.cfg
        E = self.env.num_envs
        dev = self.device

        # coins and random actions on the host, in the JAX package's order
        explore = self.rng.random(E) < self.epsilons
        random_a = self.rng.integers(0, self.action_dim, size=E)
        q, device_actions, (h, c) = self.policy.act_select(
            torch.from_numpy(self.obs).to(dev),
            torch.from_numpy(self.last_action).to(dev),
            torch.from_numpy(self.last_reward).to(dev),
            self.carry,
            torch.from_numpy(explore).to(dev),
            torch.from_numpy(random_a.astype(np.int32)).to(dev),
        )
        # one device -> host copy for q, actions and the new carry (a bf16
        # carry widens to float32 exactly)
        A, H = q.shape[1], h.shape[1]
        packed = torch.cat([q, device_actions[:, None].float(), h.float(), c.float()],
                           dim=1).cpu().numpy()
        q_np = packed[:, :A]
        actions = packed[:, A].astype(np.int32)
        hidden_np = np.stack([packed[:, A + 1 : A + 1 + H], packed[:, A + 1 + H :]], axis=1)

        # deferred cuts bootstrap from this call's Q
        fresh = np.zeros(E, bool)
        for i in np.nonzero(self._pending_cut | self._pending_truncate)[0]:
            block, prios, ep_reward = self.accs[i].finish(last_qval=q_np[i])
            self.push_block(block, prios, ep_reward)
            if self._pending_truncate[i]:
                if hasattr(self.env, "force_reset"):
                    self.obs[i] = self.env.force_reset(i)
                self.last_action[i] = 0
                self.last_reward[i] = 0.0
                self.episode_steps[i] = 0
                fresh[i] = True
        self._pending_cut[:] = False
        self._pending_truncate[:] = False

        # fresh slots take a NOOP that is not recorded
        actions[fresh] = 0
        term_obs, rewards, dones, next_obs = self.env.step(actions)

        keep = np.ones(E, np.float32)
        for i in range(E):
            if fresh[i]:
                seed_obs = next_obs[i] if dones[i] else term_obs[i]
                self.accs[i].reset(seed_obs)
                self.obs[i] = seed_obs
                keep[i] = 0.0
                continue
            self.accs[i].add(int(actions[i]), float(rewards[i]), term_obs[i], q_np[i], hidden_np[i])
            self.episode_steps[i] += 1
            if dones[i]:
                block, prios, ep_reward = self.accs[i].finish(last_qval=None)
                self.push_block(block, prios, ep_reward)
                self.accs[i].reset(next_obs[i])
                self.obs[i] = next_obs[i]
                self.last_action[i] = 0
                self.last_reward[i] = 0.0
                self.episode_steps[i] = 0
                keep[i] = 0.0
            else:
                self.obs[i] = term_obs[i]
                self.last_action[i] = actions[i]
                self.last_reward[i] = rewards[i]
                if self.episode_steps[i] >= cfg.max_episode_steps:
                    self._pending_truncate[i] = True
                elif len(self.accs[i]) == cfg.block_length:
                    self._pending_cut[i] = True

        if not keep.all():
            k = torch.from_numpy(keep).to(dev, h.dtype)[:, None]
            self.carry = (h * k, c * k)
        else:
            self.carry = (h, c)

        self.total_steps += E
        self._steps_since_refresh += E
        if self._steps_since_refresh >= cfg.actor_update_interval:
            self._steps_since_refresh = 0
            self._maybe_refresh_params()

    def resync(self) -> None:
        """Recover to a consistent state after a mid-step fault (the
        supervisor's restart hook). step() is not re-entrant once env.step
        has run: a crash between env.step and the accumulator writes leaves
        self.obs and the carry describing the pre-step world while the env
        has advanced. Instead: discard every in-flight accumulator window
        and start fresh episodes in all slots."""
        self._reset_state(np.array(self.env.reset_all()))

    def _maybe_refresh_params(self) -> None:
        params, version = self.param_store.latest()
        if version != self.param_version:
            self.policy.load_state_dict(params)
            self.param_version = version
