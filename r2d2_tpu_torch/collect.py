"""Experience collection on the card (port of r2d2_tpu/collect.py).

For a tensor env core (envs/catch.TensorCatchEnv, envs/fake.ScriptedFnEnv)
the whole collection loop runs on the device, one chunk of `chunk_len`
steps over E envs:

    policy act -> ε-greedy over the ladder -> env dynamics -> render ->
    block packing (n-step returns, terminal-as-gamma-0, per-sequence
    counters, true-window-start stored carries, rescaled-space initial
    priorities)

and the packed fields go into the device store (DeviceReplayBuffer.
add_blocks_batch) without visiting host memory; the host reads back only a
few kilobytes of priorities and counters per chunk. The chunk is a
fixed-length Python loop with no data-dependent exit and no host read: a
slot whose episode ends idles out the rest of the chunk.

Chunk semantics are the reference actor's with max_episode_steps ==
chunk_len: each chunk starts fresh episodes in every slot, steps until each
episode ends, and truncates slots still running at the chunk end with a
bootstrap Q from one more policy evaluation. For such episode-aligned
chunks the packing is the port's SequenceAccumulator's: the integer
fields, frames and carries bit for bit, n-step returns summed in float64
as the accumulator sums them, the bootstrap discounts from the same
float32 powers, the priorities to a float32 sum order.

carry_episodes=True (episodes longer than a chunk, as in the JAX package):
a slot alive at the chunk end keeps its env state, recurrent state, last
action and reward and its partial episode reward into the next chunk, whose
block stores the continuation; the seam window replays from the carried
stored state with no burn-in (the host accumulator also copies burn-in
rows across the seam, so blocks equal the host's only for aligned chunks).

The random draws of a chunk (ε coins, random actions, reset draws, the
env core's per-step draws: catch's multi-ball respawns, drift's moves,
banditgrid's payout noise) come from a CollectDraws source: a
torch.Generator on the device by default, or given arrays (the tests hand
in JAX's draws).

Multi-task plane: `task_id` conditions the policy and stamps every packed
block's per-sequence task field (present only when cfg.num_tasks > 1),
`action_dim` narrows the random exploration draws to the task's native
action count (the head's mask keeps the greedy picks there), and `gamma`
replaces cfg.gamma in the task's n-step returns and stored discounts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.envs.functional import select_rows
from r2d2_tpu_torch.models.r2d2 import R2D2Network, initial_carry
from r2d2_tpu_torch.ops.epsilon import epsilon_ladder
from r2d2_tpu_torch.ops.priority import mixed_td_priorities
from r2d2_tpu_torch.ops.value_rescale import inverse_value_rescale, value_rescale


def default_chunk_len(cfg: R2D2Config) -> int:
    """The chunk rule shared by collection and device-side evaluation:
    episodes are truncated at block_length (a block holds one episode)."""
    return min(cfg.block_length, cfg.max_episode_steps)


class CollectDraws:
    """The draws of collection chunks, from one torch.Generator on the
    collector's device: per step E ε-coin uniforms and E random actions
    (the env core draws its own per-step draws from the same generator),
    and the reset draws of the fresh episodes at a chunk's end."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def step(self, t: int, n: int, num_actions: int, device):
        g = self.generator
        return (torch.rand(n, generator=g, device=device, dtype=torch.float32),
                torch.randint(0, num_actions, (n,), generator=g, device=device,
                              dtype=torch.int32))

    def respawn(self, t: int) -> Optional[torch.Tensor]:
        return None

    def reset(self, fn_env, n: int, device):
        return fn_env.reset(n, self.generator, device)


class GivenDraws(CollectDraws):
    """Draws handed in: `explore` (T, E) uniforms, `actions` (T, E) random
    actions, `resets` the fresh state a chunk ends with, `respawns` (T, ...)
    the env core's per-step draws (catch's multi-ball respawn columns,
    drift's moves, banditgrid's normals), or None."""

    def __init__(self, explore, actions, resets=None, respawns=None):
        super().__init__(None)
        self.explore, self.actions = explore, actions
        self.resets, self.respawns = resets, respawns

    def step(self, t, n, num_actions, device):
        return (torch.as_tensor(self.explore[t], device=device).float(),
                torch.as_tensor(self.actions[t], device=device).to(torch.int32))

    def respawn(self, t):
        return None if self.respawns is None else torch.as_tensor(self.respawns[t])

    def reset(self, fn_env, n, device):
        return self.resets


class CollectCarry(NamedTuple):
    """Per-slot cross-chunk episode state (carry_episodes=True): the env
    state, the recurrent state after the last step (in the acting dtype),
    the last action / reward the policy resumes from, and the episode's
    reward and steps in earlier chunks (ep_steps enforces
    cfg.max_episode_steps)."""

    env_state: object
    h: torch.Tensor              # (E, H)
    c: torch.Tensor              # (E, H)
    last_action: torch.Tensor    # (E,) int32
    last_reward: torch.Tensor    # (E,) float32
    prefix_reward: torch.Tensor  # (E,) float32
    ep_steps: torch.Tensor       # (E,) int32


def initial_collect_carry(cfg: R2D2Config, fn_env, num_envs: int, draws: CollectDraws,
                          device) -> CollectCarry:
    """Fresh episodes in every slot: reset env states, zero recurrent state,
    NOOP last action, zero reward."""
    E = num_envs
    h, c = initial_carry(E, cfg.hidden_dim, device, cfg.carry_dtype)
    zi = torch.zeros(E, dtype=torch.int32, device=device)
    zf = torch.zeros(E, dtype=torch.float32, device=device)
    return CollectCarry(draws.reset(fn_env, E, device), h, c, zi, zf, zf.clone(), zi.clone())


def make_collect_fn(cfg: R2D2Config, fn_env, num_envs: int, chunk_len: int,
                    carry_episodes: bool = False, task_id: int = 0,
                    action_dim: Optional[int] = None, gamma: Optional[float] = None):
    """The chunk collector (see make_collect_core)."""
    return make_collect_core(cfg, fn_env, num_envs, chunk_len, carry_episodes,
                             task_id=task_id, action_dim=action_dim, gamma=gamma)


def make_collect_core(cfg: R2D2Config, fn_env, num_envs: int, chunk_len: int,
                      carry_episodes: bool = False, task_id: int = 0,
                      action_dim: Optional[int] = None, gamma: Optional[float] = None):
    """Build collect(policy, env_state, epsilons, draws) ->
      (fields, priorities (E, S), num_seq (E,), sizes (E,), dones (E,),
       ep_rewards (E,), next_env_state)

    `policy` is an R2D2Network on the collection device, `fields` a dict of
    (E, ...) tensors keyed and typed as the device store's fields. With
    carry_episodes the env_state argument and the last result are a
    CollectCarry; ep_rewards are then whole-episode returns where dones is
    set (a capped episode counts as done). task_id, action_dim and gamma:
    the multi-task plane (module docstring)."""
    E, T = num_envs, chunk_len
    L, Bn, n = cfg.learning_steps, cfg.burn_in_steps, cfg.forward_steps
    S, bl, slot = cfg.seqs_per_block, cfg.block_length, cfg.block_slot_len
    # A is the union width of the Q rows; A_task the range of random actions
    H, A = cfg.hidden_dim, cfg.action_dim
    A_task = A if action_dim is None else int(action_dim)
    gamma = cfg.gamma if gamma is None else float(gamma)
    eps_h = cfg.value_rescale_eps
    if not 0 < T <= bl:
        raise ValueError(f"chunk_len {T} must be in (0, block_length={bl}]")
    # gamma**j rounded to float32, as the accumulator's n_step_gammas rounds
    # its Python powers
    gamma_pow = torch.tensor([gamma ** j for j in range(n + 1)], dtype=torch.float32)

    def _pack(obs_buf, actions, rewards, qs, hiddens, size, done, q_final, la0, lr0, hid0):
        """Pack the chunk into store-slot fields, batched over E. obs_buf
        (E, slot, ...) holds the T+1 stored frames; actions / rewards (E, T)
        are zero past `size`; qs (E, T, A), hiddens (E, T, 2, H) float32
        post-step carries; q_final (E, A) the bootstrap evaluation; la0 /
        lr0 / hid0 the pre-chunk last action / reward / carry."""
        dev = obs_buf.device
        t1 = torch.arange(T + 1, device=dev)
        tT = torch.arange(T, device=dev)
        sid = torch.arange(S, device=dev)
        size_ = size.long()[:, None]
        valid_t1 = t1[None] <= size_          # stored entries 0..size
        valid_T = tT[None] < size_            # recorded transitions
        obs_buf[:, : T + 1] *= valid_t1.view(E, T + 1, *([1] * (obs_buf.dim() - 2))).to(
            obs_buf.dtype)

        f_la = torch.zeros((E, slot), dtype=torch.int32, device=dev)
        f_la[:, : T + 1] = torch.where(valid_t1, torch.cat([la0[:, None], actions], 1), 0)
        f_lr = torch.zeros((E, slot), dtype=torch.float32, device=dev)
        f_lr[:, : T + 1] = torch.where(valid_t1, torch.cat([lr0[:, None], rewards], 1), 0.0)

        # n-step returns R_t = sum_{k<n} gamma^k r_{t+k}, zero past the end,
        # accumulated in float64 as the accumulator's n_step_returns
        # r2d2: disable=float64-op  (E x T scalars, summed in the host accumulator's float64 for its bits)
        f64 = torch.float64
        r64 = torch.cat([rewards.to(f64),
                         torch.zeros((E, max(n - 1, 0)), dtype=f64, device=dev)], 1)
        R = torch.zeros((E, T), dtype=f64, device=dev)
        for k in range(n):
            R = R + (gamma ** k) * r64[:, k:k + T]
        R = torch.where(valid_T, R, 0.0).float()

        # bootstrap discount: gamma^n on full windows, gamma^(size-t) toward
        # a truncation, 0 toward a terminal
        gp = gamma_pow.to(dev)
        max_fwd = torch.clamp(size_, max=n)
        tail = gp[torch.clamp(size_ - tT[None], 1, n)]
        tail = torch.where(done[:, None], torch.zeros_like(tail), tail)
        gamma_n = torch.where(tT[None] < size_ - max_fwd, gp[n], tail)
        gamma_n = torch.where(valid_T, gamma_n, 0.0)

        f_action = torch.zeros((E, bl), dtype=torch.int32, device=dev)
        f_action[:, :T] = actions
        f_R = torch.zeros((E, bl), dtype=torch.float32, device=dev)
        f_R[:, :T] = R
        f_gamma = torch.zeros((E, bl), dtype=torch.float32, device=dev)
        f_gamma[:, :T] = gamma_n

        # per-sequence counters; window 0 packs with burn_in 0 (an episode
        # start, or a continuation replaying from its carried state)
        num_seq = (size_ + L - 1) // L
        valid_seq = sid[None] < num_seq
        burn = torch.where(valid_seq, torch.clamp(sid[None] * L, max=Bn), 0)
        learn = torch.clamp(size_ - sid[None] * L, 0, L)
        cum = torch.cumsum(learn, 1)
        fwd = torch.where(valid_seq, torch.clamp(size_ + 1 - cum, 0, n), 0)

        # the stored carry at each sequence's true window start
        stored_hid = torch.cat([hid0[:, None], hiddens], 1)  # (E, T+1, 2, H)
        wstart = torch.clamp(sid[None] * L - burn, 0, T)
        hid_seq = stored_hid[torch.arange(E, device=dev)[:, None], wstart]
        hid_seq = torch.where(valid_seq[..., None, None], hid_seq, 0.0)

        # the actor-side initial priorities in rescaled space: the bootstrap
        # value is max_a Q(s_min(t+max_fwd, size)), zero at a terminal
        qarr = torch.cat([qs, q_final[:, None].float()], 1)
        qarr = torch.where(((t1[None] >= size_) & done[:, None])[..., None], 0.0, qarr)
        boot = torch.clamp(tT[None] + max_fwd, max=size_)
        max_q = torch.gather(qarr.amax(-1), 1, boot)
        taken_q = torch.gather(qarr[:, :T], 2, actions.long()[..., None])[..., 0]
        target = value_rescale(R + gamma_n * inverse_value_rescale(max_q, eps_h), eps_h)
        abs_td = torch.where(valid_T, torch.abs(target - taken_q), 0.0)
        td_pad = torch.zeros((E, bl), dtype=torch.float32, device=dev)
        td_pad[:, :T] = abs_td
        m = (torch.arange(L, device=dev)[None, None] < learn[..., None]).float()
        prios = mixed_td_priorities(td_pad.view(E * S, L), m.view(E * S, L),
                                    cfg.td_mix_eta).view(E, S)

        fields = {
            "obs": obs_buf,
            "last_action": f_la,
            "last_reward": f_lr,
            "action": f_action,
            "n_step_reward": f_R,
            "gamma": f_gamma,
            "hidden": hid_seq.to(cfg.state_dtype),
            "burn_in": burn.to(torch.int32),
            "learning": learn.to(torch.int32),
            "forward": fwd.to(torch.int32),
        }
        if cfg.num_tasks > 1:
            fields["task"] = torch.full((E, S), int(task_id), dtype=torch.int32, device=dev)
        return fields, prios, num_seq[:, 0].to(torch.int32)

    @torch.no_grad()
    def collect(policy: R2D2Network, env_state, epsilons: torch.Tensor, draws: CollectDraws):
        dev = epsilons.device
        task = (torch.full((E,), int(task_id), dtype=torch.int32, device=dev)
                if cfg.num_tasks > 1 else None)
        if carry_episodes:
            carry0: CollectCarry = env_state
            env_state = carry0.env_state
            h, c = carry0.h, carry0.c
            la, lr = carry0.last_action, carry0.last_reward
        else:
            h, c = initial_carry(E, H, dev, cfg.carry_dtype)
            la = torch.zeros(E, dtype=torch.int32, device=dev)
            lr = torch.zeros(E, dtype=torch.float32, device=dev)
        la0, lr0 = la, lr
        hid0 = torch.stack([h, c], 1).float()
        obs_buf = torch.zeros((E, slot, *cfg.obs_shape), dtype=torch.uint8, device=dev)
        actions = torch.zeros((E, T), dtype=torch.int32, device=dev)
        rewards = torch.zeros((E, T), dtype=torch.float32, device=dev)
        qs = torch.zeros((E, T, A), dtype=torch.float32, device=dev)
        hiddens = torch.zeros((E, T, 2, H), dtype=torch.float32, device=dev)
        applied = torch.zeros((E, T), dtype=torch.bool, device=dev)
        ended = torch.zeros((E, T), dtype=torch.bool, device=dev)
        active = torch.ones(E, dtype=torch.bool, device=dev)
        for t in range(T):
            obs = fn_env.render(env_state)
            obs_buf[:, t] = obs
            u, rand_a = draws.step(t, E, A_task, dev)
            q, act, (h, c) = policy.act_select(obs, la, lr, (h, c), u < epsilons, rand_a, task)
            # the core's per-step draws (catch calls them respawn)
            new_env, reward, done = fn_env.step(env_state, act, draws.generator,
                                                draws.respawn(t))
            # slots whose episode ended stay frozen: their remaining steps
            # are padding, and step `size` renders the terminal frame
            env_state = select_rows(active, new_env, env_state)
            reward = torch.where(active, reward.float(), 0.0)
            act = torch.where(active, act, 0)
            done = done & active
            actions[:, t] = act
            rewards[:, t] = reward
            qs[:, t] = q.float()
            hiddens[:, t, 0] = h.float()
            hiddens[:, t, 1] = c.float()
            applied[:, t] = active
            ended[:, t] = done
            la = torch.where(active, act, la)
            lr = torch.where(active, reward, lr)
            active = active & ~done
        final_obs = fn_env.render(env_state)
        obs_buf[:, T] = final_obs
        q_final, _ = policy.act(final_obs, la, lr, (h, c), task)
        sizes = applied.sum(1).to(torch.int32)
        dones = ended.any(1)
        ep_rewards = rewards.sum(1)
        fields, priorities, num_seq = _pack(obs_buf, actions, rewards, qs, hiddens, sizes,
                                            dones, q_final.float(), la0, lr0, hid0)
        fresh = draws.reset(fn_env, E, dev)
        if not carry_episodes:
            return fields, priorities, num_seq, sizes, dones, ep_rewards, fresh
        # alive slots continue next chunk, done slots restart; a slot that
        # reached cfg.max_episode_steps is capped: restarted, and counted
        # as a finished episode in the stats
        ep_len = carry0.ep_steps + sizes
        capped = active & (ep_len >= cfg.max_episode_steps)
        cont = active & ~capped
        zero = torch.zeros((), dtype=h.dtype, device=dev)
        ep_total = carry0.prefix_reward + ep_rewards
        new_carry = CollectCarry(
            env_state=select_rows(cont, env_state, fresh),
            h=torch.where(cont[:, None], h, zero),
            c=torch.where(cont[:, None], c, zero),
            last_action=torch.where(cont, la, 0),
            last_reward=torch.where(cont, lr, 0.0),
            prefix_reward=torch.where(cont, ep_total, 0.0),
            ep_steps=torch.where(cont, ep_len, 0).to(torch.int32),
        )
        return fields, priorities, num_seq, sizes, dones | capped, ep_total, new_carry

    return collect


def _host(t: torch.Tensor) -> np.ndarray:
    """A carry tensor as an npz-safe host array (bfloat16 as uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == np.uint16 \
        else torch.from_numpy(a)
    return t.to(like.device, like.dtype)


class DeviceCollector:
    """Drives the chunk collector against a DeviceReplayBuffer. Stands in
    for VectorizedActor where the Trainer needs it: step() collects one
    chunk (not one env step), steps_per_call is the env steps a call runs
    at most, resync() restores a consistent state after a supervised
    restart, carry_state()/restore_carry() the preemption carry."""

    def __init__(self, cfg: R2D2Config, policy: R2D2Network, param_store, fn_env, replay,
                 epsilons: Optional[np.ndarray] = None, seed: int = 0,
                 chunk_len: Optional[int] = None, device="cuda", task_id: int = 0,
                 action_dim: Optional[int] = None, gamma: Optional[float] = None):
        E = cfg.num_actors
        self.cfg, self.E = cfg, E
        self.device = torch.device(device)
        self.chunk = int(chunk_len or default_chunk_len(cfg))
        # episodes longer than a chunk carry env and recurrent state across
        # chunks instead of never visiting the states past the first chunk
        self.carry_episodes = cfg.max_episode_steps > self.chunk
        self.replay = replay
        self.param_store = param_store
        self.fn_env = fn_env
        self.policy = policy.requires_grad_(False)
        # r2d2: ephemeral(the ParamStore version last loaded into the policy copy; a resumed run builds a new store from the checkpoint and this line loads it)
        params, self.param_version = param_store.latest()
        self.policy.load_state_dict(params)
        eps = (np.asarray(epsilons, np.float32) if epsilons is not None
               else epsilon_ladder(E, cfg.base_eps, cfg.eps_alpha))
        if len(eps) != E:
            raise ValueError(f"{len(eps)} epsilons for {E} envs")
        self.epsilons = torch.from_numpy(np.asarray(eps, np.float32)).to(self.device)
        self._collect = make_collect_fn(cfg, fn_env, E, self.chunk, self.carry_episodes,
                                        task_id=task_id, action_dim=action_dim, gamma=gamma)
        self.draws = CollectDraws(torch.Generator(device=self.device).manual_seed(seed))
        self.env_state = self._fresh()
        self.total_steps = 0

    def _fresh(self):
        if self.carry_episodes:
            return initial_collect_carry(self.cfg, self.fn_env, self.E, self.draws, self.device)
        return self.draws.reset(self.fn_env, self.E, self.device)

    @property
    def steps_per_call(self) -> int:
        return self.E * self.chunk

    def _refresh_params(self) -> None:
        params, version = self.param_store.latest()
        if version != self.param_version:
            self.policy.load_state_dict(params)
            self.param_version = version

    def step(self) -> int:
        """Collect one chunk and write its E blocks into replay; returns the
        env transitions recorded."""
        self._refresh_params()
        fields, prios, num_seq, sizes, dones, ep_rewards, self.env_state = self._collect(
            self.policy, self.env_state, self.epsilons, self.draws)
        sizes_np = sizes.cpu().numpy()
        self.replay.add_blocks_batch(fields, num_seq.cpu().numpy(), sizes_np,
                                     prios.cpu().numpy(), ep_rewards.cpu().numpy(),
                                     dones.cpu().numpy())
        recorded = int(sizes_np.sum())
        self.total_steps += recorded
        return recorded

    def resync(self) -> None:
        """Supervised-restart hook: fresh episodes in every slot (a chunk in
        flight was never written)."""
        self.env_state = self._fresh()

    def carry_state(self) -> dict:
        """The preemption carry (npz-safe): the generator's state, the step
        counter and the env / episode carry. step() is a function of these
        and the parameters, so restoring them resumes the stream exactly."""
        d = {"generator": self.draws.generator.get_state().numpy(),
             "total_steps": np.asarray(self.total_steps, np.int64)}
        for j, leaf in enumerate(_leaves(self.env_state)):
            d[f"env_{j}"] = _host(leaf)
        return d

    def restore_carry(self, d: dict) -> None:
        self.draws.generator.set_state(torch.from_numpy(np.asarray(d["generator"], np.uint8)))
        self.total_steps = int(np.asarray(d["total_steps"])[()])
        leaves = [_device(np.asarray(d[f"env_{j}"]), like)
                  for j, like in enumerate(_leaves(self.env_state))]
        self.env_state = _unflatten(self.env_state, leaves)


def _leaves(state):
    """The tensors of an env state or a CollectCarry, in a fixed order."""
    if isinstance(state, CollectCarry):
        return [*_leaves(state.env_state), *state[1:]]
    return list(state)


def _unflatten(like, leaves):
    if isinstance(like, CollectCarry):
        k = len(like.env_state)
        return CollectCarry(_unflatten(like.env_state, leaves[:k]), *leaves[k:])
    return type(like)(*leaves)
