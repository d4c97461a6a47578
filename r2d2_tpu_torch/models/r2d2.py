"""R2D2Network — recurrent dueling double-DQN trunk (port of
r2d2_tpu/models/r2d2.py).

- encoder -> recurrent core (the LSTM, or the LRU with
  recurrent_core="lru") over concat(latent, one-hot last action, last
  reward) -> dueling heads, Q = V + A - mean(A), in float32.
- `act` / `act_select`: the batched single-step acting forward, through
  the core's `step` (plain PyTorch: acting runs no kernel).
- `unroll`: one core pass over the padded burn_in+learning+forward window
  (the LSTM through the fused sequence kernels, with the burn-in seam when
  fused_sequence is set; the LRU through its scan, with the gradient
  through every step, as in the JAX package), then two clamped gathers:

    learning view   idx(t) = burn_in + t
    bootstrap view  idx(t) = min(burn_in + F + t, burn_in + learning + forward - 1)

Observations enter as uint8 and are normalized once, here.

Multi-task (num_tasks > 1, a (B,) int task per row through `act`,
`act_select` and `unroll`): the head's input is widened by the one-hot
task after the core's output (trimmed back to hidden_dim where the card
pads the LSTM's units), broadcast over L in `unroll`; with
task_action_dims the advantage mean runs over each task's valid actions
and the invalid ones are floored at -1e9, so neither the acting argmax nor
the learner's bootstrap max can pick them. num_tasks = 1 keeps the
single-task head, its weights' shapes included.

`compute_dtype` (the config's resolved compute dtype) is the dtype of the
encoder, the core input and the LSTM; the parameters stay float32, and the
dueling head is a float32 island, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r2d2_tpu_torch.config import R2D2Config, resolve_device, set_fp32_numerics
from r2d2_tpu_torch.models.encoders import dense, make_encoder
from r2d2_tpu_torch.models.lru import LRU
from r2d2_tpu_torch.models.lstm import LSTM, Carry
from r2d2_tpu_torch.ops.act_tail import epsilon_greedy_actions


def one_hot(x: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """(..., n) one-hot of integer `x` in `dtype`, as jax.nn.one_hot forms
    it: a comparison with arange(n). (F.one_hot reads the class range back
    to the host on the CPU, twice a call.)"""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


class R2D2Network(nn.Module):
    def __init__(
        self,
        obs_shape,
        action_dim: int,
        hidden_dim: int = 512,
        learning_steps: int = 40,
        forward_steps: int = 5,
        encoder: str = "nature",
        encoder_depth: int = 0,
        fused_sequence: bool = True,
        generator: Optional[torch.Generator] = None,
        backward_arm: Tuple[str, int] = ("default", 0),
        compute_dtype: torch.dtype = torch.float32,
        impala_channels: Tuple[int, ...] = (16, 32, 32),
        recurrent_core: str = "lstm",
        lru_chunk: int = 0,
        lru_r_min: float = 0.9,
        lru_r_max: float = 0.999,
        num_tasks: int = 1,
        task_action_dims: Tuple[int, ...] = (),
    ):
        super().__init__()
        self.dtype = compute_dtype
        self.action_dim = action_dim
        self.hidden_dim = hidden_dim
        self.learning_steps = learning_steps
        self.forward_steps = forward_steps
        self.fused_sequence = fused_sequence
        self.recurrent_core = recurrent_core
        self.num_tasks = num_tasks
        self.task_action_dims = tuple(task_action_dims)
        self._dims_on = {}  # the task_action_dims tensor per device
        g = generator
        self.enc = make_encoder(encoder, obs_shape, hidden_dim, encoder_depth, g, compute_dtype,
                                impala_channels)
        core_in = hidden_dim + action_dim + 1
        if recurrent_core == "lru":
            self.core = LRU(hidden_dim, core_in, dtype=compute_dtype, r_min=lru_r_min,
                            r_max=lru_r_max, chunk=lru_chunk, generator=g)
        else:
            self.core = LSTM(hidden_dim, core_in, generator=g, backward_arm=backward_arm,
                             dtype=compute_dtype)
        head_in = hidden_dim + (num_tasks if num_tasks > 1 else 0)
        self.adv_hidden = dense(head_in, hidden_dim, g)
        self.adv_out = dense(hidden_dim, action_dim, g)
        self.val_hidden = dense(head_in, hidden_dim, g)
        self.val_out = dense(hidden_dim, 1, g)

    @classmethod
    def from_config(cls, cfg: R2D2Config, generator=None, device="cuda") -> "R2D2Network":
        """Build on `device` (the card unless the caller passes "cpu"),
        with the core running the backward arm that
        ``cfg.resolve_backward_arm`` resolves for that device. On the card
        this sets the float32 numerics (``config.set_fp32_numerics``: TF32
        off, which the LRU's chunk products need even in a bf16 run)."""
        if (torch.device(device).type == "cuda" and cfg.lstm_backend == "scan"
                and cfg.recurrent_core == "lstm"):
            raise ValueError(
                "lstm_backend='scan' names the plain PyTorch versions, which "
                "the port runs only on the CPU; use 'auto' or 'pallas'"
            )
        dev = resolve_device(device)
        if dev.type == "cuda":
            set_fp32_numerics()
        return cls(
            cfg.obs_shape, cfg.action_dim, cfg.hidden_dim, cfg.learning_steps,
            cfg.forward_steps, cfg.encoder, cfg.encoder_depth, cfg.fused_sequence,
            generator=generator, backward_arm=cfg.resolve_backward_arm(device=dev.type),
            compute_dtype=cfg.torch_compute_dtype, impala_channels=cfg.impala_channels,
            recurrent_core=cfg.recurrent_core, lru_chunk=cfg.lru_chunk,
            lru_r_min=cfg.lru_r_min, lru_r_max=cfg.lru_r_max, num_tasks=cfg.num_tasks,
            task_action_dims=tuple(cfg.task_action_dims),
        ).to(dev)

    # ----------------------------------------------------------------- util

    def _core_input(self, obs, last_action, last_reward, view=None):
        """(N, *obs) uint8, (N,) int, (N,) float -> (N, latent+A+1), all in
        the compute dtype. `view` (models/tp.TPView) computes the latent
        over a tp group's slices."""
        x = obs.to(self.dtype) / 255.0
        latent = self.enc(x) if view is None else view.latent(x)
        onehot = one_hot(last_action, self.action_dim, self.dtype)
        reward = last_reward.to(self.dtype)[:, None]
        return torch.cat([latent, onehot, reward], dim=-1)

    def _task_mask(self, task: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """(B, A) bool valid-action mask of each row's task, or None when
        every task spans the whole union action space."""
        if task is None or self.num_tasks <= 1 or not self.task_action_dims:
            return None
        dims = self._dims_on.get(task.device)
        if dims is None:
            dims = self._dims_on[task.device] = torch.tensor(
                self.task_action_dims, dtype=torch.long, device=task.device)
        actions = torch.arange(self.action_dim, device=task.device)
        return actions[None, :] < dims[task.long()][:, None]

    def _dueling(self, h: torch.Tensor, task: Optional[torch.Tensor] = None,
                 view=None) -> torch.Tensor:
        """Dueling Q in float32 whatever the compute dtype: Q = V + A -
        mean_a A; multi-task as in the module docstring. `view` computes the
        heads over a tp group's slices."""
        h = h.float()
        mask = self._task_mask(task)
        if task is not None and self.num_tasks > 1:
            onehot = one_hot(task, self.num_tasks, torch.float32)
            if h.dim() == 3:  # (B, L, H): one task per sequence
                onehot = onehot[:, None, :].expand(*h.shape[:2], self.num_tasks)
            h = torch.cat([h, onehot], dim=-1)
        if view is None:
            adv = self.adv_out(F.relu(self.adv_hidden(h)))
            val = self.val_out(F.relu(self.val_hidden(h)))
        else:
            adv, val = view.heads(h)
        if mask is None:
            return val + adv - adv.mean(dim=-1, keepdim=True)
        if adv.dim() == 3:
            mask = mask[:, None, :]
        valid = mask.float()
        adv_mean = (adv * valid).sum(-1, keepdim=True) / valid.sum(-1, keepdim=True)
        q = val + adv - adv_mean
        return torch.where(mask, q, torch.full_like(q, -1e9))

    # ------------------------------------------------------------------ act

    def act(self, obs, last_action, last_reward, carry: Carry,
            task: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Carry]:
        x = self._core_input(obs, last_action, last_reward)
        h, carry = self.core.step(x, carry)
        return self._dueling(h, task), carry

    def act_select(self, obs, last_action, last_reward, carry: Carry, explore, random_actions,
                   task: Optional[torch.Tensor] = None):
        """Core step + dueling + ε-greedy select: (q (B,A) f32, action (B,)
        int32, carry). The ε coin and random draws are inputs (host numpy
        stream, see ops/act_tail.py); multi-task callers draw the random
        actions within each row's native action count."""
        q, carry = self.act(obs, last_action, last_reward, carry, task)
        return q, epsilon_greedy_actions(q, explore, random_actions), carry

    # --------------------------------------------------------------- unroll

    def unroll(self, obs, last_action, last_reward, hidden, burn_in, learning, forward,
               task: Optional[torch.Tensor] = None, view=None):
        """(B,T,*obs) uint8, (B,T), (B,T), (B,2,H), (B,) x3, task (B,) or
        None -> (q_learn (B,L,A), q_boot (B,L,A), mask (B,L) f32). `view`
        (models/tp.TPView): the unroll of one batch shard's tp group."""
        B, T = obs.shape[:2]
        L, Fw = self.learning_steps, self.forward_steps
        x = self._core_input(
            obs.reshape(B * T, *obs.shape[2:]),
            last_action.reshape(B * T),
            last_reward.reshape(B * T),
            view,
        ).reshape(B, T, -1)
        carry = (hidden[:, 0], hidden[:, 1])
        kw = {}
        if view is not None and self.recurrent_core == "lstm":
            kw["params"] = view.core_params()
        if self.recurrent_core == "lstm" and self.fused_sequence:
            outs, _ = self.core(x, carry, burn_in=burn_in, **kw)
        else:
            outs, _ = self.core(x, carry, **kw)

        burn_in, learning, forward = burn_in.long(), learning.long(), forward.long()
        t = torch.arange(L, device=obs.device)
        learn_idx = torch.clamp(burn_in[:, None] + t[None, :], 0, T - 1)
        seq_end = burn_in + learning + forward
        boot_idx = torch.minimum(burn_in[:, None] + Fw + t[None, :], seq_end[:, None] - 1)
        boot_idx = torch.clamp(boot_idx, 0, T - 1)
        H = outs.shape[-1]
        learn_h = torch.gather(outs, 1, learn_idx[:, :, None].expand(B, L, H))
        boot_h = torch.gather(outs, 1, boot_idx[:, :, None].expand(B, L, H))
        mask = (t[None, :] < learning[:, None]).float()
        return self._dueling(learn_h, task, view), self._dueling(boot_h, task, view), mask

    forward = unroll


def initial_carry(batch: int, hidden_dim: int, device="cuda",
                  dtype: torch.dtype = torch.float32) -> Carry:
    """Zero carry — the episode-start state ((h, c) of the LSTM, (Re h,
    Im h) of the LRU)."""
    z = torch.zeros((batch, hidden_dim), dtype=dtype, device=resolve_device(device))
    return z, z.clone()


def init_params(cfg: R2D2Config, seed: int = 0, device="cuda") -> R2D2Network:
    """A network with parameters drawn from an explicit torch.Generator
    seeded with `seed` (the same distributions as the flax init; not the
    same numbers)."""
    gen = torch.Generator().manual_seed(seed)
    return R2D2Network.from_config(cfg, generator=gen, device=device)
