"""R2D2Network — recurrent dueling double-DQN trunk (port of
r2d2_tpu/models/r2d2.py, single-task, float32).

- encoder -> LSTM over concat(latent, one-hot last action, last reward) ->
  dueling heads, Q = V + A - mean(A), in float32.
- `act` / `act_select`: the batched single-step acting forward, through
  `LSTM.step` (plain PyTorch: acting runs no kernel).
- `unroll`: one LSTM pass over the padded burn_in+learning+forward window
  (through the fused sequence kernels), then two clamped gathers:

    learning view   idx(t) = burn_in + t
    bootstrap view  idx(t) = min(burn_in + F + t, burn_in + learning + forward - 1)

Observations enter as uint8 and are normalized once, here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r2d2_tpu_torch.config import R2D2Config, require_ported, resolve_device
from r2d2_tpu_torch.models.encoders import dense, make_encoder
from r2d2_tpu_torch.models.lstm import LSTM, Carry
from r2d2_tpu_torch.ops.act_tail import epsilon_greedy_actions


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
    ):
        super().__init__()
        self.action_dim = action_dim
        self.hidden_dim = hidden_dim
        self.learning_steps = learning_steps
        self.forward_steps = forward_steps
        self.fused_sequence = fused_sequence
        g = generator
        self.enc = make_encoder(encoder, obs_shape, hidden_dim, encoder_depth, g)
        self.core = LSTM(hidden_dim, hidden_dim + action_dim + 1, generator=g)
        self.adv_hidden = dense(hidden_dim, hidden_dim, g)
        self.adv_out = dense(hidden_dim, action_dim, g)
        self.val_hidden = dense(hidden_dim, hidden_dim, g)
        self.val_out = dense(hidden_dim, 1, g)

    @classmethod
    def from_config(cls, cfg: R2D2Config, generator=None, device="cuda") -> "R2D2Network":
        """Build on `device` (the card unless the caller passes "cpu").
        Refuses what the port cannot run there yet: backward arms other
        than the default one (K4/K5) on any device."""
        require_ported(cfg)
        arm, _ = cfg.resolve_backward_arm(device=device)
        if arm != "default":
            raise NotImplementedError(
                f"backward arm {arm!r} (kernels K4/K5) is queued; use "
                "backward_arm='default'"
            )
        if torch.device(device).type == "cuda" and cfg.lstm_backend == "scan":
            raise ValueError(
                "lstm_backend='scan' names the plain PyTorch versions, which "
                "the port runs only on the CPU; use 'auto' or 'pallas'"
            )
        dev = resolve_device(device)
        return cls(
            cfg.obs_shape, cfg.action_dim, cfg.hidden_dim, cfg.learning_steps,
            cfg.forward_steps, cfg.encoder, cfg.encoder_depth, cfg.fused_sequence,
            generator=generator,
        ).to(dev)

    # ----------------------------------------------------------------- util

    def _core_input(self, obs, last_action, last_reward):
        """(N, *obs) uint8, (N,) int, (N,) float -> (N, latent+A+1)."""
        x = obs.float() / 255.0
        latent = self.enc(x)
        onehot = F.one_hot(last_action.long(), self.action_dim).float()
        reward = last_reward.float()[:, None]
        return torch.cat([latent, onehot, reward], dim=-1)

    def _dueling(self, h: torch.Tensor) -> torch.Tensor:
        h = h.float()
        adv = self.adv_out(F.relu(self.adv_hidden(h)))
        val = self.val_out(F.relu(self.val_hidden(h)))
        return val + adv - adv.mean(dim=-1, keepdim=True)

    # ------------------------------------------------------------------ act

    def act(self, obs, last_action, last_reward, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        x = self._core_input(obs, last_action, last_reward)
        h, carry = self.core.step(x, carry)
        return self._dueling(h), carry

    def act_select(self, obs, last_action, last_reward, carry: Carry, explore, random_actions):
        """Core step + dueling + ε-greedy select: (q (B,A) f32, action (B,)
        int32, carry). The ε coin and random draws are inputs (host numpy
        stream, see ops/act_tail.py)."""
        q, carry = self.act(obs, last_action, last_reward, carry)
        return q, epsilon_greedy_actions(q, explore, random_actions), carry

    # --------------------------------------------------------------- unroll

    def unroll(self, obs, last_action, last_reward, hidden, burn_in, learning, forward):
        """(B,T,*obs) uint8, (B,T), (B,T), (B,2,H), (B,) x3 ->
        (q_learn (B,L,A), q_boot (B,L,A), mask (B,L) f32)."""
        B, T = obs.shape[:2]
        L, Fw = self.learning_steps, self.forward_steps
        x = self._core_input(
            obs.reshape(B * T, *obs.shape[2:]),
            last_action.reshape(B * T),
            last_reward.reshape(B * T),
        ).reshape(B, T, -1)
        carry = (hidden[:, 0], hidden[:, 1])
        if self.fused_sequence:
            outs, _ = self.core(x, carry, burn_in=burn_in)
        else:
            outs, _ = self.core(x, carry)

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
        return self._dueling(learn_h), self._dueling(boot_h), mask

    forward = unroll


def initial_carry(batch: int, hidden_dim: int, device="cuda") -> Carry:
    """Zero (h, c) — the episode-start state."""
    z = torch.zeros((batch, hidden_dim), dtype=torch.float32, device=resolve_device(device))
    return z, z.clone()


def init_params(cfg: R2D2Config, seed: int = 0, device="cuda") -> R2D2Network:
    """A network with parameters drawn from an explicit torch.Generator
    seeded with `seed` (the same distributions as the flax init; not the
    same numbers)."""
    gen = torch.Generator().manual_seed(seed)
    return R2D2Network.from_config(cfg, generator=gen, device=device)
