"""Learner: the double-Q, value-rescaled, prioritized update (port of
r2d2_tpu/learner.py, host-batch path).

Per update: the online unroll (one fused forward launch, one seam-backward
launch through autograd) and the target unroll under ``torch.no_grad()``
(one forward launch).

- double-Q target: a* = argmax_a Q_online(s_{t+n}, a) with no gradient,
  evaluated by the target net; y = h(R_n + gamma_n * h^-1(Q_target)).
- IS-weighted masked MSE over the global count of valid learning steps.
- mixed per-sequence TD priorities, computed on the device.
- optimizer: a global-norm clip written out by hand — optax's
  ``clip_by_global_norm`` has no epsilon in its denominator, while
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 — then Adam with
  ``eps=cfg.adam_eps``. The cosine schedule is written out as well.
- target sync: the target parameters take the online ones every
  ``target_net_update_interval`` updates, inside the step.

PyTorch updates the networks and the optimizer state in place; the step
returns the same TrainState object.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config, resolve_device, set_fp32_numerics
from r2d2_tpu_torch.models.r2d2 import R2D2Network, init_params
from r2d2_tpu_torch.ops.act_tail import first_argmax
from r2d2_tpu_torch.ops.priority import mixed_td_priorities
from r2d2_tpu_torch.ops.value_rescale import inverse_value_rescale, value_rescale


class DeviceBatch(NamedTuple):
    """The device-side view of a replay SampledBatch."""

    obs: torch.Tensor            # (B, T, *obs_shape) uint8
    last_action: torch.Tensor    # (B, T) int64
    last_reward: torch.Tensor    # (B, T) float32
    hidden: torch.Tensor         # (B, 2, H) float32
    action: torch.Tensor         # (B, L) int64
    n_step_reward: torch.Tensor  # (B, L) float32
    gamma: torch.Tensor          # (B, L) float32
    burn_in_steps: torch.Tensor  # (B,) int32
    learning_steps: torch.Tensor # (B,) int32
    forward_steps: torch.Tensor  # (B,) int32
    is_weights: torch.Tensor     # (B,) float32

    @classmethod
    def from_sampled(cls, b, device) -> "DeviceBatch":
        def put(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if dtype is not None:
                t = t.to(dtype)
            return t.to(device, non_blocking=True)

        return cls(
            obs=put(b.obs),
            last_action=put(b.last_action, torch.int64),
            last_reward=put(b.last_reward, torch.float32),
            hidden=put(b.hidden, torch.float32),
            action=put(b.action, torch.int64),
            n_step_reward=put(b.n_step_reward, torch.float32),
            gamma=put(b.gamma, torch.float32),
            burn_in_steps=put(b.burn_in_steps, torch.int32),
            learning_steps=put(b.learning_steps, torch.int32),
            forward_steps=put(b.forward_steps, torch.int32),
            is_weights=put(b.is_weights, torch.float32),
        )


@dataclasses.dataclass
class TrainState:
    net: R2D2Network          # online network (trained)
    target_net: R2D2Network   # target network (no gradients)
    optimizer: torch.optim.Optimizer
    step: int = 0             # updates applied so far


def lr_at(cfg: R2D2Config, count: int) -> float:
    """The learning rate of update number `count` (0-based): constant, or
    optax's cosine_decay_schedule over training_steps, holding at
    lr * lr_final_frac past the horizon."""
    if cfg.lr_schedule != "cosine":
        return cfg.lr
    steps = max(cfg.training_steps, 1)
    frac = min(count, steps) / steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return cfg.lr * ((1.0 - cfg.lr_final_frac) * cosine + cfg.lr_final_frac)


def make_optimizer(cfg: R2D2Config, params) -> torch.optim.Optimizer:
    """Adam(lr, eps=adam_eps); the clip before it is clip_by_global_norm_."""
    return torch.optim.Adam(params, lr=cfg.lr, eps=cfg.adam_eps)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g -> g / norm * max_norm when
    norm >= max_norm, with no epsilon. Returns the pre-clip norm. No host
    synchronisation: the choice is a select on the device."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def init_train_state(cfg: R2D2Config, device="cuda", seed=None) -> Tuple[R2D2Network, TrainState]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_numerics()
    net = init_params(cfg, cfg.seed if seed is None else seed, dev)
    target = copy.deepcopy(net).requires_grad_(False)
    return net, TrainState(net, target, make_optimizer(cfg, net.parameters()), 0)


def make_loss_fn(cfg: R2D2Config):
    """(net, target_net, batch, denom) -> (loss, (priorities, aux))."""
    eps = cfg.value_rescale_eps

    def loss_fn(net, target_net, b: DeviceBatch, denom):
        args = (b.obs, b.last_action, b.last_reward, b.hidden,
                b.burn_in_steps, b.learning_steps, b.forward_steps)
        q_learn, q_boot_online, mask = net(*args)
        with torch.no_grad():
            _, q_boot_target, _ = target_net(*args)
            # double-Q: online selects, target evaluates
            a_star = first_argmax(q_boot_online.detach())
            q_tgt = torch.gather(q_boot_target, -1, a_star[..., None].long())[..., 0]
            y = value_rescale(
                b.n_step_reward + b.gamma * inverse_value_rescale(q_tgt, eps), eps
            )
        q_taken = torch.gather(q_learn, -1, b.action[..., None])[..., 0]
        td = y - q_taken
        w = b.is_weights[:, None]
        loss = torch.sum(w * torch.square(td) * mask) / denom

        with torch.no_grad():
            q_taken = q_taken.detach()
            abs_td = torch.abs(td.detach()) * mask
            priorities = mixed_td_priorities(abs_td, mask, cfg.td_mix_eta)
            aux = {
                "q_mean": torch.sum(q_taken * mask) / denom,
                "target_mean": torch.sum(y * mask) / denom,
                "td_abs_mean": torch.sum(abs_td) / denom,
            }
        return loss, (priorities, aux)

    return loss_fn


def make_train_step(cfg: R2D2Config):
    """(state, batch) -> (state, metrics, priorities); updates `state` in
    place. Metrics and priorities stay on the device."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, b: DeviceBatch):
        if cfg.zero_state_replay:
            b = b._replace(hidden=torch.zeros_like(b.hidden))
        denom = torch.clamp(b.learning_steps.sum().float(), min=1.0)
        params = list(state.net.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        loss, (priorities, aux) = loss_fn(state.net, state.target_net, b, denom)
        loss.backward()
        grads = [p.grad for p in params]
        g_norm = clip_by_global_norm_(grads, cfg.grad_norm)
        for group in state.optimizer.param_groups:
            group["lr"] = lr_at(cfg, state.step)
        state.optimizer.step()
        state.step += 1
        if state.step % cfg.target_net_update_interval == 0:
            with torch.no_grad():
                for t, p in zip(state.target_net.parameters(), params):
                    t.copy_(p)
        metrics = {"loss": loss.detach(), "grad_norm": g_norm, **aux}
        return state, metrics, priorities

    return train_step
