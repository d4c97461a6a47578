"""ε-greedy action selection after the dueling head.

Port of r2d2_tpu/ops/act_tail.py. The ε coin and the random actions are
inputs drawn by the caller from its numpy Generator, so the host RNG
stream matches the JAX package bit for bit. Ties go to the first maximal
action, as with `jnp.argmax` / `np.argmax`.
"""

from __future__ import annotations

import torch


def first_argmax(q: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, taking the first maximum on ties (int64).
    torch.argmax does not promise which tied index it returns; the first
    maximum is the smallest index whose value equals the maximum."""
    A = q.shape[-1]
    idx = torch.arange(A, device=q.device).expand_as(q)
    at_max = q == q.amax(dim=-1, keepdim=True)
    return torch.where(at_max, idx, A).amin(dim=-1)


def epsilon_greedy_actions(
    q: torch.Tensor,               # (B, A) float Q-values
    explore: torch.Tensor,         # (B,) bool ε-coin per row
    random_actions: torch.Tensor,  # (B,) integer uniform draws in [0, A)
) -> torch.Tensor:
    """(B,) int32 actions: argmax-Q, or the random draw where explore."""
    greedy = first_argmax(q).to(torch.int32)
    return torch.where(explore, random_actions.to(torch.int32), greedy)
