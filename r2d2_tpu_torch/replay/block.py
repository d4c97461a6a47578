"""Block — the unit of replay storage (port of r2d2_tpu/replay/block.py).

`last_action` is a scalar uint8 index (one-hot expansion happens on the
device); per-sequence step counters are int32. Stored recurrent carries
are in the config's ``state_dtype``: float32, or under precision="bf16"
bfloat16 kept on the host as its uint16 bit patterns (numpy has no
bfloat16), the bits the JAX package's ml_dtypes store holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def state_host_dtype(state_dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that holds carries of `state_dtype` on the host."""
    return np.dtype(np.uint16 if state_dtype == torch.bfloat16 else np.float32)


def to_state_host(x, state_dtype: torch.dtype) -> np.ndarray:
    """Carries (a numpy array or a tensor of any float dtype, or uint16 bf16
    bits) as host storage of `state_dtype`: float32, or the bits of the
    value rounded to the nearest bfloat16 (ties to even), as the JAX
    package's float32 -> ml_dtypes.bfloat16 store rounds."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16 and state_dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.uint16)
        x = x.float().numpy()
    x = np.asarray(x)
    if x.dtype == np.uint16:
        if state_dtype != torch.bfloat16:
            raise TypeError("uint16 carries are bf16 bits, but the state dtype is float32")
        return x
    if state_dtype != torch.bfloat16:
        return np.asarray(x, dtype=np.float32)
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def state_tensor(x: np.ndarray) -> torch.Tensor:
    """Host carry storage as a tensor: float32 as it is, uint16 bf16 bits
    viewed as bfloat16 (no copy of the values, no rounding)."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@dataclasses.dataclass
class Block:
    # (stored_steps, *obs_shape) uint8; stored_steps = burn_in_steps[0] +
    # sum(learning_steps) + 1 (trailing seed entry for the next window)
    obs: np.ndarray
    last_action: np.ndarray    # (stored_steps,) uint8
    last_reward: np.ndarray    # (stored_steps,) float32
    action: np.ndarray         # (T,) uint8 action taken at each learning step
    n_step_reward: np.ndarray  # (T,) float32 n-step return
    gamma: np.ndarray          # (T,) float32 bootstrap discount, 0 past a terminal
    # (num_sequences, 2, hidden_dim) (h, c) at each sequence's TRUE
    # replay-window start, host storage of the state dtype (state_host_dtype)
    hidden: np.ndarray
    num_sequences: int
    burn_in_steps: np.ndarray  # (num_sequences,) int32
    learning_steps: np.ndarray
    forward_steps: np.ndarray
    # the task id of the actor that collected the block (multi-task plane);
    # one per block, broadcast per sequence by the stores; 0 on single-task
    task: int = 0

    @property
    def stored_steps(self) -> int:
        return len(self.obs)


# The per-step fields a demoted block carries in its disk-segment record, in
# record order (replay/disk_tier.py sizes and parses its fixed-geometry slots
# by them). The per-sequence metadata (carries, spans) stays in memory for
# disk slots: the control plane samples demoted sequences without touching
# a segment.
DISK_FIELDS = (
    "obs", "last_action", "last_reward", "action", "n_step_reward", "gamma",
)


def disk_field_specs(cfg):
    """Per-slot (shape, dtype) of every disk-segment record field, in
    DISK_FIELDS order: the host slab's dtypes (uint8 actions), so a spilled
    row round-trips bit for bit."""
    slot, bl = cfg.block_slot_len, cfg.block_length
    return {
        "obs": ((slot, *cfg.obs_shape), np.uint8),
        "last_action": ((slot,), np.uint8),
        "last_reward": ((slot,), np.float32),
        "action": ((bl,), np.uint8),
        "n_step_reward": ((bl,), np.float32),
        "gamma": ((bl,), np.float32),
    }


def store_field_specs(cfg):
    """Per-slot (shape, torch dtype) of every device-store field, without
    the leading block axis (r2d2_tpu/replay/block.py's function of the same
    name): the dtypes of the JAX package's device store, so a device
    snapshot is one file for both packages."""
    S, slot, bl = cfg.seqs_per_block, cfg.block_slot_len, cfg.block_length
    return {
        "obs": ((slot, *cfg.obs_shape), torch.uint8),
        "last_action": ((slot,), torch.int32),
        "last_reward": ((slot,), torch.float32),
        "action": ((bl,), torch.int32),
        "n_step_reward": ((bl,), torch.float32),
        "gamma": ((bl,), torch.float32),
        # the config's state dtype: float32, or bfloat16 under precision="bf16"
        "hidden": ((S, 2, cfg.hidden_dim), cfg.state_dtype),
        "burn_in": ((S,), torch.int32),
        "learning": ((S,), torch.int32),
        "forward": ((S,), torch.int32),
    } | (
        # per-sequence task ids, only on multi-task configs: the
        # single-task layout (and its snapshots) stays as it was
        {"task": ((S,), torch.int32)} if cfg.num_tasks > 1 else {}
    )
