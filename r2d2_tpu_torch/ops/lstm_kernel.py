"""The fused LSTM sequence unroll: two hand-written Hopper kernels, their
plain PyTorch versions, and the autograd Function that joins them.

Port of the default arm of r2d2_tpu/ops/pallas_lstm.py:

- ``lstm_fwd`` — csrc/lstm_fwd.cu, replacing ``_fwd_kernel``: the fused
  T-step forward. ``proj_t (T,B,4H)`` (x @ Wi + b for every step, computed
  outside), ``wh (H,4H)``, ``h0, c0 (B,H)`` -> ``outs (T,B,H)``,
  ``cs (T,B,H)``.
- ``lstm_seq_bwd`` — csrc/lstm_seq_bwd.cu, replacing ``_seq_bwd_kernel``:
  the reverse walk with the per-row burn-in seam, -> ``dz (T,B,4H)``.
- ``lstm_seq_unroll`` — the ``torch.autograd.Function`` with the contract of
  ``pallas_lstm.lstm_seq_unroll``: one forward launch; in the backward the
  h_T cotangent folds into ``dout[-1]`` and the c_T cotangent seeds the cell
  carry, ``dproj = dz``, ``dWh = hprev^T @ dz`` as one matmul outside the
  kernel, zero tensors for ``dh0`` / ``dc0`` and no gradient for the seam.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises. There is no fallback from one to
the other. Each wrapper counts its kernel launches in ``launch_counts``.

Float32 only in this slice (bfloat16 is queued as M7).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

# kernel launches since the last reset_launch_counts(); a wrapper adds one
# where it launches its kernel and nowhere else
launch_counts: Dict[str, int] = {"lstm_fwd": 0, "lstm_seq_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _split_gates(z: torch.Tensor, H: int):
    i = torch.sigmoid(z[..., :H])
    f = torch.sigmoid(z[..., H : 2 * H])
    g = torch.tanh(z[..., 2 * H : 3 * H])
    o = torch.sigmoid(z[..., 3 * H :])
    return i, f, g, o


# --------------------------------------------------------------------------
# plain versions: the kernels' exact per-step math, masks and f32 carry
# --------------------------------------------------------------------------


def lstm_fwd_plain(proj_t, wh, h0, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    H = wh.shape[0]
    h, c = h0.float(), c0.float()
    outs, cs = [], []
    for t in range(proj_t.shape[0]):
        z = proj_t[t].float() + h.to(wh.dtype) @ wh
        i, f, g, o = _split_gates(z, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h.to(proj_t.dtype))
        cs.append(c)
    return torch.stack(outs), torch.stack(cs)


def lstm_seq_bwd_plain(dout, proj_t, hprev, cprev, cs, wh, dcT, burn) -> torch.Tensor:
    T, B, H = cs.shape
    burn = burn.reshape(B, 1)
    dh = torch.zeros((B, H), dtype=torch.float32, device=cs.device)
    dc = dcT.float()
    dz = [None] * T
    for t in reversed(range(T)):
        keep = t >= burn
        carry_keep = t > burn
        z = proj_t[t].float() + hprev[t].to(wh.dtype) @ wh
        i, f, g, o = _split_gates(z, H)
        tanh_c = torch.tanh(cs[t])
        dh_t = torch.where(keep, dout[t].float(), 0.0) + dh
        do = dh_t * tanh_c
        dc_t = dh_t * o * (1.0 - tanh_c * tanh_c) + dc
        di = dc_t * g
        df = dc_t * cprev[t]
        dg = dc_t * i
        dz_t = torch.cat(
            [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g), do * o * (1.0 - o)],
            dim=-1,
        )
        dz[t] = dz_t
        dh = torch.where(carry_keep, dz_t.to(wh.dtype) @ wh.T, 0.0)
        dc = torch.where(carry_keep, dc_t * f, 0.0)
    return torch.stack(dz)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel(name: str, n_ptrs: int):
    from r2d2_tpu_torch.ops import _build

    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + [_I, _I, _I, _P]
        fn.restype = _I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
    return fn, getattr(lib, f"{name}_error_string")


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, n_ptrs: int, tensors, T: int, B: int, H: int, device) -> None:
    fn, err_str = _kernel(name, n_ptrs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*(t.data_ptr() for t in tensors), T, B, H, stream)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {err_str(code).decode()} ({code})")
    launch_counts[name] += 1


def _device_of(t: torch.Tensor, op: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t.device}")
    return t.device


def lstm_fwd(proj_t, wh, h0, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outs (T,B,H) in proj dtype, cs (T,B,H) float32). Kernel on CUDA,
    plain version on the CPU; the same operand checks on both."""
    dev = _device_of(proj_t, "lstm_fwd")
    T, B, H4 = proj_t.shape
    H = H4 // 4
    f32 = torch.float32
    _check("proj_t", proj_t, (T, B, 4 * H), f32, dev)
    _check("wh", wh, (H, 4 * H), f32, dev)
    _check("h0", h0, (B, H), f32, dev)
    _check("c0", c0, (B, H), f32, dev)
    if dev.type == "cpu":
        return lstm_fwd_plain(proj_t, wh, h0, c0)
    outs = torch.empty((T, B, H), dtype=f32, device=dev)
    cs = torch.empty((T, B, H), dtype=f32, device=dev)
    _launch("lstm_fwd", 6, (proj_t, wh, h0, c0, outs, cs), T, B, H, dev)
    return outs, cs


def lstm_seq_bwd(dout, proj_t, hprev, cprev, cs, wh, dcT, burn) -> torch.Tensor:
    """dz (T,B,4H) float32 of the seam backward. Kernel on CUDA, plain
    version on the CPU; the same operand checks on both. `burn` is (B,)
    int32, 0 <= burn[b] < T."""
    dev = _device_of(cs, "lstm_seq_bwd")
    T, B, H = cs.shape
    f32 = torch.float32
    _check("dout", dout, (T, B, H), f32, dev)
    _check("proj_t", proj_t, (T, B, 4 * H), f32, dev)
    _check("hprev", hprev, (T, B, H), f32, dev)
    _check("cprev", cprev, (T, B, H), f32, dev)
    _check("cs", cs, (T, B, H), f32, dev)
    _check("wh", wh, (H, 4 * H), f32, dev)
    _check("dcT", dcT, (B, H), f32, dev)
    _check("burn", burn, (B,), torch.int32, dev)
    if dev.type == "cpu":
        return lstm_seq_bwd_plain(dout, proj_t, hprev, cprev, cs, wh, dcT, burn)
    # the carry product reads wh^T row by row: one contiguous copy per call
    whT = wh.t().contiguous()
    dz = torch.empty((T, B, 4 * H), dtype=f32, device=dev)
    _launch(
        "lstm_seq_bwd", 10,
        (dout, proj_t, hprev, cprev, cs, wh, whT, dcT, burn, dz), T, B, H, dev,
    )
    return dz


# --------------------------------------------------------------------------
# autograd op
# --------------------------------------------------------------------------


class _SeqUnroll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj_t, wh, h0, c0, burn_in):
        outs, cs = lstm_fwd(proj_t, wh, h0, c0)
        ctx.save_for_backward(proj_t, wh, h0, c0, burn_in, outs)
        ctx.cs = cs
        return outs, outs[-1].float().clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, douts, dhT, dcT):
        proj_t, wh, h0, c0, burn_in, outs = ctx.saved_tensors
        cs = ctx.cs
        T, B, H = cs.shape
        # a fresh contiguous copy: the incoming cotangent may be a strided
        # view (the caller transposes outs to batch-major)
        douts = douts.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        douts[-1] += dhT.float()
        hprev = torch.cat([h0.to(outs.dtype)[None], outs[:-1]], dim=0)
        cprev = torch.cat([c0.float()[None], cs[:-1]], dim=0)
        dz = lstm_seq_bwd(
            douts, proj_t, hprev, cprev, cs, wh, dcT.float().contiguous(),
            burn_in.to(torch.int32).contiguous(),
        )
        dproj = dz.to(proj_t.dtype)
        # dz is exactly zero below each row's seam, so burn-in steps drop
        # out of the weight gradient too: (H, T*B) @ (T*B, 4H)
        dwh = (hprev.reshape(T * B, H).float().T @ dz.reshape(T * B, 4 * H)).to(wh.dtype)
        return dproj, dwh, torch.zeros_like(h0), torch.zeros_like(c0), None


def lstm_seq_unroll(proj_t, wh, h0, c0, burn_in):
    """Fused burn-in + train unroll with a per-row stop-gradient seam.

    Returns (outs (T,B,H), (h_T, c_T)). Gradients do not flow into steps
    t < burn_in[b] of row b, and d h0 / d c0 are zero tensors. Contract:
    0 <= burn_in[b] < T."""
    outs, hT, cT = _SeqUnroll.apply(proj_t, wh, h0, c0, burn_in)
    return outs, (hT, cT)


# --------------------------------------------------------------------------
# backward-arm selection (pure Python; pallas_lstm.py:793-872)
# --------------------------------------------------------------------------

_ITEMSIZE = {"float32": 4, "bfloat16": 2, torch.float32: 4, torch.bfloat16: 2}


def seq_backward_residual_bytes(T: int, B: int, H: int, proj_dtype,
                                ckpt_every: int = 0) -> dict:
    """Carry-residual footprint of each backward arm, in bytes: the full h
    (proj dtype) and c (f32) sequences, or N = T/ckpt_every boundary
    carries of each under the checkpointed arm."""
    itemsize = _ITEMSIZE[proj_dtype]
    n = T // ckpt_every if ckpt_every else T
    return {
        "h_residual_bytes": n * B * H * itemsize,
        "c_residual_bytes": n * B * H * 4,
        "carry_residual_bytes": n * B * H * (itemsize + 4),
    }


def choose_backward_arm(
    T: int, B: int, H: int, proj_dtype, budget_bytes: int, mode: str = "auto"
) -> Tuple[str, int]:
    """(arm, ckpt_stride) from a peak-residual-bytes budget, exactly as
    ``pallas_lstm.choose_backward_arm``: "auto" walks default (carries +
    f32 dz), then fused_dwh (carries + proj-dtype dz), then ckpt with the
    smallest divisor stride S >= 2 of T that fits (else the largest)."""
    itemsize = _ITEMSIZE[proj_dtype]
    dz_f32 = T * B * 4 * H * 4
    dz_proj = T * B * 4 * H * itemsize
    carry_full = seq_backward_residual_bytes(T, B, H, proj_dtype)["carry_residual_bytes"]

    def ckpt_stride() -> int:
        divisors = [s for s in range(2, T + 1) if T % s == 0]
        for s in divisors:
            peak = (
                seq_backward_residual_bytes(T, B, H, proj_dtype, s)["carry_residual_bytes"]
                + dz_proj
            )
            if peak <= budget_bytes:
                return s
        return divisors[-1] if divisors else T

    if mode == "default":
        return ("default", 0)
    if mode == "fused_dwh":
        return ("fused_dwh", 0)
    if mode == "ckpt":
        return ("ckpt", ckpt_stride())
    if mode != "auto":
        raise ValueError(f"unknown backward-arm mode {mode!r}")
    if carry_full + dz_f32 <= budget_bytes:
        return ("default", 0)
    if carry_full + dz_proj <= budget_bytes:
        return ("fused_dwh", 0)
    return ("ckpt", ckpt_stride())
