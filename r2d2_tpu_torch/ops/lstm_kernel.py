"""The fused LSTM unroll: five hand-written Hopper kernels, their plain
PyTorch versions, and the autograd Functions that join them.

Port of r2d2_tpu/ops/pallas_lstm.py, one CUDA source per Pallas kernel:

- ``lstm_fwd`` — csrc/lstm_fwd.cu, replacing ``_fwd_kernel``: the fused
  T-step forward. ``proj_t (T,B,4H)`` (x @ Wi + b for every step, computed
  outside), ``wh (H,4H)``, ``h0, c0 (B,H)`` -> ``outs (T,B,H)``,
  ``cs (T,B,H)``.
- ``lstm_seq_bwd`` — csrc/lstm_seq_bwd.cu, replacing ``_seq_bwd_kernel``:
  the reverse walk with the per-row burn-in seam, -> ``dz (T,B,4H)``.
- ``lstm_bwd`` — csrc/lstm_bwd.cu, replacing ``_bwd_kernel``: the reverse
  walk with no seam, -> ``dz`` and the real ``dh0, dc0 (B,H)``.
- ``lstm_seq_bwd_fused`` — csrc/lstm_seq_bwd_fused.cu, replacing
  ``_seq_bwd_fused_kernel``: the seam walk with ``dWh = sum_t
  h_{t-1}^T @ dz_t`` formed inside the kernel, -> ``dz``, ``dwh``.
- ``lstm_seq_bwd_ckpt`` — csrc/lstm_seq_bwd_ckpt.cu, replacing
  ``_seq_bwd_ckpt_kernel``: per S-step segment, newest first, the forward
  recomputed from the segment's checkpointed carry, then the seam walk
  with the in-kernel dWh, -> ``dz``, ``dwh``.

Each splits the hidden units across the SMs in one cooperative launch
(csrc/column_split.cuh; the backward ones share its reverse walk);
``lstm_geometry`` decides the split, and walks a batch wider than a block
in row chunks inside each step. ``lstm_seq_bwd_fused`` runs
``lstm_seq_bwd``'s walk in the same geometry, so its dz is
``lstm_seq_bwd``'s bit for bit on the card (in bf16: its float32 dz
rounded; ``lstm_geometry`` gives the two bf16 forms one split).

Dtypes. Every kernel takes float32, and also bfloat16 operands where the
Pallas kernels do under bf16 compute (proj, wh, and h0/c0, hprev or
h_ckpt), each through its own bf16 kernel form (``<name>_bf16``, counted
under that key), with the Pallas kernels' casts: products of bf16 values
summed in float32, the (h, c) carry and c residuals in float32, outs (and
K4's and K5's dz) in the proj dtype, K2's and K3's dz (and K3's dh0, dc0)
in float32. K4 and K5 sum dWh from the unrounded float32 dz (their bf16
forms from its two bf16 planes, ``bf16(dz)`` and ``bf16(dz - bf16(dz))``).
All five bf16 forms run their products on the tensor cores (``mma.sync``,
``TENSOR_CORE``), every float32 form on the FMA units.

The autograd Functions carry the contracts of the JAX custom-VJP ops:
``lstm_unroll`` (no seam, real d h0 / d c0), ``lstm_seq_unroll`` (default
arm: dWh as one matmul outside the kernel), ``lstm_seq_unroll_fused_dwh``
and ``lstm_seq_unroll_ckpt(S)`` (the two other backward arms). In every
backward the h_T cotangent folds into ``dout[-1]`` and the c_T cotangent
seeds the cell carry.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises. There is no fallback from one to
the other. Each wrapper counts its kernel launches in ``launch_counts``,
and every call of its form, on any device, in ``dispatch_counts`` (the
graph checks hold the two equal on the card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

# the kernel sources (csrc/<name>.cu), each with its C arguments:
# (pointers, ints), then the stream
_SOURCE_SIGNATURES = {
    "lstm_fwd": (8, 10),             # ..., barrier, T, B, H, then the Geometry
    "lstm_seq_bwd": (12, 10),
    "lstm_bwd": (13, 10),
    "lstm_seq_bwd_fused": (14, 11),  # ..., barrier, T, B, H, W, then the Geometry
    "lstm_seq_bwd_ckpt": (15, 11),   # ..., barrier, T, B, H, S, then the Geometry
}
SOURCES = tuple(_SOURCE_SIGNATURES)
# the bf16 forms: the same source and C arguments, entry point <name>_launch
BF16_FORMS = tuple(f"{n}_bf16" for n in SOURCES)
_SOURCE = {**{n: n for n in SOURCES}, **{n: n[: -len("_bf16")] for n in BF16_FORMS}}
_SIGNATURES = {n: _SOURCE_SIGNATURES[src] for n, src in _SOURCE.items()}
# every kernel form a wrapper launches
KERNELS = SOURCES + BF16_FORMS

# kernel launches since the last reset_launch_counts(); a wrapper adds one
# where it launches its kernel and nowhere else
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
# calls of each kernel form since the last reset_launch_counts(), on any
# device: a wrapper adds one per call, whether it then runs the plain
# version (CPU) or launches (CUDA); on the card it equals launch_counts
dispatch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    """Zero launch_counts and dispatch_counts."""
    for counts in (launch_counts, dispatch_counts):
        for k in counts:
            counts[k] = 0


def _split_gates(z: torch.Tensor, H: int):
    i = torch.sigmoid(z[..., :H])
    f = torch.sigmoid(z[..., H : 2 * H])
    g = torch.tanh(z[..., 2 * H : 3 * H])
    o = torch.sigmoid(z[..., 3 * H :])
    return i, f, g, o


# --------------------------------------------------------------------------
# plain versions: the kernels' exact per-step math, masks and f32 carry
# --------------------------------------------------------------------------


def _lo_dot(x, w):
    """x @ w in float32 with x rounded to w's dtype first: the exact
    products of w-dtype values (a product of two bf16 values is exact in
    f32) summed in f32, as jnp.dot(x.astype(w.dtype), w,
    preferred_element_type=f32). For float32 operands, x @ w."""
    return x.to(w.dtype).float() @ w.float()


def lstm_fwd_plain(proj_t, wh, h0, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    H = wh.shape[0]
    h, c = h0.float(), c0.float()
    outs, cs = [], []
    for t in range(proj_t.shape[0]):
        z = proj_t[t].float() + _lo_dot(h, wh)
        i, f, g, o = _split_gates(z, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h.to(proj_t.dtype))
        cs.append(c)
    return torch.stack(outs), torch.stack(cs)


def _bwd_step(dout_t, proj_tt, h_prev, c_prev, c_t, wh, dh, dc, keep=None, carry_keep=None):
    """One reverse step of every backward kernel: the gates recomputed from
    h_{t-1}, -> (dz_t, dh, dc) carried into step t-1. `keep` masks the
    step's output cotangent and `carry_keep` cuts the carry (the seam);
    None means no seam. dz_t is float32; the carry product takes it
    rounded to wh's dtype."""
    H = wh.shape[0]
    z = proj_tt.float() + _lo_dot(h_prev, wh)
    i, f, g, o = _split_gates(z, H)
    tanh_c = torch.tanh(c_t)
    d_out = dout_t.float()
    if keep is not None:
        d_out = torch.where(keep, d_out, 0.0)
    dh_t = d_out + dh
    do = dh_t * tanh_c
    dc_t = dh_t * o * (1.0 - tanh_c * tanh_c) + dc
    di = dc_t * g
    df = dc_t * c_prev
    dg = dc_t * i
    dz_t = torch.cat(
        [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g), do * o * (1.0 - o)],
        dim=-1,
    )
    dh = _lo_dot(dz_t, wh.T)
    dc = dc_t * f
    if carry_keep is not None:
        dh = torch.where(carry_keep, dh, 0.0)
        dc = torch.where(carry_keep, dc, 0.0)
    return dz_t, dh, dc


def lstm_seq_bwd_plain(dout, proj_t, hprev, cprev, cs, wh, dcT, burn) -> torch.Tensor:
    T, B, H = cs.shape
    burn = burn.reshape(B, 1)
    dh = torch.zeros((B, H), dtype=torch.float32, device=cs.device)
    dc = dcT.float()
    dz = [None] * T
    for t in reversed(range(T)):
        dz[t], dh, dc = _bwd_step(dout[t], proj_t[t], hprev[t], cprev[t], cs[t], wh, dh, dc,
                                  t >= burn, t > burn)
    return torch.stack(dz)


def lstm_bwd_plain(dout, proj_t, hprev, cprev, cs, wh, dcT):
    """(dz, dh0, dc0): the reverse walk with no seam; after step 0 the
    carry holds the initial state's cotangents."""
    T, B, H = cs.shape
    dh = torch.zeros((B, H), dtype=torch.float32, device=cs.device)
    dc = dcT.float()
    dz = [None] * T
    for t in reversed(range(T)):
        dz[t], dh, dc = _bwd_step(dout[t], proj_t[t], hprev[t], cprev[t], cs[t], wh, dh, dc)
    return torch.stack(dz), dh, dc


def lstm_seq_bwd_fused_plain(dout, proj_t, hprev, cprev, cs, wh, dcT, burn):
    """(dz in proj dtype, dwh f32): the seam walk, adding h_{t-1}^T @ dz_t
    into dWh at every step."""
    T, B, H = cs.shape
    burn = burn.reshape(B, 1)
    dh = torch.zeros((B, H), dtype=torch.float32, device=cs.device)
    dc = dcT.float()
    dwh = torch.zeros((H, 4 * H), dtype=torch.float32, device=cs.device)
    dz = [None] * T
    for t in reversed(range(T)):
        dz_t, dh, dc = _bwd_step(dout[t], proj_t[t], hprev[t], cprev[t], cs[t], wh, dh, dc,
                                 t >= burn, t > burn)
        dwh += hprev[t].float().T @ dz_t
        dz[t] = dz_t.to(proj_t.dtype)
    return torch.stack(dz), dwh


def lstm_seq_bwd_ckpt_plain(dout, proj_t, h_ckpt, c_ckpt, wh, dcT, burn, S: int):
    """(dz in proj dtype, dwh f32) from the N = T/S segment-entry carries:
    per segment, newest first, the forward recomputed from its checkpoint,
    then the seam walk on the real step index with dWh added per step. The
    recomputed h is used as the forward's outs are, rounded to the proj
    dtype; dWh sums the f32 dz, before it is rounded."""
    T, B, H = dout.shape
    burn = burn.reshape(B, 1)
    dh = torch.zeros((B, H), dtype=torch.float32, device=dout.device)
    dc = dcT.float()
    dwh = torch.zeros((H, 4 * H), dtype=torch.float32, device=dout.device)
    dz = [None] * T
    for seg in reversed(range(T // S)):
        base = seg * S
        outs, cs = lstm_fwd_plain(proj_t[base : base + S], wh, h_ckpt[seg], c_ckpt[seg])
        hs = torch.cat([h_ckpt[seg].float()[None], outs.float()])
        cs = torch.cat([c_ckpt[seg].float()[None], cs])
        for s in reversed(range(S)):
            t = base + s
            dz_t, dh, dc = _bwd_step(dout[t], proj_t[t], hs[s], cs[s], cs[s + 1], wh, dh, dc,
                                     t >= burn, t > burn)
            dwh += hs[s].T @ dz_t
            dz[t] = dz_t.to(proj_t.dtype)
    return torch.stack(dz), dwh


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel(name: str):
    """The C entry point <name>_launch of kernel form `name` (built from
    csrc/<source>.cu) and its source's error-string function."""
    from r2d2_tpu_torch.ops import _build

    src = _SOURCE[name]
    lib = _build.load(src)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        n_ptrs, n_ints = _SIGNATURES[name]
        fn.argtypes = [_P] * n_ptrs + [_I] * n_ints + [_P]
        fn.restype = _I
        err = getattr(lib, f"{src}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
    return fn, getattr(lib, f"{src}_error_string")


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, tensors, ints, device) -> None:
    """Launch kernel form `name` on the current stream; a None tensor is a
    null pointer (a workspace the geometry does not need)."""
    if (len(tensors), len(ints)) != _SIGNATURES[name]:
        raise TypeError(f"{name} takes {_SIGNATURES[name]} (pointers, ints)")
    fn, err_str = _kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*(0 if t is None else t.data_ptr() for t in tensors), *ints, stream)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {err_str(code).decode()} ({code})")
    launch_counts[name] += 1


def _device_of(t: torch.Tensor, op: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t.device}")
    return t.device


# the dtypes of the operands that the Pallas kernels take in the compute
# dtype (proj, wh, and h0/c0, hprev or h_ckpt); the f32 ones stay f32
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _compute_dtype(proj_t: torch.Tensor, op: str) -> torch.dtype:
    if proj_t.dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{op}: proj_t has dtype {proj_t.dtype}, the kernels take "
                        f"{COMPUTE_DTYPES}")
    return proj_t.dtype


def _form(name: str, dtype: torch.dtype) -> str:
    """The kernel form of source `name` for compute dtype `dtype`."""
    return name if dtype == torch.float32 else f"{name}_bf16"


def _check_walk(dout, proj_t, hprev, cprev, cs, wh, dcT, dev, dt) -> None:
    """The operands every reverse walk over saved (T,B,H) residuals takes:
    proj_t, hprev and wh in the compute dtype `dt`, the rest float32."""
    T, B, H = cs.shape
    f32 = torch.float32
    _check("dout", dout, (T, B, H), f32, dev)
    _check("proj_t", proj_t, (T, B, 4 * H), dt, dev)
    _check("hprev", hprev, (T, B, H), dt, dev)
    _check("cprev", cprev, (T, B, H), f32, dev)
    _check("cs", cs, (T, B, H), f32, dev)
    _check("wh", wh, (H, 4 * H), dt, dev)
    _check("dcT", dcT, (B, H), f32, dev)


# the column-split kernels (csrc/column_split.cuh), all five: K1 and the
# reverse walk's K2, K3, K4 and K5 (K4 and K5 also stage their dWh tiles
# in the walk's buffers)
COLUMN_SPLIT = SOURCES
# the kernels with a dWh pass (K5: Walk::add_dwh, in bf16 Walk::add_dwh_tc;
# K4: Walk::add_dwh_window, in the same buffers, in bf16 cut into 2
# stages, so a stage of its holds at least twice the rows counted here)
_DWH_PASS = ("lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt")
# the tensor-core forms whose split leaves room for that pass's stage: K4
# and K5, and K2, so that K4-bf16 walks in K2-bf16's split (its dz is
# K2-bf16's f32 dz rounded, bit for bit)
_DWH_STAGE = ("lstm_seq_bwd",) + _DWH_PASS

# at most this many threads per block (and the most the slices of a block's
# items are widened to), the widest tile of h (or dz) columns staged in
# shared memory at once, the bytes of padding of a staged row (kVec
# elements) and the tiles in the copy pipeline (kStages)
_MAX_THREADS = 512
_SLICED_THREADS = 256
_MAX_K_TILE = 128
_ROW_PAD_BYTES = 16
_STAGES = 4
# the bulk ring's mbarriers, a full and an empty one a stage: K1 keeps them
# in shared memory of their own (the walk, in a row padding of wh's rows)
_RING_BARRIER_BYTES = 16 * _STAGES

# the sources whose bf16 forms run their products on the tensor cores: all
# five (column_split.cuh: mma.sync m16n8k16, rows of 16, warp tiles of 16 x
# 16 gate columns and 16 x 8 carry units, at most _MAX_WARP_TILES a warp;
# the dWh pass of K4 and K5 _DWH_TILES tiles of 16 dWh rows x 16 gate
# columns a warp)
TENSOR_CORE = ("lstm_fwd", "lstm_seq_bwd", "lstm_bwd", "lstm_seq_bwd_fused",
               "lstm_seq_bwd_ckpt")
_MMA_ROWS = 16
_MAX_WARP_TILES = 2
_DWH_TILES = 8
# their thread ceiling (column_split.cuh kMaxThreadsTC): a thread may keep
# up to 255 registers; and their widest k-tile (fewer, longer pipeline
# tiles per step)
_MAX_THREADS_TC = 256
_MAX_K_TILE_TC = 256


def tensor_cores(kernel: str, itemsize: int) -> bool:
    """Whether the form of `kernel` for operands of `itemsize` bytes runs
    its products on the tensor cores (all five bf16 forms)."""
    return kernel in TENSOR_CORE and itemsize == 2


def tensor_core_layout(units: int) -> Tuple[int, int]:
    """(gate columns, carry units) of a tensor-core form's block product at
    `units` hidden units per block (a multiple of 4): the 4 x units gate
    columns, a multiple of 16, and the units padded to 8 for the carry's
    n8 tiles."""
    return 4 * units, 8 * -(-units // 8)


class Geometry(NamedTuple):
    """How a column-split kernel cuts its work, passed to it as ints."""

    units: int       # hidden units per block (Hb); the last block may own fewer
    grid: int        # blocks, all resident at once (a cooperative launch)
    threads: int     # per block: row groups x Hb items, times the k-slices
    k_tile: int      # columns of h (or dz) staged per tile
    pinned: bool     # the block's wh slice stays in shared memory all launch
    smem_bytes: int  # dynamic shared memory per block
    rows: int        # batch rows per chunk (a multiple of 4); the batch padded
                     # to 4 when one chunk holds it

    def chunks(self, B: int) -> int:
        return -(-B // self.rows)


def _dwh_tile_rows(H: int, units: int, threads: int, kt: int, pinned: bool, Bc: int,
                   Hbp: int, itemsize: int = 4) -> int:
    """Rows of (h, dz) that one stage of the FMA dWh pass (the float32
    forms of K4 and K5) holds (column_split.cuh, ``Walk::add_dwh``): the
    staging tiles, and when wh is streamed also its tile buffers, cut in
    _STAGES; a row is kc h values of `itemsize` bytes and the unit-major
    f32 dz columns, each padded."""
    vec = _ROW_PAD_BYTES // itemsize
    k_chunk = min(H, 4 * (threads // units) // vec * vec)
    if k_chunk == 0:  # fewer k rows per pass than one 16-byte copy holds
        return 0
    row = (k_chunk + vec) * itemsize + (4 * units + 4) * 4
    region = _STAGES * Bc * (kt * itemsize + _ROW_PAD_BYTES)
    if not pinned:
        region += _STAGES * (kt * 4 * units + Hbp * kt) * itemsize + _STAGES * Hbp * _ROW_PAD_BYTES
    return ((region // _STAGES) & ~15) // row


def _warp_slices(tiles: int, warps: int) -> int:
    """The k-slices of a product of `tiles` warp tiles over `warps` warps
    (column_split.cuh, ``Warps``)."""
    per_warp = -(-tiles // warps)
    return warps // -(-tiles // per_warp)


def _dwh_tc_tile_rows(H: int, units: int, threads: int, kt: int, pinned: bool,
                      rows: int) -> int:
    """Rows m of (h, hi, lo) that one stage of the bf16 dWh pass of K4 and
    K5 holds (``Walk::add_dwh_tc``), a multiple of 16: a warp's _DWH_TILES
    tiles are 16/kNW k16 rows by kNW n16 columns (kNW = 4, 2 or 1, the
    most that divides the block's n16 columns); a pass's k columns are the
    warps' k groups (over its n groups) x their k16 rows, at most H padded
    to 16; a row is that many h values and both planes' 4 units + 8
    columns, bf16.
    The stages share the walk's tile buffers: its staging tiles where wh
    is pinned (its slice stays), else also its gate-column and row tiles."""
    nb = units // 4
    nw = 4 if nb % 4 == 0 else 2 if nb % 2 == 0 else 1
    warps = threads // 32
    kgp = warps // min(nb // nw, warps)
    kc = min(kgp * _DWH_TILES // nw * 16, 16 * -(-H // 16))
    row = 2 * (kc + 8 + 2 * (4 * units + 8))
    pad = _ROW_PAD_BYTES // 2
    region = _STAGES * rows * (kt + pad)
    if not pinned:
        region += _STAGES * (kt * (4 * units + pad) + tensor_core_layout(units)[1] * (kt + pad))
    stage = (2 * region // _STAGES) & ~15
    return stage // row // 16 * 16


def _tensor_core_geometry(B: int, H: int, backward: bool, num_sms: int, smem_limit: int,
                          max_threads: int, max_rows, dwh: bool) -> Geometry:
    """lstm_geometry of a tensor-core form (a bf16 form). Hb is
    ceil(H / SMs) rounded up to 4, so each gate's Hb columns of a wh row
    come in whole 8- or 16-byte copies; chunks are whole m16 tiles of rows;
    the k-tile a multiple of 16, the widest that fits (wh streamed before
    a narrower tile); the threads whole warps, at most _MAX_THREADS_TC, at
    least one per row group and unit (the epilogue's owners) and enough
    that no warp holds more than _MAX_WARP_TILES tiles, widened to one warp
    per tile where the ceiling allows. Shared memory: the staging tiles;
    the gate columns in rows of 4Hb + 8 (pinned: H padded to 16 rows); for
    the walk also wh's Hbp rows and, with one chunk, the dh carry; and the
    slices' planes of f32 sums, rows of N + 1, for the larger of the two
    products. With `dwh` (K4's and K5's forms, and K2's, so that it gets
    K4's split) a stage of the dWh pass, in the tile buffers, must also
    hold a 16-row tile (``_dwh_tc_tile_rows``), with k-tiles wider than H
    tried last for that; K5's recompute takes the walk's gate product, so
    nothing else is added."""
    per_sm = -(-H // num_sms)
    units = 4 * -(-per_sm // 4)
    grid = -(-H // units)
    N, Hbp = tensor_core_layout(units)
    max_threads = min(max_threads, _MAX_THREADS_TC)
    if 4 * units > max_threads or max_threads < 32:
        raise ValueError(f"{units} units per block in rows of {_MMA_ROWS} need more than "
                         f"{max_threads} threads")
    k16 = 16 * -(-H // 16)
    widest = min(k16, _MAX_K_TILE_TC)
    tiles = [widest] + [k for k in (128, 64, 32, 16) if k < widest]
    if dwh:  # last, tiles wider than H: room for the dWh stage where H is a few units
        tiles += [k for k in (32, 64, 128, _MAX_K_TILE_TC) if k > widest]
    m_all = -(-B // _MMA_ROWS)
    tried = set()
    for n in range(1, m_all + 1):
        mt = -(-m_all // n)  # m16 tiles per chunk
        rows = _MMA_ROWS * mt
        if mt in tried or (max_rows is not None and rows > max_rows):
            continue
        tried.add(mt)
        gate_tiles, carry_tiles = mt * N // 16, mt * Hbp // 8
        most = max(gate_tiles, carry_tiles if backward else 0)
        need = max(rows // 4 * units, 32 * -(-most // _MAX_WARP_TILES))
        # a warp per tile where the ceiling allows (no k-slices beyond it)
        threads = max(32 * -(-need // 32), min(32 * most, max_threads // 32 * 32))
        if threads > max_threads:
            continue
        warps = threads // 32
        red = _warp_slices(gate_tiles, warps) * rows * (N + 1)
        if backward:
            red = max(red, _warp_slices(carry_tiles, warps) * rows * (Hbp + 1))
        one_chunk = rows >= B
        # the widest k-tile first, pinned where it fits: the pipeline's
        # tiles per step, not the bytes it streams, cost the most
        for kt in tiles:
            for pinned in (True, False):
                nbytes = _STAGES * rows * (kt * 2 + _ROW_PAD_BYTES) + 4 * red
                if backward and one_chunk:
                    nbytes += 4 * rows * units
                if not backward:
                    nbytes += _RING_BARRIER_BYTES
                if pinned:
                    nbytes += k16 * (N * 2 + _ROW_PAD_BYTES)
                    if backward:
                        nbytes += Hbp * (4 * H * 2 + _ROW_PAD_BYTES)
                else:
                    nbytes += _STAGES * kt * (N * 2 + _ROW_PAD_BYTES)
                    if backward:
                        nbytes += _STAGES * Hbp * (kt * 2 + _ROW_PAD_BYTES)
                if nbytes > smem_limit:
                    continue
                if dwh and _dwh_tc_tile_rows(H, units, threads, kt, pinned, rows) < _MMA_ROWS:
                    continue
                return Geometry(units, grid, threads, kt, pinned, nbytes, rows)
    raise ValueError(f"no tile of B={B}, H={H} fits {smem_limit} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def lstm_geometry(B: int, H: int, kernel: str, num_sms: int, smem_limit: int,
                  itemsize: int = 4, max_threads: int = _MAX_THREADS,
                  max_rows=None) -> Geometry:
    """The column split of `kernel` (one of COLUMN_SPLIT) on a card with
    `num_sms` SMs and `smem_limit` bytes of shared memory per block, for
    operands of `itemsize` bytes (4: float32, 2: bf16).

    Each block owns ``Hb = ceil(H / num_sms)`` hidden units (their four
    gate columns of wh, and for the reverse walk also their rows), so
    ``grid = ceil(H / Hb) <= num_sms``. A thread owns 4 rows x one unit's 4
    gates over one k-slice. The block walks the batch in the fewest row
    chunks whose ceil(rows/4) x Hb items fit `max_threads` and whose
    staging tiles fit; the items are split into the most k-slices that keep
    the block within 256 threads. The wh slice is pinned in shared memory
    where it fits beside the staging tiles, else streamed in k-tiles beside
    them; the tiles narrow until the shared memory fits (and, for K4 and
    K5, until a stage of their dWh pass holds a row). Where one chunk holds
    the batch the walk's dh carry sits in shared memory; with more, both
    carries go to a global workspace.
    `max_rows`, where given, caps the rows per chunk.

    The tensor-core forms (``tensor_cores``: every bf16 form) take their
    own layout (``_tensor_core_geometry``): units a multiple of 4, chunks
    of whole 16-row tiles, k-tiles a multiple of 16, threads in whole
    warps.
    Raises ValueError where no tile fits even a chunk of 4 rows, or H is
    not a multiple of 16 bytes of the operands (the kernels copy 16-byte
    rows)."""
    if kernel not in COLUMN_SPLIT:
        raise ValueError(f"{kernel!r} is not a column-split kernel: {COLUMN_SPLIT}")
    if itemsize not in (2, 4):
        raise ValueError(f"operands of {itemsize} bytes: the kernels take 4 (f32) or 2 (bf16)")
    vec = _ROW_PAD_BYTES // itemsize
    if H % vec:
        raise ValueError(f"hidden size {H} is not a multiple of {vec} (16-byte rows of "
                         f"{itemsize}-byte values)")
    backward = kernel != "lstm_fwd"
    if tensor_cores(kernel, itemsize):
        return _tensor_core_geometry(B, H, backward, num_sms, smem_limit, max_threads, max_rows,
                                     kernel in _DWH_STAGE)
    units = -(-H // num_sms)
    grid = -(-H // units)
    if units > max_threads:
        raise ValueError(f"{units} units per block need more than {max_threads} threads")
    row_groups = -(-B // 4)
    Hbp = 4 * -(-units // 4)
    widest = min(H, _MAX_K_TILE)
    tiles = [widest] + [k for k in (64, 32, 16, 8) if k < widest]
    tried = set()
    for n in range(1, row_groups + 1):
        groups = -(-row_groups // n)  # row groups per chunk
        items = groups * units
        if groups in tried or items > max_threads or (max_rows is not None
                                                        and 4 * groups > max_rows):
            continue
        tried.add(groups)
        rows = 4 * groups
        one_chunk = rows >= B
        slices = 1
        while items * slices * 2 <= min(_SLICED_THREADS, max_threads):
            slices *= 2
        threads = items * slices
        for pinned in (True, False):
            for kt in tiles:
                # the staged rows and the slices' partials; with one chunk
                # also the walk's dh carry
                nbytes = _STAGES * rows * (kt * itemsize + _ROW_PAD_BYTES) + 64 * threads
                if backward and one_chunk:
                    nbytes += 4 * rows * units
                if not backward:
                    nbytes += _RING_BARRIER_BYTES
                # the wh slice: gate columns, and (walk) rows padded to 4 units
                if pinned:
                    nbytes += H * 4 * units * itemsize
                    if backward:
                        nbytes += Hbp * (4 * H * itemsize + _ROW_PAD_BYTES)
                else:
                    nbytes += _STAGES * kt * 4 * units * itemsize
                    if backward:
                        nbytes += _STAGES * Hbp * (kt * itemsize + _ROW_PAD_BYTES)
                if nbytes > smem_limit:
                    continue
                if (kernel in _DWH_PASS and _dwh_tile_rows(
                        H, units, threads, kt, pinned, rows, Hbp, itemsize) < 1):
                    continue
                return Geometry(units, grid, threads, kt, pinned, nbytes, rows)
    raise ValueError(f"no tile of B={B}, H={H} fits {smem_limit} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory bytes a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _geometry(B: int, H: int, kernel: str, dev, dtype=torch.float32) -> Geometry:
    return lstm_geometry(B, H, kernel, *_device_limits(dev.index or 0), dtype.itemsize)


def _geometry_ints(g: Geometry) -> Tuple[int, ...]:
    return (g.units, g.grid, g.threads, g.k_tile, int(g.pinned), g.smem_bytes, g.rows)


def _carry_workspace(g: Geometry, B: int, dev):
    """The walk's (dh, dc) carry slabs, (2, grid, chunks*rows, units) f32,
    where the batch takes more than one chunk; else None."""
    chunks = g.chunks(B)
    if chunks == 1:
        return None
    return torch.empty(2 * g.grid * chunks * g.rows * g.units, dtype=torch.float32, device=dev)


def _exchange_ring(source: str, g: Geometry, B: int, H: int, dtype, dev,
                   lib=None) -> torch.Tensor:
    """The exchange ring of the five kernels (both forms take their
    exchanged rows through TMA bulk copies out of it: column_split.cuh "The
    exchange"; K1 h_t, K2, K3 and K4 dz_t, K5 both) in the compute dtype, sized
    by the kernel's source itself (<source>_exchange_ring_elems,
    column_split.cuh ExchangeRing, the one account of its layout), from
    `lib` or the built library of `source`."""
    if lib is None:
        from r2d2_tpu_torch.ops import _build

        lib = _build.load(source)
    fn = getattr(lib, f"{source}_exchange_ring_elems")
    fn.argtypes = [_I] * 8
    fn.restype = ctypes.c_longlong
    n = fn(dtype.itemsize, B, H, g.units, g.grid, g.k_tile, int(g.pinned), g.rows)
    return torch.empty(n, dtype=dtype, device=dev)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The column-split kernels copy rows of these 16 bytes at a time."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _barrier(dev) -> torch.Tensor:
    """The grid barrier's arrival count and generation, zeroed per launch."""
    return torch.zeros(2, dtype=torch.int32, device=dev)


def lstm_fwd(proj_t, wh, h0, c0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outs (T,B,H) in proj dtype, cs (T,B,H) float32). proj_t, wh, h0 and
    c0 share one dtype, float32 or bfloat16. Kernel on CUDA, plain version
    on the CPU; the same operand checks on both."""
    dev = _device_of(proj_t, "lstm_fwd")
    T, B, H4 = proj_t.shape
    H = H4 // 4
    dt = _compute_dtype(proj_t, "lstm_fwd")
    _check("proj_t", proj_t, (T, B, 4 * H), dt, dev)
    _check("wh", wh, (H, 4 * H), dt, dev)
    _check("h0", h0, (B, H), dt, dev)
    _check("c0", c0, (B, H), dt, dev)
    dispatch_counts[_form("lstm_fwd", dt)] += 1
    if dev.type == "cpu":
        return lstm_fwd_plain(proj_t, wh, h0, c0)
    geo = _geometry(B, H, "lstm_fwd", dev, dt)
    if tensor_cores("lstm_fwd", dt.itemsize):
        _check_aligned("wh", wh)  # its gate columns come in 8- and 16-byte copies
    outs = torch.empty((T, B, H), dtype=dt, device=dev)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    xch = _exchange_ring("lstm_fwd", geo, B, H, dt, dev)  # h_t, exchanged
    _launch(_form("lstm_fwd", dt), (proj_t, wh, h0, c0, outs, cs, xch, _barrier(dev)),
            (T, B, H, *_geometry_ints(geo)), dev)
    return outs, cs


def grid_barriers(n: int, B: int, H: int, dev) -> None:
    """Launch n grid barriers alone, with K1's geometry at (B, H): the
    column split's per-step floor, for timing. Counts no launch."""
    from r2d2_tpu_torch.ops import _build

    geo = _geometry(B, H, "lstm_fwd", dev)
    _, err_str = _kernel("lstm_fwd")
    fn = _build.load("lstm_fwd").lstm_fwd_barriers_launch
    fn.argtypes = [_P, _I, _I, _I, _I, _P]
    fn.restype = _I
    bar = _barrier(dev)
    with torch.cuda.device(dev):
        code = fn(bar.data_ptr(), n, geo.grid, geo.threads, geo.smem_bytes,
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"grid barrier launch failed: {err_str(code).decode()} ({code})")


def exchange_alone(T: int, B: int, H: int, dev, dtype=torch.float32, bulk: bool = True,
                   geo: Geometry = None, source: str = "lstm_seq_bwd",
                   cols: bool = True) -> None:
    """Launch one exchange alone, for timing (its source's
    ``exchange_kernel``): T - 1 steps of one grid barrier and the exchange
    of one step of the exchange ring into the stage ring, no product; `bulk`
    the bulk ring, else the cp.async pipeline; with the batch in one chunk,
    in the geometry of `source` at (B, H) in `dtype`, or `geo`. `source`
    "lstm_seq_bwd": the carry product's exchange of dz (K2, K3, K5);
    "lstm_fwd": the gate product's of h (K1, K5's recompute), with `cols`
    the block's gate columns of wh beside each tile where wh is streamed.
    Counts no launch."""
    from r2d2_tpu_torch.ops import _build

    if source not in ("lstm_seq_bwd", "lstm_fwd"):
        raise ValueError(f"no exchange probe in {source!r}")
    geo = geo or _geometry(B, H, source, dev, dtype)
    _, err_str = _kernel(_form(source, dtype))
    lib = _build.load(source)
    fn = getattr(lib, f"{source}_exchange{'' if dtype == torch.float32 else '_bf16'}_launch")
    x = _exchange_ring(source, geo, B, H, dtype, dev, lib).zero_()
    wh = torch.zeros((H, 4 * H), dtype=dtype, device=dev)
    bar = _barrier(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if source == "lstm_fwd":
        fn.argtypes = [_P] * 3 + [_I] * 12 + [_P]
        args = (x.data_ptr(), wh.data_ptr(), bar.data_ptr(), T, B, H, *_geometry_ints(geo),
                int(bulk), int(cols), stream)
    else:
        fn.argtypes = [_P] * 4 + [_I] * 11 + [_P]
        dcT = torch.zeros((B, H), dtype=torch.float32, device=dev)
        args = (x.data_ptr(), wh.data_ptr(), dcT.data_ptr(), bar.data_ptr(), T, B, H,
                *_geometry_ints(geo), int(bulk), stream)
    fn.restype = _I
    with torch.cuda.device(dev):
        code = fn(*args)
    if code != 0:
        raise RuntimeError(f"exchange launch failed: {err_str(code).decode()} ({code})")


def dwh_pass_alone(hprev: torch.Tensor, dtype=torch.float32) -> None:
    """Launch K4's dWh passes alone, for timing (lstm_seq_bwd_fused.cu
    ``dwh_pass_kernel``): the T / DWH_WINDOW windows of a launch over hprev
    (T, B, H) in `dtype` and a window as it stands, no walk and no grid
    barrier, in K4's geometry with the batch in one chunk. Counts no
    launch."""
    from r2d2_tpu_torch.ops import _build

    T, B, H = hprev.shape
    dev = hprev.device
    geo = _geometry(B, H, "lstm_seq_bwd_fused", dev, dtype)
    _, err_str = _kernel(_form("lstm_seq_bwd_fused", dtype))
    sfx = "" if dtype == torch.float32 else "_bf16"
    fn = getattr(_build.load("lstm_seq_bwd_fused"), f"lstm_seq_bwd_fused_dwh{sfx}_launch")
    fn.argtypes = [_P] * 5 + [_I] * 11 + [_P]
    fn.restype = _I
    win, W = fused_dwh_window(T, B, geo, dtype, dev)
    wh = torch.zeros((H, 4 * H), dtype=dtype, device=dev)
    dcT = torch.zeros((B, H), dtype=torch.float32, device=dev)
    dwh = torch.empty((H, 4 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(hprev.data_ptr(), wh.data_ptr(), dcT.data_ptr(), dwh.data_ptr(), win.data_ptr(),
                  T, B, H, W, *_geometry_ints(geo), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"dWh pass launch failed: {err_str(code).decode()} ({code})")


def lstm_seq_bwd(dout, proj_t, hprev, cprev, cs, wh, dcT, burn) -> torch.Tensor:
    """dz (T,B,4H) float32 of the seam backward. proj_t, hprev and wh in
    float32 or bfloat16, the rest float32. Kernel on CUDA, plain version
    on the CPU; the same operand checks on both. `burn` is (B,) int32,
    0 <= burn[b] < T."""
    dev = _device_of(cs, "lstm_seq_bwd")
    T, B, H = cs.shape
    dt = _compute_dtype(proj_t, "lstm_seq_bwd")
    _check_walk(dout, proj_t, hprev, cprev, cs, wh, dcT, dev, dt)
    _check("burn", burn, (B,), torch.int32, dev)
    dispatch_counts[_form("lstm_seq_bwd", dt)] += 1
    if dev.type == "cpu":
        return lstm_seq_bwd_plain(dout, proj_t, hprev, cprev, cs, wh, dcT, burn)
    geo = _geometry(B, H, "lstm_seq_bwd", dev, dt)
    _check_aligned("hprev", hprev)
    _check_aligned("wh", wh)
    dz = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    xch = _exchange_ring("lstm_seq_bwd", geo, B, H, dt, dev)  # dz (bf16: rounded), exchanged
    _launch(_form("lstm_seq_bwd", dt),
            (dout, proj_t, hprev, cprev, cs, wh, dcT, burn, dz, xch,
             _carry_workspace(geo, B, dev), _barrier(dev)),
            (T, B, H, *_geometry_ints(geo)), dev)
    return dz


def lstm_bwd(dout, proj_t, hprev, cprev, cs, wh, dcT):
    """(dz (T,B,4H), dh0 (B,H), dc0 (B,H)), all float32, of the backward
    with no seam. proj_t, hprev and wh in float32 or bfloat16, the rest
    float32. Kernel on CUDA, plain version on the CPU; the same operand
    checks on both."""
    dev = _device_of(cs, "lstm_bwd")
    T, B, H = cs.shape
    f32 = torch.float32
    dt = _compute_dtype(proj_t, "lstm_bwd")
    _check_walk(dout, proj_t, hprev, cprev, cs, wh, dcT, dev, dt)
    dispatch_counts[_form("lstm_bwd", dt)] += 1
    if dev.type == "cpu":
        return lstm_bwd_plain(dout, proj_t, hprev, cprev, cs, wh, dcT)
    geo = _geometry(B, H, "lstm_bwd", dev, dt)
    _check_aligned("hprev", hprev)
    _check_aligned("wh", wh)
    dz = torch.empty((T, B, 4 * H), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    dc0 = torch.empty((B, H), dtype=f32, device=dev)
    xch = _exchange_ring("lstm_bwd", geo, B, H, dt, dev)  # dz (bf16: rounded), exchanged
    _launch(_form("lstm_bwd", dt),
            (dout, proj_t, hprev, cprev, cs, wh, dcT, dz, dh0, dc0, xch,
             _carry_workspace(geo, B, dev), _barrier(dev)),
            (T, B, H, *_geometry_ints(geo)), dev)
    return dz, dh0, dc0


# the steps of dz that lstm_seq_bwd_fused adds into dWh at once (the
# window): each window reads and writes the block's dWh columns once, so
# fewer windows move fewer bytes (17: five windows at T=85, faster than
# windows of 5 in both forms at every width tried on an H100) for a larger
# window (33 MB at the wide model's batch 96 in bf16, against the f32 dz's
# 134)
DWH_WINDOW = 17


def fused_dwh_window(T: int, B: int, g: Geometry, dtype, device, steps: int = None):
    """The window of lstm_seq_bwd_fused's dWh pass at geometry g: the dz
    columns of each block for W = min(DWH_WINDOW, T) steps (or `steps`),
    laid out as a stage of the pass holds them (column_split.cuh
    DwhWindow), so that one TMA bulk copy brings a stage's rows of a plane:
    (planes, grid, rows, ld) in the compute dtype. float32: one plane, dz,
    W*B rows of a unit's four gates side by side (4 units + 4); bf16: two,
    bf16(dz) and the low plane bf16(dz - bf16(dz)), the unrounded dz that
    dWh sums, W*B rows rounded up to 16, gate-major (4 units + 8). Never a
    (T, B, 4H) f32 copy of dz. -> (window, W)."""
    W = min(DWH_WINDOW, T) if steps is None else steps
    if dtype == torch.float32:
        planes, rows, ld = 1, W * B, 4 * g.units + 4
    else:
        planes, rows, ld = 2, 16 * -(-W * B // 16), 4 * g.units + 8
    return torch.empty((planes, g.grid, rows, ld), dtype=dtype, device=device), W


def lstm_seq_bwd_fused(dout, proj_t, hprev, cprev, cs, wh, dcT, burn):
    """(dz (T,B,4H) in proj dtype, dwh (H,4H) float32) of the seam backward
    with dWh formed in the kernel. proj_t, hprev and wh in float32 or
    bfloat16, the rest float32. Kernel on CUDA, plain version on the CPU;
    the same operand checks on both. On the card dz is lstm_seq_bwd's bit
    for bit (the same walk on the same exchange in the same geometry; in
    bf16 its f32 dz rounded); dz and dWh differ from the plain version by
    summation order only (dWh: windows of DWH_WINDOW steps, newest first),
    except that the bf16 form sums dz into dWh to about 16 bits (two bf16
    planes)."""
    dev = _device_of(cs, "lstm_seq_bwd_fused")
    T, B, H = cs.shape
    dt = _compute_dtype(proj_t, "lstm_seq_bwd_fused")
    _check_walk(dout, proj_t, hprev, cprev, cs, wh, dcT, dev, dt)
    _check("burn", burn, (B,), torch.int32, dev)
    dispatch_counts[_form("lstm_seq_bwd_fused", dt)] += 1
    if dev.type == "cpu":
        return lstm_seq_bwd_fused_plain(dout, proj_t, hprev, cprev, cs, wh, dcT, burn)
    geo = _geometry(B, H, "lstm_seq_bwd_fused", dev, dt)
    _check_aligned("hprev", hprev)
    _check_aligned("wh", wh)
    dz = torch.empty((T, B, 4 * H), dtype=dt, device=dev)
    dwh = torch.empty((H, 4 * H), dtype=torch.float32, device=dev)
    win, W = fused_dwh_window(T, B, geo, dt, dev)  # the pass's dz, by bulk copies
    xch = _exchange_ring("lstm_seq_bwd_fused", geo, B, H, dt, dev)  # dz (bf16: rounded)
    _launch(_form("lstm_seq_bwd_fused", dt),
            (dout, proj_t, hprev, cprev, cs, wh, dcT, burn, dz, dwh, win, xch,
             _carry_workspace(geo, B, dev), _barrier(dev)),
            (T, B, H, W, *_geometry_ints(geo)), dev)
    return dz, dwh


def lstm_seq_bwd_ckpt(dout, proj_t, h_ckpt, c_ckpt, wh, dcT, burn, S: int):
    """(dz (T,B,4H) in proj dtype, dwh (H,4H) float32) of the checkpointed
    seam backward. `h_ckpt` (proj dtype), `c_ckpt` (float32), (T/S, B, H),
    are the carries entering each S-step segment; proj_t and wh in float32
    or bfloat16, the rest float32. Kernel on CUDA, plain version on the
    CPU."""
    dev = _device_of(dout, "lstm_seq_bwd_ckpt")
    T, B, H = dout.shape
    if S < 1 or T % S:
        raise ValueError(f"seq len {T} not divisible by checkpoint segment {S}")
    N = T // S
    f32 = torch.float32
    dt = _compute_dtype(proj_t, "lstm_seq_bwd_ckpt")
    _check("dout", dout, (T, B, H), f32, dev)
    _check("proj_t", proj_t, (T, B, 4 * H), dt, dev)
    _check("h_ckpt", h_ckpt, (N, B, H), dt, dev)
    _check("c_ckpt", c_ckpt, (N, B, H), f32, dev)
    _check("wh", wh, (H, 4 * H), dt, dev)
    _check("dcT", dcT, (B, H), f32, dev)
    _check("burn", burn, (B,), torch.int32, dev)
    dispatch_counts[_form("lstm_seq_bwd_ckpt", dt)] += 1
    if dev.type == "cpu":
        return lstm_seq_bwd_ckpt_plain(dout, proj_t, h_ckpt, c_ckpt, wh, dcT, burn, S)
    geo = _geometry(B, H, "lstm_seq_bwd_ckpt", dev, dt)
    dz = torch.empty((T, B, 4 * H), dtype=dt, device=dev)
    dwh = torch.empty((H, 4 * H), dtype=f32, device=dev)
    # the recomputed segment's h (every block reads it whole; proj dtype)
    # and c (each block touches only its own units), (S+1, B, H) each
    seg_h = torch.empty((S + 1, B, H), dtype=dt, device=dev)
    seg_c = torch.empty((S + 1, B, H), dtype=f32, device=dev)
    # bf16: the segment's low plane of dz, bf16(dz - bf16(dz)): with dz
    # itself, the f32 dz that dWh sums before dz is rounded
    dz_lo = None if dt == f32 else torch.empty((S, B, 4 * H), dtype=dt, device=dev)
    # rows copied 16 bytes at a time (bf16: wh's gate columns and both dz
    # planes 8 or 16)
    for name, t in (("h_ckpt", h_ckpt), ("wh", wh), ("seg_h", seg_h), ("dz", dz),
                    ("dz_lo", dz_lo)):
        if t is not None:
            _check_aligned(name, t)
    # the recompute's h_t and the walk's dz_t (bf16: rounded), exchanged
    xch = _exchange_ring("lstm_seq_bwd_ckpt", geo, B, H, dt, dev)
    _launch(_form("lstm_seq_bwd_ckpt", dt),
            (dout, proj_t, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, seg_h, seg_c, dz_lo, xch,
             _carry_workspace(geo, B, dev), _barrier(dev)),
            (T, B, H, S, *_geometry_ints(geo)), dev)
    return dz, dwh


# --------------------------------------------------------------------------
# autograd ops
# --------------------------------------------------------------------------


def _cotangents(douts, dhT, dcT):
    """(dout with the h_T cotangent folded into its last step, dcT), as
    fresh contiguous float32 tensors: the incoming cotangent may be a
    strided view (the caller transposes outs to batch-major)."""
    douts = douts.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    douts[-1] += dhT.float()
    return douts, dcT.float().contiguous()


def _carries(h0, c0, outs, cs):
    """(h_{t-1}, c_{t-1}) for every step t."""
    hprev = torch.cat([h0.to(outs.dtype)[None], outs[:-1]], dim=0)
    cprev = torch.cat([c0.float()[None], cs[:-1]], dim=0)
    return hprev, cprev


def _outer_dwh(hprev, dz, wh):
    """dWh = hprev^T @ dz as one matmul outside the kernel: (H, T*B) @ (T*B, 4H)."""
    T, B, H = hprev.shape
    return (hprev.reshape(T * B, H).float().T @ dz.reshape(T * B, 4 * H)).to(wh.dtype)


class _Unroll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj_t, wh, h0, c0):
        outs, cs = lstm_fwd(proj_t, wh, h0, c0)
        ctx.save_for_backward(proj_t, wh, h0, c0, outs)
        ctx.cs = cs
        return outs, outs[-1].float().clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, douts, dhT, dcT):
        proj_t, wh, h0, c0, outs = ctx.saved_tensors
        douts, dcT = _cotangents(douts, dhT, dcT)
        hprev, cprev = _carries(h0, c0, outs, ctx.cs)
        dz, dh0, dc0 = lstm_bwd(douts, proj_t, hprev, cprev, ctx.cs, wh, dcT)
        return dz.to(proj_t.dtype), _outer_dwh(hprev, dz, wh), dh0.to(h0.dtype), dc0.to(c0.dtype)


def lstm_unroll(proj_t, wh, h0, c0):
    """Fused LSTM unroll with no seam: (outs (T,B,H), (h_T, c_T)). The
    gradient runs through every step into h0 / c0."""
    outs, hT, cT = _Unroll.apply(proj_t, wh, h0, c0)
    return outs, (hT, cT)


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
        douts, dcT = _cotangents(douts, dhT, dcT)
        hprev, cprev = _carries(h0, c0, outs, ctx.cs)
        dz = lstm_seq_bwd(douts, proj_t, hprev, cprev, ctx.cs, wh, dcT,
                          burn_in.to(torch.int32).contiguous())
        # dz is exactly zero below each row's seam, so burn-in steps drop
        # out of the weight gradient too
        return (dz.to(proj_t.dtype), _outer_dwh(hprev, dz, wh),
                torch.zeros_like(h0), torch.zeros_like(c0), None)


class _SeqUnrollFusedDwh(_SeqUnroll):
    """The default arm's forward and residuals; the backward kernel adds
    dWh up itself."""

    @staticmethod
    def backward(ctx, douts, dhT, dcT):
        proj_t, wh, h0, c0, burn_in, outs = ctx.saved_tensors
        douts, dcT = _cotangents(douts, dhT, dcT)
        hprev, cprev = _carries(h0, c0, outs, ctx.cs)
        dz, dwh = lstm_seq_bwd_fused(douts, proj_t, hprev, cprev, ctx.cs, wh, dcT,
                                     burn_in.to(torch.int32).contiguous())
        return (dz.to(proj_t.dtype), dwh.to(wh.dtype),
                torch.zeros_like(h0), torch.zeros_like(c0), None)


def lstm_seq_unroll(proj_t, wh, h0, c0, burn_in):
    """Fused burn-in + train unroll with a per-row stop-gradient seam.

    Returns (outs (T,B,H), (h_T, c_T)). Gradients do not flow into steps
    t < burn_in[b] of row b, and d h0 / d c0 are zero tensors. Contract:
    0 <= burn_in[b] < T."""
    outs, hT, cT = _SeqUnroll.apply(proj_t, wh, h0, c0, burn_in)
    return outs, (hT, cT)


def lstm_seq_unroll_fused_dwh(proj_t, wh, h0, c0, burn_in):
    """:func:`lstm_seq_unroll` with the fused-dWh backward arm: the same
    forward, values and residuals; only the backward kernel differs."""
    outs, hT, cT = _SeqUnrollFusedDwh.apply(proj_t, wh, h0, c0, burn_in)
    return outs, (hT, cT)


@functools.lru_cache(maxsize=None)
def lstm_seq_unroll_ckpt(S: int):
    """Build the checkpointed-backward sequence op for segment length S:
    :func:`lstm_seq_unroll`'s signature and forward values, but the forward
    saves only the T/S carries entering each segment, not outs / cs. The
    factory is cached: one op per S. As the JAX op raises only in its VJP
    forward, this raises ValueError when T % S only if a gradient is
    wanted; an undifferentiated call returns lstm_seq_unroll's values."""
    if S < 1:
        raise ValueError(f"seq_grad_checkpoint segment length must be >= 1, got {S}")

    class _SeqUnrollCkpt(torch.autograd.Function):
        @staticmethod
        def forward(ctx, proj_t, wh, h0, c0, burn_in):
            T = proj_t.shape[0]
            outs, cs = lstm_fwd(proj_t, wh, h0, c0)
            # the carries entering segments 1..N-1 are the step-(kS-1)
            # outputs; segment 0 starts from (h0, c0)
            h_ckpt = torch.cat([h0.to(outs.dtype)[None], outs[S - 1 : T - 1 : S]])
            c_ckpt = torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]])
            ctx.save_for_backward(proj_t, wh, h0, c0, burn_in, h_ckpt, c_ckpt)
            return outs, outs[-1].float().clone(), cs[-1].clone()

        @staticmethod
        def backward(ctx, douts, dhT, dcT):
            proj_t, wh, h0, c0, burn_in, h_ckpt, c_ckpt = ctx.saved_tensors
            douts, dcT = _cotangents(douts, dhT, dcT)
            dz, dwh = lstm_seq_bwd_ckpt(douts, proj_t, h_ckpt, c_ckpt, wh, dcT,
                                        burn_in.to(torch.int32).contiguous(), S)
            return (dz.to(proj_t.dtype), dwh.to(wh.dtype),
                    torch.zeros_like(h0), torch.zeros_like(c0), None)

    def seq_unroll_ckpt(proj_t, wh, h0, c0, burn_in):
        T = proj_t.shape[0]
        wants_grad = torch.is_grad_enabled() and any(
            x.requires_grad for x in (proj_t, wh, h0, c0))
        if T % S and wants_grad:
            raise ValueError(f"seq len {T} not divisible by checkpoint segment {S}")
        outs, hT, cT = _SeqUnrollCkpt.apply(proj_t, wh, h0, c0, burn_in)
        return outs, (hT, cT)

    return seq_unroll_ckpt


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
