"""The CUDA sources of r2d2_tpu_torch/csrc, compiled with g++ against a CPU
emulation of the CUDA subset they use (tests/cuda_emulation/cuda_runtime.h),
called through the same plain C interface and argument order the port's
ctypes wrappers use, and held against the kernels' plain PyTorch versions.

This checks each kernel's indexing, ragged-edge masks, seam masks and the
placement of its block barriers (shared memory starts poisoned, so a read
before its write shows) on a machine without a card. It checks nothing of
warps, the memory model or speed: the kernels themselves are held against
the plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py.

The emulated subset is small on purpose: one `extern __shared__` array,
cooperative launches through the template `cudaLaunchKernelEx`,
`__syncthreads`, `__syncwarp`, `__ldg`, `__ldcg`,
`__threadfence`, `__nanosleep`, an integer `atomicAdd`, `float4`, `uint2`,
`__uint_as_float`, 1-D thread and block indices (`__launch_bounds__` is
dropped), and of cuda_bf16.h the type `__nv_bfloat16` with its two
conversions (tests/cuda_emulation/cuda_bf16.h). A cooperative
launch runs all its blocks at once, so the column-split kernels (K1 to
K5) run here with their hand-written grid barrier, at a geometry cut
to four blocks; a misplaced exchange or barrier reads another block's
columns before they are written. Each kernel also runs at a thread
ceiling cut so far that the batch takes two or more row chunks (the last
one ragged), and the bf16 forms of all five run against their plain
versions in bf16 (K4's with dWh windows that do and do not divide T, in
both forms). The bulk exchange of all five (TMA bulk copies into an
mbarrier ring) and K4's dWh pass on its own ring run on the scalar host
bodies column_split.cuh gives their primitives: an mbarrier a 64-bit word
whose waiters block on it until its phase moves, a bulk copy a memcpy that
completes its bytes on it; each ring is also run where it wraps many times
a step, wh pinned and streamed. A kernel
whose body leaves the subset (clusters, warp intrinsics, wgmma) is held
against its plain version by
tests/test_torch_cuda.py and chip_smoke.py only; the header is not meant
to grow into a CUDA emulator.

Tolerance: both sides sum in float32 in other orders; forward 1e-5, dz 1e-4
absolute, and dz exactly zero below each row's seam. dWh is held to 1e-4 of
its largest entry: each entry sums T*B products in another order (K4:
per column slice, windows of steps newest first, (t, b) in each; K5: per
segment, newest first), and entries
that cancel to near zero have no meaningful relative error. The
column-split kernels sum every output in one fixed order, so two launches
give the same bits, and K4 walks as K2 does in K2's geometry, so its dz
is K2's bit for bit.

bf16 forms: both sides sum exact products of bf16 values in float32, in
other orders, so a value can round to the neighbouring bf16 value where
the two sums straddle a rounding boundary, a step of 2^-8 of it, which
then feeds the later steps. Forward outs (bf16), cs, and dz (K2's and
K3's f32, K4's and K5's bf16), K3's dh0 and dc0 are held to two such
steps (BF16_RTOL = 2^-7) plus BF16_ATOL absolute; K4's and K5's dWh,
summed in f32 from the f32 dz carried in two bf16 planes (dz to about 16
bits), to 1e-4 of its largest entry as in float32 (summing the rounded
dz instead would be off by about 1e-3). Two launches still give the same
bits, and K4-bf16's dz is K2-bf16's f32 dz rounded to bf16 everywhere:
the two get one split. One case adds a slack derived from K5-bf16's own
recompute: its dWh in row chunks at H=600 (see _recompute_dwh_slack).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.ops import lstm_kernel

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "r2d2_tpu_torch", "csrc")
BF16 = torch.bfloat16
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-3


def _emulated(name, out_dir):
    """csrc/<name>.cu rewritten for the emulation header and built with
    g++: {kernel form: its entry point}, with the port's C signatures."""
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = src.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    src = re.sub(r"__launch_bounds__\([^)]*\)", "", src)  # a register budget: no CPU meaning
    # every kernel is a cooperative launch (column_split.cuh)
    assert "launch_cooperative(" in src, f"{name}.cu: launches?"
    cpp = os.path.join(out_dir, f"{name}.cpp")
    with open(cpp, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-I", os.path.join(HERE, "cuda_emulation"), "-I", CSRC, "-o", lib, cpp],
        check=True, capture_output=True, text=True,
    )
    dll = ctypes.CDLL(lib)
    forms = {f"{name}_lib": dll}  # the library itself (the ring's size)
    for form, src_name in lstm_kernel._SOURCE.items():
        if src_name != name:
            continue
        fn = getattr(dll, f"{form}_launch")
        n_ptrs, n_ints = lstm_kernel._SIGNATURES[form]
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        forms[form] = fn
    return forms


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("emulated_kernels"))
    forms = {}
    for name in lstm_kernel.SOURCES:
        forms.update(_emulated(name, out))
    return forms


def _call(fn, tensors, *ints):
    assert fn(*(0 if t is None else t.data_ptr() for t in tensors), *ints, None) == 0


# the column split cut to at most four blocks, so an emulated launch runs
# a few hundred threads at once
EMULATED_SMS = 4
SMEM_LIMIT = 232_448


# a tensor-core form's thread ceiling below 512: cut into chunks by rows
# instead (a warp is its least block), one m16 tile a chunk
TC_CHUNK_ROWS = 16


def _emulated_geometry(name, B, H, max_threads=512):
    """The emulated geometry of kernel form `name`. A tensor-core form
    (every bf16 form) owns at most 64 units a block (one thread per 4 rows
    and unit, 16 rows, 256 threads), so it takes more blocks where H needs
    them;
    and where the case cuts threads to force row chunks, it takes a row
    ceiling of TC_CHUNK_ROWS instead."""
    src = lstm_kernel._SOURCE[name]
    itemsize = 2 if name.endswith("_bf16") else 4
    if not lstm_kernel.tensor_cores(src, itemsize):
        return lstm_kernel.lstm_geometry(B, H, src, EMULATED_SMS, SMEM_LIMIT, itemsize,
                                         max_threads)
    rows = TC_CHUNK_ROWS if max_threads < 512 else None
    return lstm_kernel.lstm_geometry(B, H, src, max(EMULATED_SMS, -(-H // 64)), SMEM_LIMIT,
                                     itemsize, 512, rows)


def _split(kernels, name, tensors, T, B, H, *ints, max_threads=512):
    """Launch the column-split kernel form `name` at the emulated geometry
    (its dtype's, within `max_threads`), with the walk's carry workspace
    where the batch takes more than one chunk and a zeroed grid barrier;
    `ints` (K5's S) come between H and the geometry. -> the geometry."""
    g = _emulated_geometry(name, B, H, max_threads)
    _launch_at(kernels, name, tensors, T, B, H, g, *ints)
    return g


def _launch_at(kernels, name, tensors, T, B, H, g, *ints):
    """Launch kernel form `name` at geometry g (as _split does)."""
    src = lstm_kernel._SOURCE[name]
    if src != "lstm_fwd":
        tensors = (*tensors, lstm_kernel._carry_workspace(g, B, "cpu"))
    _call(kernels[name], (*tensors, torch.zeros(2, dtype=torch.int32)), T, B, H, *ints,
          *lstm_kernel._geometry_ints(g))


# (T, B, H): a ragged batch tile, H not a multiple of the 32-thread warp,
# H above the 512-thread block (two hidden units per thread; for K1/K2 a
# wh slice streamed in ragged k-tiles), a tiny H
SHAPES = [(7, 5, 32), (4, 9, 40), (3, 2, 600), (6, 4, 8)]
# shapes cut into row chunks by a thread ceiling: (T, B, H, ceiling), the
# ceiling one or two row groups of the units a block owns (8, 10, 150, 2
# at four blocks), so the batch takes 2, 6, 2 and 2 chunks, the last one
# ragged
CHUNK_SHAPES = [(7, 5, 32, 8), (4, 21, 40, 10), (3, 9, 600, 300), (6, 13, 8, 4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _operands(T, B, H, dtype=torch.float32):
    """Random operands and the plain forward's residuals at one shape;
    proj, wh, h0 and c0 (and so outs) in `dtype`."""
    rng = np.random.default_rng(T * B + H)
    proj = _t(rng.normal(size=(T, B, 4 * H))).to(dtype)
    wh = _t(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H)).to(dtype)
    h0 = _t(rng.normal(size=(B, H)) * 0.3).to(dtype)
    c0 = _t(rng.normal(size=(B, H)) * 0.3).to(dtype)
    outs, cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    dout, dcT = _t(rng.normal(size=(T, B, H))), _t(rng.normal(size=(B, H)))
    return rng, proj, wh, h0, c0, outs, cs, dout, dcT


def _walk(proj, wh, h0, c0, outs, cs, dout, dcT):
    """The reverse walks' operands: (dout, proj, hprev, cprev, cs, wh, dcT)."""
    return (dout, proj, torch.cat([h0[None], outs[:-1]]),
            torch.cat([c0.float()[None], cs[:-1]]), cs, wh, dcT)


def _burns(rng, T, B):
    """Seams at 0, mid, T-1 and mixed per row."""
    return [np.zeros(B), np.full(B, T // 2), np.full(B, T - 1), rng.integers(0, T, B)]


def _assert_dwh_close(got, want):
    tol = 1e-4 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def _assert_zero_below_seam(dz, burn_np):
    for b in range(dz.shape[1]):
        assert not dz[: int(burn_np[b]), b].any()


def _ring(kernels, source, g, B, H, dtype):
    """The exchange ring of kernel `source` at g, sized by the emulated
    source."""
    return lstm_kernel._exchange_ring(source, g, B, H, dtype, "cpu", kernels[f"{source}_lib"])


def _fwd(kernels, proj, wh, h0, c0, mt=512):
    T, B, H4 = proj.shape
    H = H4 // 4
    outs, cs = torch.empty(T, B, H, dtype=proj.dtype), torch.empty(T, B, H)
    name = "lstm_fwd" if proj.dtype == torch.float32 else "lstm_fwd_bf16"
    xch = _ring(kernels, "lstm_fwd", _emulated_geometry(name, B, H, mt), B, H, proj.dtype)
    _split(kernels, name, (proj, wh, h0, c0, outs, cs, xch), T, B, H, max_threads=mt)
    return outs, cs


def _seam(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn, mt=512):
    T, B, H = cs.shape
    dz = torch.empty(T, B, 4 * H)
    name = lstm_kernel._form("lstm_seq_bwd", proj.dtype)
    xch = _ring(kernels, "lstm_seq_bwd", _emulated_geometry(name, B, H, mt), B, H, proj.dtype)
    _split(kernels, name, (dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, xch), T, B, H,
           max_threads=mt)
    return dz


def _seamless(kernels, dout, proj, hprev, cprev, cs, wh, dcT, mt=512):
    T, B, H = cs.shape
    dz, dh0, dc0 = torch.empty(T, B, 4 * H), torch.empty(B, H), torch.empty(B, H)
    name = lstm_kernel._form("lstm_bwd", proj.dtype)
    xch = _ring(kernels, "lstm_bwd", _emulated_geometry(name, B, H, mt), B, H, proj.dtype)
    _split(kernels, name, (dout, proj, hprev, cprev, cs, wh, dcT, dz, dh0, dc0, xch), T, B, H,
           max_threads=mt)
    return dz, dh0, dc0


# the dWh window of the emulated K4 launches, in steps: several windows at
# these T, the newest ragged at T=7 and 6 (the wrapper's DWH_WINDOW takes
# one)
WINDOW = 5


def _fused(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn, mt=512, window=None):
    """K4's (dz, dwh) at the emulated geometry, with a dWh window of
    min(WINDOW, T) steps, or of `window` steps."""
    B, H = cs.shape[1:]
    g = _emulated_geometry(lstm_kernel._form("lstm_seq_bwd_fused", proj.dtype), B, H, mt)
    return _fused_at(kernels, (dout, proj, hprev, cprev, cs, wh, dcT), burn, g, window)


def _fused_at(kernels, walk, burn, g, window=None):
    """K4's (dz, dwh) at geometry g, on its exchange ring, with its dWh
    window laid out as the wrapper lays it out, of min(WINDOW, T) steps or
    of `window` steps."""
    T, B, H = walk[4].shape
    dt = walk[1].dtype
    dz, dwh = torch.empty(T, B, 4 * H, dtype=dt), torch.empty(H, 4 * H)
    win, W = lstm_kernel.fused_dwh_window(T, B, g, dt, "cpu",
                                          min(WINDOW, T) if window is None else window)
    xch = _ring(kernels, "lstm_seq_bwd_fused", g, B, H, dt)
    _launch_at(kernels, lstm_kernel._form("lstm_seq_bwd_fused", dt),
               (*walk, burn, dz, dwh, win, xch), T, B, H, g, W)
    return dz, dwh


def _ckpt(kernels, dout, proj, outs, cs, h0, c0, wh, dcT, burn, S, mt=512):
    """(dz, dwh, h_ckpt, c_ckpt) of K5 at segment length S."""
    T, B, H = cs.shape
    dt = proj.dtype
    h_ckpt = torch.cat([h0[None], outs[S - 1 : T - 1 : S]]).contiguous()
    c_ckpt = torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]]).contiguous()
    dz, dwh = torch.empty(T, B, 4 * H, dtype=dt), torch.empty(H, 4 * H)
    seg = torch.empty(S + 1, B, H, dtype=dt), torch.empty(S + 1, B, H)
    if dt == torch.float32:
        name, dz_lo = "lstm_seq_bwd_ckpt", None
    else:  # the low plane of dz that the bf16 form's dWh pass sums
        name, dz_lo = "lstm_seq_bwd_ckpt_bf16", torch.empty(S, B, 4 * H, dtype=dt)
    xch = _ring(kernels, "lstm_seq_bwd_ckpt", _emulated_geometry(name, B, H, mt), B, H, dt)
    _split(kernels, name, (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, *seg, dz_lo, xch),
           T, B, H, S, max_threads=mt)
    return dz, dwh, h_ckpt, c_ckpt


def _strides(T):
    """Two segment lengths: the smallest divisor >= 2 of T, and 1 or T."""
    s = min(d for d in range(2, T + 1) if T % d == 0)
    return [s, T if s < T else 1]


def _seams_for(rng, T, B, S):
    """Seams on segment boundaries, inside segments, and at 0 / T-1."""
    on = rng.integers(0, T // S, B) * S
    inside = on + (rng.integers(1, S, B) if S > 1 else 0)
    return (on, np.minimum(inside, T - 1), np.zeros(B), np.full(B, T - 1))


def _check_forward_and_seam(kernels, T, B, H, mt=512):
    rng = np.random.default_rng(T * B + H)
    proj = _t(rng.normal(size=(T, B, 4 * H)))
    wh = _t(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    h0, c0 = _t(rng.normal(size=(B, H)) * 0.3), _t(rng.normal(size=(B, H)) * 0.3)
    outs, cs = _fwd(kernels, proj, wh, h0, c0, mt)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    torch.testing.assert_close(outs, p_outs, rtol=0, atol=1e-5)
    torch.testing.assert_close(cs, p_cs, rtol=0, atol=1e-5)

    hprev = torch.cat([h0[None], outs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dout, dcT = _t(rng.normal(size=(T, B, H))), _t(rng.normal(size=(B, H)))
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz = _seam(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn, mt)
        plain = lstm_kernel.lstm_seq_bwd_plain(dout, proj, hprev, cprev, cs, wh, dcT, burn)
        torch.testing.assert_close(dz, plain, rtol=0, atol=1e-4)
        _assert_zero_below_seam(dz, burn_np)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_kernels_match_plain_versions(kernels, T, B, H):
    _check_forward_and_seam(kernels, T, B, H)


def _check_seamless(kernels, T, B, H, mt=512):
    _, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    got = _seamless(kernels, *walk, mt=mt)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_seamless_backward_matches_plain_version(kernels, T, B, H):
    _check_seamless(kernels, T, B, H)


def _check_fused(kernels, T, B, H, mt=512):
    """dz and dWh (summed in the kernel) against the plain version."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz, dwh = _fused(kernels, *walk, burn, mt)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)
        torch.testing.assert_close(dz, p_dz, rtol=0, atol=1e-4)
        _assert_dwh_close(dwh, p_dwh)
        _assert_zero_below_seam(dz, burn_np)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_fused_dwh_backward_matches_plain_version(kernels, T, B, H):
    """dz and dWh (summed in the kernel) against the plain version."""
    _check_fused(kernels, T, B, H)


def _check_ckpt(kernels, T, B, H, mt=512):
    """At two strides, with seams on segment boundaries, inside segments,
    and at 0 / T-1."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    for S in _strides(T):
        for burn_np in _seams_for(rng, T, B, S):
            burn = torch.from_numpy(burn_np.astype(np.int32))
            dz, dwh, h_ckpt, c_ckpt = _ckpt(kernels, dout, proj, outs, cs, h0, c0, wh, dcT,
                                            burn, S, mt)
            p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(
                dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
            torch.testing.assert_close(dz, p_dz, rtol=0, atol=1e-4)
            _assert_dwh_close(dwh, p_dwh)
            _assert_zero_below_seam(dz, burn_np)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_ckpt_backward_matches_plain_version(kernels, T, B, H):
    """At two strides, with seams on segment boundaries, inside segments,
    and at 0 / T-1."""
    _check_ckpt(kernels, T, B, H)


@pytest.mark.parametrize("T,B,H", [(7, 5, 32), (6, 4, 8)])
def test_emulated_seamless_backward_gives_the_same_bits_every_launch(kernels, T, B, H):
    _, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    for a, b in zip(_seamless(kernels, *walk), _seamless(kernels, *walk)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,B,H", [(7, 5, 32), (6, 4, 8)])
def test_emulated_ckpt_backward_gives_the_same_bits_every_launch(kernels, T, B, H):
    """dz and dWh at two strides, with seams on and inside segment
    boundaries."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    for S in _strides(T):
        on, inside = _seams_for(rng, T, B, S)[:2]
        for burn_np in (on, inside):
            args = (dout, proj, outs, cs, h0, c0, wh, dcT,
                    torch.from_numpy(burn_np.astype(np.int32)), S)
            for a, b in zip(_ckpt(kernels, *args)[:2], _ckpt(kernels, *args)[:2]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("T,B,H", [(7, 5, 32), (6, 4, 8)])
def test_emulated_fused_dwh_backward_gives_the_same_bits_every_launch(kernels, T, B, H):
    """dz and dWh, with seams at 0, mid, T-1 and mixed."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        for a, b in zip(_fused(kernels, *walk, burn), _fused(kernels, *walk, burn)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_fused_dwh_dz_is_the_seam_backwards_bit_for_bit(kernels, T, B, H):
    """K4 runs K2's walk in K2's geometry: the same dz bits at the same
    inputs, seams at 0, mid, T-1 and mixed."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        assert torch.equal(_fused(kernels, *walk, burn)[0], _seam(kernels, *walk, burn))


# ---------------------------------------------------------------------------
# row chunks: the batch walked in two or more chunks per step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,B,H,mt", CHUNK_SHAPES)
def test_emulated_geometry_cut_into_row_chunks(T, B, H, mt):
    """The thread ceiling of CHUNK_SHAPES gives every kernel two or more
    chunks, the last one ragged, with threads within the ceiling."""
    for name in lstm_kernel.SOURCES:
        g = lstm_kernel.lstm_geometry(B, H, name, EMULATED_SMS, SMEM_LIMIT, 4, mt)
        assert g.chunks(B) >= 2 and B % g.rows and g.threads <= mt, (name, g)


@pytest.mark.parametrize("T,B,H,mt", CHUNK_SHAPES)
def test_emulated_kernels_in_row_chunks_match_plain_versions(kernels, T, B, H, mt):
    """K1 and K2 (seams 0, mid, T-1 and mixed), K3, K4 and K5 (two strides,
    seams on and inside segments) with the batch in row chunks."""
    _check_forward_and_seam(kernels, T, B, H, mt)
    _check_seamless(kernels, T, B, H, mt)
    _check_fused(kernels, T, B, H, mt)
    _check_ckpt(kernels, T, B, H, mt)


@pytest.mark.parametrize("T,B,H,mt", CHUNK_SHAPES[:2])
def test_emulated_kernels_in_row_chunks_give_the_same_bits_every_launch(kernels, T, B, H, mt):
    """Each kernel twice at a chunked geometry, and K4's dz equal to K2's."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    for a, b in zip(_fwd(kernels, proj, wh, h0, c0, mt), _fwd(kernels, proj, wh, h0, c0, mt)):
        assert torch.equal(a, b)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    burn = torch.from_numpy(rng.integers(0, T, B).astype(np.int32))
    seam = _seam(kernels, *walk, burn, mt)
    assert torch.equal(seam, _seam(kernels, *walk, burn, mt))
    for a, b in zip(_seamless(kernels, *walk, mt=mt), _seamless(kernels, *walk, mt=mt)):
        assert torch.equal(a, b)
    fused = _fused(kernels, *walk, burn, mt)
    assert torch.equal(fused[0], seam)
    for a, b in zip(fused, _fused(kernels, *walk, burn, mt)):
        assert torch.equal(a, b)
    args = (dout, proj, outs, cs, h0, c0, wh, dcT, burn, _strides(T)[0], mt)
    for a, b in zip(_ckpt(kernels, *args)[:2], _ckpt(kernels, *args)[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,B,H,mt", [(7, 5, 32, 512), (7, 5, 32, 8), (7, 4, 4, 1)])
def test_emulated_fused_dwh_window_may_not_divide_T(kernels, T, B, H, mt):
    """K4 in float32 with dWh windows of 1, 3 (T=7: the newest window one
    step) and T steps, one chunk, row chunks, and blocks of one thread (a
    stage of the pass would hold more rows than warp 0 has lanes): dWh the
    same sum in other orders, to 1e-4 of its largest entry, the same bits
    on a second launch, and the same dz bits in every case."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    burn = torch.from_numpy(rng.integers(0, T, B).astype(np.int32))
    p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)[1]
    dz = []
    for window in (1, 3, T):
        got = _fused(kernels, *walk, burn, mt, window)
        _assert_dwh_close(got[1], p_dwh)
        assert all(map(torch.equal, got, _fused(kernels, *walk, burn, mt, window)))
        dz.append(got[0])
    assert all(torch.equal(d, dz[0]) for d in dz)


# ---------------------------------------------------------------------------
# the bf16 forms of K1, K2 and K5
# ---------------------------------------------------------------------------


# a bf16 shape whose tensor-core K4 and K5 blocks own 24 units: six n16
# columns of dWh tiles, in three groups of two a warp (one group a warp
# elsewhere)
BF16_N_GROUP_SHAPE = (5, 7, 96, 512)
# bf16 shapes cut by a thread ceiling under 512: the bf16 forms (all on the
# tensor cores) take a row ceiling of TC_CHUNK_ROWS instead (one chunk and
# two)
BF16_CHUNK_SHAPES = [(7, 9, 32, 16), (4, 21, 40, 20)]


@pytest.mark.parametrize("T,B,H,mt", [(T, B, H, 512) for T, B, H in SHAPES] + BF16_CHUNK_SHAPES
                         + [BF16_N_GROUP_SHAPE])
def test_emulated_bf16_kernels_match_plain_versions(kernels, T, B, H, mt):
    """K1, K2 (seams 0, mid, T-1, mixed) and K5 (two strides, seams on and
    inside segments) with bf16 operands, one chunk and row chunks, against
    their bf16 plain versions; each launched twice for the same bits. The
    bf16 forms run their host tile products (the tensor-core forms'; K5's
    dWh pass the transposed-A product of both dz planes, at S*B and H off
    multiples of 16), in row chunks where the batch is wider than
    TC_CHUNK_ROWS."""
    for name in lstm_kernel.SOURCES:
        g = _emulated_geometry(f"{name}_bf16", B, H, mt)
        tc = lstm_kernel.tensor_cores(name, 2)
        assert g.chunks(B) >= 2 or mt == 512 or (tc and B <= TC_CHUNK_ROWS), (name, g)
    rng, proj, wh, h0, c0, p_outs, p_cs, dout, dcT = _operands(T, B, H, BF16)
    outs, cs = _fwd(kernels, proj, wh, h0, c0, mt)
    assert outs.dtype == BF16 and cs.dtype == torch.float32
    torch.testing.assert_close(outs.float(), p_outs.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(cs, p_cs, rtol=BF16_RTOL, atol=BF16_ATOL)
    for a, b in zip((outs, cs), _fwd(kernels, proj, wh, h0, c0, mt)):
        assert torch.equal(a, b)
    # the walks on the plain forward's residuals, so both sides see the
    # same inputs
    walk = _walk(proj, wh, h0, c0, p_outs, p_cs, dout, dcT)
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz = _seam(kernels, *walk, burn, mt)
        assert dz.dtype == torch.float32
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
        _assert_zero_below_seam(dz, burn_np)
        assert torch.equal(dz, _seam(kernels, *walk, burn, mt))
    for S in _strides(T):
        for burn_np in _seams_for(rng, T, B, S)[:2]:
            burn = torch.from_numpy(burn_np.astype(np.int32))
            args = (dout, proj, p_outs, p_cs, h0, c0, wh, dcT, burn, S, mt)
            dz, dwh, h_ckpt, c_ckpt = _ckpt(kernels, *args)
            p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(
                dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
            assert dz.dtype == BF16 and dwh.dtype == torch.float32
            torch.testing.assert_close(dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
            _assert_dwh_close(dwh, p_dwh)
            _assert_zero_below_seam(dz, burn_np)
            for a, b in zip((dz, dwh), _ckpt(kernels, *args)[:2]):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the bf16 forms of K3 and K4
# ---------------------------------------------------------------------------


def _check_bf16_fused(kernels, walk, burn_np, mt, window=None):
    """K4-bf16 against its plain version (dz in bf16, dWh from the f32 dz),
    zero below the seam, twice for the same bits. -> dz."""
    burn = torch.from_numpy(burn_np.astype(np.int32))
    dz, dwh = _fused(kernels, *walk, burn, mt, window)
    p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)
    assert dz.dtype == BF16 and dwh.dtype == torch.float32
    torch.testing.assert_close(dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    _assert_dwh_close(dwh, p_dwh)
    _assert_zero_below_seam(dz, burn_np)
    for a, b in zip((dz, dwh), _fused(kernels, *walk, burn, mt, window)):
        assert torch.equal(a, b)
    return dz


@pytest.mark.parametrize("T,B,H,mt", [(T, B, H, 512) for T, B, H in SHAPES] + BF16_CHUNK_SHAPES
                         + [BF16_N_GROUP_SHAPE])
def test_emulated_bf16_seamless_and_fused_dwh_match_plain_versions(kernels, T, B, H, mt):
    """K3-bf16 (dz, dh0, dc0 in f32) and K4-bf16 (seams 0, mid, T-1,
    mixed; a window of min(WINDOW, T) steps, ragged at T=7 and 6;
    its dWh pass the transposed-A product of both dz planes) with bf16
    operands, one chunk and row chunks, against their bf16 plain versions
    on the plain forward's residuals; each launched twice for the same
    bits. lstm_geometry gives K2-bf16 and K4-bf16 one split at every
    shape, so K4-bf16's dz is K2-bf16's f32 dz rounded to bf16, bit for
    bit."""
    rng, proj, wh, h0, c0, p_outs, p_cs, dout, dcT = _operands(T, B, H, BF16)
    walk = _walk(proj, wh, h0, c0, p_outs, p_cs, dout, dcT)
    got = _seamless(kernels, *walk, mt=mt)
    assert all(x.dtype == torch.float32 for x in got)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(a, b, rtol=BF16_RTOL, atol=BF16_ATOL)
    for a, b in zip(got, _seamless(kernels, *walk, mt=mt)):
        assert torch.equal(a, b)
    geos = [_emulated_geometry(n, B, H, mt) for n in ("lstm_seq_bwd_bf16",
                                                      "lstm_seq_bwd_fused_bf16")]
    assert geos[0] == geos[1], geos
    for burn_np in _burns(rng, T, B):
        dz = _check_bf16_fused(kernels, walk, burn_np, mt)
        seam = _seam(kernels, *walk, torch.from_numpy(burn_np.astype(np.int32)), mt)
        assert torch.equal(dz, seam.to(BF16))


@pytest.mark.parametrize("T,B,H,mt", [(7, 5, 32, 512), (7, 9, 32, 16)])
def test_emulated_bf16_fused_dwh_window_may_not_divide_T(kernels, T, B, H, mt):
    """K4-bf16 with windows of 1, 3 (T=7: the newest window one step) and
    T steps, one chunk and row chunks: dWh the same sum in every case, to
    1e-4 of its largest entry, and the same dz bits."""
    rng, proj, wh, h0, c0, p_outs, p_cs, dout, dcT = _operands(T, B, H, BF16)
    walk = _walk(proj, wh, h0, c0, p_outs, p_cs, dout, dcT)
    burn_np = rng.integers(0, T, B)
    dz = [_check_bf16_fused(kernels, walk, burn_np, mt, window) for window in (1, 3, T)]
    assert all(torch.equal(d, dz[0]) for d in dz)


# ---------------------------------------------------------------------------
# the tensor-core forms (K1-, K2-, K3- and K4-bf16) in row chunks
# ---------------------------------------------------------------------------


# batches that the tensor-core forms walk in chunks of TC_CHUNK_ROWS (3 and
# 2, the last one ragged), with H's last k-tile ending off a multiple of 16
# (40 of 48; 600 = 18 x 32 + 24): their host tile products read the zero
# padding of both operands, restaged every step and chunk
TC_CHUNK_SHAPES = [(4, 37, 40, 20), (3, 21, 600, 300)]


# the one case whose K5-bf16 dWh takes _recompute_dwh_slack: (T, B, H, S)
RECOMPUTE_SLACK_CASE = (3, 21, 600, 3)


def _recompute_dwh_slack(walk, burn, S):
    """The part of K5-bf16's dWh error that comes from its recompute, for
    RECOMPUTE_SLACK_CASE only.

    K5 recomputes h inside each segment (steps t with t % S != 0) in its
    own summation order; the plain version recomputes it in another. Each
    side rounds its f32 h to bf16 with an error of at most half a bf16
    step, so the two h may differ by one whole step where their f32 values
    straddle a rounding boundary. A bf16 step is 2^-7 to 2^-8 of |h| (8
    significant bits), so one step is at most 2^-7 |h|. An entry
    dWh[k, j] = sum over the T*B terms (t, b) of h[t, b, k] * dz[t, b, j]
    then moves by at most
    2^-7 * sum_(t, b recomputed) |h[t, b, k]| * |dz[t, b, j]|, entry by
    entry, with dz the f32 dz of the plain walk.

    In that case 4 of the 25,200 recomputed h differ: three by one step
    (|h| 1.0e-4 to 1.9e-2) and one, |h| = 2.1e-6, by three steps of its own
    size, 4.5e-8 in all, which the one-step term of the other terms of its
    sums covers many times over. The kernel's dWh is 2.74e-4 off the plain
    one, against 1e-4 of its largest entry, 2.63e-4 to 3.67e-4. Every other
    case holds to the 1e-4 bound alone. At S = 1 no h is recomputed and
    the slack is zero."""
    hprev, T = walk[2].float(), walk[2].shape[0]
    rec = torch.tensor([t % S != 0 for t in range(T)])
    if not rec.any():
        return 0.0
    dz = lstm_kernel.lstm_seq_bwd_plain(*walk, burn)
    return 2.0 ** -7 * torch.einsum("tbk,tbj->kj", hprev[rec].abs(), dz[rec].abs())


@pytest.mark.parametrize("T,B,H,mt", TC_CHUNK_SHAPES)
def test_emulated_tensor_core_forms_in_row_chunks_match_plain_versions(kernels, T, B, H, mt):
    """K1-bf16 (outs, cs), K3-bf16 (dz, dh0, dc0), K2-bf16 (dz), K4-bf16
    (dz, dWh; seams 0 and mixed) and K5-bf16 (dz, dWh at S = 1 and the
    other strides) in two or more row chunks against their bf16 plain
    versions, each launched twice for the same bits, dz zero below each
    seam, and K4-bf16's dz K2-bf16's rounded.

    K5-bf16's dWh is held to 1e-4 of its largest entry, as in the other
    cases, save at RECOMPUTE_SLACK_CASE, which adds the slack of its
    recompute (_recompute_dwh_slack). Where one segment holds the whole
    unroll (S = T), the kernel's own recomputed h is in its scratch, and
    the plain dWh summed from that h must meet the 1e-4 bound alone."""
    for name in ("lstm_fwd_bf16", "lstm_bwd_bf16", "lstm_seq_bwd_bf16",
                 "lstm_seq_bwd_fused_bf16", "lstm_seq_bwd_ckpt_bf16"):
        g = _emulated_geometry(name, B, H, mt)
        assert g.rows == TC_CHUNK_ROWS and g.chunks(B) >= 2 and B % g.rows, (name, g)
    rng, proj, wh, h0, c0, p_outs, p_cs, dout, dcT = _operands(T, B, H, BF16)
    got = _fwd(kernels, proj, wh, h0, c0, mt)
    for a, b in zip(got, (p_outs, p_cs)):
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(map(torch.equal, got, _fwd(kernels, proj, wh, h0, c0, mt)))
    walk = _walk(proj, wh, h0, c0, p_outs, p_cs, dout, dcT)
    got = _seamless(kernels, *walk, mt=mt)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(a, b, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(map(torch.equal, got, _seamless(kernels, *walk, mt=mt)))
    for burn_np in _burns(rng, T, B)[::3]:  # seams 0 and mixed
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz = _seam(kernels, *walk, burn, mt)
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
        _assert_zero_below_seam(dz, burn_np)
        assert torch.equal(dz, _seam(kernels, *walk, burn, mt))
        assert torch.equal(_check_bf16_fused(kernels, walk, burn_np, mt), dz.to(BF16))
    for S in sorted({1, *_strides(T)}):
        for burn_np in _seams_for(rng, T, B, S)[:2]:
            burn = torch.from_numpy(burn_np.astype(np.int32))
            args = (dout, proj, p_outs, p_cs, h0, c0, wh, dcT, burn, S, mt)
            dz, dwh, h_ckpt, c_ckpt = _ckpt(kernels, *args)
            p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(
                dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
            torch.testing.assert_close(dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
            tol = 1e-4 * float(p_dwh.abs().max())
            if (T, B, H, S) == RECOMPUTE_SLACK_CASE:
                tol = tol + _recompute_dwh_slack(walk, burn, S)
            assert ((dwh - p_dwh).abs() <= tol).all(), (S, float((dwh - p_dwh).abs().max()))
            _assert_zero_below_seam(dz, burn_np)
            assert all(map(torch.equal, (dz, dwh), _ckpt(kernels, *args)[:2]))
            if S == T:
                _check_dwh_from_recomputed_h(kernels, walk, args, dwh)


def _check_dwh_from_recomputed_h(kernels, walk, args, dwh):
    """K5-bf16 at S = T, one segment: the plain walk run on the h that the
    kernel recomputed (left in its seg_h scratch: seg_h[s] is the h entering
    step s, s >= 1) gives the kernel's dWh to 1e-4 of its largest entry, the
    bound of every other case."""
    dout, proj, _, _, h0, c0, wh, dcT, burn, S, mt = args
    T, B, H = dout.shape
    h_ckpt, c_ckpt = h0[None].contiguous(), c0.float()[None].contiguous()
    dz, dwh2 = torch.empty(T, B, 4 * H, dtype=BF16), torch.empty(H, 4 * H)
    seg_h, seg_c = torch.empty(S + 1, B, H, dtype=BF16), torch.empty(S + 1, B, H)
    xch = _ring(kernels, "lstm_seq_bwd_ckpt",
                _emulated_geometry("lstm_seq_bwd_ckpt_bf16", B, H, mt), B, H, BF16)
    _split(kernels, "lstm_seq_bwd_ckpt_bf16",
           (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh2, seg_h, seg_c,
            torch.empty(S, B, 4 * H, dtype=BF16), xch), T, B, H, S, max_threads=mt)
    assert torch.equal(dwh2, dwh)
    hprev = torch.cat([h0[None], seg_h[1:S]])
    own = (dout, proj, hprev, *walk[3:])
    dz32 = lstm_kernel.lstm_seq_bwd_plain(*own, burn)
    own_dwh = hprev.float().reshape(T * B, H).T @ dz32.reshape(T * B, 4 * H)
    _assert_dwh_close(dwh, own_dwh)


# ---------------------------------------------------------------------------
# the bulk exchange of all five kernels: a stage ring that wraps many times
# a step
# ---------------------------------------------------------------------------


# column_split.cuh kStages: the stages of the exchange's ring
STAGES = 4
# (T, B, H, shared memory, thread ceiling, kernel): a shared-memory limit
# that narrows the k-tile until the carry product's 4H columns take at
# least 3 * STAGES tiles, so the ring wraps several times a step and its
# barriers' phases run on over steps and chunks; wh streamed with one
# chunk (the first two) and two or more, then pinned with one chunk and
# three; "walk" runs K2, K3 and K4 there. Then K1's and K5's
# rings, where the gate product's H columns take 12 tiles of 8 (K5: at
# S=2, two segments): wh pinned with one chunk, streamed with four.
RING_SHAPES = [pytest.param(*shape, "walk", id="-".join(map(str, shape))) for shape in (
    (5, 9, 40, 30000, 512), (4, 6, 96, 60000, 512), (4, 13, 64, 30000, 512), (3, 37, 64, 30000, 64),
    (6, 5, 32, 26500, 512), (4, 21, 32, 23000, 512))]
RING_SHAPES += [
    pytest.param(5, 9, 96, 48500, 512, "lstm_fwd", id="K1-pinned-5-9-96"),
    pytest.param(4, 13, 96, 26000, 512, "lstm_fwd", id="K1-streamed-chunks-4-13-96"),
    pytest.param(4, 9, 96, 86800, 512, "lstm_seq_bwd_ckpt", id="K5-pinned-4-9-96"),
    pytest.param(4, 13, 96, 30000, 512, "lstm_seq_bwd_ckpt", id="K5-streamed-chunks-4-13-96"),
]
# bf16, (T, B, H, shared memory, rows a chunk, kernel): the tensor-core
# split at (20, 96) in 62,000 bytes (12 tiles of 32 columns), that split
# cut into chunks of 16 rows (K2 and K3 only: K4's dWh stage needs more
# rows) and the split of a batch of 33 in two chunks of 32 (12 tiles of
# 32, wh streamed); K1's gate product in 12 tiles of 16 with wh
# pinned (the split's k-tile narrowed to 16) and streamed in two chunks,
# and K5's in 12 tiles of 32, streamed, in two chunks
RING_SHAPES_BF16 = [pytest.param(*shape, "walk", id="-".join(map(str, shape))) for shape in (
    (4, 20, 96, 62000, None), (3, 20, 96, 62000, 16), (3, 33, 96, 57000, None))]
RING_SHAPES_BF16 += [
    pytest.param(3, 9, 192, 232448, None, "lstm_fwd", id="K1-pinned-3-9-192"),
    pytest.param(3, 20, 192, 41500, 16, "lstm_fwd", id="K1-streamed-chunks-3-20-192"),
    pytest.param(4, 20, 384, 110000, 16, "lstm_seq_bwd_ckpt", id="K5-streamed-chunks-4-20-384"),
]


def _check_ring(kernels, T, B, H, g, dtype, fused):
    """K2 (seams 0, mid, T-1, mixed) and K3 at geometry g against their
    plain versions, each twice for the same bits; with `fused`, K4 at g
    too: its dWh against the plain version, twice for the same bits, and
    its dz equal to K2's (bf16: rounded) bit for bit."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H, dtype)
    walk = _walk(proj, wh, h0, c0, outs, cs, dout, dcT)
    f32 = dtype == torch.float32
    tol = dict(rtol=0, atol=1e-4) if f32 else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    sfx = "" if f32 else "_bf16"
    seam_ring, seamless_ring = (_ring(kernels, s, g, B, H, dtype) for s in ("lstm_seq_bwd",
                                                                             "lstm_bwd"))

    def seam(burn):
        dz = torch.empty(T, B, 4 * H)
        _launch_at(kernels, "lstm_seq_bwd" + sfx, (*walk, burn, dz, seam_ring), T, B, H, g)
        return dz

    def seamless():
        out = torch.empty(T, B, 4 * H), torch.empty(B, H), torch.empty(B, H)
        _launch_at(kernels, "lstm_bwd" + sfx, (*walk, *out, seamless_ring), T, B, H, g)
        return out

    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz = seam(burn)
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn), **tol)
        _assert_zero_below_seam(dz, burn_np)
        assert torch.equal(seam(burn), dz)
        if fused:
            f_dz, dwh = _fused_at(kernels, walk, burn, g)
            assert torch.equal(f_dz, dz if f32 else dz.to(dtype))
            _assert_dwh_close(dwh, lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)[1])
            assert all(map(torch.equal, (f_dz, dwh), _fused_at(kernels, walk, burn, g)))
    got = seamless()
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(seamless(), got):
        assert torch.equal(a, b)


def _check_gate_ring(kernels, T, B, H, g, dtype, source):
    """K1 (outs, cs) or K5 (dz, dWh at S=2, seams on and inside segments)
    at geometry g against their plain versions, each twice for the same
    bits; K5's ring is K2's and K1's side by side (ExchangeRing)."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H, dtype)
    f32 = dtype == torch.float32
    sfx = "" if f32 else "_bf16"
    tol = dict(rtol=0, atol=1e-5) if f32 else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    ring = _ring(kernels, source, g, B, H, dtype)
    if source == "lstm_fwd":
        def fwd():
            got = torch.empty(T, B, H, dtype=dtype), torch.empty(T, B, H)
            _launch_at(kernels, "lstm_fwd" + sfx, (proj, wh, h0, c0, *got, ring), T, B, H, g)
            return got
        got = fwd()
        for a, b in zip(got, (outs, cs)):
            torch.testing.assert_close(a.float(), b.float(), **tol)
        assert all(map(torch.equal, got, fwd()))
        return
    assert ring.numel() == sum(_ring(kernels, s, g, B, H, dtype).numel()
                               for s in ("lstm_seq_bwd", "lstm_fwd"))
    S = 2
    h_ckpt = torch.cat([h0[None], outs[S - 1 : T - 1 : S]]).contiguous()
    c_ckpt = torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]]).contiguous()

    def ckpt(burn):
        dz, dwh = torch.empty(T, B, 4 * H, dtype=dtype), torch.empty(H, 4 * H)
        seg = torch.empty(S + 1, B, H, dtype=dtype), torch.empty(S + 1, B, H)
        dz_lo = None if f32 else torch.empty(S, B, 4 * H, dtype=dtype)
        _launch_at(kernels, "lstm_seq_bwd_ckpt" + sfx,
                   (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, *seg, dz_lo, ring),
                   T, B, H, g, S)
        return dz, dwh

    for burn_np in _seams_for(rng, T, B, S)[:2]:
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz, dwh = ckpt(burn)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(dout, proj, h_ckpt, c_ckpt, wh, dcT,
                                                          burn, S)
        torch.testing.assert_close(dz.float(), p_dz.float(),
                                   **(dict(rtol=0, atol=1e-4) if f32 else tol))
        _assert_dwh_close(dwh, p_dwh)
        _assert_zero_below_seam(dz, burn_np)
        assert all(map(torch.equal, (dz, dwh), ckpt(burn)))


@pytest.mark.parametrize("T,B,H,smem,mt,kernel", RING_SHAPES)
def test_emulated_bulk_exchange_ring_wraps_in_float32(kernels, T, B, H, smem, mt, kernel):
    if kernel != "walk":
        g = lstm_kernel.lstm_geometry(B, H, kernel, EMULATED_SMS, smem, 4, mt)
        assert -(-H // g.k_tile) >= 3 * STAGES, g
        _check_gate_ring(kernels, T, B, H, g, torch.float32, kernel)
        return
    g = lstm_kernel.lstm_geometry(B, H, "lstm_seq_bwd", EMULATED_SMS, smem, 4, mt)
    assert -(-4 * H // g.k_tile) >= 3 * STAGES, g
    assert g == lstm_kernel.lstm_geometry(B, H, "lstm_seq_bwd_fused", EMULATED_SMS, smem, 4, mt)
    _check_ring(kernels, T, B, H, g, torch.float32, fused=True)


@pytest.mark.parametrize("T,B,H,smem,rows,kernel", RING_SHAPES_BF16)
def test_emulated_bulk_exchange_ring_wraps_in_bf16(kernels, T, B, H, smem, rows, kernel):
    sms = max(EMULATED_SMS, -(-H // 64))
    if kernel != "walk":
        g = lstm_kernel.lstm_geometry(B, H, kernel, sms, smem, 2, 512, rows)
        if g.pinned:  # the pinned split's k-tile narrowed: more tiles, no more bytes
            g = g._replace(k_tile=16)
        assert -(-H // g.k_tile) >= 3 * STAGES, g
        _check_gate_ring(kernels, T, B, H, g, BF16, kernel)
        return
    g = lstm_kernel.lstm_geometry(B, H, "lstm_seq_bwd", sms, smem, 2)
    assert -(-4 * H // g.k_tile) >= 3 * STAGES, g
    if rows:  # the split cut into row chunks (K4's dWh stage is not sized for it)
        g = g._replace(rows=rows)
        assert g.chunks(B) >= 2
    _check_ring(kernels, T, B, H, g, BF16, fused=rows is None)
