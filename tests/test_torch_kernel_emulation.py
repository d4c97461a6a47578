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
`__syncthreads`, `__ldg`, `__ldcg`,
`__threadfence`, `__nanosleep`, an integer `atomicAdd`, `float4`, `uint2`,
`__uint_as_float`, 1-D thread and block indices (`__launch_bounds__` is
dropped), and of cuda_bf16.h the type `__nv_bfloat16` with its two
conversions (tests/cuda_emulation/cuda_bf16.h). A cooperative
launch runs all its blocks at once, so the column-split kernels (K1 to
K5) run here with their hand-written grid barrier, at a geometry cut
to four blocks; a misplaced exchange or barrier reads another block's
columns before they are written. Each kernel also runs at a thread
ceiling cut so far that the batch takes two or more row chunks (the last
one ragged), and the bf16 forms of K1, K2 and K5 run against their plain
versions in bf16. A kernel whose body leaves the subset (clusters,
warp intrinsics, wgmma, TMA) is dropped from this test and is held
against its plain version by tests/test_torch_cuda.py and chip_smoke.py
only; the header is not meant to grow into a CUDA emulator.

Tolerance: both sides sum in float32 in other orders; forward 1e-5, dz 1e-4
absolute, and dz exactly zero below each row's seam. dWh is held to 1e-4 of
its largest entry: each entry sums T*B products in another order (K4:
per column slice over (t, b); K5: per segment, newest first), and entries
that cancel to near zero have no meaningful relative error. The
column-split kernels sum every output in one fixed order, so two launches
give the same bits, and K4 walks as K2 does in K2's geometry, so its dz
is K2's bit for bit.

bf16 forms: both sides sum exact products of bf16 values in float32, in
other orders, so a value can round to the neighbouring bf16 value where
the two sums straddle a rounding boundary, a step of 2^-8 of it, which
then feeds the later steps. Forward outs (bf16), cs, and dz (K2's f32,
K5's bf16) are held to two such steps (BF16_RTOL = 2^-7) plus BF16_ATOL
absolute; K5's dWh, summed in f32 from the f32 dz, to 1e-4 of its
largest entry as in float32 (summing the rounded dz instead would be off
by about 1e-3). Two launches still give the same bits.
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
    src = re.sub(r"__launch_bounds__\(\w+\)", "", src)  # a register budget: no CPU meaning
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
    forms = {}
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


def _split(kernels, name, tensors, T, B, H, *ints, max_threads=512):
    """Launch the column-split kernel form `name` at the emulated geometry
    (its dtype's, within `max_threads`), with the walk's carry workspace
    where the batch takes more than one chunk and a zeroed grid barrier;
    `ints` (K5's S) come between H and the geometry. -> the geometry."""
    src = lstm_kernel._SOURCE[name]
    itemsize = 2 if name.endswith("_bf16") else 4
    g = lstm_kernel.lstm_geometry(B, H, src, EMULATED_SMS, SMEM_LIMIT, itemsize, max_threads)
    if src != "lstm_fwd":
        tensors = (*tensors, lstm_kernel._carry_workspace(g, B, "cpu"))
    _call(kernels[name], (*tensors, torch.zeros(2, dtype=torch.int32)), T, B, H, *ints,
          *lstm_kernel._geometry_ints(g))
    return g


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


def _fwd(kernels, proj, wh, h0, c0, mt=512):
    T, B, H4 = proj.shape
    outs, cs = torch.empty(T, B, H4 // 4, dtype=proj.dtype), torch.empty(T, B, H4 // 4)
    name = "lstm_fwd" if proj.dtype == torch.float32 else "lstm_fwd_bf16"
    _split(kernels, name, (proj, wh, h0, c0, outs, cs), T, B, H4 // 4, max_threads=mt)
    return outs, cs


def _seam(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn, mt=512):
    T, B, H = cs.shape
    dz = torch.empty(T, B, 4 * H)
    if proj.dtype == torch.float32:
        name, xch = "lstm_seq_bwd", None
    else:
        name, xch = "lstm_seq_bwd_bf16", torch.empty(2, B, 4 * H, dtype=proj.dtype)
    _split(kernels, name, (dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, xch), T, B, H,
           max_threads=mt)
    return dz


def _seamless(kernels, dout, proj, hprev, cprev, cs, wh, dcT, mt=512):
    T, B, H = cs.shape
    dz, dh0, dc0 = torch.empty(T, B, 4 * H), torch.empty(B, H), torch.empty(B, H)
    _split(kernels, "lstm_bwd", (dout, proj, hprev, cprev, cs, wh, dcT, dz, dh0, dc0), T, B, H,
           max_threads=mt)
    return dz, dh0, dc0


def _fused(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn, mt=512):
    T, B, H = cs.shape
    dz, dwh = torch.empty(T, B, 4 * H), torch.empty(H, 4 * H)
    _split(kernels, "lstm_seq_bwd_fused", (dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh),
           T, B, H, max_threads=mt)
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
        name, dz32 = "lstm_seq_bwd_ckpt", None
    else:
        name, dz32 = "lstm_seq_bwd_ckpt_bf16", torch.empty(S, B, 4 * H)
    _split(kernels, name, (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, *seg, dz32),
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


# ---------------------------------------------------------------------------
# the bf16 forms of K1, K2 and K5
# ---------------------------------------------------------------------------


# bf16 row chunks: K5's dWh pass stages 8 bf16 h values per copy, so it
# needs two threads per unit, two row groups at these ceilings (2 and 3
# chunks)
BF16_CHUNK_SHAPES = [(7, 9, 32, 16), (4, 21, 40, 20)]


@pytest.mark.parametrize("T,B,H,mt", [(T, B, H, 512) for T, B, H in SHAPES] + BF16_CHUNK_SHAPES)
def test_emulated_bf16_kernels_match_plain_versions(kernels, T, B, H, mt):
    """K1, K2 (seams 0, mid, T-1, mixed) and K5 (two strides, seams on and
    inside segments) with bf16 operands, one chunk and row chunks, against
    their bf16 plain versions; each launched twice for the same bits."""
    for name in lstm_kernel.SOURCES:
        g = lstm_kernel.lstm_geometry(B, H, name, EMULATED_SMS, SMEM_LIMIT, 2, mt)
        assert g.chunks(B) >= 2 or mt == 512, (name, g)
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
