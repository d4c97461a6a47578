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
one `<<<>>>` launch per source or cooperative launches through the
template `cudaLaunchKernelEx`, `__syncthreads`, `__ldg`, `__ldcg`,
`__threadfence`, `__nanosleep`, an integer `atomicAdd`, `float4`, and 1-D
thread and block indices (`__launch_bounds__` is dropped). A cooperative
launch runs all its blocks at once, so the column-split kernels (K1, K2,
K3, K5) run here with their hand-written grid barrier, at a geometry cut
to four blocks; a misplaced exchange or barrier reads another block's
columns before they are written. A kernel whose body leaves the subset (clusters,
warp intrinsics, wgmma, TMA) is dropped from this test and is held
against its plain version by tests/test_torch_cuda.py and chip_smoke.py
only; the header is not meant to grow into a CUDA emulator.

Tolerance: both sides sum in float32 in other orders; forward 1e-5, dz 1e-4
absolute, and dz exactly zero below each row's seam. dWh is held to 1e-4 of
its largest entry: each entry sums T*B products in another order (K4:
per-block partials, then over blocks; K5: per segment, newest first), and
entries that cancel to near zero have no meaningful relative error. The
column-split kernels sum every output in one fixed order, so two launches
give the same bits.
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
# each kernel's (pointers, ints): the ints are T, B, H (and S, or the
# column split's geometry), then the stream
ARGS = {
    "lstm_fwd": (7, 9),
    "lstm_seq_bwd": (10, 9),
    "lstm_bwd": (11, 9),
    "lstm_seq_bwd_fused": (13, 3),
    "lstm_seq_bwd_ckpt": (12, 10),
}


def _emulated(name, out_dir):
    """csrc/<name>.cu rewritten for the emulation header and built with g++."""
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = src.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    src = re.sub(r"__launch_bounds__\(\w+\)", "", src)  # a register budget: no CPU meaning
    src, n = re.subn(r"(\w+)<<<([^>]*)>>>\((.*?)\);", r"emulate(\2, [&] { \1(\3); });",
                     src, flags=re.S)
    # one <<<>>> launch, or cooperative ones (column_split.cuh)
    assert n == 1 or (n == 0 and "launch_cooperative(" in src), f"{name}.cu: launches?"
    cpp = os.path.join(out_dir, f"{name}.cpp")
    with open(cpp, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-I", os.path.join(HERE, "cuda_emulation"), "-I", CSRC, "-o", lib, cpp],
        check=True, capture_output=True, text=True,
    )
    fn = getattr(ctypes.CDLL(lib), f"{name}_launch")
    n_ptrs, n_ints = ARGS[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("emulated_kernels"))
    return {name: _emulated(name, out) for name in ARGS}


def _call(fn, tensors, *ints):
    assert fn(*(t.data_ptr() for t in tensors), *ints, None) == 0


# the column split cut to at most four blocks, so an emulated launch runs
# a few hundred threads at once
EMULATED_SMS = 4
SMEM_LIMIT = 232_448


def _split(kernels, name, tensors, T, B, H, *ints):
    """Launch the column-split kernel `name` at the emulated geometry, with
    a zeroed grid barrier; `ints` (K5's S) come between H and the
    geometry."""
    g = lstm_kernel.lstm_geometry(B, H, name, EMULATED_SMS, SMEM_LIMIT)
    _call(kernels[name], (*tensors, torch.zeros(2, dtype=torch.int32)), T, B, H, *ints, g.units,
          g.grid, g.threads, g.k_tile, int(g.pinned), g.smem_bytes)


# (T, B, H): a ragged batch tile, H not a multiple of the 32-thread warp,
# H above the 512-thread block (two hidden units per thread; for K1/K2 a
# wh slice streamed in ragged k-tiles), a tiny H
SHAPES = [(7, 5, 32), (4, 9, 40), (3, 2, 600), (6, 4, 8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _operands(T, B, H):
    """Random operands and the plain forward's residuals at one shape."""
    rng = np.random.default_rng(T * B + H)
    proj = _t(rng.normal(size=(T, B, 4 * H)))
    wh = _t(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    h0, c0 = _t(rng.normal(size=(B, H)) * 0.3), _t(rng.normal(size=(B, H)) * 0.3)
    outs, cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    dout, dcT = _t(rng.normal(size=(T, B, H))), _t(rng.normal(size=(B, H)))
    return rng, proj, wh, h0, c0, outs, cs, dout, dcT


def _burns(rng, T, B):
    """Seams at 0, mid, T-1 and mixed per row."""
    return [np.zeros(B), np.full(B, T // 2), np.full(B, T - 1), rng.integers(0, T, B)]


def _assert_dwh_close(got, want):
    tol = 1e-4 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def _assert_zero_below_seam(dz, burn_np):
    for b in range(dz.shape[1]):
        assert not dz[: int(burn_np[b]), b].any()


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_kernels_match_plain_versions(kernels, T, B, H):
    rng = np.random.default_rng(T * B + H)
    proj = _t(rng.normal(size=(T, B, 4 * H)))
    wh = _t(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    h0, c0 = _t(rng.normal(size=(B, H)) * 0.3), _t(rng.normal(size=(B, H)) * 0.3)
    outs, cs = torch.empty(T, B, H), torch.empty(T, B, H)
    _split(kernels, "lstm_fwd", (proj, wh, h0, c0, outs, cs), T, B, H)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    torch.testing.assert_close(outs, p_outs, rtol=0, atol=1e-5)
    torch.testing.assert_close(cs, p_cs, rtol=0, atol=1e-5)

    hprev = torch.cat([h0[None], outs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dout, dcT = _t(rng.normal(size=(T, B, H))), _t(rng.normal(size=(B, H)))
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz = torch.empty(T, B, 4 * H)
        _split(kernels, "lstm_seq_bwd", (dout, proj, hprev, cprev, cs, wh, dcT, burn, dz),
               T, B, H)
        plain = lstm_kernel.lstm_seq_bwd_plain(dout, proj, hprev, cprev, cs, wh, dcT, burn)
        torch.testing.assert_close(dz, plain, rtol=0, atol=1e-4)
        _assert_zero_below_seam(dz, burn_np)


def _seamless(kernels, dout, proj, hprev, cprev, cs, wh, dcT):
    T, B, H = cs.shape
    dz, dh0, dc0 = torch.empty(T, B, 4 * H), torch.empty(B, H), torch.empty(B, H)
    _split(kernels, "lstm_bwd", (dout, proj, hprev, cprev, cs, wh, dcT, dz, dh0, dc0), T, B, H)
    return dz, dh0, dc0


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_seamless_backward_matches_plain_version(kernels, T, B, H):
    _, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    hprev, cprev = torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]])
    dz, dh0, dc0 = _seamless(kernels, dout, proj, hprev, cprev, cs, wh, dcT)
    p_dz, p_dh0, p_dc0 = lstm_kernel.lstm_bwd_plain(dout, proj, hprev, cprev, cs, wh, dcT)
    torch.testing.assert_close(dz, p_dz, rtol=0, atol=1e-4)
    torch.testing.assert_close(dh0, p_dh0, rtol=0, atol=1e-4)
    torch.testing.assert_close(dc0, p_dc0, rtol=0, atol=1e-4)


def _fused(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn):
    T, B, H = cs.shape
    dz, dwh = torch.empty(T, B, 4 * H), torch.empty(H, 4 * H)
    part, ticket = lstm_kernel._dwh_workspace(B, H, torch.device("cpu"))
    _call(kernels["lstm_seq_bwd_fused"],
          (dout, proj, hprev, cprev, cs, wh, wh.t().contiguous(), dcT, burn, dz, dwh, part,
           ticket), T, B, H)
    return dz, dwh


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_fused_dwh_backward_matches_plain_version(kernels, T, B, H):
    """dz and dWh (summed in the kernel) against the plain version."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    hprev, cprev = torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]])
    for burn_np in _burns(rng, T, B):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz, dwh = _fused(kernels, dout, proj, hprev, cprev, cs, wh, dcT, burn)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(
            dout, proj, hprev, cprev, cs, wh, dcT, burn)
        torch.testing.assert_close(dz, p_dz, rtol=0, atol=1e-4)
        _assert_dwh_close(dwh, p_dwh)
        _assert_zero_below_seam(dz, burn_np)


def _strides(T):
    """Two segment lengths: the smallest divisor >= 2 of T, and 1 or T."""
    s = min(d for d in range(2, T + 1) if T % d == 0)
    return [s, T if s < T else 1]


def _ckpt(kernels, dout, proj, outs, cs, h0, c0, wh, dcT, burn, S):
    """(dz, dwh, h_ckpt, c_ckpt) of K5 at segment length S."""
    T, B, H = cs.shape
    h_ckpt = torch.cat([h0[None], outs[S - 1 : T - 1 : S]]).contiguous()
    c_ckpt = torch.cat([c0[None], cs[S - 1 : T - 1 : S]]).contiguous()
    dz, dwh = torch.empty(T, B, 4 * H), torch.empty(H, 4 * H)
    seg = torch.empty(S + 1, B, H), torch.empty(S + 1, B, H)
    _split(kernels, "lstm_seq_bwd_ckpt",
           (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, *seg), T, B, H, S)
    return dz, dwh, h_ckpt, c_ckpt


def _seams_for(rng, T, B, S):
    """Seams on segment boundaries, inside segments, and at 0 / T-1."""
    on = rng.integers(0, T // S, B) * S
    inside = on + (rng.integers(1, S, B) if S > 1 else 0)
    return (on, np.minimum(inside, T - 1), np.zeros(B), np.full(B, T - 1))


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_emulated_ckpt_backward_matches_plain_version(kernels, T, B, H):
    """At two strides, with seams on segment boundaries, inside segments,
    and at 0 / T-1."""
    rng, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    for S in _strides(T):
        for burn_np in _seams_for(rng, T, B, S):
            burn = torch.from_numpy(burn_np.astype(np.int32))
            dz, dwh, h_ckpt, c_ckpt = _ckpt(kernels, dout, proj, outs, cs, h0, c0, wh, dcT,
                                            burn, S)
            p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(
                dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
            torch.testing.assert_close(dz, p_dz, rtol=0, atol=1e-4)
            _assert_dwh_close(dwh, p_dwh)
            _assert_zero_below_seam(dz, burn_np)


@pytest.mark.parametrize("T,B,H", [(7, 5, 32), (6, 4, 8)])
def test_emulated_seamless_backward_gives_the_same_bits_every_launch(kernels, T, B, H):
    _, proj, wh, h0, c0, outs, cs, dout, dcT = _operands(T, B, H)
    walk = (dout, proj, torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]]), cs,
            wh, dcT)
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
