"""The CUDA sources of r2d2_tpu_torch/csrc, compiled with g++ against a CPU
emulation of the CUDA subset they use (tests/cuda_emulation/cuda_runtime.h),
called through the same plain C interface and argument order the port's
ctypes wrappers use, and held against the kernels' plain PyTorch versions.

This checks each kernel's indexing, ragged-edge masks, seam masks and the
placement of its block barriers (shared memory starts poisoned, so a read
before its write shows) on a machine without a card. It checks nothing of
warps, the memory model or speed: the kernels themselves are held against
the plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py.

The emulated subset is small on purpose: one `extern __shared__` array, one
`<<<>>>` launch per source, `__syncthreads`, `__ldg`, and 1-D thread and
block indices. A kernel whose body leaves it (clusters, cooperative
launches, warp intrinsics, wgmma, TMA) is dropped from this test and is
held against its plain version by tests/test_torch_cuda.py and
chip_smoke.py only; the header is not meant to grow into a CUDA emulator.

Tolerance: both sides sum in float32 in other orders; forward 1e-5, dz 1e-4
absolute, and dz exactly zero below each row's seam.
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
N_PTRS = {"lstm_fwd": 6, "lstm_seq_bwd": 10}


def _emulated(name, out_dir):
    """csrc/<name>.cu rewritten for the emulation header and built with g++."""
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    src = src.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    src, n = re.subn(r"(\w+)<<<([^>]*)>>>\((.*?)\);", r"emulate(\2, [&] { \1(\3); });",
                     src, flags=re.S)
    assert n == 1, f"{name}.cu: expected one kernel launch"
    cpp = os.path.join(out_dir, f"{name}.cpp")
    with open(cpp, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-I", os.path.join(HERE, "cuda_emulation"), "-o", lib, cpp],
        check=True, capture_output=True, text=True,
    )
    fn = getattr(ctypes.CDLL(lib), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * N_PTRS[name] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("emulated_kernels"))
    return {name: _emulated(name, out) for name in N_PTRS}


def _call(fn, tensors, T, B, H):
    assert fn(*(t.data_ptr() for t in tensors), T, B, H, None) == 0


# (T, B, H): a ragged batch tile, H not a multiple of the 32-thread warp,
# H above the 512-thread block (two hidden units per thread), a tiny H
@pytest.mark.parametrize("T,B,H", [(7, 5, 32), (4, 9, 40), (3, 2, 600), (6, 4, 8)])
def test_emulated_kernels_match_plain_versions(kernels, T, B, H):
    rng = np.random.default_rng(T * B + H)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    proj = t(rng.normal(size=(T, B, 4 * H)))
    wh = t(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    h0, c0 = t(rng.normal(size=(B, H)) * 0.3), t(rng.normal(size=(B, H)) * 0.3)
    outs, cs = torch.empty(T, B, H), torch.empty(T, B, H)
    _call(kernels["lstm_fwd"], (proj, wh, h0, c0, outs, cs), T, B, H)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    torch.testing.assert_close(outs, p_outs, rtol=0, atol=1e-5)
    torch.testing.assert_close(cs, p_cs, rtol=0, atol=1e-5)

    hprev = torch.cat([h0[None], outs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dout, dcT = t(rng.normal(size=(T, B, H))), t(rng.normal(size=(B, H)))
    for burn_np in (np.zeros(B), np.full(B, T // 2), np.full(B, T - 1), rng.integers(0, T, B)):
        burn = torch.from_numpy(burn_np.astype(np.int32))
        dz = torch.empty(T, B, 4 * H)
        _call(kernels["lstm_seq_bwd"],
              (dout, proj, hprev, cprev, cs, wh, wh.t().contiguous(), dcT, burn, dz), T, B, H)
        plain = lstm_kernel.lstm_seq_bwd_plain(dout, proj, hprev, cprev, cs, wh, dcT, burn)
        torch.testing.assert_close(dz, plain, rtol=0, atol=1e-4)
        for b in range(B):
            assert not dz[: int(burn_np[b]), b].any()
