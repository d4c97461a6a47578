"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one (the kernels have
no CPU mode). The file imports nothing of JAX, so on a machine with the card
and without JAX it runs on its own, skipping the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: the kernels and the plain versions both work in float32 but sum
the H-long (and 4H-long) dot products in other orders, and the recurrence
carries those differences through T steps; 1e-4 absolute (dz also 1e-4
relative) holds them with room at T=85, H=512. dWh, summed in the kernel
(K4 per column slice, windows of 17 steps newest first, K5 per column
slice and segment), is
held to 1e-4 of its largest entry: each entry sums T*B products of both
signs, so entries that cancel to near zero have no meaningful relative
error. K4's dz is held to K2's bit for bit: the same walk on the same
exchange in the same geometry.

Row chunks: batches wider than one block's threads (B=600 at H=512, B=200
at H=2048) are walked in two chunks per step, held to the same bounds.

bf16 forms (all five): both sides sum exact products of bf16 values in
float32 in other orders, so a value may round to the neighbouring bf16
value (2^-8 relative) where the two sums straddle a rounding boundary,
and that step feeds the later ones: outs, cs and dz are held to
BF16_ATOL absolute plus BF16_RTOL relative, dWh to BF16_DWH of its
largest entry. Two launches still give the same bits. All five bf16
forms sum their products on the tensor cores (mma.sync), whose f32 sums
take yet another order (K4's and K5's dWh from dz in two bf16 planes,
about 16 bits of it): the same class holds them.

Serving (r2d2_tpu_torch/serve): the pipelined server's pinned read-back
and its event against the serial server bit for bit, the cache written in
place across one session's back-to-back batches, and a bf16 carry's spill
round trip, all on the card. The fleet (serve/multi.py) and the live loop
(liveloop/): two replicas on cuda:0 answering bit for bit as their own
reference_act, with the tap's carries (gathered at dispatch, read back
through pinned buffers) equal to the reference's; and the closed loop on
catch, whose served return improves as it trains on its own traffic.
"""

import copy
import time

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    PinnedStager,
    TrainState,
    make_optimizer,
    make_train_step,
)
from r2d2_tpu_torch.models.r2d2 import init_params
from r2d2_tpu_torch.ops import lstm_kernel

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


SHAPES = [(7, 5, 32), (13, 67, 96), (3, 2, 640), (85, 64, 512)]
# batches the column split walks in two row chunks per step
CHUNKED = [(5, 600, 512), (4, 200, 2048)]
BF16 = torch.bfloat16
BF16_ATOL, BF16_RTOL, BF16_DWH = 2e-2, 2e-2, 1e-2


# K1/K2 also at the xl width, where their wh slice is streamed
@pytest.mark.parametrize("shape", SHAPES + [(85, 64, 2048)])
def test_kernels_match_plain_versions(cuda, shape):
    T, B, H = shape
    rng = np.random.default_rng(T * B + H)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)

    proj = put(rng.normal(size=(T, B, 4 * H)))
    wh = put(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    h0, c0 = put(rng.normal(size=(B, H)) * 0.3), put(rng.normal(size=(B, H)) * 0.3)
    lstm_kernel.reset_launch_counts()
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    torch.testing.assert_close(outs, p_outs, rtol=0, atol=1e-4)
    torch.testing.assert_close(cs, p_cs, rtol=0, atol=1e-4)
    hprev = torch.cat([h0[None], outs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dout, dcT = put(rng.normal(size=(T, B, H))), put(rng.normal(size=(B, H)))
    for burn_np in (np.zeros(B), np.full(B, T // 2), np.full(B, T - 1), rng.integers(0, T, B)):
        burn = torch.from_numpy(burn_np.astype(np.int32)).to(cuda)
        args = (dout, proj, hprev, cprev, cs, wh, dcT, burn)
        dz = lstm_kernel.lstm_seq_bwd(*args)
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*args), rtol=1e-4, atol=1e-4)
        for b in range(B):
            assert not dz[: int(burn_np[b]), b].any()
    torch.cuda.synchronize()
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_fwd=1, lstm_seq_bwd=4)


def _assert_dwh_close(got, want):
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_arm_kernels_match_plain_versions(cuda, shape):
    """K3 (no seam), K4 (fused dWh) and K5 (checkpointed, at every divisor
    stride of T) against their plain versions, seams at 0, mid, T-1 and
    mixed."""
    T, B, H = shape
    rng = np.random.default_rng(T * B + H + 1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)

    proj = put(rng.normal(size=(T, B, 4 * H)))
    wh = put(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    h0, c0 = put(rng.normal(size=(B, H)) * 0.3), put(rng.normal(size=(B, H)) * 0.3)
    outs, cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    hprev, cprev = torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]])
    dout, dcT = put(rng.normal(size=(T, B, H))), put(rng.normal(size=(B, H)))
    walk = (dout, proj, hprev, cprev, cs, wh, dcT)
    lstm_kernel.reset_launch_counts()
    for got, want in zip(lstm_kernel.lstm_bwd(*walk), lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    strides = [S for S in range(1, T + 1) if T % S == 0]
    for burn_np in (np.zeros(B), np.full(B, T // 2), np.full(B, T - 1), rng.integers(0, T, B)):
        burn = torch.from_numpy(burn_np.astype(np.int32)).to(cuda)
        dz, dwh = lstm_kernel.lstm_seq_bwd_fused(*walk, burn)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)
        torch.testing.assert_close(dz, p_dz, rtol=1e-4, atol=1e-4)
        _assert_dwh_close(dwh, p_dwh)
        for S in strides:
            h_ckpt = torch.cat([h0[None], outs[S - 1 : T - 1 : S]])
            c_ckpt = torch.cat([c0[None], cs[S - 1 : T - 1 : S]])
            args = (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
            dz_k, dwh_k = lstm_kernel.lstm_seq_bwd_ckpt(*args)
            p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(*args)
            torch.testing.assert_close(dz_k, p_dz, rtol=1e-4, atol=1e-4)
            _assert_dwh_close(dwh_k, p_dwh)
            for b in range(B):
                assert not dz_k[: int(burn_np[b]), b].any()
        for b in range(B):
            assert not dz[: int(burn_np[b]), b].any()
    torch.cuda.synchronize()
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_bwd=1, lstm_seq_bwd_fused=4,
        lstm_seq_bwd_ckpt=4 * len(strides))


def test_column_split_kernels_give_the_same_bits_every_launch(cuda):
    """K1, K2, K3 (dz, dh0, dc0), K4 (dz, dWh) and K5 (dz, dWh at S=5) at
    the atari widths: no float atomics, each output summed by one thread
    in a fixed order."""
    T, B, H = 85, 64, 512
    g = torch.Generator(device=cuda).manual_seed(3)
    proj = torch.randn(T, B, 4 * H, device=cuda, generator=g)
    wh = (torch.rand(H, 4 * H, device=cuda, generator=g) * 2 - 1) * H ** -0.5
    h0, c0 = (torch.randn(B, H, device=cuda, generator=g) * 0.3 for _ in range(2))
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    again = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    assert torch.equal(outs, again[0]) and torch.equal(cs, again[1])
    hprev, cprev = torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]])
    walk = (torch.randn(T, B, H, device=cuda, generator=g), proj, hprev, cprev, cs, wh,
            torch.randn(B, H, device=cuda, generator=g),
            torch.randint(0, T, (B,), device=cuda, generator=g, dtype=torch.int32))
    assert torch.equal(lstm_kernel.lstm_seq_bwd(*walk), lstm_kernel.lstm_seq_bwd(*walk))
    for a, b in zip(lstm_kernel.lstm_bwd(*walk[:-1]), lstm_kernel.lstm_bwd(*walk[:-1])):
        assert torch.equal(a, b)
    for a, b in zip(lstm_kernel.lstm_seq_bwd_fused(*walk), lstm_kernel.lstm_seq_bwd_fused(*walk)):
        assert torch.equal(a, b)
    S = 5
    ckpt = (walk[0], proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
            torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, walk[6], walk[7], S)
    for a, b in zip(lstm_kernel.lstm_seq_bwd_ckpt(*ckpt), lstm_kernel.lstm_seq_bwd_ckpt(*ckpt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(85, 64, 2048)])
def test_fused_dwh_dz_is_the_seam_backwards_bit_for_bit(cuda, shape):
    """K4 runs K2's walk in K2's geometry: the same dz bits at the same
    inputs, seams at 0, mid, T-1 and mixed."""
    T, B, H = shape
    g = torch.Generator(device=cuda).manual_seed(T * B + H)
    proj = torch.randn(T, B, 4 * H, device=cuda, generator=g)
    wh = (torch.rand(H, 4 * H, device=cuda, generator=g) * 2 - 1) * H ** -0.5
    h0, c0 = (torch.randn(B, H, device=cuda, generator=g) * 0.3 for _ in range(2))
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    walk = (torch.randn(T, B, H, device=cuda, generator=g), proj,
            torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]]), cs, wh,
            torch.randn(B, H, device=cuda, generator=g))
    mixed = torch.randint(0, T, (B,), device=cuda, generator=g, dtype=torch.int32)
    for burn in (torch.zeros_like(mixed), torch.full_like(mixed, T // 2),
                 torch.full_like(mixed, T - 1), mixed):
        assert torch.equal(lstm_kernel.lstm_seq_bwd_fused(*walk, burn)[0],
                           lstm_kernel.lstm_seq_bwd(*walk, burn))


# K2, K3 and K4 take their carry product's rows through TMA bulk copies
# into an mbarrier ring (column_split.cuh "The exchange"): the atari widths,
# the wide model's batch 96 and xl
EXCHANGE_SHAPES = [(85, 64, 512), (85, 96, 1024), (85, 64, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", EXCHANGE_SHAPES, ids=str)
def test_bulk_exchange_kernels_on_the_card(cuda, shape, dtype):
    """K2 (seams 0, mid, T-1, mixed) and K3 against their plain versions,
    three launches of each giving the same bits, and K4's dz equal to
    K2's bit for bit (bf16: K4-bf16's dz is K2-bf16's f32 dz rounded): K4
    walks on the same ring in the same split."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, dtype, T * B + H)
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    walk = (dout, proj, torch.cat([h0[None], outs[:-1]]),
            torch.cat([c0.float()[None], cs[:-1]]), cs, wh, dcT)
    f32 = dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    for burn in (torch.zeros_like(mixed), torch.full_like(mixed, T // 2),
                 torch.full_like(mixed, T - 1), mixed):
        dz = lstm_kernel.lstm_seq_bwd(*walk, burn)
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn), **tol)
        f_dz = lstm_kernel.lstm_seq_bwd_fused(*walk, burn)[0]
        assert torch.equal(f_dz, dz if f32 else dz.to(BF16))
    for _ in range(2):
        assert torch.equal(lstm_kernel.lstm_seq_bwd(*walk, mixed), dz)
    got = lstm_kernel.lstm_bwd(*walk)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(a, b, **tol)
    for _ in range(2):
        for a, b in zip(lstm_kernel.lstm_bwd(*walk), got):
            assert torch.equal(a, b)


# K4 on the ring, its dWh pass on a stage ring of its own: the exchange
# shapes and two batches walked in row chunks
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", EXCHANGE_SHAPES + [(85, 1024, 512), (85, 256, 2048)], ids=str)
def test_fused_dwh_on_the_ring_on_the_card(cuda, shape, dtype):
    """K4 (seams 0 and mixed) against its plain version (dWh to 1e-4 of its
    largest entry, bf16 BF16_DWH), two more launches giving the same bits,
    and its dz K2's bit for bit (bf16: K2-bf16's f32 dz rounded)."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, dtype, T * B + H + 2)
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    walk = (dout, proj, torch.cat([h0[None], outs[:-1]]),
            torch.cat([c0.float()[None], cs[:-1]]), cs, wh, dcT)
    f32 = dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    for burn in (torch.zeros_like(mixed), mixed):
        dz, dwh = lstm_kernel.lstm_seq_bwd_fused(*walk, burn)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)
        torch.testing.assert_close(dz.float(), p_dz.float(), **tol)
        bound = 1e-4 if f32 else BF16_DWH
        assert float((dwh - p_dwh).abs().max()) <= bound * float(p_dwh.abs().max())
        seam = lstm_kernel.lstm_seq_bwd(*walk, burn)
        assert torch.equal(dz, seam if f32 else seam.to(BF16))
        for _ in range(2):
            assert all(map(torch.equal, (dz, dwh), lstm_kernel.lstm_seq_bwd_fused(*walk, burn)))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_fused_ring_is_the_seam_backwards(cuda, dtype):
    """lstm_seq_bwd_fused_exchange_ring_elems sizes K4's ring as K2's at the
    same split (column_split.cuh ExchangeRing, the carry product's part)."""
    for B, H in ((64, 512), (96, 1024), (64, 2048), (1024, 512), (256, 2048)):
        g = lstm_kernel._geometry(B, H, "lstm_seq_bwd_fused", cuda, dtype)
        rings = [lstm_kernel._exchange_ring(src, g, B, H, dtype, cuda).numel()
                 for src in ("lstm_seq_bwd_fused", "lstm_seq_bwd")]
        assert rings[0] == rings[1], (B, H, g, rings)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_dwh_pass_alone_runs(cuda, dtype):
    """K4's timing probe: a launch's dWh passes with no walk, at the atari
    widths (wh pinned) and at xl (streamed)."""
    for H in (512, 2048):
        lstm_kernel.dwh_pass_alone(torch.zeros(85, 64, H, dtype=dtype, device=cuda), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_exchange_alone_runs_both_exchanges(cuda, dtype):
    """The timing probe: T - 1 steps of a grid barrier and K2's exchange
    with no product, through the bulk ring and through cp.async."""
    for bulk in (True, False):
        lstm_kernel.exchange_alone(85, 64, 512, cuda, dtype, bulk)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_forward_exchange_alone_runs_both_exchanges(cuda, dtype):
    """The forward's probe: T - 1 steps of a grid barrier and K1's exchange
    of h with no product, through the bulk ring and through cp.async, at
    the atari widths (wh pinned) and at xl (streamed: with and without the
    gate columns)."""
    for H in (512, 2048):
        for bulk in (True, False):
            for cols in (True, False):
                lstm_kernel.exchange_alone(85, 64, H, cuda, dtype, bulk, source="lstm_fwd",
                                           cols=cols)
    torch.cuda.synchronize()


# K1 takes h_t, and K5 both h_t (its recompute) and dz_t (its walk), through
# TMA bulk copies into the mbarrier ring, with wh's gate columns beside each
# tile where wh is streamed (xl): the atari widths, the wide model's batch
# 96 and xl
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", EXCHANGE_SHAPES, ids=str)
def test_gate_ring_kernels_on_the_card(cuda, shape, dtype):
    """K1 (outs, cs) and K5 (dz, dWh at S=5 and S=85, mixed seams) against
    their plain versions, three launches of each giving the same bits."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, dtype, T * B + H + 1)
    f32 = dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    for a, b in zip((outs, cs), lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)):
        torch.testing.assert_close(a.float(), b.float(), **tol)
    for _ in range(2):
        assert all(map(torch.equal, (outs, cs), lstm_kernel.lstm_fwd(proj, wh, h0, c0)))
    for S in (5, 85):
        args = _ckpt_args(dout, proj, outs, cs, h0, c0, wh, dcT, mixed, S)
        dz, dwh = lstm_kernel.lstm_seq_bwd_ckpt(*args)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(*args)
        torch.testing.assert_close(dz.float(), p_dz.float(), **tol)
        bound = 1e-4 if f32 else BF16_DWH
        assert float((dwh - p_dwh).abs().max()) <= bound * float(p_dwh.abs().max())
        for _ in range(2):
            assert all(map(torch.equal, (dz, dwh), lstm_kernel.lstm_seq_bwd_ckpt(*args)))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_gate_rings_sized_by_their_sources(cuda, dtype):
    """lstm_fwd_exchange_ring_elems and lstm_seq_bwd_ckpt_exchange_ring_elems
    against the layout counted here: two slots of the gate product's tiles
    (per chunk, ceil(H / kt) tiles of Bc rows of kt + 16 bytes), and where
    wh is streamed every block's tiles of gate columns (kt rows of 4Hb;
    bf16 4Hb + 8); K5's ring is K2's and K1's side by side."""
    for B, H in ((64, 512), (96, 1024), (64, 2048), (1024, 512), (256, 2048)):
        g = lstm_kernel._geometry(B, H, "lstm_fwd", cuda, dtype)
        vec = 16 // dtype.itemsize
        row = g.units * 4 if dtype == torch.float32 else g.units * 4 + vec
        nh = -(-H // g.k_tile)
        want = 2 * g.chunks(B) * nh * g.rows * (g.k_tile + vec)
        if not g.pinned:
            want += g.grid * nh * g.k_tile * row
        assert lstm_kernel._exchange_ring("lstm_fwd", g, B, H, dtype, cuda).numel() == want
        g5 = lstm_kernel._geometry(B, H, "lstm_seq_bwd_ckpt", cuda, dtype)
        rings = [lstm_kernel._exchange_ring(src, g5, B, H, dtype, cuda).numel()
                 for src in ("lstm_seq_bwd_ckpt", "lstm_seq_bwd", "lstm_fwd")]
        assert rings[0] == rings[1] + rings[2], (B, H, g5, rings)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    T, B, H = 4, 3, 8
    proj = torch.zeros(T, B, 4 * H, device=cuda)
    wh = torch.zeros(H, 4 * H, device=cuda)
    h = torch.zeros(B, H, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        lstm_kernel.lstm_fwd(proj.double(), wh, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_kernel.lstm_fwd(proj.transpose(0, 1).contiguous().transpose(0, 1), wh, h, h)
    with pytest.raises(ValueError, match="cpu"):
        lstm_kernel.lstm_fwd(proj, wh.cpu(), h, h)


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three updates through the kernels on the card against the same
    updates through the plain versions on the CPU."""
    _card_vs_cpu(tiny_test().replace(target_net_update_interval=2), steps=3)


@pytest.mark.parametrize("arm", [{"backward_arm": "fused_dwh"}, {"backward_arm": "ckpt"},
                                 {"fused_sequence": False}], ids=["fused_dwh", "ckpt", "no_seam"])
def test_train_step_per_arm_on_the_card_matches_the_cpu(cuda, arm):
    """One update under each other backward arm; "pallas" names the arms'
    kernels on the card and their plain versions on the CPU."""
    cfg = tiny_test().replace(lstm_backend="pallas", **arm)
    want = {"fused_dwh": "fused_dwh", "ckpt": "ckpt"}.get(arm.get("backward_arm"), "default")
    assert cfg.resolve_backward_arm(device="cuda")[0] == want
    lstm_kernel.reset_launch_counts()
    _card_vs_cpu(cfg, steps=1)
    kernel = {"fused_dwh": "lstm_seq_bwd_fused", "ckpt": "lstm_seq_bwd_ckpt"}.get(want, "lstm_bwd")
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_fwd=2, **{kernel: 1})


def _card_vs_cpu(cfg, steps, bf16=False):
    """`steps` updates through the kernels on the card against the same
    updates through the plain versions on the CPU: loss and priorities to
    rtol 1e-4 / atol 1e-5, each parameter's gradient entry by entry to
    rtol 1e-4 plus 1e-4 of its largest entry (the bound of dWh), and the
    parameters after the updates to rtol 1e-4 / atol 1e-5. With `bf16` the
    bf16 class: loss and priorities to rtol 1e-2 / atol 1e-3, gradients to
    rtol 1e-2 plus BF16_DWH of each one's largest entry; the parameters are
    not compared, since Adam's first step moves each by about lr in the
    direction of its gradient's sign, which a gradient near zero may flip
    (its gradient is held instead)."""
    rtol, atol, grad_tol = (1e-2, 1e-3, BF16_DWH) if bf16 else (1e-4, 1e-5, 1e-4)
    net = init_params(cfg, seed=1, device="cpu")
    states = {}
    for dev in ("cpu", "cuda"):
        online = copy.deepcopy(net).to(dev)
        target = copy.deepcopy(net).to(dev).requires_grad_(False)
        states[dev] = TrainState(online, target, make_optimizer(cfg, online.parameters()), 0)
    step = make_train_step(cfg)
    rng = np.random.default_rng(0)
    Bn, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps

    class Sampled:
        pass

    for _ in range(steps):
        b = Sampled()
        b.obs = rng.integers(0, 256, size=(Bn, T, *cfg.obs_shape), dtype=np.uint8)
        b.last_action = rng.integers(0, cfg.action_dim, size=(Bn, T))
        b.last_reward = rng.normal(size=(Bn, T)).astype(np.float32)
        b.hidden = (rng.normal(size=(Bn, 2, cfg.hidden_dim)) * 0.5).astype(np.float32)
        b.action = rng.integers(0, cfg.action_dim, size=(Bn, L))
        b.n_step_reward = rng.normal(size=(Bn, L)).astype(np.float32)
        b.gamma = np.full((Bn, L), 0.99, np.float32)
        b.burn_in_steps = rng.choice([0, cfg.burn_in_steps], size=Bn).astype(np.int32)
        b.learning_steps = np.full(Bn, L, np.int32)
        b.forward_steps = np.full(Bn, cfg.forward_steps, np.int32)
        b.is_weights = rng.uniform(0.3, 1.0, size=Bn).astype(np.float32)
        if cfg.num_tasks > 1:  # a multi-task batch: one task per sequence
            b.task = rng.integers(0, cfg.num_tasks, size=Bn).astype(np.int32)
        out = {dev: step(states[dev], DeviceBatch.from_sampled(b, dev)) for dev in states}
        torch.testing.assert_close(out["cuda"][1]["loss"].cpu(), out["cpu"][1]["loss"],
                                   rtol=rtol, atol=atol)
        torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=rtol, atol=atol)
        for (name, a), b in zip(states["cuda"].net.named_parameters(),
                                states["cpu"].net.parameters()):
            torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=grad_tol,
                                       atol=grad_tol * float(b.grad.abs().max()), msg=name)
    if bf16:
        return
    for (name, a), b in zip(states["cuda"].net.state_dict().items(),
                            states["cpu"].net.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5, msg=name)


def _operands(cuda, T, B, H, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    proj = torch.randn(T, B, 4 * H, device=cuda, generator=g).to(dtype)
    wh = ((torch.rand(H, 4 * H, device=cuda, generator=g) * 2 - 1) * H ** -0.5).to(dtype)
    h0, c0 = ((torch.randn(B, H, device=cuda, generator=g) * 0.3).to(dtype) for _ in range(2))
    dout = torch.randn(T, B, H, device=cuda, generator=g)
    dcT = torch.randn(B, H, device=cuda, generator=g)
    mixed = torch.randint(0, T, (B,), device=cuda, generator=g, dtype=torch.int32)
    return proj, wh, h0, c0, dout, dcT, mixed


def _ckpt_args(dout, proj, outs, cs, h0, c0, wh, dcT, burn, S):
    T = proj.shape[0]
    return (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
            torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]]), wh, dcT, burn, S)


@pytest.mark.parametrize("shape", CHUNKED, ids=str)
def test_kernels_in_row_chunks_match_plain_versions(cuda, shape):
    """All five kernels with the batch in two row chunks, against their
    plain versions (seams 0 and mixed; K5 at S=1 and T), each launched
    twice for the same bits, and K4's dz equal to K2's."""
    T, B, H = shape
    for kernel in lstm_kernel.SOURCES:
        assert lstm_kernel._geometry(B, H, kernel, cuda).chunks(B) == 2
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, torch.float32, T * B + H)
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    for got, want in zip((outs, cs), lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert all(map(torch.equal, (outs, cs), lstm_kernel.lstm_fwd(proj, wh, h0, c0)))
    walk = (dout, proj, torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]]), cs,
            wh, dcT)
    got = lstm_kernel.lstm_bwd(*walk)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert all(map(torch.equal, got, lstm_kernel.lstm_bwd(*walk)))
    for burn in (torch.zeros_like(mixed), mixed):
        dz = lstm_kernel.lstm_seq_bwd(*walk, burn)
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(dz, lstm_kernel.lstm_seq_bwd(*walk, burn))
        f_dz, f_dwh = lstm_kernel.lstm_seq_bwd_fused(*walk, burn)
        assert torch.equal(f_dz, dz)
        _assert_dwh_close(f_dwh, lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)[1])
        assert torch.equal(f_dwh, lstm_kernel.lstm_seq_bwd_fused(*walk, burn)[1])
        for S in (1, T):
            args = _ckpt_args(dout, proj, outs, cs, h0, c0, wh, dcT, burn, S)
            k_dz, k_dwh = lstm_kernel.lstm_seq_bwd_ckpt(*args)
            p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(*args)
            torch.testing.assert_close(k_dz, p_dz, rtol=1e-4, atol=1e-4)
            _assert_dwh_close(k_dwh, p_dwh)
            assert all(map(torch.equal, (k_dz, k_dwh), lstm_kernel.lstm_seq_bwd_ckpt(*args)))


@pytest.mark.parametrize("shape", SHAPES + [(85, 64, 2048)] + CHUNKED, ids=str)
def test_bf16_kernels_match_plain_versions(cuda, shape):
    """K1, K2 (seams 0, mid, T-1, mixed) and K5 (S=5 where it divides T,
    and S=T) with bf16 operands against their plain versions, on the
    plain forward's residuals, each launched twice for the same bits;
    every launch counted under the bf16 form's own key."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, BF16, T * B + H + 2)
    lstm_kernel.reset_launch_counts()
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    assert outs.dtype == BF16 and cs.dtype == torch.float32
    torch.testing.assert_close(outs.float(), p_outs.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(cs, p_cs, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(map(torch.equal, (outs, cs), lstm_kernel.lstm_fwd(proj, wh, h0, c0)))
    walk = (dout, proj, torch.cat([h0[None], p_outs[:-1]]), torch.cat([c0.float()[None],
            p_cs[:-1]]), p_cs, wh, dcT)
    seams = (torch.zeros_like(mixed), torch.full_like(mixed, T // 2),
             torch.full_like(mixed, T - 1), mixed)
    for burn in seams:
        dz = lstm_kernel.lstm_seq_bwd(*walk, burn)
        assert dz.dtype == torch.float32
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
        assert torch.equal(dz, lstm_kernel.lstm_seq_bwd(*walk, burn))
    strides = sorted({5 if T % 5 == 0 else 1, T})
    for S in strides:
        args = _ckpt_args(dout, proj, p_outs, p_cs, h0, c0, wh, dcT, mixed, S)
        k_dz, k_dwh = lstm_kernel.lstm_seq_bwd_ckpt(*args)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(*args)
        assert k_dz.dtype == BF16
        torch.testing.assert_close(k_dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        assert float((k_dwh - p_dwh).abs().max()) <= BF16_DWH * float(p_dwh.abs().max())
        assert all(map(torch.equal, (k_dz, k_dwh), lstm_kernel.lstm_seq_bwd_ckpt(*args)))
    torch.cuda.synchronize()
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_fwd_bf16=2, lstm_seq_bwd_bf16=8,
        lstm_seq_bwd_ckpt_bf16=2 * len(strides))


@pytest.mark.parametrize("shape", SHAPES + [(85, 64, 2048), (85, 96, 1024)] + CHUNKED, ids=str)
def test_bf16_seamless_and_fused_dwh_match_plain_versions(cuda, shape):
    """K3 (dz, dh0, dc0 in f32) and K4 (seams 0, mid, T-1, mixed; dz in
    bf16, dWh from the f32 dz in two bf16 planes) with bf16 operands
    against their plain versions, on the plain forward's residuals, each
    launched twice for the same bits; K4's dz is K2's f32 dz rounded to
    bf16, bit for bit (the two get one split)."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, BF16, T * B + H + 3)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    walk = (dout, proj, torch.cat([h0[None], p_outs[:-1]]), torch.cat([c0.float()[None],
            p_cs[:-1]]), p_cs, wh, dcT)
    lstm_kernel.reset_launch_counts()
    got = lstm_kernel.lstm_bwd(*walk)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(map(torch.equal, got, lstm_kernel.lstm_bwd(*walk)))
    assert (lstm_kernel._geometry(B, H, "lstm_seq_bwd", cuda, BF16)
            == lstm_kernel._geometry(B, H, "lstm_seq_bwd_fused", cuda, BF16))
    for burn in (torch.zeros_like(mixed), torch.full_like(mixed, T // 2),
                 torch.full_like(mixed, T - 1), mixed):
        dz, dwh = lstm_kernel.lstm_seq_bwd_fused(*walk, burn)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)
        assert dz.dtype == BF16 and dwh.dtype == torch.float32
        torch.testing.assert_close(dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        assert float((dwh - p_dwh).abs().max()) <= BF16_DWH * float(p_dwh.abs().max())
        assert all(map(torch.equal, (dz, dwh), lstm_kernel.lstm_seq_bwd_fused(*walk, burn)))
        assert torch.equal(dz, lstm_kernel.lstm_seq_bwd(*walk, burn).to(BF16))
    torch.cuda.synchronize()
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_bwd_bf16=2, lstm_seq_bwd_fused_bf16=8,
        lstm_seq_bwd_bf16=4)


# the tensor-core forms (every bf16 form): ragged batches (B=5, 37:
# one m16 tile part empty; K5's S*B rows of dWh off a multiple of 16 too),
# H whose last k-tile ends off a multiple of 16 (40, 600; K5's dWh rows
# likewise) and units per block not a multiple of 8 (H=40, 600: 4 and 8 of
# 132 SMs' ceil rounded to 4), the atari, wide B=96 and xl shapes, and
# batches in row chunks (3 and 4 at the forms' 256 threads)
TC_SHAPES = [(7, 5, 40), (9, 37, 600), (11, 37, 40), (6, 5, 600), (85, 64, 512),
             (85, 96, 1024), (85, 64, 2048)] + CHUNKED


@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
def test_tensor_core_forms_match_plain_versions(cuda, shape):
    """K1-bf16 (outs, cs), K3-bf16 (dz, dh0, dc0) and K5-bf16 (dz, dWh at S
    = 1, 5 where it divides T, and T, seams mixed per row), whose products
    run on the tensor cores, against their plain versions in the bf16
    class, K5's dz zero below each seam, each launched twice for the same
    bits and counted under its own key."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, BF16, T * B + H + 4)
    geo = {n: lstm_kernel._geometry(B, H, n, cuda, BF16) for n in lstm_kernel.TENSOR_CORE}
    for g in geo.values():
        assert g.rows % 16 == 0 and g.units % 4 == 0 and g.threads % 32 == 0
        assert (g.chunks(B) >= 2) == (shape in CHUNKED)
    lstm_kernel.reset_launch_counts()
    outs, cs = lstm_kernel.lstm_fwd(proj, wh, h0, c0)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    assert outs.dtype == BF16 and cs.dtype == torch.float32
    torch.testing.assert_close(outs.float(), p_outs.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(cs, p_cs, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(map(torch.equal, (outs, cs), lstm_kernel.lstm_fwd(proj, wh, h0, c0)))
    walk = (dout, proj, torch.cat([h0[None], p_outs[:-1]]), torch.cat([c0.float()[None],
            p_cs[:-1]]), p_cs, wh, dcT)
    got = lstm_kernel.lstm_bwd(*walk)
    for a, b in zip(got, lstm_kernel.lstm_bwd_plain(*walk)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert all(map(torch.equal, got, lstm_kernel.lstm_bwd(*walk)))
    strides = sorted({1, T} | ({5} if T % 5 == 0 else set()))
    for S in strides:
        args = _ckpt_args(dout, proj, p_outs, p_cs, h0, c0, wh, dcT, mixed, S)
        k_dz, k_dwh = lstm_kernel.lstm_seq_bwd_ckpt(*args)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_ckpt_plain(*args)
        assert k_dz.dtype == BF16 and k_dwh.dtype == torch.float32
        torch.testing.assert_close(k_dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        assert float((k_dwh - p_dwh).abs().max()) <= BF16_DWH * float(p_dwh.abs().max())
        below = torch.arange(T, device=cuda)[:, None] < mixed[None, :].long()
        assert not k_dz[below].any()
        assert all(map(torch.equal, (k_dz, k_dwh), lstm_kernel.lstm_seq_bwd_ckpt(*args)))
    torch.cuda.synchronize()
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_fwd_bf16=2, lstm_bwd_bf16=2,
        lstm_seq_bwd_ckpt_bf16=2 * len(strides))


@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
def test_tensor_core_seam_forms_match_plain_versions(cuda, shape):
    """K2-bf16 (dz, f32) and K4-bf16 (dz in bf16, dWh from its two bf16
    planes), on the tensor cores, with seams mixed per row, at T-1 and at
    0, against their plain versions in the bf16 class: dz zero below each
    seam, the same bits on two launches, K4-bf16's dz K2-bf16's f32 dz
    rounded to bf16, bit for bit (the two get one split), and each
    counted under its own key."""
    T, B, H = shape
    proj, wh, h0, c0, dout, dcT, mixed = _operands(cuda, T, B, H, BF16, T * B + H + 5)
    geo = {n: lstm_kernel._geometry(B, H, n, cuda, BF16)
           for n in ("lstm_seq_bwd", "lstm_seq_bwd_fused")}
    assert geo["lstm_seq_bwd"] == geo["lstm_seq_bwd_fused"]
    assert all(lstm_kernel.tensor_cores(n, 2) for n in geo)
    p_outs, p_cs = lstm_kernel.lstm_fwd_plain(proj, wh, h0, c0)
    walk = (dout, proj, torch.cat([h0[None], p_outs[:-1]]), torch.cat([c0.float()[None],
            p_cs[:-1]]), p_cs, wh, dcT)
    seams = (mixed, torch.full_like(mixed, T - 1), torch.zeros_like(mixed))
    lstm_kernel.reset_launch_counts()
    for burn in seams:
        below = torch.arange(T, device=cuda)[:, None] < burn[None, :].long()
        dz = lstm_kernel.lstm_seq_bwd(*walk, burn)
        assert dz.dtype == torch.float32
        torch.testing.assert_close(dz, lstm_kernel.lstm_seq_bwd_plain(*walk, burn),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
        assert not dz[below].any()
        assert torch.equal(dz, lstm_kernel.lstm_seq_bwd(*walk, burn))
        f_dz, f_dwh = lstm_kernel.lstm_seq_bwd_fused(*walk, burn)
        p_dz, p_dwh = lstm_kernel.lstm_seq_bwd_fused_plain(*walk, burn)
        assert f_dz.dtype == BF16 and f_dwh.dtype == torch.float32
        torch.testing.assert_close(f_dz.float(), p_dz.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        assert float((f_dwh - p_dwh).abs().max()) <= BF16_DWH * float(p_dwh.abs().max())
        assert not f_dz[below].any()
        assert all(map(torch.equal, (f_dz, f_dwh), lstm_kernel.lstm_seq_bwd_fused(*walk, burn)))
        assert torch.equal(f_dz, dz.to(BF16))
    torch.cuda.synchronize()
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0), lstm_seq_bwd_bf16=2 * len(seams),
        lstm_seq_bwd_fused_bf16=2 * len(seams))


def test_bf16_wrappers_refuse_f32_operands_where_jax_has_f32(cuda):
    """The bf16 forms take bf16 only where the Pallas kernels do (proj, wh,
    h0/c0, hprev, h_ckpt), and f32 where they take f32, K3's and K4's
    forms as the others."""
    T, B, H = 4, 3, 8
    proj = torch.zeros(T, B, 4 * H, device=cuda, dtype=BF16)
    wh = torch.zeros(H, 4 * H, device=cuda, dtype=BF16)
    hb = torch.zeros(T, B, H, device=cuda, dtype=BF16)
    f = torch.zeros(T, B, H, device=cuda)
    dcT = torch.zeros(B, H, device=cuda)
    burn = torch.zeros(B, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="wh"):
        lstm_kernel.lstm_fwd(proj, wh.float(), hb[0], hb[0])
    with pytest.raises(TypeError, match="cs"):
        lstm_kernel.lstm_seq_bwd(f, proj, hb, f, hb, wh, dcT, burn)
    with pytest.raises(TypeError, match="dout"):
        lstm_kernel.lstm_seq_bwd(hb, proj, hb, f, f, wh, dcT, burn)
    with pytest.raises(TypeError, match="cprev"):
        lstm_kernel.lstm_bwd(f, proj, hb, hb, f, wh, dcT)
    with pytest.raises(TypeError, match="wh"):
        lstm_kernel.lstm_seq_bwd_fused(f, proj, hb, f, f, wh.float(), dcT, burn)


# --------------------------------------------------------------------------
# the training path's host plane on the card: pinned staging, checkpoints,
# and hidden sizes padded to the kernels' row
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_pinned_staging_equals_from_sampled(cuda, precision):
    """Batches staged through the pinned ring and the side stream equal the
    pageable copies bit for bit, in every field's dtype (the bf16 carry
    too), also once the ring has wrapped around."""
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.profiling import TransferTimer

    tr = Trainer(tiny_test().replace(env_name="catch", precision=precision), device=cuda)
    tr.warmup()
    timer = TransferTimer()
    stager = PinnedStager(cuda, slots=3, timer=timer)
    for i in range(7):
        b = tr.replay.sample_batch(tr.sample_rng)
        staged, event = stager.stage(b)
        got = PinnedStager.consume(staged, event)
        want = DeviceBatch.from_sampled(b, cuda)
        for name, g, w in zip(DeviceBatch._fields, got, want):
            assert g.device == w.device and g.dtype == w.dtype, name
            assert torch.equal(g, w), (i, name)
    assert want.hidden.dtype == (BF16 if precision == "bf16" else torch.float32)
    assert timer.stats()["h2d_chunks"] == 7 and timer.bytes_staged > 0


def test_checkpoint_restores_onto_the_card_bitwise(cuda, tmp_path):
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps

    cfg = tiny_test().replace(env_name="catch", training_steps=4, save_interval=2,
                              checkpoint_dir=str(tmp_path / "ckpt"))
    tr = Trainer(cfg, device=cuda)
    tr.run_inline()
    assert list_checkpoint_steps(cfg.checkpoint_dir) == [2, 4]
    resumed = Trainer(cfg, device=cuda, resume=True)
    assert resumed.state.step == 4
    for a, b in ((tr.state.net, resumed.state.net), (tr.state.target_net,
                                                      resumed.state.target_net)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert y.device.type == "cuda" and torch.equal(x, y), k
    oa, ob = tr.state.optimizer.state_dict()["state"], resumed.state.optimizer.state_dict()["state"]
    assert set(oa) == set(ob) and oa
    for i in oa:
        for k, v in oa[i].items():
            assert torch.equal(v, ob[i][k]), (i, k)
            if k != "step":
                assert ob[i][k].device.type == "cuda"


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_hidden_510_through_padded_kernels_matches_plain_versions(cuda, precision):
    """Hidden 510, a multiple of neither 4 nor 8: the model pads it to 512
    (two zero units, in fp32 and bf16 alike) on the card, so the kernels run, and
    one update, its gradients included, matches the unpadded plain
    versions on the CPU (_card_vs_cpu: fp32, and bf16 in the bf16 class)."""
    cfg = tiny_test().replace(hidden_dim=510, precision=precision, target_net_update_interval=2)
    lstm_kernel.reset_launch_counts()
    _card_vs_cpu(cfg, steps=1, bf16=precision == "bf16")
    suffix = "_bf16" if precision == "bf16" else ""
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0),
        **{f"lstm_fwd{suffix}": 2, f"lstm_seq_bwd{suffix}": 1})


@pytest.mark.parametrize("precision,chunk", [("fp32", 0), ("fp32", 5), ("bf16", 0)],
                         ids=["fp32_scan", "fp32_chunk5", "bf16_scan"])
def test_impala_lru_train_steps_on_the_card_match_the_cpu(cuda, precision, chunk):
    """The long-context model (IMPALA (8, 16) at 26x26, the LRU core) on
    the card against the CPU (_card_vs_cpu): two updates in fp32; one in
    bf16, in the bf16 class, as the hidden-510 bf16 case (a second bf16
    update starts from parameters that Adam's first step moved apart by
    about lr wherever a near-zero gradient's sign differs). The LRU
    launches none of the LSTM kernels."""
    cfg = tiny_test().replace(encoder="impala", obs_shape=(26, 26, 1), impala_channels=(8, 16),
                              recurrent_core="lru", lru_chunk=chunk, precision=precision,
                              target_net_update_interval=2)
    lstm_kernel.reset_launch_counts()
    bf16 = precision == "bf16"
    _card_vs_cpu(cfg, steps=1 if bf16 else 2, bf16=bf16)
    assert not any(lstm_kernel.launch_counts.values())


def test_native_gather_matches_numpy_beside_the_card(cuda):
    """The native replay core in a process that holds a CUDA context (and
    torch's own OpenMP runtime): its window gathers equal a numpy fancy
    index bit for bit, at the atari main path's shapes."""
    from r2d2_tpu_torch._native import load_native

    torch.zeros(1, device=cuda)
    core = load_native()
    assert core.gather_threads() >= 1
    rng = np.random.default_rng(0)
    store = rng.integers(0, 255, size=(12, 441, 84, 84, 1), dtype=np.uint8)
    b = rng.integers(0, 12, size=64)
    start = rng.integers(-40, 441 - 40, size=64)
    rows = np.clip(start[:, None] + np.arange(85)[None, :], 0, 440)
    np.testing.assert_array_equal(core.gather_windows(store, b, start, 85), store[b[:, None], rows])


@pytest.mark.parametrize("precision,k", [("fp32", 1), ("fp32", 3), ("bf16", 2)])
def test_tiered_ring_staging_equals_host_draws(cuda, precision, k):
    """Chunks gathered into the tiered plane's pinned ring and copied on its
    side stream into the two device slabs equal K host-plane draws from the
    same Generator state and contents, bit for bit, also after the ring has
    wrapped (each slot refilled only after the consumer's event)."""
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
    from r2d2_tpu_torch.replay.snapshot import restore_replay, save_replay
    from r2d2_tpu_torch.replay.tiered_store import (
        StagingRing, TieredReplayBuffer, stage_chunk, staged_specs)
    from r2d2_tpu_torch.train import Trainer

    cfg = tiny_test().replace(env_name="catch", precision=precision, replay_plane="tiered",
                              updates_per_dispatch=k, training_steps=12)
    tr = Trainer(cfg, device=cuda)
    tr.warmup()
    assert isinstance(tr.replay, TieredReplayBuffer)
    host = ReplayBuffer(cfg.replace(replay_plane="host", updates_per_dispatch=1))
    path = str(__import__("tempfile").mkdtemp()) + "/s.npz"
    save_replay(tr.replay, path)
    restore_replay(host, path)
    ring = StagingRing(staged_specs(cfg, k), cuda)
    assert all(t.is_pinned() for t in ring.host[0].values())
    rng_t, rng_h = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(5):
        chunk = stage_chunk(tr.replay, rng_t, k, ring)
        torch.cuda.current_stream().wait_event(chunk.event)
        got = DeviceBatch.from_staged(chunk.batch)
        for j in range(k):
            want = DeviceBatch.from_sampled(host.sample_batch(rng_h), cuda)
            for name, g, w in zip(DeviceBatch._fields, got, want):
                assert g.device.type == "cuda" and g.dtype == w.dtype, name
                assert torch.equal(g[j], w), (i, j, name)
        ring.release(chunk.slot)


def test_tiered_dispatch_launches_and_preempt_resume_on_the_card(cuda, tmp_path):
    """The tiered plane on the card: each dispatch of K=2 launches 2K
    forward and K seam-backward kernels; a SIGTERM delivered at
    trainer.update cuts the run with a snapshot and a checkpoint, and the
    resumed run equals an uninterrupted one in this process bit for bit:
    replay, Generator, step, networks and Adam state (tiny_test's mlp
    encoder: no convolution whose backward the library may sum in another
    order)."""
    from r2d2_tpu_torch.replay.snapshot import save_replay
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils import faults

    def cfg(tag):
        return tiny_test().replace(
            env_name="catch", replay_plane="tiered", updates_per_dispatch=2,
            deterministic_staging=True, training_steps=8, save_interval=1000,
            learning_starts=48, snapshot_replay=True,
            checkpoint_dir=str(tmp_path / tag))

    lstm_kernel.reset_launch_counts()
    clean = Trainer(cfg("clean"), device=cuda)
    clean.warmup()
    lstm_kernel.reset_launch_counts()
    clean.run_inline(env_steps_per_update=4)
    assert {k: v for k, v in lstm_kernel.launch_counts.items() if v} == {
        "lstm_fwd": 16, "lstm_seq_bwd": 8}
    faults.install(faults.FaultPlane(schedule={"trainer.update": {2: "sigterm"}}))
    try:
        cut = Trainer(cfg("killed"), device=cuda)
        cut.run_inline(env_steps_per_update=4)
    finally:
        faults.uninstall()
    assert cut.preempted and cut._step == 4
    resumed = Trainer(cfg("killed"), device=cuda, resume=True)
    assert resumed._initial_step == 4
    resumed.run_inline(env_steps_per_update=4)
    assert resumed._step == 8 and resumed.sample_rng.bit_generator.state == \
        clean.sample_rng.bit_generator.state
    files = []
    for tag, t in (("a", clean), ("b", resumed)):
        save_replay(t.replay, str(tmp_path / f"{tag}.npz"))
        files.append(np.load(str(tmp_path / f"{tag}.npz")))
    assert sorted(files[0].files) == sorted(files[1].files)
    for key in files[0].files:
        np.testing.assert_array_equal(files[0][key], files[1][key], err_msg=key)
    for a, b in ((clean.state.net, resumed.state.net),
                 (clean.state.target_net, resumed.state.target_net)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    oa = clean.state.optimizer.state_dict()["state"]
    ob = resumed.state.optimizer.state_dict()["state"]
    assert all(torch.equal(v, ob[i][n]) for i in oa for n, v in oa[i].items())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_device_store_gather_on_the_card_equals_the_cpu(cuda, precision):
    """The device plane's store on the card and on the CPU, filled with the
    same blocks: the same coordinates gather the same batch bit for bit."""
    from r2d2_tpu_torch.learner import make_store_gather
    from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer

    cfg = tiny_test().replace(replay_plane="device", precision=precision)
    bufs = {d: DeviceReplayBuffer(cfg, d) for d in ("cpu", cuda)}
    for i in range(12):
        rng = np.random.default_rng(i)
        acc = SequenceAccumulator(cfg)
        acc.reset(rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8))
        for _ in range([16, 9, 16, 5][i % 4]):
            acc.add(action=int(rng.integers(cfg.action_dim)), reward=float(rng.normal()),
                    next_obs=rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8),
                    q_value=rng.normal(size=cfg.action_dim).astype(np.float32),
                    hidden=rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
        block = acc.finish(last_qval=None if i % 2 else
                           rng.normal(size=cfg.action_dim).astype(np.float32))
        for buf in bufs.values():
            buf.add_block(*block)
    si = bufs["cpu"].sample_indices(np.random.default_rng(0))
    gather = make_store_gather(cfg)
    out = {d: gather(buf.stores, *(torch.from_numpy(x).to(d) for x in (si.b, si.s,
                                                                        si.is_weights)))
           for d, buf in bufs.items()}
    for name, a, b in zip(DeviceBatch._fields, out[cuda], out["cpu"]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b), name


def test_device_sum_tree_on_the_card_equals_the_cpu(cuda):
    """Updates with duplicates and masks, descents and IS weights of the
    device tree on the card: the CPU's within 1e-6 relative (the sums are
    the same additions; td**alpha may round by an ulp), the descents of the
    same uniforms equal, and deterministic under
    torch.use_deterministic_algorithms."""
    from r2d2_tpu_torch.replay import device_sum_tree as dst

    cap = 5000
    L = dst.tree_layers(cap)
    rng = np.random.default_rng(1)
    trees = {d: dst.tree_init(cap, d) for d in ("cpu", cuda)}
    for _ in range(20):
        idx = torch.from_numpy(rng.integers(0, cap, 256))
        td = torch.from_numpy(rng.uniform(0, 4, 256).astype(np.float32))
        mask = torch.from_numpy(rng.random(256) < 0.9)
        for d in trees:
            trees[d] = dst.tree_update(trees[d], L, idx.to(d), td.to(d), 0.9, mask.to(d))
    torch.testing.assert_close(trees[cuda].cpu(), trees["cpu"], rtol=1e-6, atol=1e-6)
    same = dst.tree_from_leaves(trees["cpu"][dst.leaf_offset(L):][:cap].numpy(), cap, cuda)
    u = torch.rand(64, generator=torch.Generator().manual_seed(2))
    leaf = dst.tree_descend(same, L, u.to(cuda))
    assert torch.equal(leaf.cpu(), dst.tree_descend(same.cpu(), L, u))
    torch.testing.assert_close(dst.is_weights(same, L, leaf, 0.6).cpu(),
                               dst.is_weights(same.cpu(), L, leaf.cpu(), 0.6),
                               rtol=1e-6, atol=0)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = dst.tree_update(same, L, idx.to(cuda), td.to(cuda), 0.9)
        b = dst.tree_update(same, L, idx.to(cuda), td.to(cuda), 0.9)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(a, b)


def test_megastep_and_superstep_on_the_card_match_the_cpu(cuda):
    """One fused megastep (K=2: the chunk with the entry parameters, the
    updates, the slab write) and one N=2 superstep on the card, from the
    CPU's parameters, stores, tree and draws: the chunk's integer fields
    and frames equal, the updates' loss and priorities within rtol 1e-4 /
    atol 1e-5 (tiny_test's mlp encoder), and each launches 2K + K
    kernels per dispatch."""
    from r2d2_tpu_torch.actor import ParamStore
    from r2d2_tpu_torch.collect import DeviceCollector, GivenDraws
    from r2d2_tpu_torch.envs.catch import TensorCatchEnv
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.megastep import make_megastep, make_priority_superstep
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer

    k = 2
    cfg = tiny_test().replace(env_name="catch", action_dim=3, num_actors=4,
                              max_episode_steps=16, replay_plane="device",
                              priority_plane="device", updates_per_dispatch=k,
                              training_steps=4, target_net_update_interval=2)
    fn_env = TensorCatchEnv(12, 12)
    _, state = init_train_state(cfg, "cpu")
    replay = DeviceReplayBuffer(cfg, "cpu")
    col = DeviceCollector(cfg, copy.deepcopy(state.net), ParamStore(state.net), fn_env, replay,
                          seed=3, device="cpu")
    while not replay.can_sample():
        col.step()
    with replay.lock:
        ptr0 = replay._reserve_advance(4)
        draws = [replay._draw_sample_idx(np.random.default_rng(5)) for _ in range(k)]
    coords = [torch.from_numpy(np.stack([getattr(d, f) for d in draws]))
              for f in ("b", "s", "is_weights")]
    rng = np.random.default_rng(6)
    u, a = rng.random((16, 4)).astype(np.float32), rng.integers(0, 3, (16, 4))
    fresh = fn_env.reset(4, torch.Generator().manual_seed(1))
    results = {}
    for d in ("cpu", cuda):
        st = copy.deepcopy(state)
        for net in (st.net, st.target_net):
            net.to(d)
        st.optimizer = make_optimizer(cfg, st.net.parameters())
        stores = {key: t.to(d, copy=True) for key, t in replay.stores.items()}
        env = type(col.env_state)(*(t.to(d) for t in col.env_state))
        lstm_kernel.reset_launch_counts()
        st, m, p, chunk, _ = make_megastep(cfg, fn_env, 4, 16, k)(
            st, stores, env, col.epsilons.to(d), GivenDraws(u, a, resets=fresh), *(
                x.to(d) for x in coords), ptr0)
        mega_launches = dict(lstm_kernel.launch_counts)
        lstm_kernel.reset_launch_counts()
        uu = torch.from_numpy(rng.random((2, k, cfg.batch_size)).astype(np.float32)) \
            if d == "cpu" else results["cpu"]["u"]
        st, tree, m2 = make_priority_superstep(cfg, 2, k)(
            st, stores, replay.dtree.tree.clone().to(d),
            torch.from_numpy(replay.num_seq_store).to(d),
            uu.to(d))
        results[d] = dict(m=m, p=p, chunk=chunk, stores=stores, tree=tree, m2=m2, u=uu,
                          mega=mega_launches, sup=dict(lstm_kernel.launch_counts))
    got, want = results[cuda], results["cpu"]
    for key in ("obs", "last_action", "action", "burn_in", "learning", "forward"):
        assert torch.equal(got["stores"][key].cpu(), want["stores"][key]), key
    for x, y in zip(got["chunk"][1:4], want["chunk"][1:4]):
        assert torch.equal(x.cpu(), y)
    torch.testing.assert_close(got["p"].cpu(), want["p"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["m"]["loss"].cpu(), want["m"]["loss"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["m2"]["loss"].cpu(), want["m2"]["loss"], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(got["tree"].cpu(), want["tree"], rtol=1e-4, atol=1e-5)
    assert {key: v for key, v in got["mega"].items() if v} == {"lstm_fwd": 2 * k,
                                                              "lstm_seq_bwd": k}
    assert {key: v for key, v in got["sup"].items() if v} == {"lstm_fwd": 4 * k,
                                                             "lstm_seq_bwd": 2 * k}


# --------------------------------------------------------------------------
# the multi-task plane and procmaze on the card
# --------------------------------------------------------------------------


MULTITASK_FAMILY = ["keydoor:4:2", "drift", "banditgrid", "catch"]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_task_head_train_steps_on_the_card_match_the_cpu(cuda, precision):
    """The task-conditioned head (one-hot task after the core's output, the
    masked advantage mean, the -1e9 floor) through the kernels on the card
    against the CPU (_card_vs_cpu; fp32 two updates, bf16 one in the bf16
    class), 2 forward + 1 seam backward launches per update."""
    from r2d2_tpu_torch.multitask import build_registry

    cfg, _ = build_registry(tiny_test().replace(precision=precision,
                                                target_net_update_interval=2),
                            MULTITASK_FAMILY)
    lstm_kernel.reset_launch_counts()
    bf16 = precision == "bf16"
    steps = 1 if bf16 else 2
    _card_vs_cpu(cfg, steps=steps, bf16=bf16)
    suffix = "_bf16" if bf16 else ""
    assert lstm_kernel.launch_counts == dict(
        dict.fromkeys(lstm_kernel.KERNELS, 0),
        **{f"lstm_fwd{suffix}": 2 * steps, f"lstm_seq_bwd{suffix}": steps})
    net = init_params(cfg, seed=1, device=cuda)
    B = 16
    task = torch.arange(B, device=cuda, dtype=torch.int32) % cfg.num_tasks
    obs = torch.randint(0, 256, (B, *cfg.obs_shape), dtype=torch.uint8, device=cuda)
    zeros = torch.zeros(B, dtype=torch.int32, device=cuda)
    carry = tuple(torch.zeros(B, cfg.hidden_dim, device=cuda) for _ in range(2))
    with torch.no_grad():
        q, a, _ = net.act_select(obs, zeros, zeros.float(), carry,
                                 torch.zeros(B, dtype=torch.bool, device=cuda), zeros, task)
    dims = torch.tensor(cfg.task_action_dims, device=cuda)[task.long()]
    invalid = torch.arange(cfg.action_dim, device=cuda)[None] >= dims[:, None]
    assert (q[invalid] == -1e9).all() and (a.long() < dims).all()


def test_task_gather_on_the_card_equals_the_cpu(cuda):
    """A multi-task device store on the card and on the CPU, the same
    blocks of three tasks: the same coordinates gather the same batch, the
    task column included, bit for bit."""
    from r2d2_tpu_torch.learner import make_store_gather
    from r2d2_tpu_torch.multitask import build_registry
    from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer

    cfg, _ = build_registry(tiny_test().replace(replay_plane="device"), MULTITASK_FAMILY[:3])
    bufs = {d: DeviceReplayBuffer(cfg, d) for d in ("cpu", cuda)}
    for i in range(12):
        rng = np.random.default_rng(i)
        acc = SequenceAccumulator(cfg, task_id=i % 3, gamma=cfg.task_gammas[i % 3])
        acc.reset(rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8))
        for _ in range(16):
            acc.add(action=int(rng.integers(cfg.action_dim)), reward=float(rng.normal()),
                    next_obs=rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8),
                    q_value=rng.normal(size=cfg.action_dim).astype(np.float32),
                    hidden=rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
        block = acc.finish(last_qval=None)
        for buf in bufs.values():
            buf.add_block(*block)
    si = bufs["cpu"].sample_indices(np.random.default_rng(0))
    gather = make_store_gather(cfg)
    out = {d: gather(buf.stores, *(torch.from_numpy(x).to(d) for x in (si.b, si.s,
                                                                        si.is_weights)))
           for d, buf in bufs.items()}
    for a, b in zip(out[cuda].tensors(), out["cpu"].tensors()):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert torch.equal(out[cuda].task.cpu(), torch.from_numpy(si.b % 3).int())


def test_procmaze_core_on_the_card_equals_the_cpu(cuda):
    """The procmaze core at the procgen_impala geometry (64x64x3) on the
    card and on the CPU from the same draws: states, frames, rewards and
    dones bit for bit over 100 steps; the card's own generator draws
    valid levels."""
    from r2d2_tpu_torch.envs.procmaze import ProcMazeEnv

    env, E = ProcMazeEnv(16, 4, 96, shaping_coef=0.02), 64
    draws = env.level_draws(E, torch.Generator().manual_seed(0), "cpu")
    s = {d: env.reset(E, device=d, draws=tuple(x.to(d) for x in draws)) for d in ("cpu", cuda)}
    rng = np.random.default_rng(0)
    for t in range(100):
        a = torch.from_numpy(rng.integers(0, 5, E).astype(np.int32))
        frames = {d: env.render(st) for d, st in s.items()}
        assert torch.equal(frames[cuda].cpu(), frames["cpu"])
        out = {d: env.step(st, a.to(d)) for d, st in s.items()}
        s = {d: o[0] for d, o in out.items()}
        for x, y in zip(out[cuda][1:], out["cpu"][1:]):
            assert torch.equal(x.cpu(), y), t
        for x, y in zip(s[cuda], s["cpu"]):
            assert torch.equal(x.cpu(), y), t
    own = env.reset(256, torch.Generator(device=cuda).manual_seed(1), cuda)
    assert own.walls.is_cuda and not (own.agent == own.goal).all(-1).any()


# ---------------------------------------------------------------- serving


def _serve_pair(precision, pipeline, **serve_kw):
    from r2d2_tpu_torch.serve import PolicyServer, ServeConfig

    cfg = tiny_test().replace(precision=precision, serve_pipeline=pipeline)
    scfg = ServeConfig(buckets=(2, 4, 8), max_wait_ms=1.0, cache_capacity=16, epsilon=0.3,
                       **serve_kw)
    return PolicyServer(cfg, scfg, device="cuda"), cfg


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_serve_pinned_read_back_under_the_depth2_pipeline(cuda, precision):
    """Through the running server (start(): the serve loop, and when
    pipelined the completion worker behind the depth-2 semaphore), every
    request queued before the loop starts and each completion held 5 ms,
    so two batches are in flight and a staging set is reused while the
    batch before it completes: each record's q and actions come back
    through its staging set's pinned buffers and its event, and equal the
    serial server's answers bit for bit; the two sets' buffers alternate."""
    import threading

    ser, cfg = _serve_pair(precision, False)
    pipe, _ = _serve_pair(precision, True)
    rng = np.random.default_rng(0)
    specs = [[(f"s{(b + i) % 5}", rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8),
               float(rng.normal())) for i in range(1 + b % 4)] for b in range(10)]
    out, recs, depth = {}, [], [0, 0]
    lock = threading.Lock()
    for name, srv in (("ser", ser), ("pipe", pipe)):
        srv.warmup()
        stage, complete = srv._stage_and_dispatch, srv._complete

        def staged(batch, stage=stage, name=name):
            rec = stage(batch)
            if name == "pipe":
                with lock:
                    recs.append((rec.q_host.is_pinned(), rec.event is not None,
                                 rec.q_host.data_ptr()))
                    depth[0] += 1
                    depth[1] = max(depth)
            return rec

        def completed(rec, complete=complete, name=name):
            if name == "pipe":
                time.sleep(0.005)
                with lock:
                    depth[0] -= 1
            complete(rec)

        srv._stage_and_dispatch, srv._complete = staged, completed
        futures = [[srv.submit(sid, o, reward=r) for sid, o, r in rows] for rows in specs]
        srv.start(watch_checkpoints=False)
        try:
            out[name] = [[f.result(timeout=30.0) for f in fs] for fs in futures]
            assert srv.check() == {"worker_restarts": 0, "worker_stalls": 0}
        finally:
            srv.stop()
    for a_batch, b_batch in zip(out["ser"], out["pipe"]):
        for a, b in zip(a_batch, b_batch):
            assert (a.action, a.bucket, a.row) == (b.action, b.bucket, b.row)
            np.testing.assert_array_equal(a.q, b.q)
    assert ser._rng.bit_generator.state == pipe._rng.bit_generator.state
    assert depth[1] == 2 and all(pinned and event for pinned, event, _ in recs)
    # the two sets of a bucket take turns (at most two per bucket in use)
    assert len({ptr for *_, ptr in recs}) <= 2 * len(pipe.batcher.buckets)


def test_serve_read_back_buffers_go_with_their_staging_set(cuda):
    """The q, action and tap-row read-back buffers are pinned and belong to
    their staging set: a server with the live-loop tap answers as one
    without it while every set is reallocated mid-stream, the replaced
    sets' buffers are freed, and each live set's are sized by its bucket
    (tests/test_torch_serve_readback.py holds the same on the CPU)."""
    import gc
    import weakref

    from r2d2_tpu_torch.liveloop import TransitionTap
    from r2d2_tpu_torch.serve import PolicyServer, ServeConfig

    cfg = tiny_test()

    def make(tap):
        srv = PolicyServer(cfg, ServeConfig(buckets=(2, 4), max_wait_ms=1.0,
                                            cache_capacity=16), device="cuda")
        if tap:
            srv.tap = TransitionTap(cfg)
        srv.warmup()
        return srv

    def serve(srv, sids, obs, reset):
        futs = [srv.submit(s, o, reward=0.5, reset=reset) for s, o in zip(sids, obs)]
        srv._serve_iteration()
        return [f.result(timeout=30.0) for f in futs]

    def buffers(srv):
        return {k: dict(b["host"]) for k, b in srv._staging._sets.items() if b["host"]}

    tapped, plain = make(True), make(False)
    rng = np.random.default_rng(0)
    replaced = []
    for r, n in enumerate([2, 3, 2, 4, 3, 2]):
        obs = [rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8) for _ in range(n)]
        sids = [f"s{i}" for i in range(n)]
        for a, b in zip(serve(tapped, sids, obs, r == 0), serve(plain, sids, obs, r == 0)):
            assert (a.action, a.bucket, a.row) == (b.action, b.bucket, b.row)
            np.testing.assert_array_equal(a.q, b.q)
        if r == 3:
            replaced = [weakref.ref(t) for h in buffers(tapped).values() for t in h.values()]
            tapped._staging.warm(cfg.obs_shape, np.float32)
    gc.collect()
    assert replaced and all(ref() is None for ref in replaced)
    live = buffers(tapped)
    assert {bucket for bucket, _ in live} == {2, 4}
    for (bucket, _), host in live.items():
        assert set(host) == {"q", "action", "tap_h", "tap_c"}
        assert all(t.is_pinned() and t.shape[0] == bucket for t in host.values())
    tapped.tap.process_pending()
    assert tapped.tap.stats()["tap_captured_steps"] > 0


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_serve_commit_in_place_across_back_to_back_batches(cuda, precision):
    """One session's requests in consecutive batches: each batch writes the
    cache's own tensors in place (the same storage throughout) and the next
    gathers that write, answers equal to the reference carried on, bit for
    bit."""
    from r2d2_tpu_torch.serve import reference_act

    srv, cfg = _serve_pair(precision, True)
    srv.warmup()
    storage = [t.data_ptr() for t in srv.cache.arrays()]
    params = srv.served_params()
    rng = np.random.default_rng(1)
    h = c = torch.zeros((1, cfg.hidden_dim), device="cuda")
    last = 0
    srv.start(watch_checkpoints=False)
    try:
        for t in range(6):
            obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
            res = srv.submit("one", obs, reward=0.5, reset=t == 0, epsilon=0.0).result(10.0)
            q, (h, c) = reference_act(srv.net, params, obs[None], np.array([last]),
                                      np.array([0.0 if t == 0 else 0.5], np.float32), (h, c),
                                      min_batch=res.bucket, row=res.row)
            h, c = h.to(cfg.state_dtype), c.to(cfg.state_dtype)
            np.testing.assert_array_equal(q[0].cpu().numpy(), res.q)
            last = res.action
    finally:
        srv.stop()
    assert [t.data_ptr() for t in srv.cache.arrays()] == storage


def test_serve_bf16_spill_round_trip_on_the_card(cuda):
    """A bf16 carry demoted from the card to the host slab and promoted back
    keeps its bits."""
    from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache

    cache = RecurrentStateCache(capacity=2, hidden_dim=64, dtype=torch.bfloat16,
                                spill_capacity=4, device="cuda")
    (slot,), _ = cache.assign(["a"])
    h = torch.randn(1, 64, device="cuda").to(torch.bfloat16)
    cache.write(torch.tensor([int(slot)], device="cuda"), h, -h,
                torch.tensor([2], device="cuda"), torch.tensor([0.75], device="cuda"))
    cache.assign(["b"])
    cache.assign(["c"])  # a demoted to the slab
    assert cache.spilled("a") and not cache._spill_h.is_cuda
    (slot2,), fresh = cache.assign(["a"])
    assert not fresh[0]
    assert torch.equal(cache.h[slot2].view(torch.int16), h[0].view(torch.int16))
    assert torch.equal(cache.c[slot2].view(torch.int16), (-h)[0].view(torch.int16))
    assert int(cache.last_action[slot2]) == 2 and float(cache.last_reward[slot2]) == 0.75


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fleet_of_two_on_one_card_bit_for_bit(cuda, precision):
    """Two replicas on cuda:0, each with its own module: every answer equals
    its replica's reference_act at its bucket and row, and the carries the
    tap gathered at dispatch are the reference's, bit for bit."""
    from r2d2_tpu_torch.liveloop import LiveLoopPlane
    from r2d2_tpu_torch.serve import LocalClient, MultiDeviceServer, ServeConfig, reference_act

    cfg = tiny_test().replace(precision=precision, serve_spill=16, liveloop=True,
                              liveloop_explore_fraction=0.0)
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2, 4, 8), max_wait_ms=1.0,
                                             cache_capacity=16), devices=[cuda, cuda])
    assert srv.replicas[0].net is not srv.replicas[1].net

    class _Sink:
        def add_blocks_batch(self, items):
            pass

    plane = LiveLoopPlane(cfg, srv, _Sink())
    records = []
    observe = plane.tap.observe_batch

    def spy(sids, *args, rows=None, **kw):
        records.append((list(sids), rows[0].copy(), rows[1].copy()))
        return observe(sids, *args, rows=rows, **kw)

    plane.tap.observe_batch = spy
    srv.warmup()
    srv.start()
    client = LocalClient(srv)
    rng = np.random.default_rng(3)
    sessions = [f"card-{s}" for s in range(6)]
    carry = {sid: (torch.zeros((1, cfg.hidden_dim), device=cuda),) * 2 + (0,)
             for sid in sessions}
    want = {}
    try:
        for t in range(5):
            for sid in sessions:
                obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
                reward = 0.0 if t == 0 else float(rng.normal())
                res = client.act(sid, obs, reward=reward, reset=t == 0)
                replica = srv.replica_for(sid)
                h, c, last = carry[sid]
                q, (h, c) = reference_act(replica.net, replica.served_params(), obs[None],
                                          np.array([last]), np.array([reward], np.float32),
                                          (h, c), min_batch=res.bucket, row=res.row)
                np.testing.assert_array_equal(q[0].cpu().numpy(), res.q)
                h, c = h.to(cfg.state_dtype), c.to(cfg.state_dtype)
                carry[sid] = (h, c, res.action)
                want.setdefault(sid, []).append((h[0].float().cpu().numpy(),
                                                 c[0].float().cpu().numpy()))
        deadline = time.monotonic() + 10.0
        while len(records) < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        plane.stop()
        srv.stop()
    assert srv.router.counts() == [3, 3]
    got = {}
    for sids, h_rows, c_rows in records:
        for i, sid in enumerate(sids):
            got.setdefault(sid, []).append((h_rows[i], c_rows[i]))
    for sid in sessions:
        assert len(got[sid]) == 5
        for (gh, gc), (wh, wc) in zip(got[sid], want[sid]):
            np.testing.assert_array_equal(gh, wh)
            np.testing.assert_array_equal(gc, wc)


def test_liveloop_return_improves_on_catch(cuda, tmp_path):
    """The closed loop on the card at the JAX test's sizes (30 s, 6
    sessions, two replicas on cuda:0): the fleet hot-reloads what the
    trainer learns from its own traffic, no session is lost, and the served
    return of the second half beats the first's."""
    # pytest puts tests/ on the path (no package there: a site-packages
    # "tests" package would shadow one)
    from torch_liveloop_catch import run_liveloop_catch

    seconds = 30.0
    stats, loop_stats, episodes = run_liveloop_catch(tmp_path, "cuda", seconds=seconds)
    assert stats["sessions_lost"] == 0 and stats["reloads"] >= 1
    assert stats["params_version"] > 0
    assert loop_stats["tap_captured_steps"] > 0 and loop_stats["bridge_ingested_blocks"] > 0
    half1 = [r for t, r in episodes if t < seconds / 2]
    half2 = [r for t, r in episodes if t >= seconds / 2]
    print(f"liveloop on the card: {len(half1)} + {len(half2)} episodes, mean return "
          f"{np.mean(half1):.3f} -> {np.mean(half2):.3f}, {stats['reloads']} reloads")
    assert len(half1) >= 10 and len(half2) >= 10
    assert float(np.mean(half2)) > float(np.mean(half1))


def test_transport_loopback_trains_and_reloads_on_the_card(cuda, tmp_path):
    """The block stream in one process on cuda:0: a one-replica fleet
    serves catch sessions, its tap's blocks go through a
    BlockStreamPublisher and an IngestService over loopback into a
    LiveLoopTrainer's replay; one update launches K1 twice and K2 once; the
    learner's CKPT, broadcast back on the same socket and installed through
    publish_params, serves the learner's parameters bit for bit, and the
    answers equal reference_act under them."""
    from r2d2_tpu_torch.envs.catch import CatchHostEnv
    from r2d2_tpu_torch.liveloop import LiveLoopPlane, LiveLoopTrainer
    from r2d2_tpu_torch.serve import LocalClient, MultiDeviceServer, ServeConfig, reference_act
    from r2d2_tpu_torch.transport import BlockStreamPublisher, IngestService, framing

    cfg = tiny_test().replace(env_name="catch", action_dim=3, liveloop=True, serve_spill=16,
                              checkpoint_dir=str(tmp_path / "ckpt"),
                              transport_heartbeat_s=0.2, transport_dead_peer_s=5.0)
    trainer = LiveLoopTrainer(cfg, device=cuda)
    svc = IngestService(cfg, trainer.replay)
    svc.start()
    srv = MultiDeviceServer(cfg, ServeConfig(buckets=(2, 4, 8), max_wait_ms=1.0,
                                             cache_capacity=16, poll_interval_s=3600.0),
                            devices=[cuda])
    template = dict(srv._params_host)
    applied = []

    def apply(leaves, step, version):
        srv.publish_params(framing.params_from_leaves(leaves, template), step, version=version)
        applied.append(version)

    pub = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", on_checkpoint=apply)
    plane = LiveLoopPlane(cfg, srv, replay=pub)
    pub.audit_source = lambda: plane.tap.audit_tail[-1] if plane.tap.audit_tail else None
    srv.warmup()
    srv.start(watch_checkpoints=False)
    plane.start()
    pub.start()
    client = LocalClient(srv)
    try:
        envs = [CatchHostEnv(height=cfg.obs_shape[0], width=cfg.obs_shape[1], seed=s)
                for s in range(4)]
        state = [(e.reset(), 0.0, True) for e in envs]
        deadline = time.monotonic() + 120.0
        while not trainer.can_train() and time.monotonic() < deadline:
            for i, e in enumerate(envs):
                obs, reward, reset = state[i]
                res = client.act(f"s{i}", obs, reward=reward, reset=reset)
                obs, reward, done, _ = e.step(res.action)
                state[i] = (e.reset() if done else obs, reward, bool(done))
        assert trainer.can_train(), svc.stats()
        assert svc.stats()["ingest_duplicate_blocks"] == 0
        before = dict(lstm_kernel.launch_counts)
        assert trainer.train(1) == 1
        moved = {k: v - before[k] for k, v in lstm_kernel.launch_counts.items()
                 if v != before[k]}
        assert moved == {"lstm_fwd": 2, "lstm_seq_bwd": 1}
        learned = {k: v.detach().clone() for k, v in
                   trainer.trainer.state.net.state_dict().items()}
        svc.broadcast_checkpoint(framing.params_to_leaves(trainer.trainer.state.net),
                                 trainer.step, 1)
        deadline = time.monotonic() + 30.0
        while applied != [1] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert applied == [1] and srv.stats()["params_version"] == 1
        replica = srv.replicas[0]
        served = replica.served_params()
        for k, v in learned.items():
            assert torch.equal(served[k].to(v.device), v), k
        h = c = torch.zeros((1, cfg.hidden_dim), device=cuda)
        last, rng = 0, np.random.default_rng(7)
        for t in range(4):
            obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
            res = client.act("after-reload", obs, reward=0.0, reset=t == 0)
            assert res.params_version == 1
            q, (h, c) = reference_act(replica.net, learned, obs[None], np.array([last]),
                                      np.array([0.0], np.float32), (h, c),
                                      min_batch=res.bucket, row=res.row)
            np.testing.assert_array_equal(q[0].cpu().numpy(), res.q)
            last = res.action
    finally:
        plane.stop()
        pub.stop(flush_deadline_s=1.0)
        srv.stop()
        svc.stop()
        trainer.finish()


def test_sharded_update_on_one_card_equals_the_device_plane(cuda):
    """A dp=2 sharded update with both shards on cuda:0 (their stores, their
    rows, their gradients summed) against the device plane's update on the
    same blocks and coordinates on the card: rtol 1e-4 / atol 1e-5, and 2
    forward + 1 seam-backward launches per shard."""
    from r2d2_tpu_torch.learner import make_fused_train_step, make_sharded_fused_train_step
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
    from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay

    from torch_multihost_child import synth_block

    dp = 2
    cfg = tiny_test().replace(replay_plane="sharded", dp_size=dp, learning_starts=16)
    sharded = ShardedDeviceReplay(cfg, make_mesh(dp, ["cuda:0"] * dp))
    device = DeviceReplayBuffer(cfg.replace(replay_plane="device", dp_size=1), cuda)
    rng = np.random.default_rng(0)
    for _ in range(8):
        block, prios = synth_block(cfg, rng), rng.uniform(0.5, 2.0, cfg.seqs_per_block)
        sharded.add_block(block, prios, None)
        device.add_block(block, prios, None)
    si = sharded.sample_indices(np.random.default_rng(1))
    # block k sits in shard k % dp at local slot k // dp, and at slot k on
    # the device plane
    b_dev = (si.b * dp + np.arange(dp)[:, None]).reshape(-1)
    net = init_params(cfg, seed=1, device=cuda)
    states = []
    for _ in range(2):
        online = copy.deepcopy(net)
        target = copy.deepcopy(net).requires_grad_(False)
        states.append(TrainState(online, target, make_optimizer(cfg, online.parameters()), 0))
    lstm_kernel.reset_launch_counts()
    a, ma, pa = make_sharded_fused_train_step(cfg)(states[0], sharded.stores, si.b, si.s,
                                                   si.is_weights)
    torch.cuda.synchronize()
    launches = {k: v for k, v in lstm_kernel.launch_counts.items() if v}
    assert launches == {"lstm_fwd": 2 * dp, "lstm_seq_bwd": dp}, launches
    coords = [torch.from_numpy(x).to(cuda) for x in (b_dev, si.s.reshape(-1),
                                                       si.is_weights.reshape(-1))]
    b, mb, pb = make_fused_train_step(cfg)(states[1], device.stores, *coords)
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pa.reshape(-1), pb, rtol=1e-4, atol=1e-5)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def _filled_sharded(cfg, dp, n=8, seed=0):
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay

    from torch_multihost_child import synth_block

    replay = ShardedDeviceReplay(cfg, make_mesh(dp, ["cuda:0"] * dp))
    rng = np.random.default_rng(seed)
    for i in range(n):
        replay.add_block(synth_block(cfg, rng), rng.uniform(0.5, 2.0, cfg.seqs_per_block),
                         float(i) if i % 3 == 0 else None)
    return replay


def test_reshard_round_trip_on_the_card(cuda, tmp_path):
    """A dp=2 sharded snapshot on cuda:0: the exact reshard equals a plain
    restore bit for bit; the re-deal onto the device plane keeps the global
    counters and trains, 2 forward + 1 seam-backward launches."""
    from r2d2_tpu_torch.learner import make_fused_train_step
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
    from r2d2_tpu_torch.replay.reshard import reshard_replay, snapshot_paths
    from r2d2_tpu_torch.replay.snapshot import restore_replay, save_replay

    cfg = tiny_test().replace(replay_plane="sharded", dp_size=2, learning_starts=16)
    src = _filled_sharded(cfg, 2)
    save_replay(src, str(tmp_path / "replay_snapshot.npz"))
    paths = snapshot_paths(str(tmp_path))
    exact, plain = _filled_sharded(cfg, 2, n=0), _filled_sharded(cfg, 2, n=0)
    reshard_replay(exact, paths)
    restore_replay(plain, paths[0])
    for a, b in zip(exact.stores, plain.stores):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(exact.shards, plain.shards):
        assert np.array_equal(a.tree.leaves(), b.tree.leaves())
        assert (a.block_ptr, a.size, a.ptr_advances) == (b.block_ptr, b.size, b.ptr_advances)
    dev = DeviceReplayBuffer(cfg.replace(replay_plane="device", dp_size=1), cuda)
    reshard_replay(dev, paths)
    assert dev.env_steps == src.env_steps and len(dev) == len(src)
    assert dev.num_episodes == sum(sh.num_episodes for sh in src.shards)
    si = dev.sample_indices(np.random.default_rng(2))
    net = init_params(cfg, seed=1, device=cuda)
    st = TrainState(net, copy.deepcopy(net).requires_grad_(False),
                    make_optimizer(cfg, net.parameters()), 0)
    lstm_kernel.reset_launch_counts()
    _, m, _ = make_fused_train_step(cfg)(st, dev.stores, *(torch.from_numpy(x).to(cuda)
                                                          for x in (si.b, si.s, si.is_weights)))
    torch.cuda.synchronize()
    assert {k: v for k, v in lstm_kernel.launch_counts.items() if v} == {
        "lstm_fwd": 2, "lstm_seq_bwd": 1}
    assert torch.isfinite(m["loss"])


def test_one_sharded_superstep_on_the_card(cuda):
    """A dp=2 sharded superstep of N=1 x K=2 on cuda:0: each shard's tree
    on the card, 2*K*dp forward + K*dp seam-backward launches, and the
    hand-rolled sharded update of the same draws bit for bit."""
    from r2d2_tpu_torch.learner import make_sharded_fused_multi_train_step
    from r2d2_tpu_torch.megastep import (
        make_sharded_priority_superstep,
        superstep_generators,
        superstep_uniforms,
    )
    from r2d2_tpu_torch.replay import device_sum_tree as dst
    from r2d2_tpu_torch.replay.control_plane import shard_config

    dp, K = 2, 2
    cfg = tiny_test().replace(replay_plane="sharded", dp_size=dp, priority_plane="device",
                              learning_starts=16)
    replay = _filled_sharded(cfg, dp)
    assert replay.dtree_stack.device.type == "cuda"
    scfg = shard_config(cfg, dp)
    L, S = dst.tree_layers(scfg.num_sequences), scfg.seqs_per_block
    u = [superstep_uniforms(superstep_generators(5, 0, 1, cuda, shard=i), K, scfg.batch_size,
                            cuda) for i in range(dp)]
    trees = [sh.dtree.tree for sh in replay.shards]
    nss = [torch.from_numpy(sh.num_seq_store.copy()).to(cuda) for sh in replay.shards]
    net = init_params(cfg, seed=1, device=cuda)
    states = [TrainState(n, copy.deepcopy(net).requires_grad_(False),
                         make_optimizer(cfg, n.parameters()), 0)
              for n in (copy.deepcopy(net), copy.deepcopy(net))]
    lstm_kernel.reset_launch_counts()
    a, trees_a, _ = make_sharded_priority_superstep(cfg, replay.mesh, 1, K)(
        states[0], replay.stores, trees, nss, u)
    torch.cuda.synchronize()
    assert {k: v for k, v in lstm_kernel.launch_counts.items() if v} == {
        "lstm_fwd": 2 * K * dp, "lstm_seq_bwd": K * dp}
    leaf = torch.stack([torch.stack([dst.tree_descend(t, L, uk) for uk in ui[0]])
                        for t, ui in zip(trees, u)], 1)
    p = torch.stack([torch.stack([dst.priorities_of(t, L, leaf[k, i]) for k in range(K)])
                     for i, t in enumerate(trees)], 1)
    b = leaf // S
    s = torch.minimum(leaf % S, torch.clamp(torch.stack(nss)[torch.arange(dp, device=cuda)[None, :, None], b] - 1, min=0))
    bb, _, _ = make_sharded_fused_multi_train_step(cfg, K, is_from_priorities=True)(
        states[1], replay.stores, b, s, p)
    for x, y in zip(a.net.parameters(), bb.net.parameters()):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y) for x, y in zip(trees_a, trees))


def test_tp2_fsdp2_update_on_the_card(cuda):
    """One manual tp=2 x fsdp=2 update on cuda:0 (two batch shards, each
    through its tp group: the LSTM on the gathered gate columns; Adam on two
    moment shards) against the one-device update: rtol 1e-4 / atol 1e-5,
    and 2 forward + 1 seam-backward launches per batch shard."""
    from r2d2_tpu_torch.learner import (
        DeviceBatch,
        ShardedAdam,
        make_sharded_train_step,
        make_train_step,
        shard_optimizer,
    )
    from r2d2_tpu_torch.parallel.mesh import make_mesh, shard_slices

    cfg = tiny_test().replace(tp_size=2, fsdp_size=2)
    assert cfg.resolved_partitioning == "manual"
    rng = np.random.default_rng(0)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    batch = DeviceBatch(
        obs=torch.from_numpy(rng.integers(0, 255, (B, T, *cfg.obs_shape), dtype=np.uint8)),
        last_action=torch.from_numpy(rng.integers(0, cfg.action_dim, (B, T))),
        last_reward=torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)),
        hidden=torch.from_numpy(rng.normal(size=(B, 2, cfg.hidden_dim)).astype(np.float32)),
        action=torch.from_numpy(rng.integers(0, cfg.action_dim, (B, L))),
        n_step_reward=torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32)),
        gamma=torch.full((B, L), 0.99),
        burn_in_steps=torch.full((B,), cfg.burn_in_steps, dtype=torch.int32),
        learning_steps=torch.full((B,), L, dtype=torch.int32),
        forward_steps=torch.full((B,), cfg.forward_steps, dtype=torch.int32),
        is_weights=torch.from_numpy(rng.uniform(0.3, 1.0, B).astype(np.float32)),
    ).rows(slice(None), cuda)
    net = init_params(cfg, seed=1, device=cuda)
    states = [TrainState(n, copy.deepcopy(net).requires_grad_(False),
                         make_optimizer(cfg, n.parameters()), 0)
              for n in (copy.deepcopy(net), copy.deepcopy(net))]
    mesh = make_mesh(1, ["cuda:0"] * 4, tp=2, fsdp=2)
    shard_optimizer(cfg, states[0], mesh)
    assert isinstance(states[0].optimizer, ShardedAdam)
    lstm_kernel.reset_launch_counts()
    a, ma, pa = make_sharded_train_step(cfg, mesh=mesh, data_axes=("dp", "fsdp"))(
        states[0], [batch.rows(sl, cuda) for sl in shard_slices(B, 2)])
    torch.cuda.synchronize()
    assert {k: v for k, v in lstm_kernel.launch_counts.items() if v} == {
        "lstm_fwd": 4, "lstm_seq_bwd": 2}
    b, mb, pb = make_train_step(cfg.replace(tp_size=1, fsdp_size=1))(states[1], batch)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(ma[k], mb[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pa.reshape(-1), pb, rtol=1e-4, atol=1e-5)
    for x, y in zip(a.net.parameters(), b.net.parameters()):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def test_graph_gate_on_the_card(cuda):
    """The graph checks over every entry point on cuda:0, each recorded call
    under set_sync_debug_mode("error"): 0 findings, and on every train step
    the kernel dispatches equal the launches form by form (no plain version
    ran on the card): 2 forwards + 1 backward of the arm's form an update."""
    from r2d2_tpu_torch.analysis import graph_rules as g
    from r2d2_tpu_torch.analysis.findings import render_text

    findings = g.scan_entry_points(device="cuda")
    assert findings == [], render_text(findings)
    for p, sfx in (("fp32", ""), ("bf16", "_bf16")):
        trace = g.train_step_trace(p, "cuda")
        assert trace.dispatches == trace.launches == {f"lstm_fwd{sfx}": 4,
                                                      f"lstm_seq_bwd{sfx}": 2}
        for arm, form in (("fused_dwh", "lstm_seq_bwd_fused"), ("ckpt", "lstm_seq_bwd_ckpt")):
            trace = g.backward_arm_train_step_trace(p, arm, "cuda")
            assert trace.dispatches == trace.launches == {f"lstm_fwd{sfx}": 4,
                                                          f"{form}{sfx}": 2}
        trace = g.priority_superstep_trace(p, "cuda")
        assert trace.dispatches == trace.launches
