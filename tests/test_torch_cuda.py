"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one (the kernels have
no CPU mode). The file imports nothing of JAX, so on a machine with the card
and without JAX it runs on its own, skipping the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: the kernels and the plain versions both work in float32 but sum
the H-long (and 4H-long) dot products in other orders, and the recurrence
carries those differences through T steps; 1e-4 absolute (dz also 1e-4
relative) holds them with room at T=85, H=512. dWh, summed in the kernel
(K4 per column slice over (t, b), K5 per column slice and segment), is
held to 1e-4 of its largest entry: each entry sums T*B products of both
signs, so entries that cancel to near zero have no meaningful relative
error. K4's dz is held to K2's bit for bit: the same walk in the same
geometry.

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
"""

import copy

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
