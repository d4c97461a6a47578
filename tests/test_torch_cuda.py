"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one (the kernels have
no CPU mode). The file imports nothing of JAX, so on a machine with the card
and without JAX it runs on its own, skipping the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: the kernels and the plain versions both work in float32 but sum
the H-long (and 4H-long) dot products in other orders, and the recurrence
carries those differences through T steps; 1e-4 absolute (dz also 1e-4
relative) holds them with room at T=85, H=512. dWh, summed in the kernel
(K4 over per-block partials, K5 per column slice and segment), is held to
1e-4 of its largest entry: each entry
sums T*B products of both signs, so entries that cancel to near zero have
no meaningful relative error.
"""

import copy

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.learner import DeviceBatch, TrainState, make_optimizer, make_train_step
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
        lstm_fwd=0, lstm_bwd=1, lstm_seq_bwd=0, lstm_seq_bwd_fused=4,
        lstm_seq_bwd_ckpt=4 * len(strides))


def test_column_split_kernels_give_the_same_bits_every_launch(cuda):
    """K1, K2, K3 (dz, dh0, dc0) and K5 (dz, dWh at S=5) at the atari
    widths: no float atomics, each output summed by one thread in a fixed
    order."""
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
    S = 5
    ckpt = (walk[0], proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
            torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, walk[6], walk[7], S)
    for a, b in zip(lstm_kernel.lstm_seq_bwd_ckpt(*ckpt), lstm_kernel.lstm_seq_bwd_ckpt(*ckpt)):
        assert torch.equal(a, b)


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


def _card_vs_cpu(cfg, steps):
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
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-4, atol=1e-5)
    for (name, a), b in zip(states["cuda"].net.state_dict().items(),
                            states["cpu"].net.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5, msg=name)
