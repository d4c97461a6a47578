"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one (the kernels have
no CPU mode). The file imports nothing of JAX, so on a machine with the card
and without JAX it runs on its own, skipping the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: the kernels and the plain versions both work in float32 but sum
the H-long (and 4H-long) dot products in other orders, and the recurrence
carries those differences through T steps; 1e-4 absolute (dz also 1e-4
relative) holds them with room at T=85, H=512.
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


@pytest.mark.parametrize("shape", [(7, 5, 32), (13, 67, 96), (3, 2, 640), (85, 64, 512)])
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
    assert lstm_kernel.launch_counts == {"lstm_fwd": 1, "lstm_seq_bwd": 4}


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
    cfg = tiny_test().replace(target_net_update_interval=2)
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

    for _ in range(3):
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
