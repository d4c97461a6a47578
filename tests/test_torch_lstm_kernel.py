"""The port's fused LSTM sequence op (r2d2_tpu_torch/ops/lstm_kernel.py)
against the JAX package's Pallas op (r2d2_tpu/ops/pallas_lstm.py), which runs
in interpret mode on the CPU.

On the CPU the port's wrappers run the kernels' plain PyTorch versions, so
these tests hold the plain versions (the arithmetic the CUDA kernels repeat)
against the Pallas kernels. The CUDA kernels themselves are held against the
plain versions on the card, by `chip_smoke.py` and tests/test_torch_cuda.py.

Tolerances follow tests/test_pallas_lstm.py: forward atol 1e-5, gradients
rtol 1e-4 / atol 1e-5, all float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops import pallas_lstm as ref
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.ops import lstm_kernel as port

torch.set_num_threads(1)

T, B, H = 7, 5, 8


def _inputs(seed, T=T, B=B, H=H):
    rng = np.random.default_rng(seed)
    return dict(
        proj_t=rng.normal(size=(T, B, 4 * H)).astype(np.float32),
        wh=(rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
        h0=(rng.normal(size=(B, H)) * 0.3).astype(np.float32),
        c0=(rng.normal(size=(B, H)) * 0.3).astype(np.float32),
        ct=rng.normal(size=(T, B, H)).astype(np.float32),
        ch=rng.normal(size=(B, H)).astype(np.float32),
        cc=rng.normal(size=(B, H)).astype(np.float32),
    )


BURNS = {
    "zero": np.zeros(B, np.int32),
    "mid": np.full(B, T // 2, np.int32),
    "last": np.full(B, T - 1, np.int32),
    "mixed": np.array([0, 3, T - 1, 1, 5], np.int32),
}


def _jax_unroll(x, burn):
    """Pallas op: values and gradients w.r.t. (proj, wh, h0, c0)."""

    def loss(proj_t, wh, h0, c0):
        outs, (hT, cT) = ref.lstm_seq_unroll(proj_t, wh, h0, c0, jnp.asarray(burn))
        return jnp.sum(outs * x["ct"]) + jnp.sum(hT * x["ch"]) + jnp.sum(cT * x["cc"])

    args = [jnp.asarray(x[k]) for k in ("proj_t", "wh", "h0", "c0")]
    outs, (hT, cT) = ref.lstm_seq_unroll(*args, jnp.asarray(burn))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(a) for a in (outs, hT, cT)], [np.asarray(g) for g in grads]


def _port_unroll(x, burn):
    args = [torch.tensor(x[k], requires_grad=True) for k in ("proj_t", "wh", "h0", "c0")]
    outs, (hT, cT) = port.lstm_seq_unroll(*args, torch.from_numpy(burn))
    loss = (
        torch.sum(outs * torch.from_numpy(x["ct"]))
        + torch.sum(hT * torch.from_numpy(x["ch"]))
        + torch.sum(cT * torch.from_numpy(x["cc"]))
    )
    loss.backward()
    values = [a.detach().numpy() for a in (outs, hT, cT)]
    return values, [a.grad.numpy() for a in args]


@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_seq_unroll_matches_pallas(burn_name):
    burn = BURNS[burn_name]
    x = _inputs(0)
    (j_outs, j_hT, j_cT), j_grads = _jax_unroll(x, burn)
    (p_outs, p_hT, p_cT), p_grads = _port_unroll(x, burn)
    np.testing.assert_allclose(p_outs, j_outs, atol=1e-5)
    np.testing.assert_allclose(p_hT, j_hT, atol=1e-5)
    np.testing.assert_allclose(p_cT, j_cT, atol=1e-5)
    for name, pg, jg in zip(("proj", "wh"), p_grads[:2], j_grads[:2]):
        np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-5, err_msg=name)
    # the seam cuts every path into the initial state: exact zeros, as tensors
    assert not p_grads[2].any() and not p_grads[3].any()
    # burn-in steps of each row get exactly zero input-projection gradient
    dproj = p_grads[0]
    for b in range(B):
        assert not dproj[: burn[b], b].any()
        assert dproj[burn[b]:, b].any()


def test_initial_state_grads_are_zero_tensors():
    """autograd.grad without allow_unused raises if the op returned None for
    h0 / c0; the seam makes them zero tensors instead."""
    x = _inputs(1)
    args = [torch.tensor(x[k], requires_grad=True) for k in ("proj_t", "wh", "h0", "c0")]
    outs, (hT, cT) = port.lstm_seq_unroll(*args, torch.from_numpy(BURNS["mid"]))
    grads = torch.autograd.grad(outs.sum() + hT.sum() + cT.sum(), args)
    assert grads[2].shape == (B, H) and not grads[2].any()
    assert grads[3].shape == (B, H) and not grads[3].any()


def test_plain_forward_matches_pallas_forward_kernel():
    x = _inputs(2)
    j_outs, j_cs = ref._lstm_fwd_call(
        *(jnp.asarray(x[k]) for k in ("proj_t", "wh", "h0", "c0")), interpret=True
    )
    p_outs, p_cs = port.lstm_fwd(*(torch.from_numpy(x[k]) for k in ("proj_t", "wh", "h0", "c0")))
    np.testing.assert_allclose(p_outs.numpy(), np.asarray(j_outs), atol=1e-5)
    np.testing.assert_allclose(p_cs.numpy(), np.asarray(j_cs), atol=1e-5)


@pytest.mark.parametrize("burn_name", ["zero", "mixed"])
def test_plain_seq_backward_matches_pallas_kernel(burn_name):
    """The seam backward alone, on the same residuals: dz of the plain
    version against `_seq_bwd_kernel`."""
    burn = BURNS[burn_name]
    x = _inputs(3)
    rng = np.random.default_rng(4)
    outs, cs = port.lstm_fwd_plain(*(torch.from_numpy(x[k]) for k in ("proj_t", "wh", "h0", "c0")))
    hprev = np.concatenate([x["h0"][None], outs[:-1].numpy()])
    cprev = np.concatenate([x["c0"][None], cs[:-1].numpy()])
    dout = rng.normal(size=(T, B, H)).astype(np.float32)
    dcT = rng.normal(size=(B, H)).astype(np.float32)
    operands = (dout, x["proj_t"], hprev, cprev, cs.numpy(), x["wh"], dcT)
    j_dz = ref._lstm_seq_bwd_call(
        *(jnp.asarray(a) for a in operands), jnp.asarray(burn.reshape(B, 1)), interpret=True
    )
    p_dz = port.lstm_seq_bwd(*(torch.from_numpy(np.ascontiguousarray(a)) for a in operands),
                             torch.from_numpy(burn))
    np.testing.assert_allclose(p_dz.numpy(), np.asarray(j_dz), rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    port.reset_launch_counts()
    x = _inputs(5)
    port.lstm_fwd(*(torch.from_numpy(x[k]) for k in ("proj_t", "wh", "h0", "c0")))
    _port_unroll(x, BURNS["mixed"])
    assert port.launch_counts == {"lstm_fwd": 0, "lstm_seq_bwd": 0}


@pytest.mark.parametrize(
    "T_,B_,H_,budget_mb,dtype,mode",
    [
        (85, 64, 512, 128, "float32", "auto"),   # the atari widths: default arm
        (85, 64, 512, 64, "float32", "auto"),    # over budget: fused_dwh
        (85, 64, 512, 8, "float32", "auto"),     # far over: ckpt
        (85, 64, 512, 1, "bfloat16", "auto"),    # nothing fits: largest stride
        (80, 32, 256, 16, "bfloat16", "auto"),
        (85, 64, 512, 128, "float32", "ckpt"),
        (85, 64, 512, 128, "float32", "fused_dwh"),
        (10, 8, 32, 128, "float32", "default"),
    ],
)
def test_backward_arm_choice_matches_reference(T_, B_, H_, budget_mb, dtype, mode):
    budget = budget_mb * (1 << 20)
    assert port.choose_backward_arm(T_, B_, H_, dtype, budget, mode) == ref.choose_backward_arm(
        T_, B_, H_, dtype, budget, mode
    )
    for every in (0, 5, 17):
        assert port.seq_backward_residual_bytes(T_, B_, H_, dtype, every) == (
            ref.seq_backward_residual_bytes(T_, B_, H_, dtype, every)
        )


def test_config_resolves_kernels_on_cuda_and_plain_on_cpu():
    cfg = tiny_test()
    assert cfg.resolve_backward_arm(device="cpu") == ("default", 0)
    assert cfg.resolve_backward_arm(device="cuda") == ("default", 0)
    # a budget the default arm exceeds: the reference would pick a K4/K5
    # arm, which the port refuses (queued) instead of running another one
    small = cfg.replace(batch_size=4096, backward_residual_budget_mb=1)
    assert small.resolve_backward_arm(device="cpu") == ("default", 0)
    arm, _ = small.resolve_backward_arm(device="cuda")
    assert arm != "default"
    with pytest.raises(NotImplementedError, match="queued"):
        R2D2Network.from_config(small, device="cuda")
    with pytest.raises(ValueError, match="only on the CPU"):
        R2D2Network.from_config(cfg.replace(lstm_backend="scan"), device="cuda")
