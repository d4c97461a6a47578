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
    assert port.launch_counts == dict.fromkeys(port.KERNELS, 0)


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
    # a budget the default arm exceeds: on the card "auto" picks a K4/K5
    # arm, as the reference does on a TPU; the plain versions keep the
    # default one
    small = cfg.replace(batch_size=4096, backward_residual_budget_mb=1)
    assert small.resolve_backward_arm(device="cpu") == ("default", 0)
    arm = small.resolve_backward_arm(device="cuda")
    assert arm[0] != "default"
    # the network is built, and its core carries the arm resolved for its
    # device ("pallas" names the kernels' arms on the CPU too)
    assert R2D2Network.from_config(small, device="cpu").core.backward_arm == ("default", 0)
    pallas = small.replace(lstm_backend="pallas")
    assert R2D2Network.from_config(pallas, device="cpu").core.backward_arm == arm
    with pytest.raises(ValueError, match="only on the CPU"):
        R2D2Network.from_config(cfg.replace(lstm_backend="scan"), device="cuda")


# the H100: 132 SMs, 232,448 bytes of shared memory a block may opt in to
H100_SMS, H100_SMEM = 132, 232_448


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_seq_bwd", "lstm_bwd", "lstm_seq_bwd_fused",
                                    "lstm_seq_bwd_ckpt"], ids=["K1", "K2", "K3", "K4", "K5"])
@pytest.mark.parametrize("H_", [8, 32, 96, 512, 640, 2048])
def test_column_split_geometry_at_the_atari_batch(H_, kernel):
    """The column split of K1 to K5 at B=64 on the H100: every hidden
    unit owned by exactly one block, no block empty, the grid within
    the SM count (one resident block per SM), a whole number of k-slices
    of the block's (4 rows x 1 unit) items, the shared memory within the
    card's limit, and the wh slice pinned at the atari width and streamed
    at the xl width. The reverse walks (K2 to K5) share one layout, and a
    stage of K4's and K5's dWh pass holds at least one row."""
    B_ = 64
    g = port.lstm_geometry(B_, H_, kernel, H100_SMS, H100_SMEM)
    owned = [j for blk in range(g.grid) for j in range(blk * g.units, min(H_, (blk + 1) * g.units))]
    assert owned == list(range(H_))
    assert (g.grid - 1) * g.units < H_  # the last block owns at least one unit
    assert g.grid <= H100_SMS
    items = (B_ // 4) * g.units
    assert g.threads % items == 0 and g.threads <= 512
    assert g.k_tile <= H_
    assert g.smem_bytes <= H100_SMEM
    if H_ == 512:
        assert g.pinned and (g.units, g.grid) == (4, 128)
    if H_ == 2048:
        assert not g.pinned and (g.units, g.grid) == (16, 128)
    if kernel != "lstm_fwd":
        assert g == port.lstm_geometry(B_, H_, "lstm_seq_bwd", H100_SMS, H100_SMEM)
    if kernel in ("lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt"):
        assert port._dwh_tile_rows(H_, g.units, g.threads, g.k_tile, g.pinned, B_,
                                   4 * -(-g.units // 4)) >= 1


# the column split of every kernel before row chunks, where it fit:
# (units, grid, threads, k_tile, pinned, smem_bytes) at 132 SMs, 232,448 B
_PR5_GEOMETRY = {
    (64, 512): {k: (4, 128, 256, 128, True, 184320 if k == "lstm_fwd" else 218176)
                for k in port.SOURCES},
    (128, 2048): {k: (16, 128, 512, 32, False, 139264 if k == "lstm_fwd" else 156672)
                  for k in port.SOURCES},
    (512, 512): {k: (4, 128, 512, 16, True, 229376) if k == "lstm_fwd"
                 else (4, 128, 512, 8, True, 204864) for k in port.SOURCES},
}


@pytest.mark.parametrize("shape", sorted(_PR5_GEOMETRY), ids=str)
def test_column_split_geometry_that_fit_before_row_chunks_is_unchanged(shape):
    """Where the batch fit one block, every kernel keeps one chunk (rows =
    the batch padded to 4) and the geometry it had: the same code path."""
    B_, H_ = shape
    for kernel, want in _PR5_GEOMETRY[shape].items():
        g = port.lstm_geometry(B_, H_, kernel, H100_SMS, H100_SMEM)
        assert tuple(g)[:6] == want and g.rows == 4 * -(-B_ // 4) and g.chunks(B_) == 1, kernel


# the bf16 column split of the seam backward and the fused-dWh backward (K2,
# K4), on the tensor cores: (units, grid, threads, k_tile, pinned,
# smem_bytes, rows) at the atari, wide B=96, xl and atari B=192 shapes and
# in row chunks
_SEAM_BF16_GEOMETRY = {
    (64, 512): (4, 128, 128, 256, True, 198016, 64),
    (96, 1024): (8, 128, 256, 128, False, 169856, 96),
    (64, 2048): (16, 128, 256, 128, False, 181504, 64),
    (192, 512): (4, 128, 256, 64, True, 184192, 192),
    (600, 512): (4, 128, 256, 64, True, 191424, 208),
    (200, 2048): (16, 128, 256, 128, False, 177408, 64),
    (1024, 512): (4, 128, 256, 64, True, 222336, 256),
    (256, 2048): (16, 128, 256, 128, False, 177408, 64),
}


@pytest.mark.parametrize("shape", sorted(_SEAM_BF16_GEOMETRY), ids=str)
def test_column_split_geometry_of_the_seam_bf16_forms_is_one_split(shape):
    """K2- and K4-bf16 run on the tensor cores in one split (so K4-bf16's
    dz is K2-bf16's f32 dz rounded, bit for bit), the one K5-bf16 takes."""
    B_, H_ = shape
    for kernel in ("lstm_seq_bwd", "lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt"):
        assert port.tensor_cores(kernel, 2)
        g = port.lstm_geometry(B_, H_, kernel, H100_SMS, H100_SMEM, 2)
        assert tuple(g) == _SEAM_BF16_GEOMETRY[shape], kernel


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("H_", [512, 1024, 2048])
def test_column_split_geometry_splits_every_batch(H_, itemsize):
    """Every kernel has a column split for every batch from 1 to 4096 rows
    at the widths the model presets train (hidden 512, 1024, 2048), in
    both operand sizes: whole chunks that cover the batch, the block within
    512 threads and the card's shared memory, a stage of K4's and K5's dWh
    pass holding a row. The FMA forms (float32) take chunks of 4-row groups
    and a whole number of k-slices of their items; the tensor-core forms
    (bf16) chunks of 16-row tiles, units a multiple of 4 (the carry's
    padded to 8), k-tiles a multiple of 16, and whole warps, at least one
    thread per 4 rows and unit (the epilogue's owners), and no more than
    256 (a thread may keep 255 registers). The bf16 dWh pass of K4 and K5
    stages 16-row tiles of h and both dz planes; K2-, K4- and K5-bf16 take
    one split, K3-bf16's wherever such a tile fits that split's buffers."""
    batches = sorted({*range(1, 70), *range(70, 4097, 37), 1024, 2048, 4096})
    for kernel in port.SOURCES:
        for B_ in batches:
            g = port.lstm_geometry(B_, H_, kernel, H100_SMS, H100_SMEM, itemsize)
            groups = g.rows // 4
            assert g.rows % 4 == 0 and g.chunks(B_) * g.rows >= B_ > (g.chunks(B_) - 1) * g.rows
            assert g.threads <= 512
            if port.tensor_cores(kernel, itemsize):
                gates, carry_units = port.tensor_core_layout(g.units)
                assert g.rows % 16 == 0 and g.units % 4 == 0 and g.k_tile % 16 == 0
                assert gates % 16 == 0 and carry_units % 8 == 0 and carry_units >= g.units
                assert g.threads % 32 == 0 and groups * g.units <= g.threads <= 256
            else:
                assert g.threads % (groups * g.units) == 0
            assert g.smem_bytes <= H100_SMEM and g.grid <= H100_SMS
            seam = kernel in ("lstm_seq_bwd", "lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt")
            if seam and port.tensor_cores(kernel, itemsize):
                rows = port._dwh_tc_tile_rows(H_, g.units, g.threads, g.k_tile, g.pinned, g.rows)
                assert rows >= 16 and rows % 16 == 0
                assert g == port.lstm_geometry(B_, H_, "lstm_seq_bwd_ckpt", H100_SMS, H100_SMEM,
                                               itemsize)
                k3 = port.lstm_geometry(B_, H_, "lstm_bwd", H100_SMS, H100_SMEM, itemsize)
                assert g == k3 or port._dwh_tc_tile_rows(
                    H_, k3.units, k3.threads, k3.k_tile, k3.pinned, k3.rows) < 16
            elif kernel in ("lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt"):
                assert port._dwh_tile_rows(H_, g.units, g.threads, g.k_tile, g.pinned, g.rows,
                                           4 * -(-g.units // 4), itemsize) >= 1


def test_column_split_geometry_refuses_what_cannot_fit():
    """What the card still refuses. A batch wider than a block's threads
    is no longer among it: (256, 2048), which needed 1,024 threads in one
    chunk, now walks its rows in two chunks of 128."""
    g = port.lstm_geometry(256, 2048, "lstm_seq_bwd", H100_SMS, H100_SMEM)
    assert (g.rows, g.chunks(256), g.threads) == (128, 2, 512)
    with pytest.raises(ValueError, match="shared memory"):
        port.lstm_geometry(64, 512, "lstm_bwd", H100_SMS, 1024)
    with pytest.raises(ValueError, match="multiple of 4"):
        port.lstm_geometry(64, 510, "lstm_fwd", H100_SMS, H100_SMEM)
    with pytest.raises(ValueError, match="multiple of 8"):
        port.lstm_geometry(64, 516, "lstm_fwd", H100_SMS, H100_SMEM, itemsize=2)
    with pytest.raises(ValueError, match="threads"):
        port.lstm_geometry(64, 512, "lstm_fwd", H100_SMS, H100_SMEM, max_threads=2)
    with pytest.raises(ValueError, match="column-split"):
        port.lstm_geometry(64, 512, "not_a_kernel", H100_SMS, H100_SMEM)
    # a tensor-core form: 16 rows of 132 units need 528 threads, over its
    # ceiling of 256, and no warp fits 16
    with pytest.raises(ValueError, match="threads"):
        port.lstm_geometry(64, 132 * 132, "lstm_bwd", H100_SMS, H100_SMEM, itemsize=2)
    with pytest.raises(ValueError, match="threads"):
        port.lstm_geometry(64, 512, "lstm_fwd", H100_SMS, H100_SMEM, itemsize=2, max_threads=16)
