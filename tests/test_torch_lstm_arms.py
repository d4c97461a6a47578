"""The port's three other LSTM backward ops — the seamless unroll
(`lstm_unroll`, kernel K3), the fused-dWh arm (`lstm_seq_unroll_fused_dwh`,
K4) and the checkpointed arm (`lstm_seq_unroll_ckpt(S)`, K5) — and the
training paths that select them, against the JAX package, whose Pallas ops
run in interpret mode on the CPU.

On the CPU the port's wrappers run the kernels' plain PyTorch versions, so
these tests hold the plain versions (the arithmetic the CUDA kernels repeat)
against the Pallas kernels; the CUDA kernels are held against the plain
versions by tests/test_torch_kernel_emulation.py here, and on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The arms are reached with lstm_backend="pallas": on a CPU "auto" resolves to
the default arm in both packages.

Tolerances follow tests/test_pallas_lstm.py: forward atol 1e-5, gradients
and train-step results rtol 1e-4 / atol 1e-5, all float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu import config as jax_config
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_train_step as jax_make_train_step
from r2d2_tpu.ops import pallas_lstm as ref
from r2d2_tpu_torch import config as port_config
from r2d2_tpu_torch.interop import params_to_flax
from r2d2_tpu_torch.learner import DeviceBatch, make_train_step
from r2d2_tpu_torch.ops import lstm_kernel as port
from test_torch_learner import _assert_trees_close, _batch, _np_tree, _port_state, _Sampled

torch.set_num_threads(1)

T, B, H = 6, 8, 8

# the seam vectors of tests/test_pallas_lstm.py's checkpoint tests
BURNS = {
    # on segment boundaries (S=2 over T=6: boundaries 0/2/4)
    "on": np.array([0, 2, 4, 2, 4, 0, 2, 4], np.int32),
    # strictly inside recomputed segments
    "inside": np.array([1, 3, 5, 1, 3, 5, 1, 3], np.int32),
    # mixed, plus the all-learn and nearly-all-burn extremes
    "mixed": np.array([0, 5, 1, 4, 2, 3, 0, 5], np.int32),
}
KEYS = ("proj_t", "wh", "h0", "c0")


def _inputs(seed):
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


def _jax_op(op, x, *extra):
    """Values and gradients w.r.t. (proj, wh, h0, c0) of a Pallas op."""
    extra = [jnp.asarray(e) for e in extra]

    def loss(*args):
        outs, (hT, cT) = op(*args, *extra)
        return jnp.sum(outs * x["ct"]) + jnp.sum(hT * x["ch"]) + jnp.sum(cT * x["cc"])

    args = [jnp.asarray(x[k]) for k in KEYS]
    outs, (hT, cT) = op(*args, *extra)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(a) for a in (outs, hT, cT)], [np.asarray(g) for g in grads]


def _port_op(op, x, *extra):
    args = [torch.tensor(x[k], requires_grad=True) for k in KEYS]
    outs, (hT, cT) = op(*args, *(torch.from_numpy(e) for e in extra))
    loss = (
        torch.sum(outs * torch.from_numpy(x["ct"]))
        + torch.sum(hT * torch.from_numpy(x["ch"]))
        + torch.sum(cT * torch.from_numpy(x["cc"]))
    )
    loss.backward()
    return [a.detach().numpy() for a in (outs, hT, cT)], [a.grad.numpy() for a in args]


def _assert_matches(port_out, jax_out):
    (p_vals, p_grads), (j_vals, j_grads) = port_out, jax_out
    for name, pv, jv in zip(("outs", "hT", "cT"), p_vals, j_vals):
        np.testing.assert_allclose(pv, jv, atol=1e-5, err_msg=name)
    for name, pg, jg in zip(KEYS, p_grads, j_grads):
        np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-5, err_msg=f"d{name}")


def _assert_seam(grads, burn):
    dproj, _, dh0, dc0 = grads
    assert not dh0.any() and not dc0.any()
    for b in range(B):
        assert not dproj[: burn[b], b].any()
        assert dproj[burn[b]:, b].any()


# --------------------------------------------------------------------------
# each op against its Pallas op
# --------------------------------------------------------------------------


def test_unroll_matches_pallas_with_real_initial_state_grads():
    x = _inputs(0)
    p = _port_op(port.lstm_unroll, x)
    _assert_matches(p, _jax_op(ref.lstm_unroll, x))
    # no seam: the gradient reaches every step and the initial state
    dproj, _, dh0, dc0 = p[1]
    assert dh0.any() and dc0.any() and all(dproj[t].any() for t in range(T))


@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_fused_dwh_matches_pallas(burn_name):
    burn = BURNS[burn_name]
    x = _inputs(1)
    p = _port_op(port.lstm_seq_unroll_fused_dwh, x, burn)
    _assert_matches(p, _jax_op(ref.lstm_seq_unroll_fused_dwh, x, burn))
    _assert_seam(p[1], burn)


@pytest.mark.parametrize("S", [1, 2, 3, 6])
@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_ckpt_matches_pallas(S, burn_name):
    burn = BURNS[burn_name]
    x = _inputs(2)
    p = _port_op(port.lstm_seq_unroll_ckpt(S), x, burn)
    _assert_matches(p, _jax_op(ref.lstm_seq_unroll_ckpt(S), x, burn))
    _assert_seam(p[1], burn)


# --------------------------------------------------------------------------
# each plain version against its Pallas kernel body
# --------------------------------------------------------------------------


def _residuals(seed):
    x = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    outs, cs = port.lstm_fwd_plain(*(torch.from_numpy(x[k]) for k in KEYS))
    outs, cs = outs.numpy(), cs.numpy()
    return dict(
        x=x, outs=outs, cs=cs,
        hprev=np.concatenate([x["h0"][None], outs[:-1]]),
        cprev=np.concatenate([x["c0"][None], cs[:-1]]),
        dout=rng.normal(size=(T, B, H)).astype(np.float32),
        dcT=rng.normal(size=(B, H)).astype(np.float32),
    )


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_plain_seamless_backward_matches_pallas_kernel():
    r = _residuals(3)
    j, p = _both((r["dout"], r["x"]["proj_t"], r["hprev"], r["cprev"], r["cs"], r["x"]["wh"],
                  r["dcT"]))
    want = ref._lstm_bwd_call(*j, interpret=True)
    got = port.lstm_bwd(*p)
    for name, g, w in zip(("dz", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_plain_fused_backward_matches_pallas_kernel(burn_name):
    burn = BURNS[burn_name]
    r = _residuals(4)
    j, p = _both((r["dout"], r["x"]["proj_t"], r["hprev"], r["cprev"], r["cs"], r["x"]["wh"],
                  r["dcT"]))
    want = ref._lstm_seq_bwd_fused_call(*j, jnp.asarray(burn.reshape(B, 1)), interpret=True)
    got = port.lstm_seq_bwd_fused(*p, torch.from_numpy(burn))
    for name, g, w in zip(("dz", "dwh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("S", [1, 2, 3, 6])
@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_plain_ckpt_backward_matches_pallas_kernel(S, burn_name):
    burn = BURNS[burn_name]
    r = _residuals(5)
    h_ckpt = np.concatenate([r["x"]["h0"][None], r["outs"][S - 1 : T - 1 : S]])
    c_ckpt = np.concatenate([r["x"]["c0"][None], r["cs"][S - 1 : T - 1 : S]])
    j, p = _both((r["dout"], r["x"]["proj_t"], h_ckpt, c_ckpt, r["x"]["wh"], r["dcT"]))
    want = ref._lstm_seq_bwd_ckpt_call(*j, jnp.asarray(burn.reshape(B, 1)), S=S,
                                       interpret=True)
    got = port.lstm_seq_bwd_ckpt(*p, torch.from_numpy(burn), S)
    for name, g, w in zip(("dz", "dwh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
    for b in range(B):
        assert not got[0][: burn[b], b].any()


# --------------------------------------------------------------------------
# contracts against the port's own default arm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("burn_name", sorted(BURNS))
def test_fused_dwh_dproj_is_the_default_arms_bit_for_bit(burn_name):
    burn = BURNS[burn_name]
    x = _inputs(6)
    _, default = _port_op(port.lstm_seq_unroll, x, burn)
    _, fused = _port_op(port.lstm_seq_unroll_fused_dwh, x, burn)
    np.testing.assert_array_equal(fused[0], default[0])
    np.testing.assert_allclose(fused[1], default[1], rtol=1e-4, atol=1e-5)


def test_ckpt_refuses_a_stride_that_does_not_divide_T():
    """Where a gradient is wanted; the backward kernel refuses it too."""
    x = _inputs(7)
    with pytest.raises(ValueError, match="not divisible"):
        _port_op(port.lstm_seq_unroll_ckpt(4), x, BURNS["mixed"])
    with pytest.raises(ValueError, match="not divisible"):
        port.lstm_seq_bwd_ckpt(*(torch.zeros(s) for s in (
            (T, B, H), (T, B, 4 * H), (1, B, H), (1, B, H), (H, 4 * H), (B, H))),
            torch.zeros(B, dtype=torch.int32), 4)
    assert port.lstm_seq_unroll_ckpt(3) is port.lstm_seq_unroll_ckpt(3)


def test_ckpt_runs_an_undifferentiated_call_at_a_stride_that_does_not_divide_T():
    """As the JAX op, which raises only in its VJP forward: with no
    gradient wanted the values are the plain unroll's."""
    x = _inputs(7)
    burn = BURNS["mixed"]
    j_outs, (j_hT, j_cT) = ref.lstm_seq_unroll_ckpt(4)(
        *(jnp.asarray(x[k]) for k in KEYS), jnp.asarray(burn))
    args = [torch.from_numpy(x[k]) for k in KEYS]
    got = port.lstm_seq_unroll_ckpt(4)(*args, torch.from_numpy(burn))
    # no grad mode: the inputs may require a gradient that nobody takes
    with torch.no_grad():
        args_rg = [a.clone().requires_grad_(True) for a in args]
        no_grad = port.lstm_seq_unroll_ckpt(4)(*args_rg, torch.from_numpy(burn))
    for outs, (hT, cT) in (got, no_grad):
        np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs), atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(j_hT), atol=1e-5)
        np.testing.assert_allclose(cT.numpy(), np.asarray(j_cT), atol=1e-5)


def test_cpu_arms_launch_no_kernel():
    port.reset_launch_counts()
    x = _inputs(8)
    _port_op(port.lstm_unroll, x)
    _port_op(port.lstm_seq_unroll_fused_dwh, x, BURNS["mixed"])
    _port_op(port.lstm_seq_unroll_ckpt(2), x, BURNS["mixed"])
    assert set(port.launch_counts) == set(port.KERNELS)
    assert not any(port.launch_counts.values())


# --------------------------------------------------------------------------
# train steps per arm against JAX make_train_step
# --------------------------------------------------------------------------

ARMS = {
    "fused_dwh": dict(backward_arm="fused_dwh"),
    "ckpt": dict(backward_arm="ckpt"),
    "no_seam": dict(fused_sequence=False),
}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_train_steps_per_arm_match_jax(arm, steps):
    """As tests/test_torch_learner.py does it, under each other arm."""
    kw = dict(target_net_update_interval=2, lstm_backend="pallas", **ARMS[arm])
    jcfg = jax_config.tiny_test().replace(**kw)
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jcfg, net, donate=False)
    cfg = port_config.tiny_test().replace(**kw)
    pstate = _port_state(cfg, _np_tree(jstate.params))
    assert pstate.net.core.backward_arm == jcfg.resolve_backward_arm()
    pstep = make_train_step(cfg)
    for i in range(steps):
        b = _Sampled(_batch(cfg, seed=20 + i))
        jstate, jm, jprio = jstep(jstate, JaxBatch.from_sampled(b))
        pstate, pm, pprio = pstep(pstate, DeviceBatch.from_sampled(b, "cpu"))
        for k in ("loss", "grad_norm", "q_mean", "target_mean", "td_abs_mean"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(pprio.numpy(), np.asarray(jprio), rtol=1e-4, atol=1e-5)
    _assert_trees_close(params_to_flax(pstate.net), _np_tree(jstate.params), "params")
    _assert_trees_close(params_to_flax(pstate.target_net), _np_tree(jstate.target_params),
                        "target")


# --------------------------------------------------------------------------
# config: arm resolution and the model presets
# --------------------------------------------------------------------------

ARM_KNOBS = [
    {},
    {"backward_arm": "default"},
    {"backward_arm": "fused_dwh"},
    {"backward_arm": "ckpt"},
    {"seq_fused_dwh": True},
    {"backward_residual_budget_mb": 8},
    {"backward_residual_budget_mb": 1},
    {"fused_sequence": False, "backward_arm": "ckpt"},
]


def _legacy_ckpt(preset):
    return {"seq_grad_checkpoint": 5 if preset == "atari" else 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", ["tiny_test", "atari"])
def test_backward_arm_resolution_matches_jax(preset, dtype):
    for knobs in ARM_KNOBS + [_legacy_ckpt(preset)]:
        kw = dict(compute_dtype=dtype, **knobs)
        jcfg = jax_config.PRESETS[preset]().replace(**kw)
        cfg = port_config.PRESETS[preset]().replace(**kw)
        # "auto" is the kernels on the card and the plain versions on the
        # CPU, as JAX's is Pallas on a TPU and scan elsewhere
        assert cfg.resolve_backward_arm(device="cpu") == jcfg.resolve_backward_arm(), knobs
        assert cfg.resolve_backward_arm(device="cuda") == (
            jcfg.replace(lstm_backend="pallas").resolve_backward_arm()), knobs
        pallas = dict(kw, lstm_backend="pallas")
        assert port_config.PRESETS[preset]().replace(**pallas).resolve_backward_arm(
            device="cpu") == jax_config.PRESETS[preset]().replace(**pallas).resolve_backward_arm()


def test_model_presets_match_jax_and_xl_resolves_to_ckpt():
    assert port_config.MODEL_PRESETS == jax_config.MODEL_PRESETS
    want = {"base": ("default", 0), "wide": ("default", 0), "xl": ("ckpt", 85),
            "deep": ("default", 0), "deep_wide": ("default", 0)}
    for name in sorted(port_config.MODEL_PRESETS):
        cfg = port_config.apply_model_preset(
            port_config.default_atari().replace(compute_dtype="float32"), name)
        jcfg = jax_config.apply_model_preset(
            jax_config.default_atari().replace(compute_dtype="float32"), name)
        assert (cfg.model_preset, cfg.hidden_dim, cfg.encoder_depth) == (
            jcfg.model_preset, jcfg.hidden_dim, jcfg.encoder_depth)
        got = cfg.resolve_backward_arm(device="cuda")
        assert got == jcfg.replace(lstm_backend="pallas").resolve_backward_arm() == want[name]
        assert cfg.resolve_backward_arm(device="cpu") == ("default", 0)
    # under bf16 xl resolves to stride 5, as in the JAX package
    xl16 = port_config.apply_model_preset(port_config.default_atari(), "xl")
    assert xl16.resolve_backward_arm(device="cuda") == ("ckpt", 5)
    with pytest.raises(ValueError, match="unknown model_preset"):
        port_config.apply_model_preset(port_config.tiny_test(), "huge")
    with pytest.raises(ValueError, match="unknown model_preset"):
        port_config.tiny_test().replace(model_preset="huge")
