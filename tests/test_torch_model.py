"""The port's R2D2Network (r2d2_tpu_torch/models) against the flax network of
the JAX package, on parameters converted with r2d2_tpu_torch.interop.

Covers `act`, `act_select`, `unroll` (learning view, bootstrap view, mask)
and parameter gradients, for the mlp encoder (also with extra latent layers)
and the nature encoder, with the burn-in seam (fused_sequence=True, the
default) and without it. The nature encoder runs at 36x36 (the smallest
frame its trunk takes; 1x1 spatial) and at 44x44, whose 2x2x64 conv output
pins the NHWC flatten order before Dense_0. Float32 throughout; values to
1e-5, gradients to rtol 1e-4 / atol 1e-5 (tests/test_pallas_lstm.py's
tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu.ops.act_tail import epsilon_greedy_actions as jax_eps_greedy
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.models.r2d2 import R2D2Network, init_params
from r2d2_tpu_torch.ops.act_tail import epsilon_greedy_actions

torch.set_num_threads(1)

VARIANTS = {
    "mlp": dict(),
    "mlp_deep": dict(encoder_depth=2),  # Dense_1, Dense_2 after the latent
    "nature36": dict(encoder="nature", obs_shape=(36, 36, 1)),
    "nature44": dict(encoder="nature", obs_shape=(44, 44, 1)),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _build(variant, seed=0, **extra):
    kw = {**VARIANTS[variant], **extra}
    jcfg = jax_tiny_test().replace(**kw)
    net, params = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    tnet = R2D2Network.from_config(tiny_test().replace(**kw), device="cpu")
    tnet.load_state_dict(params_from_flax(_np_tree(params)))
    return jcfg, net, params, tnet


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    Bn, T, L = 6, cfg.seq_len, cfg.learning_steps
    burn = np.array([0, 1, 4, 4, 2, 3], np.int32)
    learn = np.array([4, 4, 3, 4, 1, 2], np.int32)
    fwd = np.minimum(T - burn - learn, cfg.forward_steps).astype(np.int32)
    return dict(
        obs=rng.integers(0, 256, size=(Bn, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=(Bn, T)).astype(np.int32),
        last_reward=rng.normal(size=(Bn, T)).astype(np.float32),
        hidden=(rng.normal(size=(Bn, 2, cfg.hidden_dim)) * 0.5).astype(np.float32),
        burn_in=burn, learning=learn, forward=fwd,
    )


def _port_args(b):
    return [torch.from_numpy(b[k]) for k in
            ("obs", "last_action", "last_reward", "hidden", "burn_in", "learning", "forward")]


def _jax_args(b):
    return [jnp.asarray(b[k]) for k in
            ("obs", "last_action", "last_reward", "hidden", "burn_in", "learning", "forward")]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_act_and_act_select_match_flax(variant):
    cfg, net, params, tnet = _build(variant)
    rng = np.random.default_rng(1)
    E = 5
    obs = rng.integers(0, 256, size=(E, *cfg.obs_shape), dtype=np.uint8)
    la = rng.integers(0, cfg.action_dim, size=E).astype(np.int32)
    lr = rng.normal(size=E).astype(np.float32)
    h, c = (rng.normal(size=(2, E, cfg.hidden_dim)) * 0.5).astype(np.float32)
    explore = np.array([True, False, False, True, False])
    rand_a = rng.integers(0, cfg.action_dim, size=E).astype(np.int32)

    jq, ja, (jh, jc) = net.apply(
        params, jnp.asarray(obs), jnp.asarray(la), jnp.asarray(lr),
        (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(explore), jnp.asarray(rand_a),
        method=net.act_select,
    )
    with torch.no_grad():
        tq, ta, (th, tc) = tnet.act_select(
            torch.from_numpy(obs), torch.from_numpy(la), torch.from_numpy(lr),
            (torch.from_numpy(h), torch.from_numpy(c)),
            torch.from_numpy(explore), torch.from_numpy(rand_a),
        )
        aq, (ah, ac) = tnet.act(torch.from_numpy(obs), torch.from_numpy(la),
                                torch.from_numpy(lr), (torch.from_numpy(h), torch.from_numpy(c)))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(aq.numpy(), tq.numpy())
    np.testing.assert_array_equal(ah.numpy(), th.numpy())


def test_act_tail_takes_the_first_maximum_on_ties():
    q = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.0, -1.0, 5.0, 5.0],
                  [7.0, 1.0, 7.0, 7.0]], np.float32)
    explore = np.array([False, False, False, True])
    rand_a = np.array([0, 1, 2, 3], np.int32)
    port = epsilon_greedy_actions(torch.from_numpy(q), torch.from_numpy(explore),
                                  torch.from_numpy(rand_a))
    ref = jax_eps_greedy(jnp.asarray(q), jnp.asarray(explore), jnp.asarray(rand_a))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(port.numpy(), [1, 0, 2, 3])


def _unroll_and_grads_jax(net, params, b, ct_learn, ct_boot):
    args = _jax_args(b)

    def loss(p):
        ql, qb, _ = net.apply(p, *args)
        return jnp.sum(ql * ct_learn) + jnp.sum(qb * ct_boot)

    ql, qb, mask = net.apply(params, *args)
    return (np.asarray(ql), np.asarray(qb), np.asarray(mask)), _np_tree(jax.grad(loss)(params))


def _unroll_and_grads_port(tnet, b, ct_learn, ct_boot):
    tnet.zero_grad(set_to_none=True)
    ql, qb, mask = tnet.unroll(*_port_args(b))
    (torch.sum(ql * torch.from_numpy(ct_learn)) + torch.sum(qb * torch.from_numpy(ct_boot))).backward()
    grads = {k: p.grad for k, p in tnet.named_parameters()}
    return (ql.detach().numpy(), qb.detach().numpy(), mask.numpy()), params_to_flax(grads)


@pytest.mark.parametrize("fused_sequence", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unroll_views_and_gradients_match_flax(variant, fused_sequence):
    cfg, net, params, tnet = _build(variant, seed=2, fused_sequence=fused_sequence)
    b = _batch(cfg, seed=3)
    rng = np.random.default_rng(4)
    shape = (len(b["burn_in"]), cfg.learning_steps, cfg.action_dim)
    ct_learn = rng.normal(size=shape).astype(np.float32)
    ct_boot = rng.normal(size=shape).astype(np.float32)
    (jl, jb, jm), jg = _unroll_and_grads_jax(net, params, b, ct_learn, ct_boot)
    (tl, tb, tm), tg = _unroll_and_grads_port(tnet, b, ct_learn, ct_boot)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tm, jm)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tg)[0])
    assert len(flat_j) == len(flat_t)
    for path, g in flat_j:
        np.testing.assert_allclose(flat_t[path], g, rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_seam_changes_gradients_but_not_values():
    """With burn-in > 0 the seam must matter (else the seam test above
    would pass vacuously against a seamless port)."""
    _, _, _, seam = _build("mlp", seed=5)
    _, _, _, full = _build("mlp", seed=5, fused_sequence=False)
    cfg = tiny_test()
    b = _batch(cfg, seed=6)
    rng = np.random.default_rng(7)
    shape = (len(b["burn_in"]), cfg.learning_steps, cfg.action_dim)
    cts = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    (sl, _, _), sg = _unroll_and_grads_port(seam, b, *cts)
    (fl, _, _), fg = _unroll_and_grads_port(full, b, *cts)
    np.testing.assert_array_equal(sl, fl)
    assert not np.allclose(sg["params"]["core"]["wh"], fg["params"]["core"]["wh"])


def test_nchw_flatten_would_not_match():
    """The 44x44 trunk ends at 2x2x64: flattening NCHW instead of NHWC feeds
    Dense_0 a permuted vector and changes the latent."""
    _, _, _, tnet = _build("nature44")
    x = torch.from_numpy(np.random.default_rng(8).random((3, 44, 44, 1)).astype(np.float32))
    enc = tnet.enc
    y = x.permute(0, 3, 1, 2)
    for layer in enc.convs:
        y = torch.relu(layer(y))
    assert y.shape[2:] == (2, 2)
    nchw = enc.tail(y.reshape(3, -1))
    np.testing.assert_array_equal(enc(x).detach().numpy(),
                                  enc.tail(y.permute(0, 2, 3, 1).reshape(3, -1)).detach().numpy())
    assert not torch.allclose(enc(x), nchw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flax_torch_flax_round_trip_is_bitwise(variant):
    _, _, params, tnet = _build(variant, seed=9)
    tree = _np_tree(params)
    back = params_to_flax(params_from_flax(tree))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b) or a.dtype == b.dtype, tree, back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    back_from_module = params_to_flax(tnet)
    jax.tree.map(np.testing.assert_array_equal, tree, back_from_module)


def test_port_init_draws_flax_shapes_from_a_seed():
    cfg = tiny_test().replace(encoder="nature", obs_shape=(36, 36, 1))
    a, b = (init_params(cfg, seed=3, device="cpu") for _ in range(2))
    for (k, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), k
    _, _, params, _ = _build("nature36")
    shapes = jax.tree.map(np.shape, _np_tree(params))
    assert jax.tree.map(np.shape, params_to_flax(a)) == shapes


@pytest.mark.parametrize("dtype,H", [(torch.float32, 30), (torch.bfloat16, 36)])
@pytest.mark.parametrize("arm", [("default", 0), ("fused_dwh", 0), ("ckpt", 2), None])
def test_zero_padded_unroll_matches_the_unpadded_one(dtype, H, arm, monkeypatch):
    """The core padded with zero units (what the card runs at an H off the
    kernels' row multiple, here forced on the CPU) gives the unpadded
    unroll's outputs, final carry and parameter gradients to 1e-6: a zero
    unit stays zero and adds only zero products. `arm` None is the unroll
    with no seam."""
    from r2d2_tpu_torch.models.lstm import LSTM

    core = LSTM(H, 11, generator=torch.Generator().manual_seed(1),
                backward_arm=arm or ("default", 0), dtype=dtype)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 6, 11, generator=g)
    carry = (torch.randn(3, H, generator=g) * 0.3, torch.randn(3, H, generator=g) * 0.3)
    burn = None if arm is None else torch.tensor([0, 2, 5])
    assert core.padded_units("cpu") == H
    runs = []
    for Hp in (H, -(-H // 8) * 8):
        monkeypatch.setattr(LSTM, "padded_units", lambda self, device, Hp=Hp: Hp)
        core.zero_grad()
        outs, (hT, cT) = core(x, carry, burn)
        assert outs.shape == (3, 6, H) and hT.shape == cT.shape == (3, H)
        (outs.float().square().mean() + hT.float().mean() + cT.float().mean()).backward()
        runs.append([outs.detach(), hT.detach(), cT.detach(),
                     *(p.grad.clone() for p in (core.wi, core.wh, core.b))])
    for a, b in zip(*runs):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-6, atol=1e-6)
