"""The port's IMPALA encoder (r2d2_tpu_torch/models/encoders.py) against the
JAX package's flax ImpalaEncoder, with parameters converted by interop.py.

- forward and the gradient of every parameter (and of the input) at
  26x26x1 with channels (8, 16), the long_context preset's, and at 64x64x3
  with (16, 32, 32), to 1e-5 (values) and rtol 1e-4 / atol 1e-4
  (gradients), in float32, with extra latent layers in one case;
- flax's SAME max pool, bit for bit: the total pad split (0, 1) at 26 -> 13,
  (1, 1) at 13 -> 7 (and the other sizes the two stacks meet);
- the interop round trips of a whole IMPALA + LRU network tree, both ways.

The flax encoder is built directly: the JAX package's make_encoder does not
pass impala_channels to ImpalaEncoder, so its networks always run the
default (16, 32, 32) stack.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.models.encoders import ImpalaEncoder as RefImpala
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import (
    encoder_from_flax,
    encoder_to_flax,
    params_from_flax,
    params_to_flax,
)
from r2d2_tpu_torch.models.encoders import ImpalaEncoder, _max_pool_same, same_pool_pads
from r2d2_tpu_torch.models.r2d2 import R2D2Network

torch.set_num_threads(1)

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(obs_shape, channels, latent=32, depth=0, seed=0):
    ref = RefImpala(latent_dim=latent, channels=channels, depth=depth)
    x = np.random.default_rng(seed).uniform(size=(4, *obs_shape)).astype(np.float32)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    port = ImpalaEncoder(obs_shape, latent, channels, depth)
    port.load_state_dict({k[len("enc."):]: v
                          for k, v in encoder_from_flax(params["params"]).items()})
    return ref, params, port, x


@pytest.mark.parametrize("obs_shape,channels,depth", [
    ((26, 26, 1), (8, 16), 0), ((64, 64, 3), (16, 32, 32), 0), ((26, 26, 1), (8, 16), 2)])
def test_forward_and_gradients_match_flax(obs_shape, channels, depth):
    ref, params, port, x = _pair(obs_shape, channels, depth=depth)
    w = np.random.default_rng(1).normal(size=(x.shape[0], 32)).astype(np.float32)

    def jloss(p, xs):
        return jnp.sum(ref.apply(p, xs) * w)

    want = ref.apply(params, jnp.asarray(x))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VALUE_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    grads = encoder_to_flax({f"enc.{n}": p.grad for n, p in port.named_parameters()})
    flat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    ref_flat = jax.tree_util.tree_flatten_with_path(jg["params"])[0]
    assert len(flat) == len(ref_flat) == 4 * len(channels) * 2 + 2 * len(channels) + 2 * (1 + depth)
    for path, v in ref_flat:
        np.testing.assert_allclose(flat[path], np.asarray(v), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)


@pytest.mark.parametrize("size,pads", [(26, (0, 1)), (13, (1, 1)), (64, (0, 1)), (32, (0, 1)),
                                       (16, (0, 1)), (7, (1, 1)), (9, (1, 1))])
def test_same_max_pool_matches_flax(size, pads):
    assert same_pool_pads(size) == pads
    x = np.random.default_rng(size).normal(size=(2, size, size + 1, 3)).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    got = _max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interop_round_trips_an_impala_lru_tree():
    kw = dict(encoder="impala", obs_shape=(26, 26, 1), recurrent_core="lru")
    _, params = jax_init_params(jax.random.PRNGKey(3), jax_tiny_test().replace(**kw))
    params = jax.tree.map(np.asarray, params)
    net = R2D2Network.from_config(tiny_test().replace(**kw), device="cpu")
    net.load_state_dict(params_from_flax(params))  # every name and shape lines up
    back = params_to_flax(net)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(got) == len(want)
    for path, v in want:
        assert got[path].dtype == v.dtype and np.array_equal(got[path], v), path
    sd = net.state_dict()
    again = params_from_flax(back)
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
