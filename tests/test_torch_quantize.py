"""The port's int8 weight quantization (r2d2_tpu_torch/ops/quantize.py)
against the JAX package's (r2d2_tpu/ops/quantize.py), on a network's
parameters converted by interop.params_from_flax: the same leaves
selected, and q8 and scale equal bit for bit after the layout transpose
(flax's output channel is the last axis, the port's axis 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu.ops import quantize as jq
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)

NETS = {
    "mlp": {},
    "impala": dict(encoder="impala", obs_shape=(26, 26, 1)),
    "nature_lru": dict(encoder="nature", obs_shape=(36, 36, 1), recurrent_core="lru"),
}


def _to_port_layout(x: np.ndarray) -> np.ndarray:
    """A flax kernel-shaped array in the port's layout: HWIO -> OIHW,
    (in, out) -> (out, in)."""
    return x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T


def _params(kind, seed=0):
    _, params = jax_init_params(jax.random.PRNGKey(seed), jax_tiny_test().replace(**NETS[kind]))
    params = jax.tree.map(np.array, params)
    # a zero output channel takes scale 1.0 on both sides
    first = params["params"]["adv_out"]["kernel"]
    first[:, 0] = 0.0
    return params


@pytest.mark.parametrize("kind", sorted(NETS))
def test_q8_and_scale_equal_jax_bit_for_bit(kind):
    params = _params(kind)
    jtree, jcount = jq.quantize_tree(params)
    got, count = tq.quantize_tree(params_from_flax(params))
    assert count == jcount > 0
    # flatten JAX's quantized leaves to the port's names through interop
    q8 = params_from_flax(jax.tree.map(
        np.asarray, jax.tree_util.tree_map(lambda leaf: leaf["q8"] if jq._is_qleaf(leaf) else
                                           np.zeros(0), jtree, is_leaf=jq._is_qleaf)))
    scale = params_from_flax(jax.tree.map(
        np.asarray, jax.tree_util.tree_map(lambda leaf: leaf["scale"] if jq._is_qleaf(leaf)
                                           else np.zeros(0), jtree, is_leaf=jq._is_qleaf)))
    quantized = sorted(k for k, v in got.items() if tq.is_qleaf(v))
    assert quantized == sorted(k for k, v in q8.items() if v.numel() > 0)
    assert not any(k.startswith("core.") for k in quantized)
    for k in quantized:
        assert got[k]["q8"].dtype == torch.int8 and got[k]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got[k]["q8"].numpy(), q8[k].numpy(), err_msg=k)
        # the scale: (1, ..., O) in flax, (O, 1, ...) here
        want = scale[k].numpy().reshape(-1)
        np.testing.assert_array_equal(got[k]["scale"].numpy().reshape(-1), want, err_msg=k)
        assert got[k]["scale"].shape == (got[k]["q8"].shape[0],) + (1,) * (got[k]["q8"].dim() - 1)
    # every other leaf passes through untouched
    plain = params_from_flax(params)
    for k, v in got.items():
        if not tq.is_qleaf(v):
            assert v is plain[k] or torch.equal(v, plain[k])


@pytest.mark.parametrize("kind", sorted(NETS))
def test_dequantize_equals_jax(kind):
    params = _params(kind, seed=1)
    jdeq = jax.tree.map(np.asarray, jq.dequantize_tree(jq.quantize_tree(params)[0]))
    got = tq.dequantize_tree(tq.quantize_tree(params_from_flax(params))[0])
    want = params_from_flax(jdeq)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_round_half_to_even_and_clip():
    """Values exactly between two integers after the division round to the
    even one, as jnp.round does; the absmax maps to +-127."""
    w = torch.tensor([[127.0, 0.5, 1.5, 2.5, -2.5, -127.0]])
    q = tq.quantize_tree({"adv_out.weight": w})[0]["adv_out.weight"]
    assert q["scale"].item() == 1.0
    assert q["q8"].tolist() == [[127, 0, 2, 2, -2, -127]]
    jqq = jq._quantize_leaf(jnp.asarray(w.numpy().T))
    np.testing.assert_array_equal(np.asarray(jqq["q8"]).T, q["q8"].numpy())


def test_dequantize_passes_a_float_dict_through():
    sd = {"a.weight": torch.ones(2, 2), "b.bias": torch.zeros(2)}
    out = tq.dequantize_tree(sd)
    assert out.keys() == sd.keys() and all(out[k] is sd[k] for k in sd)
