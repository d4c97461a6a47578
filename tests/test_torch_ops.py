"""The port's small ops (r2d2_tpu_torch/ops) against the JAX package's.

Host numpy twins are compared bit for bit; the torch versions of the device
math (value rescale, priorities) to float32 rounding."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops import epsilon as ref_eps
from r2d2_tpu.ops import priority as ref_prio
from r2d2_tpu.ops import returns as ref_ret
from r2d2_tpu_torch.ops import epsilon, priority, returns, value_rescale

# the reference package's ops/__init__ re-exports functions under the
# module names, so import the module itself
ref_vr = importlib.import_module("r2d2_tpu.ops.value_rescale")

torch.set_num_threads(1)


def _values(seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=64) * 30, [0.0, -0.0, 1e-7, -5e3, 5e3]])
    return x.astype(np.float32)


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_value_rescale_torch_and_numpy(eps):
    x = _values()
    # the inverse's sqrt(1 + 4 eps (|x| + 1 + eps)) - 1 cancels about two
    # digits of float32 at small eps, and the square doubles the rest
    for port, ref, rtol in (
        (value_rescale.value_rescale, ref_vr.value_rescale, 1e-6),
        (value_rescale.inverse_value_rescale, ref_vr.inverse_value_rescale, 1e-4),
    ):
        np.testing.assert_allclose(port(torch.from_numpy(x), eps).numpy(),
                                   np.asarray(ref(jnp.asarray(x), eps)), rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(value_rescale.value_rescale_np(x, eps),
                                  ref_vr.value_rescale_np(x, eps))
    np.testing.assert_array_equal(value_rescale.inverse_value_rescale_np(x, eps),
                                  ref_vr.inverse_value_rescale_np(x, eps))
    round_trip = value_rescale.inverse_value_rescale(
        value_rescale.value_rescale(torch.from_numpy(x).double(), eps), eps)
    np.testing.assert_allclose(round_trip.numpy(), x, rtol=1e-6, atol=1e-6)


def test_mixed_td_priorities_torch_and_numpy():
    rng = np.random.default_rng(1)
    abs_td = np.abs(rng.normal(size=(6, 5))).astype(np.float32)
    mask = (rng.random((6, 5)) < 0.7).astype(np.float32)
    mask[2] = 0.0  # an empty row gives 0
    port = priority.mixed_td_priorities(torch.from_numpy(abs_td), torch.from_numpy(mask), 0.9)
    ref = ref_prio.mixed_td_priorities(jnp.asarray(abs_td), jnp.asarray(mask), 0.9)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6)
    assert port[2] == 0.0 and port.dtype == torch.float32
    np.testing.assert_array_equal(priority.mixed_td_priorities_np(abs_td, mask, 0.9),
                                  ref_prio.mixed_td_priorities_np(abs_td, mask, 0.9))


@pytest.mark.parametrize("size,n,done", [(1, 5, True), (3, 5, False), (40, 5, False),
                                         (40, 5, True), (7, 1, False)])
def test_n_step_returns_and_gammas_bitwise(size, n, done):
    r = np.random.default_rng(size).choice([0.0, 1.0, -1.0, 0.25], size=size)
    np.testing.assert_array_equal(returns.n_step_returns(r, 0.997, n),
                                  ref_ret.n_step_returns(r, 0.997, n))
    np.testing.assert_array_equal(returns.n_step_gammas(size, 0.997, n, done),
                                  ref_ret.n_step_gammas(size, 0.997, n, done))


@pytest.mark.parametrize("n", [1, 2, 8, 256])
def test_epsilon_ladder_bitwise(n):
    np.testing.assert_array_equal(epsilon.epsilon_ladder(n, 0.4, 7.0),
                                  ref_eps.epsilon_ladder(n, 0.4, 7.0))
