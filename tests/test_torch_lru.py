"""The port's LRU core (r2d2_tpu_torch/models/lru.py) against the JAX
package's flax LRU, with the flax parameters carried across by name (the
LRU's parameters keep their names and shapes in interop.py).

- the scan unroll from a nonzero carry: outputs and final carry to 1e-5
  abs + 1e-5 rel (tests/test_lru.py's tolerance), at even and odd T;
- `step`, step by step, equals the unroll;
- the chunked form at C in {4, 5, 12, 16} (5 and 16 through the zero-pad
  path) against JAX's chunked form at rtol 2e-4 / atol 2e-5
  (tests/test_lru.py:85);
- the gradient of every parameter, the input and the carry against
  jax.grad to rtol 1e-4 / atol 1e-4, in both forms;
- bf16 compute against JAX's bf16 to 2e-2 abs + 2e-2 rel (both round the
  projections and the readout to bf16 in other orders);
- the ring init keeps |lambda| in [r_min, r_max].
Float32 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.models.lru import LRU as RefLRU
from r2d2_tpu_torch.models.lru import LRU, associative_scan

torch.set_num_threads(1)

B, D, H = 3, 5, 8
TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _setup(T, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    carry = tuple((rng.normal(size=(B, H)) * 0.3).astype(np.float32) for _ in range(2))
    params = RefLRU(hidden_dim=H, in_dim=D).init(jax.random.PRNGKey(seed + 1), jnp.asarray(xs),
                                                 tuple(map(jnp.asarray, carry)))
    return xs, carry, jax.tree.map(np.asarray, params)


def _port(params, chunk=0, dtype=torch.float32):
    m = LRU(H, D, dtype=dtype, chunk=chunk)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params["params"].items()})
    return m


def _ref(params, xs, carry, chunk=0, dtype=jnp.float32):
    return RefLRU(hidden_dim=H, in_dim=D, chunk=chunk, dtype=dtype).apply(
        params, jnp.asarray(xs), tuple(map(jnp.asarray, carry)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("T", [12, 13, 67])
def test_scan_unroll_matches_jax(T):
    xs, carry, params = _setup(T)
    want, (wr, wi) = _ref(params, xs, carry)
    with torch.no_grad():
        got, (gr, gi) = _port(params)(*_t(xs), tuple(_t(*carry)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **TOL)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **TOL)


def test_step_equals_the_unroll():
    xs, carry, params = _setup(12)
    m = _port(params)
    with torch.no_grad():
        outs, final = m(*_t(xs), tuple(_t(*carry)))
        c = tuple(_t(*carry))
        steps = []
        for t in range(xs.shape[1]):
            o, c = m.step(torch.from_numpy(xs[:, t]), c)
            steps.append(o)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), outs.numpy(), **TOL)
    for a, b in zip(c, final):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_associative_scan_equals_the_sequential_recurrence():
    """The scan alone against a for loop over T (the oracle), lambda's part
    broadcast from (1, T, H) as the unroll passes it."""
    g = torch.Generator().manual_seed(0)
    T = 29
    a = [torch.rand(1, T, H, generator=g) * 0.9 for _ in range(2)]
    b = [torch.randn(B, T, H, generator=g) for _ in range(2)]
    Ar, Ai, Br, Bi = associative_scan((*a, *b), dim=1)
    hr, hi = torch.zeros(B, H), torch.zeros(B, H)
    pr, pi = torch.ones(1, H), torch.zeros(1, H)
    for t in range(T):
        ar, ai = a[0][:, t], a[1][:, t]
        hr, hi = ar * hr - ai * hi + b[0][:, t], ar * hi + ai * hr + b[1][:, t]
        pr, pi = ar * pr - ai * pi, ar * pi + ai * pr
        np.testing.assert_allclose(Br[:, t].numpy(), hr.numpy(), **TOL)
        np.testing.assert_allclose(Bi[:, t].numpy(), hi.numpy(), **TOL)
        np.testing.assert_allclose(Ar[:, t].numpy(), pr.numpy(), **TOL)
        np.testing.assert_allclose(Ai[:, t].numpy(), pi.numpy(), **TOL)


@pytest.mark.parametrize("C", [4, 5, 12, 16])
def test_chunked_unroll_matches_jax(C):
    xs, carry, params = _setup(12)
    want, (wr, wi) = _ref(params, xs, carry, chunk=C)
    with torch.no_grad():
        got, (gr, gi) = _port(params, chunk=C)(*_t(xs), tuple(_t(*carry)))
        scan, _ = _port(params)(*_t(xs), tuple(_t(*carry)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHUNK_TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **CHUNK_TOL)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **CHUNK_TOL)
    np.testing.assert_allclose(got.numpy(), scan.numpy(), **CHUNK_TOL)


@pytest.mark.parametrize("C", [0, 5])
def test_gradients_match_jax(C):
    T = 12
    xs, carry, params = _setup(T, seed=3)
    rng = np.random.default_rng(9)
    w_out = rng.normal(size=(B, T, H)).astype(np.float32)
    w_c = rng.normal(size=(2, B, H)).astype(np.float32)

    def jloss(p, x, c):
        outs, (cr, ci) = RefLRU(hidden_dim=H, in_dim=D, chunk=C).apply(p, x, c)
        return jnp.sum(outs * w_out) + jnp.sum(cr * w_c[0]) + jnp.sum(ci * w_c[1])

    jg, jgx, jgc = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(xs), tuple(map(jnp.asarray, carry)))
    m = _port(params, chunk=C)
    x = torch.from_numpy(xs).requires_grad_(True)
    c = tuple(t.requires_grad_(True) for t in _t(*carry))
    outs, (cr, ci) = m(x, c)
    loss = (outs * torch.from_numpy(w_out)).sum() + (cr * torch.from_numpy(w_c[0])).sum() + (
        ci * torch.from_numpy(w_c[1])).sum()
    loss.backward()
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg["params"][name]), **GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for got, want in zip(c, jgc):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("C", [0, 4])
def test_bf16_compute_matches_jax_bf16(C):
    xs, carry, params = _setup(12, seed=5)
    want, (wr, wi) = _ref(params, xs, carry, chunk=C, dtype=jnp.bfloat16)
    with torch.no_grad():
        got, (gr, gi) = _port(params, chunk=C, dtype=torch.bfloat16)(*_t(xs), tuple(_t(*carry)))
    assert got.dtype == torch.bfloat16 and gr.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **BF16_TOL)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **BF16_TOL)


@pytest.mark.parametrize("r_min,r_max", [(0.9, 0.999), (0.98, 0.9999)])
def test_ring_init_keeps_lambda_in_the_ring(r_min, r_max):
    m = LRU(256, D, r_min=r_min, r_max=r_max, generator=torch.Generator().manual_seed(0))
    mod, theta = (v.detach() for v in m._polar())
    assert (mod >= r_min * (1 - 1e-6)).all() and (mod <= r_max * (1 + 1e-6)).all()
    assert (mod < 1).all() and (theta > 0).all() and (theta <= 6.283 * (1 + 1e-6)).all()
    # spread over the ring, not piled at one end
    assert mod.min() < r_min + 0.2 * (r_max - r_min) and mod.max() > r_max - 0.2 * (r_max - r_min)
