"""The port's IMPALA encoder in bfloat16 (r2d2_tpu_torch/models/encoders.py)
against the JAX package's flax ImpalaEncoder(dtype=jnp.bfloat16), with the
parameters converted by interop.encoder_from_flax: at 26x26x1 with channels
(8, 16) and at 64x64x3 with (16, 32, 32), forward and gradients, with the
biases flax initializes (zero) and with trained-like biases.

Where the two sides round. flax's Conv(dtype=bf16) and Dense(dtype=bf16)
cast inputs and kernel to bf16, take the product with float32 sums and
round it to bf16, then add the bias and round again (flax's ``y = dot(x,
w); y += b``). The port did the same for the inputs and the kernel, but it
handed the bias to F.conv2d / F.linear, which on the CPU (oneDNN) add it
inside the sum and round once. That was a port-side cause: on one layer
with non-zero biases, about 31% of the outputs differed from flax's by a
unit of the last place. The port now rounds the product and adds the bias
after it (encoders._conv, _linear), and on one layer it differs from flax
only where the two float32 sums straddle a rounding boundary
(test_bias_rounds_after_the_product). Relu, the SAME max pool (with the
same tie-break, the first maximum) and the residual adds (one bf16
rounding each) are in the same order on both sides. On the card cuDNN adds
the bias after the convolution, as flax does, so the card and the CPU now
round at the same points too.

The bound (forward). Both sides start from the same bf16 input. Element
by element a bound E on their difference is carried layer by layer
(rounding_bound.impala_rounding_bound):
- a product (each of the 15 convolutions, fan-in n = 9 C_in, and the
  Dense) moves by the input's E through the weights, taken in quadrature,
  sqrt(E^2 * W^2): the differences come from independent roundings of
  either sign (the worst case, |W| * E, grows by about 0.8 sqrt(n) a
  convolution and passes 1e23 in these stacks); each side's float32 sum
  lies within gamma_n of the exact one, gamma_n = n 2^-24 / (1 - n 2^-24)
  times the products' magnitude: the accumulation's growth with its
  fan-in;
- each rounding point either side takes (the products, the bias adds, the
  6 residual adds) costs nothing where no bf16 rounding boundary lies
  within the values' reach (both round to the same value), and the reach
  plus one bf16 unit of the last place (2^-7 relative, two halves of u =
  2^-8) where one does (rounding_bound.rounding_gap);
- a max pool passes on max(E at the max m, max_j (a_j + E_j) - m) over its
  window, a relu the largest move of its output (pool_gap, relu_gap); the
  residual add takes both branches' E before it rounds.
The measured differences are at most a few percent of it.

The bound (backward), from the forward's values and E, with the
cotangents rounded where the backward rounds them:
- a relu whose input may have the other sign on the other side may pass
  the cotangent on one side only: its bound there is |g| + E_g;
- a max pool window whose max another candidate can reach may route its
  cotangent to either: every such candidate's bound gets |g| + E_g; the
  two to four windows that can meet at an element add in bf16, one unit
  per add;
- a product's input cotangent and its kernel gradient (N x H x W terms)
  as in the forward, both factors' bounds carried, each rounding point
  boundary-aware; the two cotangent branches of a residual add round once.
The walk stands for a third implementation rounding at the same points;
the port and flax each lie within its bound, so they are held to twice
it. It holds, but at 64x64 the relu and max pool decisions the forward's
bound leaves open put it above the gradients' own size. So the
gradients are also held layer by layer (test_bf16_layer_gradients_match
_flax): given flax's own input to each layer and flax's own cotangent at
its output, the two sides sum the same bf16 products, and the bound is a
single rounding point's, without quadrature.

flax's bias gradients on the CPU are sums of the bf16 cotangent in bf16
(XLA's CPU reduction of a bf16 array), 5-10% of their norm off the exact
sum; the port sums in float32 and rounds once. So the port's bias
gradients are held against the float64 sum of flax's own cotangent, which
a zero added to every Conv and Dense output (flax's intercept_methods)
captures without changing a value.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from r2d2_tpu.models.encoders import ImpalaEncoder as RefImpala
from r2d2_tpu_torch.interop import encoder_from_flax, encoder_to_flax
from r2d2_tpu_torch.models.encoders import ImpalaEncoder, _conv, _linear, same_pool_pads
from r2d2_tpu_torch.models.rounding_bound import (
    _f32_sum_error,
    _spacing,
    impala_rounding_bound,
    relu_gap,
    rounding_gap,
    unit_roundoff,
)

torch.set_num_threads(1)

U = unit_roundoff(torch.bfloat16)
LATENT = 32
CASES = [((26, 26, 1), (8, 16)), ((64, 64, 3), (16, 32, 32))]
BIASES = {"init": 0.0, "trained": 0.1}


def _pair(obs_shape, channels, bias_scale, seed=0):
    ref = RefImpala(latent_dim=LATENT, channels=channels, dtype=jnp.bfloat16)
    x = np.random.default_rng(seed).uniform(size=(4, *obs_shape)).astype(np.float32)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    rng = np.random.default_rng(seed + 5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + bias_scale * rng.normal(size=v.shape)).astype(np.float32)
        if "bias" in jax.tree_util.keystr(p) else v, params)
    port = ImpalaEncoder(obs_shape, LATENT, channels, dtype=torch.bfloat16)
    port.load_state_dict({k[len("enc."):]: v
                          for k, v in encoder_from_flax(params["params"]).items()})
    w = np.random.default_rng(seed + 1).normal(size=(x.shape[0], LATENT)).astype(np.float32)
    return ref, params, port, x, w


def _flax_side(ref, params, x, w):
    """flax's output, parameter gradients, input gradient, and the
    cotangent of every Conv and Dense output (a zero probe added to each
    output: the gradient with respect to it) and its input, in call
    order."""

    def apply(p, xs, probes):
        k = iter(range(len(probes) if probes is not None else 10 ** 6))

        def icpt(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if (isinstance(context.module, (fnn.Conv, fnn.Dense))
                    and context.method_name == "__call__"):
                i = next(k)
                if probes is None:
                    shapes.append(y.shape)
                    inputs.append(np.asarray(jnp.asarray(args[0]).astype(jnp.float32)))
                else:
                    y = y + probes[i].astype(y.dtype)
            return y

        with fnn.intercept_methods(icpt):
            return ref.apply(p, xs)

    shapes, inputs = [], []
    out = apply(params, jnp.asarray(x), None)
    probes = [jnp.zeros(s, jnp.bfloat16) for s in shapes]

    def loss(p, xs, pr):
        return jnp.sum(apply(p, xs, pr).astype(jnp.float32) * w)

    gp, gx, gpr = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(x), probes)
    cot = [np.asarray(g.astype(jnp.float32)) for g in gpr]
    return (np.asarray(out.astype(jnp.float32)), gp["params"], np.asarray(gx), cot, inputs)


def _port_side(port, x, w):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out.float() * torch.from_numpy(w)).sum().backward()
    grads = encoder_to_flax({f"enc.{n}": p.grad.float() for n, p in port.named_parameters()})
    return out.detach().float().numpy(), grads, xt.grad.numpy()


def _relu_back(g, eg, pre, e_pre):
    """A relu's backward: where the other side's input may have the other
    sign, the cotangent may pass on one side only."""
    pre = pre.float()
    amb = (e_pre > 0) & (pre - e_pre <= 0) & (pre + e_pre > 0)
    keep = (pre > 0).float()
    return g * keep, torch.where(amb, g.abs() + eg, keep * eg)


def _pool_back(g, eg, z, ez):
    """The SAME 3x3/2 max pool's backward and its bound: a window whose max
    another candidate may reach routes its cotangent to either; elements
    that two to four windows may route to sum their cotangents in bf16."""
    B, C, H, W = z.shape
    (top, bottom), (left, right) = (same_pool_pads(n) for n in (H, W))
    size = (H + top + bottom, W + left + right)
    cols = F.unfold(F.pad(z.float(), (left, right, top, bottom), value=float("-inf")), 3,
                    stride=2).reshape(B, C, 9, -1)
    ecols = F.unfold(F.pad(ez, (left, right, top, bottom)), 3, stride=2).reshape(B, C, 9, -1)
    m, idx = cols.max(dim=2, keepdim=True)
    e_m = ecols.gather(2, idx)
    top1 = torch.zeros_like(cols).scatter_(2, idx, 1.0)
    cand = (top1 > 0) | ((cols + ecols >= m - e_m) & (ecols + e_m > 0))
    amb = cand.sum(dim=2, keepdim=True) > 1
    gw, egw = g.reshape(B, C, 1, -1), eg.reshape(B, C, 1, -1)
    err = torch.where(amb & cand, gw.abs() + egw, top1 * egw)

    def fold(t):
        out = F.fold(t.reshape(B, C * 9, -1), size, 3, stride=2)
        return out[:, :, top:top + H, left:left + W]

    gx, count = fold(top1 * gw), fold(cand.float())
    reach = fold(cand * (gw.abs() + egw))
    extra = torch.where(count > 1, (count - 1) * _spacing(reach, torch.bfloat16),
                        torch.zeros_like(reach))
    return gx.to(torch.bfloat16).float(), fold(err) + extra


def _product_back(g, eg, x, ex, wt, fn_x, fn_w, n_x, n_w):
    """Input and weight cotangents of a product, rounded to bf16, with their
    bounds: the other side's cotangent within eg of g, its input within ex
    of x, every float32 sum within gamma of the exact one."""
    w2 = wt.square()
    gx = fn_x(g, wt)
    d = fn_x(eg.square(), w2).sqrt() * (1 + _f32_sum_error(n_x)) + 3 * _f32_sum_error(
        n_x) * fn_x(g.square(), w2).sqrt()
    egx = rounding_gap(gx, d, torch.bfloat16)
    gw = fn_w(x, g)
    reach = (fn_w(x.square(), eg.square()) + fn_w(ex.square(), g.square())
             + fn_w(ex.square(), eg.square())).sqrt()
    d = reach * (1 + _f32_sum_error(n_w)) + 3 * _f32_sum_error(n_w) * fn_w(
        x.square(), g.square()).sqrt()
    egw = rounding_gap(gw, d, torch.bfloat16)
    return gx.to(torch.bfloat16).float(), egx, egw


def _bias_back(g, eg, dims, n):
    """The port's bias gradient (its float32 sum, rounded once) against the
    exact sum of the other side's cotangent."""
    gb = g.sum(dims)
    d = eg.square().sum(dims).sqrt() + 2 * _f32_sum_error(n) * g.square().sum(dims).sqrt()
    return d + _spacing(gb.abs() + d, torch.bfloat16)


def _conv_back(g, eg, x, ex, layer):
    wt = layer.weight.to(torch.bfloat16).float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    gx, egx, egw = _product_back(
        g, eg, x.float(), ex, wt, lambda a, w: F.conv_transpose2d(a, w, padding=1),
        lambda a, b: torch.nn.grad.conv2d_weight(a, wt.shape, b, padding=1),
        wt.shape[0] * 9, n)
    return gx, egx, egw, _bias_back(g, eg, (0, 2, 3), n)


def _dense_back(g, eg, x, ex, layer):
    wt = layer.weight.to(torch.bfloat16).float()
    gx, egx, egw = _product_back(g, eg, x.float(), ex, wt, lambda a, w: a @ w,
                                 lambda a, b: b.T @ a, wt.shape[0], x.shape[0])
    return gx, egx, egw, _bias_back(g, eg, 0, x.shape[0])


@torch.no_grad()
def _gradient_bounds(port, x, w):
    """The backward's bound (module docstring), walked from the forward's
    trace with cotangents rounded where the port's backward rounds them:
    {port parameter name: bound} and the input gradient's bound, NHWC.
    The walk stands for a third implementation that rounds at the same
    points; the port and flax each lie within the bound of it."""
    trace = []
    impala_rounding_bound(port, torch.from_numpy(x), trace)
    *stages, tail = trace
    bounds = {}
    g = torch.from_numpy(w).to(torch.bfloat16).float()
    eg = torch.zeros_like(g)
    names = {id(m): n for n, m in port.named_modules()}

    def keep(layer, ew, eb):
        bounds[f"{names[id(layer)]}.weight"], bounds[f"{names[id(layer)]}.bias"] = ew, eb

    for rec in reversed(tail["layers"]):
        g, eg = _relu_back(g, eg, rec["z"], rec["e_z"])
        g, eg, ew, eb = _dense_back(g, eg, rec["x"], rec["e_x"], rec["layer"])
        keep(rec["layer"], ew, eb)
    pre = tail["pre"]
    nhwc = (pre.shape[0], pre.shape[2], pre.shape[3], pre.shape[1])
    g, eg = (t.reshape(nhwc).permute(0, 3, 1, 2) for t in (g, eg))
    g, eg = _relu_back(g, eg, pre, tail["e_pre"])
    for stage in reversed(stages):
        for rec in reversed(stage["blocks"]):
            c0, c1 = rec["block"].convs
            gb, egb, ew, eb = _conv_back(g, eg, F.relu(rec["a"]), relu_gap(rec["a"], rec["e_a"]),
                                         c1)
            keep(c1, ew, eb)
            gb, egb = _relu_back(gb, egb, rec["a"], rec["e_a"])
            gb, egb, ew, eb = _conv_back(gb, egb, F.relu(rec["x"]),
                                         relu_gap(rec["x"], rec["e_x"]), c0)
            keep(c0, ew, eb)
            gb, egb = _relu_back(gb, egb, rec["x"], rec["e_x"])
            s = g + gb
            g, eg = s.to(torch.bfloat16).float(), rounding_gap(s, eg + egb, torch.bfloat16)
        g, eg = _pool_back(g, eg, stage["z"], stage["e_z"])
        g, eg, ew, eb = _conv_back(g, eg, stage["x"], stage["e_x"], stage["layer"])
        keep(stage["layer"], ew, eb)
    return {k: 2 * v for k, v in bounds.items()}, 2 * eg.permute(0, 2, 3, 1)


def _call_order(channels):
    """The flax paths of the Conv and Dense layers in call order: each
    stage's Conv, its two blocks' two Convs, then Dense_0."""
    order = []
    for i in range(len(channels)):
        order.append((f"Conv_{i}",))
        order += [(f"ResidualBlock_{2 * i + j}", f"Conv_{k}") for j in (0, 1) for k in (0, 1)]
    return order + [("Dense_0",)]


def _port_layers(port):
    """The port's Conv and Dense layers in the same call order."""
    layers = []
    for i, conv in enumerate(port.convs):
        layers.append(conv)
        layers += [c for blk in port.blocks[2 * i:2 * i + 2] for c in blk.convs]
    return layers + [port.tail.dense[0]]


def _within(label, got, want, bound):
    got, want, bound = (np.asarray(t, np.float64) for t in (got, want, bound))
    diff = np.abs(got - want)
    assert (diff <= bound).all(), (
        f"{label}: {int((diff > bound).sum())} of {diff.size} outside the derived bound, "
        f"max |diff| {diff.max():.3e}, worst diff/bound {(diff / bound).max():.3f}")
    return float(diff.max()), float((diff / np.maximum(bound, 1e-30)).max())


@pytest.mark.parametrize("bias", sorted(BIASES))
@pytest.mark.parametrize("obs_shape,channels", CASES)
def test_bf16_forward_within_the_derived_bound(obs_shape, channels, bias):
    ref, params, port, x, w = _pair(obs_shape, channels, BIASES[bias])
    want = np.asarray(ref.apply(params, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    out, bound = impala_rounding_bound(port, torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), got)  # the bound's forward is the encoder's
    _within("forward", got, want, bound.numpy())


@pytest.mark.parametrize("bias", sorted(BIASES))
@pytest.mark.parametrize("obs_shape,channels", CASES)
def test_bf16_gradients_within_the_derived_bound(obs_shape, channels, bias):
    ref, params, port, x, w = _pair(obs_shape, channels, BIASES[bias])
    _, jgrads, jgx, cot, _ = _flax_side(ref, params, x, w)
    _, grads, gx = _port_side(port, x, w)
    bounds, ex = _gradient_bounds(port, x, w)
    flat_bounds = dict(jax.tree_util.tree_flatten_with_path(
        encoder_to_flax({f"enc.{n}": b for n, b in bounds.items()}))[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    ref_flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(ref_flat) == 10 * len(channels) + 2
    # the cotangent sums flax's bias gradients stand for
    order = _call_order(channels)
    assert len(order) == len(cot)
    bias_ref = {path: c.astype(np.float64).sum(axis=tuple(range(c.ndim - 1)))
                for path, c in zip(order, cot)}
    for path, v in ref_flat:
        keys = tuple(p.key for p in path)
        want = bias_ref[keys[:-1]] if keys[-1] == "bias" else np.asarray(v)
        _within(jax.tree_util.keystr(path), flat[path], want, flat_bounds[path])
    _within("input gradient", gx, jgx, ex.numpy())


@pytest.mark.parametrize("channels_in", [1, 3, 16, 32])
def test_bias_rounds_after_the_product(channels_in):
    """One Conv with non-zero biases: the port's output may differ from
    flax's only where the two float32 sums of the product straddle a bf16
    rounding boundary. Two sums at most 2 gamma_n sum |w x| = D apart
    straddle at most with chance D / ulp, each side's value lying anywhere
    within its ulp: the count stays under sum(min(1, D / ulp)). A bias added
    inside the sum and rounded once (F.conv2d's own bias) exceeds that
    count: about 31% of the outputs differ."""
    rng = np.random.default_rng(channels_in)
    x = rng.uniform(-1, 1, size=(4, 32, 32, channels_in)).astype(np.float32)
    m = fnn.Conv(16, (3, 3), padding="SAME", dtype=jnp.bfloat16)
    p = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(channels_in), jnp.asarray(x)))
    p["params"]["bias"] = (0.3 * rng.normal(size=16)).astype(np.float32)
    want = np.asarray(m.apply(p, jnp.asarray(x)).astype(jnp.float32))
    layer = torch.nn.Conv2d(channels_in, 16, 3)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(p["params"]["kernel"].transpose(3, 2, 0, 1).copy()))
        layer.bias.copy_(torch.from_numpy(p["params"]["bias"]))
        xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
        y = F.conv2d(xt, layer.weight.to(torch.bfloat16), None, padding=1).float()
        d = 2 * _f32_sum_error(9 * channels_in) * F.conv2d(
            xt.float().abs(), layer.weight.to(torch.bfloat16).float().abs(), padding=1)
        got = _conv(xt, layer, torch.bfloat16, padding=1).float().permute(0, 2, 3, 1).numpy()
        fused = F.conv2d(xt, layer.weight.to(torch.bfloat16), layer.bias.to(torch.bfloat16),
                         padding=1).float().permute(0, 2, 3, 1).numpy()
    ulp = 2 * U * torch.exp2(torch.floor(torch.log2(y.abs().clamp_min(1e-30))))
    allowed = float(torch.clamp(d / ulp, max=1.0).sum())
    differ = int(np.count_nonzero(got != want))
    assert differ <= allowed, (differ, allowed)
    # the count tells the two forms apart: the fused bias exceeds it
    assert int(np.count_nonzero(fused != want)) > allowed


@pytest.mark.parametrize("bias", sorted(BIASES))
@pytest.mark.parametrize("obs_shape,channels", CASES)
def test_bf16_layer_gradients_match_flax(obs_shape, channels, bias):
    """Layer by layer, from flax's own input to each Conv and Dense and
    flax's own cotangent at its output (so no difference from earlier
    layers enters): the port's kernel gradient against flax's, and its bias
    gradient against the exact sum of that cotangent. Both sides sum the
    same bf16 products in float32 and round once, so they may differ only
    where a rounding boundary lies within 2 gamma_n sum |x g| of the sum
    (rounding_gap, the worst case: no quadrature), and by one bf16 unit
    there; the bias adds half a unit of the port's one rounding."""
    ref, params, port, x, w = _pair(obs_shape, channels, BIASES[bias])
    _, jgrads, _, cot, inputs = _flax_side(ref, params, x, w)
    exact = 0
    for path, layer, xin, g in zip(_call_order(channels), _port_layers(port), inputs, cot):
        node = jgrads
        for key in path:
            node = node[key]
        layer.zero_grad(set_to_none=True)
        wt = layer.weight.detach().to(torch.bfloat16)
        xt = torch.from_numpy(np.array(xin)).to(torch.bfloat16)
        gt = torch.from_numpy(np.array(g)).to(torch.bfloat16)
        if path[-1].startswith("Conv"):
            xt, gt = xt.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)
            y = _conv(xt, layer, torch.bfloat16, padding=1)
            with torch.no_grad():
                sums = torch.nn.grad.conv2d_weight(xt.float().abs(), wt.shape, gt.float().abs(),
                                                   padding=1)
                ref_w = torch.nn.grad.conv2d_weight(xt.float(), wt.shape, gt.float(), padding=1)
            n = xt.shape[0] * xt.shape[2] * xt.shape[3]
            want_w = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        else:
            y = _linear(xt, layer, torch.bfloat16)
            with torch.no_grad():
                sums, ref_w = gt.float().abs().T @ xt.float().abs(), gt.float().T @ xt.float()
            n = xt.shape[0]
            want_w = np.asarray(node["kernel"]).T
        y.backward(gt)
        bound = rounding_gap(ref_w, 2 * _f32_sum_error(n) * sums, torch.bfloat16)
        got_w = layer.weight.grad.numpy()
        _within(f"{path} kernel", got_w, want_w, bound.numpy())
        exact += int(np.array_equal(got_w, want_w))
        gsum = torch.from_numpy(g.astype(np.float64)).reshape(-1, g.shape[-1]).sum(0)
        gabs = torch.from_numpy(np.abs(g).astype(np.float64)).reshape(-1, g.shape[-1]).sum(0)
        bgot = layer.bias.grad.double()
        bbound = _f32_sum_error(n) * gabs + _spacing(bgot.float(), torch.bfloat16).double() / 2
        _within(f"{path} bias", bgot.numpy(), gsum.numpy(), bbound.numpy())
    assert exact >= len(inputs) // 2  # most kernels agree bit for bit
