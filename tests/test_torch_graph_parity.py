"""The port's graph checks against the JAX package's jaxpr gate, on the
same configurations and inputs:

- the port's kernel dispatches per update equal the number of
  ``pallas_call`` equations in JAX's traced program, found by walking the
  ClosedJaxpr's equations and the sub-jaxprs in their params (the
  reference's own gate counts the printed text, where a shared sub-jaxpr
  prints once: 2 in the text for 3 equations in the fp32 train step);
- the pure checkers the port copies (compare_store_fields,
  check_trace_budget, the auto-arm resolution) give JAX's findings, rule
  ids mapped ``jaxpr-`` -> ``graph-``;
- the port's store_field_specs equal JAX's at both precisions.

Exact comparisons: counts, rule ids, shapes and dtype names."""

import jax
import jax.extend as jex
import ml_dtypes
import numpy as np
import pytest
import torch

from r2d2_tpu.analysis import jaxpr_rules as j
from r2d2_tpu_torch.analysis import graph_rules as g

torch.set_num_threads(1)


def _subjaxprs(v):
    if isinstance(v, jex.core.ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, jex.core.Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _subjaxprs(x)


def walked_pallas_calls(jaxpr) -> int:
    """pallas_call equations in a jaxpr and every sub-jaxpr of its
    equations' params."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "pallas_call"
        for v in eqn.params.values():
            n += sum(walked_pallas_calls(s) for s in _subjaxprs(v))
    return n


def _jax_train_step(cfg, net_state):
    from r2d2_tpu.learner import make_stacked_batch_train_step

    net, state = net_state
    step = make_stacked_batch_train_step(cfg, net, j._NUM_STEPS, donate=False)
    return jax.make_jaxpr(step)(state, j._stacked_struct_from_cfg(cfg, j._NUM_STEPS))


def _jax_program(name: str, precision: str):
    """JAX's ClosedJaxpr of the entry point, built by jaxpr_rules' own
    recipe (its cached configs, nets and states)."""
    if name == "default":
        return _jax_train_step(j._cfg(precision).replace(lstm_backend="pallas"),
                               j._pallas_net_and_state(precision))
    if name in ("fused_dwh", "ckpt"):
        return _jax_train_step(j._backward_arm_cfg(precision, name),
                               j._backward_arm_net_and_state(precision, name))
    if name.startswith("auto_"):
        arm = name[len("auto_"):]
        return _jax_train_step(j._auto_arm_cfg(precision, arm),
                               j._auto_arm_net_and_state(precision, arm))
    assert name == "unroll"
    cfg = j._cfg(precision)
    net, state = j._pallas_net_and_state(precision)
    B, T = cfg.batch_size, cfg.seq_len
    sds = jax.ShapeDtypeStruct
    return jax.make_jaxpr(lambda p, *a: net.apply(p, *a))(
        state.params, sds((B, T, *cfg.obs_shape), np.uint8), sds((B, T), np.int32),
        sds((B, T), np.float32), sds((B, 2, cfg.hidden_dim), cfg.state_dtype),
        sds((B,), np.int32), sds((B,), np.int32), sds((B,), np.int32))


def _port_per_update(name: str, precision: str) -> int:
    if name == "default":
        trace = g.train_step_trace(precision, "cpu")
    elif name in ("fused_dwh", "ckpt"):
        trace = g.backward_arm_train_step_trace(precision, name, "cpu")
    elif name.startswith("auto_"):
        trace = g.auto_backward_arm_train_step_trace(precision, name[len("auto_"):], "cpu")
    else:
        return sum(g.fused_unroll_trace(precision, "cpu").dispatches.values())
    assert trace.updates == j._NUM_STEPS
    return sum(trace.dispatches.values()) // trace.updates


@pytest.mark.parametrize("name, precision, expected", [
    ("default", "fp32", 3), ("default", "bf16", 3), ("fused_dwh", "fp32", 3),
    ("ckpt", "fp32", 3), ("auto_fused_dwh", "fp32", 3), ("auto_ckpt", "fp32", 3),
    ("unroll", "fp32", 1),
])
def test_dispatches_per_update_equal_jaxs_walked_pallas_calls(name, precision, expected):
    walked = walked_pallas_calls(_jax_program(name, precision).jaxpr)
    assert walked == expected
    assert _port_per_update(name, precision) == walked


def test_the_printed_text_undercounts_the_default_train_step():
    """The reason the port never counts text: the printer shares the
    sub-jaxpr the scan's body holds."""
    cj = _jax_program("default", "fp32")
    assert str(cj).count("pallas_call") == 2
    assert walked_pallas_calls(cj.jaxpr) == 3


def _mapped(findings):
    return sorted((f.rule.replace("jaxpr-", "graph-"), f.path.split(":", 1)[1])
                  for f in findings)


def test_compare_store_fields_matches_jaxs():
    bf16 = np.dtype(ml_dtypes.bfloat16)
    specs = {"hidden": ((2, 2, 8), bf16), "obs": ((3, 4), np.uint8)}
    cases = [
        {"hidden": np.zeros((2, 2, 8), bf16), "obs": np.zeros((3, 4), np.uint8)},
        {"hidden": np.zeros((2, 2, 8), np.float32), "obs": np.zeros((3, 4), np.uint8)},
        {"hidden": np.zeros((2, 2, 4), bf16)},
        {"hidden": np.zeros((2, 2, 8), bf16), "obs": np.zeros((3, 4), np.uint8),
         "extra": np.zeros(1)},
    ]
    for vals in cases:
        assert _mapped(g.compare_store_fields(vals, specs, "t")) == _mapped(
            j.compare_store_fields(vals, specs, "t"))
    # the real pair: JAX's padded block and specs through both checkers
    from r2d2_tpu.replay.block import Block, store_field_specs
    from r2d2_tpu.replay.device_store import DeviceReplayBuffer

    for precision in ("fp32", "bf16"):
        cfg = j._cfg(precision)
        S, n, bl = cfg.seqs_per_block, cfg.block_slot_len - 1, cfg.block_length
        block = Block(
            obs=np.zeros((n, *cfg.obs_shape), np.uint8), last_action=np.zeros(n, np.uint8),
            last_reward=np.zeros(n, np.float32), action=np.zeros(bl, np.uint8),
            n_step_reward=np.zeros(bl, np.float32), gamma=np.zeros(bl, np.float32),
            hidden=np.zeros((S, 2, cfg.hidden_dim), np.float32), num_sequences=S,
            burn_in_steps=np.full(S, cfg.burn_in_steps, np.int32),
            learning_steps=np.full(S, cfg.learning_steps, np.int32),
            forward_steps=np.full(S, cfg.forward_steps, np.int32))
        vals = DeviceReplayBuffer.pad_block_fields(cfg, block)
        specs = store_field_specs(cfg)
        assert g.compare_store_fields(vals, specs, "t") == []
        assert j.compare_store_fields(vals, specs, "t") == []
        vals["hidden"] = vals["hidden"].astype(np.float32)
        assert _mapped(g.compare_store_fields(vals, specs, "t")) == _mapped(
            j.compare_store_fields(vals, specs, "t"))


def test_check_trace_budget_matches_jaxs():
    for count in range(0, 9):
        for buckets in ((2,), (2, 4), (2, 4, 8)):
            for arms in (1, 3):
                assert _mapped(g.check_trace_budget(count, buckets, "s", arms)) == _mapped(
                    j.check_trace_budget(count, buckets, "s", arms))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_auto_arm_resolution_matches_jaxs(precision, monkeypatch):
    """For every pinned cell, and with the budgets moved up and down, the
    port's check fires exactly where JAX's resolution misses its arm."""
    base = dict(j._AUTO_ARM_BUDGET_MB)
    assert base == g._AUTO_ARM_BUDGET_MB
    for budgets in (base, dict.fromkeys(base, 1), dict.fromkeys(base, 1000)):
        for key, mb in budgets.items():
            monkeypatch.setitem(j._AUTO_ARM_BUDGET_MB, key, mb)
            monkeypatch.setitem(g._AUTO_ARM_BUDGET_MB, key, mb)
        for arm in ("fused_dwh", "ckpt"):
            jcfg = j._auto_arm_cfg.__wrapped__(precision, arm)
            jax_miss = jcfg.resolve_backward_arm()[0] != arm
            port = g.check_auto_arm_resolution(g._auto_arm_cfg(precision, arm), arm, "t")
            assert [f.rule for f in port] == (["graph-auto-arm-resolution"] if jax_miss else [])
            assert g._auto_arm_cfg(precision, arm).resolve_backward_arm(device="cpu") == tuple(
                jcfg.resolve_backward_arm())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_store_field_specs_equal_jaxs(precision):
    from r2d2_tpu.replay.block import store_field_specs as jax_specs
    from r2d2_tpu_torch.replay.block import store_field_specs as port_specs

    for jcfg, pcfg in ((j._cfg(precision), g._cfg(precision)),
                       (j._multitask_cfg(precision), g._multitask_cfg(precision))):
        js, ps = jax_specs(jcfg), port_specs(pcfg)
        assert list(js) == list(ps)
        for k in js:
            assert tuple(js[k][0]) == tuple(ps[k][0]), k
            assert g._dtype(js[k][1]) == g._dtype(ps[k][1]), k
