"""The port's graph checks (r2d2_tpu_torch/analysis/graph_rules.py) on the
CPU: the gate over every entry point at both precisions, the mirrors of
the JAX package's jaxpr-gate tests (tests/test_analysis.py: the entry
gates, the launch-count overrun, donation, store fields, trace budget,
the fingerprint and the cache), the CLI's --graph, and one seeded fault
per rule, each firing exactly its rule.

Shapes are tiny_test's (the auto arms H=512, B=32); the entry points'
traces are shared through the module's caches. No tolerance: the checks
are exact (dtypes, counts, storage pointers)."""

import json
import os

import numpy as np
import pytest
import torch

from r2d2_tpu_torch import learner
from r2d2_tpu_torch.analysis import graph_rules as g
from r2d2_tpu_torch.analysis.findings import Finding, render_text
from r2d2_tpu_torch.ops import lstm_kernel as K

torch.set_num_threads(1)

PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "r2d2_tpu_torch")


def rules_of(findings):
    return sorted({f.rule for f in findings})


def op(name="aten::add", dtypes=("float32",), tainted=False, ins=("cpu",), outs=None,
       consumes=()):
    return g.OpRecord(name, tuple(dtypes), tuple(() for _ in dtypes),
                      tuple(outs if outs is not None else ("cpu",) * len(dtypes)),
                      tuple(ins), tainted, tuple(consumes))


# ------------------------------------------------------------ the gate


SCANS = ["train_step", "multitask_train_step", "resharded_train_step", "act", "act_select",
         "fused_unroll", "backward_arms", "auto_backward_arms", "manual_train_step",
         "superstep", "serve_step", "trace_budget", "multi_serve_step", "liveloop_gather",
         "donation"]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("entry", SCANS)
def test_each_entry_point_is_clean(entry, precision):
    findings = getattr(g, f"scan_{entry}")(precision, device="cpu")
    assert findings == [], render_text(findings)


def test_graph_entry_point_gate():
    """Every entry point at both precisions, and the int8 arms: zero
    findings (the tier-1 gate)."""
    findings = g.scan_entry_points(device="cpu")
    assert findings == [], render_text(findings)


def test_int8_serve_arms_are_clean():
    findings = g.scan_serve_step_int8("fp32", "cpu") + g.scan_multi_serve_step(
        "fp32", "int8", device="cpu")
    assert findings == [], render_text(findings)
    trace = g.serve_step_trace("fp32", "int8", "cpu")
    # the encoder's and heads' weights, each first read by the dequantization
    assert len(trace.int8) == 5
    assert all(n.endswith(".q8") for n in trace.int8)


def test_graph_superstep_gate_both_precisions():
    """The N x K priority superstep: clean at both precisions, the tree
    descent and the K updates in the recorded program, N*K*(2 + 1)
    dispatches, and the TrainState and tree kept in place."""
    for precision in ("fp32", "bf16"):
        assert g.scan_superstep(precision, "cpu") == []
    trace = g.priority_superstep_trace("fp32", "cpu")
    assert trace.dispatches == {"lstm_fwd": 8, "lstm_seq_bwd": 4}
    names = {o.name for o in trace.ops}
    assert "aten::nextafter" in names and "aten::index" in names
    before, after = trace.kept
    assert "tree" in before and before["tree"] == after["tree"]


def test_train_step_dispatches_per_update():
    """2 forwards + 1 seam backward per update, in the compute dtype's
    forms; the stacked step runs K=2 updates."""
    assert g.train_step_trace("fp32", "cpu").dispatches == {"lstm_fwd": 4, "lstm_seq_bwd": 2}
    assert g.train_step_trace("bf16", "cpu").dispatches == {
        "lstm_fwd_bf16": 4, "lstm_seq_bwd_bf16": 2}
    assert g.act_trace("fp32", "cpu").dispatches == {}
    assert g.act_select_trace("bf16", "cpu").dispatches == {}
    assert g.fused_unroll_trace("fp32", "cpu").dispatches == {"lstm_fwd": 1}


def test_adam_step_read_is_not_a_host_sync():
    """torch's Adam reads its host step counter with .item() (not
    capturable): recorded, untainted, not flagged; the step reads nothing
    of its data back."""
    trace = g.train_step_trace("fp32", "cpu")
    reads = [o for o in trace.ops if o.name == "aten::_local_scalar_dense"]
    assert reads and not any(o.tainted for o in reads)
    assert g.check_no_host_sync(trace, "t") == []


def test_multitask_train_step_gate_both_precisions():
    for precision in ("fp32", "bf16"):
        assert g.scan_multitask_train_step(precision, "cpu") == []
    trace = g.multitask_train_step_trace("fp32", "cpu")
    # the (B,) int32 task leaf conditions the head: its one-hot is formed
    B = g._multitask_cfg("fp32").batch_size
    assert any(o.name == "aten::eq" and o.out_shapes[0] == (B, 2) for o in trace.ops)


def test_multi_serve_step_gate():
    """Both replicas (on repeated devices) run the identical program, at
    both precisions and under int8."""
    for precision in ("fp32", "bf16"):
        assert g.scan_multi_serve_step(precision, device="cpu") == []
    a, b = (g.multi_serve_step_trace("fp32", "none", 2, i, "cpu") for i in range(2))
    assert [o[:3] for o in a.ops] == [o[:3] for o in b.ops] and a.ops


def test_backward_arm_gate_both_precisions():
    for precision in ("fp32", "bf16"):
        assert g.scan_backward_arms(precision, "cpu") == []
    for arm, form in (("fused_dwh", "lstm_seq_bwd_fused"), ("ckpt", "lstm_seq_bwd_ckpt")):
        assert g.backward_arm_train_step_trace("fp32", arm, "cpu").dispatches == {
            "lstm_fwd": 4, form: 2}
        assert g.backward_arm_train_step_trace("bf16", arm, "cpu").dispatches == {
            "lstm_fwd_bf16": 4, f"{form}_bf16": 2}


def test_manual_train_step_gate_both_precisions():
    """dp2 x tp2 x fsdp2 on 8 repeated CPU devices: 2*dp*fsdp forwards and
    dp*fsdp backwards an update, the moment shards kept in place."""
    for precision in ("fp32", "bf16"):
        assert g.scan_manual_train_step(precision, device="cpu") == []
    trace = g.manual_train_step_trace("fp32", 2, 2, 2, "cpu")
    assert trace.dispatches == {"lstm_fwd": 8, "lstm_seq_bwd": 4}
    assert any(k.startswith("mu.") for k in trace.kept[0])


def test_auto_backward_arm_gate_both_precisions():
    for precision in ("fp32", "bf16"):
        assert g.scan_auto_backward_arms(precision, "cpu") == []
    assert g._auto_arm_cfg("bf16", "fused_dwh").resolve_backward_arm(device="cpu") == (
        "fused_dwh", 0)
    arm, stride = g._auto_arm_cfg("fp32", "ckpt").resolve_backward_arm(device="cpu")
    assert arm == "ckpt" and stride >= 2


def test_the_two_faults_the_gate_found_stay_fixed():
    """The sharded step summed its denominator on the host (int() of each
    shard's learning steps); the superstep returned a new tree per update
    instead of its entry tree."""
    for trace in (g.resharded_train_step_trace("fp32", 2, "cpu"),
                  g.manual_train_step_trace("fp32", 2, 2, 2, "cpu")):
        assert not [o for o in trace.ops if o.name == "aten::_local_scalar_dense" and o.tainted]
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.megastep import make_priority_superstep
    from r2d2_tpu_torch.replay import device_sum_tree as dst

    cfg = g._superstep_cfg("fp32")
    _, state = init_train_state(cfg, "cpu", seed=0)
    tree = dst.tree_from_leaves(np.linspace(0.1, 1.0, cfg.num_sequences), cfg.num_sequences)
    was = tree.clone()
    u = torch.rand((1, 2, cfg.batch_size), generator=torch.Generator().manual_seed(0))
    nss = torch.full((cfg.num_blocks,), cfg.seqs_per_block, dtype=torch.int32)
    _, out, _ = make_priority_superstep(cfg, 1, 2)(state, g._stores(cfg, cfg.num_blocks, "cpu"),
                                                   tree, nss, u)
    assert out is tree and not torch.equal(tree, was)


def test_one_hot_matches_torch_and_reads_nothing_back():
    from r2d2_tpu_torch.models.r2d2 import one_hot

    x = torch.tensor([[0, 3], [2, 1]])
    assert torch.equal(one_hot(x, 4, torch.float32), torch.nn.functional.one_hot(x, 4).float())
    trace, _ = g.observe(lambda: one_hot(x, 4, torch.bfloat16), [x], "cpu")
    assert g.check_no_host_sync(trace, "t") == []


# --------------------------------------------------- checker negatives


def test_graph_checkers_fire_on_synthetic_programs():
    t = g.Trace
    assert rules_of(g.check_no_float64(t([op(dtypes=("float64",))]), "t")) == ["graph-float64"]
    assert rules_of(g.check_no_float64(t([op(dtypes=("complex128",))]), "t")) == [
        "graph-float64"]
    assert g.check_no_float64(t([op()]), "t") == []
    assert rules_of(g.check_no_bf16(t([op(dtypes=("bfloat16",))]), "t")) == [
        "graph-bf16-in-fp32"]
    assert g.check_no_bf16(t([op()]), "t") == []
    # a healthy bf16 program has both dtypes
    assert g.check_fp32_island(t([op(dtypes=("bfloat16",)), op()]), "t") == []
    assert rules_of(g.check_fp32_island(t([op()]), "t")) == ["graph-no-bf16-under-bf16"]
    assert rules_of(g.check_fp32_island(t([op(dtypes=("bfloat16",))]), "t")) == [
        "graph-missing-fp32-island"]
    # host syncs: a data-derived read, an op sized by the data, a copy to
    # the host, a synchronizing CUDA call; an untainted host read is not
    for bad in (t([op("aten::_local_scalar_dense", (), tainted=True)]),
                t([op("aten::nonzero", ("int64",), tainted=True)]),
                t([op("aten::_to_copy", ins=("cuda",), outs=("cpu",))]),
                t([], sync_error="called a synchronizing CUDA operation")):
        assert rules_of(g.check_no_host_sync(bad, "t")) == ["graph-host-sync"]
    assert g.check_no_host_sync(t([op("aten::_local_scalar_dense", ())]), "t") == []
    assert rules_of(g.check_output_dtypes({"q": "bfloat16"}, "float32", "t")) == [
        "graph-output-dtype"]
    assert g.check_output_dtypes({"q": "float32"}, "float32", "t") == []


def test_kernel_launch_count_checker_fires_on_budget_overrun():
    """One dispatch too many (dWh split back out into a 4th launch) is a
    finding; the exact budget is clean; on the card a dispatch that did
    not launch (a plain version ran there) is a finding too."""
    want = {"lstm_fwd": 2, "lstm_seq_bwd": 1}
    four = g.Trace(dispatches={"lstm_fwd": 3, "lstm_seq_bwd": 1})
    three = g.Trace(dispatches=dict(want))
    assert rules_of(g.check_kernel_launch_count(four, "t", want, "step")) == [
        "graph-kernel-launch-count"]
    assert g.check_kernel_launch_count(three, "t", want, "step") == []
    card = g.Trace(dispatches=dict(want), launches={"lstm_fwd": 2}, device="cuda")
    assert rules_of(g.check_kernel_launch_count(card, "t", want, "step")) == [
        "graph-kernel-launch-count"]
    card.launches = dict(want)
    assert g.check_kernel_launch_count(card, "t", want, "step") == []


def test_int8_checker():
    t = g.Trace
    good = t([op("aten::_to_copy", consumes=("w.q8",)), op("aten::mul")], int8=("w.q8",))
    assert g.check_int8_weights(good, "t") == []
    for bad in (t([op()]),  # no int8 weight entered the step
                t([op("aten::mm", consumes=("w.q8",))], int8=("w.q8",)),
                t([op("aten::_to_copy", ("float64",), consumes=("w.q8",))], int8=("w.q8",)),
                t([op()], int8=("w.q8",))):  # never read
        assert rules_of(g.check_int8_weights(bad, "t")) == ["graph-no-int8-under-int8"]


def test_donation_checker_fires_on_mismatch():
    before = {"w": (64, (4, 4), "float32")}
    assert g.compare_kept_storage(before, dict(before), "t") == []
    for after in ({"w": (128, (4, 4), "float32")}, {"w": (64, (4, 4), "float16")},
                  {"w": (64, (2, 8), "float32")}, {}):
        assert rules_of(g.compare_kept_storage(before, after, "t")) == [
            "graph-donation-mismatch"]
    w = torch.zeros(3)
    specs = g.storage_specs({"w": w})
    w.add_(1.0)
    assert g.compare_kept_storage(specs, g.storage_specs({"w": w}), "t") == []


def test_store_field_checker_fires_on_an_f32_slab_for_a_bf16_store():
    """A float32 hidden slab padded for a bf16 store, in numpy and in torch
    form; a missing field and an unknown one."""
    import ml_dtypes

    specs = {"hidden": ((2, 2, 8), np.dtype(ml_dtypes.bfloat16))}
    good = {"hidden": np.zeros((2, 2, 8), np.dtype(ml_dtypes.bfloat16))}
    bad = {"hidden": np.zeros((2, 2, 8), np.float32)}
    assert g.compare_store_fields(good, specs, "t") == []
    assert rules_of(g.compare_store_fields(bad, specs, "t")) == ["graph-store-field-mismatch"]
    tspecs = {"hidden": ((2, 2, 8), torch.bfloat16)}
    assert g.compare_store_fields({"hidden": torch.zeros(2, 2, 8, dtype=torch.bfloat16)},
                                  tspecs, "t") == []
    assert rules_of(g.compare_store_fields({"hidden": torch.zeros(2, 2, 8)}, tspecs, "t")) == [
        "graph-store-field-mismatch"]
    assert rules_of(g.compare_store_fields({}, tspecs, "t")) == ["graph-store-field-mismatch"]
    assert len(g.compare_store_fields({"x": torch.zeros(1)}, {}, "t")) == 1
    for precision in ("fp32", "bf16"):
        assert g.check_store_field_dtypes(precision) == []


def test_trace_budget_checker():
    assert g.check_trace_budget(2, (2, 4)) == []
    assert rules_of(g.check_trace_budget(3, (2, 4))) == ["graph-trace-budget"]
    assert g.check_trace_budget(6, (2, 4), arms=3) == []
    srv = g._serve_server("fp32", "none", "cpu", degrade=True)
    assert srv.trace_count == 3  # one bucket x the ladder's three arms


def test_replica_divergence_checker():
    a = g.Trace([op(), op("aten::mm")])
    b = g.Trace([op(), op("aten::mm")])
    assert g.check_replica_divergence([a, b], "t") == []
    c = g.Trace([op(), op("aten::mm"), op()])
    assert rules_of(g.check_replica_divergence([a, c], "t")) == ["graph-replica-divergence"]


# ------------------------------------------------------ seeded faults


def _train_rules(monkeypatch, precision="fp32"):
    """The train step's own checks (precision, outputs, dispatches, kept
    state) on a fresh, uncached trace under whatever is patched."""
    trace = g.train_step_trace.__wrapped__(precision, "cpu")
    monkeypatch.setattr(g, "train_step_trace", lambda *a, **k: trace)
    found = (g.scan_train_step(precision, "cpu")
             + g.check_kernel_launch_count(trace, "t", trace.expected, "train step")
             + g.scan_donation(precision, "cpu"))
    return rules_of(found)


def _patch_loss(monkeypatch, extra):
    """learner.make_loss_fn with `extra(loss, net, target, b)` applied to
    each update's loss."""
    orig = learner.make_loss_fn

    def make(cfg):
        fn = orig(cfg)

        def loss_fn(net, target_net, b, denom):
            loss, aux = fn(net, target_net, b, denom)
            return extra(loss, net, target_net, b), aux

        return loss_fn

    monkeypatch.setattr(learner, "make_loss_fn", make)


def _fault_float64(monkeypatch):
    _patch_loss(monkeypatch, lambda loss, *_: loss + (torch.tensor(0.5, dtype=torch.float64)
                                                      * 0).float())
    return _train_rules(monkeypatch)


def _fault_bf16(monkeypatch):
    _patch_loss(monkeypatch, lambda loss, *_: loss + (loss.detach().to(torch.bfloat16)
                                                      * 0).float())
    return _train_rules(monkeypatch)


def _fault_item(monkeypatch):
    def extra(loss, *_):
        loss.item()
        return loss

    _patch_loss(monkeypatch, extra)
    return _train_rules(monkeypatch)


def _fault_second_forward(monkeypatch):
    def extra(loss, net, target, b):
        with torch.no_grad():
            target(b.obs, b.last_action, b.last_reward, b.hidden, b.burn_in_steps,
                   b.learning_steps, b.forward_steps)
        return loss

    _patch_loss(monkeypatch, extra)
    return _train_rules(monkeypatch)


def _fault_rebound(monkeypatch):
    orig = learner._apply_gradients
    # the storages rebound away, kept alive: a freed one could be handed
    # to a later clone at the address the check compares
    replaced = []

    def apply(cfg, state, params):
        norm = orig(cfg, state, params)
        replaced.append(state.net.core.wh.data)
        state.net.core.wh.data = state.net.core.wh.data.clone()
        return norm

    monkeypatch.setattr(learner, "_apply_gradients", apply)
    return _train_rules(monkeypatch)


def _fault_fp32_compute(monkeypatch):
    cfg = g._cfg
    monkeypatch.setattr(g, "_cfg", lambda precision: cfg("fp32"))
    return _train_rules(monkeypatch, "bf16")


def _fault_bf16_priorities(monkeypatch):
    orig = learner.mixed_td_priorities
    monkeypatch.setattr(learner, "mixed_td_priorities",
                        lambda *a: orig(*a).to(torch.bfloat16))
    return _train_rules(monkeypatch, "bf16")


def _fault_int8_at_publish(monkeypatch):
    from r2d2_tpu_torch.ops.quantize import dequantize_tree
    from r2d2_tpu_torch.serve.server import PolicyServer

    orig = PolicyServer.prepare_for_publish

    def prepare(self, params, arm=None):
        out, leaves, arm = orig(self, params, arm)
        return dequantize_tree(out), leaves, arm

    monkeypatch.setattr(PolicyServer, "prepare_for_publish", prepare)
    srv = g._serve_server.__wrapped__("fp32", "int8", "cpu")
    trace = g._serve_trace(srv, "cpu")
    monkeypatch.setattr(g, "serve_step_trace", lambda *a, **k: trace)
    return rules_of(g.scan_serve_step_int8("fp32", "cpu"))


def _fault_f32_hidden_slab(monkeypatch):
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer

    orig = DeviceReplayBuffer.pad_block_fields

    def pad(cfg, block):
        out = orig(cfg, block)
        out["hidden"] = np.zeros(out["hidden"].shape, np.float32)
        return out

    monkeypatch.setattr(DeviceReplayBuffer, "pad_block_fields", staticmethod(pad))
    return rules_of(g.check_store_field_dtypes("bf16") + g.check_store_field_dtypes("fp32"))


def _fault_fourth_shape(monkeypatch):
    srv = g._serve_server.__wrapped__("fp32", "none", "cpu", True)
    params, _, _, arm = srv._published
    n = 3
    srv._step(params, arm, n, torch.zeros((n, *srv.cfg.obs_shape), dtype=torch.uint8),
              torch.zeros(n), torch.full((n,), srv.cache.pad_slot, dtype=torch.long),
              torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool),
              torch.zeros(n, dtype=torch.int32), None)
    monkeypatch.setattr(g, "_serve_server", lambda *a, **k: srv)
    return rules_of(g.scan_trace_budget("fp32", "cpu"))


def _fault_replica_index(monkeypatch):
    fleet = g._multi_serve_server.__wrapped__("fp32", "none", 2, "cpu")
    for index, rep in enumerate(fleet.replicas):
        step = rep._step

        def closed(*args, _step=step, _index=index):
            q, action = _step(*args)
            return (q + 0.0 * _index if _index else q), action

        rep._step = closed
    traces = [g._serve_trace(rep, "cpu") for rep in fleet.replicas]
    monkeypatch.setattr(g, "multi_serve_step_trace",
                        lambda precision, q, dp, i, device: traces[i])
    return rules_of(g.scan_multi_serve_step("fp32", device="cpu"))


def _fault_moved_budget(monkeypatch):
    monkeypatch.setitem(g._AUTO_ARM_BUDGET_MB, ("bf16", "fused_dwh"), 10_000)
    return rules_of(g.scan_auto_backward_arms("bf16", "cpu"))


def _fault_no_fp32_island(monkeypatch):
    # no edit of the port narrows its loss island without rewriting the
    # model: a synthetic all-bf16 program, as JAX's test feeds texts
    trace = g.Trace([op(dtypes=("bfloat16",)), op("aten::mm", ("bfloat16",))])
    return rules_of(g._step_checks(trace, "t", "bf16"))


SEEDED = {
    "graph-float64": _fault_float64,
    "graph-bf16-in-fp32": _fault_bf16,
    "graph-host-sync": _fault_item,
    "graph-no-int8-under-int8": _fault_int8_at_publish,
    "graph-store-field-mismatch": _fault_f32_hidden_slab,
    "graph-trace-budget": _fault_fourth_shape,
    "graph-replica-divergence": _fault_replica_index,
    "graph-donation-mismatch": _fault_rebound,
    "graph-kernel-launch-count": _fault_second_forward,
    "graph-no-bf16-under-bf16": _fault_fp32_compute,
    "graph-output-dtype": _fault_bf16_priorities,
    "graph-auto-arm-resolution": _fault_moved_budget,
    "graph-missing-fp32-island": _fault_no_fp32_island,
}


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_fault_fires_exactly_its_rule(rule, monkeypatch):
    assert SEEDED[rule](monkeypatch) == [rule]


# ------------------------------------------------------------------ CLI


def _clean_file(tmp_path):
    p = tmp_path / "clean.py"
    p.write_text("x = 1\n")
    return str(p)


def test_cli_graph_exit_codes_and_formats(tmp_path, capsys, monkeypatch):
    from r2d2_tpu_torch.analysis.cli import main

    clean = _clean_file(tmp_path)
    assert main(["--graph", "--device", "cpu", clean]) == 0
    assert "no findings" in capsys.readouterr().out
    assert main(["--graph", "--device", "cpu", "--format", "json", clean]) == 0
    assert json.loads(capsys.readouterr().out)["count"] == 0
    bad = Finding("graph-float64", "error", "<graph:train_step[fp32]>", 0, 0, "m")
    monkeypatch.setattr(g, "scan_entry_points", lambda precisions=("fp32", "bf16"),
                        device="cuda": [bad])
    assert main(["--graph", "--device", "cpu", clean]) == 1
    assert "graph-float64" in capsys.readouterr().out
    assert main(["--graph", "--device", "cpu", "--format", "sarif", clean]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["results"][0]["ruleId"] == "graph-float64"


def test_cli_graph_refuses_without_a_card(tmp_path, capsys, monkeypatch):
    from r2d2_tpu_torch.analysis.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--graph", _clean_file(tmp_path)])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_changed_only_graph_uses_the_cache(tmp_path, monkeypatch):
    from r2d2_tpu_torch.analysis import cli

    seen = []
    monkeypatch.setattr(cli, "_changed_files", lambda root: [])
    monkeypatch.setattr(g, "scan_entry_points_cached",
                        lambda path, device="cuda": seen.append((path, device)) or [])
    assert cli.main(["--changed-only", "--graph", "--device", "cpu"]) == 0
    assert seen and seen[0][0].endswith(".r2d2_torch_graph_cache.json") and seen[0][1] == "cpu"


# ------------------------------------------------------- result cache


def test_graph_source_fingerprint_stable():
    files = g.entry_point_source_files()
    rels = {os.path.relpath(p, PKG_DIR).replace(os.sep, "/") for p in files}
    for must in ("learner.py", "megastep.py", "serve/server.py", "serve/multi.py",
                 "replay/block.py", "ops/lstm_kernel.py", "analysis/graph_rules.py"):
        assert must in rels, must
    assert g.source_fingerprint("cpu") == g.source_fingerprint("cpu")
    assert g.source_fingerprint("cpu") != g.source_fingerprint("cuda")


def test_graph_cache_roundtrip(tmp_path, monkeypatch):
    """First call scans and writes the cache, the second is served from it,
    a fingerprint mismatch (or another device) forces a rescan, and a
    corrupt cache falls through to a real scan."""
    calls = []

    def fake_scan(precisions=("fp32", "bf16"), device="cuda"):
        calls.append(device)
        return [Finding("graph-float64", "error", "<graph:x>", 0, 0, "m")]

    monkeypatch.setattr(g, "scan_entry_points", fake_scan)
    cache = str(tmp_path / "cache.json")
    out1 = g.scan_entry_points_cached(cache, device="cpu")
    assert calls == ["cpu"] and out1[0].rule == "graph-float64"
    assert g.scan_entry_points_cached(cache, device="cpu") == out1
    assert calls == ["cpu"]  # a cache hit: nothing run
    g.scan_entry_points_cached(cache, device="cuda")
    assert calls == ["cpu", "cuda"]
    with open(cache, encoding="utf-8") as fh:
        data = json.load(fh)
    data["fingerprint"] = "stale"
    with open(cache, "w", encoding="utf-8") as fh:
        json.dump(data, fh)
    g.scan_entry_points_cached(cache, device="cpu")
    assert len(calls) == 3
    with open(cache, "w", encoding="utf-8") as fh:
        fh.write("{not json")
    assert g.scan_entry_points_cached(cache, device="cpu") == out1
    assert len(calls) == 4


def test_dispatch_counts_count_every_call_on_the_cpu():
    """The wrappers count each call of a form on any device; on the CPU
    none of them launches."""
    K.reset_launch_counts()
    T, B, H = 3, 2, 4
    proj = torch.zeros(T, B, 4 * H)
    K.lstm_fwd(proj, torch.zeros(H, 4 * H), torch.zeros(B, H), torch.zeros(B, H))
    K.lstm_fwd(proj.to(torch.bfloat16), *(torch.zeros(*s, dtype=torch.bfloat16)
                                          for s in ((H, 4 * H), (B, H), (B, H))))
    assert {k: v for k, v in K.dispatch_counts.items() if v} == {"lstm_fwd": 1,
                                                                "lstm_fwd_bf16": 1}
    assert not any(K.launch_counts.values())
    K.reset_launch_counts()
    assert not any(K.dispatch_counts.values())
