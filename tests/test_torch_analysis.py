"""The port's AST lints and CLI (r2d2_tpu_torch/analysis/ast_rules.py,
findings.py, cli.py): tests/test_analysis.py's rule cases mirrored in
torch's forms, on small sources — each rule fires on its bad form, stays
silent on its clean form and under its suppression — the four dropped
rules, the findings model and its three renderings, and the CLI's exit
codes, formats and --changed-only. Stdlib-only under test: no jax, and
torch only for the thread pin."""

from __future__ import annotations

import json
import os
import textwrap

import pytest
import torch

from r2d2_tpu_torch.analysis import ast_rules, cli
from r2d2_tpu_torch.analysis.findings import (
    Finding,
    render_json,
    render_sarif,
    render_text,
    stable_sort,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "r2d2_tpu_torch")


def lint(src: str, path: str = "learner.py"):
    """AST-lint a snippet as if it lived at `path` (hot-path by default so
    the host-sync rule is armed)."""
    return ast_rules.analyze_source(textwrap.dedent(src), path)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return str(p)


# ------------------------------------------------------------ findings model


def test_finding_model_and_rendering():
    a = Finding("r", "error", "b.py", 2, 0, "m2")
    b = Finding("r", "warning", "a.py", 9, 3, "m1", hint="do x")
    text = render_text([a, b])
    assert text.index("a.py:9:3") < text.index("b.py:2:0")
    assert "hint: do x" in text and "2 findings" in text
    payload = json.loads(render_json([a, b]))
    assert payload["count"] == 2
    assert [f["path"] for f in payload["findings"]] == ["a.py", "b.py"]
    assert render_text([]) == "no findings"
    with pytest.raises(ValueError):
        Finding("r", "fatal", "a.py", 1, 0, "m")


def test_findings_dedupe_overlapping_scans():
    f = Finding("r", "error", "a.py", 1, 0, "m")
    g = Finding("r", "error", "a.py", 1, 0, "m")
    distinct = Finding("r", "error", "a.py", 1, 0, "other message")
    assert stable_sort([f, g]) == [f]
    assert len(stable_sort([f, g, distinct])) == 2
    assert "1 finding" in render_text([f, g])
    assert json.loads(render_json([f, g, f]))["count"] == 1


def test_sarif_rendering():
    a = Finding("rule-b", "error", "b.py", 2, 4, "m", hint="h")
    b = Finding("rule-a", "info", "<label>", 0, 0, "m2")
    doc = json.loads(render_sarif([a, b, a]))
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "r2d2-analyze"
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == ["rule-a", "rule-b"]
    assert len(run["results"]) == 2
    by_rule = {r["ruleId"]: r for r in run["results"]}
    assert by_rule["rule-a"]["level"] == "note"
    assert by_rule["rule-b"]["level"] == "error"
    region = by_rule["rule-a"]["locations"][0]["physicalLocation"]["region"]
    assert region["startLine"] == 1
    loc = by_rule["rule-b"]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "b.py"
    assert loc["region"] == {"startLine": 2, "startColumn": 5}
    assert "(hint: h)" in by_rule["rule-b"]["message"]["text"]


# ------------------------------------------------------------- host-sync rule


def test_host_sync_fires_on_every_torch_form_in_a_hot_loop():
    src = """
    import torch
    def drain(xs, ev, stream):
        out = []
        for x in xs:
            out.append(x.item())
            out.append(x.cpu())
            out.append(x.tolist())
            out.append(x.numpy())
            out.append(float(x))
            out.append(int(x))
            flag = bool(x)
            torch.cuda.synchronize()
            ev.synchronize()
            stream.synchronize()
        return out
    """
    findings, _ = lint(src)
    assert rules_of(findings) == ["host-sync-in-hot-path"]
    assert len(findings) == 10
    assert all(f.severity == "warning" for f in findings)


def test_host_sync_quiet_outside_loops_on_constants_and_cold_files():
    hoisted = """
    def f(x):
        return x.cpu().numpy(), float(x), int(x)  # no loop: one transfer
    """
    assert lint(hoisted)[0] == []
    consts = """
    def f(xs):
        for x in xs:
            y = float(0) + int(3) + bool(1)
            z = x.to(torch.float32)
            w = x.cpu(memory_format=None)  # an argument: not the bare read
    """
    assert lint(consts)[0] == []
    in_loop = """
    def g(xs):
        out = []
        for x in xs:
            out.append(x.item())
        return out
    """
    assert lint(in_loop, path="utils/summaries.py")[0] == []
    # np.asarray is a host op in the port (no jax.device_get surface)
    host = """
    import numpy as np
    def g(xs):
        return [np.asarray(x) for x in xs] + [np.array(x) for x in xs]
    """
    assert lint(host)[0] == []


def test_host_sync_serve_dir_uses_serve_step_rule():
    src = """
    def g(xs):
        out = []
        for x in xs:
            out.append(x.item())
        return out
    """
    findings, _ = lint(src, path="r2d2_tpu_torch/serve/loop.py")
    assert rules_of(findings) == ["blocking-host-sync-in-serve-step"]


def test_serve_step_rule_flags_stage_dispatch_function_wide():
    bad = """
    import torch
    def _stage_and_dispatch(self, batch):
        q, action = self._step(batch)
        q_host = q.cpu()
        q_np = q_host.numpy()
        torch.cuda.synchronize()
        self._event.synchronize()
        return q_np.tolist(), action.item()
    """
    findings, _ = lint(bad, path="r2d2_tpu_torch/serve/server.py")
    assert rules_of(findings) == ["blocking-host-sync-in-serve-step"]
    assert len(findings) == 6
    assert all("_stage_and_dispatch" in f.message for f in findings)
    ok = """
    def _stage_and_dispatch(self, batch, eps):
        if float(eps.max()) > 0.0:
            return int(len(batch))
        return bool(len(batch))
    """
    assert lint(ok, path="r2d2_tpu_torch/serve/server.py")[0] == []


def test_serve_step_rule_exempts_completion_and_warmup():
    src = """
    def _complete(self, rec):
        rec.event.synchronize()
        q = rec.q_host.numpy()
        out = []
        for r in rec.batch:
            out.append(float(q[0]))
        return out
    def warmup(self):
        for b in self.buckets:
            self.step(b).cpu()
    """
    assert lint(src, path="r2d2_tpu_torch/serve/server.py")[0] == []


def test_host_sync_fires_in_multitask_serve_batch_loop():
    bad = """
    def run_batch(batch, q):
        tasks = []
        for r in batch:
            tasks.append(r.task.tolist())
            tasks.append(q.item())
        return tasks
    """
    findings, _ = lint(bad, path="r2d2_tpu_torch/serve/server.py")
    assert rules_of(findings) == ["blocking-host-sync-in-serve-step"]
    assert len(findings) == 2
    good = """
    import numpy as np
    def run_batch(batch, dims):
        task_full = np.zeros(len(batch), np.int32)
        for i, r in enumerate(batch):
            task_full[i] = r.task
        return task_full, np.asarray(dims, np.int64)
    """
    assert lint(good, path="r2d2_tpu_torch/serve/server.py")[0] == []


# ------------------------------------------------------------------- float64


def test_float64_device_forms_fire():
    src = """
    import numpy as np
    import torch
    def f(x):
        y = x.to(torch.float64)
        z = x.double() + torch.zeros(3, dtype="float64")
        w = torch.tensor([1.0], dtype=np.float64)
        return y, z, w, torch.ones(2, dtype=torch.double)
    """
    findings, _ = lint(src, path="ops/thing.py")
    assert rules_of(findings) == ["float64-op"]
    # torch.float64, .double(), "float64" into torch.zeros, np.float64 into
    # torch.tensor, torch.double
    assert len(findings) == 5
    assert all(f.severity == "error" for f in findings)


def test_host_numpy_float64_is_fine():
    src = """
    import numpy as np
    def prefix(tree, rewards):
        # sum-tree/accumulator math is host-side and MAY be f64
        return np.cumsum(np.asarray(tree, np.float64)), rewards.astype(np.float64)
    """
    assert lint(src, path="replay/sum_tree.py")[0] == []


# --------------------------------------------------------------- fault sites


def test_unknown_fault_site_fires_known_clean():
    src = """
    from r2d2_tpu_torch.utils.faults import fault_point
    def f():
        fault_point("trainer.update")
        fault_point("trainer.updaet")
    """
    findings, _ = lint(src, path="train.py")
    assert rules_of(findings) == ["unknown-fault-site"]
    assert "trainer.updaet" in findings[0].message


def test_dynamic_fault_site_fires():
    src = """
    from r2d2_tpu_torch.utils.faults import fault_point
    def f(site):
        fault_point(site)
    """
    assert rules_of(lint(src, path="train.py")[0]) == ["dynamic-fault-site"]


def test_fault_sites_read_the_ports_own_registry():
    """The registry is the port's (r2d2_tpu_torch.utils.faults): its own
    sites lint clean, and the module never loads the JAX package's."""
    from r2d2_tpu_torch.utils import faults

    assert ast_rules.KNOWN_SITES is faults.KNOWN_SITES
    calls = "\n".join(f'    fault_point("{s}")' for s in faults.KNOWN_SITES)
    assert lint(f"def f():\n{calls}\n", path="serve/scenarios.py")[0] == []
    typo = 'def f():\n    fault_point("serve.replica_kil")\n'
    findings, _ = lint(typo, path="serve/scenarios.py")
    assert rules_of(findings) == ["unknown-fault-site"]


def test_snapshot_missing_topology_fires_and_clean():
    src = """
    from r2d2_tpu_torch.replay.snapshot import save_replay
    def f(replay, path):
        save_replay(replay, path)
    """
    findings, _ = lint(src, path="train.py")
    assert rules_of(findings) == ["snapshot-missing-topology"]
    assert "reshard" in findings[0].message
    clean = """
    from r2d2_tpu_torch.replay.snapshot import save_replay, snapshot_topology
    def f(replay, path, kw):
        save_replay(replay, path, topology=snapshot_topology(replay))
        save_replay(replay, path, **kw)
    """
    assert lint(clean, path="train.py")[0] == []


# ------------------------------------------------------------ lock discipline

LOCK_BARE = """
import threading
class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
    def add(self, n):
        with self._lock:
            self.count += n
    def reset(self):
        self.count = 0
"""


def test_lock_discipline_fires_on_bare_write():
    findings, _ = lint(LOCK_BARE, path="replay/thing.py")
    assert rules_of(findings) == ["lock-discipline"]
    assert findings[0].line == 11


def test_lock_discipline_clean_when_guarded_everywhere():
    src = LOCK_BARE.replace(
        "    def reset(self):\n        self.count = 0",
        "    def reset(self):\n        with self._lock:\n            self.count = 0")
    assert lint(src, path="replay/thing.py")[0] == []


def test_lock_discipline_covers_spill_and_router_shapes():
    spill = """
    import threading
    class Cache:
        def __init__(self):
            self._lock = threading.Lock()
            self._spill_slots = {}
            self.spills = 0
        def demote(self, sid, row):
            with self._lock:
                self._spill_slots[sid] = row
                self.spills += 1
        def evict(self, sid):
            row = self._spill_slots.pop(sid, None)  # read: not flagged
            self.spills = 0
    """
    findings, _ = lint(spill, path="serve/state_cache.py")
    assert rules_of(findings) == ["lock-discipline"] and "spills" in findings[0].message
    router = """
    import threading
    class Router:
        def __init__(self):
            self._lock = threading.Lock()
            self._counts = [0, 0]
        def route(self, sid):
            with self._lock:
                self._counts = list(self._counts)
        def forget(self, sid):
            self._counts = [0, 0]
    """
    findings, _ = lint(router, path="serve/multi.py")
    assert rules_of(findings) == ["lock-discipline"] and "_counts" in findings[0].message


def test_guarded_by_silences_ast_lock_discipline():
    src = LOCK_BARE.replace("    def reset(self):",
                            "    # r2d2: guarded-by(_lock)\n    def reset(self):")
    findings, suppressed = lint(src, path="replay/thing.py")
    assert findings == []
    assert [f.rule for f in suppressed] == ["lock-discipline"]


# ------------------------------------------------------ host-tree-in-hot-loop


def test_host_tree_in_hot_loop_fires():
    src = """
    def drain(self, batches):
        for b in batches:
            idx, w = self.tree.sample(64, self.rng)
            self.tree.update(idx, b)
            n = sum_tree.leaves()
        return n
    """
    findings, _ = lint(src, path="megastep.py")
    assert rules_of(findings) == ["host-tree-in-hot-loop"]
    assert len(findings) == 3 and "priority_plane" in findings[0].message


def test_host_tree_rule_ignores_device_ops_and_cold_files():
    src = """
    from r2d2_tpu_torch.replay import device_sum_tree as dst
    def superstep(tree, rows, cache):
        for row in rows:
            tree = dst.tree_update(tree, 4, row[0], row[1], 0.9)
            cache.update(row)
        return tree
    """
    assert lint(src, path="megastep.py")[0] == []
    hot = """
    def drain(self, xs):
        for x in xs:
            self.tree.update(x, x)  # r2d2: disable=host-tree-in-hot-loop
    """
    findings, suppressed = lint(hot, path="learner.py")
    assert findings == [] and [f.rule for f in suppressed] == ["host-tree-in-hot-loop"]
    cold = hot.replace("  # r2d2: disable=host-tree-in-hot-loop", "")
    assert lint(cold, path="replay/control_plane.py")[0] == []


# ------------------------------------------------- codec-decode-in-hot-loop

DECODE_LOOPS = """
import mmap
import numpy as np
from r2d2_tpu_torch.replay.codec import decode_field
def drain(self, blobs, paths):
    out = []
    for blob in blobs:
        arr, _ = decode_field(blob)
        out.append(arr)
    while paths:
        out.append(np.memmap(paths.pop(), dtype=np.uint8, mode="r"))
    return out
"""


def test_codec_decode_in_hot_loop_fires():
    hits = [f for f in lint(DECODE_LOOPS)[0] if f.rule == "codec-decode-in-hot-loop"]
    assert len(hits) == 2 and all(f.severity == "warning" for f in hits)
    serve = lint(DECODE_LOOPS, path="r2d2_tpu_torch/serve/server.py")[0]
    assert rules_of(serve) == ["codec-decode-in-hot-loop"]


def test_codec_decode_quiet_outside_loops_cold_files_and_suppressed():
    hoisted = """
    from r2d2_tpu_torch.replay.codec import decode_field
    def load_one(blob):
        return decode_field(blob)[0]
    """
    assert lint(hoisted)[0] == []
    assert lint(DECODE_LOOPS, path="r2d2_tpu_torch/replay/disk_tier.py")[0] == []
    sup = """
    from r2d2_tpu_torch.replay.codec import decode_field
    def drain(self, blobs):
        for b in blobs:
            yield decode_field(b)  # r2d2: disable=codec-decode-in-hot-loop
    """
    findings, suppressed = lint(sup)
    assert findings == [] and [f.rule for f in suppressed] == ["codec-decode-in-hot-loop"]


# ---------------------------------------------------------------- suppression


def test_suppression_same_line_and_line_above():
    src = """
    def f(xs):
        out = []
        for x in xs:
            out.append(x.item())  # r2d2: disable=host-sync-in-hot-path  (a reason)
            # r2d2: disable=host-sync-in-hot-path
            out.append(x.cpu())
            out.append(x.item())
        return out
    """
    findings, suppressed = lint(src)
    assert len(findings) == 1 and findings[0].line == 8
    assert len(suppressed) == 2
    assert all(f.rule == "host-sync-in-hot-path" for f in suppressed)


def test_suppression_disable_all_and_wrong_rule():
    src = """
    def f(xs):
        out = []
        for x in xs:
            out.append(x.item())  # r2d2: disable=all
            out.append(x.item())  # r2d2: disable=float64-op
        return out
    """
    findings, suppressed = lint(src)
    assert len(findings) == 1 and len(suppressed) == 1


# -------------------------------------------------------------- dropped rules

JAX_ONLY = """
import functools
import jax
from jax.experimental.shard_map import shard_map
def f(fns, x):
    for fn in fns:
        x = jax.jit(fn)(x)
    return x
@functools.partial(jax.jit, static_argnames=("opts",))
def g(x, opts=[]):
    if x.shape[0] > 2:
        x = x * 2
    return x
"""


def test_the_four_jax_rules_are_dropped_and_documented():
    assert set(ast_rules.DROPPED_RULES) == {
        "jit-in-loop", "unhashable-static-arg", "shape-branch-in-jit",
        "raw-shard-map-import",
    }
    assert not set(ast_rules.DROPPED_RULES) & set(ast_rules.ALL_RULES)
    assert lint(JAX_ONLY, path="ops/thing.py")[0] == []
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    for rule in ast_rules.DROPPED_RULES:
        assert f"- {rule}:" in ast_rules.__doc__, rule
        assert rule in readme, rule


# ------------------------------------------------------------------------ CLI

DIRTY = """
def f(xs):
    out = []
    for x in xs:
        out.append(x.item())
    return out
"""


def test_cli_text_and_exit_codes(tmp_path, capsys):
    dirty = _write(tmp_path, "learner.py", DIRTY)
    assert cli.main([dirty]) == 1
    out = capsys.readouterr().out
    assert "host-sync-in-hot-path" in out and "1 finding" in out
    clean = _write(tmp_path, "clean.py", "x = 1\n")
    assert cli.main([clean]) == 0
    assert "no findings" in capsys.readouterr().out
    sup = _write(tmp_path, "sup/learner.py", DIRTY.replace(
        "x.item())", "x.item())  # r2d2: disable=host-sync-in-hot-path  (test)"))
    assert cli.main([sup]) == 0  # suppressed findings never gate
    assert "(1 suppressed)" in capsys.readouterr().out


def test_cli_json_stable_sorted(tmp_path, capsys):
    _write(tmp_path, "serve/b.py", "def f(xs):\n    for x in xs:\n        y = x.item()\n")
    _write(tmp_path, "serve/a.py",
           "def f(xs):\n    for x in xs:\n        y = x.item()\n        z = x.cpu()\n")
    assert cli.main(["--format", "json", str(tmp_path)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == 3
    keys = [(f["path"], f["line"], f["col"], f["rule"]) for f in payload["findings"]]
    assert keys == sorted(keys) and keys[0][0].endswith("a.py")


def test_cli_sarif_format(tmp_path, capsys):
    dirty = _write(tmp_path, "learner.py", DIRTY)
    assert cli.main(["--format", "sarif", dirty]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["results"][0]["ruleId"] == "host-sync-in-hot-path"


def test_cli_changed_only(tmp_path, capsys, monkeypatch):
    """--changed-only lints the git-changed files of the port's package
    only: a changed file of the JAX package (or anywhere else) is not the
    torch rules' to judge."""
    pkg = tmp_path / "repo" / "r2d2_tpu_torch"
    dirty = _write(pkg, "learner.py", DIRTY)
    outside = _write(tmp_path / "repo" / "r2d2_tpu", "learner.py", DIRTY)
    monkeypatch.setattr(cli, "PKG_ROOT", str(pkg))
    monkeypatch.setattr(cli, "_changed_files", lambda root: [dirty, outside])
    assert cli.main(["--changed-only"]) == 1
    out = capsys.readouterr().out
    assert "host-sync-in-hot-path" in out and "1 finding" in out
    monkeypatch.setattr(cli, "_changed_files", lambda root: [outside])
    assert cli.main(["--changed-only"]) == 0
    monkeypatch.setattr(cli, "_changed_files", lambda root: [])
    assert cli.main(["--changed-only"]) == 0
    capsys.readouterr()


def test_cli_syntax_error_reported(tmp_path, capsys):
    bad = _write(tmp_path, "broken.py", "def f(:\n")
    assert cli.main([bad]) == 1
    assert "syntax-error" in capsys.readouterr().out


def test_cli_has_no_graph_check_flag(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--jaxpr"])
    capsys.readouterr()
