"""The port's analyzer against the JAX package's, and the port clean under
its own.

- Parity: for every rule whose logic the port keeps unchanged — the AST
  rules lock-discipline, snapshot-missing-topology, host-tree-in-hot-loop
  and codec-decode-in-hot-loop; the three concurrency rules (blocking-
  under-lock on the blocking operations both sets hold); and the resume,
  bad-ephemeral-annotation, unsorted-scan and id-keyed / set-order
  nondet-taint rules — both packages' passes, run over the same fixture
  sources and over JAX's r2d2_tpu/serve, liveloop, transport and replay
  trees, give the same findings and the same suppressed lists as (rule,
  relative path, line). Each tree is analyzed once per package (module
  fixtures).
- The chaos pass: a port site whose name only JAX's tests drill is
  undrilled for the port.
- The clean gate: `python -m r2d2_tpu_torch.analysis --concurrency
  --determinism` exits 0 over r2d2_tpu_torch/, and every `# r2d2:`
  annotation in the port carries its reason.
"""

from __future__ import annotations

import io
import os
import re
import shutil
import textwrap
import time
import tokenize

import pytest
import torch

from r2d2_tpu.analysis import ast_rules as jax_ast
from r2d2_tpu.analysis import concurrency as jax_conc
from r2d2_tpu.analysis import determinism as jax_det
from r2d2_tpu_torch.analysis import ast_rules, cli, concurrency, determinism

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "r2d2_tpu_torch")
JAX_TREES = [os.path.join(ROOT, "r2d2_tpu", d)
             for d in ("serve", "liveloop", "transport", "replay")]

SHARED_AST = {"lock-discipline", "snapshot-missing-topology",
              "host-tree-in-hot-loop", "codec-decode-in-hot-loop"}
SHARED_DET = {"resume-uncaptured-field", "resume-unrestored-field",
              "bad-ephemeral-annotation", "unsorted-scan", "nondet-taint"}


def _labels(mod):
    return (set(mod._BLOCKING_DOTTED.values()) | set(mod._BLOCKING_NAMES.values())
            | set(mod._BLOCKING_METHODS.values()) | {".item() (D2H sync)"})


# the blocking operations both packages' sets hold (the rest differ: JAX's
# jax.device_get & co., the port's .cpu()/.cuda()/synchronize & co.)
COMMON_BLOCKING = _labels(jax_conc) & (
    _labels(concurrency) | set(concurrency._BLOCKING_TENSOR_METHODS.values()))


def _shared(f) -> bool:
    if f.rule in SHARED_AST:
        return True
    if f.rule in ("lock-order-cycle", "cross-thread-unguarded-write"):
        return True
    if f.rule == "blocking-under-lock":
        return f.message.split(" inside a critical section")[0] in COMMON_BLOCKING
    if f.rule == "nondet-taint":
        # the wall-clock taint's sinks differ (fold_in vs the torch seeds)
        return not f.message.startswith("wall-clock")
    return f.rule in SHARED_DET


def _keys(findings, root):
    return sorted((f.rule, os.path.relpath(f.path, root), f.line)
                  for f in findings if _shared(f))


def _run_all(analyzers, paths):
    findings, suppressed = [], []
    for mod in analyzers:
        f, s = mod.analyze_paths(paths)
        findings += f
        suppressed += s
    return findings, suppressed


# fixture packages: each rule's bad form, clean form and suppression, as
# tests/test_analysis.py holds them; laid out with the hot-path and serve
# names the AST rules key on
FIXTURES = {
    "ast/replay/store.py": """
        import threading
        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self.n = 0
            def add(self, n):
                with self._lock:
                    self.count += n
                    self.n += 1
            def reset(self):
                self.count = 0
            # r2d2: guarded-by(_lock)
            def _reset_n(self):
                self.n = 0
            def clear(self):
                self.n = 0  # r2d2: disable=lock-discipline
    """,
    "ast/train.py": """
        from r2d2_tpu.replay.snapshot import save_replay, snapshot_topology
        def f(replay, path, kw):
            save_replay(replay, path)
            save_replay(replay, path, topology=snapshot_topology(replay))
            save_replay(replay, path, **kw)
            save_replay(replay, path)  # r2d2: disable=snapshot-missing-topology
    """,
    "ast/megastep.py": """
        import mmap
        import numpy as np
        from r2d2_tpu.replay import device_sum_tree as dst
        from r2d2_tpu.replay.codec import decode_field
        def drain(self, batches, blobs, paths):
            for b in batches:
                idx, w = self.tree.sample(64, self.rng)
                self.tree.update(idx, b)  # r2d2: disable=host-tree-in-hot-loop
                t = dst.tree_update(self.dtree, 4, b, b, 0.9)
            for blob in blobs:
                arr, _ = decode_field(blob)
                m = np.memmap(paths.pop(), dtype=np.uint8, mode="r")
            return decode_field(blobs[0])
    """,
    "ast/serve/server.py": """
        from r2d2_tpu.replay.codec import decode_block
        def gather(self, blobs):
            out = []
            for b in blobs:
                out.append(decode_block(b))
                out.append(b.read_block())  # r2d2: disable=codec-decode-in-hot-loop
            return out
    """,
    "conc/cycle.py": """
        import threading
        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self._r = threading.RLock()
            def fwd(self):
                with self._a:
                    with self._b:
                        pass
            def rev(self):
                with self._b:
                    with self._a:
                        pass
            def _helper(self):
                with self._a:
                    pass
            def again(self):
                with self._a:
                    self._helper()
            def _rhelper(self):
                with self._r:
                    pass
            def ragain(self):
                with self._r:
                    self._rhelper()
    """,
    "conc/race.py": """
        import queue
        import socket
        import threading
        import time
        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self.guarded = 0
                self.noted = 0
                self.q = queue.Queue()
                self._t = threading.Thread(target=self._loop, daemon=True)
            def _loop(self):
                while True:
                    self.count += 1
                    self.q.put(1)
                    with self._lock:
                        self.guarded += 1
                        self._bump()
                    self.noted += 1  # r2d2: disable=cross-thread-unguarded-write
            # r2d2: guarded-by(_lock)
            def _bump(self):
                self.guarded -= 1
                time.sleep(0.01)
            def bump(self, x, sock):
                self.count += 1
                self.noted += 1  # r2d2: guarded-by(_lock)
                with self._lock:
                    self.guarded += 1
                    v = x.item()
                    sock.sendall(b"x")
                    time.sleep(0.1)  # r2d2: disable=blocking-under-lock
                    w = x.cpu()
                return v, w
    """,
    "det/acc.py": """
        import glob
        import os
        import time
        class Acc:
            def __init__(self):
                self.total = 0.0
                self.n = 0
                self.k = 0
                # r2d2: ephemeral(monitoring counter; restarts at 0 on resume)
                self.seen = 0
                # r2d2: ephemeral()
                self.m = 0
            def add(self, x, d):
                self.total += x
                self.n += 1
                self.k += 1
                self.seen += 1
                self.m += 1
                self.files = os.listdir(d)
                self.more = sorted(glob.glob(d))
                self.mark = time.time()
            def carry_state(self):
                return {"total": self.total, "k": self.k}
            def restore_carry(self, d):
                self.total = d["total"]
                # r2d2: ephemeral(this line assigns no attribute)
                x = 1
        def evict(server, trace, cache, obj):
            for sid in {ev.session for ev in trace}:
                server.evict(sid)
            cache[id(obj)] = 1
            ok = [s for s in sorted({1, 2})]
            return {id(obj): 2}, ok, glob.glob("x")  # r2d2: disable=unsorted-scan
    """,
}


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    for name, src in FIXTURES.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


@pytest.fixture(scope="module")
def fixture_results(fixture_tree):
    paths = [fixture_tree]
    return (_run_all((jax_ast, jax_conc, jax_det), paths),
            _run_all((ast_rules, concurrency, determinism), paths))


@pytest.fixture(scope="module")
def jax_tree_results():
    return (_run_all((jax_ast, jax_conc, jax_det), JAX_TREES),
            _run_all((ast_rules, concurrency, determinism), JAX_TREES))


def test_shared_rules_agree_on_the_fixture_sources(fixture_tree, fixture_results):
    (jf, js), (pf, ps) = fixture_results
    assert _keys(pf, fixture_tree) == _keys(jf, fixture_tree)
    assert _keys(ps, fixture_tree) == _keys(js, fixture_tree)
    # every shared rule is exercised, found and suppressed
    found = {k[0] for k in _keys(pf, fixture_tree)}
    assert found >= SHARED_AST | SHARED_DET | {
        "lock-order-cycle", "cross-thread-unguarded-write", "blocking-under-lock"}, found
    hushed = {k[0] for k in _keys(ps, fixture_tree)}
    assert hushed >= SHARED_AST | {"cross-thread-unguarded-write", "blocking-under-lock",
                                   "resume-uncaptured-field", "unsorted-scan"}, hushed


def test_the_blocking_sets_differ_only_in_their_device_forms(fixture_tree, fixture_results):
    """On the fixture, `.cpu()` under the lock is the port's finding alone;
    the common operations (.item(), socket send, time.sleep) are both's."""
    (jf, _), (pf, _) = fixture_results
    port_only = sorted({f.message.split(" inside")[0] for f in pf
                        if f.rule == "blocking-under-lock"}
                       - {f.message.split(" inside")[0] for f in jf
                          if f.rule == "blocking-under-lock"})
    assert port_only == [".cpu() (D2H sync)"]
    assert {".item() (D2H sync)", "socket send", "time.sleep"} <= COMMON_BLOCKING


def test_shared_rules_agree_on_the_jax_trees(jax_tree_results):
    (jf, js), (pf, ps) = jax_tree_results
    root = os.path.join(ROOT, "r2d2_tpu")
    assert _keys(pf, root) == _keys(jf, root)
    assert _keys(ps, root) == _keys(js, root)
    # the trees' own audited annotations are what both read: non-trivial
    assert len(_keys(js, root)) >= 15, _keys(js, root)
    assert {k[0] for k in _keys(js, root)} >= {
        "cross-thread-unguarded-write", "lock-discipline", "resume-uncaptured-field"}


def test_a_jax_drill_of_the_same_site_name_does_not_drill_the_port(tmp_path):
    """The sibling tests/ holds both packages' tests. A port site whose
    name only the JAX package's tests drill is undrilled here: the fixture
    registers "serve.reload", guards it, and ships the JAX package's own
    tests/test_chaos.py (which drills a site of that name). JAX's pass
    counts that file; the port's flags the site until a test that drives
    the port (test_torch_*.py, or a torch_*.py helper) names it."""
    site = "serve.reload"
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "pkgfaults.py").write_text(f'KNOWN_SITES = ("{site}",)\n')
    (pkg / "mod.py").write_text(f'def reload():\n    fault_point("{site}")\n')
    (tmp_path / "tests").mkdir()
    shutil.copy(os.path.join(ROOT, "tests", "test_chaos.py"), tmp_path / "tests")
    with open(tmp_path / "tests" / "test_chaos.py", encoding="utf-8") as fh:
        assert f'"{site}"' in fh.read()  # the JAX tests do drill the name
    assert jax_det.analyze_paths([str(pkg)])[0] == []
    findings, _ = determinism.analyze_paths([str(pkg)])
    assert [(f.rule, site in f.message) for f in findings] == [("chaos-undrilled-site", True)]
    (tmp_path / "tests" / "torch_drills.py").write_text(f'SITES = ("{site}",)\n')
    assert determinism.analyze_paths([str(pkg)])[0] == []


def test_the_port_is_clean_under_its_own_analyzer(capsys):
    """The tier-1 gate: no unsuppressed finding of any pass over the
    port, within a small share of the tier-1 budget."""
    t0 = time.perf_counter()
    rc = cli.main(["--concurrency", "--determinism"])
    elapsed = time.perf_counter() - t0
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.startswith("no findings")
    assert re.search(r"\((\d+) suppressed\)", out), out
    assert elapsed < 60.0, f"the analysis took {elapsed:.1f}s"


_ANNOTATION = re.compile(r"#\s*r2d2:\s*(.*)")
_WITH_REASON = re.compile(
    r"^(disable=[A-Za-z0-9_,-]+|guarded-by\([A-Za-z0-9_.,\s]+\))\s+\((.{8,})\)$"
    r"|^ephemeral\((.{8,})\)$")


def test_every_annotation_in_the_port_carries_a_reason():
    """`# r2d2: disable=<rule>  (<reason>)`, `# r2d2: guarded-by(<lock>)
    (<reason>)` or `# r2d2: ephemeral(<reason>)`: no annotation in the port
    is left without its reason in place."""
    seen = 0
    for path in ast_rules.collect_py_files([PKG_DIR]):
        if os.sep + "analysis" + os.sep in path:
            continue  # the analyzer's own docs show the syntax
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _ANNOTATION.search(tok.string)
            if not m:
                continue
            seen += 1
            assert _WITH_REASON.match(m.group(1).strip()), (
                f"{os.path.relpath(path, ROOT)}:{tok.start[0]}: {tok.string}")
    assert seen >= 30
