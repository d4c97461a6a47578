"""The port's interprocedural passes (r2d2_tpu_torch/analysis/concurrency.py
and determinism.py): tests/test_analysis.py's concurrency and determinism
cases mirrored on small fixture packages, in torch's forms where the port's
rules take them — the blocking set (`.item()`, `.cpu()`, `.tolist()`,
`.numpy()`, `.cuda()`, `.to(<cuda device>)`, the synchronizes), executor
workers as thread roots, torch's seed sinks and unseeded draws — and the
chaos pass counting only the tests that drive the port. Stdlib-only under
test: no jax (the chaos case against JAX's analyzer is in
test_torch_analysis_parity.py)."""

from __future__ import annotations

import os
import textwrap

import torch

from r2d2_tpu_torch.analysis import concurrency, determinism
from r2d2_tpu_torch.analysis.findings import Finding, render_sarif, render_text

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "r2d2_tpu_torch")


def rules_of(findings):
    return sorted({f.rule for f in findings})


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return str(p)


def conc(tmp_path, files):
    for name, src in files.items():
        _write(tmp_path, name, src)
    return concurrency.analyze_paths([str(tmp_path)])


def det(tmp_path, files):
    for name, src in files.items():
        _write(tmp_path, name, src)
    return determinism.analyze_paths([str(tmp_path)])


# -------------------------------------------------------- concurrency pass

CYCLIC = """
import threading
class S:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
    def fwd(self):
        with self._a:
            with self._b:
                pass
    def rev(self):
        with self._b:
            with self._a:
                pass
"""


def test_lock_order_cycle_fires_and_consistent_order_clean(tmp_path):
    findings, _ = conc(tmp_path / "pos", {"mod.py": CYCLIC})
    assert rules_of(findings) == ["lock-order-cycle"]
    assert "S._a" in findings[0].message and "S._b" in findings[0].message
    consistent = CYCLIC.replace("with self._b:\n            with self._a:",
                                "with self._a:\n            with self._b:")
    assert consistent != CYCLIC
    assert conc(tmp_path / "neg", {"mod.py": consistent})[0] == []


def test_nonreentrant_reacquire_is_deadlock_rlock_is_not(tmp_path):
    src = """
    import threading
    class T:
        def __init__(self):
            self._lock = threading.Lock()
        def _helper(self):
            with self._lock:
                pass
        def run(self):
            with self._lock:
                self._helper()
    """
    findings, _ = conc(tmp_path / "pos", {"mod.py": src})
    assert rules_of(findings) == ["lock-order-cycle"]
    assert "non-reentrant" in findings[0].message
    rl = src.replace("threading.Lock()", "threading.RLock()")
    assert conc(tmp_path / "neg", {"mod.py": rl})[0] == []


RACY = """
import threading
class W:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
    def _loop(self):
        while True:
            self.count += 1
    def bump(self):
        self.count += 1
"""


def test_cross_thread_unguarded_write_fires(tmp_path):
    findings, _ = conc(tmp_path, {"mod.py": RACY})
    assert rules_of(findings) == ["cross-thread-unguarded-write"]
    assert all(f.severity == "error" for f in findings)
    assert "W.count" in findings[0].message and "2 thread roots" in findings[0].message


def test_cross_thread_write_clean_when_guarded_everywhere(tmp_path):
    src = RACY.replace("            self.count += 1", "            with self._lock:\n"
                       "                self.count += 1").replace(
        "    def bump(self):\n        self.count += 1",
        "    def bump(self):\n        with self._lock:\n            self.count += 1")
    assert conc(tmp_path, {"mod.py": src})[0] == []


def test_cross_thread_write_exempts_threadsafe_and_unthreaded(tmp_path):
    src = """
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor
    class Plumbing:
        def __init__(self):
            self._q = queue.Queue()
            self._stop = threading.Event()
            self._pool = ThreadPoolExecutor(2)
            self._t = threading.Thread(target=self._loop, daemon=True)
            self._lock = threading.Lock()
        def _loop(self):
            self._q.put(1)
        def close(self):
            self._stop.set()
            self._pool.shutdown(wait=False)
    class PlainCounter:
        def fail(self):
            self.failures = getattr(self, "failures", 0) + 1
        def reset(self):
            self.failures = 0
    """
    assert conc(tmp_path, {"mod.py": src})[0] == []


def test_guarded_by_def_annotation_asserts_contract(tmp_path):
    clean = """
    import threading
    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self._t = threading.Thread(target=self._loop, daemon=True)
        def _loop(self):
            with self._lock:
                self._bump()
        # r2d2: guarded-by(_lock)
        def _bump(self):
            self.count += 1
        def bump(self):
            with self._lock:
                self._bump()
    """
    assert conc(tmp_path / "clean", {"mod.py": clean})[0] == []
    checked = clean.replace(
        "def _bump(self):\n            self.count += 1",
        "def _bump(self):\n            with self._lock:\n"
        "                self.count += 1",
    )
    assert "lock-order-cycle" in rules_of(conc(tmp_path / "checked", {"mod.py": checked})[0])


def test_guarded_by_write_line_annotation(tmp_path):
    src = """
    import threading
    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self._t = threading.Thread(target=self._loop, daemon=True)
        def _loop(self):
            with self._lock:
                self.count += 1
        def external(self):
            self.count += 1  # r2d2: guarded-by(_lock)
    """
    assert conc(tmp_path, {"mod.py": src})[0] == []


def test_blocking_under_lock_fires_direct_and_interprocedural(tmp_path):
    src = """
    import threading
    import time
    class B:
        def __init__(self):
            self._lock = threading.Lock()
        def slow(self):
            with self._lock:
                time.sleep(1.0)
        def outer(self):
            with self._lock:
                self._inner()
        def _inner(self):
            time.sleep(0.1)
    """
    findings, _ = conc(tmp_path, {"mod.py": src})
    assert rules_of(findings) == ["blocking-under-lock"]
    assert len(findings) == 2 and all(f.severity == "warning" for f in findings)
    inner = [f for f in findings if "_inner" in f.message]
    assert inner and "caller-holds-lock contract" in inner[0].message


def test_blocking_under_lock_takes_the_torch_forms(tmp_path):
    src = """
    import threading
    import torch
    class B:
        def __init__(self):
            self._lock = threading.Lock()
        def read(self, x, ev, stream):
            with self._lock:
                a = x.item()
                b = x.cpu()
                c = x.tolist()
                d = x.numpy()
                e = x.cuda()
                f = x.to("cuda:0")
                g = x.to(device=torch.device("cuda"))
                torch.cuda.synchronize()
                ev.synchronize()
                stream.synchronize()
        def host_only(self, x, dev):
            with self._lock:
                y = x.to(dev)
                z = x.to(torch.float32)
                w = x.to("cpu")
    """
    findings, _ = conc(tmp_path, {"mod.py": src})
    assert rules_of(findings) == ["blocking-under-lock"]
    labels = sorted(f.message.split(" inside")[0] for f in findings)
    assert len(findings) == 10, labels
    assert all(f.line < 19 for f in findings)  # host_only stays clean
    assert any(label.startswith(".to(<cuda device>)") for label in labels)


def test_blocking_outside_lock_clean(tmp_path):
    src = """
    import threading
    import time
    class B:
        def __init__(self):
            self._lock = threading.Lock()
        def ok(self, x):
            with self._lock:
                n = 1
            time.sleep(0.1)
            return n, x.item()
    """
    assert conc(tmp_path, {"mod.py": src})[0] == []


def test_concurrency_suppression_in_place(tmp_path):
    src = RACY.replace(
        "        while True:\n            self.count += 1",
        "        while True:\n            self.count += 1"
        "  # r2d2: disable=cross-thread-unguarded-write").replace(
        "    def bump(self):\n        self.count += 1",
        "    def bump(self):\n        # r2d2: disable=cross-thread-unguarded-write\n"
        "        self.count += 1")
    findings, suppressed = conc(tmp_path, {"mod.py": src})
    assert findings == []
    assert {f.rule for f in suppressed} == {"cross-thread-unguarded-write"}


POOLED = """
import threading
from concurrent.futures import ThreadPoolExecutor
class Pool:
    def __init__(self, envs):
        self.envs = list(envs)
        self.steps = 0
        self._pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="work")
    def _one(self, env):
        self.steps += 1
        return env
    def step(self):
        self.steps += 1
        return list(self._pool.map(self._one, self.envs))
def local_pool(items, sink):
    with ThreadPoolExecutor(2) as ex:
        ex.submit(sink.push, items)
    ex2 = ThreadPoolExecutor(1)
    ex2.submit(lambda: sink.push(items))
"""


def test_executor_bodies_are_thread_roots(tmp_path):
    """A ThreadPoolExecutor's .map/.submit body runs on the pool's workers:
    a root of kind "pool" (named by thread_name_prefix), for a pool held
    on self, bound by `with ... as`, or bound to a local; a write from the
    body that races the submitting thread is flagged."""
    _write(tmp_path, "mod.py", POOLED)
    roots = [r for r in concurrency.thread_roots([str(tmp_path)]) if r.kind == "pool"]
    assert [(r.name, r.line) for r in roots] == [("work", 14), ("", 17), ("", 19)]
    assert roots[0].entries == ((str(tmp_path / "mod.py"), "Pool", "_one"),)
    findings, _ = concurrency.analyze_paths([str(tmp_path)])
    assert rules_of(findings) == ["cross-thread-unguarded-write"]
    assert {f.line for f in findings} == {10, 13}
    assert all("Pool.steps" in f.message and "pool:" in f.message for f in findings)
    # map over a plain list, or submit on a non-executor, is no root
    plain = POOLED.replace("ThreadPoolExecutor(max_workers=2, thread_name_prefix=\"work\")",
                           "[]").replace("self._pool.map(", "map(")
    _write(tmp_path / "plain", "mod.py", plain)
    assert [r.line for r in concurrency.thread_roots([str(tmp_path / "plain")])
            if r.kind == "pool"] == [17, 19]


def test_thread_root_inventory_of_the_port():
    """The inventory covers every thread the port starts: raw Thread
    constructions, supervision spawn sites, the env pool's executor, the
    socketserver handler, and the synthetic main root — and the env pool
    root is clean under the pass."""
    roots = concurrency.thread_roots([PKG_DIR])
    assert {"thread", "spawn", "pool", "handler", "main"} <= {r.kind for r in roots}
    spawn_names = {r.name for r in roots if r.kind == "spawn"}
    for name in ("ckpt-watcher-multi", "degrade-controller", "liveloop-tap",
                 "liveloop-ingest", "serve-loop", "serve-complete", "autoscaler",
                 "transport-publish", "transport-ingest", "actor", "sampler"):
        assert name in spawn_names, (name, sorted(spawn_names))
    pools = [r for r in roots if r.kind == "pool"]
    assert pools and {r.name for r in pools} == {"envpool"}
    assert all(os.path.relpath(r.path, PKG_DIR) == "actor.py" for r in pools)
    assert any(e[1:] == ("HostEnvPool", "_step_one") for r in pools for e in r.entries)
    paths = {os.path.relpath(r.path, PKG_DIR) for r in roots if r.path}
    for mod in ("serve/server.py", "serve/multi.py", "serve/client.py",
                "serve/scenarios.py", "serve/autoscale.py", "liveloop/loop.py",
                "utils/supervision.py", "replay/tiered_store.py", "train.py",
                "actor.py", "transport/publisher.py"):
        assert mod in paths, f"no thread root found in {mod}"


def test_seeded_mutation_trips_concurrency_gate(tmp_path):
    """Delete ONE lock acquisition from the port's serve/state_cache.py
    (the assign fast path) inside a fixture package that drives the cache
    from two thread roots — the gate must trip; the unmutated copy is
    clean."""
    with open(os.path.join(PKG_DIR, "serve", "state_cache.py"), encoding="utf-8") as fh:
        real = fh.read()
    driver = """
    import threading

    from cachemod import RecurrentStateCache

    class Driver:
        def __init__(self):
            self.cache = RecurrentStateCache(4, 8)
            self._thread = threading.Thread(target=self._loop, daemon=True)
        def _loop(self):
            while True:
                self.cache.assign(["s"])
        def evict(self, sid):
            self.cache.evict(sid)
    """
    intact = tmp_path / "intact"
    _write(intact, "cachemod.py", real)
    _write(intact, "driver.py", driver)
    findings, _ = concurrency.analyze_paths([str(intact)])
    assert findings == [], render_text(findings)
    i = real.index("def assign")
    j = real.index("with self._lock:", i)
    mutated = real[:j] + "if True:" + real[j + len("with self._lock:"):]
    broken = tmp_path / "mutated"
    _write(broken, "cachemod.py", mutated)
    _write(broken, "driver.py", driver)
    findings, _ = concurrency.analyze_paths([str(broken)])
    assert "cross-thread-unguarded-write" in rules_of(findings)
    assert any("cachemod.py" in f.path for f in findings)


# -------------------------------------------------------- determinism pass

ACC = """
class Acc:
    def __init__(self):
        self.total = 0.0
        self.n = 0
    def add(self, x):
        self.total += x
        self.n += 1
    def carry_state(self):
        return {"total": self.total, "n": self.n}
    def restore_carry(self, d):
        self.total = d["total"]
        self.n = d["n"]
"""


def test_resume_complete_class_is_clean_and_uncaptured_fires(tmp_path):
    assert det(tmp_path / "ok", {"mod.py": ACC})[0] == []
    uncaptured = ACC.replace('"total": self.total, "n": self.n', '"total": self.total')
    findings, _ = det(tmp_path / "pos", {"mod.py": uncaptured})
    assert rules_of(findings) == ["resume-uncaptured-field"]
    assert "Acc.n" in findings[0].message


def test_unrestored_field_fires(tmp_path):
    src = ACC.replace('        self.n = d["n"]\n', "")
    findings, _ = det(tmp_path, {"mod.py": src})
    assert rules_of(findings) == ["resume-unrestored-field"]
    assert "Acc.n" in findings[0].message


def test_unpack_and_subscript_mutations_inventoried(tmp_path):
    src = """
    class C:
        def __init__(self):
            self.a = 0
            self.b = 0
            self.d = {}
        def step(self, f):
            (self.a, self.b) = f()
            self.d["k"] = self.a
        def capture_pending(self):
            return {"a": self.a}
        def restore_pending(self, d):
            self.a = d["a"]
    """
    findings, _ = det(tmp_path, {"mod.py": src})
    assert rules_of(findings) == ["resume-uncaptured-field"]
    assert {f.message.split(" ")[0] for f in findings} == {"C.b", "C.d"}


def test_ephemeral_exempts_and_is_inventoried(tmp_path):
    src = """
    class Tap:
        def __init__(self):
            self.blocks = []
            # r2d2: ephemeral(monitoring counter; restarts at 0 on resume)
            self.emitted = 0
        def push(self, b):
            self.blocks.append(b)
            self.blocks = self.blocks[-4:]
            self.emitted += 1
        def carry_state(self):
            return {"blocks": list(self.blocks)}
        def restore_carry(self, d):
            self.blocks = list(d["blocks"])
    """
    findings, suppressed = det(tmp_path, {"mod.py": src})
    assert findings == [], render_text(findings)
    assert [f.rule for f in suppressed] == ["resume-uncaptured-field"]
    assert "Tap.emitted" in suppressed[0].message


def test_bad_ephemeral_annotations_flagged(tmp_path):
    empty = """
    class S:
        def __init__(self):
            # r2d2: ephemeral()
            self.n = 0
        def bump(self):
            self.n += 1
        def carry_state(self):
            return {}
        def restore_carry(self, d):
            pass
    """
    findings, _ = det(tmp_path / "empty", {"mod.py": empty})
    assert rules_of(findings) == ["bad-ephemeral-annotation"]
    assert "empty reason" in findings[0].message
    stray = '''
    """Docs may mention # r2d2: ephemeral(x) without it being an annotation."""
    class P:
        def carry_state(self):
            return {}
        def restore_carry(self, d):
            pass
        def go(self):
            # r2d2: ephemeral(this line assigns no attribute)
            y = 1
            return y
    '''
    findings, _ = det(tmp_path / "stray", {"mod.py": stray})
    assert rules_of(findings) == ["bad-ephemeral-annotation"]
    assert len(findings) == 1 and "attaches to no" in findings[0].message


def test_wallclock_taint_into_torch_seed_sinks_and_audit_allowlist(tmp_path):
    hot = """
    import time
    import numpy as np
    import torch
    from blocks import Block
    def derive(sock, device):
        t = time.time()
        g = torch.Generator(device=device).manual_seed(int(t))
        torch.manual_seed(time.time_ns())
        rng = np.random.default_rng(int(time.monotonic()))
        sock.send(seq=time.time())
        return g, rng, Block(obs=time.time())
    """
    findings, _ = det(tmp_path / "pos", {"mod.py": hot})
    assert rules_of(findings) == ["nondet-taint"]
    # two manual_seed inputs, the default_rng input, the seq kwarg, the Block field
    assert len(findings) == 5
    assert sum("seed input" in f.message for f in findings) == 3
    ok = """
    import time
    from blocks import Block
    def stamp(sock):
        return Block(t_serve=time.time(), lag_stamp=time.time())
    """
    assert det(tmp_path / "neg", {"mod.py": ok})[0] == []


def test_wallclock_taint_interprocedural(tmp_path):
    ret = """
    import time
    import torch
    def now():
        return time.time()
    def derive(g):
        return g.manual_seed(int(now()))
    """
    assert rules_of(det(tmp_path / "ret", {"mod.py": ret})[0]) == ["nondet-taint"]
    param = """
    import time
    class S:
        def __init__(self):
            self.mark = 0.0
        def _set(self, v):
            self.mark = v
        def tick(self):
            self._set(time.time())
        def bump(self):
            self._set(self.mark + 1.0)
        def carry_state(self):
            return {"mark": self.mark}
        def restore_carry(self, d):
            self.mark = d["mark"]
    """
    findings, _ = det(tmp_path / "param", {"mod.py": param})
    assert rules_of(findings) == ["nondet-taint"]
    assert len(findings) == 1 and "via _set" in findings[0].message


def test_unsorted_scan_and_unseeded_random(tmp_path):
    pos = """
    import glob
    import os
    import numpy as np
    import torch
    def spool(d, n):
        names = [x for x in os.listdir(d)]
        files = glob.glob(d + "/*.npz")
        g = torch.Generator()
        return (names, files, np.random.uniform(), torch.rand(n), torch.randint(0, 4, (n,)),
                torch.randperm(n), torch.multinomial(torch.ones(n), 1), torch.randn(n), g)
    """
    findings, _ = det(tmp_path / "pos", {"mod.py": pos})
    assert rules_of(findings) == ["unseeded-random", "unsorted-scan"]
    # listdir, glob; np.random.uniform, rand, randint, randperm, multinomial,
    # randn, and the never-seeded Generator
    assert len(findings) == 9
    neg = """
    import glob
    import os
    import numpy as np
    import torch
    def spool(d, n, rng, seed):
        names = sorted(os.listdir(d))
        files = sorted(glob.glob(d + "/*.npz"))
        gen = np.random.default_rng(0)
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        h = torch.Generator().manual_seed(seed)
        return (names, files, gen.uniform(), rng.normal(), torch.rand(n, generator=g),
                torch.randint(0, 4, (n,), generator=h))
    """
    findings, _ = det(tmp_path / "neg", {"mod.py": neg})
    assert findings == [], render_text(findings)


def test_set_iteration_and_id_keys(tmp_path):
    pos = """
    def evict(server, trace, cache, obj):
        for sid in {ev.session for ev in trace}:
            server.evict(sid)
        cache[id(obj)] = 1
        return {id(obj): 2}
    """
    findings, _ = det(tmp_path / "pos", {"mod.py": pos})
    assert rules_of(findings) == ["nondet-taint"] and len(findings) == 3
    neg = """
    def evict(server, trace):
        for sid in sorted({ev.session for ev in trace}):
            server.evict(sid)
    """
    assert det(tmp_path / "neg", {"mod.py": neg})[0] == []


CHAOS_FAULTS = """
KNOWN_SITES = (
    "alpha.load",
    "beta.save",
    "gamma.send",
)
def fault_point(site):
    pass
"""
CHAOS_MOD = """
from pkgfaults import fault_point
def load():
    fault_point("alpha.load")
def send():
    fault_point("gamma.send")
    fault_point("delta.recv")
"""


def test_chaos_coverage_fixture(tmp_path):
    _write(tmp_path, "pkg/pkgfaults.py", CHAOS_FAULTS)
    _write(tmp_path, "pkg/mod.py", CHAOS_MOD)
    _write(tmp_path, "tests/test_torch_drill.py", """
    def test_drill():
        for site in ("alpha.load", "gamma.send"):
            assert site
    """)
    findings, _ = determinism.analyze_paths([str(tmp_path / "pkg")])
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    assert sorted(by_rule) == [
        "chaos-undrilled-site", "chaos-unguarded-site", "chaos-unregistered-site",
    ]
    assert "beta.save" in by_rule["chaos-unguarded-site"][0].message
    assert "beta.save" in by_rule["chaos-undrilled-site"][0].message
    assert "delta.recv" in by_rule["chaos-unregistered-site"][0].message
    assert by_rule["chaos-unguarded-site"][0].path.endswith("pkgfaults.py")
    assert by_rule["chaos-unregistered-site"][0].path.endswith("mod.py")


def test_determinism_sarif_rule_indices_stable():
    fs = [
        Finding("unsorted-scan", "warning", "a.py", 1, 0, "m"),
        Finding("nondet-taint", "error", "b.py", 1, 0, "m"),
        Finding("chaos-undrilled-site", "error", "c.py", 1, 0, "m"),
    ]
    import json

    rules = [r["id"] for r in json.loads(render_sarif(fs))["runs"][0]["tool"]["driver"]["rules"]]
    assert rules == sorted(rules) and set(rules) <= set(determinism.ALL_RULES)


def test_seeded_mutation_trips_determinism_gate(tmp_path):
    """Delete ONE field ("sum_reward") from the port's SequenceAccumulator
    carry_state inside a fixture copy — the gate must trip; the unmutated
    copy is clean."""
    with open(os.path.join(PKG_DIR, "replay", "accumulator.py"), encoding="utf-8") as fh:
        real = fh.read()
    _write(tmp_path / "intact", "acc.py", real)
    findings, _ = determinism.analyze_paths([str(tmp_path / "intact")])
    assert findings == [], render_text(findings)
    dropped = '"sum_reward": np.asarray(self.sum_reward, np.float64),'
    assert dropped in real
    _write(tmp_path / "mutated", "acc.py", real.replace(dropped, ""))
    findings, _ = determinism.analyze_paths([str(tmp_path / "mutated")])
    assert "resume-uncaptured-field" in rules_of(findings)
    assert any("sum_reward" in f.message for f in findings)
