"""Determinism & resume-completeness analysis: the bit-exact invariant,
statically (port of r2d2_tpu/analysis/determinism.py; torch's seed sinks
and random draws, and only the port's own tests count as drills).

Every plane since the preemption work rests on one invariant — kill-and-
resume is bit-identical — but the dynamic chaos drills only catch the
state they happen to exercise: a mutable attribute silently missing from
`carry_state`/`capture_pending`, or a wall-clock value leaking into a
stored Block field, ships green until a drill hits it. This pass proves
the invariant's static half over the same package-wide AST program the
concurrency pass builds, with three rule families:

1. **Resume completeness** — every class on the snapshot path (anything
   defining `carry_state`/`capture_pending`/`restore_carry`/
   `restore_pending`) gets its mutable `self.*` attributes inventoried:
   any attribute assigned outside `__init__` and the carry/restore
   methods themselves must be captured by a carry method, reconstructed
   by a restore method, or annotated `# r2d2: ephemeral(<reason>)` at one
   of its assignment sites (`resume-uncaptured-field`,
   `resume-unrestored-field`). The annotation has the same audited-
   contract semantics as `guarded-by`: an empty reason, or an annotation
   that attaches to no such attribute, is itself an error
   (`bad-ephemeral-annotation`), and exempted attributes surface in the
   suppressed list so the exemption inventory stays visible.

2. **Nondeterminism taint** — wall-clock reads (`time.time`,
   `perf_counter`, `monotonic`, `datetime.now`) are taint sources; the
   taint flows through local assignments and interprocedurally through
   same-module/self-method calls (return-value summaries + param-to-sink
   summaries on the call graph) into deterministic sinks: seed inputs
   (`torch.Generator(...).manual_seed(...)`, `torch.manual_seed(...)`,
   `np.random.default_rng(...)`; the JAX package's sink is `fold_in`),
   `Block(...)` constructor fields, transport `seq`/`priority`
   values, resume-scoped `self.*` stores, and snapshot-payload dict
   entries inside carry methods (`nondet-taint`). Wall-clock is
   explicitly ALLOWED into audit/metrics destinations — a sink whose
   name says it is a stamp (`t_serve`, `*_stamp`, lag/skew/stats/metric/
   elapsed/latency/heartbeat/…) never fires; that allowlist is the
   audit-sink classification. Unsorted directory scans (`os.listdir`,
   `glob.glob`, `.iterdir`) not wrapped directly in `sorted(...)` are
   flagged at the call (`unsorted-scan`); module-level `random.*`/
   `np.random.*` draws outside an explicit seeded Generator, torch's
   `torch.rand*` / `randint` / `randperm` / `multinomial` / `normal` /
   `bernoulli` / `poisson` without `generator=` (the process-global torch
   stream), and a `torch.Generator(...)` that is never seeded are flagged
   (`unseeded-random`); and set iteration / `id()`-keyed mappings are
   direct `nondet-taint` findings — iteration order varies per process,
   `id()` varies per run.

3. **Chaos coverage** — the `KNOWN_SITES` registry is cross-checked both
   ways: every registered site must have a literal `fault_point(...)`/
   `with_retries(...)` guard in the scanned package
   (`chaos-unguarded-site`) and must appear as a site literal in the
   sibling test tree, i.e. actually be drilled (`chaos-undrilled-site`).
   That tree holds both packages' tests, so only the files that drive
   the port count: `tests/test_torch_*.py` and the `tests/torch_*.py`
   helpers (a JAX drill of a site of the same name drills nothing here);
   a guard whose literal site is not registered is dead chaos surface
   (`chaos-unregistered-site`). When no scanned module defines
   KNOWN_SITES the family is silent, so fixture packages opt in by
   shipping their own registry.

Resolution is deliberately strict (same-module functions and `self`
methods only; unresolved calls are skipped) — under-approximating the
call graph keeps the repo-wide zero-findings gate honest: every finding
is a determinism hazard worth fixing or annotating, not noise.
Suppression uses the shared machinery: `# r2d2: disable=<rule>` routes a
finding to the suppressed list, `# r2d2: ephemeral(<reason>)` documents
a deliberately rebuilt-not-restored attribute in place.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

from r2d2_tpu_torch.analysis import ast_rules
from r2d2_tpu_torch.analysis.findings import Finding, stable_sort

ALL_RULES = (
    "resume-uncaptured-field",
    "resume-unrestored-field",
    "bad-ephemeral-annotation",
    "nondet-taint",
    "unsorted-scan",
    "unseeded-random",
    "chaos-unguarded-site",
    "chaos-undrilled-site",
    "chaos-unregistered-site",
)

# methods that define the snapshot path: a class with any of these is
# resume-scoped and its mutable attribute inventory is checked
CARRY_METHODS = frozenset({"carry_state", "capture_pending"})
RESTORE_METHODS = frozenset({"restore_carry", "restore_pending"})

_EPHEMERAL_RE = re.compile(r"#\s*r2d2:\s*ephemeral\(([^)]*)\)")

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}

# directory scans whose OS-dependent order must not feed recovery paths
_SCAN_CALLS = {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}

_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.")
# constructors/plumbing on the random modules that are fine: explicit
# seeded generators ARE the discipline the rule enforces
_RANDOM_SEEDED_OK = {
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "MT19937", "RandomState", "Random", "seed", "getstate", "setstate",
    "set_state", "get_state", "bit_generator",
}

# torch's draws from the process-global stream unless given generator=
_TORCH_DRAWS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "multinomial", "normal", "bernoulli", "poisson",
}
_TORCH_PREFIXES = ("torch.",)
# the calls that seed a torch.Generator (the seed-input sinks too)
_SEEDERS = ("manual_seed", "set_state")
# seed inputs: a wall-clock value here seeds a different stream every run
_SEED_SINKS = ("manual_seed", "default_rng")

# the sibling test tree's files that drive the port (helpers included)
_PORT_TEST_PREFIXES = ("test_torch_", "torch_")

# call kwargs that order/identify stored data: a wall-clock seq or
# priority diverges across runs
_DET_KWARGS = ("seq", "priority", "priorities")

# the audit-sink classification: destinations whose NAME says they are
# wall-clock stamps (serve-time stamps, lag/skew telemetry, stats and
# metrics payloads) are allowed — they are observability, not replayed
# state, and the resume fingerprint never covers them
_AUDIT_NAME_RE = re.compile(
    r"time|stamp|lag|skew|audit|stats|metric|elapsed|deadline|timeout|"
    r"backoff|clock|wall|latency|heartbeat|age|t_serve"
)

_SITE_RE = re.compile(r"^[A-Za-z0-9_]+\.[A-Za-z0-9_]+$")

FuncId = Tuple[str, str, str]  # (path, class name or "", function name)


def _is_audit_name(name: Optional[str]) -> bool:
    return bool(name) and bool(_AUDIT_NAME_RE.search(str(name)))


def _dotted(node: ast.AST) -> Optional[str]:
    return ast_rules._dotted(node)


def ephemeral_comments(
    text: str,
) -> List[Tuple[int, str, Tuple[int, ...]]]:
    """All `# r2d2: ephemeral(<reason>)` annotations in one file:
    (comment line, reason, covered lines). Placement rules match the
    disable/guarded-by machinery: a trailing comment covers its own line,
    a comment-only line covers itself and the line below. Annotations are
    a checked contract (a non-attaching one is an error), so real COMMENT
    tokens are required — a docstring merely mentioning the syntax is not
    an annotation."""
    out: List[Tuple[int, str, Tuple[int, ...]]] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _EPHEMERAL_RE.search(tok.string)
        if not m:
            continue
        row, col = tok.start
        line = text.splitlines()[row - 1] if row else ""
        comment_only = not line[:col].strip()
        targets = (row, row + 1) if comment_only else (row,)
        out.append((row, m.group(1).strip(), targets))
    return out


@dataclasses.dataclass
class _Module:
    path: str
    tree: ast.Module
    src_lines: List[str]
    suppress: Dict[int, Set[str]]
    # covered line -> ephemeral reason
    ephemeral: Dict[int, str] = dataclasses.field(default_factory=dict)
    eph_comments: List[Tuple[int, str, Tuple[int, ...]]] = \
        dataclasses.field(default_factory=list)
    # lines where an ephemeral target actually attached to an attribute
    attached: Set[int] = dataclasses.field(default_factory=set)
    funcs: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ast.ClassDef] = dataclasses.field(default_factory=dict)
    # whether ANY wall-clock call occurs in this module: taint never
    # crosses modules (call resolution is same-module only), so a module
    # without one can be skipped by the whole taint machinery — its
    # summaries are provably all-clean
    has_wall: bool = False


@dataclasses.dataclass
class _ResumeClass:
    path: str
    name: str
    carry: List[ast.AST]
    restore: List[ast.AST]
    # attr -> earliest mutation site outside __init__/carry/restore
    mutations: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    ephemeral: Dict[str, str] = dataclasses.field(default_factory=dict)
    captured: Set[str] = dataclasses.field(default_factory=set)
    restored: Set[str] = dataclasses.field(default_factory=set)

    @property
    def carry_names(self) -> str:
        return "/".join(sorted(f.name for f in self.carry)) or "<no carry method>"

    @property
    def restore_names(self) -> str:
        return "/".join(sorted(f.name for f in self.restore)) or "<no restore method>"


@dataclasses.dataclass
class _TaintSummary:
    ret_wall: bool = False
    # param index (self included at 0 for methods) -> sink description
    sink_params: Dict[int, str] = dataclasses.field(default_factory=dict)


def _self_attr_stores(root: ast.AST) -> List[Tuple[str, int, int]]:
    """Every `self.X` assignment target under `root`: plain assigns,
    augmented/annotated assigns, tuple/list unpacking (the collector's
    `(..., self.env_state, self.key) = ...` idiom), subscript stores
    (`self.d[k] = v` mutates d), for-targets, and deletes."""
    out: List[Tuple[str, int, int]] = []

    def collect(t: ast.AST) -> None:
        if isinstance(t, ast.Attribute):
            if isinstance(t.value, ast.Name) and t.value.id == "self":
                out.append((t.attr, t.lineno, t.col_offset))
        elif isinstance(t, ast.Subscript):
            collect(t.value)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)
        elif isinstance(t, ast.Starred):
            collect(t.value)

    for node in ast.walk(root):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                collect(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            collect(node.target)
        elif isinstance(node, ast.For):
            collect(node.target)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                collect(t)
    return out


def _self_attrs_used(root: ast.AST) -> Set[str]:
    """Every attribute read or written through `self` under `root` —
    occurrence in a carry/restore method is what counts as captured/
    reconstructed (a restore may rebuild a field by mutating it in place,
    e.g. `self.rng.bit_generator.state = ...`)."""
    out: Set[str] = set()
    for node in ast.walk(root):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            out.add(node.attr)
    return out


def _name_targets(t: ast.AST) -> List[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in t.elts:
            out.extend(_name_targets(e))
        return out
    if isinstance(t, ast.Starred):
        return _name_targets(t.value)
    return []


class _Program:
    """The package-wide AST program: modules, classes, functions, the
    resume-scoped class inventory, and the taint summaries."""

    def __init__(self) -> None:
        self.modules: Dict[str, _Module] = {}
        self.funcs: Dict[FuncId, ast.AST] = {}
        self.resume: Dict[Tuple[str, str], _ResumeClass] = {}
        self.summaries: Dict[FuncId, _TaintSummary] = {}

    # ------------------------------------------------------------- loading

    def load(self, files: Iterable[str]) -> None:
        for path in files:
            try:
                with open(path, encoding="utf-8") as fh:
                    text = fh.read()
                tree = ast.parse(text)
            except (OSError, SyntaxError):
                continue  # ast_rules reports the parse failure
            src_lines = text.splitlines()
            mod = _Module(
                path=path,
                tree=tree,
                src_lines=src_lines,
                suppress=ast_rules._suppressions(src_lines),
                eph_comments=ephemeral_comments(text),
                has_wall=any(
                    isinstance(n, ast.Call)
                    and _dotted(n.func) in _WALLCLOCK_CALLS
                    for n in ast.walk(tree)
                ),
            )
            for _cline, reason, targets in mod.eph_comments:
                for t in targets:
                    mod.ephemeral.setdefault(t, reason)
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mod.funcs[node.name] = node
                    self.funcs[(path, "", node.name)] = node
                elif isinstance(node, ast.ClassDef):
                    mod.classes[node.name] = node
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            self.funcs[(path, node.name, item.name)] = item
            self.modules[path] = mod
        for path in sorted(self.modules):
            mod = self.modules[path]
            for cname, cnode in sorted(mod.classes.items()):
                rc = self._scan_resume_class(mod, cnode)
                if rc is not None:
                    self.resume[(path, cname)] = rc

    def _scan_resume_class(
        self, mod: _Module, cnode: ast.ClassDef
    ) -> Optional[_ResumeClass]:
        methods = {
            n.name: n
            for n in cnode.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        carry = [methods[m] for m in sorted(CARRY_METHODS & set(methods))]
        restore = [methods[m] for m in sorted(RESTORE_METHODS & set(methods))]
        if not carry and not restore:
            return None
        rc = _ResumeClass(path=mod.path, name=cnode.name, carry=carry,
                          restore=restore)
        exempt = {"__init__"} | CARRY_METHODS | RESTORE_METHODS
        for mname, m in methods.items():
            for attr, line, col in _self_attr_stores(m):
                reason = mod.ephemeral.get(line)
                if reason is not None:
                    rc.ephemeral.setdefault(attr, reason)
                    mod.attached.add(line)
                if mname in exempt:
                    continue
                prev = rc.mutations.get(attr)
                if prev is None or (line, col) < prev:
                    rc.mutations[attr] = (line, col)
        for f in carry:
            rc.captured |= _self_attrs_used(f)
        for f in restore:
            rc.restored |= _self_attrs_used(f)
        return rc

    # ---------------------------------------------------- taint machinery

    def _resolve(
        self, mod: _Module, cls: str, call: ast.Call
    ) -> Tuple[Optional[FuncId], int]:
        """Strict callee resolution: same-module functions and `self`
        methods only. Returns (callee, positional offset) — a self-method
        call's positional arg j binds param j+1 (self sits at 0)."""
        f = call.func
        if isinstance(f, ast.Name) and f.id in mod.funcs:
            return (mod.path, "", f.id), 0
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and cls
            and (mod.path, cls, f.attr) in self.funcs
        ):
            return (mod.path, cls, f.attr), 1
        return None, 0

    def _expr_tokens(
        self, e: ast.AST, env: Dict[str, Set], mod: _Module, cls: str
    ) -> Set:
        """Taint tokens of one expression: "wall" for wall-clock reach,
        ("p", i) for values derived from param i."""
        toks: Set = set()
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in _WALLCLOCK_CALLS:
                    toks.add("wall")
                else:
                    callee, _off = self._resolve(mod, cls, node)
                    if callee is not None and self.summaries.get(
                        callee, _TaintSummary()
                    ).ret_wall:
                        toks.add("wall")
            elif isinstance(node, ast.Name):
                toks |= env.get(node.id, set())
        return toks

    def _local_env(
        self, fn: ast.AST, mod: _Module, cls: str
    ) -> Dict[str, Set]:
        """Intraprocedural taint environment: params seed ("p", i) tokens,
        assignments propagate to fixpoint (bounded rounds cover
        loop-carried chains)."""
        env: Dict[str, Set] = {}
        args = fn.args
        names = [a.arg for a in args.posonlyargs + args.args]
        for i, n in enumerate(names):
            if n != "self":
                env[n] = {("p", i)}
        for _round in range(4):
            changed = False
            for node in ast.walk(fn):
                value: Optional[ast.AST] = None
                targets: List[str] = []
                if isinstance(node, ast.Assign):
                    value = node.value
                    for t in node.targets:
                        targets.extend(_name_targets(t))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    value = node.value
                    targets = _name_targets(node.target)
                if value is None or not targets:
                    continue
                toks = self._expr_tokens(value, env, mod, cls)
                if not toks:
                    continue
                for name in targets:
                    have = env.setdefault(name, set())
                    if toks - have:
                        have.update(toks)
                        changed = True
            if not changed:
                break
        return env

    def _function_sinks(
        self, fid: FuncId, fn: ast.AST, env: Dict[str, Set]
    ) -> List[Tuple[Set, str, int, int]]:
        """Every deterministic sink reached in `fn`, with the taint tokens
        flowing into it: (tokens, sink description, line, col). Audit-
        named destinations are dropped here — the allowlist IS the
        audit-sink classification."""
        path, cls, name = fid
        mod = self.modules[path]
        out: List[Tuple[Set, str, int, int]] = []

        def sink(e: ast.AST, desc: str, where: ast.AST) -> None:
            toks = self._expr_tokens(e, env, mod, cls)
            if toks:
                out.append((toks, desc, where.lineno, where.col_offset))

        in_carry = bool(cls) and name in CARRY_METHODS \
            and (path, cls) in self.resume
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                # the called name's last part, also on a call's result
                # (torch.Generator(...).manual_seed(...))
                leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else (_dotted(node.func) or ""))
                if leaf in _SEED_SINKS:
                    for arg in list(node.args) + [k.value for k in node.keywords]:
                        sink(arg, f"a {leaf} seed input (the derived "
                             "random stream diverges)", node)
                if leaf == "Block":
                    for j, arg in enumerate(node.args):
                        sink(arg, f"Block(...) positional field {j} "
                             "(stored replay data)", node)
                    for k in node.keywords:
                        if not _is_audit_name(k.arg):
                            sink(k.value, f"Block field '{k.arg}' "
                                 "(stored replay data)", node)
                for k in node.keywords:
                    if k.arg in _DET_KWARGS:
                        sink(k.value, f"'{k.arg}=' (orders/identifies "
                             "stored data)", node)
                callee, off = self._resolve(mod, cls, node)
                if callee is not None:
                    summ = self.summaries.get(callee)
                    if summ and summ.sink_params:
                        for j, arg in enumerate(node.args):
                            desc = summ.sink_params.get(j + off)
                            if desc is not None:
                                sink(arg, f"{desc} (via {callee[2]})", node)
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                value = node.value
                if value is None:
                    continue
                for t in tgts:
                    for attr, _l, _c in _self_attr_stores_of_target(t):
                        rc = self.resume.get((path, cls))
                        if rc is None or attr in rc.ephemeral \
                                or _is_audit_name(attr):
                            continue
                        sink(value, f"resume-scoped field {cls}.{attr} "
                             "(snapshotted state)", node)
                    if in_carry and isinstance(t, ast.Subscript) \
                            and isinstance(t.slice, ast.Constant) \
                            and isinstance(t.slice.value, str) \
                            and not _is_audit_name(t.slice.value):
                        sink(value, "snapshot payload entry "
                             f"'{t.slice.value}'", node)
            elif in_carry and isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (
                        isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        and not _is_audit_name(k.value)
                    ):
                        sink(v, f"snapshot payload entry '{k.value}'", node)
        return out

    def compute_summaries(self) -> None:
        """Interprocedural fixpoint over (ret_wall, sink_params): a
        function returning a wall-clock value taints its callers'
        expressions; a param reaching a sink makes every call site with a
        tainted arg at that index a finding site."""
        self.summaries = {fid: _TaintSummary() for fid in self.funcs}
        for _round in range(6):
            changed = False
            for fid in sorted(self.funcs):
                fn = self.funcs[fid]
                mod = self.modules[fid[0]]
                if not mod.has_wall:
                    # no wall-clock source in the module and taint never
                    # crosses modules: the default-clean summary is exact
                    continue
                env = self._local_env(fn, mod, fid[1])
                summ = self.summaries[fid]
                ret_wall = any(
                    isinstance(n, ast.Return)
                    and n.value is not None
                    and "wall" in self._expr_tokens(n.value, env, mod, fid[1])
                    for n in ast.walk(fn)
                )
                sink_params = dict(summ.sink_params)
                for toks, desc, _l, _c in self._function_sinks(fid, fn, env):
                    for t in toks:
                        if isinstance(t, tuple) and t[0] == "p":
                            sink_params.setdefault(t[1], desc)
                if ret_wall != summ.ret_wall or sink_params != summ.sink_params:
                    summ.ret_wall = ret_wall
                    summ.sink_params = sink_params
                    changed = True
            if not changed:
                break


def _self_attr_stores_of_target(t: ast.AST) -> List[Tuple[str, int, int]]:
    """Direct `self.X` targets of one assignment target (no subscript
    recursion here: `self.d[k] = wall` stores INTO d, which the carry-fn
    payload rule covers; the plain-attr sink is for `self.X = wall`)."""
    out: List[Tuple[str, int, int]] = []
    if isinstance(t, ast.Attribute):
        if isinstance(t.value, ast.Name) and t.value.id == "self":
            out.append((t.attr, t.lineno, t.col_offset))
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            out.extend(_self_attr_stores_of_target(e))
    elif isinstance(t, ast.Starred):
        out.extend(_self_attr_stores_of_target(t.value))
    return out


# ------------------------------------------------------------ direct rules


def _is_unordered_iter(e: ast.AST) -> bool:
    if isinstance(e, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(e, ast.Call)
        and isinstance(e.func, ast.Name)
        and e.func.id in ("set", "frozenset")
    )


def _is_id_call(e: ast.AST) -> bool:
    return (
        isinstance(e, ast.Call)
        and isinstance(e.func, ast.Name)
        and e.func.id == "id"
    )


def _unseeded_generators(nodes: List[ast.AST]) -> List[ast.Call]:
    """`torch.Generator(...)` constructions that are never seeded: not the
    receiver of a direct `.manual_seed(...)`/`.set_state(...)`, and not
    assigned to a name or attribute that the module seeds. `nodes`: every
    node of the module."""
    seeded: Set[int] = set()  # ids of seeded receiver expressions
    seeded_names: Set[str] = set()
    for node in nodes:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SEEDERS
        ):
            seeded.add(id(node.func.value))
            seeded_names.add(_dotted(node.func.value) or "")
    for node in nodes:
        if (
            isinstance(node, ast.Assign)
            and any(_dotted(t) in seeded_names for t in node.targets)
        ):
            seeded.add(id(node.value))
    return [
        node for node in nodes
        if isinstance(node, ast.Call)
        and _dotted(node.func) == "torch.Generator"
        and id(node) not in seeded
    ]


def _module_direct(mod: _Module, emit) -> None:
    """Syntactic per-module rules: unsorted scans, unseeded module-level
    RNG (numpy's and torch's), set iteration, id()-keyed mappings."""
    nodes = list(ast.walk(mod.tree))  # one walk, for every rule below
    sorted_args: Set[int] = set()
    for node in nodes:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "sorted"
        ):
            for a in node.args:
                sorted_args.add(id(a))
    for node in _unseeded_generators(nodes):
        emit(Finding(
            rule="unseeded-random", severity="error", path=mod.path,
            line=node.lineno, col=node.col_offset,
            message="torch.Generator() is never seeded: it starts from "
            "the default seed, not from the run's",
            hint="seed it with .manual_seed(<derived seed>) where it is "
            "built",
        ))
    for node in nodes:
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d is not None and (
                d in _SCAN_CALLS or d.endswith(".iterdir")
            ) and id(node) not in sorted_args:
                emit(Finding(
                    rule="unsorted-scan", severity="warning", path=mod.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"{d}() returns entries in filesystem order, "
                    "which varies across hosts and runs",
                    hint="wrap the scan directly in sorted(...) so every "
                    "consumer sees one canonical order, or mark a "
                    "deliberately order-free scan with "
                    "`# r2d2: disable=unsorted-scan`",
                ))
            if (
                d is not None
                and d.startswith(_RANDOM_PREFIXES)
                and d.rsplit(".", 1)[-1] not in _RANDOM_SEEDED_OK
            ):
                emit(Finding(
                    rule="unseeded-random", severity="error", path=mod.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"{d}() draws from the process-global RNG: "
                    "unseeded, shared across threads, not captured by any "
                    "snapshot",
                    hint="draw from an explicit np.random.default_rng(seed) "
                    "Generator whose bit_generator.state the owner's "
                    "carry_state captures",
                ))
            if (
                d is not None
                and d.startswith(_TORCH_PREFIXES)
                and d.rsplit(".", 1)[-1] in _TORCH_DRAWS
                and not any(k.arg == "generator" for k in node.keywords)
            ):
                emit(Finding(
                    rule="unseeded-random", severity="error", path=mod.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"{d}() without generator= draws from torch's "
                    "process-global stream: shared across threads, not "
                    "captured by any snapshot",
                    hint="pass generator= a torch.Generator seeded with "
                    "manual_seed(...) from the run's seed",
                ))
        if isinstance(node, ast.For) and _is_unordered_iter(node.iter):
            emit(Finding(
                rule="nondet-taint", severity="error", path=mod.path,
                line=node.iter.lineno, col=node.iter.col_offset,
                message="iterating a set: element order varies with hash "
                "seeding and insertion history across runs",
                hint="iterate sorted(<set>) so downstream effects happen "
                "in one canonical order",
            ))
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            for gen in node.generators:
                if _is_unordered_iter(gen.iter):
                    emit(Finding(
                        rule="nondet-taint", severity="error", path=mod.path,
                        line=gen.iter.lineno, col=gen.iter.col_offset,
                        message="comprehension over a set produces an "
                        "ordered result from an unordered source",
                        hint="iterate sorted(<set>) inside the "
                        "comprehension",
                    ))
        if isinstance(node, ast.Subscript) and _is_id_call(node.slice):
            emit(Finding(
                rule="nondet-taint", severity="error", path=mod.path,
                line=node.lineno, col=node.col_offset,
                message="id()-keyed mapping: object addresses differ every "
                "run, so the mapping's contents/order are unreproducible",
                hint="key on a stable identity (session id, name, counter)",
            ))
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None and _is_id_call(k):
                    emit(Finding(
                        rule="nondet-taint", severity="error", path=mod.path,
                        line=k.lineno, col=k.col_offset,
                        message="id()-keyed mapping: object addresses "
                        "differ every run, so the mapping's contents/order "
                        "are unreproducible",
                        hint="key on a stable identity (session id, name, "
                        "counter)",
                    ))


# ---------------------------------------------------------- chaos coverage


def _tests_dir_near(path: str) -> Optional[str]:
    """The sibling test tree for a package file: walk up a few levels
    looking for a `tests/` directory (r2d2_tpu_torch/utils/faults.py ->
    <repo>/tests; fixture packages ship their own sibling tests/)."""
    d = os.path.dirname(os.path.abspath(path))
    for _ in range(4):
        cand = os.path.join(d, "tests")
        if os.path.isdir(cand):
            return cand
        nxt = os.path.dirname(d)
        if nxt == d:
            break
        d = nxt
    return None


# sibling-test-tree scan results, keyed on the tree's (path, mtime, size)
# fingerprint: one analyzer process (the tier-1 gate, CI) walks the same
# tests/ dir several times and the parse is the chaos rule's whole cost
_DRILLED_CACHE: Dict[Tuple, frozenset] = {}


def _drives_port(path: str) -> bool:
    return os.path.basename(path).startswith(_PORT_TEST_PREFIXES)


def _drilled_sites(tests_dir: str) -> frozenset:
    """Every site-shaped string literal in the files under `tests_dir`
    that drive the port (`test_torch_*.py`, `torch_*.py`)."""
    files = [
        p for p in ast_rules.collect_py_files([tests_dir]) if _drives_port(p)
    ]
    sig: List[Tuple[str, int, int]] = []
    for p in files:
        try:
            st = os.stat(p)
        except OSError:
            continue
        sig.append((p, st.st_mtime_ns, st.st_size))
    key = (tests_dir, tuple(sig))
    cached = _DRILLED_CACHE.get(key)
    if cached is not None:
        return cached
    drilled: Set[str] = set()
    for tpath in files:
        try:
            with open(tpath, encoding="utf-8") as fh:
                ttree = ast.parse(fh.read())
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(ttree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _SITE_RE.match(node.value)
            ):
                drilled.add(node.value)
    _DRILLED_CACHE[key] = frozenset(drilled)
    return _DRILLED_CACHE[key]


def _site_arg(node: ast.Call) -> Optional[ast.AST]:
    d = _dotted(node.func) or ""
    leaf = d.rsplit(".", 1)[-1]
    if leaf == "fault_point" and node.args:
        return node.args[0]
    if leaf == "with_retries":
        if len(node.args) >= 2:
            return node.args[1]
        for k in node.keywords:
            if k.arg == "site":
                return k.value
    return None


def _chaos(prog: _Program, emit) -> None:
    registered: Dict[str, Tuple[str, int]] = {}
    ks_paths: List[str] = []
    for path in sorted(prog.modules):
        mod = prog.modules[path]
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign):
                targets, value = [node.target], node.value
            else:
                continue
            if value is None or not isinstance(value, (ast.Tuple, ast.List)):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "KNOWN_SITES"
                for t in targets
            ):
                continue
            ks_paths.append(path)
            for elt in value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    registered.setdefault(elt.value, (path, elt.lineno))
    if not registered:
        return  # no registry in the scanned tree: the family is opt-in

    guarded: Dict[str, Tuple[str, int, int]] = {}
    for path in sorted(prog.modules):
        mod = prog.modules[path]
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            arg = _site_arg(node)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                guarded.setdefault(
                    arg.value, (path, node.lineno, node.col_offset)
                )

    drilled: Set[str] = set()
    for ks_path in sorted(set(ks_paths)):
        tests_dir = _tests_dir_near(ks_path)
        if tests_dir is None:
            continue
        drilled.update(_drilled_sites(tests_dir))

    for site in sorted(registered):
        path, line = registered[site]
        if site not in guarded:
            emit(Finding(
                rule="chaos-unguarded-site", severity="error", path=path,
                line=line, col=0,
                message=f"fault site '{site}' is registered in KNOWN_SITES "
                "but no fault_point/with_retries call in the scanned tree "
                "names it",
                hint="guard the boundary the registration promises, or "
                "delete the dead registry entry",
            ))
        if site not in drilled:
            emit(Finding(
                rule="chaos-undrilled-site", severity="error", path=path,
                line=line, col=0,
                message=f"fault site '{site}' is registered but never "
                "appears in the sibling test tree: no chaos drill ever "
                "injects it",
                hint="add it to a fault-injection sweep "
                "(tests/test_torch_chaos or tests/test_torch_faults style) "
                "so the failure path is exercised",
            ))
    for site in sorted(guarded):
        if site in registered:
            continue
        path, line, col = guarded[site]
        emit(Finding(
            rule="chaos-unregistered-site", severity="error", path=path,
            line=line, col=col,
            message=f"fault_point/with_retries names site '{site}' which "
            "is not in KNOWN_SITES: specs targeting it are rejected and "
            "no sweep will ever reach it",
            hint="register the site in faults.KNOWN_SITES (and drill it)",
        ))


# ----------------------------------------------------------------- driver


def analyze_paths(
    paths: Iterable[str],
) -> Tuple[List[Finding], List[Finding]]:
    """Run the determinism rule families over every .py file under
    `paths`. Returns (findings, suppressed) like ast_rules/concurrency —
    suppressed covers both `# r2d2: disable=` matches and the audited
    `# r2d2: ephemeral(...)` exemptions, so the exemption inventory
    stays visible to the gate."""
    prog = _Program()
    prog.load(ast_rules.collect_py_files(paths))

    findings: List[Finding] = []
    suppressed: List[Finding] = []

    def emit(f: Finding) -> None:
        mod = prog.modules.get(f.path)
        rules_here = mod.suppress.get(f.line, set()) if mod else set()
        if f.rule in rules_here or "all" in rules_here:
            suppressed.append(f)
        else:
            findings.append(f)

    # ---- resume completeness
    for (path, cls) in sorted(prog.resume):
        rc = prog.resume[(path, cls)]
        for attr in sorted(rc.mutations):
            line, col = rc.mutations[attr]
            f: Optional[Finding] = None
            if rc.carry and attr not in rc.captured:
                f = Finding(
                    rule="resume-uncaptured-field", severity="error",
                    path=path, line=line, col=col,
                    message=f"{cls}.{attr} is mutated outside __init__/"
                    f"carry/restore but never captured by {rc.carry_names}:"
                    " a kill-and-resume silently resets it",
                    hint=f"capture the field in {rc.carry_names} (and "
                    f"reconstruct it in {rc.restore_names}), or annotate "
                    "its declaration with `# r2d2: ephemeral(<why resume "
                    "does not need it>)`",
                )
            elif rc.restore and attr not in rc.restored:
                f = Finding(
                    rule="resume-unrestored-field", severity="error",
                    path=path, line=line, col=col,
                    message=f"{cls}.{attr} is captured by {rc.carry_names} "
                    f"but never reconstructed in {rc.restore_names}: the "
                    "snapshot carries it and resume drops it",
                    hint=f"restore the field in {rc.restore_names}, or "
                    "annotate its declaration with `# r2d2: "
                    "ephemeral(<why resume rebuilds it>)`",
                )
            if f is None:
                continue
            if attr in rc.ephemeral:
                suppressed.append(f)  # audited exemption, kept visible
            else:
                emit(f)

    # ---- ephemeral annotations are a checked contract
    for path in sorted(prog.modules):
        mod = prog.modules[path]
        for cline, reason, targets in mod.eph_comments:
            if not reason:
                emit(Finding(
                    rule="bad-ephemeral-annotation", severity="error",
                    path=path, line=cline, col=0,
                    message="ephemeral annotation with an empty reason: "
                    "the invariant that makes the field resume-safe must "
                    "be stated in place",
                    hint="write `# r2d2: ephemeral(<why a resumed run "
                    "rebuilds or never needs this field>)`",
                ))
            elif not any(t in mod.attached for t in targets):
                emit(Finding(
                    rule="bad-ephemeral-annotation", severity="error",
                    path=path, line=cline, col=0,
                    message="ephemeral annotation attaches to no `self.*` "
                    "assignment in a resume-scoped class: it exempts "
                    "nothing",
                    hint="place it on (or directly above) an attribute "
                    "assignment of a class that defines carry_state/"
                    "capture_pending/restore_carry/restore_pending",
                ))

    # ---- direct syntactic rules
    for path in sorted(prog.modules):
        _module_direct(prog.modules[path], emit)

    # ---- wall-clock taint into deterministic sinks
    prog.compute_summaries()
    for fid in sorted(prog.funcs):
        fn = prog.funcs[fid]
        mod = prog.modules[fid[0]]
        if not mod.has_wall:
            continue  # no in-module wall source, no cross-module taint
        env = prog._local_env(fn, mod, fid[1])
        for toks, desc, line, col in prog._function_sinks(fid, fn, env):
            if "wall" not in toks:
                continue
            emit(Finding(
                rule="nondet-taint", severity="error", path=fid[0],
                line=line, col=col,
                message=f"wall-clock value flows into {desc}: two runs of "
                "the same trace stamp different values, breaking the "
                "bit-exact resume fingerprint",
                hint="derive the value from a counter/seed; genuine "
                "audit/metrics stamps are exempt when the destination "
                "name says so (t_serve, *_stamp, lag, skew, stats, ...)",
            ))

    # ---- chaos coverage
    _chaos(prog, emit)

    return stable_sort(findings), stable_sort(suppressed)
