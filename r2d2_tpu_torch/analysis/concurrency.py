"""Interprocedural concurrency analysis over the port's threaded planes
(port of r2d2_tpu/analysis/concurrency.py; the blocking set in torch's
forms, and executor workers as thread roots).

The single-function `lock-discipline` AST lint (ast_rules.py) catches a
bare write racing a guarded one INSIDE one class. It cannot see the whole
program: which thread roots exist, which functions each root reaches,
which locks are held on entry to a callee (the caller-holds-lock
contract), what order locks nest in across call chains, or whether a
blocking operation runs inside a critical section three frames up. This
pass computes exactly that, over a package-wide AST call graph:

1. **Thread-root inventory** — every `threading.Thread(target=...)`
   construction, every `Supervisor.spawn(name, body, on_restart=...)`
   call site (the supervision restart loop runs `body` AND the recovery
   hook on the worker thread), every `ThreadPoolExecutor` `.submit(fn,
   ...)` / `.map(fn, ...)` call on an executor the code built (the body
   runs on the pool's worker threads: ThreadedHostEnvPool's env steps),
   every socketserver `*RequestHandler.handle` (one thread per TCP
   connection), plus one synthetic ``main`` root covering the public API
   surface (any public function or method is callable from the
   owning/main thread).

2. **Lock summaries + lock-order graph** — per function: the locks it
   acquires (`with self.<lock>:` over `threading.Lock/RLock` attributes,
   or module-level locks), the locks held at each call site and attribute
   write, and its transitively acquired lock set. Holding L1 while
   (transitively) acquiring L2 adds the edge L1 -> L2; any cycle in the
   resulting graph — including a self-edge on a non-reentrant Lock, the
   caller-holds-lock contract violated by a re-acquire — is a potential
   deadlock (`lock-order-cycle`).

3. **Guarded-by inference** — for every `self.<attr>` write (assignments
   plus mutating container/method calls), the effective guard set =
   locally held locks ∪ locks held on entry along every path from every
   root (a per-root intersection over call sites) ∪ explicit
   `# r2d2: guarded-by(<lock>)` annotations (ast_rules.guarded_by_map —
   the same comment machinery as suppressions). An attribute written from
   >= 2 distinct thread roots whose writes share NO common lock is a data
   race (`cross-thread-unguarded-write`). Classes with no lock, no thread
   spawn site, and no annotation are presumed single-thread-confined /
   externally synchronized and exempt — the rule targets the
   thread-aware objects the serve/replay planes actually share.

4. **Blocking-under-lock** — D2H reads (`.item()`, `.cpu()`,
   `.tolist()`, `.numpy()`), H2D placement (`.cuda()`, `.to(<cuda
   device>)`), the synchronizes (`torch.cuda.synchronize`,
   `Event.synchronize`, `Stream.synchronize`), checkpoint/socket I/O,
   `time.sleep`, and `with_retries` (its backoff sleeps) executed while any
   lock is held — locally or via the caller-holds contract — stall every
   thread contending for that lock for a device round trip or worse
   (`blocking-under-lock`).

Deliberate exceptions use the same in-place machinery as the AST lints:
`# r2d2: disable=<rule>` suppresses, `# r2d2: guarded-by(<lock>)`
asserts (and is then CHECKED, not trusted blindly — the named lock feeds
the order graph and the guard intersection).

The analysis is instance-insensitive and resolution is deliberately
strict (calls resolve only through `self`, attributes/locals/params with
statically known class types, same-module or unambiguous package
functions, and typed-list element access); unresolved calls are skipped.
Under-approximating the call graph keeps the repo-wide zero-findings gate
honest: every finding is a hazard worth fixing or annotating, not noise.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from collections import deque
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from r2d2_tpu_torch.analysis import ast_rules
from r2d2_tpu_torch.analysis.findings import Finding, stable_sort

ALL_RULES = (
    "lock-order-cycle",
    "cross-thread-unguarded-write",
    "blocking-under-lock",
)

# FuncId: (path, class name or "", function name). Lambdas/defs passed as
# thread bodies get synthetic names ("<entry:LINE>") so they are analyzed
# as functions without polluting the enclosing function's flow.
FuncId = Tuple[str, str, str]
# LockId: "ClassName.attr" for instance locks, "relpath::name" for
# module-level locks, or a raw annotation token.
LockId = str

_LOCK_CTORS = {"threading.Lock": "Lock", "threading.RLock": "RLock"}

# thread pools whose .submit/.map bodies run on worker threads
_EXECUTOR_CTORS = {
    "ThreadPoolExecutor", "futures.ThreadPoolExecutor",
    "concurrent.futures.ThreadPoolExecutor",
}

# constructors whose objects are internally synchronized: writes through
# them never need an external guard
_THREADSAFE_CTORS = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "threading.Event", "threading.Lock",
    "threading.RLock", "threading.Condition", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.local", "threading.Barrier",
} | _EXECUTOR_CTORS

# mutating container/object methods: a call `self.X.append(...)` is a
# write to X for guard purposes
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "clear", "remove", "discard", "add", "update",
    "setdefault", "move_to_end", "sort", "reverse",
}

# blocking operations that must not run inside a critical section
_BLOCKING_DOTTED = {
    "torch.cuda.synchronize": "torch.cuda.synchronize (device sync)",
    "time.sleep": "time.sleep",
    "socket.create_connection": "socket connect",
}
_BLOCKING_NAMES = {
    "with_retries": "with_retries (backoff sleeps between attempts)",
    "restore_checkpoint": "checkpoint restore (fs I/O)",
    "save_checkpoint": "checkpoint save (fs I/O)",
    "latest_checkpoint_step": "checkpoint listing (fs I/O)",
}
_BLOCKING_METHODS = {
    "recv": "socket recv",
    "sendall": "socket send",
    "accept": "socket accept",
    "connect": "socket connect",
}
# zero-argument tensor methods that wait for the device
_BLOCKING_TENSOR_METHODS = {
    "item": ".item() (D2H sync)",
    "cpu": ".cpu() (D2H sync)",
    "tolist": ".tolist() (D2H sync)",
    "numpy": ".numpy() (D2H sync)",
    "cuda": ".cuda() (H2D transfer)",
    "synchronize": ".synchronize() (device sync)",
}


def _is_cuda_device(node: ast.AST) -> bool:
    """A literal CUDA device: "cuda", "cuda:N", or torch.device("cuda...")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and _dotted(node.func) in (
        "torch.device", "device"
    ):
        return bool(node.args) and _is_cuda_device(node.args[0])
    return False


@dataclasses.dataclass(frozen=True)
class ThreadRoot:
    """One concurrent entry point into the program."""

    root_id: str   # "kind:relpath:line" — distinct per construction site
    kind: str      # "thread" | "spawn" | "pool" | "handler" | "main"
    name: str      # thread/worker name literal when statically known
    path: str
    line: int
    entries: Tuple[FuncId, ...]  # resolved functions that run on this root


@dataclasses.dataclass
class _ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    bases: Tuple[str, ...] = ()
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    locks: Dict[str, str] = dataclasses.field(default_factory=dict)  # attr -> Lock|RLock
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_elem_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    threadsafe: Set[str] = dataclasses.field(default_factory=set)
    executors: Set[str] = dataclasses.field(default_factory=set)
    thread_aware: bool = False


@dataclasses.dataclass
class _FuncSummary:
    fid: FuncId
    node: ast.AST
    cls: Optional[str]
    # (lock, line, col, locks already held locally at the acquire)
    acquires: List[Tuple[LockId, int, int, Tuple[LockId, ...]]] = \
        dataclasses.field(default_factory=list)
    # (callee or None, line, col, locally held locks, blocking label or None)
    calls: List[Tuple[Optional[FuncId], int, int, Tuple[LockId, ...],
                      Optional[str]]] = dataclasses.field(default_factory=list)
    # ((class, attr), line, col, guard set = local held + line annotation)
    writes: List[Tuple[Tuple[str, str], int, int, FrozenSet[LockId]]] = \
        dataclasses.field(default_factory=list)
    entry_annot: FrozenSet[LockId] = frozenset()


@dataclasses.dataclass
class _Module:
    path: str
    tree: ast.Module
    src_lines: List[str]
    suppress: Dict[int, Set[str]]
    guards: Dict[int, Set[str]]
    locks: Set[str] = dataclasses.field(default_factory=set)  # module-level
    funcs: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)

    @property
    def rel(self) -> str:
        return os.path.basename(self.path)


def _dotted(node: ast.AST) -> Optional[str]:
    return ast_rules._dotted(node)


def _spawn_name(node: ast.AST) -> str:
    """Best-effort static worker name from a spawn's first argument.
    Handles the repo's two idioms: a plain string constant, and the
    replica-suffix concatenation `"serve-loop" + suffix` — the left
    Constant is the stable identity the inventory tests assert on."""
    if isinstance(node, ast.Constant):
        return str(node.value)
    if isinstance(node, ast.BinOp) and isinstance(node.left, ast.Constant):
        return str(node.left.value)
    return ""


def _parse_annotation(node: Optional[ast.AST]) -> Tuple[Optional[str], Optional[str]]:
    """(type name, element type name) from an annotation expression.
    Understands Name/Attribute, Optional[T], and List/Sequence/Tuple[T]
    (element type for subscripted receivers and for-loop targets); string
    annotations are re-parsed."""
    if node is None:
        return None, None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None, None
    if isinstance(node, (ast.Name, ast.Attribute)):
        d = _dotted(node)
        return (d.split(".")[-1] if d else None), None
    if isinstance(node, ast.Subscript):
        base = _dotted(node.value)
        base = base.split(".")[-1] if base else None
        inner = node.slice
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        inner_t, _ = _parse_annotation(inner)
        if base == "Optional":
            return inner_t, None
        if base in ("List", "Sequence", "Tuple", "list", "tuple", "Deque"):
            return None, inner_t
    return None, None


class _Program:
    def __init__(self) -> None:
        self.modules: Dict[str, _Module] = {}
        self.classes: Dict[str, _ClassInfo] = {}
        self.funcs: Dict[FuncId, _FuncSummary] = {}
        self.func_nodes: Dict[FuncId, Tuple[_Module, Optional[str], ast.AST]] = {}
        # bare module-level function name -> candidate FuncIds (package-wide)
        self.global_funcs: Dict[str, List[FuncId]] = {}
        self.roots: List[ThreadRoot] = []
        # AST node ids of lambdas/defs that are thread entries: excluded
        # from inline attribution in their enclosing function
        self.entry_nodes: Set[int] = set()
        self.rlocks: Set[LockId] = set()

    # ------------------------------------------------------------- loading

    def load(self, files: Sequence[str]) -> None:
        for path in files:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            try:
                tree = ast.parse(text)
            except SyntaxError:
                continue  # ast_rules reports the parse failure
            src_lines = text.splitlines()
            mod = _Module(
                path=path, tree=tree, src_lines=src_lines,
                suppress=ast_rules._suppressions(src_lines),
                guards=ast_rules.guarded_by_map(tree, src_lines),
            )
            self.modules[path] = mod
            self._index_module(mod)
        for mod in self.modules.values():
            self._index_types(mod)
        for mod in self.modules.values():
            self._collect_roots(mod)
        for fid, (mod, cls, node) in sorted(self.func_nodes.items()):
            self.funcs[fid] = self._summarize(mod, cls, fid, node)
        self._add_main_root()

    def _index_module(self, mod: _Module) -> None:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod.funcs[node.name] = node
                fid = (mod.path, "", node.name)
                self.func_nodes[fid] = (mod, None, node)
                self.global_funcs.setdefault(node.name, []).append(fid)
            elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = _dotted(node.value.func)
                if ctor in _LOCK_CTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod.locks.add(t.id)
                            if _LOCK_CTORS[ctor] == "RLock":
                                self.rlocks.add(f"{mod.rel}::{t.id}")
            elif isinstance(node, ast.ClassDef):
                info = _ClassInfo(
                    name=node.name, path=mod.path, node=node,
                    bases=tuple(
                        b for b in (_dotted(base) for base in node.bases) if b
                    ),
                )
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info.methods[item.name] = item
                        fid = (mod.path, node.name, item.name)
                        self.func_nodes[fid] = (mod, node.name, item)
                self.classes[info.name] = info

    def _index_types(self, mod: _Module) -> None:
        """Second pass (class registry complete): lock attrs, thread-safe
        attrs, and attribute types for every class in the module."""
        for info in self.classes.values():
            if info.path != mod.path:
                continue
            for sub in ast.walk(info.node):
                target = value = ann = None
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    target, value = sub.targets[0], sub.value
                elif isinstance(sub, ast.AnnAssign):
                    target, value, ann = sub.target, sub.value, sub.annotation
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    continue
                attr = target.attr
                if isinstance(value, ast.Call):
                    ctor = _dotted(value.func)
                    if ctor in _LOCK_CTORS:
                        info.locks[attr] = _LOCK_CTORS[ctor]
                        if _LOCK_CTORS[ctor] == "RLock":
                            self.rlocks.add(f"{info.name}.{attr}")
                        continue
                    if ctor in _EXECUTOR_CTORS:
                        info.executors.add(attr)
                    if ctor in _THREADSAFE_CTORS:
                        info.threadsafe.add(attr)
                        continue
                    last = ctor.split(".")[-1] if ctor else None
                    if last in self.classes:
                        info.attr_types.setdefault(attr, last)
                        continue
                if isinstance(value, (ast.List, ast.ListComp)):
                    elt = value.elts[0] if (
                        isinstance(value, ast.List) and value.elts
                    ) else getattr(value, "elt", None)
                    if isinstance(elt, ast.Call):
                        last = (_dotted(elt.func) or "").split(".")[-1]
                        if last in self.classes:
                            info.attr_elem_types.setdefault(attr, last)
                t, elem = _parse_annotation(ann)
                if t in self.classes:
                    info.attr_types.setdefault(attr, t)
                if elem in self.classes:
                    info.attr_elem_types.setdefault(attr, elem)
            # a class that owns a lock, a thread pool or spawns a thread
            # participates in the cross-thread write rule; plain data
            # classes are presumed single-thread-confined
            info.thread_aware = bool(info.locks) or bool(info.executors) or any(
                isinstance(s, ast.Call)
                and (
                    _dotted(s.func) == "threading.Thread"
                    or (isinstance(s.func, ast.Attribute) and s.func.attr == "spawn")
                )
                for s in ast.walk(info.node)
            )
            span = range(info.node.lineno, (info.node.end_lineno or 0) + 1)
            if any(ln in mod.guards for ln in span):
                info.thread_aware = True
        # annotation-only param types are handled per-function in _summarize

    # --------------------------------------------------------------- roots

    def _collect_roots(self, mod: _Module) -> None:
        rel = os.path.relpath(mod.path)

        def walk(node: ast.AST, cls: Optional[str], fn: Optional[ast.AST]) -> None:
            for child in ast.iter_child_nodes(node):
                child_cls, child_fn = cls, fn
                if isinstance(child, ast.ClassDef):
                    child_cls, child_fn = child.name, None
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    child_fn = child
                if isinstance(child, ast.Call):
                    self._root_from_call(mod, rel, child, cls, fn)
                walk(child, child_cls, child_fn)

        walk(mod.tree, None, None)

        for info in self.classes.values():
            if info.path != mod.path:
                continue
            if any("RequestHandler" in b for b in info.bases) and \
                    "handle" in info.methods:
                self.roots.append(ThreadRoot(
                    root_id=f"handler:{rel}:{info.node.lineno}",
                    kind="handler", name=info.name, path=mod.path,
                    line=info.node.lineno,
                    entries=((mod.path, info.name, "handle"),),
                ))

    def _root_from_call(self, mod: _Module, rel: str, call: ast.Call,
                        cls: Optional[str], fn: Optional[ast.AST]) -> None:
        d = _dotted(call.func)
        if d in ("threading.Thread", "Thread"):
            target = next(
                (kw.value for kw in call.keywords if kw.arg == "target"), None
            )
            entries = self._resolve_entry(mod, cls, fn, target)
            name = next(
                (kw.value.value for kw in call.keywords
                 if kw.arg == "name" and isinstance(kw.value, ast.Constant)),
                "",
            )
            self.roots.append(ThreadRoot(
                root_id=f"thread:{rel}:{call.lineno}", kind="thread",
                name=str(name), path=mod.path, line=call.lineno,
                entries=tuple(entries),
            ))
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "spawn"
            and len(call.args) >= 2
        ):
            entries = self._resolve_entry(mod, cls, fn, call.args[1])
            # the recovery hook runs on the SAME worker thread (the
            # supervision restart loop calls it between body crashes)
            for kw in call.keywords:
                if kw.arg == "on_restart":
                    entries.extend(self._resolve_entry(mod, cls, fn, kw.value))
            name = _spawn_name(call.args[0])
            self.roots.append(ThreadRoot(
                root_id=f"spawn:{rel}:{call.lineno}", kind="spawn",
                name=str(name), path=mod.path, line=call.lineno,
                entries=tuple(entries),
            ))
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in ("submit", "map")
            and call.args
        ):
            ctor = self._executor_ctor(mod, cls, fn, call.func.value)
            if ctor is None:
                return
            # every call's body runs on the pool's workers, never on the
            # submitting thread
            entries = self._resolve_entry(mod, cls, fn, call.args[0])
            name = next(
                (_spawn_name(kw.value) for kw in ctor.keywords
                 if kw.arg == "thread_name_prefix"),
                "",
            )
            self.roots.append(ThreadRoot(
                root_id=f"pool:{rel}:{call.lineno}", kind="pool",
                name=name, path=mod.path, line=call.lineno,
                entries=tuple(entries),
            ))

    def _executor_ctor(self, mod: _Module, cls: Optional[str],
                       fn: Optional[ast.AST], expr: ast.AST
                       ) -> Optional[ast.Call]:
        """The ThreadPoolExecutor(...) construction `expr` names: a
        `self.<attr>` the class assigns one to, or a local bound by an
        assignment or a `with ... as` in the enclosing function."""
        scope: Optional[ast.AST] = None
        want: Optional[str] = None
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls in self.classes
            and expr.attr in self.classes[cls].executors
        ):
            scope, want = self.classes[cls].node, f"self.{expr.attr}"
        elif isinstance(expr, ast.Name) and fn is not None:
            scope, want = fn, expr.id
        if scope is None:
            return None
        for sub in ast.walk(scope):
            if (
                isinstance(sub, ast.Assign)
                and isinstance(sub.value, ast.Call)
                and _dotted(sub.value.func) in _EXECUTOR_CTORS
                and any(_dotted(t) == want for t in sub.targets)
            ):
                return sub.value
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    ctx = item.context_expr
                    if (
                        isinstance(ctx, ast.Call)
                        and _dotted(ctx.func) in _EXECUTOR_CTORS
                        and item.optional_vars is not None
                        and _dotted(item.optional_vars) == want
                    ):
                        return ctx
        return None

    def _resolve_entry(self, mod: _Module, cls: Optional[str],
                       fn: Optional[ast.AST], expr: Optional[ast.AST]
                       ) -> List[FuncId]:
        """Resolve a thread body expression to FuncIds. Lambdas and local
        defs become synthetic analysis functions and are EXCLUDED from
        inline attribution in the enclosing function — their statements
        run on the new thread, not the spawning one."""
        if expr is None:
            return []
        if isinstance(expr, ast.Lambda):
            self.entry_nodes.add(id(expr))
            fid = (mod.path, cls or "", f"<entry:{expr.lineno}>")
            self.func_nodes[fid] = (mod, cls, expr)
            return [fid]
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and cls is not None:
            m = self._lookup_method(cls, expr.attr)
            return [m] if m else []
        if isinstance(expr, ast.Name):
            # a nested def in the enclosing function (actor_body et al.)
            if fn is not None:
                for sub in ast.walk(fn):
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and sub is not fn and sub.name == expr.id:
                        self.entry_nodes.add(id(sub))
                        fid = (mod.path, cls or "", f"<entry:{sub.lineno}>")
                        self.func_nodes[fid] = (mod, cls, sub)
                        return [fid]
            if expr.id in mod.funcs:
                return [(mod.path, "", expr.id)]
        return []

    def _add_main_root(self) -> None:
        entries: List[FuncId] = []
        for fid, (mod, cls, node) in self.func_nodes.items():
            name = fid[2]
            if name.startswith("_"):  # includes __init__ and <entry:...>
                continue
            entries.append(fid)
        self.roots.append(ThreadRoot(
            root_id="main", kind="main", name="main", path="", line=0,
            entries=tuple(sorted(entries)),
        ))

    def _lookup_method(self, cls: str, name: str) -> Optional[FuncId]:
        seen: Set[str] = set()
        queue_: List[str] = [cls]
        while queue_:
            c = queue_.pop(0)
            if c in seen or c not in self.classes:
                continue
            seen.add(c)
            info = self.classes[c]
            if name in info.methods:
                return (info.path, c, name)
            queue_.extend(b.split(".")[-1] for b in info.bases)
        return None

    # ----------------------------------------------------------- summaries

    def _summarize(self, mod: _Module, cls: Optional[str], fid: FuncId,
                   node: ast.AST) -> _FuncSummary:
        summ = _FuncSummary(fid=fid, node=node, cls=cls)
        env: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
        args = node.args if not isinstance(node, ast.Lambda) else node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            t, elem = _parse_annotation(a.annotation)
            if t or elem:
                env[a.arg] = (t, elem)
        summ.entry_annot = frozenset(
            self._resolve_lock_name(n, cls, mod)
            for n in mod.guards.get(node.lineno, ())
        )

        def type_of(expr: ast.AST) -> Optional[str]:
            if isinstance(expr, ast.Name):
                t = env.get(expr.id)
                return t[0] if t else None
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and expr.value.id == "self":
                if cls and cls in self.classes:
                    return self.classes[cls].attr_types.get(expr.attr)
                return None
            if isinstance(expr, ast.Attribute):
                base_t = type_of(expr.value)
                if base_t and base_t in self.classes:
                    return self.classes[base_t].attr_types.get(expr.attr)
                return None
            if isinstance(expr, ast.Subscript):
                return elem_type_of(expr.value)
            return None

        def elem_type_of(expr: ast.AST) -> Optional[str]:
            if isinstance(expr, ast.Name):
                t = env.get(expr.id)
                return t[1] if t else None
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and expr.value.id == "self":
                if cls and cls in self.classes:
                    return self.classes[cls].attr_elem_types.get(expr.attr)
            return None

        def resolve_lock(expr: ast.AST) -> Optional[LockId]:
            if isinstance(expr, ast.Call):
                expr = expr.func
            if isinstance(expr, ast.Attribute):
                if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                    if cls:
                        owner = self._lock_owner(cls, expr.attr)
                        if owner:
                            return f"{owner}.{expr.attr}"
                    return None
                t = type_of(expr.value)
                if t and t in self.classes and expr.attr in self.classes[t].locks:
                    return f"{t}.{expr.attr}"
                return None
            if isinstance(expr, ast.Name) and expr.id in mod.locks:
                return f"{mod.rel}::{expr.id}"
            return None

        def resolve_call(func_expr: ast.AST) -> Optional[FuncId]:
            if isinstance(func_expr, ast.Name):
                n = func_expr.id
                if n in self.classes:
                    return self._lookup_method(n, "__init__")
                if n in mod.funcs:
                    return (mod.path, "", n)
                cands = self.global_funcs.get(n, [])
                return cands[0] if len(cands) == 1 else None
            if isinstance(func_expr, ast.Attribute):
                if isinstance(func_expr.value, ast.Name) and \
                        func_expr.value.id == "self" and cls:
                    return self._lookup_method(cls, func_expr.attr)
                last = (_dotted(func_expr) or "").split(".")[-1]
                t = type_of(func_expr.value)
                if t:
                    return self._lookup_method(t, func_expr.attr)
                if last in self.classes:
                    return self._lookup_method(last, "__init__")
            return None

        def blocking_label(call: ast.Call) -> Optional[str]:
            d = _dotted(call.func)
            if d in _BLOCKING_DOTTED:
                return _BLOCKING_DOTTED[d]
            last = d.split(".")[-1] if d else None
            if last in _BLOCKING_NAMES:
                return _BLOCKING_NAMES[last]
            if isinstance(call.func, ast.Attribute):
                m = call.func.attr
                if m in _BLOCKING_METHODS:
                    return _BLOCKING_METHODS[m]
                if m in _BLOCKING_TENSOR_METHODS and not call.args \
                        and not call.keywords:
                    return _BLOCKING_TENSOR_METHODS[m]
                if m == "to" and any(
                    _is_cuda_device(a)
                    for a in list(call.args) + [k.value for k in call.keywords]
                ):
                    return ".to(<cuda device>) (H2D transfer)"
            return None

        def record_call(call: ast.Call, held: Tuple[LockId, ...]) -> None:
            summ.calls.append((
                resolve_call(call.func), call.lineno, call.col_offset,
                held, blocking_label(call),
            ))
            # a mutating method on a non-thread-safe self attribute is a
            # write for guard purposes (self._deferred.append, ...)
            f = call.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _MUTATORS
                and isinstance(f.value, ast.Attribute)
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "self"
                and cls
            ):
                record_write(f.value.attr, call, held)

        def line_guards(lineno: int) -> FrozenSet[LockId]:
            return frozenset(
                self._resolve_lock_name(n, cls, mod)
                for n in mod.guards.get(lineno, ())
            )

        def record_write(attr: str, at: ast.AST,
                         held: Tuple[LockId, ...]) -> None:
            if not cls or cls not in self.classes:
                return
            info = self.classes[cls]
            if attr in info.locks or attr in info.threadsafe:
                return
            summ.writes.append((
                (cls, attr), at.lineno, at.col_offset,
                frozenset(held) | line_guards(at.lineno),
            ))

        def scan_expr(expr: ast.AST, held: Tuple[LockId, ...]) -> None:
            if id(expr) in self.entry_nodes:
                return  # runs on another thread; analyzed as its own entry
            if isinstance(expr, ast.Lambda):
                scan_expr(expr.body, ())
                return
            if isinstance(expr, ast.Call):
                record_call(expr, held)
            for child in ast.iter_child_nodes(expr):
                scan_expr(child, held)

        def visit_stmt(stmt: ast.AST, held: Tuple[LockId, ...]) -> None:
            if id(stmt) in self.entry_nodes:
                return
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def (closure) runs inside this function's
                # machinery but not under the lexically enclosing locks
                visit_block(stmt.body, ())
                return
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in stmt.items:
                    scan_expr(item.context_expr, held)
                    lock = resolve_lock(item.context_expr)
                    if lock is not None:
                        summ.acquires.append(
                            (lock, stmt.lineno, stmt.col_offset, new_held)
                        )
                        new_held = new_held + (lock,)
                visit_block(stmt.body, new_held)
                return
            targets: List[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                targets = list(stmt.targets)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                targets = [stmt.target]
            for t in list(targets):
                if isinstance(t, (ast.Tuple, ast.List)):
                    targets.extend(t.elts)
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    record_write(base.attr, stmt, held)
            if isinstance(stmt, ast.For):
                # typed-list iteration types the loop variable (`for r in
                # self.replicas:` -> r: PolicyServer)
                if isinstance(stmt.target, ast.Name):
                    elem = elem_type_of(stmt.iter)
                    if elem:
                        env[stmt.target.id] = (elem, None)
                scan_expr(stmt.iter, held)
                visit_block(stmt.body + stmt.orelse, held)
                return
            if isinstance(stmt, (ast.While, ast.If)):
                scan_expr(stmt.test, held)
                visit_block(stmt.body + stmt.orelse, held)
                return
            if isinstance(stmt, ast.Try):
                visit_block(stmt.body + stmt.orelse + stmt.finalbody, held)
                for h in stmt.handlers:
                    visit_block(h.body, held)
                return
            # local ctor assignment types the variable
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                last = (_dotted(stmt.value.func) or "").split(".")[-1]
                if last in self.classes and len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Name):
                    env[stmt.targets[0].id] = (last, None)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, (ast.expr,)):
                    scan_expr(child, held)
                elif isinstance(child, ast.stmt):
                    visit_stmt(child, held)

        def visit_block(stmts: Sequence[ast.AST],
                        held: Tuple[LockId, ...]) -> None:
            for s in stmts:
                visit_stmt(s, held)

        if isinstance(node, ast.Lambda):
            scan_expr(node.body, ())
        else:
            visit_block(node.body, ())
        return summ

    def _lock_owner(self, cls: str, attr: str) -> Optional[str]:
        """The class (self or a base) declaring `attr` as a lock."""
        seen: Set[str] = set()
        queue_: List[str] = [cls]
        while queue_:
            c = queue_.pop(0)
            if c in seen or c not in self.classes:
                continue
            seen.add(c)
            if attr in self.classes[c].locks:
                return c
            queue_.extend(b.split(".")[-1] for b in self.classes[c].bases)
        return None

    def _resolve_lock_name(self, name: str, cls: Optional[str],
                           mod: _Module) -> LockId:
        """Resolve an annotation token: a bare name binds to the enclosing
        class's lock attribute, then to a module-level lock; dotted names
        and unknown tokens pass through verbatim (consistent annotations
        still intersect)."""
        if "." in name or "::" in name:
            return name
        if cls:
            owner = self._lock_owner(cls, name)
            if owner:
                return f"{owner}.{name}"
        if name in mod.locks:
            return f"{mod.rel}::{name}"
        return name


# ------------------------------------------------------- interprocedural


def _propagate(prog: _Program) -> Tuple[
    Dict[Tuple[str, FuncId], FrozenSet[LockId]],
    Dict[FuncId, Set[str]],
]:
    """Worklist over (root, function): entry-held lock sets — the
    intersection of locks held at every discovered call site from that
    root, floored by the function's own guarded-by(def) annotation — and
    per-function reaching-root sets."""
    eh: Dict[Tuple[str, FuncId], FrozenSet[LockId]] = {}
    work: deque = deque()
    for root in prog.roots:
        for entry in root.entries:
            if entry not in prog.funcs:
                continue
            key = (root.root_id, entry)
            annot = prog.funcs[entry].entry_annot
            if key not in eh:
                eh[key] = annot
                work.append(key)
    while work:
        root_id, fid = work.popleft()
        summ = prog.funcs[fid]
        base = eh[(root_id, fid)]
        for callee, _line, _col, held, _blk in summ.calls:
            if callee is None or callee not in prog.funcs:
                continue
            annot = prog.funcs[callee].entry_annot
            eff = base | frozenset(held) | annot
            key = (root_id, callee)
            cur = eh.get(key)
            new = eff if cur is None else (cur & eff) | annot
            if new != cur:
                eh[key] = new
                work.append(key)
    reach: Dict[FuncId, Set[str]] = {}
    for (root_id, fid) in eh:
        reach.setdefault(fid, set()).add(root_id)
    return eh, reach


def _entry_held_all(prog: _Program, eh, reach, fid: FuncId) -> FrozenSet[LockId]:
    roots = reach.get(fid)
    if not roots:
        return prog.funcs[fid].entry_annot
    out: Optional[FrozenSet[LockId]] = None
    for r in roots:
        s = eh[(r, fid)]
        out = s if out is None else out & s
    return out if out is not None else frozenset()


def _entry_held_per_root(prog: _Program, eh, reach,
                         fid: FuncId) -> List[FrozenSet[LockId]]:
    """Distinct per-root must-hold entry sets. Lock-order and blocking
    checks use these rather than the all-roots intersection: a function
    called both bare from main AND under a lock from a watcher thread
    still deadlocks/stalls on the watcher path — the unlocked main path
    must not mask it."""
    roots = reach.get(fid)
    if not roots:
        return [prog.funcs[fid].entry_annot]
    return sorted({eh[(r, fid)] for r in roots}, key=sorted)


def _transitive_acquires(prog: _Program) -> Dict[FuncId, Set[LockId]]:
    acq = {
        fid: {a[0] for a in summ.acquires}
        for fid, summ in prog.funcs.items()
    }
    changed = True
    while changed:
        changed = False
        for fid, summ in prog.funcs.items():
            for callee, _l, _c, _held, _b in summ.calls:
                if callee in acq and not acq[callee] <= acq[fid]:
                    acq[fid] |= acq[callee]
                    changed = True
    return acq


def _lock_cycles(edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]]
                 ) -> List[List[LockId]]:
    """Elementary cycles via SCC decomposition: each SCC with a cycle
    yields one canonical cycle (deterministic order)."""
    graph: Dict[LockId, Set[LockId]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    sccs: List[List[LockId]] = []
    counter = [0]

    def strongconnect(v: LockId) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(graph[v]):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            scc = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                scc.append(w)
                if w == v:
                    break
            sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    cycles: List[List[LockId]] = []
    for scc in sccs:
        if len(scc) > 1:
            cycles.append(sorted(scc))
        elif (scc[0], scc[0]) in edges:
            cycles.append([scc[0]])
    return sorted(cycles)


# --------------------------------------------------------------- analysis


def thread_roots(paths: Iterable[str]) -> List[ThreadRoot]:
    """The thread-root inventory for the given files/directories."""
    prog = _Program()
    prog.load(ast_rules.collect_py_files(paths))
    return sorted(prog.roots, key=lambda r: (r.path, r.line, r.root_id))


def analyze_paths(paths: Iterable[str]) -> Tuple[List[Finding], List[Finding]]:
    """Run the concurrency rule family over every .py file under `paths`.
    Returns (findings, suppressed) like ast_rules.analyze_paths."""
    prog = _Program()
    prog.load(ast_rules.collect_py_files(paths))
    eh, reach = _propagate(prog)
    acq = _transitive_acquires(prog)

    findings: List[Finding] = []
    suppressed: List[Finding] = []

    def emit(f: Finding) -> None:
        mod = prog.modules.get(f.path)
        rules_here = mod.suppress.get(f.line, set()) if mod else set()
        if f.rule in rules_here or "all" in rules_here:
            suppressed.append(f)
        else:
            findings.append(f)

    # ---- lock-order graph + cycles
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}

    def add_edge(h: LockId, l: LockId, path: str, line: int, via: str) -> None:
        if h == l and h in prog.rlocks:
            return  # re-acquiring an RLock is legal
        key = (h, l)
        site = (path, line, via)
        if key not in edges or site < edges[key]:
            edges[key] = site

    for fid, summ in sorted(prog.funcs.items()):
        for base in _entry_held_per_root(prog, eh, reach, fid):
            for lock, line, _col, held_before in summ.acquires:
                for h in sorted(base | frozenset(held_before)):
                    add_edge(
                        h, lock, fid[0], line,
                        f"{_qual(fid)} acquires {lock} while holding {h}",
                    )
            for callee, line, _col, held, _blk in summ.calls:
                if callee is None or callee not in prog.funcs:
                    continue
                eff = base | frozenset(held)
                if not eff:
                    continue
                for lock in sorted(acq.get(callee, ())):
                    for h in sorted(eff):
                        add_edge(
                            h, lock, fid[0], line,
                            f"{_qual(fid)} calls {_qual(callee)} (which "
                            f"acquires {lock}) while holding {h}",
                        )

    for cycle in _lock_cycles(edges):
        if len(cycle) == 1:
            (path, line, via) = edges[(cycle[0], cycle[0])]
            msg = (
                f"potential deadlock: non-reentrant lock {cycle[0]} can be "
                f"re-acquired while already held ({via})"
            )
        else:
            legs = []
            for a, b in zip(cycle, cycle[1:] + cycle[:1]):
                if (a, b) in edges:
                    legs.append(edges[(a, b)])
            path, line = legs[0][0], legs[0][1]
            chain = " -> ".join(cycle + [cycle[0]])
            msg = (
                f"potential deadlock: lock-order cycle {chain}; "
                + "; ".join(v for (_p, _l, v) in legs)
            )
        emit(Finding(
            rule="lock-order-cycle", severity="error", path=path, line=line,
            col=0, message=msg,
            hint="impose one global acquisition order (document it at the "
            "lock's definition), or narrow one critical section so the "
            "nested acquire happens after release",
        ))

    # ---- cross-thread write guards
    by_attr: Dict[Tuple[str, str], List[Tuple[FuncId, int, int,
                                              FrozenSet[LockId]]]] = {}
    for fid, summ in prog.funcs.items():
        if fid[2] == "__init__":
            continue  # pre-publication writes (object not yet shared)
        roots = reach.get(fid)
        if not roots:
            continue  # never runs
        base = _entry_held_all(prog, eh, reach, fid)
        for key, line, col, guards in summ.writes:
            by_attr.setdefault(key, []).append((fid, line, col, guards | base))

    for (cls, attr), events in sorted(by_attr.items()):
        info = prog.classes.get(cls)
        if info is None or not info.thread_aware:
            continue
        roots_union: Set[str] = set()
        for fid, _l, _c, _g in events:
            roots_union |= reach.get(fid, set())
        if len(roots_union) < 2:
            continue
        common = frozenset.intersection(*(g for _f, _l, _c, g in events))
        if common:
            continue
        root_names = sorted(roots_union)
        guarded_sets = sorted(
            {tuple(sorted(g)) for _f, _l, _c, g in events if g}
        )
        bare = sorted(
            (e for e in events if not e[3]), key=lambda e: (e[0][0], e[1], e[2])
        )
        targets = bare if bare else [min(
            events, key=lambda e: (e[0][0], e[1], e[2])
        )]
        for fid, line, col, _g in targets:
            if guarded_sets:
                detail = (
                    "other writes hold "
                    + " / ".join("{" + ", ".join(g) + "}" for g in guarded_sets)
                    + " — no common guard"
                )
            else:
                detail = "no write holds any lock"
            emit(Finding(
                rule="cross-thread-unguarded-write", severity="error",
                path=fid[0], line=line, col=col,
                message=f"{cls}.{attr} is written from {len(roots_union)} "
                f"thread roots ({', '.join(root_names)}) and this write has "
                f"no guard; {detail}",
                hint="take the owning lock around the write, or assert the "
                "caller-holds-lock contract with `# r2d2: guarded-by(<lock>)`"
                " (a single-thread-confined phase can use "
                "`# r2d2: disable=cross-thread-unguarded-write` with a "
                "comment saying why)",
            ))

    # ---- blocking operations under a lock
    for fid, summ in sorted(prog.funcs.items()):
        bases = _entry_held_per_root(prog, eh, reach, fid)
        for _callee, line, col, held, label in summ.calls:
            if label is None:
                continue
            for base in bases:
                eff = base | frozenset(held)
                if not eff:
                    continue
                emit(Finding(
                    rule="blocking-under-lock", severity="warning",
                    path=fid[0], line=line, col=col,
                    message=f"{label} inside a critical section "
                    f"({', '.join(sorted(eff))} held"
                    + ("" if held else " via the caller-holds-lock contract")
                    + f") in {_qual(fid)}: every thread contending for the "
                    "lock stalls behind this operation",
                    hint="stage the slow work outside the lock and keep only "
                    "the state swap inside, or mark a deliberate exception "
                    "with `# r2d2: disable=blocking-under-lock`",
                ))
                break  # one finding per site, not per root

    return stable_sort(findings), stable_sort(suppressed)


def _qual(fid: FuncId) -> str:
    path, cls, name = fid
    base = os.path.basename(path)
    return f"{base}:{cls}.{name}" if cls else f"{base}:{name}"
