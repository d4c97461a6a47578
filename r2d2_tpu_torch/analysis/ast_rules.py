"""AST lint rules over the port's source (port of
r2d2_tpu/analysis/ast_rules.py, in torch's forms).

Each rule encodes an invariant that Python cannot enforce at runtime until
it is too late on the card: a device->host read inside a hot loop stalls
the launch queue for a full round trip per iteration, a float64 tensor
doubles memory and falls off the tensor cores, an unregistered fault site
silently drops out of the chaos sweep, and an unlocked write to
lock-guarded state is a data race waiting for a thread interleaving. The
rules are deliberately conservative approximations — they flag the
syntactic patterns that produce those failures, and a deliberate
exception is silenced in place with

    # r2d2: disable=<rule>[,<rule>...]          (same line or line above)

so every suppression is visible in the diff it rides in on. The comment
syntax is the JAX package's, character for character: one comment means
the same thing to both packages' analyzers.

Lock-discipline exceptions have a PRECISE variant: instead of muting the
rule, an annotation asserts WHICH lock protects the write —

    self.count += 1  # r2d2: guarded-by(lock)   (this write: caller holds
                                                 self.lock)
    def _account(self):  # r2d2: guarded-by(lock)
        ...                                     (whole function runs with
                                                 self.lock held — the
                                                 caller-holds-lock contract)

A guarded-by annotation silences `lock-discipline` for the covered lines
exactly like a disable comment would, but unlike a disable it feeds the
interprocedural concurrency pass (analysis/concurrency.py), which treats
the named lock as held there and CHECKS the assertion's consequences
(lock-order edges, cross-thread guard consistency) instead of going blind.

Rule catalog (ids, severities):

- host-sync-in-hot-path  (warning)  a device->host read inside a
  for/while body in the hot-path modules (learner.py, collect.py,
  megastep.py): `.item()`, `.cpu()`, `.tolist()`, `.numpy()`,
  `float(x)` / `int(x)` / `bool(x)` of a possible tensor,
  `torch.cuda.synchronize()` and `Event.synchronize()` /
  `Stream.synchronize()`. Each one waits for the card once per
  iteration. The serving plane has its own rule (below).
- blocking-host-sync-in-serve-step (warning)  the serve-pipeline variant,
  covering serve/* files: the same loop-body flags as
  host-sync-in-hot-path, PLUS function-wide (not just loop-body) coverage
  of `.item()` / `.cpu()` / `.tolist()` / `.numpy()` and the
  synchronizes inside the pipeline's stage/dispatch bodies (`_run_batch`,
  `_serve_iteration`, `_stage*`, `_dispatch*`) — one blocking
  materialization there stalls the whole depth-2 overlap, so the serve
  thread must never wait on the device. Completion-side functions
  (`_complete*`) and `warmup*` are exempt: materializing is their job.
  `float()` / `int()` / `bool()` stay loop-only.
- float64-op             (error)    float64 on the device: `torch.float64`,
  `torch.double`, a `.double()` cast, and a float64 dtype (`np.float64`,
  `"float64"`) passed to a `torch.*` tensor constructor. Host-side numpy
  float64 (sum-tree prefix sums, env reward accumulators, the numpy
  replay's priorities) is fine and not flagged: only what reaches a torch
  tensor is.
- unknown-fault-site     (error)    `fault_point(<a string literal>)` whose site is
  not registered in the port's `r2d2_tpu_torch.utils.faults.KNOWN_SITES`
  — the site would be invisible to chaos sweeps and the R2D2_FAULTS
  operator surface.
- dynamic-fault-site     (warning)  `fault_point(expr)` with a non-literal
  argument — statically uncheckable, and sweeps cannot enumerate it.
- snapshot-missing-topology (error) a `save_replay(...)` call site in the
  package without an explicit `topology=` manifest: a snapshot written
  without a manifest cannot be resharded onto a changed device/host
  layout (replay/reshard.py).
- lock-discipline        (warning)  a class that guards attribute writes
  with `with self.<lock>:` in one method but writes the same attributes
  bare in another (non-__init__) method — the trainer/serve/watcher
  threads share these objects, so the bare write races the guarded one.
- host-tree-in-hot-loop  (warning)  a host `SumTree` method call
  (`.tree.sample(...)`, `.tree.update(...)`, ...) inside a for/while body
  in the learner hot-path modules: under priority_plane='device' the sum
  tree lives on the card and sampling/write-back run inside the
  superstep, so a host-tree call here both stalls the launch queue per
  iteration and silently forks the host tree away from the device tree.
  The device ops (replay/device_sum_tree.py module functions) are not
  flagged.
- codec-decode-in-hot-loop (warning) a block-codec decode
  (`decode_field` / `decode_block` / `read_block`) or an mmap page-in
  (`np.memmap` / `mmap.mmap`) inside a for/while body in the learner
  hot-path modules or serve/*: decompression and first-touch page faults
  belong on the replay staging thread (tiered_store._fill_disk_rows),
  never on the learner or serve step.

Dropped, because they have no torch meaning (the JAX package keeps them):

- jit-in-loop: the port builds no `jax.jit` wrappers; nothing retraces.
- unhashable-static-arg: there are no jit static arguments to hash.
- shape-branch-in-jit: eager torch runs a shape branch as plain Python;
  no program variant is traced per shape.
- raw-shard-map-import: the port has no shard_map and no jax version shim.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from r2d2_tpu_torch.analysis.findings import Finding
from r2d2_tpu_torch.utils.faults import KNOWN_SITES

ALL_RULES = (
    "host-sync-in-hot-path",
    "blocking-host-sync-in-serve-step",
    "float64-op",
    "unknown-fault-site",
    "dynamic-fault-site",
    "snapshot-missing-topology",
    "lock-discipline",
    "host-tree-in-hot-loop",
    "codec-decode-in-hot-loop",
)

# the JAX package's rules that have no counterpart here (module docstring)
DROPPED_RULES = (
    "jit-in-loop",
    "unhashable-static-arg",
    "shape-branch-in-jit",
    "raw-shard-map-import",
)

# hot-path modules for the host-sync rule: the learner/collection dispatch
# loops. The serving plane has blocking-host-sync-in-serve-step, which
# adds function-wide stage/dispatch coverage on top of the same loop-body
# checks.
HOT_BASENAMES = {"learner.py", "collect.py", "megastep.py"}
HOT_DIRNAMES: Set[str] = set()

# the serve rule's scope + its pipeline-role name conventions
# (serve/server.py): stage/dispatch bodies must never block on the
# device; completion/warmup bodies exist to block on it
SERVE_DIRNAMES = {"serve"}
_SERVE_STEP_NAMES = {"_run_batch", "_serve_iteration"}
_SERVE_STEP_PREFIXES = ("_stage", "_dispatch")
_SERVE_EXEMPT_PREFIXES = ("_complete", "warmup")

# device->host reads in torch's forms: zero-argument tensor methods, and
# the synchronizes (the module function and the Event/Stream method)
_SYNC_METHODS = {
    "item": ".item()",
    "cpu": ".cpu()",
    "tolist": ".tolist()",
    "numpy": ".numpy()",
    "synchronize": ".synchronize()",
}
_SYNC_CALLS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    "cuda.synchronize": "torch.cuda.synchronize()",
}
# scalar casts of a possible tensor: loop-body only
_SCALAR_CASTS = ("float", "int", "bool")

_DISABLE_RE = re.compile(r"#\s*r2d2:\s*disable=([A-Za-z0-9_,\s-]+)")
_GUARDED_BY_RE = re.compile(r"#\s*r2d2:\s*guarded-by\(([A-Za-z0-9_.\s,]+)\)")


def is_hot_path(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return parts[-1] in HOT_BASENAMES or bool(HOT_DIRNAMES & set(parts[:-1]))


def is_serve_path(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return bool(SERVE_DIRNAMES & set(parts[:-1]))


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _suppressions(src_lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Line -> suppressed rule set. A trailing `# r2d2: disable=` comment
    covers its own line; a comment-ONLY line covers itself and the line
    below (so it can sit above a long statement without leaking onto
    unrelated neighbors)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src_lines, start=1):
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        targets = (i, i + 1) if line.lstrip().startswith("#") else (i,)
        for target in targets:
            out.setdefault(target, set()).update(rules)
    return out


def _guarded_by_comments(src_lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Line -> lock names asserted held there by `# r2d2: guarded-by(X)`
    annotations. Same placement rules as _suppressions: a trailing comment
    covers its own line, a comment-only line covers itself and the line
    below."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src_lines, start=1):
        m = _GUARDED_BY_RE.search(line)
        if not m:
            continue
        names = {n.strip() for n in m.group(1).split(",") if n.strip()}
        targets = (i, i + 1) if line.lstrip().startswith("#") else (i,)
        for target in targets:
            out.setdefault(target, set()).update(names)
    return out


def guarded_by_map(tree: ast.AST, src_lines: Sequence[str]) -> Dict[int, Set[str]]:
    """The full guarded-by map for one file: per-line annotations, with a
    def-line annotation expanded over the whole function body (the
    caller-holds-lock contract — every statement in the function runs
    with the named lock held)."""
    out = _guarded_by_comments(src_lines)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        names = out.get(node.lineno)
        if names:
            for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                out.setdefault(ln, set()).update(names)
    return out


_FLOAT64_NAMES = (
    "np.float64", "numpy.float64", "torch.float64", "torch.double",
)


def _is_float64(node: ast.AST) -> bool:
    if _dotted(node) in _FLOAT64_NAMES:
        return True
    return isinstance(node, ast.Constant) and node.value == "float64"


def _sync_label(node: ast.Call) -> Optional[str]:
    """The torch device->host read a call makes, or None: `.item()`,
    `.cpu()`, `.tolist()`, `.numpy()`, `.synchronize()` (no arguments)
    and `torch.cuda.synchronize(...)`."""
    d = _dotted(node.func)
    if d in _SYNC_CALLS:
        return _SYNC_CALLS[d]
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _SYNC_METHODS
        and not node.args
        and not node.keywords
    ):
        return _SYNC_METHODS[node.func.attr]
    return None


def _scalar_cast(node: ast.Call) -> Optional[str]:
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in _SCALAR_CASTS
        and len(node.args) == 1
        and not isinstance(node.args[0], ast.Constant)
    ):
        return f"{node.func.id}(...) on a possible tensor"
    return None


# one-entry memo keyed on the tree's identity (holding a strong ref, so
# the id is never reused under it): several rules ask the same question of
# one module, and each question is one walk per module, not one per rule
_TREE_MEMO: Dict[str, Tuple[ast.AST, object]] = {}


def _memo_per_tree(name: str, tree: ast.AST, build):
    ent = _TREE_MEMO.get(name)
    if ent is not None and ent[0] is tree:
        return ent[1]
    res = build()
    _TREE_MEMO[name] = (tree, res)
    return res


def _loop_body_calls(tree: ast.AST) -> List[ast.Call]:
    """Every call inside a for/while body (or its else), nested scopes
    included, each once, in one pass over the tree: the node set the
    loop-body rules read (a loop's target, iterable and test are not in its
    body)."""

    def build() -> List[ast.Call]:
        out: List[ast.Call] = []

        def visit(node: ast.AST, in_loop: bool) -> None:
            if in_loop and isinstance(node, ast.Call):
                out.append(node)
            if isinstance(node, (ast.For, ast.While)):
                head = (node.test,) if isinstance(node, ast.While) else (
                    node.target, node.iter)
                for child in head:
                    visit(child, in_loop)
                for child in list(node.body) + list(node.orelse):
                    visit(child, True)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, in_loop)

        visit(tree, False)
        return out

    return _memo_per_tree("loop_body_calls", tree, build)


# ---------------------------------------------------------------- the rules


def _rule_host_sync(tree: ast.AST, path: str) -> List[Finding]:
    if not is_hot_path(path):
        return []
    out: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()

    def flag(node: ast.AST, what: str) -> None:
        key = (node.lineno, node.col_offset)
        if key in seen:
            return
        seen.add(key)
        out.append(
            Finding(
                rule="host-sync-in-hot-path",
                severity="warning",
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=f"{what} inside a hot-path loop body forces a "
                "device->host sync per iteration",
                hint="hoist the transfer out of the loop (batch it), or "
                "mark a deliberate readback with "
                "`# r2d2: disable=host-sync-in-hot-path`",
            )
        )

    for node in _loop_body_calls(tree):
        what = _sync_label(node) or _scalar_cast(node)
        if what is not None:
            flag(node, what)
    return out


def _own_nodes(root: ast.AST) -> List[ast.AST]:
    """All descendant nodes of `root` that belong to ITS scope — nested
    function/class definitions are skipped (they get their own scope
    decision when the caller iterates over them directly)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _rule_serve_step_host_sync(tree: ast.AST, path: str) -> List[Finding]:
    """Serve-plane host-sync discipline (the depth-2 pipeline's contract):

    - everywhere in serve/* except completion/warmup bodies, the classic
      loop-body checks apply (a sync per iteration stalls the batch);
    - inside stage/dispatch bodies (`_run_batch`, `_serve_iteration`,
      `_stage*`, `_dispatch*`) the device->host reads are banned
      FUNCTION-WIDE — `.item()` / `.cpu()` / `.tolist()` / `.numpy()` or a
      synchronize anywhere there serializes the serve thread against the
      device and collapses the stage/step overlap. float()/int()/bool()
      stay loop-only (scalar host math at stage time is fine).
    """
    if not is_serve_path(path):
        return []
    out: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()

    def flag(node: ast.AST, what: str, where: str) -> None:
        key = (node.lineno, node.col_offset)
        if key in seen:
            return
        seen.add(key)
        out.append(
            Finding(
                rule="blocking-host-sync-in-serve-step",
                severity="warning",
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=f"{what} {where} blocks the serve thread on the "
                "device and stalls the stage/dispatch pipeline",
                hint="materialize on the completion side (_complete*), or "
                "mark a deliberate sync with "
                "`# r2d2: disable=blocking-host-sync-in-serve-step`",
            )
        )

    def check_loops(scope: ast.AST) -> None:
        own = _own_nodes(scope)
        own_set = set(map(id, own))
        for loop in own:
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for stmt in list(loop.body) + list(loop.orelse):
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call) or id(node) not in own_set:
                        continue
                    what = _sync_label(node) or _scalar_cast(node)
                    if what is not None:
                        flag(node, what, "inside a serve loop body")

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name.startswith(_SERVE_EXEMPT_PREFIXES):
            continue
        if fn.name in _SERVE_STEP_NAMES or fn.name.startswith(_SERVE_STEP_PREFIXES):
            for node in _own_nodes(fn):
                if isinstance(node, ast.Call):
                    what = _sync_label(node)
                    if what is not None:
                        flag(node, what, f"in stage/dispatch body {fn.name}()")
        check_loops(fn)
    check_loops(tree)
    return out


# host SumTree API surface (replay/sum_tree.py + the control plane's tree
# attribute) and the receiver names that conventionally hold a HOST tree.
# The device plane's ops are module functions (dst.tree_update(...)) so
# their receiver chain never matches.
_HOST_TREE_METHODS = {
    "sample", "update", "sample_indices", "update_priorities",
    "priorities_of", "leaves",
}
_HOST_TREE_NAMES = {"tree", "sum_tree", "host_tree"}


def _rule_host_tree_in_hot_loop(tree: ast.AST, path: str) -> List[Finding]:
    if not is_hot_path(path):
        return []
    out: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()
    for node in _loop_body_calls(tree):
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_TREE_METHODS
        ):
            continue
        recv = node.func.value
        recv_d = _dotted(recv) or ""
        # jax.tree.leaves / jax.tree_util & friends are pytree ops (kept as
        # the JAX package has it: one rule, one logic)
        if recv_d.startswith(("jax.", "jnp.", "tree_util.")):
            continue
        last = (
            recv.attr
            if isinstance(recv, ast.Attribute)
            else recv.id if isinstance(recv, ast.Name) else ""
        )
        if last not in _HOST_TREE_NAMES:
            continue
        key = (node.lineno, node.col_offset)
        if key in seen:
            continue
        seen.add(key)
        out.append(
            Finding(
                rule="host-tree-in-hot-loop",
                severity="warning",
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=f"host SumTree call {recv_d or last}."
                f"{node.func.attr}(...) inside a hot-loop body: "
                "under priority_plane='device' sampling and "
                "priority write-back run over the device tree "
                "(megastep superstep); a host-tree call here syncs "
                "per iteration and forks the host tree from the "
                "device tree",
                hint="use the device ops "
                "(replay/device_sum_tree.py) or the control "
                "plane's _tree_write funnel; mark a deliberate "
                "host-plane path with "
                "`# r2d2: disable=host-tree-in-hot-loop`",
            )
        )
    return out


def _rule_float64(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()

    def flag(node: ast.AST, message: str, hint: str) -> None:
        key = (node.lineno, node.col_offset)
        if key in seen:
            return
        seen.add(key)
        out.append(
            Finding(
                rule="float64-op",
                severity="error",
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
                hint=hint,
            )
        )

    for node in ast.walk(tree):
        d = _dotted(node) if isinstance(node, ast.Attribute) else None
        if d in ("torch.float64", "torch.double"):
            flag(
                node,
                f"{d} puts float64 on the device: it doubles memory and "
                "falls off the tensor cores under the precision policy",
                "use torch.float32 (or bf16 via config.compute_dtype); "
                "host-side accumulation may use np.float64",
            )
        elif isinstance(node, ast.Call):
            cd = _dotted(node.func)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "double"
                and not node.args
                and not node.keywords
            ):
                flag(
                    node,
                    ".double() casts a tensor to float64 on its device",
                    "use .float(); host-side accumulation may use np.float64",
                )
            elif cd is not None and cd.split(".")[0] == "torch":
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if _is_float64(arg) and _dotted(arg) not in (
                        "torch.float64", "torch.double"
                    ):
                        flag(
                            arg,
                            f"float64 dtype passed to {cd}: device tensors "
                            "must stay <= 32-bit under the precision policy",
                            "use float32 (or bf16 via config.compute_dtype)",
                        )
    return out


def _rule_fault_sites(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None or d.split(".")[-1] != "fault_point":
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value not in KNOWN_SITES:
                out.append(
                    Finding(
                        rule="unknown-fault-site",
                        severity="error",
                        path=path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=f"fault site {arg.value!r} is not registered "
                        "in faults.KNOWN_SITES: chaos sweeps and the "
                        "R2D2_FAULTS operator surface cannot see it",
                        hint="add the site to KNOWN_SITES (utils/faults.py) "
                        "or fix the typo",
                    )
                )
        else:
            out.append(
                Finding(
                    rule="dynamic-fault-site",
                    severity="warning",
                    path=path,
                    line=node.lineno,
                    col=node.col_offset,
                    message="fault_point called with a non-literal site name: "
                    "statically uncheckable and unenumerable by sweeps",
                    hint="pass a string literal registered in KNOWN_SITES",
                )
            )
    return out


def _rule_snapshot_topology(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None or d.split(".")[-1] != "save_replay":
            continue
        # kw.arg is None for a **kwargs splat: statically unverifiable,
        # give it the benefit of the doubt rather than false-positive
        if any(kw.arg == "topology" or kw.arg is None for kw in node.keywords):
            continue
        out.append(
            Finding(
                rule="snapshot-missing-topology",
                severity="error",
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message="save_replay call without an explicit topology= "
                "manifest: a snapshot written without one cannot be "
                "resharded onto a changed device/host layout "
                "(replay/reshard.py)",
                hint="pass topology=snapshot_topology(replay, tp=cfg.tp_size)",
            )
        )
    return out


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not (
            isinstance(node.value, ast.Call)
            and _dotted(node.value.func) in ("threading.Lock", "threading.RLock")
        ):
            continue
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                locks.add(t.attr)
    return locks


def _self_attr_writes(node: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(attr name, node) for every `self.X = / self.X op= / self.X[...] =`
    in the subtree, NOT descending into nested function defs."""
    out: List[Tuple[str, ast.AST]] = []

    def targets_of(stmt) -> List[ast.AST]:
        if isinstance(stmt, ast.Assign):
            return list(stmt.targets)
        if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            return [stmt.target]
        return []

    def visit(n: ast.AST) -> None:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            for t in targets_of(child):
                base = t
                if isinstance(base, ast.Subscript):
                    base = base.value
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    out.append((base.attr, child))
            visit(child)

    visit(node)
    return out


def _rule_lock_discipline(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = [
            n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]

        def lock_blocks(method) -> List[ast.With]:
            blocks = []
            for node in ast.walk(method):
                if not isinstance(node, ast.With):
                    continue
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call):  # e.g. lock.acquire-style wrappers
                        ctx = ctx.func
                    if (
                        isinstance(ctx, ast.Attribute)
                        and isinstance(ctx.value, ast.Name)
                        and ctx.value.id == "self"
                        and ctx.attr in locks
                    ):
                        blocks.append(node)
                        break
            return blocks

        guarded: Set[str] = set()
        per_method_blocks: Dict[str, List[ast.With]] = {}
        for m in methods:
            blocks = lock_blocks(m)
            per_method_blocks[m.name] = blocks
            for b in blocks:
                for attr, _ in _self_attr_writes(b):
                    guarded.add(attr)
        guarded -= locks
        if not guarded:
            continue

        for m in methods:
            if m.name == "__init__":
                continue
            locked_nodes: Set[int] = set()
            for b in per_method_blocks[m.name]:
                for sub in ast.walk(b):
                    locked_nodes.add(id(sub))
            for attr, node in _self_attr_writes(m):
                if attr in guarded and id(node) not in locked_nodes:
                    out.append(
                        Finding(
                            rule="lock-discipline",
                            severity="warning",
                            path=path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=f"self.{attr} is written under "
                            f"`with self.<lock>` elsewhere in "
                            f"{cls.name} but bare here: the write races "
                            "the guarded ones across threads",
                            hint="take the lock, or mark a single-threaded "
                            "phase with `# r2d2: disable=lock-discipline`",
                        )
                    )
    return out


# block-codec decode / disk page-in surface (replay/codec.py +
# replay/disk_tier.py). Method-style receivers (x.decode_field(...)) and
# bare names (decode_field(...)) both match: the contract is positional
# ("not on the learner/serve step"), not receiver-typed.
_DECODE_CALL_NAMES = {"decode_field", "decode_block", "read_block"}
_MMAP_CALLS = {"np.memmap", "numpy.memmap", "mmap.mmap"}


def _rule_codec_decode_in_hot_loop(tree: ast.AST, path: str) -> List[Finding]:
    if not (is_hot_path(path) or is_serve_path(path)):
        return []
    out: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()
    for node in _loop_body_calls(tree):
        d = _dotted(node.func) or ""
        last = d.split(".")[-1]
        if d in _MMAP_CALLS:
            what = f"{d}(...)"
        elif last in _DECODE_CALL_NAMES:
            what = f"{d or last}(...)"
        else:
            continue
        key = (node.lineno, node.col_offset)
        if key in seen:
            continue
        seen.add(key)
        out.append(
            Finding(
                rule="codec-decode-in-hot-loop",
                severity="warning",
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=f"{what} inside a hot-loop body: block-codec "
                "inflate / mmap page-in belongs on the replay "
                "staging thread (tiered_store._fill_disk_rows), not "
                "the learner/serve step — a per-iteration decode "
                "erases the three-tier overlap",
                hint="sample through TieredReplayBuffer (the staging "
                "thread decodes behind the prefetch queue), or mark "
                "a deliberate cold-path decode with "
                "`# r2d2: disable=codec-decode-in-hot-loop`",
            )
        )
    return out


_RULES = (
    _rule_host_sync,
    _rule_serve_step_host_sync,
    _rule_float64,
    _rule_fault_sites,
    _rule_snapshot_topology,
    _rule_lock_discipline,
    _rule_host_tree_in_hot_loop,
    _rule_codec_decode_in_hot_loop,
)


# ---------------------------------------------------------------- driver


def analyze_source(
    text: str, path: str
) -> Tuple[List[Finding], List[Finding]]:
    """Run every AST rule over one file's source. Returns
    (findings, suppressed) — suppressed findings matched a
    `# r2d2: disable=` comment and do not gate."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return (
            [
                Finding(
                    rule="syntax-error",
                    severity="error",
                    path=path,
                    line=e.lineno or 0,
                    col=e.offset or 0,
                    message=f"file does not parse: {e.msg}",
                )
            ],
            [],
        )
    src_lines = text.splitlines()
    suppress = _suppressions(src_lines)
    guards = guarded_by_map(tree, src_lines)
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for rule_fn in _RULES:
        for f in rule_fn(tree, path):
            rules_here = suppress.get(f.line, set())
            if f.rule in rules_here or "all" in rules_here:
                suppressed.append(f)
            elif f.rule == "lock-discipline" and guards.get(f.line):
                # a guarded-by annotation asserts the named lock is held
                # at this write (caller-holds-lock contract); the
                # concurrency pass checks the assertion interprocedurally
                suppressed.append(f)
            else:
                findings.append(f)
    return findings, suppressed


def collect_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d != "__pycache__" and not d.startswith(".")
                )
                out.extend(
                    os.path.join(root, f) for f in sorted(files) if f.endswith(".py")
                )
        elif p.endswith(".py") and os.path.exists(p):
            out.append(p)
    return sorted(dict.fromkeys(out))


def analyze_paths(
    paths: Iterable[str],
) -> Tuple[List[Finding], List[Finding]]:
    """AST-lint every .py file under `paths` (files or directories).
    Returns (findings, suppressed), stable-sorted."""
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for path in collect_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        f, s = analyze_source(text, path)
        findings.extend(f)
        suppressed.extend(s)
    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)
    return findings, suppressed
