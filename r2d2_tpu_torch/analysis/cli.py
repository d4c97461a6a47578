"""CLI for the port's analysis plane.

    python -m r2d2_tpu_torch.analysis [--format text|json|sarif]
                                      [--changed-only] [--concurrency]
                                      [--determinism]
                                      [--graph [--device cpu|cuda]]
                                      [paths...]

Default paths: the r2d2_tpu_torch package tree. Exit status 1 when any
unsuppressed finding remains (suppressed ones are counted in text mode but
never gate). `--changed-only` narrows the AST lints to the package's files
reported by `git diff --name-only HEAD` plus its untracked .py files — the
fast local loop. `--concurrency` runs the interprocedural thread/lock pass
(concurrency.py) and `--determinism` the resume-completeness /
nondeterminism-taint / chaos-coverage pass (determinism.py); both are
interprocedural, so they always scan the full requested tree. `--format
sarif` emits SARIF 2.1.0 for CI annotation; rule indices are stable
because the driver's rule table is the sorted set of rule ids present.
`--graph` also runs the port's train, act, superstep and serve entry points
at small shapes and holds them to graph_rules.py's contracts (slower:
imports torch and the model stack), on `--device` (the card by default;
with no card it refuses unless given `--device cpu`); combined with
`--changed-only` its results are served from a cache keyed on a hash of
the entry points' sources and the device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List

from r2d2_tpu_torch.analysis import ast_rules
from r2d2_tpu_torch.analysis.findings import render_json, render_sarif, render_text

# the default tree: the r2d2_tpu_torch package
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --changed-only --graph result cache, relative to the repo root (see
# graph_rules.scan_entry_points_cached); untracked, cheap to delete
_GRAPH_CACHE = ".r2d2_torch_graph_cache.json"


def _changed_files(repo_root: str) -> List[str]:
    """Tracked-modified plus untracked .py files, absolute paths."""
    out: List[str] = []
    for args in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            res = subprocess.run(
                args, cwd=repo_root, capture_output=True, text=True, check=True
            )
        except (OSError, subprocess.CalledProcessError):
            continue
        out.extend(
            os.path.join(repo_root, line)
            for line in res.stdout.splitlines()
            if line.endswith(".py")
        )
    return sorted(dict.fromkeys(out))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m r2d2_tpu_torch.analysis",
        description="torch-aware static analysis of the port: host-sync/"
        "float64/fault-site/lock lints, the interprocedural "
        "concurrency and determinism passes, and the graph checks",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the r2d2_tpu_torch "
        "package)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text"
    )
    parser.add_argument(
        "--changed-only", action="store_true",
        help="lint only the package's git-changed/untracked .py files "
        "(fast local loop)",
    )
    parser.add_argument(
        "--concurrency", action="store_true",
        help="also run the interprocedural concurrency pass: thread-root "
        "inventory, lock-order cycles, cross-thread write guards, and "
        "blocking-under-lock",
    )
    parser.add_argument(
        "--determinism", action="store_true",
        help="also run the interprocedural determinism pass: resume-"
        "completeness of carry/restore state, wall-clock/unsorted-scan/"
        "unseeded-RNG taint into deterministic sinks, and chaos-site "
        "coverage",
    )
    parser.add_argument(
        "--graph", action="store_true",
        help="also run the train/act/superstep/serve entry points at both "
        "precisions and hold them to the graph checks (slow: imports torch; "
        "cached under --changed-only)",
    )
    parser.add_argument(
        "--device", choices=("cpu", "cuda"), default="cuda",
        help="where --graph runs the entry points (default: the card; no "
        "fallback to the CPU)",
    )
    args = parser.parse_args(argv)
    if args.graph and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            parser.error("--graph runs on the card and no CUDA device is available; "
                         "pass --device cpu to run it on the CPU")

    pkg_root = PKG_ROOT
    if args.changed_only:
        # the repo holds both packages: torch rules lint only the port
        paths = [
            p for p in _changed_files(os.path.dirname(pkg_root))
            if os.path.abspath(p).startswith(pkg_root + os.sep)
        ]
    elif args.paths:
        paths = args.paths
    else:
        paths = [pkg_root]

    findings, suppressed = ast_rules.analyze_paths(paths)
    # the interprocedural passes: a changed file's hazards can live in its
    # callers, so they always cover the full requested tree (the package
    # root under --changed-only)
    whole = args.paths if args.paths else [pkg_root]
    if args.concurrency:
        from r2d2_tpu_torch.analysis import concurrency

        cf, cs = concurrency.analyze_paths(whole)
        findings = findings + cf
        suppressed = suppressed + cs
    if args.determinism:
        from r2d2_tpu_torch.analysis import determinism

        df, ds = determinism.analyze_paths(whole)
        findings = findings + df
        suppressed = suppressed + ds
    if args.graph:
        from r2d2_tpu_torch.analysis import graph_rules

        if args.changed_only:
            cache = os.path.join(os.path.dirname(pkg_root), _GRAPH_CACHE)
            findings = findings + graph_rules.scan_entry_points_cached(
                cache, device=args.device)
        else:
            findings = findings + graph_rules.scan_entry_points(device=args.device)

    if args.format == "json":
        print(render_json(findings))
    elif args.format == "sarif":
        print(render_sarif(findings))
    else:
        print(render_text(findings))
        if suppressed:
            print(f"({len(suppressed)} suppressed)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
