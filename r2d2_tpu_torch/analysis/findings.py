"""Findings model for the port's static-analysis plane (port of
r2d2_tpu/analysis/findings.py, unchanged in content).

One shape for every checker — the AST lints and the interprocedural
concurrency and determinism passes alike — so the CLI, the tier-1 gate
(tests/test_torch_analysis*.py), and ad-hoc callers all consume the same records:
rule id, severity, file:line, message, and a fix hint. Rendering is fully
deterministic: stable-sorted (path, line, col, rule, message) AND deduped
(identical findings from overlapping scans — e.g. a file passed twice, or
a rule family run both standalone and via the CLI — collapse to one), so
text/JSON/SARIF outputs diff clean in CI.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str  # one of SEVERITIES
    path: str  # source file, or "<label>" for a whole-program finding
    line: int  # 1-based; 0 for whole-program findings
    col: int  # 0-based column; 0 for whole-program findings
    message: str
    hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule, self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
        }

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        out = f"{loc} [{self.severity}] {self.rule}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def stable_sort(findings: Iterable[Finding]) -> List[Finding]:
    """Sorted AND deduped: identical findings from overlapping scans
    (same rule/severity/location/message/hint) collapse to one record."""
    return sorted(dict.fromkeys(findings), key=Finding.sort_key)


def render_text(findings: Iterable[Finding]) -> str:
    fs = stable_sort(findings)
    if not fs:
        return "no findings"
    lines = [f.render() for f in fs]
    lines.append(f"{len(fs)} finding{'s' if len(fs) != 1 else ''}")
    return "\n".join(lines)


def render_json(findings: Iterable[Finding]) -> str:
    fs = stable_sort(findings)
    return json.dumps(
        {"count": len(fs), "findings": [f.to_dict() for f in fs]},
        indent=2,
        sort_keys=True,
    )


# SARIF severity levels per the 2.1.0 spec (sarifv2.1.0 §3.27.10)
_SARIF_LEVELS = {"error": "error", "warning": "warning", "info": "note"}


def render_sarif(findings: Iterable[Finding]) -> str:
    """SARIF 2.1.0 for CI annotation. Rule ids are the stable in-repo
    rule names; locations map to file + 1-based line/column regions
    (whole-program findings keep their `<label>` pseudo path with a
    line-1 region — SARIF requires a positive startLine).
    Output is stable-sorted + deduped like the JSON renderer."""
    fs = stable_sort(findings)
    rules = sorted({f.rule for f in fs})
    results = []
    for f in fs:
        text = f.message if not f.hint else f"{f.message} (hint: {f.hint})"
        results.append(
            {
                "ruleId": f.rule,
                "level": _SARIF_LEVELS[f.severity],
                "message": {"text": text},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {
                                "startLine": max(f.line, 1),
                                "startColumn": f.col + 1,
                            },
                        }
                    }
                ],
            }
        )
    doc = {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
        "master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "r2d2-analyze",
                        "rules": [{"id": r} for r in rules],
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
