"""The port's static-analysis plane (M17a): AST lints and the
interprocedural concurrency and determinism passes over the port's
source, with one findings model and a CLI (`python -m
r2d2_tpu_torch.analysis`). Port of r2d2_tpu/analysis/ without its jaxpr
scanners; the rule catalogs and the four dropped rules are in each
module's docstring.

Import surface: everything is stdlib-only (the fault-site registry
included), so the analyzer runs with neither torch nor jax; the
interprocedural passes (`concurrency`, `determinism`) are loaded lazily
by their CLI flags.
"""

from r2d2_tpu_torch.analysis.findings import (  # noqa: F401
    SEVERITIES,
    Finding,
    render_json,
    render_text,
    stable_sort,
)
