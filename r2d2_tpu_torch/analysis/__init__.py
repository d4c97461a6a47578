"""The port's static-analysis plane: AST lints and the interprocedural
concurrency and determinism passes over the port's source (M17a), and the
graph checks over its entry points (M17b, `graph_rules`, the counterpart
of the JAX package's jaxpr scanners), with one findings model and a CLI
(`python -m r2d2_tpu_torch.analysis`). Port of r2d2_tpu/analysis/; the
rule catalogs and the four dropped rules are in each module's docstring.

Import surface: everything but `graph_rules` is stdlib-only (the
fault-site registry included), so the analyzer runs with neither torch
nor jax; the interprocedural passes (`concurrency`, `determinism`) and
the graph checks (which import torch and the port's model stack) are
loaded lazily by their CLI flags.
"""

from r2d2_tpu_torch.analysis.findings import (  # noqa: F401
    SEVERITIES,
    Finding,
    render_json,
    render_text,
    stable_sort,
)
