"""The port stands alone: importing r2d2_tpu_torch and every one of its
modules (and running chip_smoke.py) loads nothing of JAX, flax, optax or the
JAX package, nor ml_dtypes (the chip machine's installs do not name it: the
port keeps bf16 carries on the host as uint16 bits), the serving plane, the
int8 quantization, the transport with its pod harness and the
data-parallel planes (parallel/, the sharded and multihost stores, the
ranks' helper tests/torch_multihost_child.py) and M13b's modules (the
reshard, the placement table, the shard-local tp network, the sharded
runners) and the source analysis (analysis/, its CLI run over the package;
the graph checks load torch, the rest not even that) on their own
included, and no source line of the package, chip_smoke.py, the port's
demos, its tools or the helpers its card suite shares imports them;
chip_smoke.py fails cleanly where it cannot run."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "r2d2_tpu", "ml_dtypes")

IMPORT_ALL = """
import importlib, pkgutil, sys
import r2d2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(r2d2_tpu_torch.__path__, "r2d2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    return env


def test_importing_every_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    # every module: the fault plane, snapshots, tiers, the serving plane,
    # the transport, the data-parallel planes, M13b's modules and the
    # analysis package (8: its __init__, __main__, findings, ast_rules,
    # concurrency, determinism, graph_rules and cli) included
    assert int(count) >= 92
    assert bad.strip() == "[]"


SERVE_ONLY = """
import sys
import r2d2_tpu_torch.ops.quantize, r2d2_tpu_torch.serve, r2d2_tpu_torch.serve.__main__
from r2d2_tpu_torch.serve import PolicyServer, PolicyClient, reference_act
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(bad)
"""


def test_the_serving_plane_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", SERVE_ONLY.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


TRANSPORT_ONLY = """
import sys
sys.path.insert(0, "tests")
import r2d2_tpu_torch.transport.podloop, torch_podloop
from r2d2_tpu_torch.transport import BlockStreamPublisher, IngestService, framing
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(bad)
"""


def test_the_transport_and_its_pod_harness_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", TRANSPORT_ONLY.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


PARALLEL_ONLY = """
import sys
sys.path.insert(0, "tests")
import r2d2_tpu_torch.parallel, r2d2_tpu_torch.parallel.mesh, r2d2_tpu_torch.parallel.multihost
import r2d2_tpu_torch.replay.sharded_store, r2d2_tpu_torch.replay.multihost_store
import torch_multihost_child
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(bad)
"""


def test_the_data_parallel_planes_and_their_child_load_no_jax():
    """parallel/, the sharded and multihost stores and the ranks' helper
    (tests/torch_multihost_child.py), on their own."""
    out = subprocess.run(
        [sys.executable, "-c", PARALLEL_ONLY.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


ELASTIC_ONLY = """
import sys
import r2d2_tpu_torch.replay.reshard, r2d2_tpu_torch.parallel.sharding_map
import r2d2_tpu_torch.models.tp, r2d2_tpu_torch.megastep
from r2d2_tpu_torch.megastep import MultiHostFusedRunner, ShardedFusedRunner
from r2d2_tpu_torch.learner import ShardedAdam
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(bad)
"""


def test_the_reshard_and_the_tp_fsdp_modules_load_no_jax():
    """replay/reshard.py, parallel/sharding_map.py, models/tp.py and the
    sharded runners, on their own."""
    out = subprocess.run(
        [sys.executable, "-c", ELASTIC_ONLY.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


ANALYSIS_ONLY = """
import sys
import r2d2_tpu_torch.analysis, r2d2_tpu_torch.analysis.__main__
from r2d2_tpu_torch.analysis import ast_rules, cli, concurrency, determinism, findings
rc = cli.main(["--concurrency", "--determinism", "--format", "json",
               "r2d2_tpu_torch/actor.py", "r2d2_tpu_torch/serve"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(rc, bad, "torch" in sys.modules)
"""


def test_the_analysis_package_loads_no_jax():
    """The analysis package, its CLI run over part of the port included:
    it loads neither JAX nor the JAX package (nor torch: it reads source)."""
    out = subprocess.run(
        [sys.executable, "-c", ANALYSIS_ONLY.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 [] False"


GRAPH_ONLY = """
import sys
import r2d2_tpu_torch.analysis.graph_rules as g
findings = g.scan_act("fp32", device="cpu") + g.scan_liveloop_gather("bf16", device="cpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(len(findings), bad, "torch" in sys.modules)
"""


@pytest.mark.parametrize("case", ["graph_rules", "cli without --graph"])
def test_graph_rules_load_no_jax_and_the_analysis_without_it_no_torch(case):
    """graph_rules (run on two entry points) loads torch and no JAX; the
    analysis package and its CLI without --graph load neither."""
    code = GRAPH_ONLY if case == "graph_rules" else ANALYSIS_ONLY
    out = subprocess.run(
        [sys.executable, "-c", code.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    want = "0 [] True" if case == "graph_rules" else "0 [] False"
    assert out.stdout.strip().splitlines()[-1] == want


def _python_files():
    for d, _, names in os.walk(os.path.join(ROOT, "r2d2_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)
    yield os.path.join(ROOT, "chip_smoke.py")
    for n in sorted(os.listdir(os.path.join(ROOT, "examples"))):
        if n.startswith("torch_") and n.endswith(".py"):
            yield os.path.join(ROOT, "examples", n)
    for n in sorted(os.listdir(os.path.join(ROOT, "tools"))):
        if n.endswith(".py"):
            yield os.path.join(ROOT, "tools", n)
    # the helpers the card's suite and chip_smoke.py share (the pod harness,
    # the multihost ranks' helper)
    for n in sorted(os.listdir(os.path.join(ROOT, "tests"))):
        if n.startswith("torch_") and n.endswith(".py"):
            yield os.path.join(ROOT, "tests", n)


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN))
    hits = [
        f"{path}:{i}: {line.strip()}"
        for path in _python_files()
        for i, line in enumerate(open(path), 1)
        if pattern.match(line)
    ]
    assert hits == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")],
        cwd=cwd, env=_clean_env() if cwd == ROOT else {**_clean_env(), "PYTHONPATH": ""},
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_chip_smoke_alone_fails_without_the_package(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
