"""The port stands alone: importing r2d2_tpu_torch and every one of its
modules (and running chip_smoke.py) loads nothing of JAX, flax, optax or the
JAX package, and chip_smoke.py fails cleanly where it cannot run."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "r2d2_tpu")

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
    assert int(count) >= 20  # every module of the slice was imported
    assert bad.strip() == "[]"


def _python_files():
    for d, _, names in os.walk(os.path.join(ROOT, "r2d2_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)
    yield os.path.join(ROOT, "chip_smoke.py")


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
