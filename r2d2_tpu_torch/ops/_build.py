"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source under ``r2d2_tpu_torch/csrc/`` has a plain C interface and is
compiled on its own (with the headers it includes from
``csrc/*.cuh``) into a shared library in ``r2d2_tpu_torch/_build/``
(listed in .gitignore). The first kernel loaded builds every source, in
parallel: one nvcc process each, all started together. The library name
carries a hash of the source and the flags, so an edited source is never
served by a stale build.

Nothing here runs at import time; the CPU test suite imports this module
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, kept in the log
    "-Xptxas", "-v",
)

# the text nvcc printed for each library built by this process, and the
# seconds from the start of its build() to the end of its nvcc
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def sources() -> List[str]:
    """The kernel names: one per csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's identity
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current build, all in
    parallel; raise with nvcc's output if any compile fails."""
    names = list(names)
    out = {n: _library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); the CUDA "
                           "toolkit is needed to build the kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))

    def finish(n, proc):
        build_logs[n] = proc.communicate()[0]
        build_seconds[n] = time.perf_counter() - t0

    waits = [threading.Thread(target=finish, args=(n, proc)) for n, (_, proc) in procs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed = []
    for n, (tmp, proc) in procs.items():
        log = build_logs[n]
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode})\n{log}")
            os.unlink(tmp)
        else:
            # atomic: a concurrent builder of the same source races benignly
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def _built() -> Dict[str, Path]:
    return build(sources())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu; the first call builds every
    source that has no current build."""
    return ctypes.CDLL(str(_built()[name]))
