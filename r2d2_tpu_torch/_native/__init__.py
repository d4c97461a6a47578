"""ctypes loader for the native replay core (replay_core.cpp).

The port's own copy of the JAX package's replay core: the sum-tree update
and sample, the IS weights and the window gathers of batch assembly, with
a plain C ABI. At first use it is built with
``g++ -O3 -shared -fPIC -std=c++17 -fopenmp`` into ``r2d2_tpu_torch/_build/``
(listed in .gitignore), under a name that carries a hash of the source and
the flags, as ``ops/_build.py`` names the kernels' builds. The compiler
writes to a temporary file that is then renamed into place, so processes
that build at once race harmlessly.

It is loaded with ``ctypes.CDLL``, so a call releases the interpreter lock
while it runs. There is no fallback: when the build or the load fails,
:func:`load_native` raises with the compiler's output. The numpy path is
taken only where the config asks for it (``use_native_replay=False``).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "replay_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp")

_lock = threading.Lock()
_core: Optional["NativeReplayCore"] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path(src: Path, build_dir: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return build_dir / f"libreplay_core-{digest}.so"


def build(src: Optional[Path] = None, build_dir: Optional[Path] = None,
          cxx: str = "g++") -> Path:
    """Compile `src` (default: SRC) into `build_dir` (default: BUILD_DIR)
    unless a build of it under the same flags exists; -> the library's
    path. Raises RuntimeError with the compiler's output."""
    src, build_dir = Path(src or SRC), Path(build_dir or BUILD_DIR)
    out = library_path(src, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"the native replay core did not build: {cxx} failed to run: "
                           f"{e}") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"the native replay core did not build ({cxx} {' '.join(CXX_FLAGS)} {src}, exit "
            f"{r.returncode}); set use_native_replay=False for the numpy path:\n"
            f"{r.stdout}{r.stderr}"
        )
    os.replace(tmp, out)  # atomic: two processes building the same source race harmlessly
    return out


class NativeReplayCore:
    """The interface replay/sum_tree.py's `native` hook expects, plus the
    window gathers of replay/replay_buffer.py's batch assembly."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.tree_update.argtypes = [_f64p, ctypes.c_int64, _i64p, _f64p,
                                    ctypes.c_int64, ctypes.c_double]
        lib.tree_update.restype = None
        lib.tree_sample.argtypes = [_f64p, ctypes.c_int64, _f64p, ctypes.c_int64, _i64p]
        lib.tree_sample.restype = None
        lib.gather_windows.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p,
                                       ctypes.c_int64, ctypes.c_int64, _u8p]
        lib.gather_windows.restype = None
        lib.gather_windows_multi.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _i64p, ctypes.c_int64, ctypes.c_int64, _i64p,
            _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.gather_windows_multi.restype = None
        lib.is_weights.argtypes = [_f64p, ctypes.c_int64, _i64p, ctypes.c_int64,
                                   ctypes.c_double, _f32p]
        lib.is_weights.restype = ctypes.c_int64
        lib.gather_threads.argtypes = []
        lib.gather_threads.restype = ctypes.c_int64

    def gather_threads(self) -> int:
        """The OpenMP threads a gather runs on."""
        return int(self._lib.gather_threads())

    # --- sum tree ---------------------------------------------------------

    def tree_update(self, tree: np.ndarray, num_layers: int, idxes: np.ndarray,
                    td_errors: np.ndarray, alpha: float) -> None:
        idxes = np.ascontiguousarray(idxes, np.int64)
        td = np.ascontiguousarray(td_errors, np.float64)
        self._lib.tree_update(tree, num_layers, idxes, td, len(idxes), alpha)

    def tree_sample(self, tree: np.ndarray, num_layers: int,
                    prefixsums: np.ndarray) -> np.ndarray:
        prefixsums = np.ascontiguousarray(prefixsums, np.float64)
        out = np.empty(len(prefixsums), np.int64)
        self._lib.tree_sample(tree, num_layers, prefixsums, len(prefixsums), out)
        return out

    def is_weights(self, tree: np.ndarray, num_layers: int, nodes: np.ndarray,
                   beta: float) -> np.ndarray:
        nodes = np.ascontiguousarray(nodes, np.int64)
        out = np.empty(len(nodes), np.float32)
        self._lib.is_weights(tree, num_layers, nodes, len(nodes), beta, out)
        return out

    # --- batch assembly ---------------------------------------------------

    def gather_windows(self, store: np.ndarray, b: np.ndarray, win_start: np.ndarray,
                       T: int) -> np.ndarray:
        """store: (num_blocks, slot, *row_shape) C-contiguous; -> (B, T,
        *row_shape), row indices clamped to [0, slot-1]."""
        if not store.flags["C_CONTIGUOUS"]:
            raise ValueError("gather_windows needs a C-contiguous store")
        slot, row_shape = store.shape[1], store.shape[2:]
        row_bytes = int(np.prod(row_shape, dtype=np.int64)) * store.itemsize
        b = np.ascontiguousarray(b, np.int64)
        win_start = np.ascontiguousarray(win_start, np.int64)
        out = np.empty((len(b), T, *row_shape), store.dtype)
        self._lib.gather_windows(store.view(np.uint8).reshape(-1), slot, row_bytes, b,
                                 win_start, len(b), T, out.view(np.uint8).reshape(-1))
        return out

    def gather_windows_multi(self, stores, b: np.ndarray, win_start: np.ndarray,
                             T: int) -> List[np.ndarray]:
        """The same (b, win_start) windows from several stores that share
        the slot axis, in one native call; one (B, T, *row_shape) array per
        store, with gather_windows' clamp."""
        b = np.ascontiguousarray(b, np.int64)
        win_start = np.ascontiguousarray(win_start, np.int64)
        slot = stores[0].shape[1]
        outs, row_bytes = [], np.empty(len(stores), np.int64)
        store_ptrs = (ctypes.c_void_p * len(stores))()
        out_ptrs = (ctypes.c_void_p * len(stores))()
        for f, store in enumerate(stores):
            if not store.flags["C_CONTIGUOUS"] or store.shape[1] != slot:
                raise ValueError("gather_windows_multi needs C-contiguous stores of one slot")
            row_bytes[f] = int(np.prod(store.shape[2:], dtype=np.int64)) * store.itemsize
            out = np.empty((len(b), T, *store.shape[2:]), store.dtype)
            outs.append(out)
            store_ptrs[f] = store.ctypes.data
            out_ptrs[f] = out.ctypes.data
        self._lib.gather_windows_multi(store_ptrs, row_bytes, len(stores), slot, b, win_start,
                                       len(b), T, out_ptrs)
        return outs


def load_native() -> NativeReplayCore:
    """Build (if needed) and load the core, once per process. Raises
    RuntimeError when the build fails and OSError when the load does."""
    global _core
    with _lock:
        if _core is None:
            _core = NativeReplayCore(ctypes.CDLL(str(build())))
        return _core
