"""The port's native replay core (r2d2_tpu_torch/_native) against the JAX
package's numpy replay path and the port's own.

- tree update: the same tree to rtol 1e-12 (duplicate indices included);
- tree sample: the same indices, IS weights to rtol 1e-6;
- gather_windows and gather_windows_multi: bit for bit against a numpy
  fancy index, on windows clamped at either end and in range;
- ReplayBuffer batches through the native core against the JAX package's
  ReplayBuffer(use_native_replay=False): bit for bit, through ring wraps
  and stale priority updates;
- the build: two processes building into one clean directory at once both
  load a working library, and a failed build raises with the compiler's
  output instead of falling back to numpy.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as RefReplay
from r2d2_tpu.replay.sum_tree import SumTree as RefSumTree
from r2d2_tpu_torch import _native
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.sum_tree import SumTree
from tests.test_torch_replay import _assert_same, _blocks, _stream

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def core():
    return _native.load_native()


@pytest.mark.parametrize("capacity", [1, 5, 16, 100, 1000])
def test_tree_update_and_sample_match_numpy(core, capacity):
    rng = np.random.default_rng(capacity)
    ref = RefSumTree(capacity, 0.9, 0.6)
    port_np = SumTree(capacity, 0.9, 0.6)
    port = SumTree(capacity, 0.9, 0.6, native=core)
    for _ in range(6):
        n = int(rng.integers(1, 2 * capacity + 2))
        idx = rng.integers(0, capacity, size=n)  # duplicates included
        td = rng.uniform(0.0, 2.0, size=n)
        td[0] = 0.0
        for t in (ref, port_np, port):
            t.update(idx, td)
        np.testing.assert_allclose(port.tree, ref.tree, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(port_np.tree, ref.tree)
        if ref.total > 0:
            draws = [t.sample(9, np.random.default_rng(2)) for t in (ref, port_np, port)]
            (ri, rw), (pi_np, pw_np), (pi, pw) = draws
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pi_np, ri)
            assert pi.dtype == ri.dtype and pw.dtype == rw.dtype == np.float32
            np.testing.assert_allclose(pw, rw, rtol=1e-6)


def _windows(rng, nb, slot, B, T):
    """Block indices and window starts: below 0, past the slot's end and
    in range."""
    b = rng.integers(0, nb, size=B)
    start = np.concatenate([rng.integers(-T, 0, B // 3),
                            rng.integers(slot - T + 1, slot, B // 3),
                            rng.integers(0, slot - T + 1, B - 2 * (B // 3))])
    return b, start


def _numpy_gather(store, b, start, T):
    rows = np.clip(start[:, None] + np.arange(T)[None, :], 0, store.shape[1] - 1)
    return store[b[:, None], rows]


@pytest.mark.parametrize("row_shape,dtype", [((), np.uint8), ((), np.float32),
                                             ((7, 5, 1), np.uint8), ((3, 4), np.uint16)])
def test_gather_windows_bit_for_bit(core, row_shape, dtype):
    rng = np.random.default_rng(3)
    nb, slot, B, T = 6, 21, 12, 8
    store = rng.integers(0, 250, size=(nb, slot, *row_shape)).astype(dtype)
    b, start = _windows(rng, nb, slot, B, T)
    got = core.gather_windows(store, b, start, T)
    want = _numpy_gather(store, b, start, T)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_gather_windows_multi_bit_for_bit(core):
    rng = np.random.default_rng(4)
    nb, slot, B, T = 5, 17, 9, 6
    stores = [rng.integers(0, 255, size=(nb, slot, 6, 6, 1)).astype(np.uint8),
              rng.integers(0, 4, size=(nb, slot)).astype(np.uint8),
              rng.normal(size=(nb, slot)).astype(np.float32)]
    b, start = _windows(rng, nb, slot, B, T)
    outs = core.gather_windows_multi(stores, b, start, T)
    for store, got in zip(stores, outs):
        np.testing.assert_array_equal(got, _numpy_gather(store, b, start, T))
        np.testing.assert_array_equal(got, core.gather_windows(store, b, start, T))


@pytest.fixture(scope="module")
def cfgs():
    ref = jax_tiny_test().replace(use_native_replay=False, batch_size=16)
    port = tiny_test().replace(batch_size=16)
    assert port.use_native_replay
    return ref, port


def test_native_batches_match_the_jax_numpy_path(cfgs):
    ref_cfg, port_cfg = cfgs
    stream = _stream(port_cfg, seed=1, n_episodes=30)
    ref_blocks = list(_blocks(RefAccumulator(ref_cfg), ref_cfg, stream))
    port_blocks = list(_blocks(SequenceAccumulator(port_cfg), port_cfg, stream))
    ref, port = RefReplay(ref_cfg), ReplayBuffer(port_cfg)
    assert ref.native is None and port.native is not None
    feed = list(zip((ref_blocks * 2)[: port_cfg.num_blocks + 7],
                    (port_blocks * 2)[: port_cfg.num_blocks + 7]))
    rng_ref, rng_port = np.random.default_rng(3), np.random.default_rng(3)
    td_rng = np.random.default_rng(4)
    pending, sampled = [], 0
    for i, (r, p) in enumerate(feed):
        ref.add_block(*r)
        port.add_block(*p)
        if len(port) < 48 or i % 3:
            continue
        rb, pb = ref.sample_batch(rng_ref), port.sample_batch(rng_port)
        sampled += 1
        for f in dataclasses.fields(pb):
            _assert_same(getattr(pb, f.name), getattr(rb, f.name), f"sample {i}.{f.name}")
        td = td_rng.uniform(0.0, 3.0, size=port_cfg.batch_size).astype(np.float32)
        pending.append((pb.idxes, td, pb.old_ptr, pb.old_advances))
        if len(pending) > 1:
            args = pending.pop(0)
            ref.update_priorities(*args)
            port.update_priorities(*args)
        np.testing.assert_allclose(port.tree.tree, ref.tree.tree, rtol=1e-12, atol=0)
    assert sampled > 5 and port.block_ptr == ref.block_ptr


BUILD_ONE = """
import sys
from r2d2_tpu_torch import _native
path = _native.build(build_dir=sys.argv[1])
core = _native.NativeReplayCore(__import__("ctypes").CDLL(str(path)))
print(path, core.gather_threads())
"""


def test_concurrent_builds_into_a_clean_directory(tmp_path):
    build_dir = tmp_path / "_build"
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(build_dir)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    paths = {out.split()[0] for out, _ in outs}
    assert len(paths) == 1 and all(int(out.split()[1]) >= 1 for out, _ in outs)
    # one library, no temporary file left behind
    assert sorted(p.name for p in build_dir.iterdir()) == [os.path.basename(paths.pop())]


def test_a_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    broken = tmp_path / "replay_core.cpp"
    broken.write_text('extern "C" { int tree_update( }\n')
    with pytest.raises(RuntimeError, match="did not build") as err:
        _native.build(src=broken, build_dir=tmp_path / "b")
    assert "error" in str(err.value)  # the compiler's own output
    assert not any((tmp_path / "b").iterdir())
    # the replay buffer raises too: no numpy fallback unless asked for
    monkeypatch.setattr(_native, "SRC", broken)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(_native, "_core", None)
    with pytest.raises(RuntimeError, match="did not build"):
        ReplayBuffer(tiny_test())
    assert ReplayBuffer(tiny_test().replace(use_native_replay=False)).native is None
