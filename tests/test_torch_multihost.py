"""The port's multi-process plane (replay/multihost_store.py,
parallel/multihost.py, train._MultiHostPlane) on the CPU with gloo.

Two processes owning two shards each (dp=4, tests/torch_multihost_child.py)
compute the losses and parameters of one process owning all four bit for
bit, and JAX's multihost_child.build_and_run on its 4-device mesh to rtol
1e-4 / atol 1e-5. In one process: the multihost data plane and the sharded
store give the same update on the same blocks and coordinates, and a K=2
dispatch is two single collective steps on the same draws. Two ranks of
`python -m r2d2_tpu_torch.train --distributed --replay multihost` train to
bit-identical parameters."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.parallel.multihost import make_global_mesh as jax_global_mesh
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.learner import (
    init_train_state,
    make_sharded_fused_multi_train_step,
    make_sharded_fused_train_step,
)
from r2d2_tpu_torch.parallel.mesh import make_mesh
from r2d2_tpu_torch.parallel.multihost import make_global_mesh
from r2d2_tpu_torch.replay.multihost_store import MultiHostShardedReplay
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from torch_multihost_child import build_and_run, synth_block

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    return env


def _spawn(argvs, timeout=240):
    """Run the commands as processes at once; -> their stdouts. Every one is
    killed on any failure, so a hung collective leaks nothing."""
    procs = [subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv, env in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_processes_equal_one_bit_for_bit_and_jax(tmp_path):
    jcfg = jax_tiny_test().replace(batch_size=8)
    _, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    torch.save(params, tmp_path / "params.pt")
    port = _free_port()
    child = os.path.join(ROOT, "tests", "torch_multihost_child.py")
    outs = _spawn([([sys.executable, child, str(r), "2", str(port), "2",
                     str(tmp_path / "params.pt")], _env()) for r in range(2)])
    ranks = [json.loads(next(line for line in out.splitlines()
                             if line.startswith("CHILD_RESULT "))[len("CHILD_RESULT "):])
             for out in outs]

    losses, checksum, digest, masses = build_and_run(make_global_mesh(["cpu"] * 4), params)
    assert len(losses) == 5 and all(np.isfinite(losses))
    for r in ranks:
        assert r["losses"] == losses and r["digest"] == digest
        assert r["checksum"] == checksum and r["masses"] == masses

    from multihost_child import build_and_run as jax_build_and_run

    j_losses, j_checksum = jax_build_and_run(jax_global_mesh(dp=4, tp=1, devices=jax.devices()[:4]))
    np.testing.assert_allclose(losses, j_losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(checksum, j_checksum, rtol=RTOL, atol=ATOL)


def _seeded_pair():
    """The same blocks into a one-process MultiHostShardedReplay of four
    shards and a ShardedDeviceReplay of four (JAX's cross-plane test)."""
    cfg = tiny_test().replace(batch_size=8)
    mh = MultiHostShardedReplay(cfg, make_global_mesh(["cpu"] * 4), seed=9)
    sh = ShardedDeviceReplay(cfg.replace(dp_size=4, replay_plane="sharded"),
                             make_mesh(4, ["cpu"] * 4))
    rngs = {g: np.random.default_rng(300 + g) for g in range(4)}
    for _ in range(2):
        for g in range(4):
            block = synth_block(cfg, rngs[g])
            prios = np.asarray([1.0 + 0.5 * g + 0.1 * i for i in range(cfg.seqs_per_block)],
                               np.float32)
            mh.add_block(block, prios, None)
            sh.add_block(block, prios, None)
    return cfg, mh, sh


def test_multihost_data_plane_matches_sharded_store():
    cfg, mh, sh = _seeded_pair()
    for g in range(4):
        for k, t in mh.stores[g].items():
            assert torch.equal(t, sh.stores[g][k]), k
    with mh.lock:
        b, s, raw_p, *_ = mh.sample_global()
    _, s0 = init_train_state(cfg, "cpu")
    _, s1 = init_train_state(cfg, "cpu")
    _, m_mh, p_mh = make_sharded_fused_train_step(cfg, is_from_priorities=True)(
        s0, mh.stores, b, s, raw_p)
    p64 = raw_p.astype(np.float64)
    min_p = p64[p64 > 0].min()
    w_host = np.power(np.maximum(p64, min_p) / min_p, -cfg.is_exponent).astype(np.float32)
    _, m_sh, p_sh = sh.run_with_stores(
        lambda st: make_sharded_fused_train_step(cfg)(s1, st, b, s, w_host))
    np.testing.assert_allclose(float(m_mh["loss"]), float(m_sh["loss"]), rtol=1e-5)
    np.testing.assert_allclose(p_mh.numpy(), p_sh.numpy(), atol=1e-5)


def test_k_dispatch_equals_sequential_steps_on_the_same_draws():
    cfg, mh, _ = _seeded_pair()
    with mh.lock:
        (b, s, w), draws = mh.sample_global_k(2)
    assert [len(d["idxes"]) for d in draws] == [len(mh.local_ids)] * 2 == [4, 4]
    _, a = init_train_state(cfg, "cpu")
    _, c = init_train_state(cfg, "cpu")
    a, ma, pa = make_sharded_fused_multi_train_step(cfg, 2, is_from_priorities=True)(
        a, mh.stores, b, s, w)
    single = make_sharded_fused_train_step(cfg, is_from_priorities=True)
    pc = []
    for k in range(2):
        c, mc, p = single(c, mh.stores, b[k], s[k], w[k])
        pc.append(p)
    assert torch.equal(pa, torch.stack(pc)) and torch.equal(ma["loss"], mc["loss"])
    for x, y in zip(a.net.parameters(), c.net.parameters()):
        assert torch.equal(x, y)
    # the draw epochs are the seeds sample_global would use, one by one
    _, mh2, _ = _seeded_pair()
    with mh2.lock:
        for k in range(2):
            b1, s1, w1, *_ = mh2.sample_global()
            assert np.array_equal(b1, b[k]) and np.array_equal(s1, s[k]) and np.array_equal(w1, w[k])


def test_two_ranks_of_the_cli_train_one_model(tmp_path):
    port = _free_port()
    argvs = []
    for r in range(2):
        env = {**_env(), "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        argvs.append(([sys.executable, "-m", "r2d2_tpu_torch.train", "--distributed",
                       "--replay", "multihost", "--device", "cpu", "--preset", "tiny_test",
                       "--env", "catch", "--steps", "6", "--updates-per-dispatch", "2",
                       "--set", "learning_starts=32", "--set", "save_interval=4",
                       "--set", f"checkpoint_dir={tmp_path / 'ckpt'}",
                       "--metrics", str(tmp_path / "m.jsonl")], env))
    outs = [json.loads(o.strip().splitlines()[-1]) for o in _spawn(argvs)]
    assert [o["process_index"] for o in outs] == [0, 1]
    assert all(o["process_count"] == 2 and o["dp"] == 2 and o["step"] == 6 for o in outs)
    assert outs[0]["params_sha256"] == outs[1]["params_sha256"]
    assert outs[0]["loss"] == outs[1]["loss"] and np.isfinite(outs[0]["loss"])
    assert outs[0]["gradient_allreduce_calls"] == 6
    assert outs[0]["collective_paths"]["gradient"] == "cpu"
    # rank 0 writes the checkpoint (the global env steps) and the metrics
    from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps

    assert list_checkpoint_steps(str(tmp_path / "ckpt")) == [4]
    steps = [json.loads(line)["step"] for line in open(tmp_path / "m.jsonl")]
    assert steps == [2, 4, 6]


def test_threaded_mode_alone_is_refused_on_the_multihost_plane(capsys):
    """The ranks' collectives stay in lockstep in run_inline and run_fused
    (MultiHostFusedRunner, ported since): a rank polling its batch queue
    would pair its preemption check with another rank's update. The CLI
    refuses threaded mode before a group forms."""
    from r2d2_tpu_torch import train

    for mode in ("threaded",):
        for flags in (["--distributed"], ["--replay", "multihost"]):
            with pytest.raises(SystemExit) as e:
                train.main(["--preset", "tiny_test", "--env", "catch", "--device", "cpu",
                            "--mode", mode, *flags])
            assert e.value.code == 2
            assert "--mode inline or fused" in capsys.readouterr().err
    cfg = tiny_test().replace(env_name="catch", replay_plane="multihost", dp_size=2,
                              learning_starts=32, training_steps=2)
    tr = train.Trainer(cfg, device="cpu,cpu")
    with pytest.raises(ValueError, match="run_inline"):
        tr.run_threaded()
    tr.run_inline()
    assert tr._step == 2
