"""The port's Trainer on the data-parallel planes, beside the JAX package's.

On twin numpy catch envs (the port's CatchVecEnv, which both actors take)
and from the same parameters (JAX's init converted by interop.py), both
Trainers run inline at dp=2 on the sharded plane (K=1 and K=2) and on the
host plane: their metrics records agree on step, env_steps, replay_size and
episodes exactly and on loss and q_mean to rtol 1e-4 / atol 1e-5. Within
the port, the sharded plane's threaded form (the batch gathered at sample
time) is its inline form bit for bit, and the CLI trains with a device
list."""

import json

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.train import Trainer as JaxTrainer
from r2d2_tpu_torch import train
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import CatchVecEnv
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.train import Trainer

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
BASE = dict(env_name="catch", training_steps=4, log_interval=0.0, learning_starts=48,
            save_interval=1000, dp_size=2, grad_norm=0.5)


def _load_flax(tr, tree):
    sd = params_from_flax(tree)
    for net in (tr.state.net, tr.state.target_net, tr.actor.policy):
        net.load_state_dict(sd)
    tr.param_store.publish(tr.state.net)
    tr.actor.param_version = tr.param_store.version


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("kw", [
    dict(replay_plane="sharded"),
    dict(replay_plane="sharded", updates_per_dispatch=2),
    dict(replay_plane="host"),
], ids=["sharded", "sharded-K2", "host"])
def test_trainer_matches_jax_record_by_record(tmp_path, kw):
    kw = {**BASE, **kw}
    jcfg = jax_tiny_test().replace(use_native_replay=False, metrics_path=str(tmp_path / "j.jsonl"),
                                   checkpoint_dir=str(tmp_path / "jck"), **kw)
    cfg = tiny_test().replace(metrics_path=str(tmp_path / "p.jsonl"),
                              checkpoint_dir=str(tmp_path / "pck"), **kw)
    jtr = JaxTrainer(jcfg, vec_env=CatchVecEnv(2, 12, 12, seed=5))
    ptr = Trainer(cfg, vec_env=CatchVecEnv(2, 12, 12, seed=5), device="cpu,cpu")
    assert ptr.mesh.dp == 2
    _load_flax(ptr, jax.tree.map(np.asarray, jtr.state.params))
    jtr.run_inline()
    ptr.run_inline()
    jtr.metrics.close()
    ptr.metrics_logger.close()
    jrecs, precs = _records(jcfg.metrics_path), _records(cfg.metrics_path)
    assert len(jrecs) == len(precs) == 4 // cfg.updates_per_dispatch
    for j, p in zip(jrecs, precs):
        for k in ("step", "env_steps", "replay_size", "episodes"):
            assert p[k] == j[k], (k, p, j)
        for k in ("loss", "q_mean"):
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(ptr.last_metrics["grad_norm"]) > 0


def test_gathered_at_sample_time_is_the_inline_update_bit_for_bit():
    cfg = tiny_test().replace(**{**BASE, "replay_plane": "sharded"})
    trs = [Trainer(cfg, vec_env=CatchVecEnv(2, 12, 12, seed=5), device="cpu,cpu")
           for _ in range(2)]
    for tr in trs:
        tr.warmup()
    for _ in range(3):
        for tr, pipelined in zip(trs, (False, True)):
            item = tr.sample(pipelined=pipelined)
            assert item[0] == ("batch" if pipelined else "coords")
            tr._one_update(item)
            tr.actor.step()
    for x, y in zip(trs[0].state.net.parameters(), trs[1].state.net.parameters()):
        assert torch.equal(x, y)
    for a, b in zip(trs[0].replay.shards, trs[1].replay.shards):
        np.testing.assert_array_equal(a.tree.leaves(), b.tree.leaves())


def test_cli_trains_with_a_device_list(capsys):
    train.main(["--preset", "tiny_test", "--env", "catch", "--device", "cpu,cpu", "--dp", "2",
                "--replay", "sharded", "--steps", "4", "--mode", "threaded",
                "--set", "learning_starts=48"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["replay_plane"], out["dp"], out["step"]) == ("sharded", 2, 4)
    assert out["local_devices"] == ["cpu", "cpu"] and np.isfinite(out["loss"])


def test_sharded_k2_sigterm_resume_is_bit_identical(tmp_path):
    """R2D2_FAULTS-style SIGTERM at the second K=2 dispatch of the sharded
    plane (its deferred write-back pending): the snapshot (every shard) and
    the checkpoint at the cut, then --resume, end where an uninterrupted run
    ends, bit for bit."""
    from r2d2_tpu_torch.replay.snapshot import save_replay
    from r2d2_tpu_torch.utils import faults
    from r2d2_tpu_torch.utils.faults import FaultPlane

    def cfg_of(tag):
        return tiny_test().replace(
            env_name="catch", replay_plane="sharded", dp_size=2, updates_per_dispatch=2,
            training_steps=8, snapshot_replay=True, save_interval=1000, learning_starts=48,
            checkpoint_dir=str(tmp_path / tag / "ckpt"))

    def fingerprint(tr, tag):
        save_replay(tr.replay, str(tmp_path / f"{tag}.npz"))
        with np.load(tmp_path / f"{tag}.npz") as d:
            replay = {k: d[k] for k in d.files}
        st = tr.state
        tensors = [*st.net.state_dict().values(), *st.target_net.state_dict().values()]
        for s in st.optimizer.state_dict()["state"].values():
            tensors += list(s.values())
        return tensors, st.step, tr.sample_rng.bit_generator.state, replay

    clean = Trainer(cfg_of("clean"), device="cpu,cpu")
    clean.run_inline(env_steps_per_update=4)
    faults.install(FaultPlane(schedule={"trainer.update": {2: "sigterm"}}))
    try:
        cut = Trainer(cfg_of("killed"), device="cpu,cpu")
        cut.run_inline(env_steps_per_update=4)
    finally:
        faults.uninstall()
    assert cut.preempted and 0 < cut._step < 8
    resumed = Trainer(cfg_of("killed"), device="cpu,cpu", resume=True)
    assert resumed._initial_step == cut._step and resumed.plane._pending is not None
    resumed.run_inline(env_steps_per_update=4)
    a, b = fingerprint(clean, "a"), fingerprint(resumed, "b")
    assert a[1] == b[1] == 8 and a[2] == b[2]
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert sorted(a[3]) == sorted(b[3])
    for k in a[3]:
        np.testing.assert_array_equal(a[3][k], b[3][k], err_msg=k)
