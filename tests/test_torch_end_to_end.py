"""The port's main path end to end on the CPU, as tests/test_end_to_end.py
holds the JAX package's: catch -> actor -> block packing -> PER replay ->
update -> checkpoint -> resume -> evaluation, inline and threaded.

Then the slice against the JAX package: both Trainers, on twin numpy catch
envs (the port's CatchVecEnv, which both actors take) and from the same
parameters (JAX's init converted by interop.py), run 6 inline updates. Their
metrics records agree on env_steps, replay_size and episodes exactly and on
loss and q_mean to rtol 1e-4 / atol 1e-5 (the learner tests' tolerance: the
two sum in other orders), both save steps 3 and 6, JAX's step-6 checkpoint
converted matches the port's, and evaluate_params gives the same mean
reward on a fresh env. Last, a JAX checkpoint crosses the bridge with its
Adam state (interop.adam_state_from_optax), is saved as a port checkpoint,
resumed by the port Trainer, and the next update matches JAX's on the same
batch.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.evaluate import evaluate_params as jax_evaluate_params
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import make_train_step as jax_make_train_step
from r2d2_tpu.train import Trainer as JaxTrainer
from r2d2_tpu.utils.checkpoint import list_checkpoint_steps as jax_list_checkpoint_steps
from r2d2_tpu.utils.checkpoint import restore_checkpoint as jax_restore_checkpoint
from r2d2_tpu_torch import evaluate, train
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import CatchVecEnv
from r2d2_tpu_torch.evaluate import evaluate_params, evaluate_series, plot_series
from r2d2_tpu_torch.interop import (
    adam_state_from_optax,
    adam_state_to_optax,
    params_from_flax,
    params_to_flax,
)
from r2d2_tpu_torch.learner import DeviceBatch, init_train_state
from r2d2_tpu_torch.train import Trainer
from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps, save_checkpoint

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    cfg = tiny_test().replace(
        env_name="catch",
        checkpoint_dir=str(tmp / "ckpt"),
        metrics_path=str(tmp / "metrics.jsonl"),
        training_steps=30,
        save_interval=15,
        learning_starts=48,
    )
    vec_env = CatchVecEnv(num_envs=cfg.num_actors, height=12, width=12, seed=0)
    trainer = Trainer(cfg, vec_env=vec_env, device="cpu")
    trainer.run_inline(env_steps_per_update=4)
    trainer.metrics_logger.close()
    return trainer


def test_training_reaches_step_target(trained):
    assert trained.state.step == 30
    assert trained.replay.env_steps > 48


def test_metrics_written(trained):
    recs = [json.loads(line) for line in open(trained.cfg.metrics_path)]
    assert len(recs) == 30
    assert [r["step"] for r in recs] == list(range(1, 31))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["q_mean"]) for r in recs)
    # episode counts are popped per record: they sum to the run's total
    assert sum(r["episodes"] for r in recs) <= trained.replay.episode_totals()[0]
    assert recs[-1]["env_steps"] == trained.replay.env_steps


def _assert_state_equal(a, b):
    assert a.step == b.step
    for x, y in ((a.net, b.net), (a.target_net, b.target_net)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[k], sy[k]) for k in sx)
    ox, oy = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert set(ox) == set(oy) and ox
    for i in ox:
        assert all(torch.equal(v, oy[i][k]) for k, v in ox[i].items())


def test_checkpoint_series_and_resume(trained):
    cfg = trained.cfg
    assert list_checkpoint_steps(cfg.checkpoint_dir) == [15, 30]
    resumed = Trainer(cfg, vec_env=trained.vec_env, device="cpu", resume=True)
    assert resumed.resumed and resumed.state.step == 30
    # the full TrainState comes back bit for bit
    _assert_state_equal(resumed.state, trained.state)
    # the env steps of the run so far are carried into the resumed run's
    assert resumed.env_steps_offset == trained.env_steps
    # the actor acts with the restored parameters
    pol = resumed.actor.policy.state_dict()
    assert all(torch.equal(v, pol[k]) for k, v in trained.state.net.state_dict().items())


def test_resumed_run_goes_on_to_its_target(trained, tmp_path):
    cfg = trained.cfg.replace(training_steps=33, metrics_path=str(tmp_path / "m.jsonl"))
    resumed = Trainer(cfg, vec_env=CatchVecEnv(2, 12, 12, seed=3), device="cpu", resume=True)
    resumed.run_inline(env_steps_per_update=4)
    assert resumed.state.step == 33
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    assert [r["step"] for r in recs] == [31, 32, 33]
    # env_steps after a resume: this run's replay plus the checkpoint's
    assert recs[-1]["env_steps"] == resumed.replay.env_steps + trained.env_steps


def test_evaluate_runs(trained):
    vec = CatchVecEnv(num_envs=4, height=12, width=12, seed=7)
    reward = evaluate_params(trained.cfg, trained.state.net, vec, seed=1)
    assert -1.0 <= reward <= 1.0


def test_evaluate_series(trained):
    vec = CatchVecEnv(num_envs=2, height=12, width=12, seed=9)
    rows = evaluate_series(trained.cfg, vec, device="cpu")
    assert [r["step"] for r in rows] == [15, 30]
    assert all(np.isfinite(r["mean_reward"]) for r in rows)
    assert all(r["env_frames"] == r["env_steps"] * 4 for r in rows)
    assert all(r["episodes"] == 2 and r["evaluator"] == "host" for r in rows)
    assert rows[-1]["env_steps"] == trained.env_steps


def test_evaluate_plot(trained, tmp_path):
    vec = CatchVecEnv(num_envs=2, height=12, width=12, seed=9)
    rows = evaluate_series(trained.cfg, vec, device="cpu")
    out = plot_series(rows, str(tmp_path / "curve.jpg"))
    assert os.path.getsize(out) > 1000


def test_evaluate_cli_walks_series(trained, tmp_path):
    out, plot = tmp_path / "rows.jsonl", tmp_path / "curve.jpg"
    evaluate.main(["--preset", "tiny_test", "--env", "catch", "--device", "cpu",
                   "--set", f"checkpoint_dir={trained.cfg.checkpoint_dir}",
                   "--out", str(out), "--plot", str(plot)])
    rows = [json.loads(line) for line in open(out)]
    assert [r["step"] for r in rows] == [15, 30]
    assert all(np.isfinite(r["mean_reward"]) for r in rows)
    assert plot.exists() and plot.stat().st_size > 0


def test_evaluate_params_multi_episode_auto_reset():
    cfg = tiny_test().replace(env_name="catch", action_dim=3)
    vec = CatchVecEnv(num_envs=4, height=12, width=12, seed=0)
    net, _ = init_train_state(cfg, "cpu")
    r3 = evaluate_params(cfg, net, vec, seed=1, episodes_per_slot=3, max_steps=12)
    assert -1.0 <= r3 <= 1.0
    # catch pays exactly +-1: a mean over 12 completed episodes is a
    # multiple of 1/12
    assert abs(r3 * 12 - round(r3 * 12)) < 1e-9


def test_train_cli_resumes_and_runs_threaded(trained, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    m1, m2 = str(tmp_path / "m1.jsonl"), str(tmp_path / "m2.jsonl")
    base = ["--preset", "tiny_test", "--env", "catch", "--device", "cpu",
            "--set", f"checkpoint_dir={ckpt}", "--set", "save_interval=2"]
    train.main(base + ["--steps", "4", "--metrics", m1])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["step"] == 4 and first["resumed_from"] is None and first["mode"] == "inline"
    assert list_checkpoint_steps(ckpt) == [2, 4]
    train.main(base + ["--steps", "6", "--metrics", m2, "--resume", "--mode", "threaded"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 6 and out["resumed_from"] == 4 and out["mode"] == "threaded"
    assert list_checkpoint_steps(ckpt) == [2, 4, 6]
    recs = [json.loads(line) for line in open(m2)]
    assert [r["step"] for r in recs if "loss" in r] == [5, 6]
    assert recs[-1]["env_steps"] > first["env_steps"]


def test_threaded_reaches_step_target_with_both_save_crossings(tmp_path):
    cfg = tiny_test().replace(env_name="catch", training_steps=12, save_interval=6,
                              learning_starts=48, checkpoint_dir=str(tmp_path / "ckpt"),
                              metrics_path=str(tmp_path / "m.jsonl"))
    tr = Trainer(cfg, vec_env=CatchVecEnv(2, 12, 12, seed=0), device="cpu")
    tr.run_threaded()
    assert tr.state.step == 12
    assert list_checkpoint_steps(cfg.checkpoint_dir) == [6, 12]
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    updates = [r for r in recs if "loss" in r]
    assert [r["step"] for r in updates] == list(range(1, 13))
    # the supervisor's health stats ride in the records
    assert all(r["worker_restarts"] == 0 for r in updates)
    assert all(np.isfinite(r["loss"]) for r in updates)


def test_samples_per_insert_throttles_collection(tmp_path):
    """With a samples-per-insert target, the actor thread yields once data
    outpaces optimization: the consumed/inserted ratio stays near the
    target instead of collapsing toward zero."""
    cfg = tiny_test().replace(env_name="catch", samples_per_insert=2.0, training_steps=30,
                              save_interval=1000, learning_starts=48,
                              checkpoint_dir=str(tmp_path / "ckpt"))
    tr = Trainer(cfg, device="cpu")
    tr.run_threaded()
    consumed = tr.state.step * cfg.batch_size * cfg.learning_steps
    ratio = consumed / tr.replay.env_steps
    assert ratio > 0.5, f"actors free-ran: ratio {ratio:.2f}"


# --------------------------------------------------------------------------
# the slice against the JAX package
# --------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load_flax(tr, tree):
    """Put converted flax parameters into a port Trainer's online and target
    nets, its actor's policy and its ParamStore."""
    sd = params_from_flax(tree)
    for net in (tr.state.net, tr.state.target_net, tr.actor.policy):
        net.load_state_dict(sd)
    tr.param_store.publish(tr.state.net)
    tr.actor.param_version = tr.param_store.version


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("twins")
    kw = dict(env_name="catch", training_steps=6, save_interval=3, log_interval=0.0,
              learning_starts=48)
    jcfg = jax_tiny_test().replace(use_native_replay=False, checkpoint_dir=str(tmp / "jax"),
                                   metrics_path=str(tmp / "jax.jsonl"), **kw)
    cfg = tiny_test().replace(checkpoint_dir=str(tmp / "port"),
                              metrics_path=str(tmp / "port.jsonl"), **kw)
    jtr = JaxTrainer(jcfg, vec_env=CatchVecEnv(2, 12, 12, seed=5))
    ptr = Trainer(cfg, vec_env=CatchVecEnv(2, 12, 12, seed=5), device="cpu")
    _load_flax(ptr, _np_tree(jtr.state.params))
    jtr.run_inline()
    ptr.run_inline()
    jtr.metrics.close()
    ptr.metrics_logger.close()
    return jtr, ptr


def test_slice_matches_jax_record_by_record(twins):
    jtr, ptr = twins
    jrecs = [json.loads(line) for line in open(jtr.cfg.metrics_path)]
    precs = [json.loads(line) for line in open(ptr.cfg.metrics_path)]
    assert len(jrecs) == len(precs) == 6
    for j, p in zip(jrecs, precs):
        for k in ("step", "env_steps", "replay_size", "episodes", "backward_arm"):
            assert p[k] == j[k], (k, p, j)
        for k in ("loss", "q_mean"):
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _port_tree(net):
    return params_to_flax(net)["params"]


def _assert_trees_close(got, want, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, v in flat_w:
        np.testing.assert_allclose(flat_g[path], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _optax_adam(opt_state):
    """(mu, nu, count) of the Adam inside the JAX package's optimizer chain
    (clip_by_global_norm, then adam)."""
    adam = opt_state[1][0]
    return adam.mu, adam.nu, adam.count


def test_both_save_the_same_steps_and_the_same_state(twins):
    jtr, ptr = twins
    assert jax_list_checkpoint_steps(jtr.cfg.checkpoint_dir) == [3, 6]
    assert list_checkpoint_steps(ptr.cfg.checkpoint_dir) == [3, 6]
    jstate, j_env, _ = jax_restore_checkpoint(jtr.cfg.checkpoint_dir, jtr.state, 6)
    _, template = init_train_state(ptr.cfg, "cpu", seed=1)
    from r2d2_tpu_torch.utils.checkpoint import restore_checkpoint

    pstate, p_env, _ = restore_checkpoint(ptr.cfg.checkpoint_dir, template, 6)
    assert int(jstate.step) == pstate.step == 6 and j_env == p_env
    _assert_trees_close(_port_tree(pstate.net), _np_tree(jstate.params)["params"], "params")
    _assert_trees_close(_port_tree(pstate.target_net), _np_tree(jstate.target_params)["params"],
                        "target")
    names = [n for n, _ in pstate.net.named_parameters()]
    mu, nu, count = adam_state_to_optax(pstate.optimizer.state_dict(), names)
    jmu, jnu, jcount = _optax_adam(_np_tree(jstate.opt_state))
    assert int(count) == int(jcount) == 6
    _assert_trees_close(mu["params"], jmu["params"], "mu")
    _assert_trees_close(nu["params"], jnu["params"], "nu")


def test_evaluation_matches_jax(twins):
    jtr, ptr = twins
    jr = jax_evaluate_params(jtr.cfg, jtr.net, jtr.state.params,
                             CatchVecEnv(4, 12, 12, seed=11), seed=3)
    pr = evaluate_params(ptr.cfg, ptr.state.net, CatchVecEnv(4, 12, 12, seed=11), seed=3)
    assert pr == jr


def test_adam_state_round_trips_bitwise(twins):
    jtr, ptr = twins
    mu, nu, count = _optax_adam(_np_tree(jtr.state.opt_state))
    names = [n for n, _ in ptr.state.net.named_parameters()]
    sd = adam_state_from_optax(ptr.state.optimizer.state_dict(), names, mu, nu, count)
    mu2, nu2, count2 = adam_state_to_optax(sd, names)
    assert count2.dtype == np.int32 and int(count2) == int(count)
    for a, b in ((mu2, mu), (nu2, nu)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert len(fa) == len(fb)
        for path, v in fa:
            assert v.dtype == fb[path].dtype and np.array_equal(v, fb[path]), path
    sd2 = adam_state_from_optax(sd, names, mu2, nu2, count2)
    for i, st in sd["state"].items():
        assert all(torch.equal(v, sd2["state"][i][k]) for k, v in st.items())


def test_jax_checkpoint_resumes_in_the_port(twins, tmp_path):
    """A JAX checkpoint (params, target params, Adam state, step), restored
    by the JAX package, converted and saved as a port checkpoint, resumed by
    the port Trainer: the next update on one batch matches JAX's."""
    jtr, ptr = twins
    jstate, env_steps, wall = jax_restore_checkpoint(jtr.cfg.checkpoint_dir, jtr.state, 3)
    cfg = ptr.cfg.replace(checkpoint_dir=str(tmp_path / "ckpt"))
    _, state = init_train_state(cfg, "cpu", seed=1)
    np_state = _np_tree(jstate)
    state.net.load_state_dict(params_from_flax(np_state.params))
    state.target_net.load_state_dict(params_from_flax(np_state.target_params))
    names = [n for n, _ in state.net.named_parameters()]
    state.optimizer.load_state_dict(adam_state_from_optax(
        state.optimizer.state_dict(), names, *_optax_adam(np_state.opt_state)))
    state.step = int(jstate.step)
    save_checkpoint(cfg.checkpoint_dir, state, env_steps, wall)

    tr = Trainer(cfg, vec_env=CatchVecEnv(2, 12, 12, seed=1), device="cpu", resume=True)
    assert tr.state.step == 3 and tr.env_steps_offset == env_steps
    tr.warmup()
    b = tr.replay.sample_batch(np.random.default_rng(0))
    jstep = jax_make_train_step(jtr.cfg, jtr.net, donate=False)
    jnew, jm, jprio = jstep(jstate, JaxBatch.from_sampled(types.SimpleNamespace(**vars(b),
                                                                              task=None)))
    pnew, pm, pprio = tr.step_fn(tr.state, DeviceBatch.from_sampled(b, "cpu"))
    for k in ("loss", "q_mean", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(pprio.numpy(), np.asarray(jprio), rtol=RTOL, atol=ATOL)
    assert pnew.step == int(jnew.step) == 4
    _assert_trees_close(_port_tree(pnew.net), _np_tree(jnew.params)["params"], "params")
    _assert_trees_close(_port_tree(pnew.target_net), _np_tree(jnew.target_params)["params"],
                        "target")
    jmu, jnu, _ = _optax_adam(_np_tree(jnew.opt_state))
    mu, nu, count = adam_state_to_optax(pnew.optimizer.state_dict(), names)
    assert int(count) == 4
    _assert_trees_close(mu["params"], jmu["params"], "mu")
    _assert_trees_close(nu["params"], jnu["params"], "nu")
