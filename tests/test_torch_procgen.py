"""The port's procgen_impala path (procmaze -> IMPALA encoder -> LSTM) at a
tiny geometry, against the JAX package's.

- the preset's fields are the JAX preset's, for procmaze and for another
  env name;
- both Trainers train on procmaze from the same converted parameters, on
  twin JAX FnVecEnv streams (the env both actors step, as
  tests/test_torch_end_to_end.py hands in twin envs): their metrics
  records agree on env_steps, replay_size and episodes exactly and on loss
  and q_mean to rtol 1e-4 / atol 1e-5;
- the device collector's blocks on procmaze are the host actor's blocks
  (frames, actions, counters, returns and discounts bit for bit) on the
  same trajectories, the host actor's ε draws handed in;
- the CLI runs the preset, cut to a tiny size, on the host and device
  collectors.
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import procgen_impala as jax_procgen_impala
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.envs.functional import FnVecEnv as RefFnVecEnv
from r2d2_tpu.envs.procmaze import build_procmaze_env as jax_build_procmaze_env
from r2d2_tpu.train import Trainer as JaxTrainer
from r2d2_tpu_torch import train
from r2d2_tpu_torch.actor import ParamStore, VectorizedActor
from r2d2_tpu_torch.collect import GivenDraws, make_collect_fn
from r2d2_tpu_torch.config import PRESETS, procgen_impala, tiny_test
from r2d2_tpu_torch.envs.procmaze import ProcMazeEnv, ProcMazeState
from r2d2_tpu_torch.interop import params_from_flax
from r2d2_tpu_torch.models.r2d2 import init_params
from r2d2_tpu_torch.train import Trainer, build_vec_env

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(env_name="procmaze", obs_shape=(16, 16, 3), action_dim=5, encoder="impala",
            max_episode_steps=24)


@pytest.mark.parametrize("game", ["procmaze", "procmaze_shaped:8", "Pong"])
def test_preset_is_the_jax_preset(game):
    port, ref = procgen_impala(game), jax_procgen_impala(game)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert PRESETS["procgen_impala"] is procgen_impala
    if game == "procmaze":
        assert (port.obs_shape, port.encoder, port.impala_channels, port.hidden_dim) == (
            (64, 64, 3), "impala", (16, 32, 32), 512)
        assert (port.seq_len, port.batch_size, port.compute_dtype) == (85, 64, "bfloat16")


def _twin_env(cfg, seed):
    """The JAX package's procmaze vec env: both trainers step one each."""
    return RefFnVecEnv(jax_build_procmaze_env(cfg.obs_shape, cfg.max_episode_steps,
                                              cfg.env_name), num_envs=cfg.num_actors, seed=seed)


def test_trainer_on_procmaze_matches_jax_record_by_record(tmp_path):
    kw = dict(TINY, training_steps=4, save_interval=100, log_interval=0.0, learning_starts=48)
    jcfg = jax_tiny_test().replace(use_native_replay=False, metrics_path=str(tmp_path / "j.jsonl"),
                                   checkpoint_dir=str(tmp_path / "jc"), **kw)
    cfg = tiny_test().replace(metrics_path=str(tmp_path / "p.jsonl"),
                              checkpoint_dir=str(tmp_path / "pc"), **kw)
    jtr = JaxTrainer(jcfg, vec_env=_twin_env(jcfg, 7))
    ptr = Trainer(cfg, vec_env=_twin_env(jcfg, 7), device="cpu")
    sd = params_from_flax(jax.tree.map(np.asarray, jtr.state.params))
    for net in (ptr.state.net, ptr.state.target_net, ptr.actor.policy):
        net.load_state_dict(sd)
    ptr.param_store.publish(ptr.state.net)
    ptr.actor.param_version = ptr.param_store.version
    jtr.run_inline()
    ptr.run_inline()
    jtr.metrics.close()
    ptr.metrics_logger.close()
    jrecs = [json.loads(line) for line in open(jcfg.metrics_path)]
    precs = [json.loads(line) for line in open(cfg.metrics_path)]
    assert len(jrecs) == len(precs) == 4
    for j, p in zip(jrecs, precs):
        for k in ("step", "env_steps", "replay_size", "episodes"):
            assert p[k] == j[k], (k, p, j)
        for k in ("loss", "q_mean"):
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_device_collector_blocks_are_the_host_actors_on_procmaze(precision):
    E = 6
    cfg = tiny_test().replace(num_actors=E, block_length=24, buffer_capacity=480,
                              replay_plane="device", precision=precision, **TINY)
    net = init_params(cfg, 3, "cpu")
    eps = np.linspace(0.0, 1.0, E).astype(np.float32)
    vec = build_vec_env(cfg, seed=4)
    pushed, slots = [], []
    actor = VectorizedActor(cfg, copy.deepcopy(net), ParamStore(net), vec, eps,
                            lambda b, p, r: pushed.append((b, p, r)), seed=11, device="cpu")
    start = ProcMazeState(*(t.clone() for t in vec._state))
    for i, acc in enumerate(actor.accs):  # which slot each pushed block is from
        acc.finish = (lambda f, i: lambda *a, **k: (slots.append(i), f(*a, **k))[1])(
            acc.finish, i)
    chunk = cfg.max_episode_steps
    for _ in range(chunk + 1):  # a truncation is pushed a step later
        actor.step()
    rng = np.random.default_rng(11)  # the host actor's draws, step by step
    u, a = map(np.stack, zip(*((rng.random(E).astype(np.float32), rng.integers(0, 5, size=E))
                               for _ in range(chunk))))
    fields, prios, num_seq, sizes, dones, _, _ = make_collect_fn(
        cfg, vec.env, E, chunk)(net, start, torch.from_numpy(eps), GivenDraws(u, a, resets=start))
    first = {}
    for slot, item in zip(slots, pushed):
        first.setdefault(slot, item)
    assert sorted(first) == list(range(E))
    for i, (block, host_prios, ep_reward) in first.items():
        size, ns = int(sizes[i]), int(num_seq[i])
        assert size == len(block.action) and ns == block.num_sequences
        assert bool(dones[i]) == (ep_reward is not None)
        for got, want in ((fields["obs"][i, : size + 1], block.obs),
                          (fields["last_action"][i, : size + 1], block.last_action),
                          (fields["last_reward"][i, : size + 1], block.last_reward),
                          (fields["action"][i, :size], block.action),
                          (fields["n_step_reward"][i, :size], block.n_step_reward),
                          (fields["gamma"][i, :size], block.gamma),
                          (fields["burn_in"][i, :ns], block.burn_in_steps),
                          (fields["learning"][i, :ns], block.learning_steps),
                          (fields["forward"][i, :ns], block.forward_steps)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))
        np.testing.assert_allclose(prios[i].numpy(), host_prios, rtol=1e-6, atol=1e-7)
    assert isinstance(vec.env, ProcMazeEnv)


CUT = ["--set", "obs_shape=16,16,3", "--set", "hidden_dim=32", "--set", "batch_size=4",
       "--set", "burn_in_steps=2", "--set", "learning_steps=4", "--set", "forward_steps=2",
       "--set", "block_length=16", "--set", "buffer_capacity=640", "--set",
       "learning_starts=48", "--set", "num_actors=2", "--set", "max_episode_steps=16",
       "--set", "impala_channels=4,8", "--set", "compute_dtype=float32"]


@pytest.mark.parametrize("extra", [[], ["--mode", "fused", "--updates-per-dispatch", "2"]],
                         ids=["host-collector", "fused"])
def test_cli_runs_the_preset_cut_to_a_tiny_size(extra, tmp_path, capsys):
    train.main(["--preset", "procgen_impala", "--device", "cpu", "--steps", "4",
                "--set", f"checkpoint_dir={tmp_path}", *CUT, *extra])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 4 and np.isfinite(out["loss"]) and out["env_steps"] > 0
