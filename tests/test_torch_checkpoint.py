"""The port's checkpoints (r2d2_tpu_torch/utils/checkpoint.py), as
tests/test_checkpoint.py holds the JAX package's: a save lands through a
temp dir and a rename, the listing never shows a partly written step, a
step saved again is replaced, and a restore gives back every tensor of the
TrainState (networks, Adam state, step) bit for bit."""

from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.learner import DeviceBatch, init_train_state, make_train_step
from r2d2_tpu_torch.utils.checkpoint import (
    latest_checkpoint_step,
    list_checkpoint_steps,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)


def _batch(cfg, seed):
    """A random replay batch with every row's seam at the burn-in."""
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    return types.SimpleNamespace(
        obs=rng.integers(0, 256, size=(B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=(B, T)).astype(np.int32),
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=(rng.normal(size=(B, 2, cfg.hidden_dim)) * 0.5).astype(np.float32),
        action=rng.integers(0, cfg.action_dim, size=(B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        gamma=np.full((B, L), cfg.gamma ** cfg.forward_steps, np.float32),
        burn_in_steps=np.full(B, cfg.burn_in_steps, np.int32),
        learning_steps=np.full(B, L, np.int32),
        forward_steps=np.full(B, cfg.forward_steps, np.int32),
        is_weights=rng.uniform(0.3, 1.0, size=B).astype(np.float32),
    )


def _update(state, cfg, seed):
    return make_train_step(cfg)(state, DeviceBatch.from_sampled(_batch(cfg, seed), "cpu"))[0]


def _trained_state():
    """A TrainState after two updates, so the Adam state is not empty."""
    cfg = tiny_test()
    _, state = init_train_state(cfg, "cpu", seed=0)
    for i in range(2):
        state = _update(state, cfg, 10 + i)
    return state


@pytest.fixture(scope="module")
def state():
    return _trained_state()


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in ((a.net, b.net), (a.target_net, b.target_net)):
        sx, sy = x.state_dict(), y.state_dict()
        assert list(sx) == list(sy)
        assert all(torch.equal(sx[k], sy[k]) for k in sx)
    ox, oy = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert ox["param_groups"] == oy["param_groups"]
    assert set(ox["state"]) == set(oy["state"]) and ox["state"]
    for i in ox["state"]:
        for k, v in ox["state"][i].items():
            assert torch.equal(v, oy["state"][i][k]), (i, k)


def test_save_is_atomic_and_round_trips(tmp_path, state):
    ckpt_dir = str(tmp_path / "ckpt")
    path = save_checkpoint(ckpt_dir, state, env_steps=12, wall_minutes=3.5)
    assert os.path.basename(path) == "step_2"
    # no temp residue and a finalize marker in place
    assert not [n for n in os.listdir(ckpt_dir) if n.startswith(".tmp")]
    assert os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
    assert list_checkpoint_steps(ckpt_dir) == [2]

    _, template = init_train_state(tiny_test(), "cpu", seed=1)
    restored, env_steps, wall = restore_checkpoint(ckpt_dir, template, map_location="cpu")
    assert env_steps == 12 and wall == 3.5
    _assert_states_equal(restored, state)
    # two restores step on to the same bits
    _, template2 = init_train_state(tiny_test(), "cpu", seed=1)
    twin, _, _ = restore_checkpoint(ckpt_dir, template2)
    for s in (restored, twin):
        _update(s, tiny_test(), 20)
    _assert_states_equal(restored, twin)


def test_listing_skips_partial_dirs(tmp_path, state):
    ckpt_dir = str(tmp_path / "ckpt")
    save_checkpoint(ckpt_dir, state, 0, 0.0)
    # a torn checkpoint: the dir exists but the save never finalized
    os.makedirs(os.path.join(ckpt_dir, "step_99"))
    # an in-flight temp dir from a concurrent writer
    os.makedirs(os.path.join(ckpt_dir, ".tmp_step_100"))
    os.makedirs(os.path.join(ckpt_dir, "step_junk"), exist_ok=True)
    assert list_checkpoint_steps(ckpt_dir) == [2]
    assert latest_checkpoint_step(ckpt_dir) == 2
    assert latest_checkpoint_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), state)


def test_save_overwrites_existing_step(tmp_path, state):
    ckpt_dir = str(tmp_path / "ckpt")
    save_checkpoint(ckpt_dir, state, 1, 0.0)
    # the same step again replaces it through the atomic path
    save_checkpoint(ckpt_dir, state, 2, 0.0)
    assert list_checkpoint_steps(ckpt_dir) == [2]
    _, template = init_train_state(tiny_test(), "cpu", seed=1)
    _, env_steps, _ = restore_checkpoint(ckpt_dir, template)
    assert env_steps == 2
