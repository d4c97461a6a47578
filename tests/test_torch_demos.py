"""The port's demos and CLI surface on the CPU: config.apply_cli_overrides'
order against the JAX package's, torch_catch_demo.demo_config against the
JAX demo's field by field (the IMPALA channels aside: the JAX network ran
(16, 32, 32) whatever its config named), both demos end to end for a
handful of updates (their artifacts written), the catch demo's checkpoint
served over TCP (examples/torch_serve_catch.py), and `python -m
r2d2_tpu_torch.serve --dryrun` exiting 0."""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from r2d2_tpu import config as jconfig
from r2d2_tpu_torch import config as tconfig
from r2d2_tpu_torch.serve.__main__ import main as serve_main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"demo_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared_fields(port, ref, skip=()):
    """{field: (port value, JAX value)} over the port's config fields the JAX
    config also has, tuples and lists alike."""
    out = {}
    for f in dataclasses.fields(port):
        if f.name in skip or not hasattr(ref, f.name):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
            a, b = tuple(a), tuple(b)
        out[f.name] = (a, b)
    return out


@pytest.mark.parametrize("pairs,ablate", [
    (["burn_in_steps=20", "lr=3e-4"], True),
    (["burn_in_steps=20", "zero_state_replay=false"], True),
    (["burn_in_steps=7"], False),
    ([], True),
])
def test_apply_cli_overrides_order_matches_jax(pairs, ablate):
    """--set first, then the ablation flag, which always wins."""
    got = tconfig.apply_cli_overrides(tconfig.tiny_test(), pairs, ablate)
    want = jconfig.apply_cli_overrides(jconfig.tiny_test(), pairs, ablate)
    for name, (a, b) in _shared_fields(got, want).items():
        assert a == b, name
    if ablate:
        assert got.burn_in_steps == 0 and got.zero_state_replay


@pytest.mark.parametrize("full,size", [(False, 26), (False, 40), (True, 26)])
def test_catch_demo_config_matches_jax_field_by_field(tmp_path, full, size):
    port = _load("torch_catch_demo").demo_config(str(tmp_path), 4000, 64, full, size=size)
    ref = _load("catch_demo").demo_config(str(tmp_path), 4000, 64, full, size=size)
    shared = _shared_fields(port, ref, skip=("impala_channels",))
    assert len(shared) > 50
    differ = {k: v for k, v in shared.items() if v[0] != v[1]}
    assert differ == {}
    if not full:
        assert port.impala_channels == (16, 32, 32) and port.encoder == "impala"
        assert tuple(ref.impala_channels) == (8, 16)  # named, never built by JAX


def test_long_context_demo_config_matches_jax(tmp_path):
    """The long-context demo's replacements on the port's long_context
    preset, against the JAX demo's on its own."""
    port = _load("torch_long_context_demo").demo_config(str(tmp_path), 12000, 8, 16)
    ref = jconfig.long_context().replace(
        num_actors=8, batch_size=16, buffer_capacity=1024 * 200, learning_starts=60_000,
        collector="device", replay_plane="device", updates_per_dispatch=2, forward_steps=20,
        target_net_update_interval=250, samples_per_insert=30.0, training_steps=12000,
        save_interval=1500, checkpoint_dir=os.path.join(str(tmp_path), "ckpt"),
        metrics_path=os.path.join(str(tmp_path), "metrics.jsonl"))
    shared = _shared_fields(port, ref)
    assert {k: v for k, v in shared.items() if v[0] != v[1]} == {}


@pytest.fixture(scope="module")
def catch_run(tmp_path_factory):
    """The catch demo for 16 updates on the CPU: (its --out, its eval rows)."""
    out = str(tmp_path_factory.mktemp("demo") / "catch")
    rows = _load("torch_catch_demo").main([
        "--out", out, "--steps", "16", "--actors", "4", "--device", "cpu",
        "--eval-episodes", "1", "--set", "learning_starts=200", "--set", "buffer_capacity=4000",
        "--set", "batch_size=4"])
    return out, rows


def test_catch_demo_trains_and_evaluates_on_the_cpu(catch_run):
    out, rows = catch_run
    assert [r["step"] for r in rows] == [16]
    assert rows[0]["episodes"] == 16 and rows[0]["evaluator"] == "host"
    for name in ("metrics.jsonl", "eval.jsonl", "curve.jpg"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    assert os.path.isdir(os.path.join(out, "ckpt", "step_16"))
    with open(os.path.join(out, "eval.jsonl")) as f:
        assert json.loads(f.readline())["step"] == 16


def test_the_served_checkpoint_plays_catch_over_tcp(catch_run):
    """examples/torch_serve_catch.py: the serve CLI in a subprocess on the
    run's checkpoint, 16 episodes through PolicyClient, and the evaluator's
    row for that checkpoint beside them."""
    out, rows = catch_run
    got = _load("torch_serve_catch").main(["--run", out, "--episodes", "16",
                                           "--device", "cpu"])
    assert got["ckpt_step"] == 16 and got["served_episodes"] == 16
    assert -1.0 <= got["served_mean_reward"] <= 1.0
    assert got["evaluator_mean_reward"] == rows[-1]["mean_reward"]


def test_long_context_demo_trains_and_evaluates_on_the_cpu(tmp_path):
    out = str(tmp_path / "lc")
    rows, trainer = _load("torch_long_context_demo").main([
        "--out", out, "--steps", "4", "--actors", "2", "--batch", "2", "--device", "cpu",
        "--eval-episodes", "1", "--env", "memory_catch:2:1:1", "--set", "burn_in_steps=8",
        "--set", "learning_steps=32", "--set", "block_length=64",
        "--set", "buffer_capacity=1024", "--set", "learning_starts=256"])
    m = trainer.metrics()
    assert m["step"] == 4 and torch.isfinite(torch.tensor(m["loss"]))
    assert [r["step"] for r in rows] == [2, 4] and rows[-1]["evaluator"] == "device"
    assert os.path.getsize(os.path.join(out, "curve.jpg")) > 0


def test_serve_cli_dryrun(tmp_path):
    assert serve_main(["--preset", "tiny_test", "--dryrun", "6", "--buckets", "2", "4",
                       "--cache-capacity", "8", "--spill", "8", "--max-wait-ms", "1.0",
                       "--device", "cpu", "--metrics", str(tmp_path / "m.jsonl")]) == 0
    with open(tmp_path / "m.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(r["plane"] == "serve" for r in rows)


def test_serve_cli_dryrun_from_a_checkpoint(tmp_path):
    """--ckpt serves the series' latest step."""
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.utils.checkpoint import save_checkpoint

    _, state = init_train_state(tconfig.tiny_test(), "cpu")
    state.step = 7
    save_checkpoint(str(tmp_path / "ckpt"), state, 0, 0.0)
    assert serve_main(["--dryrun", "4", "--ckpt", str(tmp_path / "ckpt"), "--buckets", "2",
                       "--cache-capacity", "4", "--device", "cpu"]) == 0
