"""The port's fused megastep (r2d2_tpu_torch/megastep.py: make_megastep,
FusedSystemRunner) and the Trainer's --mode fused, mirroring the JAX
package's tests/test_megastep.py.

A megastep equals its separate parts bit for bit on the CPU: K fused
updates on the same coordinates, the collection chunk with the entry
parameters and the same draws, then add_blocks_batch at the reserved slots.
The runner advances the ring at reserve time and lands the chunk's
accounting and the priority rows one dispatch late; it refuses episodes
longer than a chunk and stores too small for its deferred write-backs.
"""

import copy
import json

import numpy as np
import pytest
import torch

from r2d2_tpu_torch import train
from r2d2_tpu_torch.actor import ParamStore
from r2d2_tpu_torch.collect import CollectDraws, DeviceCollector, make_collect_fn
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import TensorCatchEnv
from r2d2_tpu_torch.learner import init_train_state, make_fused_multi_train_step
from r2d2_tpu_torch.megastep import FusedSystemRunner, make_megastep
from r2d2_tpu_torch.replay.control_plane import ReplayControlPlane
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step

torch.set_num_threads(1)

K = 3


def _cfg(**kw):
    return tiny_test().replace(
        env_name="catch", obs_shape=(10, 8, 1), action_dim=3, num_actors=4,
        max_episode_steps=8, block_length=16, buffer_capacity=640, learning_starts=32,
        collector="device", replay_plane="device", updates_per_dispatch=K,
        training_steps=4 * K, target_net_update_interval=2).replace(**kw)


def _setup(seed=7):
    cfg = _cfg()
    fn_env = TensorCatchEnv(cfg.obs_shape[0], cfg.obs_shape[1])
    _, state = init_train_state(cfg, "cpu")
    replay = DeviceReplayBuffer(cfg, "cpu")
    col = DeviceCollector(cfg, copy.deepcopy(state.net), ParamStore(state.net), fn_env, replay,
                          seed=seed, device="cpu")
    while not replay.can_sample():
        col.step()
    return cfg, fn_env, state, replay, col


def _gen_copy(g):
    c = torch.Generator()
    c.set_state(g.get_state())
    return c


def test_megastep_equals_separate_dispatches():
    cfg, fn_env, state, replay, col = _setup()
    E = cfg.num_actors
    rng = np.random.default_rng(3)
    with replay.lock:
        ptr0 = replay._reserve_advance(E)
        draws = [replay._draw_sample_idx(rng) for _ in range(K)]
    b, s, w = (torch.from_numpy(np.stack([getattr(d, f) for d in draws]))
               for f in ("b", "s", "is_weights"))
    stores_b = {k: t.clone() for k, t in replay.stores.items()}
    state_b = copy.deepcopy(state)
    gen = col.draws.generator
    draws_b = CollectDraws(_gen_copy(gen))
    env_state = col.env_state

    state_a, ma, pa, chunk_a, env_a = make_megastep(cfg, fn_env, E, col.chunk, K)(
        state, replay.stores, env_state, col.epsilons, CollectDraws(gen), b, s, w, ptr0)

    # the parts: collect with the entry parameters, K updates, the slab
    entry_net = copy.deepcopy(state_b.net)
    fields, cp, ns, sz, dn, er, env_b = make_collect_fn(cfg, fn_env, E, col.chunk)(
        entry_net, env_state, col.epsilons, draws_b)
    state_b, mb, pb = make_fused_multi_train_step(cfg, K)(state_b, stores_b, b, s, w)
    for k, t in stores_b.items():
        t[ptr0:ptr0 + E].copy_(fields[k])

    assert torch.equal(pa, pb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(list(state_a.net.parameters()) + list(state_a.target_net.parameters()),
                    list(state_b.net.parameters()) + list(state_b.target_net.parameters())):
        assert torch.equal(x, y)
    assert state_a.step == state_b.step
    for k in replay.stores:
        assert torch.equal(replay.stores[k], stores_b[k]), k
    for x, y in zip(chunk_a, (cp, ns, sz, dn, er)):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(env_a, env_b))
    assert torch.equal(gen.get_state(), draws_b.generator.get_state())


def test_runner_accounts_and_masks_staleness():
    cfg, fn_env, state, replay, col = _setup()
    ptr0, env0, step0 = replay.block_ptr, replay.env_steps, state.step
    runner = FusedSystemRunner(cfg, "cpu", fn_env, replay, col.epsilons, col.env_state,
                               col.draws, collect_every=2, sample_rng=np.random.default_rng(5))
    state2, m, recorded = runner.step(state)  # dispatch 0 collects
    # the pointer is past the reserved slots, the accounting still in flight
    assert recorded == 0 and replay.env_steps == env0
    assert replay.block_ptr == (ptr0 + cfg.num_actors) % cfg.num_blocks
    S = cfg.seqs_per_block
    reserved = (np.arange(ptr0, ptr0 + cfg.num_actors)[:, None] * S + np.arange(S)).ravel()
    np.testing.assert_array_equal(replay.tree.priorities_of(reserved), 0.0)
    state3, m2, recorded2 = runner.step(state2)  # dispatch 1 drains chunk 0
    assert recorded2 == cfg.num_actors * (cfg.obs_shape[0] - 2)
    assert replay.env_steps == env0 + recorded2 and runner.total_env_steps == recorded2
    assert (replay.tree.priorities_of(reserved) > 0).any()
    assert state3.step == step0 + 2 * K and np.isfinite(float(m2["loss"]))
    assert runner.finish() == 0  # no chunk in flight after an update-only dispatch
    assert runner._pending is None


def test_reserve_contiguous_retires_tail_slots():
    cfg = _cfg()  # 40 block slots
    nb, S = cfg.num_blocks, cfg.seqs_per_block
    plane = ReplayControlPlane(cfg)
    prios = np.ones(S, np.float32)
    for _ in range(nb):
        plane._account_add(S, 10, prios, None)
    full_total = plane.tree.tree[0]
    E = 16  # nb % E == 8: slots 32..39 are the stranded tail
    with plane.lock:
        assert plane._reserve_contiguous(E) == 0
    plane.block_ptr = 2 * E
    with plane.lock:
        assert plane._reserve_contiguous(E) == 0  # 32 + 16 > 40: wrap and retire
    tail = np.arange(2 * E, nb)
    assert not plane.occupied[tail].any() and plane.size == (nb - len(tail)) * 10
    np.testing.assert_array_equal(
        plane.tree.priorities_of((tail[:, None] * S + np.arange(S)).ravel()), 0.0)
    assert plane.tree.tree[0] < full_total


def test_warmup_raises_on_saturated_replay():
    # 40 slots of at most 8-step episodes hold 320 transitions: never 400
    tr = train.Trainer(_cfg(learning_starts=400), device="cpu")
    with pytest.raises(RuntimeError, match="saturated"):
        tr.warmup()


def test_runner_refuses_multi_chunk_episodes_and_small_stores():
    cfg, fn_env, state, replay, col = _setup()
    with pytest.raises(ValueError, match="exceeds the collection chunk"):
        FusedSystemRunner(cfg.replace(max_episode_steps=cfg.block_length * 2), "cpu", fn_env,
                          replay, col.epsilons, col.env_state, col.draws)
    with pytest.raises(ValueError, match="store too small"):
        FusedSystemRunner(cfg.replace(num_actors=11), "cpu", fn_env, replay, col.epsilons,
                          col.env_state, col.draws)


def test_trainer_run_fused_end_to_end(tmp_path):
    cfg = _cfg(checkpoint_dir=str(tmp_path / "ckpt"), metrics_path=str(tmp_path / "m.jsonl"),
               save_interval=K)
    tr = train.Trainer(cfg, device="cpu")
    tr.run_fused()
    assert tr._step == tr.state.step == cfg.training_steps
    assert latest_checkpoint_step(cfg.checkpoint_dir) == cfg.training_steps
    assert tr.actor.total_steps > 0 and tr.replay.env_steps >= tr.actor.total_steps
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    assert recs and recs[-1]["step"] == cfg.training_steps
    with pytest.raises(ValueError, match="run_fused needs"):
        train.Trainer(cfg.replace(collector="host"), device="cpu").run_fused()


def test_cli_mode_fused(capsys, tmp_path):
    train.main(["--preset", "tiny_test", "--env", "catch", "--device", "cpu", "--mode", "fused",
                "--updates-per-dispatch", "2", "--steps", "6", "--set", "max_episode_steps=16",
                "--set", "num_actors=4", "--metrics", str(tmp_path / "m.jsonl")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "fused" and out["step"] == 6 and out["replay_plane"] == "device"
    assert np.isfinite(out["loss"]) and out["env_steps"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--preset", "tiny_test", "--env", "catch", "--mode", "fused",
                        "--steps", "2", "--set", "max_episode_steps=16"])
