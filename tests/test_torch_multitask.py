"""The port's multi-task plane (r2d2_tpu_torch/multitask, the task head of
models/r2d2.py, the task field through replay, learner, actor and
collector, sweep.py) against the JAX package's, at tiny_test widths.

- config validation, the ε and gamma ladders and the registry: JAX's,
  values bit for bit (float64 for the ladders);
- the head from converted flax parameters: fp32 rtol 1e-5 / atol 1e-6,
  bf16 1e-2 / 1e-3, with and without task_action_dims; act_select never
  picks a masked action; a single-task head keeps its shapes;
- the task through block, host (numpy and native), tiered (disk tier
  included) and device stores and the in-step gather; single-task stores
  and batches carry none, and a JAX single-task snapshot restores;
- per-task gamma: the accumulator's blocks are JAX's bit for bit;
- a task-stratified train step: loss and priorities within 1e-5, the
  parameters after 3 steps rtol 1e-4 / atol 1e-5;
- the collector on the family cores with task_id, fed JAX's draws: the
  integer fields equal, the float fields rtol 1e-4 / atol 1e-5;
- the MultiTaskTrainers update by update on identical JAX env streams
  (loss, q_mean and priorities rtol 1e-4 / atol 1e-5), and the sweep CLI.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.collect import make_collect_fn as jax_collect_fn
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_train_step as jax_make_train_step
from r2d2_tpu.models.r2d2 import R2D2Network as JaxNet
from r2d2_tpu.models.r2d2 import init_params as jax_init_params
from r2d2_tpu.multitask import MultiTaskTrainer as JaxMultiTaskTrainer
from r2d2_tpu.multitask.registry import build_registry as jax_build_registry
from r2d2_tpu.multitask.registry import resolve_task_names as jax_resolve_task_names
from r2d2_tpu.multitask.trainer import _split_even as jax_split_even
from r2d2_tpu.ops import epsilon as jeps
from r2d2_tpu.replay import snapshot as jsnap
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as RefReplay
from r2d2_tpu.train import build_fn_env as jax_build_fn_env
from r2d2_tpu.train import build_vec_env as jax_build_vec_env
from r2d2_tpu_torch import sweep
from r2d2_tpu_torch.collect import GivenDraws, make_collect_fn
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    TrainState,
    make_optimizer,
    make_store_gather,
    make_train_step,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network, initial_carry
from r2d2_tpu_torch.multitask import MultiTaskTrainer, build_registry, resolve_task_names
from r2d2_tpu_torch.multitask.trainer import _split_even
from r2d2_tpu_torch.ops import epsilon as peps
from r2d2_tpu_torch.replay import snapshot
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.block import store_field_specs
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.tiered_store import TieredReplayBuffer
from r2d2_tpu_torch.train import build_fn_env

torch.set_num_threads(1)

FAMILY = ["keydoor:4:2", "drift", "banditgrid", "catch"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# config, ladders, registry
# --------------------------------------------------------------------------


def _outcome(make, **kw):
    try:
        c = make().replace(**kw)
        return tuple(getattr(c, f) for f in ("num_tasks", "multitask_envs", "task_action_dims",
                                             "task_gammas"))
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("kw", [
    dict(num_tasks=2, multitask_envs=("drift", "banditgrid"), task_action_dims=(3, 4),
         task_gammas=(0.99, 0.98)),
    dict(num_tasks=0),
    dict(num_tasks=2, multitask_envs=("drift",)),
    dict(num_tasks=2, task_action_dims=(3,)),
    dict(num_tasks=2, task_action_dims=(3, 5)),
    dict(num_tasks=2, task_action_dims=(0, 2)),
    dict(num_tasks=2, task_gammas=(0.99,)),
    dict(num_tasks=2, task_gammas=(0.99, 1.0)),
    dict(num_tasks=2, multitask_envs=("drift", "keydoor:20")),
    dict(num_tasks=2, multitask_envs=("drift", "banditgrid:13")),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_multitask_config_is_validated_as_jax_validates(kw):
    assert _outcome(tiny_test, **kw) == _outcome(jax_tiny_test, **kw)


@pytest.mark.parametrize("T,apt,base,alpha", [(1, 1, 0.4, 7.0), (3, 4, 0.4, 7.0),
                                              (4, 2, 0.5, 3.0), (2, 8, 0.4, 7.0)])
def test_epsilon_ladders_are_jax_bit_for_bit(T, apt, base, alpha):
    got = peps.multitask_epsilon_ladders(T, apt, base, alpha)
    want = jeps.multitask_epsilon_ladders(T, apt, base, alpha)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,gmin,gmax", [(1, 0.97, 0.997), (4, 0.97, 0.997), (3, 0.9, 0.99),
                                         (5, 0.99, 0.99)])
def test_gamma_ladder_is_jax_bit_for_bit(T, gmin, gmax):
    got, want = peps.multitask_gamma_ladder(T, gmin, gmax), jeps.multitask_gamma_ladder(
        T, gmin, gmax)
    np.testing.assert_array_equal(got.astype(np.float64), want.astype(np.float64))
    for bad in ((0, gmin, gmax), (2, 0.99, 0.97), (2, 0.0, 0.5)):
        for fn in (peps.multitask_gamma_ladder, jeps.multitask_gamma_ladder):
            with pytest.raises(ValueError):
                fn(*bad)
    with pytest.raises(ValueError):
        peps.multitask_epsilon_ladders(0, 2)


@pytest.mark.parametrize("names", [FAMILY, ["drift", "banditgrid"], ["maze", "drift", "bandit"],
                                   ["keydoor:5:3", "catch"]])
def test_registry_is_jax_registry(names):
    cfg, specs = build_registry(tiny_test(), names)
    jcfg, jspecs = jax_build_registry(jax_tiny_test(), names)
    for f in ("env_name", "action_dim", "num_tasks", "multitask_envs", "task_action_dims"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    np.testing.assert_array_equal(np.asarray(cfg.task_gammas, np.float64),
                                  np.asarray(jcfg.task_gammas, np.float64))
    assert [tuple(s) for s in specs] == [tuple(s) for s in jspecs]
    assert resolve_task_names("maze, drift,bandit,keydoor:4:2") == jax_resolve_task_names(
        "maze, drift,bandit,keydoor:4:2")
    with pytest.raises(ValueError, match="duplicate"):
        build_registry(tiny_test(), ["drift", "drift"])
    with pytest.raises(ValueError, match="no task names"):
        resolve_task_names(" , ")
    for total, parts in ((64, 4), (9, 4), (3, 3)):
        assert _split_even(total, parts) == jax_split_even(total, parts)
    with pytest.raises(ValueError):
        _split_even(2, 3)


# --------------------------------------------------------------------------
# the task-conditioned head
# --------------------------------------------------------------------------


def _inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    T = cfg.seq_len
    return dict(
        obs=rng.integers(0, 256, size=(B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=(B, T)).astype(np.int32),
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=(rng.normal(size=(B, 2, cfg.hidden_dim)) * 0.5).astype(np.float32),
        burn_in=rng.choice([0, 2, cfg.burn_in_steps], size=B).astype(np.int32),
        learning=np.full(B, cfg.learning_steps, np.int32),
        forward=np.full(B, cfg.forward_steps, np.int32),
        task=rng.integers(0, cfg.num_tasks, size=B).astype(np.int32),
    )


def _twin_nets(extra, dims):
    kw = dict(num_tasks=3, action_dim=5, task_action_dims=dims, **extra)
    jcfg, cfg = jax_tiny_test().replace(**kw), tiny_test().replace(**kw)
    jnet, params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    net = R2D2Network.from_config(cfg, device="cpu")
    net.load_state_dict(params_from_flax(_np_tree(params)))
    return cfg, jnet, params, net


@pytest.mark.parametrize("dims", [(5, 3, 4), ()], ids=["masked", "full-union"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_flax(dims, dtype):
    """The head alone on the same core outputs, (B, H) and (B, L, H), at
    the stated tolerance; then the whole network's unroll and acting step
    (fp32 at the head's tolerance; bf16 at the bf16 network's 1e-2 / 1e-2
    of tests/test_torch_bf16.py, its trunk rounding to bf16)."""
    cfg, jnet, params, net = _twin_nets({"compute_dtype": dtype}, dims)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=1e-3)
    net_tol = tol if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    assert net.adv_hidden.weight.shape == (cfg.hidden_dim, cfg.hidden_dim + 3)
    assert net.val_hidden.weight.shape == (cfg.hidden_dim, cfg.hidden_dim + 3)
    rng = np.random.default_rng(0)
    task = rng.integers(0, 3, size=7).astype(np.int32)
    for shape in ((7, cfg.hidden_dim), (7, 4, cfg.hidden_dim)):
        h = rng.normal(size=shape).astype(np.float32)
        want = jnet.apply(params, jnp.asarray(h).astype(jnp.dtype(dtype)), jnp.asarray(task),
                          method=jnet._dueling)
        with torch.no_grad():
            got = net._dueling(torch.from_numpy(h).to(cfg.torch_compute_dtype),
                               torch.from_numpy(task))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=str(shape), **tol)
    x = _inputs(cfg, 6, 1)
    names = ("obs", "last_action", "last_reward", "hidden", "burn_in", "learning", "forward",
             "task")
    want = jnet.apply(params, *(jnp.asarray(x[k]) for k in names))
    with torch.no_grad():
        got = net(*(torch.from_numpy(x[k]) for k in names))
    for g, w, what in zip(got, want, ("q_learn", "q_boot", "mask")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **net_tol)
    # the acting step, with its carry
    obs = x["obs"][:, 0]
    carry = (x["hidden"][:, 0], x["hidden"][:, 1])
    jq, jc = jnet.apply(params, jnp.asarray(obs), jnp.asarray(x["last_action"][:, 0]),
                        jnp.asarray(x["last_reward"][:, 0]), tuple(map(jnp.asarray, carry)),
                        task=jnp.asarray(x["task"]), method=jnet.act)
    with torch.no_grad():
        q, c = net.act(torch.from_numpy(obs), torch.from_numpy(x["last_action"][:, 0]),
                       torch.from_numpy(x["last_reward"][:, 0]),
                       tuple(torch.from_numpy(v) for v in carry), torch.from_numpy(x["task"]))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **net_tol)
    for g, w in zip(c, jc):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **net_tol)
    if dims:
        invalid = np.arange(5)[None, :] >= np.asarray(dims)[x["task"]][:, None]
        assert (q.numpy()[invalid] == np.float32(-1e9)).all()
        assert (got[0].numpy()[np.broadcast_to(invalid[:, None], got[0].shape)] == -1e9).all()
    # the conversion round trip of the widened head is bitwise
    back = params_to_flax(net)["params"]
    for head in ("adv_hidden", "val_hidden", "adv_out", "val_out"):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[head][k], np.asarray(params["params"][head][k]))


def test_act_select_never_picks_a_masked_action():
    cfg, _, _, net = _twin_nets({}, (2, 5, 3))
    B = 64
    x = _inputs(cfg, B, 2)
    carry = initial_carry(B, cfg.hidden_dim, "cpu")
    task = torch.from_numpy(x["task"])
    dims = torch.tensor([2, 5, 3])[task.long()]
    with torch.no_grad():
        for seed in range(4):
            net.adv_out.bias.normal_(generator=torch.Generator().manual_seed(seed))
            q, a, carry = net.act_select(
                torch.from_numpy(x["obs"][:, seed]), torch.from_numpy(x["last_action"][:, 0]),
                torch.from_numpy(x["last_reward"][:, 0]), carry, torch.zeros(B, dtype=torch.bool),
                torch.zeros(B, dtype=torch.int32), task)
            assert (a.long() < dims).all()
            assert torch.equal(a.long(), q.argmax(-1))


def test_single_task_head_keeps_its_shapes():
    cfg = tiny_test()
    net = R2D2Network.from_config(cfg, device="cpu")
    assert net.adv_hidden.weight.shape == (cfg.hidden_dim, cfg.hidden_dim)
    _, params = jax_init_params(jax.random.PRNGKey(0), jax_tiny_test())
    sd = params_from_flax(_np_tree(params))
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in net.state_dict().items()}


# --------------------------------------------------------------------------
# blocks, stores, per-task gamma
# --------------------------------------------------------------------------


def _mt_cfgs(**kw):
    base = dict(block_length=12, buffer_capacity=240, learning_starts=24, batch_size=6,
                use_native_replay=False)
    base.update(kw)
    cfg, _ = build_registry(tiny_test().replace(**base), ["drift", "banditgrid", "keydoor:4:2"])
    jcfg, _ = jax_build_registry(jax_tiny_test().replace(**base),
                                 ["drift", "banditgrid", "keydoor:4:2"])
    return cfg, jcfg


def _episodes(cfg, seed, n=8):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        length = int(rng.choice([3, 7, cfg.block_length + 5, 29]))
        first = rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8)
        steps = [(int(rng.integers(cfg.action_dim)), float(rng.normal()),
                  rng.integers(0, 256, size=cfg.obs_shape, dtype=np.uint8),
                  rng.normal(size=cfg.action_dim).astype(np.float32),
                  rng.normal(size=(2, cfg.hidden_dim)).astype(np.float32))
                 for _ in range(length)]
        yield first, steps, rng.normal(size=(length, cfg.action_dim)).astype(np.float32)


def _blocks(acc, cfg, seed):
    out = []
    for first, steps, boot in _episodes(cfg, seed):
        acc.reset(first)
        for i, step in enumerate(steps):
            acc.add(*step)
            if i == len(steps) - 1:
                out.append(acc.finish(last_qval=None))
            elif len(acc) == cfg.block_length:
                out.append(acc.finish(last_qval=boot[i]))
    return out


def test_per_task_gamma_blocks_are_jax_bit_for_bit():
    cfg, jcfg = _mt_cfgs()
    for task_id, gamma in ((1, 0.98), (2, 0.9731)):
        got = _blocks(SequenceAccumulator(cfg, task_id=task_id, gamma=gamma), cfg, task_id)
        want = _blocks(RefAccumulator(jcfg, task_id=task_id, gamma=gamma), jcfg, task_id)
        assert len(got) == len(want) > 4
        for (b, p, r), (jb, jp, jr) in zip(got, want):
            assert b.task == jb.task == task_id
            for f in ("obs", "last_action", "last_reward", "action", "n_step_reward", "gamma",
                      "hidden", "burn_in_steps", "learning_steps", "forward_steps"):
                np.testing.assert_array_equal(getattr(b, f), getattr(jb, f), err_msg=f)
            np.testing.assert_array_equal(p, jp)
            assert r == jr
        assert got[0][0].gamma[0] == np.float32(gamma ** cfg.forward_steps)


def _filled(buf, cfg, tasks=(0, 1, 2), seed=0):
    for t in tasks:
        for block in _blocks(SequenceAccumulator(cfg, task_id=t), cfg, seed + t):
            block[0].obs[:, 0, 0, 0] = t  # the task, readable from any window
            buf.add_block(*block)
    return buf


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_task_round_trips_through_the_host_and_device_stores(native):
    # a store the blocks do not wrap: the host slab keeps a rewritten slot's
    # old tail where the device store zero-pads, and windows may read it
    cfg, jcfg = _mt_cfgs(buffer_capacity=960)
    cfg = cfg.replace(use_native_replay=native)
    host = _filled(ReplayBuffer(cfg), cfg)
    ref = RefReplay(jcfg)
    for t in (0, 1, 2):
        for block in _blocks(RefAccumulator(jcfg, task_id=t), jcfg, t):
            block[0].obs[:, 0, 0, 0] = t
            ref.add_block(*block)
    dev = _filled(DeviceReplayBuffer(cfg, "cpu"), cfg)
    assert dev.stores["task"].dtype == torch.int32
    gather = make_store_gather(cfg)
    for seed in range(3):
        hb = host.sample_batch(np.random.default_rng(seed))
        jb = ref.sample_batch(np.random.default_rng(seed))
        np.testing.assert_array_equal(hb.task, jb.task)
        np.testing.assert_array_equal(hb.idxes, jb.idxes)
        np.testing.assert_array_equal(hb.task, hb.obs[:, 0, 0, 0, 0])
        assert hb.task.dtype == np.int32
        si = dev.sample_indices(np.random.default_rng(seed))
        got = dev.run_with_stores(lambda st: gather(st, *(torch.from_numpy(x) for x in (
            si.b, si.s, si.is_weights))))
        want = DeviceBatch.from_sampled(hb, "cpu")
        assert torch.equal(got.task, want.task) and got.task.dtype == torch.int32
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        jdev = JaxBatch.from_sampled(hb)
        np.testing.assert_array_equal(np.asarray(jdev.task), want.task.numpy())


def test_task_survives_the_tiered_planes_disk_tier(tmp_path):
    cfg, _ = _mt_cfgs()
    cfg = cfg.replace(replay_plane="tiered", buffer_capacity=24, replay_disk_capacity=240,
                      replay_disk_dir=str(tmp_path / "disk"), learning_starts=12)
    buf = _filled(TieredReplayBuffer(cfg), cfg)
    assert buf.disk_stats()["disk_demotions"] > 0
    rng = np.random.default_rng(0)
    for _ in range(4):
        b = buf.sample_batch(rng)
        np.testing.assert_array_equal(b.task, b.obs[:, 0, 0, 0, 0])
    assert set(np.concatenate([buf.sample_batch(rng).task for _ in range(8)])) == {0, 1, 2}


def test_single_task_stores_and_batches_carry_no_task(tmp_path):
    cfg = tiny_test().replace(block_length=12, buffer_capacity=240, learning_starts=24,
                              batch_size=4, use_native_replay=False)
    assert "task" not in store_field_specs(cfg)
    host = ReplayBuffer(cfg)
    for block in _blocks(SequenceAccumulator(cfg), cfg, 0):
        assert block[0].task == 0
        host.add_block(*block)
    b = host.sample_batch(np.random.default_rng(0))
    assert b.task is None and "task" not in vars(b)
    assert DeviceBatch.from_sampled(b, "cpu").task is None
    dev = DeviceReplayBuffer(cfg, "cpu")
    assert "task" not in dev.stores
    # a JAX single-task snapshot restores into the port's buffer
    jcfg = jax_tiny_test().replace(**{f.name: getattr(cfg, f.name)
                                      for f in dataclasses.fields(cfg)})
    ref = RefReplay(jcfg)
    for block in _blocks(RefAccumulator(jcfg), jcfg, 0):
        ref.add_block(*block)
    path = str(tmp_path / "jax.npz")
    jsnap.save_replay(ref, path)
    dst = ReplayBuffer(cfg)
    snapshot.restore_replay(dst, path)
    got, want = dst.sample_batch(np.random.default_rng(3)), ref.sample_batch(
        np.random.default_rng(3))
    np.testing.assert_array_equal(got.obs, want.obs)
    assert got.task is None and want.task is None


# --------------------------------------------------------------------------
# the task-stratified train step
# --------------------------------------------------------------------------


class _Sampled:
    def __init__(self, d):
        self.__dict__.update(d)


def _stratified(cfg, seed):
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    task = np.repeat(np.arange(cfg.num_tasks), _split_even(B, cfg.num_tasks)).astype(np.int32)
    dims = np.asarray(cfg.task_action_dims)[task]
    burn = rng.choice([0, 2, cfg.burn_in_steps], size=B).astype(np.int32)
    learn = np.full(B, L, np.int32)
    learn[-1] = L - 1
    return dict(
        obs=rng.integers(0, 256, size=(B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=(rng.integers(0, 1 << 20, size=(B, T)) % dims[:, None]).astype(np.int32),
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=(rng.normal(size=(B, 2, cfg.hidden_dim)) * 0.5).astype(np.float32),
        action=(rng.integers(0, 1 << 20, size=(B, L)) % dims[:, None]).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        gamma=np.asarray(cfg.task_gammas, np.float32)[task][:, None].repeat(L, 1) ** 2,
        burn_in_steps=burn, learning_steps=learn,
        forward_steps=np.minimum(T - burn - learn, cfg.forward_steps).astype(np.int32),
        is_weights=rng.uniform(0.3, 1.0, size=B).astype(np.float32),
        task=task,
    )


def _port_state(cfg, tree):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(tree))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


def test_task_stratified_train_steps_match_jax():
    base = dict(batch_size=8, target_net_update_interval=2)
    cfg, _ = build_registry(tiny_test().replace(**base), FAMILY)
    jcfg, _ = jax_build_registry(jax_tiny_test().replace(**base), FAMILY)
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jcfg, net, donate=False)
    pstate = _port_state(cfg, _np_tree(jstate.params))
    pstep = make_train_step(cfg)
    for i in range(3):
        b = _Sampled(_stratified(cfg, 10 + i))
        jstate, jm, jprio = jstep(jstate, JaxBatch.from_sampled(b))
        pstate, pm, pprio = pstep(pstate, DeviceBatch.from_sampled(b, "cpu"))
        if i == 0:
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(pprio.numpy(), np.asarray(jprio), rtol=1e-5, atol=1e-5)
    for port, tree, what in ((pstate.net, jstate.params, "online"),
                             (pstate.target_net, jstate.target_params, "target")):
        got = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(port)["params"])[0])
        want = jax.tree_util.tree_flatten_with_path(_np_tree(tree)["params"])[0]
        assert len(got) == len(want)
        for path, v in want:
            np.testing.assert_allclose(got[path], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what}{jax.tree_util.keystr(path)}")


# --------------------------------------------------------------------------
# the collector with task_id on the family cores
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["keydoor:4:3", "drift", "banditgrid"])
def test_collector_on_a_family_core_matches_jax_with_its_draws(name):
    n, T, task_id, gamma = 4, 12, 1, 0.98
    base = dict(block_length=12, buffer_capacity=624, num_actors=n, max_episode_steps=12)
    cfg, _ = build_registry(tiny_test().replace(**base), ["catch", name])
    jcfg, _ = jax_build_registry(jax_tiny_test().replace(**base), ["catch", name])
    ref_env = jax_build_fn_env(jcfg.replace(env_name=name))
    port_env = build_fn_env(cfg.replace(env_name=name))
    A = port_env.NUM_ACTIONS
    jnet, params = jax_init_params(jax.random.PRNGKey(1), jcfg)
    net = R2D2Network.from_config(cfg, device="cpu")
    net.load_state_dict(params_from_flax(_np_tree(params)))
    env0 = jax.vmap(ref_env.reset)(jax.random.split(jax.random.PRNGKey(2), n))
    key = jax.random.PRNGKey(3)
    eps = np.asarray([0.0, 0.3, 0.6, 1.0], np.float32)
    jout = jax_collect_fn(jcfg, jnet, ref_env, n, T, task_id=task_id, action_dim=A,
                          gamma=gamma)(params, env0, jnp.asarray(eps), key)
    # JAX's draws: the ε coins and random actions of each step, the env's
    # own per-step draws along its key chain, the fresh resets' key
    keys = jax.random.split(key, T + 2)
    u, a, env_draws, k = [], [], [], env0.key
    for t in range(T):
        ke, ka = jax.random.split(keys[t])
        u.append(np.asarray(jax.random.uniform(ke, (n,))))
        a.append(np.asarray(jax.random.randint(ka, (n,), 0, A)))
        k, sub = jax.vmap(jax.random.split)(k).transpose(1, 0, 2)
        if name == "drift":
            env_draws.append(np.asarray(jax.vmap(lambda s: jax.random.randint(s, (), -1, 2))(sub)))
        else:
            env_draws.append(np.asarray(jax.vmap(jax.random.normal)(sub)))
    fresh = jax.vmap(ref_env.reset)(jax.random.split(keys[T + 1], n))
    state_cls = type(port_env.reset(1))

    def port_state(s):
        return state_cls(*(torch.from_numpy(np.array(getattr(s, f))) for f in state_cls._fields))

    draws = GivenDraws(np.stack(u), np.stack(a), resets=port_state(fresh),
                       respawns=None if name.startswith("keydoor") else np.stack(env_draws))
    pout = make_collect_fn(cfg, port_env, n, T, task_id=task_id, action_dim=A, gamma=gamma)(
        net, port_state(env0), torch.from_numpy(eps), draws)
    jf, pf = jout[0], pout[0]
    assert set(pf) == set(jf) and (pf["task"] == task_id).all()
    for k in ("obs", "last_action", "action", "burn_in", "learning", "forward", "task"):
        np.testing.assert_array_equal(pf[k].numpy(), np.asarray(jf[k]), err_msg=k)
    assert int(pf["action"].max()) < A
    for k in ("last_reward", "n_step_reward", "gamma", "hidden"):
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(jf[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(pout[1].numpy(), np.asarray(jout[1]), rtol=1e-4, atol=1e-5)
    for i in (2, 3, 4):
        np.testing.assert_array_equal(pout[i].numpy(), np.asarray(jout[i]))


# --------------------------------------------------------------------------
# the trainers, and the sweep CLI
# --------------------------------------------------------------------------


def _load_flax(tr, tree):
    sd = params_from_flax(tree)
    for net in (tr.state.net, tr.state.target_net, *(a.policy for a in tr.actors)):
        net.load_state_dict(sd)
    tr.param_store.publish(tr.state.net)
    for a in tr.actors:
        a.param_version = tr.param_store.version


def test_multitask_trainer_matches_jax_update_by_update():
    kw = dict(num_actors=8, batch_size=8, learning_starts=32, use_native_replay=False)
    cfg, jcfg = tiny_test().replace(**kw), jax_tiny_test().replace(**kw)
    jreg, _ = jax_build_registry(jcfg, FAMILY)
    T = len(FAMILY)

    def envs():
        # the JAX package's env of every task, as its trainer builds them
        return [jax_build_vec_env(jreg.replace(env_name=n, num_actors=2),
                                  seed=jcfg.seed + 101 * (t + 1)) for t, n in enumerate(FAMILY)]

    jtr = JaxMultiTaskTrainer(jcfg, FAMILY)
    ptr = MultiTaskTrainer(cfg, FAMILY, device="cpu", vec_envs=envs())
    # JAX's trainer steps its own instances of the same streams
    for actor, env in zip(jtr.actors, envs()):
        actor.env = env
        actor._reset_state(np.array(env.reset_all()))
    _load_flax(ptr, _np_tree(jtr.state.params))
    assert ptr.batch_split == jtr.batch_split and len(ptr.actors) == T
    jtr.warmup()
    ptr.warmup()
    for pr, jr in zip(ptr.replays, jtr.replays):
        assert (len(pr), pr.env_steps) == (len(jr), jr.env_steps)
    for i in range(4):
        pm, jm = ptr.train(1), jtr.train(1)
        for k in ("loss", "q_mean"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"update {i} {k}")
        for pr, jr in zip(ptr.replays, jtr.replays):
            assert pr.env_steps == jr.env_steps
            np.testing.assert_allclose(pr.tree.tree, jr.tree.tree, rtol=1e-4, atol=1e-5)
    pb, _ = ptr._sample_stratified()
    assert pb.task.tolist() == sum(([t] * n for t, n in enumerate(ptr.batch_split)), [])
    row = ptr._metrics_row(pm)
    assert [row[f"task{t}_env_steps"] for t in range(T)] == [r.env_steps for r in ptr.replays]
    rows = ptr.evaluate(episodes=2, horizon=6)
    assert [r["task"] for r in rows] == list(range(T))
    assert all(np.isfinite(r["mean_return"]) for r in rows)
    # every stored action is inside its task's native range
    for t, replay in enumerate(ptr.replays):
        assert replay.action_store[:replay.block_ptr].max() < ptr.specs[t].action_dim


def test_sweep_multitask_cli_writes_one_row_per_task(tmp_path, capsys):
    root = tmp_path / "sw"
    sweep.main(["--multitask", "drift,bandit", "--steps", "4", "--root", str(root),
                "--eval-episodes", "2", "--device", "cpu", "--set", "num_actors=4"])
    rows = [json.loads(line) for line in open(root / "summary.jsonl")]
    assert [r["env"] for r in rows] == ["drift", "banditgrid", "catch"]
    assert all(r["steps"] == 4 and r["mode"] == "multitask" for r in rows)
    out = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(out) == 3
    assert sweep.sweep_config("Pong", root="r").checkpoint_dir == "r/Pong/checkpoints"


def test_run_sweep_drives_the_port_trainer(tmp_path):
    rows = sweep.run_sweep(["catch"], preset="tiny_test", root=str(tmp_path), steps=3,
                           mode="inline", device="cpu",
                           cfg_overrides={"learning_starts": 48, "save_interval": 100})
    assert rows[0]["steps"] == 3 and rows[0]["env_steps"] > 0
    assert copy.deepcopy(rows[0]) == json.loads(open(tmp_path / "summary.jsonl").read())
