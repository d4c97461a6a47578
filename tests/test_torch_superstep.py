"""The port's N x K priority superstep (megastep.make_priority_superstep) and
the device priority plane through the Trainer, against the JAX package.

A superstep of N on uniforms u is N superstep-1 calls on u[d] bit for bit;
one superstep is its hand-rolled parts (K descents and IS weights against
the entry tree, make_multi_update_core, the row-by-row write-back) bit for
bit; fed the uniforms JAX draws from its key, it matches JAX's superstep on
the same stores, tree and parameters (fp32, rtol 1e-4 / atol 1e-5). The
draws derive from (seed, step // (N*K)), so a resume derives them again;
the device tree restores from its own float32 snapshot leaves.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.megastep import make_priority_superstep as jax_superstep
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.device_store import DeviceReplayBuffer as RefDeviceBuffer
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import TrainState, make_multi_update_core, make_optimizer
from r2d2_tpu_torch.megastep import (
    make_priority_superstep,
    superstep_generators,
    superstep_uniforms,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.replay import device_sum_tree as dst
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.train import Trainer

torch.set_num_threads(1)

DEVICE_PRIORITY = dict(replay_plane="device", priority_plane="device",
                       target_net_update_interval=2)


def _device_cfg(tmp_path, **over):
    return tiny_test().replace(
        env_name="catch", updates_per_dispatch=2, superstep_dispatches=1, training_steps=8,
        checkpoint_dir=str(tmp_path / "ckpt"), metrics_path=str(tmp_path / "m.jsonl"),
        save_interval=1000, **DEVICE_PRIORITY).replace(**over)


@pytest.fixture(scope="module")
def warm_trainer(tmp_path_factory):
    tr = Trainer(_device_cfg(tmp_path_factory.mktemp("superstep")), device="cpu")
    tr.warmup()
    return tr


def _same_state(a, b):
    for x, y in zip(list(a.net.parameters()) + list(a.target_net.parameters()),
                    list(b.net.parameters()) + list(b.target_net.parameters())):
        assert torch.equal(x, y)
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
    assert a.step == b.step


def test_superstep_of_n_is_n_superstep_ones(warm_trainer):
    tr = warm_trainer
    cfg, K = tr.cfg, tr.cfg.updates_per_dispatch
    rp = tr.replay
    nss = torch.from_numpy(rp.num_seq_store)
    tree0 = rp.dtree.tree
    u = superstep_uniforms(superstep_generators(17, 0, 2, "cpu"), K, cfg.batch_size, "cpu")
    # a superstep writes its final tree into the tree it was given
    sA, treeA, mA = make_priority_superstep(cfg, 2, K)(
        copy.deepcopy(tr.state), rp.stores, tree0.clone(), nss, u)
    one = make_priority_superstep(cfg, 1, K)
    sB, treeB, _ = one(copy.deepcopy(tr.state), rp.stores, tree0.clone(), nss, u[0:1])
    sB, treeB, mB = one(sB, rp.stores, treeB, nss, u[1:2])
    assert torch.equal(treeA, treeB) and not torch.equal(treeA, tree0)
    _same_state(sA, sB)
    assert all(torch.equal(mA[k], mB[k]) for k in mA)
    assert sA.step == tr.state.step + 2 * K
    with pytest.raises(ValueError, match="uniforms"):
        one(copy.deepcopy(tr.state), rp.stores, tree0, nss, u)


def test_superstep_is_its_hand_rolled_parts(warm_trainer):
    tr = warm_trainer
    cfg, K = tr.cfg, tr.cfg.updates_per_dispatch
    S = cfg.seqs_per_block
    L = dst.tree_layers(cfg.num_sequences)
    rp = tr.replay
    nss = rp.num_seq_store
    tree0 = rp.dtree.tree
    u = superstep_uniforms(superstep_generators(23, 0, 1, "cpu"), K, cfg.batch_size, "cpu")
    sA, treeA, _ = make_priority_superstep(cfg, 1, K)(
        copy.deepcopy(tr.state), rp.stores, tree0.clone(), torch.from_numpy(nss), u)
    leaf = np.stack([dst.tree_descend(tree0, L, uk).numpy() for uk in u[0]])
    w = np.stack([dst.is_weights(tree0, L, torch.from_numpy(li), cfg.is_exponent).numpy()
                  for li in leaf])
    b = leaf // S
    s = np.minimum(leaf % S, np.maximum(nss[b] - 1, 0))
    sB, _, prios = make_multi_update_core(cfg, K)(
        copy.deepcopy(tr.state), rp.stores, *(torch.from_numpy(x) for x in (b, s, w)))
    treeB = tree0
    for li, td in zip(b * S + s, prios):
        treeB = dst.tree_update(treeB, L, torch.from_numpy(li), td, cfg.prio_exponent)
    assert torch.equal(treeA, treeB)
    _same_state(sA, sB)


def _jax_uniforms(key, n, k, batch):
    """The (N, K, B) uniforms JAX's superstep draws from `key`."""
    dkeys = jax.random.split(key, n) if n > 1 else key[None]
    return np.stack([np.stack([np.asarray(jax.random.uniform(kk, (batch,), dtype=jnp.float32))
                               for kk in jax.random.split(kd, k)]) for kd in dkeys])


def _port_state(cfg, tree):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(tree))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


@pytest.mark.parametrize("n", [1, 2])
def test_superstep_matches_jax_with_its_draws(n):
    K = 2
    cfg = tiny_test().replace(**DEVICE_PRIORITY)
    jcfg = jax_tiny_test().replace(lstm_backend="pallas", **DEVICE_PRIORITY)
    dev, jbuf = DeviceReplayBuffer(cfg, "cpu"), RefDeviceBuffer(jcfg)
    for buf, acc_cls, c in ((dev, SequenceAccumulator, cfg), (jbuf, RefAccumulator, jcfg)):
        for i in range(10):
            acc = acc_cls(c)
            rng = np.random.default_rng(200 + i)
            acc.reset(rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8))
            for _ in range([16, 9, 16, 5, 13][i % 5]):
                acc.add(action=int(rng.integers(cfg.action_dim)), reward=float(rng.normal()),
                        next_obs=rng.integers(0, 256, cfg.obs_shape, dtype=np.uint8),
                        q_value=rng.normal(size=cfg.action_dim).astype(np.float32),
                        hidden=(rng.normal(size=(2, cfg.hidden_dim)) * 0.5).astype(np.float32))
            buf.add_block(*acc.finish(last_qval=None if i % 2 else
                                      rng.normal(size=cfg.action_dim).astype(np.float32)))
    # the same tree bits on both sides (ingestion's pow may differ by an ulp)
    jbuf.dtree.load_leaves(dev.dtree.leaves())
    np.testing.assert_array_equal(np.asarray(jbuf.dtree.tree), dev.dtree.tree.numpy())
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    pstate = _port_state(cfg, jax.tree.map(np.asarray, jstate.params))
    key = jax.random.PRNGKey(31)
    u = torch.from_numpy(_jax_uniforms(key, n, K, cfg.batch_size))
    pstate, ptree, pm = make_priority_superstep(cfg, n, K)(
        pstate, dev.stores, dev.dtree.tree.clone(), torch.from_numpy(dev.num_seq_store), u)
    jstate, jtree, jm = jax_superstep(jcfg, net, n, K, donate=False)(
        jstate, jbuf.stores, jbuf.dtree.tree, jnp.asarray(jbuf.num_seq_store), key)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ptree.numpy(), np.asarray(jtree), rtol=1e-4, atol=1e-5)
    # the same leaves were written: the trees differ only in the values
    changed = ptree.numpy() != dev.dtree.tree.numpy()
    np.testing.assert_array_equal(changed, np.asarray(jtree) != np.asarray(jbuf.dtree.tree))
    assert pstate.step == int(jstate.step) == n * K
    for port, ref in ((pstate.net, jstate.params), (pstate.target_net, jstate.target_params)):
        flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref))[0]
        flat_t = dict(jax.tree_util.tree_flatten_with_path(params_to_flax(port))[0])
        for path, v in flat_j:
            np.testing.assert_allclose(flat_t[path], v, rtol=1e-4, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))


def test_draws_derive_from_seed_and_superstep_counter():
    a = superstep_uniforms(superstep_generators(9, 3, 2, "cpu"), 2, 5, "cpu")
    b = superstep_uniforms(superstep_generators(9, 3, 2, "cpu"), 2, 5, "cpu")
    c = superstep_uniforms(superstep_generators(9, 4, 2, "cpu"), 2, 5, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a[0], a[1])
    # dispatch d's draws do not depend on how many dispatches follow it
    one = superstep_uniforms(superstep_generators(9, 3, 1, "cpu"), 2, 5, "cpu")
    assert torch.equal(one[0], a[0])


def test_trainer_steps_and_counters(tmp_path):
    import json

    cfg = _device_cfg(tmp_path, superstep_dispatches=2, updates_per_dispatch=2,
                      training_steps=16)
    tr = Trainer(cfg, device="cpu")
    tr.run_inline(env_steps_per_update=4)
    assert tr.state.step == 16 and tr._step == 16 and tr.plane.steps_per_update == 4
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    assert recs[-1]["step"] == 16 and np.isfinite(recs[-1]["loss"])
    dev = tr.replay.dtree.leaves()
    assert np.isfinite(dev).all() and (dev >= 0).all() and dev.sum() > 0
    # the learner's write-backs land on the device tree only
    assert not np.allclose(dev, tr.replay.tree.leaves(), rtol=1e-5, atol=1e-6)


def test_snapshot_resume_restores_the_device_tree_exactly(tmp_path):
    cfg = _device_cfg(tmp_path, superstep_dispatches=2, updates_per_dispatch=2,
                      training_steps=8, save_interval=4, snapshot_replay=True)
    tr = Trainer(cfg, device="cpu")
    tr.run_inline(env_steps_per_update=4)
    leaves = tr.replay.dtree.leaves()
    tr2 = Trainer(cfg.replace(training_steps=16), device="cpu", resume=True)
    assert tr2.state.step == 8
    np.testing.assert_array_equal(tr2.replay.dtree.leaves(), leaves)
    assert torch.equal(tr2.replay.dtree.tree, tr.replay.dtree.tree)
    tr2.run_inline(env_steps_per_update=4)
    assert tr2.state.step == 16


def test_resume_step_must_divide_the_superstep_quantum(tmp_path):
    cfg = _device_cfg(tmp_path, training_steps=8, save_interval=4)
    Trainer(cfg, device="cpu").run_inline(env_steps_per_update=4)
    bad = cfg.replace(superstep_dispatches=3, updates_per_dispatch=2, training_steps=12)
    with pytest.raises(ValueError, match="superstep"):
        Trainer(bad, device="cpu", resume=True)
