"""The port's train step (r2d2_tpu_torch/learner.py) against JAX
`make_train_step`, built with lstm_backend="pallas" so the JAX side runs the
Pallas kernels in interpret mode.

From the same converted TrainState and the same batches, 1 and 3 steps must
agree on loss, priorities and every online and target parameter. The target
sync interval is 2, so three steps cross one in-step sync. One case drives the
gradient norm past `grad_norm`, so the clip runs; the clip's missing epsilon
is pinned directly against optax at a norm where an epsilon would show.

Tolerances: loss, priorities and parameters rtol 1e-4 / atol 1e-5 (the
gradient tolerance of tests/test_pallas_lstm.py; Adam's update is close to
scale-free, so parameter errors stay at the gradient's relative error times
the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_train_step as jax_make_train_step
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    TrainState,
    clip_by_global_norm_,
    lr_at,
    make_optimizer,
    make_train_step,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network

torch.set_num_threads(1)

OVERRIDES = dict(target_net_update_interval=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed, reward_scale=1.0):
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    burn = rng.choice([0, 2, cfg.burn_in_steps], size=B).astype(np.int32)
    learn = np.full(B, L, np.int32)
    learn[-1] = L - 1
    fwd = np.minimum(T - burn - learn, cfg.forward_steps).astype(np.int32)
    return dict(
        obs=rng.integers(0, 256, size=(B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=(B, T)).astype(np.int32),
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=(rng.normal(size=(B, 2, cfg.hidden_dim)) * 0.5).astype(np.float32),
        action=rng.integers(0, cfg.action_dim, size=(B, L)).astype(np.int32),
        n_step_reward=(rng.normal(size=(B, L)) * reward_scale).astype(np.float32),
        gamma=np.full((B, L), cfg.gamma ** cfg.forward_steps, np.float32),
        burn_in_steps=burn,
        learning_steps=learn,
        forward_steps=fwd,
        is_weights=rng.uniform(0.3, 1.0, size=B).astype(np.float32),
    )


class _Sampled:
    """A SampledBatch's fields, for both packages' DeviceBatch.from_sampled."""

    task = None

    def __init__(self, d):
        self.__dict__.update(d)


def _port_state(cfg, tree):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(tree))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


def _assert_trees_close(port_tree, jax_tree, what):
    flat_j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_allclose(flat_t[path], v, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize(
    "steps,reward_scale,extra",
    [
        (1, 1.0, {}),
        (3, 1.0, {}),
        (3, 1.0, {"lr_schedule": "cosine", "training_steps": 4}),
        (3, 300.0, {"grad_norm": 1.0}),  # gradient norm above grad_norm: the clip runs
    ],
    ids=["1step", "3steps", "3steps-cosine", "3steps-clipped"],
)
def test_train_steps_match_jax(steps, reward_scale, extra):
    kw = {**OVERRIDES, **extra}
    jcfg = jax_tiny_test().replace(lstm_backend="pallas", **kw)
    net, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jcfg, net, donate=False)
    cfg = tiny_test().replace(**kw)
    pstate = _port_state(cfg, _np_tree(jstate.params))
    pstep = make_train_step(cfg)

    for i in range(steps):
        b = _batch(cfg, seed=10 + i, reward_scale=reward_scale)
        jstate, jm, jprio = jstep(jstate, JaxBatch.from_sampled(_Sampled(b)))
        pstate, pm, pprio = pstep(pstate, DeviceBatch.from_sampled(_Sampled(b), "cpu"))
        for k in ("loss", "grad_norm", "q_mean", "target_mean", "td_abs_mean"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(pprio.numpy(), np.asarray(jprio), rtol=1e-4, atol=1e-5)
        if reward_scale > 1.0:
            assert float(pm["grad_norm"]) > cfg.grad_norm
    assert pstate.step == int(jstate.step) == steps
    _assert_trees_close(params_to_flax(pstate.net), _np_tree(jstate.params), "params")
    _assert_trees_close(params_to_flax(pstate.target_net),
                        _np_tree(jstate.target_params), "target")
    synced = steps >= cfg.target_net_update_interval
    same = all(torch.equal(a, b) for a, b in zip(pstate.net.state_dict().values(),
                                                 pstate.target_net.state_dict().values()))
    assert same == (steps % cfg.target_net_update_interval == 0)
    if not synced:
        _assert_trees_close(params_to_flax(pstate.target_net), _np_tree(
            jax_init_train_state(jcfg, jax.random.PRNGKey(0))[1].params), "initial target")


def test_clip_has_no_epsilon_like_optax():
    """At a global norm of 1e-3, torch's clip_grad_norm_ (norm + 1e-6 in the
    denominator) is off by 1e-3 relative; optax's clip has no epsilon."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    grads = [g * np.float32(1e-3 / norm) for g in grads]
    max_norm = 1e-4
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    port = [torch.from_numpy(g.copy()) for g in grads]
    pre = clip_by_global_norm_(port, max_norm)
    np.testing.assert_allclose(float(pre), 1e-3, rtol=1e-5)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    # below the threshold nothing changes, bit for bit
    small = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(small, 1.0)
    for s, g in zip(small, grads):
        np.testing.assert_array_equal(s.numpy(), g)


def test_cosine_schedule_matches_optax_and_holds_at_the_floor():
    cfg = tiny_test().replace(lr_schedule="cosine", training_steps=10, lr_final_frac=0.1)
    sched = optax.cosine_decay_schedule(cfg.lr, cfg.training_steps, alpha=cfg.lr_final_frac)
    for count in (0, 1, 5, 9, 10, 25):
        np.testing.assert_allclose(lr_at(cfg, count), float(sched(count)), rtol=1e-6)
    assert lr_at(tiny_test(), 7) == tiny_test().lr
