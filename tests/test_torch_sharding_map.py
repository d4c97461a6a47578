"""The port's placement table and its tp / fsdp steps
(r2d2_tpu_torch/parallel/sharding_map.py, models/tp.py, the mesh and
learner.make_sharded_train_step's tp path and ShardedAdam), mirroring the
JAX package's tests/test_sharding_map.py, against the JAX package on its 8
fake CPU devices.

The table gives, leaf by leaf, JAX's train_state_shardings spec of every
parameter, target and Adam-moment leaf (the port's names mapped to JAX's
paths by interop), and each mesh coordinate's slice of a port tensor is
JAX's addressable shard of the converted leaf; int8 serve trees follow the
kernel rules. The port's manual tp=2 x fsdp=2 x dp=2 step, its tp=2 gspmd
step and its fsdp=2 step match JAX's on the same converted parameters and
batch (fp32 rtol 1e-4 / atol 1e-5, bf16 2e-3 / 5e-4) over two updates; the
ZeRO-2 moment shards are JAX's; a checkpoint of a tp x fsdp run resumes
into another layout and trains on as the unsharded run; the configs valid
in one package are the ones valid in the other; PolicyServer(mesh=)
serves what mesh=None serves.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.learner import DeviceBatch as JaxBatch
from r2d2_tpu.learner import init_train_state as jax_init_train_state
from r2d2_tpu.learner import make_manual_train_step as jax_manual_step
from r2d2_tpu.learner import make_train_step as jax_train_step
from r2d2_tpu.ops.quantize import quantize_tree as jax_quantize_tree
from r2d2_tpu.parallel import manual_batch_sharding, shard_batch
from r2d2_tpu.parallel import make_mesh as jax_make_mesh
from r2d2_tpu.parallel import serve_param_shardings as jax_serve_shardings
from r2d2_tpu.parallel import train_state_shardings as jax_state_shardings
from r2d2_tpu.parallel.sharding_map import process_name as jax_process_name
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.interop import flax_leaf, params_from_flax, params_to_flax
from r2d2_tpu_torch.learner import (
    DeviceBatch,
    ShardedAdam,
    TrainState,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
    shard_optimizer,
)
from r2d2_tpu_torch.models.r2d2 import R2D2Network
from r2d2_tpu_torch.ops.quantize import quantize_tree
from r2d2_tpu_torch.parallel.mesh import data_shard_devices, make_mesh, shard_slices
from r2d2_tpu_torch.parallel.sharding_map import (
    TRAIN_STATE_PREFIXES,
    match_axes,
    process_name,
    serve_param_shardings,
    train_state_shardings,
    DEFAULT_RULES,
)
from r2d2_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

torch.set_num_threads(1)

TOL = {"fp32": (1e-4, 1e-5), "bf16": (2e-3, 5e-4)}


def _cpu_mesh(dp, tp=1, fsdp=1):
    return make_mesh(dp, ["cpu"] * (dp * tp * fsdp), tp=tp, fsdp=fsdp)


def _batch_np(cfg, seed=0):
    """The JAX test_learner random_batch's arrays, as numpy."""
    rng = np.random.default_rng(seed)
    B, T, L = cfg.batch_size, cfg.seq_len, cfg.learning_steps
    learn = np.full(B, L, np.int32)
    learn[-1] = L - 1
    fwd = np.full(B, cfg.forward_steps, np.int32)
    fwd[-1] = 1
    return dict(
        obs=rng.integers(0, 255, size=(B, T, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=(B, T)).astype(np.int32),
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=rng.normal(size=(B, 2, cfg.hidden_dim)).astype(np.float32),
        action=rng.integers(0, cfg.action_dim, size=(B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        gamma=np.full((B, L), cfg.gamma ** cfg.forward_steps, np.float32),
        burn_in_steps=np.full(B, cfg.burn_in_steps, np.int32),
        learning_steps=learn, forward_steps=fwd,
        is_weights=rng.uniform(0.3, 1.0, size=B).astype(np.float32))


def _jax_batch(arrs):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _port_batch(arrs, cfg):
    t = {k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}
    for k in ("last_action", "action"):
        t[k] = t[k].long()
    if cfg.state_dtype == torch.bfloat16:
        t["hidden"] = t["hidden"].to(torch.bfloat16)
    return DeviceBatch(**t)


def _port_state(cfg, params):
    nets = []
    for _ in range(2):
        net = R2D2Network.from_config(cfg, device="cpu")
        net.load_state_dict(params_from_flax(params))
        nets.append(net)
    nets[1].requires_grad_(False)
    return TrainState(nets[0], nets[1], make_optimizer(cfg, nets[0].parameters()), 0)


def _assert_params_close(port_net, jax_params, rtol, atol):
    flat_j = jtu.tree_flatten_with_path(jax.tree.map(np.asarray, jax_params))[0]
    flat_t = dict(jtu.tree_flatten_with_path(params_to_flax(port_net))[0])
    for path, v in flat_j:
        np.testing.assert_allclose(flat_t[path], v, rtol=rtol, atol=atol,
                                   err_msg=jtu.keystr(path))


# ------------------------------------------------------------------ the table


def test_pattern_grammar():
    assert process_name("core.wh") == "params.core.wh"
    assert process_name("enc.tail.dense.0.weight", "opt_state.*.*.mu.params") == \
        "opt_state.*.*.mu.params.enc.Dense_0.kernel"
    assert process_name("adv_out.weight.scale") == "params.adv_out.kernel.scale"
    assert match_axes("params.adv_out.kernel.scale", DEFAULT_RULES) == ()
    assert match_axes("params.adv_out.kernel.q8", DEFAULT_RULES) == ("tp", None)
    assert match_axes("params.enc.Conv_0.kernel", DEFAULT_RULES) == ()
    assert flax_leaf("enc.convs.1.weight") == (("enc", "Conv_1", "kernel"), (3, 2, 0, 1))


def _jax_coords(mesh, device):
    return dict(zip(mesh.axis_names, (int(x) for x in np.argwhere(mesh.devices == device)[0])))


@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 2, 2), (1, 1, 4)],
                         ids=["dp2-tp2", "dp2-tp2-fsdp2", "fsdp4"])
def test_splits_match_jax_leaf_by_leaf(layout):
    """Every TrainState leaf: the port's spec is JAX's, and the slice each
    mesh coordinate holds is JAX's addressable shard of that leaf."""
    dp, tp, fsdp = layout
    jcfg = jax_tiny_test()
    _, jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    # moments with content, so the slices are checked on values
    jstate = jstate.replace(opt_state=jax.tree.map(
        lambda x: x + jnp.arange(x.size, dtype=x.dtype).reshape(x.shape)
        if getattr(x, "ndim", 0) and jnp.issubdtype(x.dtype, jnp.floating) else x,
        jstate.opt_state))
    jmesh = jax_make_mesh(dp=dp, tp=tp, fsdp=fsdp, devices=jax.devices()[:dp * tp * fsdp])
    placed = jax.device_put(jstate, jax_state_shardings(jstate, jmesh))
    leaves = {jax_process_name(p): x for p, x in jtu.tree_flatten_with_path(placed)[0]}
    mesh = _cpu_mesh(dp, tp, fsdp)
    assert mesh.axis_names == jmesh.axis_names
    net = R2D2Network.from_config(tiny_test(), device="cpu")
    port = train_state_shardings(net, mesh)
    names = [n for n, _ in net.named_parameters()]
    assert len(port) == 4 * len(names)
    for kind, prefix in TRAIN_STATE_PREFIXES.items():
        for key in names:
            pl = port[f"{kind}.{key}"]
            jarr = leaves[process_name(key, prefix)]
            assert pl.spec == tuple(jarr.sharding.spec) + (None,) * (
                len(pl.spec) - len(tuple(jarr.sharding.spec))), (kind, key)
            _, dims = flax_leaf(key)
            dims = dims or tuple(range(jarr.ndim))
            whole = torch.from_numpy(np.ascontiguousarray(np.transpose(np.array(jarr), dims)))
            for shard in jarr.addressable_shards:
                c = _jax_coords(jmesh, shard.device)
                mine = pl.shard(whole, mesh, **{a: c[a] for a in ("tp", "fsdp") if a in c})
                np.testing.assert_array_equal(
                    mine.numpy(), np.transpose(np.asarray(shard.data), dims), err_msg=key)


def test_int8_serve_tree_follows_kernel_rules():
    cfg = tiny_test()
    net = R2D2Network.from_config(cfg, device="cpu")
    q, n = quantize_tree(net.state_dict())
    assert n > 0
    mesh = _cpu_mesh(2, 2)
    sh = serve_param_shardings(q, mesh)
    jq, _ = jax_quantize_tree(params_to_flax(net))
    jmesh = jax_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    jflat = {jax_process_name(p): tuple(s.spec) for p, s in
             jtu.tree_flatten_with_path(jax_serve_shardings(jq, jmesh))[0]}
    for key, v in sh.items():
        for sub, pl in (v.items() if isinstance(v, dict) else [(None, v)]):
            name = process_name(f"{key}.{sub}" if sub else key)
            want = jflat[name]
            assert pl.spec[:len(want)] == want and not any(pl.spec[len(want):]), name
    assert sh["enc.tail.dense.0.weight"]["q8"].dim("tp") == 0
    assert sh["adv_out.weight"]["q8"].dim("tp") == 1
    assert sh["adv_out.weight"]["scale"].dims == ()


def test_mesh_axes_and_fsdp_scope():
    assert _cpu_mesh(4, 2).axis_names == ("dp", "tp")
    m3 = _cpu_mesh(2, 2, 2)
    assert m3.axis_names == ("dp", "tp", "fsdp") and m3.shape["fsdp"] == 2
    with pytest.raises(ValueError, match="devices"):
        make_mesh(3, ["cpu"] * 8, tp=2, fsdp=2)
    with pytest.raises(ValueError, match="fsdp"):
        make_mesh(8, ["cpu"] * 8, fsdp=0)
    net = R2D2Network.from_config(tiny_test(), device="cpu")
    carriers = [k for k, pl in train_state_shardings(net, m3).items() if pl.dim("fsdp") is not None]
    assert carriers and all(k.startswith(("mu.", "nu.")) for k in carriers)
    assert "mu.core.wh" in carriers
    assert data_shard_devices(m3, ("dp", "fsdp")) == [(0, 0), (0, 1), (1, 0), (1, 1)]


# ----------------------------------------------------------------- the steps


def _jax_setup(jcfg, layout, manual):
    dp, tp, fsdp = layout
    net, state0 = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    mesh = jax_make_mesh(dp=dp, tp=tp, fsdp=fsdp, devices=jax.devices()[:dp * tp * fsdp])
    m_state = jax.device_put(state0, jax_state_shardings(state0, mesh))
    if manual:
        return net, state0, mesh, m_state, jax_manual_step(jcfg, mesh, donate=False)
    return net, state0, mesh, m_state, jax_train_step(jcfg, net, donate=False)


def _jax_placed_batch(mesh, batch, manual):
    if manual:
        sh = manual_batch_sharding(mesh)
        return jax.tree.map(lambda x: jax.device_put(x, sh), batch)
    return type(batch)(*shard_batch(mesh, tuple(batch)))


def _port_step(cfg, layout, manual, params):
    dp, tp, fsdp = layout
    mesh = _cpu_mesh(dp, tp, fsdp)
    state = _port_state(cfg, params)
    shard_optimizer(cfg, state, mesh)
    axes = ("dp", "fsdp") if manual else ("dp",)
    step = make_sharded_train_step(cfg, mesh=mesh, data_axes=axes)
    n = len(data_shard_devices(mesh, axes))

    def run(state, batch):
        state, m, p = step(state, [batch.rows(sl, "cpu") for sl in shard_slices(cfg.batch_size, n)])
        return state, m, p.reshape(-1)

    return state, run


CASES = [
    ("manual-tp2-fsdp2-dp2", dict(tp_size=2, fsdp_size=2, dp_size=2), (2, 2, 2), True),
    ("gspmd-tp2-dp2", dict(tp_size=2, dp_size=2), (2, 2, 1), False),
    ("gspmd-fsdp2-dp4", dict(fsdp_size=2, dp_size=4), (4, 1, 2), False),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_matches_jax(case, precision):
    _, kw, layout, manual = case
    rtol, atol = TOL[precision]
    jcfg = jax_tiny_test().replace(lstm_backend="scan", precision=precision, **kw)
    cfg = tiny_test().replace(precision=precision, **kw)
    assert (cfg.resolved_partitioning == "manual") == manual == (
        jcfg.resolved_partitioning == "manual")
    _, _, jmesh, jstate, jstep = _jax_setup(jcfg, layout, manual)
    arrs = _batch_np(cfg)
    jb = _jax_placed_batch(jmesh, _jax_batch(arrs), manual)
    state, step = _port_step(cfg, layout, manual, jax.tree.map(np.asarray, jstate.params))
    pb = _port_batch(arrs, cfg)
    for _ in range(2):
        jstate, jm, jp = jstep(jstate, jb)
        state, m, p = step(state, pb)
        for k in ("loss", "grad_norm", "q_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, atol=atol, err_msg=k)
        np.testing.assert_allclose(p.float().numpy(), np.asarray(jp), rtol=rtol, atol=atol)
    _assert_params_close(state.net, jstate.params, rtol, atol)
    assert state.step == int(jstate.step) == 2


def test_tp_step_is_the_unsharded_step():
    """Within the port: the manual tp x fsdp step, the tp gspmd step and the
    fsdp step all give the plain single-device step's update."""
    cfg = tiny_test()
    arrs = _batch_np(cfg, seed=3)
    net, base = jax_init_train_state(jax_tiny_test(), jax.random.PRNGKey(2))
    params = jax.tree.map(np.asarray, base.params)
    ref = _port_state(cfg, params)
    ref_step = make_train_step(cfg)
    for _ in range(2):
        ref, rm, rp = ref_step(ref, _port_batch(arrs, cfg))
    for _, kw, layout, manual in CASES:
        c = cfg.replace(**kw)
        state, step = _port_step(c, layout, manual, params)
        for _ in range(2):
            state, m, p = step(state, _port_batch(arrs, c))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(p.numpy(), rp.numpy(), rtol=1e-5, atol=1e-6)
        for a, b in zip(state.net.parameters(), ref.net.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)


def test_zero2_moment_shards_match_jax():
    """fsdp=4 x dp=2, manual: each fsdp member's moment shard is JAX's
    addressable shard of mu / nu (after one update), and the whole moments
    a checkpoint gets are JAX's whole moments."""
    kw = dict(fsdp_size=4, dp_size=2, partitioning="manual")
    jcfg = jax_tiny_test().replace(lstm_backend="scan", **kw)
    cfg = tiny_test().replace(**kw)
    _, _, jmesh, jstate, jstep = _jax_setup(jcfg, (2, 1, 4), True)
    arrs = _batch_np(cfg, seed=5)
    state, step = _port_step(cfg, (2, 1, 4), True, jax.tree.map(np.asarray, jstate.params))
    assert isinstance(state.optimizer, ShardedAdam)
    jstate, _, _ = jstep(jstate, _jax_placed_batch(jmesh, _jax_batch(arrs), True))
    state, _, _ = step(state, _port_batch(arrs, cfg))
    names = [n for n, _ in state.net.named_parameters()]
    i = names.index("core.wh")
    assert state.optimizer.moment_shards()["core.wh"] == [(8, 128)] * 4
    for mom, shards in (("mu", state.optimizer.mu[i]), ("nu", state.optimizer.nu[i])):
        out = getattr(jstate.opt_state[1][0], mom)["params"]["core"]["wh"]
        assert "fsdp" in out.sharding.spec
        for sh in out.addressable_shards:
            f = _jax_coords(jmesh, sh.device)["fsdp"]
            np.testing.assert_allclose(shards[f].numpy(), np.asarray(sh.data), rtol=1e-4,
                                       atol=1e-9)
    sd = state.optimizer.state_dict()
    np.testing.assert_allclose(
        sd["state"][i]["exp_avg"].numpy(),
        np.asarray(jstate.opt_state[1][0].mu["params"]["core"]["wh"]), rtol=1e-4, atol=1e-9)
    assert int(sd["state"][i]["step"]) == 1


def test_resume_roundtrip_across_changed_tp_fsdp_layout(tmp_path):
    """A checkpoint of a tp=2 x fsdp=2 manual run (whole parameters and
    moments) resumes into tp=1 x fsdp=2 x dp=4 and into the one-device
    step, and both go on as the unsharded run that never stopped."""
    cfg_a = tiny_test().replace(tp_size=2, fsdp_size=2, dp_size=2,
                                checkpoint_dir=str(tmp_path))
    arrs = _batch_np(cfg_a, seed=7)
    _, base = jax_init_train_state(jax_tiny_test(), jax.random.PRNGKey(4))
    params = jax.tree.map(np.asarray, base.params)
    ref = _port_state(tiny_test(), params)
    ref_step = make_train_step(tiny_test())
    for _ in range(2):
        ref, _, _ = ref_step(ref, _port_batch(arrs, cfg_a))
    state_a, step_a = _port_step(cfg_a, (2, 2, 2), True, params)
    state_a, _, _ = step_a(state_a, _port_batch(arrs, cfg_a))
    save_checkpoint(str(tmp_path), state_a, 0, 0.0)
    for kw, layout, manual in ((dict(tp_size=1, fsdp_size=2, dp_size=4, partitioning="manual"),
                                (4, 1, 2), True),
                               (dict(tp_size=1, fsdp_size=1, dp_size=1), None, False)):
        cfg_b = cfg_a.replace(**kw)
        template = _port_state(cfg_b, jax.tree.map(np.zeros_like, params))
        if layout is None:
            restored, _, _ = restore_checkpoint(str(tmp_path), template)
            final, _, _ = make_train_step(cfg_b)(restored, _port_batch(arrs, cfg_b))
        else:
            shard_optimizer(cfg_b, template, _cpu_mesh(*layout))
            restored, _, _ = restore_checkpoint(str(tmp_path), template)
            assert isinstance(restored.optimizer, ShardedAdam)
            _, step_b = _port_step(cfg_b, layout, manual, params)
            final, _, _ = step_b(restored, _port_batch(arrs, cfg_b))
        assert final.step == 2
        for a, b in zip(final.net.parameters(), ref.net.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)


def test_trainer_runs_tp_and_fsdp_and_resumes_across_layouts(tmp_path):
    """The Trainer's host plane under manual tp x fsdp and the sharded plane
    under tp (gspmd), through the CLI's --tp / --fsdp, resuming a
    checkpoint written under another layout."""
    from r2d2_tpu_torch import train

    ck = str(tmp_path / "ck")
    base = ["--preset", "tiny_test", "--env", "catch", "--set", f"checkpoint_dir={ck}",
            "--set", "save_interval=2", "--set", "learning_starts=48"]
    train.main(base + ["--device", ",".join(["cpu"] * 8), "--dp", "2", "--tp", "2",
                       "--fsdp", "2", "--steps", "2"])
    train.main(base + ["--device", "cpu,cpu,cpu,cpu", "--replay", "sharded", "--dp", "2",
                       "--tp", "2", "--steps", "4", "--resume"])
    tr = train.Trainer(tiny_test().replace(env_name="catch", checkpoint_dir=ck,
                                           learning_starts=48, fsdp_size=2, dp_size=2),
                       device="cpu,cpu,cpu,cpu", resume=True)
    assert tr.state.step == 4 and isinstance(tr.state.optimizer, ShardedAdam)


@pytest.mark.parametrize("kw", [
    dict(replay_plane="device", tp_size=2, updates_per_dispatch=2),
    dict(replay_plane="device", fsdp_size=2, priority_plane="device",
         updates_per_dispatch=2, superstep_dispatches=2),
    dict(replay_plane="tiered", tp_size=2, updates_per_dispatch=2,
         deterministic_staging=True),
    dict(replay_plane="device", dp_size=2, tp_size=2),
], ids=["device-tp2-K2", "device-fsdp2-superstep", "tiered-tp2-K2", "device-dp2-tp2"])
def test_one_device_planes_run_tp_and_fsdp(tmp_path, kw):
    """The tiered and device planes (one store feeding every shard) run dp,
    the tp group and the fsdp moment shards in their K-update, superstep
    and staged steps, and each run matches the same run at dp = tp = fsdp
    = 1 (float order only)."""
    from r2d2_tpu_torch.train import Trainer

    base = tiny_test().replace(env_name="catch", learning_starts=48, training_steps=8,
                               log_interval=0.0, save_interval=1000,
                               checkpoint_dir=str(tmp_path / "ck"))
    runs = []
    for layout in (kw, {k: v for k, v in kw.items()
                        if k not in ("dp_size", "tp_size", "fsdp_size")}):
        cfg = base.replace(**layout)
        n = cfg.dp_size * cfg.tp_size * cfg.fsdp_size
        tr = Trainer(cfg, device=",".join(["cpu"] * n))
        tr.run_inline()
        assert tr.state.step == 8
        assert (tr.mesh is not None) == (n > 1)
        runs.append(tr)
    a, b = runs
    assert isinstance(a.state.optimizer, ShardedAdam) == (kw.get("fsdp_size", 1) > 1)
    np.testing.assert_allclose(float(a.last_metrics["loss"]), float(b.last_metrics["loss"]),
                               rtol=1e-4, atol=1e-5)
    for x, y in zip(a.state.net.parameters(), b.state.net.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------------- config


CONFIGS = [
    dict(tp_size=2),
    dict(tp_size=2, dp_size=2, replay_plane="sharded"),
    dict(tp_size=2, replay_plane="sharded"),
    dict(tp_size=2, fsdp_size=2),
    dict(tp_size=2, fsdp_size=2, partitioning="gspmd"),
    dict(tp_size=2, fsdp_size=2, replay_plane="sharded", dp_size=2),
    dict(fsdp_size=2),
    dict(fsdp_size=2, replay_plane="sharded", dp_size=2),
    dict(fsdp_size=0),
    dict(fsdp_size=2, replay_plane="multihost"),
    dict(tp_size=2, replay_plane="multihost"),
    dict(partitioning="bogus"),
    dict(partitioning="manual"),
    dict(partitioning="manual", fsdp_size=2, dp_size=3),
    dict(tp_size=3, fsdp_size=2, hidden_dim=32),
    dict(tp_size=2, lstm_backend="pallas"),
    dict(tp_size=2, lstm_backend="scan"),
    dict(priority_plane="device", replay_plane="multihost"),
    dict(priority_plane="device", replay_plane="sharded", dp_size=2),
    dict(collector="device", replay_plane="multihost"),
    dict(collector="device", replay_plane="host"),
    dict(reshard_on_resume=True),
    dict(tp_size=2, replay_plane="device"),
    dict(fsdp_size=2, replay_plane="tiered", updates_per_dispatch=2, training_steps=50),
    dict(tp_size=2, fsdp_size=2, replay_plane="device"),
    dict(dp_size=2, replay_plane="device"),
]


def _valid(factory, kw):
    try:
        factory().replace(**kw)
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_config_valid_in_one_package_exactly_when_in_the_other(kw):
    assert _valid(tiny_test, kw) == _valid(jax_tiny_test, kw), kw
    if _valid(tiny_test, kw):
        a, b = tiny_test().replace(**kw), jax_tiny_test().replace(**kw)
        assert a.resolved_partitioning == b.resolved_partitioning
        assert a.tp_shards_params == b.tp_shards_params


# ------------------------------------------------------------------- serving


def test_server_mesh_places_the_int8_tree_and_serves_as_one_device():
    from r2d2_tpu_torch.serve.server import PolicyServer, ServeConfig

    cfg = tiny_test().replace(serve_quantization="int8")
    scfg = ServeConfig(buckets=(2, 4), cache_capacity=8)
    mesh = _cpu_mesh(1, 2)
    srv = PolicyServer(cfg, scfg, mesh=mesh)
    plain = PolicyServer(cfg, scfg, device="cpu")
    assert srv.quantized_leaves == plain.quantized_leaves > 0
    q8 = srv._published[0]["enc.tail.dense.0.weight"]["q8"]
    assert len(q8.pieces) == 2 and q8.dim == 0
    assert q8.pieces[0].shape[0] == plain._published[0]["enc.tail.dense.0.weight"]["q8"].shape[0] // 2
    got, want = srv.served_params(), plain.served_params()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    with pytest.raises(ValueError, match="not both"):
        PolicyServer(tiny_test(), scfg, device="cpu", mesh=mesh)
