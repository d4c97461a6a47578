"""The port's dp mesh and config (r2d2_tpu_torch/parallel, config.py,
replay/control_plane.shard_config) against the JAX package's: make_mesh,
slab_partition_map, local_axis_indices and local_slab_ranges on the same
layouts, shard_config field by field, the new validations raising where
JAX's raise, the atari_v4_8 preset and the backward arm budgeted per
shard; initialize_distributed is a no-op in one process, and the CLI's
device list."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import PRESETS as JAX_PRESETS
from r2d2_tpu.config import apply_model_preset as jax_apply_model_preset
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.parallel.mesh import slab_partition_map as jax_slab_partition_map
from r2d2_tpu.parallel.multihost import local_axis_indices as jax_local_axis_indices
from r2d2_tpu.replay.control_plane import shard_config as jax_shard_config
from r2d2_tpu_torch import parallel
from r2d2_tpu_torch.config import PRESETS, apply_model_preset, tiny_test
from r2d2_tpu_torch.parallel import multihost
from r2d2_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_devices, slab_partition_map
from r2d2_tpu_torch.replay.control_plane import shard_config
from r2d2_tpu_torch.train import build_mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_mesh_and_slab_map_match_jax(dp):
    mesh = make_mesh(dp, ["cpu"] * dp)
    jmesh = jax_make_mesh(dp=dp, tp=1, devices=jax.devices()[:dp])
    assert mesh.shape["dp"] == jmesh.shape["dp"] == dp
    assert mesh.devices == (torch.device("cpu"),) * dp and mesh.processes == (0,) * dp
    for nb in (8, 40, 5000):
        if nb % dp:
            with pytest.raises(ValueError):
                slab_partition_map(mesh, nb)
            with pytest.raises(ValueError):
                jax_slab_partition_map(jmesh, nb)
            continue
        assert slab_partition_map(mesh, nb) == jax_slab_partition_map(jmesh, nb)
    assert multihost.local_axis_indices(mesh) == jax_local_axis_indices(jmesh, "dp")
    assert multihost.local_slab_ranges(mesh, 8 * dp) == {
        g: (g * 8, (g + 1) * 8) for g in range(dp)}


def test_mesh_refusals():
    with pytest.raises(ValueError):
        make_mesh(3, ["cpu"] * 2)  # dp != the devices listed
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh(4)  # cuda:0 .. cuda:3 on a machine with fewer cards
    assert parse_devices("cuda:0,cuda:0") == [torch.device("cuda:0")] * 2
    assert parse_devices(torch.device("cpu")) == [torch.device("cpu")]


@pytest.mark.parametrize("owners", [(0, 0, 1, 1), (0, 1), (0, 0, 0, 0, 1, 1, 1, 1)])
def test_local_shards_of_a_process_match_jax(monkeypatch, owners):
    """A mesh spread over processes: each process owns the shards of its
    devices, as JAX's local_axis_indices finds them on its device array."""
    mesh = Mesh(devices=(torch.device("cpu"),) * len(owners), processes=owners)

    class FakeDev:
        def __init__(self, pid):
            self.process_index = pid

    class FakeMesh:
        devices = np.array([[FakeDev(p)] for p in owners], dtype=object)
        axis_names = ("dp", "tp")

    for pid in sorted(set(owners)):
        monkeypatch.setattr(multihost, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        got = multihost.local_axis_indices(mesh)
        assert got == jax_local_axis_indices(FakeMesh(), "dp")
        nb = 4 * len(owners)
        assert multihost.local_slab_ranges(mesh, nb) == {
            g: (4 * g, 4 * g + 4) for g in got}


def test_initialize_distributed_is_a_noop_in_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize_distributed() is False
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    mesh = multihost.make_global_mesh(["cpu", "cpu"])
    assert mesh.dp == 2 and multihost.local_axis_indices(mesh) == [0, 1]
    with pytest.raises(ValueError):
        multihost.make_global_mesh(["cpu", "cpu"], dp=4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        multihost.initialize_distributed()
    coll = multihost.Collectives()
    t = torch.ones(3)
    assert coll.sum_(t) is t and coll.sum_int(5) == 5 and coll.any(True)


@pytest.mark.parametrize("dp", [2, 4])
def test_shard_config_matches_jax_field_by_field(dp):
    kw = dict(buffer_capacity=640, learning_starts=100, batch_size=8, dp_size=dp,
              replay_plane="sharded", updates_per_dispatch=2, training_steps=50 * 2)
    cfg, jcfg = tiny_test().replace(**kw), jax_tiny_test().replace(**kw)
    got, want = shard_config(cfg, dp), jax_shard_config(jcfg, dp)
    shared = {f.name for f in dataclasses.fields(got)} & {f.name for f in dataclasses.fields(want)}
    assert len(shared) > 60
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
    assert (got.buffer_capacity, got.batch_size, got.dp_size) == (640 // dp, 8 // dp, 1)


REFUSED_BY_BOTH = [
    dict(replay_plane="sharded"),  # dp_size 1: no mesh
    dict(replay_plane="sharded", dp_size=3),  # 40 blocks over 3
    dict(replay_plane="sharded", dp_size=8, batch_size=12),  # batch over 8
    dict(updates_per_dispatch=2, training_steps=50 * 2),  # the host plane
    dict(replay_plane="shareded"),
    dict(priority_plane="device", replay_plane="multihost", dp_size=2),
    dict(collector="device", replay_plane="host"),
]


@pytest.mark.parametrize("kw", REFUSED_BY_BOTH, ids=lambda kw: ",".join(kw))
def test_validation_raises_where_jax_raises(kw):
    with pytest.raises(ValueError):
        jax_tiny_test().replace(**kw)
    with pytest.raises(ValueError):
        tiny_test().replace(**kw)


ACCEPTED_BY_BOTH = [
    dict(replay_plane="sharded", dp_size=2),
    dict(replay_plane="sharded", dp_size=4, updates_per_dispatch=2, training_steps=100),
    dict(replay_plane="multihost"),
    dict(replay_plane="multihost", dp_size=4, updates_per_dispatch=5),
    dict(dp_size=2),
]


@pytest.mark.parametrize("kw", ACCEPTED_BY_BOTH, ids=lambda kw: ",".join(kw))
def test_validation_accepts_what_jax_accepts(kw):
    assert jax_tiny_test().replace(**kw).replay_plane == tiny_test().replace(**kw).replay_plane


@pytest.mark.parametrize("kw", [
    dict(replay_plane="sharded", dp_size=2, priority_plane="device"),
    dict(replay_plane="sharded", dp_size=2, collector="device"),
    dict(replay_plane="multihost", collector="device"),
], ids=["sharded-device-tree", "sharded-device-collector", "multihost-device-collector"])
def test_sharded_superstep_and_fused_runner_configs_are_accepted_as_jax_accepts_them(kw):
    # ported: the port takes these configs as the JAX package does
    assert tiny_test().replace(**kw).replay_plane == jax_tiny_test().replace(**kw).replay_plane


def test_atari_v4_8_preset_matches_jax_and_its_arm_is_budgeted_per_shard():
    cfg, jcfg = PRESETS["atari_v4_8"](), JAX_PRESETS["atari_v4_8"]()
    for name in ("num_actors", "dp_size", "batch_size", "compute_dtype", "replay_plane",
                 "buffer_capacity", "hidden_dim", "seq_len", "encoder", "obs_shape"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.dp_size, cfg.replay_plane, cfg.batch_size) == (4, "sharded", 64)
    assert cfg.resolve_backward_arm(device="cuda") == ("default", 0)
    # the wide model at 384 rows: 96 a shard, where bf16 takes the fused arm
    for dp, batch in ((4, 384), (1, 96), (1, 384), (2, 384)):
        kw = dict(batch_size=batch, dp_size=dp, lstm_backend="pallas",
                  replay_plane="sharded" if dp > 1 else "host")
        got = apply_model_preset(PRESETS["atari_v4_8"](), "wide").replace(**kw)
        want = jax_apply_model_preset(JAX_PRESETS["atari_v4_8"](), "wide").replace(**kw)
        assert got.resolve_backward_arm(device="cuda") == want.resolve_backward_arm(), (dp, batch)
    assert apply_model_preset(PRESETS["atari_v4_8"](), "wide").replace(
        batch_size=384).resolve_backward_arm(device="cuda") == ("fused_dwh", 0)


def test_build_mesh_takes_a_device_list_and_refuses_what_it_cannot_hold(monkeypatch):
    cfg = PRESETS["atari_v4_8"]().replace(env_name="catch")
    mesh = build_mesh(cfg, "cpu,cpu,cpu,cpu")
    assert mesh.dp == 4 and set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="list them"):
        build_mesh(cfg, "cpu")
    with pytest.raises(ValueError):
        build_mesh(cfg, "cpu,cpu")  # 2 devices for dp 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        build_mesh(cfg, "cuda")  # one card for four shards
    assert build_mesh(tiny_test(), "cpu") is None
    assert build_mesh(tiny_test().replace(replay_plane="multihost"), "cpu,cpu").dp == 2
    assert parallel.make_mesh is make_mesh
