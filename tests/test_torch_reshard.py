"""The port's elastic resume (r2d2_tpu_torch/replay/reshard.py and
Trainer.reshard_live), mirroring tests/test_reshard.py and
test_autoscale.py's reshard_live cases, and held against the JAX package's
reshard_replay on the same snapshot files.

A filled dp=4 sharded replay is snapshotted; every plane-family move keeps
its content fingerprint (global counters, tree mass, the multiset of block
sums); the exact path is a plain restore bit for bit (the device tree
included); a gather fault leaves nothing mutated and the retry succeeds;
the CLI exits 0 or 2. Across packages, each package's reshard of the
other's (and its own) files gives the same stores, tree leaves, counters
and kept extras keys, for the exact path, dp 2 -> 1, dp 1 -> 2, device ->
host and a capacity shrink. reshard_live leaves the state a fresh resume
through --reshard restores, bit for bit, and an exact-layout reshard_live
trains on as the run that never resharded.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from bench import synth_block as jax_synth_block
from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu.replay.device_store import DeviceReplayBuffer as JaxDevice
from r2d2_tpu.replay.replay_buffer import ReplayBuffer as JaxHost
from r2d2_tpu.replay.reshard import reshard_replay as jax_reshard
from r2d2_tpu.replay.sharded_store import ShardedDeviceReplay as JaxSharded
from r2d2_tpu.replay.snapshot import save_replay as jax_save
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.parallel.mesh import make_mesh, slab_partition_map
from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
from r2d2_tpu_torch.replay.reshard import (
    gather_logical,
    main as reshard_main,
    reshard_replay,
    snapshot_paths,
)
from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
from r2d2_tpu_torch.replay.snapshot import (
    STORE_FIELDS,
    TopologyMismatch,
    read_manifest,
    restore_replay,
    save_replay,
)
from r2d2_tpu_torch.utils.faults import FaultPlane, InjectedFault, install, uninstall
from torch_multihost_child import synth_block

torch.set_num_threads(1)

NB = 40  # tiny_test: buffer_capacity 640 / block_length 16
EXTRA = {"carry_step": np.int64(7), "pend_idxes": np.arange(3), "actor_x": np.ones(2)}


def _cfg(**kw):
    return tiny_test().replace(use_native_replay=False, **kw)


def _jcfg(**kw):
    return jax_tiny_test().replace(use_native_replay=False, **kw)


def _sharded(cfg, dp):
    return ShardedDeviceReplay(cfg, make_mesh(dp, ["cpu"] * dp))


def _fill(cfg, replay, n=10, seed=0, synth=synth_block):
    rng = np.random.default_rng(seed)
    for i in range(n):
        block = synth(cfg, rng)
        prios = rng.random(cfg.seqs_per_block).astype(np.float32) + 0.5
        replay.add_block(block, prios, float(i) if i % 3 == 0 else None)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t)


def _planes(replay):
    """(control planes, per-shard store dicts of numpy) of either package's
    host, device or sharded replay."""
    if hasattr(replay, "shards"):
        if isinstance(replay.stores, dict):  # the JAX package's global arrays
            bps = replay.blocks_per_shard
            stores = [{k: np.asarray(v)[i * bps:(i + 1) * bps] for k, v in replay.stores.items()}
                      for i in range(replay.dp)]
        else:
            stores = [{k: _np(v) for k, v in st.items()} for st in replay.stores]
        return list(replay.shards), stores
    if hasattr(replay, "stores"):
        return [replay], [{k: _np(v) for k, v in replay.stores.items()}]
    return [replay], [{k: np.asarray(getattr(replay, k + "_store")) for k in STORE_FIELDS}]


_COUNTERS = ("block_ptr", "size", "env_steps", "num_episodes", "episode_reward_sum",
             "total_episodes", "total_reward_sum", "ptr_advances")


def _assert_same_replay(a, b):
    pa, sa = _planes(a)
    pb, sb = _planes(b)
    assert len(pa) == len(pb)
    for x, y, stx, sty in zip(pa, pb, sa, sb):
        np.testing.assert_array_equal(x.tree.leaves(), y.tree.leaves())
        for k in _COUNTERS:
            assert getattr(x, k) == getattr(y, k), k
        for k in ("learning_sum", "occupied", "num_seq_store"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
        for k in STORE_FIELDS:
            np.testing.assert_array_equal(stx[k], sty[k], err_msg=k)


def _fingerprint(replay):
    """Layout-free content: global counters, tree mass, the multiset of the
    occupied blocks' obs sums."""
    planes, stores = _planes(replay)
    sums, mass = [], 0.0
    for p, st in zip(planes, stores):
        mass += float(p.tree.leaves().sum())
        sums += [int(st["obs"][s].astype(np.int64).sum()) for s in range(len(p.occupied))
                 if p.occupied[s]]
    return (sum(p.env_steps for p in planes), sum(p.size for p in planes),
            sum(p.num_episodes for p in planes),
            round(sum(float(p.episode_reward_sum) for p in planes), 4), round(mass, 4),
            sorted(sums))


@pytest.fixture(scope="module")
def saved_sharded(tmp_path_factory):
    """A filled dp=4 sharded replay snapshotted to disk, and its
    fingerprint."""
    cfg = _cfg()
    replay = _sharded(cfg, 4)
    _fill(cfg, replay)
    d = tmp_path_factory.mktemp("sharded4")
    save_replay(replay, str(d / "replay_snapshot.npz"), extra=EXTRA)
    return cfg, str(d), _fingerprint(replay)


def test_manifest_contents(saved_sharded):
    cfg, d, _ = saved_sharded
    m = read_manifest(os.path.join(d, "replay_snapshot.npz"))
    assert m["plane"] == "sharded"
    assert m["dp"] == 4 and m["tp"] == 1 and m["process_count"] == 1
    assert m["num_blocks"] == NB and m["blocks_per_shard"] == NB // 4
    assert m["seqs_per_block"] == cfg.seqs_per_block
    assert m["local_ids"] == [0, 1, 2, 3]
    pmap = slab_partition_map(make_mesh(4, ["cpu"] * 4), NB)
    assert m["slab_ranges"] == [list(pmap[g]) for g in range(4)]


def test_topology_mismatch_is_structured(saved_sharded):
    cfg, d, _ = saved_sharded
    with pytest.raises(TopologyMismatch) as ei:
        restore_replay(DeviceReplayBuffer(cfg, "cpu"), os.path.join(d, "replay_snapshot.npz"))
    e = ei.value
    assert e.saved["plane"] == "sharded" and e.saved["dp"] == 4
    assert e.current["plane"] == "device" and e.current["dp"] == 1
    assert "--reshard" in str(e)
    with pytest.raises(TopologyMismatch) as ei:
        restore_replay(_sharded(cfg, 2), os.path.join(d, "replay_snapshot.npz"))
    assert ei.value.saved["dp"] == 4 and ei.value.current["dp"] == 2


def test_reshard_moves_keep_the_fingerprint(saved_sharded, tmp_path):
    """sharded dp4 -> device -> sharded dp2 -> host: every move keeps the
    content; the layout-free carry survives, the layout-bound is dropped;
    the host plane keeps uint8 actions."""
    cfg, d, fp = saved_sharded
    dev = DeviceReplayBuffer(cfg, "cpu")
    extras = reshard_replay(dev, snapshot_paths(d))
    assert _fingerprint(dev) == fp
    assert int(extras["carry_step"]) == 7
    assert not any(k.startswith(("pend_", "actor_")) for k in extras)
    dev.sample_indices(np.random.default_rng(0))
    save_replay(dev, str(tmp_path / "replay_snapshot.npz"))
    sh2 = _sharded(cfg, 2)
    reshard_replay(sh2, snapshot_paths(str(tmp_path)))
    assert _fingerprint(sh2) == fp
    sh2.sample_indices(np.random.default_rng(0))
    host = ReplayBuffer(cfg)
    reshard_replay(host, snapshot_paths(str(tmp_path)))
    assert _fingerprint(host) == fp
    assert host.action_store.dtype == np.uint8 and host.last_action_store.dtype == np.uint8
    np.testing.assert_array_equal(host.action_store, dev.stores["action"].numpy())


def test_exact_path_matches_plain_restore(saved_sharded):
    cfg, d, _ = saved_sharded
    path = os.path.join(d, "replay_snapshot.npz")
    a, b = _sharded(cfg, 4), _sharded(cfg, 4)
    reshard_replay(a, [path])
    restore_replay(b, path)
    _assert_same_replay(a, b)
    ra = a.sample_indices(np.random.default_rng(5))
    rb = b.sample_indices(np.random.default_rng(5))
    np.testing.assert_array_equal(ra.idxes, rb.idxes)
    np.testing.assert_array_equal(ra.is_weights, rb.is_weights)


def test_device_trees_carry_and_seed(tmp_path):
    """priority_plane="device": the exact path carries each shard's device
    tree bit for bit; a re-deal deals the float32 leaves with their
    blocks."""
    cfg = _cfg(priority_plane="device", replay_plane="sharded", dp_size=2)
    src = _sharded(cfg, 2)
    _fill(cfg, src)
    for sh in src.shards:  # device-tree leaves the host tree does not hold
        sh.dtree.update(np.arange(4), np.full(4, 3.0, np.float32))
    save_replay(src, str(tmp_path / "replay_snapshot.npz"))
    same = _sharded(cfg, 2)
    reshard_replay(same, snapshot_paths(str(tmp_path)))
    assert torch.equal(same.dtree_stack, src.dtree_stack)
    dev = DeviceReplayBuffer(cfg.replace(replay_plane="device", dp_size=1), "cpu")
    reshard_replay(dev, snapshot_paths(str(tmp_path)))
    assert np.isclose(dev.dtree.total, sum(sh.dtree.total for sh in src.shards), rtol=1e-6)
    assert sorted(dev.dtree.leaves()[dev.dtree.leaves() > 0].tolist()) == sorted(
        np.concatenate([sh.dtree.leaves() for sh in src.shards]).tolist()[i]
        for i in np.flatnonzero(np.concatenate([sh.dtree.leaves() for sh in src.shards]) > 0))


def test_gather_is_retry_safe(saved_sharded):
    cfg, d, fp = saved_sharded
    plane = install(FaultPlane(schedule={"reshard.gather": {1: "error"},
                                         "reshard.scatter": {1: "error"}}))
    try:
        dev = DeviceReplayBuffer(cfg, "cpu")
        with pytest.raises(InjectedFault):
            reshard_replay(dev, snapshot_paths(d))
        assert dev.size == 0 and not dev.occupied.any()
        with pytest.raises(InjectedFault):
            reshard_replay(dev, snapshot_paths(d))  # the scatter's turn
        assert dev.size == 0 and not dev.occupied.any()
        reshard_replay(dev, snapshot_paths(d))
        assert _fingerprint(dev) == fp
    finally:
        uninstall()
    assert ("reshard.gather", 1, "error") in plane.fired
    assert ("reshard.scatter", 1, "error") in plane.fired


def test_manifest_cli(saved_sharded, tmp_path, capsys):
    cfg, d, _ = saved_sharded
    assert reshard_main([d]) == 0
    (m,) = json.loads(capsys.readouterr().out)["manifests"].values()
    assert m["plane"] == "sharded" and m["dp"] == 4
    assert reshard_main([d, "--expect-dp", "4", "--expect-process-count", "1"]) == 0
    capsys.readouterr()
    assert reshard_main([d, "--expect-dp", "2"]) == 2
    err = capsys.readouterr().err
    assert "dp=4" in err and "expected 2" in err
    assert reshard_main([str(tmp_path), "--expect-dp", "8"]) == 0


def test_gather_rejects_duplicate_shards(saved_sharded):
    _, d, _ = saved_sharded
    path = os.path.join(d, "replay_snapshot.npz")
    with pytest.raises(ValueError, match="more than one"):
        gather_logical([path, path])


def test_capacity_shrink_drops_oldest(saved_sharded):
    cfg, d, fp = saved_sharded
    small = dataclasses.replace(cfg, buffer_capacity=cfg.block_length * 8)
    dev = DeviceReplayBuffer(small, "cpu")
    reshard_replay(dev, snapshot_paths(d))
    assert int(dev.occupied.sum()) == 8
    assert dev.env_steps == fp[0] and dev.num_episodes == fp[2]


# ------------------------------------------------------- against the JAX package


def _port_dest(kind, cfg):
    if kind == "sharded4":
        return _sharded(cfg.replace(replay_plane="sharded", dp_size=4), 4)
    if kind == "sharded2":
        return _sharded(cfg.replace(replay_plane="sharded", dp_size=2), 2)
    if kind == "device":
        return DeviceReplayBuffer(cfg, "cpu")
    return ReplayBuffer(cfg)


def _jax_dest(kind, jcfg):
    if kind == "sharded4":
        return JaxSharded(jcfg.replace(replay_plane="sharded", dp_size=4),
                          jax_make_mesh(dp=4, tp=1, devices=jax.devices()[:4]))
    if kind == "sharded2":
        return JaxSharded(jcfg.replace(replay_plane="sharded", dp_size=2),
                          jax_make_mesh(dp=2, tp=1, devices=jax.devices()[:2]))
    if kind == "device":
        return JaxDevice(jcfg)
    return JaxHost(jcfg)


# (source layout, destination layout, destination capacity in blocks)
MOVES = [
    ("sharded4", "sharded4", NB),  # the exact path
    ("sharded2", "device", NB),    # dp 2 -> 1
    ("device", "sharded2", NB),    # dp 1 -> 2
    ("device", "host", NB),        # across the plane families
    ("sharded4", "device", 8),     # a capacity shrink
]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """The same blocks in each package's replay of each source layout,
    snapshotted: {(writer, layout): dir}."""
    out = {}
    for layout in ("sharded4", "sharded2", "device"):
        for writer in ("jax", "port"):
            d = tmp_path_factory.mktemp(f"{writer}_{layout}")
            if writer == "port":
                cfg = _cfg()
                r = _port_dest(layout, cfg)
                _fill(cfg, r, n=14, seed=3)
                save_replay(r, str(d / "replay_snapshot.npz"), extra=EXTRA)
            else:
                jcfg = _jcfg()
                r = _jax_dest(layout, jcfg)
                _fill(jcfg, r, n=14, seed=3, synth=jax_synth_block)
                jax_save(r, str(d / "replay_snapshot.npz"), extra=EXTRA)
            out[(writer, layout)] = str(d)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"], ids=["jax-written", "port-written"])
@pytest.mark.parametrize("move", MOVES, ids=lambda m: f"{m[0]}-to-{m[1]}-{m[2]}")
def test_reshard_equals_jax_on_the_same_files(snapshots, writer, move):
    src, dst, blocks = move
    paths = snapshot_paths(snapshots[(writer, src)])
    cap = blocks * 16
    port = _port_dest(dst, _cfg(buffer_capacity=cap))
    ref = _jax_dest(dst, _jcfg(buffer_capacity=cap))
    kept = reshard_replay(port, paths)
    jkept = jax_reshard(ref, paths)
    _assert_same_replay(port, ref)
    assert sorted(kept) == sorted(jkept) == ["carry_step"]


# ------------------------------------------------------------- reshard_live


def _live_cfg(tmp_path, sub, **kw):
    return _cfg(**{**dict(env_name="catch", checkpoint_dir=str(tmp_path / sub),
                          snapshot_replay=True, training_steps=4, save_interval=2,
                          learning_starts=48), **kw})


def test_reshard_live_is_bit_exact(tmp_path):
    """reshard_live(dp_size=1) from the sharded dp=2 plane leaves the replay
    and the learner state that a fresh Trainer resuming the same checkpoint
    through --reshard restores, bit for bit; at an unchanged layout (the
    exact path) training goes on as a run that never resharded."""
    from r2d2_tpu_torch.train import Trainer

    sharded = dict(replay_plane="sharded", dp_size=2)
    a = Trainer(_live_cfg(tmp_path, "a", **sharded), device="cpu,cpu")
    a.run_inline()
    info = a.reshard_live(dp_size=1, replay_plane="device")
    assert info["replay_size"] == info["replay_size_before"]
    assert info["env_steps"] == info["env_steps_before"]
    assert info["bytes"] > 0
    b = Trainer(_live_cfg(tmp_path, "a", replay_plane="device", reshard_on_resume=True),
                device="cpu", resume=True)
    assert b.state.step == a.state.step == 4
    _assert_same_replay(a.replay, b.replay)
    for x, y in zip(a.state.net.parameters(), b.state.net.parameters()):
        assert torch.equal(x, y)
    for sa, sb in zip(a.state.optimizer.state.values(), b.state.optimizer.state.values()):
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k

    c = Trainer(_live_cfg(tmp_path, "c", **sharded), device="cpu,cpu")
    c.run_inline()
    c.reshard_live(dp_size=2)
    c.cfg = c.cfg.replace(training_steps=6)
    c.run_inline()
    d = Trainer(_live_cfg(tmp_path, "d", **sharded).replace(training_steps=6),
                device="cpu,cpu")
    d.run_inline()
    assert c.state.step == d.state.step == 6
    for x, y in zip(c.state.net.parameters(), d.state.net.parameters()):
        assert torch.equal(x, y)
    _assert_same_replay(c.replay, d.replay)


def test_reshard_live_rejects_bad_inputs(tmp_path):
    from r2d2_tpu_torch.train import Trainer

    t = Trainer(_live_cfg(tmp_path, "e", training_steps=1), device="cpu")
    with pytest.raises(ValueError, match="reshard_live accepts"):
        t.reshard_live(hidden_dim=128)
    with pytest.raises(NotImplementedError, match="single-process"):
        t.reshard_live(replay_plane="multihost")
