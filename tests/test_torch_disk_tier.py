"""The port's disk tier and block codec (r2d2_tpu_torch/replay/disk_tier.py,
codec.py) and the tiered store's demotion, against the JAX package's: the
codec's bytes are the JAX codec's for every dtype and shape its tests use
(and decode across the two), damage raises CodecError, the demotion victim
and the segment records are JAX's from equal contents and priorities, draws
of disk-resident rows equal the rows that were written, and a snapshot
restores a populated disk tier (and refuses another disk capacity)."""

import numpy as np
import pytest
import torch

from r2d2_tpu.config import R2D2Config as RefConfig
from r2d2_tpu.replay import codec as jcodec
from r2d2_tpu.replay.accumulator import SequenceAccumulator as RefAccumulator
from r2d2_tpu.replay.tiered_store import TieredReplayBuffer as RefTiered
from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay import codec
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.replay.snapshot import restore_replay, save_replay
from r2d2_tpu_torch.replay.tiered_store import TieredReplayBuffer

torch.set_num_threads(1)

SMALL = dict(obs_shape=(3, 3, 1), action_dim=3, hidden_dim=4, burn_in_steps=4,
             learning_steps=4, forward_steps=2, block_length=12, buffer_capacity=48,
             learning_starts=12, batch_size=5)


def small_cfg(cls=R2D2Config, **kw):
    return cls(**{**SMALL, **kw}).validate()


def disk_cfg(path, host_blocks=4, disk_blocks=8, codec_name="delta-zlib", cls=R2D2Config,
             **kw):
    return small_cfg(cls, replay_plane="tiered", buffer_capacity=host_blocks * 12,
                     replay_disk_dir=str(path), replay_disk_capacity=disk_blocks * 12,
                     block_codec=codec_name, **kw)


def make_block(acc_cls, cfg, steps=12, start_step=0, terminal=False, seed=0):
    """A block of sparse frames (a moving bright pixel), as the JAX tests'
    make_block, through either package's accumulator."""
    acc = acc_cls(cfg)
    acc.reset(np.full((3, 3, 1), 7, dtype=np.uint8))
    rng = np.random.default_rng(seed)
    for k in range(steps):
        t = start_step + k
        obs = np.zeros((3, 3, 1), np.uint8)
        obs[t % 3, (t // 3) % 3, 0] = (t + 1) % 256
        acc.add(action=t % 3, reward=float(rng.normal()), next_obs=obs,
                q_value=rng.normal(size=3).astype(np.float32),
                hidden=np.full((2, 4), float(t + 1), dtype=np.float32))
    return acc.finish(last_qval=None if terminal else rng.normal(size=3).astype(np.float32))


def fill(buf, acc_cls, cfg, n, seed0=0, prios=None):
    for i in range(n):
        block, p, ep = make_block(acc_cls, cfg, steps=12, start_step=13 * i,
                                  terminal=(i % 5 == 4), seed=seed0 + i)
        if prios is not None:
            p = np.full_like(p, prios[i])
        buf.add_block(block, p, ep)


# ------------------------------------------------------------------- codec

CODEC_CASES = [
    (np.uint8, (7, 2, 5, 5)), (np.int8, (11,)), (np.uint16, (3, 4)), (np.int32, (6, 2)),
    (np.int64, (5,)), (np.float32, (4, 3)), (np.float64, (2, 2, 2)),
    (np.uint8, (0, 4)), (np.uint8, ()),
]


def _catch_obs():
    rng = np.random.default_rng(2)
    obs = np.zeros((80, 5, 5, 1), np.uint8)
    for t in range(80):
        obs[t, t % 5, rng.integers(0, 5), 0] = 1
        obs[t, 4, rng.integers(0, 5), 0] = 1
    return obs


@pytest.mark.parametrize("dtype,shape", CODEC_CASES)
def test_codec_bytes_are_jaxs_and_decode_across(dtype, shape):
    arr = np.asarray(np.random.default_rng(0).random(shape) * 100).astype(dtype).reshape(shape)
    for name in codec.CODECS:
        ours, theirs = codec.encode_field(arr, name), jcodec.encode_field(arr, name)
        assert ours == theirs
        want, _ = jcodec.decode_field(theirs)  # a 0-d array comes back 1-d in both
        for dec in (codec.decode_field, jcodec.decode_field):
            out, end = dec(theirs)
            assert end == len(theirs) and out.dtype == arr.dtype and out.shape == want.shape
            np.testing.assert_array_equal(out, arr)


@pytest.mark.parametrize("make", [
    lambda: np.random.default_rng(1).integers(0, 256, (40, 1, 84, 84)).astype(np.uint8),
    _catch_obs,
    lambda: np.array([[250], [3], [255], [0], [128]], np.uint8),
])
def test_codec_frames_are_jaxs_bytes(make):
    arr = make()
    enc = codec.encode_field(arr)
    assert enc == jcodec.encode_field(arr)
    assert len(enc) <= codec.encoded_max_len(arr.shape, arr.dtype)
    out, _ = codec.decode_field(enc)
    np.testing.assert_array_equal(out, arr)


def test_catch_frames_compress_3x():
    obs = _catch_obs()
    assert obs.nbytes / len(codec.encode_field(obs)) >= 3.0


def test_codec_damage_raises_codec_error():
    arr = np.arange(24, dtype=np.uint8).reshape(4, 6)
    buf = bytearray(codec.encode_field(arr))
    with pytest.raises(codec.CodecError):
        codec.decode_field(buf[: len(buf) // 2])  # truncated payload
    for pos, value in ((0, 99), (1, 200)):  # unknown method, unknown dtype
        bad = bytearray(buf)
        bad[pos] = value
        with pytest.raises(codec.CodecError):
            codec.decode_field(bad)
    with pytest.raises(codec.CodecError):
        codec.decode_field(buf[:2])  # truncated header
    raw = bytearray(codec.encode_field(np.arange(6, dtype=np.float32), "none"))
    raw[-1:] = b""
    with pytest.raises(codec.CodecError):
        codec.decode_field(raw)
    deflated = bytearray(codec.encode_field(np.zeros((40, 8), np.uint8)))
    deflated[-3] ^= 0xFF
    with pytest.raises(codec.CodecError):
        codec.decode_field(deflated)
    with pytest.raises(codec.CodecError):
        codec.encode_field(np.zeros(3, np.complex64))


# --------------------------------------------------------------- disk tier


def _pair(tmp_path, prios=None, n=10, **kw):
    ours = TieredReplayBuffer(disk_cfg(tmp_path / "port", **kw))
    ref = RefTiered(disk_cfg(tmp_path / "jax", cls=RefConfig, use_native_replay=False, **kw))
    fill(ours, SequenceAccumulator, ours.cfg, n, prios=prios)
    fill(ref, RefAccumulator, ref.cfg, n, prios=prios)
    return ours, ref


def test_demotion_victim_and_records_are_jaxs(tmp_path):
    """Host capacity 4: the oldest block has the highest priority, so the
    victims are picked by priority; every spill lands in the same disk slot
    with the same record bytes as JAX's, and the control planes agree."""
    prios = [100.0, 1.0, 50.0, 60.0, 10.0, 3.0, 70.0, 2.0, 80.0, 5.0]
    ours, ref = _pair(tmp_path, prios=prios)
    assert ours.disk_stats() == ref.disk_stats()
    assert ours.disk_stats()["disk_demotions"] == 6
    for k in ("occupied", "learning_sum", "num_seq_store", "slot_stamp", "obs_store",
              "hidden_store", "burn_in_store"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)
    np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)
    assert (ours._disk_ptr, ours.ptr_advances) == (ref._disk_ptr, ref.ptr_advances)
    for slot in np.nonzero(ours.occupied[ours.cfg.num_blocks:])[0]:
        np.testing.assert_array_equal(ours.disk.record_bytes(int(slot)),
                                      ref.disk.record_bytes(int(slot)))
    # the oldest, highest-priority block is still in the host slab
    block0 = make_block(SequenceAccumulator, ours.cfg, start_step=0, seed=0)[0]
    assert any(np.array_equal(ours.obs_store[i, :13], block0.obs)
               for i in range(ours.cfg.num_blocks))


def test_segment_files_are_jaxs(tmp_path):
    ours, ref = _pair(tmp_path, codec_name="delta-zlib")
    ours.disk.flush()
    ref.disk.flush()
    for k in ours.disk._maps:
        np.testing.assert_array_equal(np.fromfile(ours.disk._segment_path(k), np.uint8),
                                      np.fromfile(ref.disk._segment_path(k), np.uint8))


@pytest.mark.parametrize("codec_name", ["delta-zlib", "none"])
def test_draws_and_writebacks_on_disk_rows_match_jax(tmp_path, codec_name):
    ours, ref = _pair(tmp_path, codec_name=codec_name, host_blocks=2, disk_blocks=10, n=12)
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    drew_disk = False
    for i in range(12):
        sa, sb = ours.sample_window_stack(ra, 2), ref.sample_window_stack(rb, 2)
        for name in ("obs", "last_action", "last_reward", "hidden", "action",
                     "n_step_reward", "gamma", "burn_in_steps", "is_weights", "idxes"):
            np.testing.assert_array_equal(getattr(sa, name), getattr(sb, name), err_msg=name)
        drew_disk |= bool((sa.idxes // ours.cfg.seqs_per_block >= ours.cfg.num_blocks).any())
        td = np.random.default_rng(i).random(sa.idxes.shape).astype(np.float32)
        for row, idx in zip(td, sa.idxes):
            ours.update_priorities(idx, row, sa.old_ptr, sa.old_advances)
            ref.update_priorities(idx, row, sb.old_ptr, sb.old_advances)
    assert drew_disk
    np.testing.assert_array_equal(ours.tree.tree, ref.tree.tree)


def test_disk_resident_rows_are_the_rows_written(tmp_path):
    """A store that demoted draws the same windows as one large enough to
    never demote, for the draws that land on disk-resident blocks: the
    big store holds those blocks at the slots they were written to."""
    cfg = disk_cfg(tmp_path, host_blocks=2, disk_blocks=10)
    buf = TieredReplayBuffer(cfg)
    fill(buf, SequenceAccumulator, cfg, 12)
    written = [make_block(SequenceAccumulator, cfg, start_step=13 * i, terminal=(i % 5 == 4),
                          seed=i)[0] for i in range(12)]
    rng = np.random.default_rng(3)
    checked = 0
    nb, S, L = cfg.num_blocks, cfg.seqs_per_block, cfg.learning_steps
    for _ in range(10):
        sw = buf.sample_window_stack(rng, 2)
        for k in range(2):
            for i, idx in enumerate(sw.idxes[k]):
                blk, s = divmod(int(idx), S)
                if blk < nb:
                    continue
                rec = buf._disk_record(blk - nb)
                # which written block it is: its records are verbatim copies
                match = [j for j, w in enumerate(written)
                         if np.array_equal(rec["obs"][: len(w.obs)], w.obs)]
                assert len(match) == 1
                w = written[match[0]]
                start = int(w.burn_in_steps[0]) + s * L - int(w.burn_in_steps[s])
                rows = np.clip(start + np.arange(cfg.seq_len), 0, cfg.block_slot_len - 1)
                slab = np.zeros((cfg.block_slot_len, *cfg.obs_shape), np.uint8)
                slab[: len(w.obs)] = w.obs
                np.testing.assert_array_equal(sw.obs[k, i], slab[rows])
                np.testing.assert_array_equal(sw.action[k, i],
                                              np.pad(w.action, (0, 12 - len(w.action)))[
                                                  np.clip(s * L + np.arange(L), 0, 11)])
                checked += 1
    assert checked > 0


def test_stale_writeback_to_a_demoted_slot_is_dropped(tmp_path):
    cfg = disk_cfg(tmp_path)
    buf = TieredReplayBuffer(cfg)
    fill(buf, SequenceAccumulator, cfg, 10)
    sw = buf.sample_window_stack(np.random.default_rng(7), 1)
    idxes = sw.idxes[0]
    before = buf.tree.priorities_of(idxes).copy()
    buf.update_priorities(idxes, np.full(idxes.shape, 9.5, np.float32), sw.old_ptr,
                          sw.old_advances)
    assert not np.allclose(before, buf.tree.priorities_of(idxes))
    old_ptr, old_adv = buf.block_ptr, buf.ptr_advances
    fill(buf, SequenceAccumulator, cfg, 13, seed0=50)  # every slot mutates
    tree = buf.tree.tree.copy()
    buf.update_priorities(idxes, np.full(idxes.shape, 77.0, np.float32), old_ptr, old_adv)
    np.testing.assert_array_equal(buf.tree.tree, tree)


def test_snapshot_restores_a_populated_disk_tier(tmp_path):
    cfg = disk_cfg(tmp_path / "a")
    buf = TieredReplayBuffer(cfg)
    fill(buf, SequenceAccumulator, cfg, 10)
    path = str(tmp_path / "snap.npz")
    save_replay(buf, path)
    fresh = TieredReplayBuffer(cfg.replace(replay_disk_dir=str(tmp_path / "b")))
    restore_replay(fresh, path)
    np.testing.assert_array_equal(fresh.tree.tree, buf.tree.tree)
    np.testing.assert_array_equal(fresh.occupied, buf.occupied)
    np.testing.assert_array_equal(fresh.slot_stamp, buf.slot_stamp)
    assert fresh._disk_ptr == buf._disk_ptr
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(4):
        sa, sb = buf.sample_window_stack(ra, 2), fresh.sample_window_stack(rb, 2)
        for name in ("obs", "action", "idxes", "is_weights"):
            np.testing.assert_array_equal(getattr(sa, name), getattr(sb, name))


def test_snapshot_refuses_another_disk_capacity(tmp_path):
    cfg = disk_cfg(tmp_path / "a")
    buf = TieredReplayBuffer(cfg)
    fill(buf, SequenceAccumulator, cfg, 10)
    path = str(tmp_path / "snap.npz")
    save_replay(buf, path)
    other = TieredReplayBuffer(disk_cfg(tmp_path / "o", disk_blocks=4))
    tree = other.tree.tree.copy()
    with pytest.raises(ValueError):
        restore_replay(other, path)
    np.testing.assert_array_equal(other.tree.tree, tree)


def test_disk_config_is_validated_as_jax_validates():
    for kw in (dict(replay_disk_capacity=12), dict(replay_disk_capacity=13, replay_disk_dir="d",
                                                   replay_plane="tiered"),
               dict(replay_disk_capacity=12, replay_disk_dir="d"),
               dict(block_codec="lz4"), dict(replay_disk_capacity=-1)):
        with pytest.raises(ValueError) as ours:
            small_cfg(**kw)
        with pytest.raises(ValueError) as theirs:
            small_cfg(RefConfig, **kw)
        assert str(ours.value) == str(theirs.value)
