"""The port's live loop (r2d2_tpu_torch/liveloop) on the CPU, as
tests/test_liveloop.py holds the JAX package's: tiny_test shapes.

- against the JAX package: the port's TransitionTap and JAX's, fed the same
  served batches, emit the same blocks bit for bit (priorities to 1e-6)
  with the same stamps; JAX's `carry_state` restored into the port's tap
  goes on as JAX's would; the EpsilonAssigner gives every session JAX's
  epsilon;
- the tap against an offline SequenceAccumulator fed the same stream:
  cuts, resets, interleaved sessions, eviction and drop seams, snapshot and
  resume bit for bit; the bridge's drop-oldest backpressure and its
  `add_block` fallback;
- on a live server (pipelined and serial, and a two-replica fleet): the
  tap's blocks equal an offline accumulator's fed the recorded served
  stream, carries and stamps included; epsilon None and 0 serve the same
  bits; the fault sites; a `slow` end-to-end run whose served return
  improves as the loop trains on it.
"""

from __future__ import annotations

import io
import time

import numpy as np
import pytest
import torch

from r2d2_tpu.config import tiny_test as jax_tiny_test
from r2d2_tpu.liveloop import EpsilonAssigner as JaxEpsilonAssigner
from r2d2_tpu.liveloop import TransitionTap as JaxTransitionTap
from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.liveloop import (
    EpsilonAssigner,
    IngestBridge,
    LiveLoopPlane,
    TransitionTap,
    gather_carry_rows,
)
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator
from r2d2_tpu_torch.serve import LocalClient, MultiDeviceServer, PolicyServer, ServeConfig
from r2d2_tpu_torch.utils import faults
from tests.test_torch_serve import SessionReference
from torch_liveloop_catch import run_liveloop_catch

torch.set_num_threads(1)

CFG = tiny_test()

BLOCK_FIELDS = ("obs", "last_action", "last_reward", "action", "n_step_reward", "gamma",
                "hidden", "burn_in_steps", "learning_steps", "forward_steps")


def _stream(cfg, T, seed=0, resets=()):
    """A synthetic served stream of one session: row t holds request t's
    facts (obs_t, reward_{t-1}, reset_t) and what the step gave (action_t,
    q_t, the new carry), with its epsilon and params version."""
    rng = np.random.default_rng(seed)
    A, H = cfg.action_dim, cfg.hidden_dim
    return [dict(obs=rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8),
                 action=int(rng.integers(A)), q=rng.normal(size=A).astype(np.float32),
                 reward=float(np.float32(rng.normal())), reset=t in resets,
                 eps=float(rng.random() * 0.4), h=rng.normal(size=H).astype(np.float32),
                 c=rng.normal(size=H).astype(np.float32), version=t // 7)
            for t in range(T)]


def _feed(tap, rows, sid="s0", slot=1, store_rows=4):
    """The stream as one-row served batches, the carry in a session store
    at `slot` (the tap must gather that row, not row 0)."""
    H = len(rows[0]["h"])
    for r in rows:
        h_store = np.zeros((store_rows, H), np.float32)
        c_store = np.zeros((store_rows, H), np.float32)
        h_store[slot], c_store[slot] = r["h"], r["c"]
        tap.observe_batch([sid], r["obs"][None], np.array([r["action"]]), r["q"][None],
                          np.array([r["reward"]], np.float32), np.array([r["reset"]]),
                          np.array([r["eps"]], np.float32), ckpt_step=r["version"],
                          version=r["version"], h_store=h_store, c_store=c_store,
                          slots=np.array([slot] * store_rows))


def _offline(cfg, rows):
    """The actor's side: the stream through a bare SequenceAccumulator with
    the serving shift applied by hand. -> (emissions, stamps)."""
    acc = SequenceAccumulator(cfg)
    blocks, stamps, eps_s, ver_s = [], [], [], []
    pending = None

    def cut(last_qval):
        blocks.append(acc.finish(last_qval=last_qval))
        stamps.append((np.asarray(eps_s, np.float32), np.asarray(ver_s, np.int64)))
        eps_s.clear()
        ver_s.clear()

    for t, r in enumerate(rows):
        hidden = np.stack([r["h"], r["c"]]).astype(np.float32)
        if t == 0:
            acc.reset(r["obs"])
        else:
            a, q, hid, eps, ver = pending
            acc.add(a, r["reward"], r["obs"], q, hid)
            eps_s.append(eps)
            ver_s.append(ver)
            if r["reset"]:
                cut(None)
                acc.reset(r["obs"])
            elif acc.size == cfg.block_length:
                cut(r["q"])
        pending = (r["action"], r["q"], hidden, r["eps"], r["version"])
    if acc.size > 0:
        cut(pending[1])
    return blocks, stamps


def _collecting_tap(cfg, cls=TransitionTap, **kw):
    out = []
    tap = cls(cfg, **kw)
    tap.set_emit(lambda b, p, er: out.append((b, p, er)))
    return tap, out


def _assert_emissions_equal(got, want, prio_atol=0.0):
    assert len(got) == len(want)
    for (gb, gp, ger), (wb, wp, wer) in zip(got, want):
        for f in BLOCK_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(gb, f)), np.asarray(getattr(wb, f)),
                                          err_msg=f"block field {f}")
        assert gb.num_sequences == wb.num_sequences
        if prio_atol:
            np.testing.assert_allclose(gp, wp, rtol=0, atol=prio_atol)
        else:
            np.testing.assert_array_equal(gp, wp)
        assert ger == wer


def _assert_audits_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["session"] == y["session"]
        np.testing.assert_array_equal(x["epsilon"], y["epsilon"])
        np.testing.assert_array_equal(x["params_version"], y["params_version"])


# --------------------------------------------------------- against the JAX tap


@pytest.mark.parametrize("seed,resets,depth", [(3, {17}, 256), (4, {5, 30}, 256),
                                               (5, set(), 5)])
def test_tap_matches_jax_tap(seed, resets, depth):
    """Both taps fed the same served batches (two sessions interleaved, a
    drop when the queue is shallow, an eviction): the same blocks bit for
    bit, priorities to 1e-6, the same stamps and counters."""
    rows_a = _stream(CFG, 40, seed=seed, resets=resets)
    rows_b = _stream(CFG, 40, seed=seed + 100)
    port, got = _collecting_tap(CFG, depth=depth)
    ref, want = _collecting_tap(jax_tiny_test(), cls=JaxTransitionTap, depth=depth)
    H = CFG.hidden_dim
    for t, (ra, rb) in enumerate(zip(rows_a, rows_b)):
        h_store = np.stack([np.zeros(H, np.float32), rb["h"], ra["h"]])
        c_store = np.stack([np.zeros(H, np.float32), rb["c"], ra["c"]])
        args = (["a", "b"], np.stack([ra["obs"], rb["obs"]]),
                np.array([ra["action"], rb["action"]]), np.stack([ra["q"], rb["q"]]),
                np.array([ra["reward"], rb["reward"]], np.float32),
                np.array([ra["reset"], rb["reset"]]),
                np.array([ra["eps"], rb["eps"]], np.float32))
        for tap in (port, ref):
            tap.observe_batch(*args, ckpt_step=ra["version"], version=ra["version"],
                              h_store=h_store, c_store=c_store, slots=np.array([2, 1, 0]))
            if t == 33:
                tap.observe_evict("b")
            if t % 9 == 8:
                tap.process_pending()
    for tap in (port, ref):
        tap.process_pending()
        tap.flush()
    _assert_emissions_equal(got, want, prio_atol=1e-6)
    _assert_audits_equal(list(port.audit_tail), list(ref.audit_tail))
    assert port.stats() == ref.stats()
    assert len(got) >= 4


def test_jax_carry_state_resumes_in_the_port_tap():
    """JAX's tap snapshotted mid-stream (a partial block, a pending
    transition, stamps in flight), its npz arrays restored into the port's
    tap, and the rest of the stream fed to both: the same emissions."""
    rows = _stream(CFG, 44, seed=9, resets={13})
    ref, _ = _collecting_tap(jax_tiny_test(), cls=JaxTransitionTap)
    _feed(ref, rows[:25])
    ref.process_pending()
    snap = _npz_round_trip(ref.carry_state())
    port, got = _collecting_tap(CFG)
    port.restore_carry(snap)
    assert port.carry_state().keys() == snap.keys()
    for k, v in port.carry_state()["s0"].items():
        np.testing.assert_array_equal(v, snap["s0"][k], err_msg=k)
    ref2, want = _collecting_tap(jax_tiny_test(), cls=JaxTransitionTap)
    ref2.restore_carry(snap)
    for tap in (port, ref2):
        _feed(tap, rows[25:])
        tap.process_pending()
        tap.flush()
    _assert_emissions_equal(got, want, prio_atol=1e-6)
    _assert_audits_equal(list(port.audit_tail), list(ref2.audit_tail))


@pytest.mark.parametrize("fraction,rungs,seed", [(0.5, 8, 0), (1.0, 3, 1), (0.0, 8, 2),
                                                 (0.3, 1, 3)])
def test_epsilon_assigner_matches_jax(fraction, rungs, seed):
    """The same epsilon per session, through first sights, repeats and
    forgets, and the same census."""
    kw = dict(liveloop_explore_fraction=fraction, liveloop_eps_rungs=rungs)
    port = EpsilonAssigner(CFG.replace(**kw), seed=seed)
    ref = JaxEpsilonAssigner(jax_tiny_test().replace(**kw), seed=seed)
    np.testing.assert_array_equal(port.ladder, ref.ladder)
    rng = np.random.default_rng(seed)
    for _ in range(300):
        sid = f"s{int(rng.integers(0, 40))}"
        if rng.random() < 0.1:
            port.forget(sid)
            ref.forget(sid)
        else:
            assert port.epsilon_for(sid) == ref.epsilon_for(sid)
        assert port.epsilon_of(sid) == ref.epsilon_of(sid)
    assert port.stats() == ref.stats()


# ------------------------------------------------- against the accumulator


def test_tap_matches_offline_accumulator():
    """Every emitted block (cuts with their q_{t+1} bootstrap, the terminal
    block a reset closes, burn-in across blocks, the flush cut) and every
    stamp, bit for bit."""
    rows = _stream(CFG, 40, seed=3, resets={17})
    tap, got = _collecting_tap(CFG)
    _feed(tap, rows)
    tap.process_pending()
    tap.flush()
    want, want_stamps = _offline(CFG, rows)
    _assert_emissions_equal(got, want)
    assert len(want) == 4
    st = tap.stats()
    assert (st["tap_captured_steps"], st["tap_emitted_blocks"], st["tap_dropped_batches"],
            st["tap_seam_breaks"], st["tap_open_sessions"]) == (39, 4, 0, 0, 0)
    audits = list(tap.audit_tail)
    assert len(audits) == len(want_stamps)
    for audit, (eps, ver) in zip(audits, want_stamps):
        assert audit["session"] == "s0"
        np.testing.assert_array_equal(audit["epsilon"], eps)
        np.testing.assert_array_equal(audit["params_version"], ver)


def test_tap_interleaved_sessions_match_per_session_offline():
    rows_a = _stream(CFG, 30, seed=11, resets={9})
    rows_b = _stream(CFG, 30, seed=12)
    tap, got = _collecting_tap(CFG)
    H = CFG.hidden_dim
    for ra, rb in zip(rows_a, rows_b):
        h_store = torch.from_numpy(np.stack([ra["h"], rb["h"]] + [np.zeros(H, np.float32)] * 2))
        c_store = torch.from_numpy(np.stack([ra["c"], rb["c"]] + [np.zeros(H, np.float32)] * 2))
        tap.observe_batch(["a", "b"], np.stack([ra["obs"], rb["obs"]]),
                          np.array([ra["action"], rb["action"]]), np.stack([ra["q"], rb["q"]]),
                          np.array([ra["reward"], rb["reward"]], np.float32),
                          np.array([ra["reset"], rb["reset"]]),
                          np.array([ra["eps"], rb["eps"]], np.float32), ckpt_step=0, version=0,
                          h_store=h_store, c_store=c_store, slots=np.arange(4))
    tap.process_pending()
    tap.flush()
    per = {"a": [], "b": []}
    for audit, emission in zip(list(tap.audit_tail), got):
        per[audit["session"]].append(emission)
    for sid, rows in (("a", rows_a), ("b", rows_b)):
        want, _ = _offline(CFG, rows)
        _assert_emissions_equal(per[sid], want)


def test_tap_eviction_and_drop_seams():
    """An eviction cuts the partial block with the pending-Q bootstrap; a
    queue overflow drops the oldest record, and the severed session's
    partial is cut cleanly at next sight before the stream reseeds."""
    rows = _stream(CFG, 10, seed=5)
    tap, got = _collecting_tap(CFG)
    _feed(tap, rows)
    tap.observe_evict("s0")
    tap.process_pending()
    assert tap.stats()["tap_open_sessions"] == 0
    _assert_emissions_equal(got, _offline(CFG, rows)[0])

    rows = _stream(CFG, 16, seed=7)
    tap, got = _collecting_tap(CFG, depth=6)
    _feed(tap, rows[:4])
    assert tap.process_pending() == 4
    _feed(tap, rows[4:])
    assert tap.process_pending() == 6
    tap.flush()
    st = tap.stats()
    assert (st["tap_dropped_batches"], st["tap_seam_breaks"], st["tap_captured_steps"]) == \
        (6, 1, 3 + 5)
    _assert_emissions_equal(got, _offline(CFG, rows[:4])[0] + _offline(CFG, rows[10:])[0])


def _npz_round_trip(snap):
    out = {}
    for sid, d in snap.items():
        buf = io.BytesIO()
        np.savez(buf, **d)
        buf.seek(0)
        with np.load(buf) as z:
            out[sid] = {k: z[k] for k in z.files}
    return out


def test_tap_snapshot_resume_bit_exact():
    rows = _stream(CFG, 44, seed=9, resets={13})
    tap_a, got_a = _collecting_tap(CFG)
    _feed(tap_a, rows)
    tap_a.process_pending()
    tap_a.flush()
    tap_b, got_b = _collecting_tap(CFG)
    _feed(tap_b, rows[:25])
    tap_b.process_pending()
    tap_c, got_c = _collecting_tap(CFG)
    tap_c.restore_carry(_npz_round_trip(tap_b.carry_state()))
    _feed(tap_c, rows[25:])
    tap_c.process_pending()
    tap_c.flush()
    _assert_emissions_equal(got_b + got_c, got_a)
    _assert_audits_equal(list(tap_a.audit_tail),
                         list(tap_b.audit_tail) + list(tap_c.audit_tail))


def test_gather_carry_rows_casts_to_float32():
    h = torch.arange(12, dtype=torch.float32).reshape(4, 3).to(torch.bfloat16)
    rows = gather_carry_rows(h, -h, torch.tensor([3, 1]))
    assert rows[0].dtype == torch.float32 and torch.equal(rows[0], h[[3, 1]].float())
    assert torch.equal(rows[1], -rows[0])


# ------------------------------------------------------- bridge backpressure


class _FakeReplay:
    def __init__(self):
        self.batches = []

    def add_blocks_batch(self, items):
        self.batches.append(list(items))


def test_bridge_backpressure_drops_oldest_counted():
    replay = _FakeReplay()
    bridge = IngestBridge(replay, depth=2)
    for i in range(5):
        bridge.offer(f"block{i}", f"prio{i}", None)
    st = bridge.stats()
    assert (st["bridge_offered_blocks"], st["bridge_dropped_blocks"],
            st["bridge_queue_depth"]) == (5, 3, 2)
    assert bridge.drain_once() == 2
    assert replay.batches == [[("block3", "prio3", None), ("block4", "prio4", None)]]
    st = bridge.stats()
    assert (st["bridge_ingested_blocks"], st["bridge_queue_depth"],
            st["bridge_dropped_last_drain"]) == (2, 0, 3)
    bridge.offer("block5", "prio5", None)
    bridge.drain_once()
    assert bridge.stats()["bridge_dropped_last_drain"] == 0


def test_bridge_falls_back_to_add_block():
    class _OldReplay:
        def __init__(self):
            self.calls = []

        def add_block(self, block, priorities, episode_reward=None):
            self.calls.append((block, priorities, episode_reward))

    replay = _OldReplay()
    bridge = IngestBridge(replay, depth=8)
    bridge.offer("b0", "p0", 1.5)
    bridge.offer("b1", "p1", None)
    assert bridge.drain_once() == 2
    assert replay.calls == [("b0", "p0", 1.5), ("b1", "p1", None)]


def test_bridge_batch_add_into_the_host_replay():
    """The port's ReplayBuffer takes a drained burst under one lock, as
    add_block would one by one."""
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    rows = _stream(CFG, 40, seed=3, resets={17})
    blocks, _ = _offline(CFG, rows)
    a, b = ReplayBuffer(CFG), ReplayBuffer(CFG)
    bridge = IngestBridge(a, depth=8)
    for blk in blocks:
        bridge.offer(*blk)
        b.add_block(*blk)
    assert bridge.drain_once() == len(blocks)
    for name in ("obs_store", "hidden_store", "n_step_reward_store"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.block_ptr, a.env_steps) == (b.block_ptr, b.env_steps)


# ------------------------------------------------------------ on a live server


def _served_stream(srv, client, cfg, sessions, steps, seed):
    """Interleaved sessions served one request at a time, each answer
    replayed through the port's reference_act at its bucket and row: ->
    {sid: rows} in _stream's layout, with the carries the server wrote."""
    rng = np.random.default_rng(seed)
    out = {sid: [] for sid in sessions}
    refs = {sid: SessionReference(srv.net if hasattr(srv, "net") else srv.replicas[0].net,
                                  cfg.hidden_dim) for sid in sessions}
    for t in range(steps):
        for k, sid in enumerate(sessions):
            obs = rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8)
            reset = t == 0 or (t == 11 and k == 1)
            reward = float(np.float32(rng.normal()))
            res = client.act(sid, obs, reward=reward, reset=reset)
            replica = srv.replica_for(sid) if hasattr(srv, "replica_for") else srv
            ref = refs[sid]
            q, _ = ref.step(replica.served_params(), obs, reward, reset, bucket=res.bucket,
                            row=res.row)
            np.testing.assert_array_equal(q, res.q)
            ref.last_action = np.array([res.action], np.int32)  # explored or not
            out[sid].append(dict(obs=obs, action=res.action, q=res.q, reward=reward,
                                 reset=reset, eps=float(np.float32(
                                     replica.eps_assigner.epsilon_of(sid))),
                                 h=ref.h[0].copy(), c=ref.c[0].copy(),
                                 version=res.params_version))
    return out


@pytest.mark.parametrize("kind", ["pipelined", "serial", "fleet"])
def test_served_tap_matches_offline_accumulator(kind):
    """A live serve stack with the loop's hooks: the blocks the tap emits
    equal an offline accumulator's fed the recorded served stream, stamps
    included (the carries gathered at dispatch are the server's own)."""
    cfg = CFG.replace(serve_pipeline=kind != "serial", liveloop=True,
                      liveloop_explore_fraction=0.5, serve_spill=16)
    serve_cfg = ServeConfig(buckets=(2, 4), max_wait_ms=1.0, cache_capacity=8)
    if kind == "fleet":
        srv = MultiDeviceServer(cfg, serve_cfg, devices=["cpu", "cpu"])
    else:
        srv = PolicyServer(cfg, serve_cfg, device="cpu")
    blocks: list = []
    sink = _FakeReplay()
    plane = LiveLoopPlane(cfg, srv, sink, seed=3)
    plane.tap.set_emit(lambda b, p, er: (blocks.append((b, p, er)), plane.bridge.offer(b, p, er)))
    srv.warmup()
    srv.start()
    plane.start()
    sessions = [f"live-{k}" for k in range(3)]
    try:
        stream = _served_stream(srv, LocalClient(srv), cfg, sessions, 20, seed=8)
        # an answer resolves before its batch reaches the tap: wait for the
        # last records before the disconnects
        deadline = time.monotonic() + 10.0
        while plane.tap.stats()["tap_captured_steps"] < 3 * 19 and time.monotonic() < deadline:
            time.sleep(0.01)
        for sid in sessions:
            srv.evict(sid)  # disconnect: the partial blocks are cut
    finally:
        plane.stop()
        srv.stop()
    per = {sid: [] for sid in sessions}
    for audit, emission in zip(list(plane.tap.audit_tail), blocks):
        per[audit["session"]].append((emission, audit))
    for sid in sessions:
        want, stamps = _offline(cfg, stream[sid])
        _assert_emissions_equal([e for e, _ in per[sid]], want)
        for (_, audit), (eps, ver) in zip(per[sid], stamps):
            np.testing.assert_array_equal(audit["epsilon"], eps)
            np.testing.assert_array_equal(audit["params_version"], ver)
    st = plane.stats()
    assert st["tap_captured_steps"] == 3 * 19 and st["tap_dropped_batches"] == 0
    assert sum(len(b) for b in sink.batches) == len(blocks) == st["bridge_ingested_blocks"]
    assert st["eps_sessions_assigned"] == 3


@pytest.fixture(scope="module")
def eps_servers():
    servers = []
    for _ in range(2):
        srv = PolicyServer(CFG, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=8),
                           device="cpu")
        srv.warmup()
        srv.start()
        servers.append(srv)
    yield servers
    for srv in servers:
        srv.stop()


def test_epsilon_none_and_zero_bitwise_identical(eps_servers):
    rng = np.random.default_rng(0)
    obs_seq = [rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8) for _ in range(12)]
    streams = []
    for srv, eps in zip(eps_servers, (None, 0.0)):
        client = LocalClient(srv)
        streams.append([(r.action, r.q.copy()) for r in (
            client.act("sess", obs, reward=0.5 * t, reset=t == 0, epsilon=eps)
            for t, obs in enumerate(obs_seq))])
    for (a0, q0), (a1, q1) in zip(*streams):
        assert a0 == a1
        np.testing.assert_array_equal(q0, q1)


def test_epsilon_override_explores_and_assigner_surfaces_stats(eps_servers):
    srv = eps_servers[0]
    client = LocalClient(srv)
    rng = np.random.default_rng(1)
    deviated = 0
    for t in range(24):
        r = client.act("explore", rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8),
                       reset=t == 0, epsilon=1.0)
        deviated += int(r.action != int(np.argmax(r.q)))
    assert deviated > 0
    srv.eps_assigner = EpsilonAssigner(CFG.replace(liveloop_explore_fraction=1.0), seed=0)
    try:
        for t in range(4):
            client.act("assigned", rng.integers(0, 255, CFG.obs_shape, dtype=np.uint8),
                       reset=t == 0)
        st = srv.stats()
        assert st["eps_sessions_assigned"] == 1 and st["eps_sessions_exploring"] == 1
        assert srv.eps_assigner.epsilon_of("assigned") > 0.0
        client.evict("assigned")
        assert srv.eps_assigner.epsilon_of("assigned") is None
    finally:
        srv.eps_assigner = None


@pytest.mark.parametrize("site", ["liveloop.tap", "liveloop.ingest"])
def test_liveloop_fault_sites(site):
    """Both sites are registered; an injected error in either worker is a
    supervised restart, and the loop still lands every block in replay."""
    assert site in faults.KNOWN_SITES
    cfg = CFG.replace(liveloop=True)
    srv = PolicyServer(cfg, ServeConfig(buckets=(2,), max_wait_ms=1.0, cache_capacity=8),
                       device="cpu")
    sink = _FakeReplay()
    plane = LiveLoopPlane(cfg, srv, sink)
    srv.warmup()
    srv.start()
    faults.install(faults.FaultPlane.from_spec(f"{site}@2=error"))
    try:
        plane.start()
        client = LocalClient(srv)
        rng = np.random.default_rng(2)
        for t in range(cfg.block_length + 3):
            client.act("f", rng.integers(0, 255, cfg.obs_shape, dtype=np.uint8), reset=t == 0)
        deadline = time.monotonic() + 10.0
        while plane.stats()["bridge_ingested_blocks"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        restarts = plane.check()["worker_restarts"]
    finally:
        faults.uninstall()
        plane.stop()
        srv.stop()
    assert restarts == 1
    assert plane.stats()["bridge_ingested_blocks"] == 2  # the full block and the flush


# --------------------------------------------------------------- end to end


@pytest.mark.slow
def test_liveloop_return_improves_on_catch(tmp_path):
    seconds = 30.0
    stats, loop_stats, episodes = run_liveloop_catch(tmp_path, "cpu", seconds=seconds)
    assert stats["sessions_lost"] == 0 and stats["reloads"] >= 1
    assert stats["params_version"] > 0
    assert loop_stats["tap_captured_steps"] > 0 and loop_stats["bridge_ingested_blocks"] > 0
    half1 = [r for t, r in episodes if t < seconds / 2]
    half2 = [r for t, r in episodes if t >= seconds / 2]
    assert len(half1) >= 10 and len(half2) >= 10
    assert float(np.mean(half2)) > float(np.mean(half1))
