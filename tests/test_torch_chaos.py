"""Kill-and-resume drills of the port's trainer under deterministic fault
injection (r2d2_tpu_torch/utils/faults.py), the port against itself, as
tests/test_chaos.py drills the JAX package.

An injected SIGTERM cuts a run at a step boundary; the run captures its
deferred priority write-back, snapshots replay with the mid-run carry
(sampling Generator, published parameters, the actor's and envs' episode
streams), writes a finalized checkpoint at the cut and reports preempted;
a resumed run then continues bit-identically to one never interrupted:
the same learner state, replay tree and sampling stream. The tiered plane
runs its synchronous deterministic_staging mode, K=2, so a deferred
write-back is pending at every cut.

The transport sweep (tests/test_chaos.py's): an injected error at every
transport and ingest fault site, and the block stream still arrives as the
fault-free run's, bit for bit, with no duplicate.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.replay.snapshot import save_replay
from r2d2_tpu_torch.train import Trainer
from r2d2_tpu_torch.utils import faults
from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step
from r2d2_tpu_torch.utils.faults import FaultPlane
from r2d2_tpu_torch.utils.supervision import PREEMPT_EXIT_CODE, STALL_EXIT_CODE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12

_PLANE_CFG = {
    "host": {},
    "tiered": dict(replay_plane="tiered", deterministic_staging=True, updates_per_dispatch=2),
    # the device planes: K=2 with the deferred write-back pending at every
    # cut, and the device priority plane's N x K superstep (N=2), whose
    # draws derive from the step counter
    "device": dict(replay_plane="device", updates_per_dispatch=2),
    "device_priority": dict(replay_plane="device", priority_plane="device",
                            updates_per_dispatch=2, superstep_dispatches=2),
    # collection on the card: the collector's generator and its episodes
    # carried across chunks (tiny_test's episodes outlive a 16-step chunk)
    "device_collector": dict(replay_plane="device", collector="device",
                             updates_per_dispatch=2),
}


@pytest.fixture(autouse=True)
def _clean_plane():
    faults.uninstall()
    faults.reset_retry_stats()
    yield
    faults.uninstall()
    faults.reset_retry_stats()


def _cfg(tmp_path, tag, plane="host", **overrides):
    (tmp_path / tag).mkdir(exist_ok=True)
    base = dict(
        env_name="catch",
        checkpoint_dir=str(tmp_path / tag / "ckpt"),
        metrics_path=str(tmp_path / tag / "metrics.jsonl"),
        snapshot_replay=True,
        training_steps=STEPS,
        save_interval=1000,  # only the preemption's checkpoint exists
        learning_starts=48,
        **_PLANE_CFG[plane],
    )
    base.update(overrides)
    return tiny_test().replace(**base)


def _fingerprint(trainer, tmp_path, tag):
    """What the resume contract promises, comparable: every tensor of the
    learner state, the step, the sampling Generator, and the whole replay
    through its own snapshot writer."""
    path = str(tmp_path / f"fp_{tag}.npz")
    save_replay(trainer.replay, path)
    with np.load(path, allow_pickle=False) as d:
        replay = {k: np.asarray(d[k]) for k in d.files}
    st = trainer.state
    tensors = [*st.net.state_dict().values(), *st.target_net.state_dict().values()]
    for s in st.optimizer.state_dict()["state"].values():
        tensors += list(s.values())
    return ([t.clone() for t in tensors], st.step, trainer.sample_rng.bit_generator.state,
            replay)


def _assert_identical(a, b):
    ta, step_a, rng_a, replay_a = a
    tb, step_b, rng_b, replay_b = b
    assert step_a == step_b and rng_a == rng_b
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert sorted(replay_a) == sorted(replay_b)
    for k in replay_a:
        np.testing.assert_array_equal(replay_a[k], replay_b[k], err_msg=k)


def _next_draw_idxes(trainer):
    """One more draw through the plane's own sampling path."""
    item = trainer.sample()
    return np.asarray(item.idxes if hasattr(item, "idxes") else item[2])


def _run_clean(cfg):
    t = Trainer(cfg, device="cpu")
    t.run_inline(env_steps_per_update=4)
    assert not t.preempted and t._step == cfg.training_steps
    return t


def _kill(cfg, site, call):
    faults.install(FaultPlane(schedule={site: {call: "sigterm"}}))
    try:
        t = Trainer(cfg, device="cpu", resume=True)
        t.run_inline(env_steps_per_update=4)
    finally:
        faults.uninstall()
    assert t.preempted, f"sigterm at {site}@{call} did not preempt"
    assert t._step < cfg.training_steps
    # the commit point: a finalized checkpoint at the cut, the snapshot too
    assert latest_checkpoint_step(cfg.checkpoint_dir) == t._step
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "replay_snapshot.npz"))
    return t


def _resume(cfg, cut):
    t = Trainer(cfg, device="cpu", resume=True)
    assert t._initial_step == cut
    t.run_inline(env_steps_per_update=4)
    assert not t.preempted and t._step == cfg.training_steps
    return t


@pytest.mark.parametrize("plane,site,call", [
    ("host", "trainer.update", 4),
    ("host", "host_plane.h2d", 3),  # delivered mid-sample
    ("host", "actor.step", 5),  # delivered in warmup: the cut is at step 0
    ("tiered", "trainer.update", 3),
    ("tiered", "tiered.stage_h2d", 2),  # delivered mid-stage
])
def test_sigterm_resume_is_bit_identical(tmp_path, plane, site, call):
    clean = _run_clean(_cfg(tmp_path, "clean", plane))
    cfg = _cfg(tmp_path, "killed", plane)
    cut = _kill(cfg, site, call)._step
    resumed = _resume(cfg, cut)
    _assert_identical(_fingerprint(clean, tmp_path, "clean"),
                      _fingerprint(resumed, tmp_path, "killed"))
    np.testing.assert_array_equal(_next_draw_idxes(clean), _next_draw_idxes(resumed))


@pytest.mark.parametrize("plane,call", [("device", 3), ("device_priority", 1),
                                        ("device_collector", 2)])
def test_device_planes_sigterm_resume_is_bit_identical(tmp_path, plane, call):
    """R2D2_FAULTS="trainer.update@N=sigterm" on the device planes: the
    resumed run's first update's loss, and every state at the end (the
    device tree's leaves among the replay's), equal an uninterrupted run's."""
    clean = _run_clean(_cfg(tmp_path, "clean", plane))
    cfg = _cfg(tmp_path, "killed", plane)
    cut = _kill(cfg, "trainer.update", call)._step
    assert cut > 0
    resumed = _resume(cfg, cut)
    _assert_identical(_fingerprint(clean, tmp_path, "clean"),
                      _fingerprint(resumed, tmp_path, "killed"))

    def loss_after(tag, step):
        with open(tmp_path / tag / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        return [r["loss"] for r in recs if r.get("step") == step]

    first = cut + resumed.plane.steps_per_update
    assert loss_after("killed", first) == loss_after("clean", first) != []
    if plane == "device_priority":
        assert torch.equal(clean.replay.dtree.tree, resumed.replay.dtree.tree)


def test_lru_core_carry_resumes_bit_identically(tmp_path):
    """The actor's carry is the LRU's (Re h, Im h) on that core: cut and
    resumed, the run is the uninterrupted one's bit for bit."""
    over = dict(recurrent_core="lru")
    clean = _run_clean(_cfg(tmp_path, "clean", **over))
    cfg = _cfg(tmp_path, "killed", **over)
    resumed = _resume(cfg, _kill(cfg, "trainer.update", 4)._step)
    _assert_identical(_fingerprint(clean, tmp_path, "clean"),
                      _fingerprint(resumed, tmp_path, "killed"))


@pytest.mark.parametrize("site,call", [("disk.write", 2), ("disk.promote", 1)])
def test_disk_tier_sigterm_resume_is_bit_identical(tmp_path, site, call):
    """A SIGTERM before a demotion's bytes land, or mid page-in, resumes
    bit-identically: the snapshot is the commit point, and the segment
    files are rewritten from it on restore."""
    over = dict(buffer_capacity=64, replay_disk_capacity=320, block_codec="delta-zlib")
    clean = _run_clean(_cfg(tmp_path, "clean", "tiered",
                            replay_disk_dir=str(tmp_path / "clean" / "disk"), **over))
    assert clean.replay.disk_stats()["disk_demotions"] > 0
    cfg = _cfg(tmp_path, "killed", "tiered", replay_disk_dir=str(tmp_path / "killed" / "disk"),
               **over)
    resumed = _resume(cfg, _kill(cfg, site, call)._step)
    _assert_identical(_fingerprint(clean, tmp_path, "clean"),
                      _fingerprint(resumed, tmp_path, "killed"))
    np.testing.assert_array_equal(_next_draw_idxes(clean), _next_draw_idxes(resumed))


def test_double_preemption_resumes_twice(tmp_path):
    clean = _run_clean(_cfg(tmp_path, "clean"))
    cfg = _cfg(tmp_path, "killed")
    assert _kill(cfg, "trainer.update", 3)._step == 3
    assert _kill(cfg, "trainer.update", 4)._step == 7
    _assert_identical(_fingerprint(clean, tmp_path, "clean"),
                      _fingerprint(_resume(cfg, 7), tmp_path, "killed"))


@pytest.mark.parametrize("plane,site", [("host", "host_plane.h2d"),
                                        ("tiered", "tiered.stage_h2d")])
def test_transient_h2d_fault_is_absorbed_without_moving_the_stream(tmp_path, plane, site):
    clean = _run_clean(_cfg(tmp_path, "clean", plane))
    faults.reset_retry_stats()
    faults.install(FaultPlane(schedule={site: {2: "error"}}))
    try:
        flaky = _run_clean(_cfg(tmp_path, "flaky", plane))
    finally:
        faults.uninstall()
    assert faults.retry_stats().get(site) == 1
    _assert_identical(_fingerprint(clean, tmp_path, "clean"),
                      _fingerprint(flaky, tmp_path, "flaky"))
    with open(flaky.cfg.metrics_path) as f:
        assert '"io_retries"' in f.read()


def test_checkpoint_save_and_restore_faults_are_absorbed(tmp_path):
    cfg = _cfg(tmp_path, "ckpt", save_interval=8)
    faults.install(FaultPlane(schedule={"checkpoint.save": {1: "error"}}))
    try:
        t = _run_clean(cfg)
    finally:
        faults.uninstall()
    assert latest_checkpoint_step(cfg.checkpoint_dir) == 8
    assert faults.retry_stats().get("checkpoint.save") == 1
    faults.install(FaultPlane(schedule={"checkpoint.restore": {1: "error"}}))
    try:
        resumed = Trainer(cfg, device="cpu", resume=True)
    finally:
        faults.uninstall()
    assert resumed._initial_step == 8 and resumed.state.step == 8
    assert faults.retry_stats().get("checkpoint.restore") == 1
    assert t._step == STEPS


def test_snapshot_write_failure_does_not_mask_the_run(tmp_path):
    cfg = _cfg(tmp_path, "snapfail")
    faults.install(FaultPlane(schedule={"snapshot.write": {1: "error"}}))
    try:
        t = _run_clean(cfg)  # the failed snapshot does not raise
    finally:
        faults.uninstall()
    assert t._step == STEPS
    assert not os.path.exists(os.path.join(cfg.checkpoint_dir, "replay_snapshot.npz"))


def test_snapshot_every_cadence(tmp_path):
    cfg = _cfg(tmp_path, "periodic", snapshot_every=4)
    t = Trainer(cfg, device="cpu")
    calls = []
    orig = t.save_replay_snapshot

    def counting(extra=None):
        calls.append(t._step)
        return orig(extra=extra)

    t.save_replay_snapshot = counting
    t.run_inline(env_steps_per_update=4)
    # crossings at 4, 8 and 12 (one may be skipped while the previous write
    # runs) and the exit snapshot, which lands last
    assert len(calls) >= 2 and calls[-1] == STEPS
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "replay_snapshot.npz"))


def test_threaded_cut_snapshots_and_resumes(tmp_path):
    """request_preempt from another thread during run_threaded: the cut
    lands at a step boundary with the snapshot and the checkpoint, and the
    resumed run goes on to its target (threaded mode's interleaving is not
    reproducible, so this drill holds the protocol, not the bits)."""
    cfg = _cfg(tmp_path, "threaded")
    t = Trainer(cfg, device="cpu")
    orig = t._one_update

    def update_then_cut(item):
        out = orig(item)
        if t._step == 5:
            t.request_preempt()
        return out

    t._one_update = update_then_cut
    t.run_threaded()
    assert t.preempted and t._step == 5
    assert latest_checkpoint_step(cfg.checkpoint_dir) == 5
    with np.load(os.path.join(cfg.checkpoint_dir, "replay_snapshot.npz")) as d:
        assert int(d["x_carry_step"]) == 5
    r = Trainer(cfg, device="cpu", resume=True)
    assert r._initial_step == 5 and r.replay.env_steps == t.replay.env_steps
    r.run_threaded()
    assert r._step == STEPS and not r.preempted


def test_cli_preempt_exit_code_and_resume(tmp_path):
    """The operator's loop as subprocesses: R2D2_FAULTS delivers a real
    SIGTERM, the CLI exits with PREEMPT_EXIT_CODE, and --resume finishes."""
    assert PREEMPT_EXIT_CODE == 85 and PREEMPT_EXIT_CODE != STALL_EXIT_CODE
    ckpt = str(tmp_path / "ckpt")
    args = [
        sys.executable, "-m", "r2d2_tpu_torch.train", "--device", "cpu",
        "--preset", "tiny_test", "--env", "catch", "--mode", "inline",
        "--steps", str(STEPS), "--snapshot-replay",
        "--set", f"checkpoint_dir={ckpt}", "--set", "save_interval=1000",
        "--set", "learning_starts=48",
    ]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    p1 = subprocess.run(args, env={**env, "R2D2_FAULTS": "trainer.update@3=sigterm"},
                        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p1.returncode == PREEMPT_EXIT_CODE, p1.stderr
    out1 = json.loads(p1.stdout.strip().splitlines()[-1])
    assert out1["preempted"] and out1["step"] == 3
    assert latest_checkpoint_step(ckpt) == 3
    p2 = subprocess.run(args + ["--resume"], env=env, cwd=ROOT, capture_output=True,
                        text=True, timeout=300)
    assert p2.returncode == 0, p2.stderr
    out2 = json.loads(p2.stdout.strip().splitlines()[-1])
    assert out2["resumed_from"] == 3 and out2["step"] == STEPS and not out2["preempted"]
    assert latest_checkpoint_step(ckpt) == 3  # no save_interval crossing after it


# ------------------------------------------------- transport chaos sweep


TRANSPORT_SITES = [
    "transport.connect",
    "transport.send",
    "transport.recv",
    "transport.spool",
    "ingest.accept",
    "ingest.dedup",
]


def _mk_transport_block(i, T=12):
    from r2d2_tpu_torch.replay.block import Block

    rng = np.random.default_rng(i)
    B = 1
    return Block(
        obs=rng.normal(size=(T, B, 5, 5)).astype(np.float32),
        last_action=rng.integers(0, 3, (T, B)).astype(np.int32),
        last_reward=rng.normal(size=(T, B)).astype(np.float32),
        action=rng.integers(0, 3, (T, B)).astype(np.int32),
        n_step_reward=rng.normal(size=(T, B)).astype(np.float32),
        gamma=np.ones((T, B), np.float32),
        hidden=rng.normal(size=(2, B, 8)).astype(np.float32),
        num_sequences=B,
        burn_in_steps=np.zeros((B,), np.int32),
        learning_steps=np.full((B,), T, np.int32),
        forward_steps=np.zeros((B,), np.int32),
    )


def _podstream_run(tmp_path, tag, n_blocks=6):
    """One fixed publisher -> ingest stream: a spool-backed publisher
    pumped by the test against a live ingest worker, every offer through
    the bridge's own retry wrapper (as the live loop feeds the publisher).
    -> (ingested obs, ingest stats, publisher stats, ingest worker counts),
    read after the publisher's stop and its final flush."""
    import time as _time

    from r2d2_tpu_torch.transport.ingest import IngestService
    from r2d2_tpu_torch.transport.publisher import BlockStreamPublisher
    from r2d2_tpu_torch.utils.faults import with_retries

    cfg = tiny_test().replace(
        env_name="catch", action_dim=3, liveloop=True,
        transport_connect_timeout_s=2.0, transport_heartbeat_s=0.2,
        transport_dead_peer_s=10.0, transport_spool_dir=str(tmp_path / tag))

    class _Sink:
        def __init__(self):
            self.items = []

        def add_blocks_batch(self, items):
            self.items.extend(items)

    sink = _Sink()
    svc = IngestService(cfg, sink, version_source=None)
    svc.start()
    pub = BlockStreamPublisher(cfg, ("127.0.0.1", svc.port), "h0", seed=0)
    try:
        for i in range(n_blocks):
            with_retries(lambda i=i: pub.add_block(_mk_transport_block(i),
                                                   np.ones((1,), np.float32), None),
                         "liveloop.ingest", sleep=lambda _: None)
        deadline = _time.monotonic() + 30.0
        while _time.monotonic() < deadline and len(sink.items) < n_blocks:
            pub.pump(timeout=0.05)
    finally:
        pub.stop(flush_deadline_s=1.0)
        workers = svc.check()
        svc.stop()
    return [b.obs for (b, _, _) in sink.items], svc.stats(), pub.stats(), workers


@pytest.mark.parametrize("site", TRANSPORT_SITES)
def test_transport_chaos_every_site_bit_identical(tmp_path, site):
    """An injected error (from the R2D2_FAULTS spec format) at every
    transport and ingest fault site: the retry, reconnect and resume
    machinery delivers the fault-free run's block stream, nothing lost,
    nothing duplicated, bit for bit, and the fault shows where it was
    absorbed."""
    clean_obs, clean_stats, _, _ = _podstream_run(tmp_path, "clean")
    assert len(clean_obs) == 6 and clean_stats["ingest_duplicate_blocks"] == 0

    faults.reset_retry_stats()
    plane = faults.install(FaultPlane.from_spec(f"{site}@1=error"))
    try:
        chaos_obs, chaos_stats, pub_stats, workers = _podstream_run(tmp_path, f"chaos_{site}")
    finally:
        faults.uninstall()
    assert plane.fired == [(site, 1, "error")]
    assert chaos_stats["ingest_blocks"] == 6
    assert chaos_stats["ingest_duplicate_blocks"] == 0
    assert len(chaos_obs) == len(clean_obs)
    for a, b in zip(chaos_obs, clean_obs):
        np.testing.assert_array_equal(a, b)
    # where each fault was absorbed: a retried connect, a retried offer, a
    # restarted ingest worker, or a dropped stream the handshake resumed (by
    # the final flush at the latest, when the fault ate the last ack)
    absorbed = {
        "transport.connect": faults.retry_stats().get("transport.connect", 0),
        "transport.spool": faults.retry_stats().get("liveloop.ingest", 0),
        "ingest.accept": workers["worker_restarts"],
    }.get(site, pub_stats["transport_reconnects"] - 1)
    assert absorbed >= 1, (pub_stats, workers, faults.retry_stats())
