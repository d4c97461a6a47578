"""The port's worker supervision (r2d2_tpu_torch/utils/supervision.py), as
tests/test_supervision.py holds the JAX package's: restart on a crash, fatal
past the restart budget or on a failing recovery hook, stalls reported and
escalated, and the main-thread watchdog's hard exit (in a subprocess). Then
threaded training under it: an injected actor fault is recovered through
VectorizedActor.resync, and a wedged actor fails the run promptly."""

import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from r2d2_tpu_torch.config import tiny_test
from r2d2_tpu_torch.envs.catch import CatchVecEnv
from r2d2_tpu_torch.train import Trainer
from r2d2_tpu_torch.utils.supervision import (
    STALL_EXIT_CODE,
    Supervisor,
    WorkerFatalError,
    WorkerStalledError,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_supervisor_restarts_crashing_worker():
    sup = Supervisor()
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected")
        if len(calls) > 5:
            sup.stop.set()
        time.sleep(0.01)

    w = sup.spawn("w", body, max_restarts=3)
    deadline = time.monotonic() + 10
    while not sup.stop.is_set() and time.monotonic() < deadline:
        sup.check()
        time.sleep(0.02)
    sup.shutdown()
    assert len(calls) > 5  # kept running after the injected crash
    assert w.restarts == 1
    assert "injected" in w.last_error


def test_supervisor_fatal_after_restart_budget():
    sup = Supervisor()

    def body():
        raise RuntimeError("always broken")

    sup.spawn("bad", body, max_restarts=2)
    deadline = time.monotonic() + 10
    with pytest.raises(WorkerFatalError, match="always broken"):
        while time.monotonic() < deadline:
            sup.check()
            time.sleep(0.02)
    sup.shutdown()


def test_on_restart_hook_failure_goes_fatal():
    """A failing recovery hook goes fatal at once, and check() surfaces
    both tracebacks."""
    sup = Supervisor()
    bodies = []

    def body():
        bodies.append(1)
        raise RuntimeError("worker crashed")

    def bad_hook():
        raise RuntimeError("hook is broken too")

    w = sup.spawn("w", body, max_restarts=5, on_restart=bad_hook)
    deadline = time.monotonic() + 10
    with pytest.raises(WorkerFatalError):
        while time.monotonic() < deadline:
            sup.check()
            time.sleep(0.02)
    assert w.fatal
    assert len(bodies) == 1  # never restarted after the hook failed
    assert any("hook is broken too" in e for e in w.errors)
    assert any("worker crashed" in e for e in w.errors)
    sup.shutdown()


def test_stall_exit_code_is_distinct():
    """The stall exit is told apart from a clean exit (0), a crash (1) and
    signals (>128); the preemption exit waits for M9."""
    assert STALL_EXIT_CODE not in (0, 1)
    assert 1 <= STALL_EXIT_CODE <= 125


def test_supervisor_reports_stall():
    sup = Supervisor(heartbeat_timeout=0.05)
    release = threading.Event()

    def body():
        release.wait(5.0)

    sup.spawn("slow", body)
    time.sleep(0.2)
    stats = sup.check()
    assert stats["worker_stalls"] == 1
    release.set()
    sup.shutdown()


class FaultyCatchVecEnv(CatchVecEnv):
    """Raises once, after `fault_after` steps: a transient actor fault."""

    def __init__(self, *a, fault_after: int = 30, **kw):
        super().__init__(*a, **kw)
        self._steps = 0
        self._fault_after = fault_after
        self._fired = False

    def step(self, actions):
        self._steps += 1
        if not self._fired and self._steps >= self._fault_after:
            self._fired = True
            raise RuntimeError("injected env fault")
        return super().step(actions)


def test_fault_injected_actor_recovers(tmp_path):
    cfg = tiny_test().replace(env_name="catch", training_steps=12, learning_starts=48,
                              save_interval=1000, checkpoint_dir=str(tmp_path / "ckpt"))
    vec_env = FaultyCatchVecEnv(cfg.num_actors, 12, 12, seed=0, fault_after=40)
    trainer = Trainer(cfg, vec_env=vec_env, device="cpu")
    resyncs = []
    resync = trainer.actor.resync
    trainer.actor.resync = lambda: (resyncs.append(1), resync())
    trainer.run_threaded()
    assert trainer.state.step == cfg.training_steps
    assert vec_env._fired  # the fault triggered mid-run
    assert resyncs == [1]  # and the actor was resynced once


def test_stalled_worker_escalates_to_fatal():
    """A thread wedged inside an unkillable call fails the run past
    stall_fatal_timeout."""
    sup = Supervisor(heartbeat_timeout=0.2, stall_fatal_timeout=3.0)
    release = threading.Event()
    sup.spawn("wedged", release.wait)  # blocks, no heartbeat
    time.sleep(0.5)
    stats = sup.check()  # stale but below fatal: surfaced, not raised
    assert stats["worker_stalls"] == 1
    time.sleep(3.0)
    with pytest.raises(WorkerFatalError, match="stalled"):
        sup.check()
    release.set()
    sup.shutdown()


def test_stall_escalation_disabled_with_zero_timeout():
    sup = Supervisor(heartbeat_timeout=0.05, stall_fatal_timeout=0.0)
    release = threading.Event()
    sup.spawn("wedged", release.wait)
    time.sleep(0.4)
    stats = sup.check()  # never escalates, only reports
    assert stats["worker_stalls"] == 1
    release.set()
    sup.shutdown()


class WedgingCatchVecEnv(CatchVecEnv):
    """Blocks inside step() once `wedge` is set, until `release` is."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.wedge = False
        self.release = threading.Event()

    def step(self, actions):
        if self.wedge:
            self.release.wait()
        return super().step(actions)


def test_run_threaded_exits_on_wedged_actor(tmp_path):
    cfg = tiny_test().replace(env_name="catch", training_steps=10_000, learning_starts=48,
                              heartbeat_timeout=0.2, stall_fatal_timeout=1.5,
                              save_interval=100_000, checkpoint_dir=str(tmp_path / "ckpt"))
    vec_env = WedgingCatchVecEnv(cfg.num_actors, 12, 12, seed=0)
    trainer = Trainer(cfg, vec_env=vec_env, device="cpu")
    trainer.warmup()  # wedge only after sampling opens
    vec_env.wedge = True
    t0 = time.time()
    try:
        with pytest.raises(WorkerStalledError, match="stalled"):
            trainer.run_threaded()
        # the exit skipped every cleanup that could block: prompt, not hung
        assert time.time() - t0 < 30.0
    finally:
        # the watchdog stays armed through the unwind on purpose; a caller
        # that keeps the process alive disarms it
        trainer.disarm_watchdog()
        vec_env.release.set()


def test_main_watchdog_hard_exits_wedged_process():
    """A wedge on the MAIN thread cannot reach sup.check(): the watchdog
    hard-exits the process with STALL_EXIT_CODE."""
    script = """
import threading
from r2d2_tpu_torch.utils.supervision import Supervisor
sup = Supervisor(heartbeat_timeout=0.2, stall_fatal_timeout=1.0, main_stall_headroom=0.0)
sup.start_main_watchdog()
sup.main_beat()
threading.Event().wait()  # the main thread wedges: no further beats
"""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=60, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == STALL_EXIT_CODE, proc.stderr
    assert "MAIN thread stalled" in proc.stderr
    assert time.time() - t0 < 60
