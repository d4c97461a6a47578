"""The port's profiler hooks (r2d2_tpu_torch/utils/profiling.py), as
tests/test_profiling.py holds the JAX package's: spans are free when idle,
show in a trace when one runs (from any thread), a bounded trace lands on
disk, and the trainer's --profile-dir writes one with the update spans.
TransferTimer keeps the JAX package's accumulators and stats() keys."""

import glob
import json
import os
import threading
import time

import torch

from r2d2_tpu_torch.utils.profiling import (
    TransferTimer,
    span,
    start_trace,
    step_span,
    stop_trace,
    trace_to,
)

torch.set_num_threads(1)


def test_spans_are_noops_when_idle():
    with span("replay/sample"):
        x = torch.ones(4) + 1
    with step_span("learner_update", 3):
        y = x * 2
    assert float(y.sum()) == 16.0


def test_trace_to_writes_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace_to(d):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(os.path.join(d, "**", "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files), "no trace artifacts written"


def test_trace_to_none_is_disabled(tmp_path):
    with trace_to(None):
        torch.ones(2)


def test_spans_from_worker_threads_reach_the_trace(tmp_path):
    prof = start_trace()

    def worker():
        with span("replay/sample"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    with step_span("learner_update", 0):
        torch.ones(8)
    path = stop_trace(prof, str(tmp_path), "t")
    names = {e.key for e in prof.key_averages()}
    assert {"learner_update", "replay/sample"} <= names
    events = json.load(open(path))["traceEvents"]
    assert {"learner_update", "replay/sample"} <= {e.get("name") for e in events}


def test_transfer_timer_accounts_overlap():
    timer = TransferTimer()
    assert timer.overlap_fraction() == 1.0  # nothing staged yet
    with timer.h2d(nbytes=2_000_000):
        time.sleep(0.05)
    with timer.wait():
        time.sleep(0.01)
    s = timer.stats()
    assert set(s) == {"h2d_overlap_fraction", "h2d_seconds", "h2d_wait_seconds", "h2d_chunks",
                      "h2d_gbytes_staged"}
    assert s["h2d_chunks"] == 1 and s["h2d_gbytes_staged"] == 0.002
    assert 0.0 < s["h2d_overlap_fraction"] < 1.0
    assert s["h2d_wait_seconds"] < s["h2d_seconds"]
    timer.reset()
    assert timer.stats()["h2d_chunks"] == 0


def test_trainer_profile_dir(tmp_path):
    from r2d2_tpu_torch.config import tiny_test
    from r2d2_tpu_torch.train import Trainer

    d = str(tmp_path / "prof")
    cfg = tiny_test().replace(env_name="catch", training_steps=4,
                              checkpoint_dir=str(tmp_path / "ckpt"))
    tr = Trainer(cfg, device="cpu", profile_dir=d, profile_steps=2)
    tr.run_inline()
    files = glob.glob(os.path.join(d, "*.json"))
    assert len(files) == 1, "trainer wrote no trace"
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"learner_update", "replay/sample"} <= names
