#!/usr/bin/env python3
"""Time the port's training updates on the card, and its encoder alone,
for this checkout or another: the check of what a change to a layer under
every path costs end to end.

    python3 tools/update_times.py [--root DIR] [--updates N] [--out FILE]

The paths are chip_smoke.py's, with its replay cuts: the atari preset on
catch in bf16 and fp32 (84x84x1, nature encoder, LSTM 512, T=85, B=64;
phases 11 and 5), procgen_impala in bf16 (64x64x3, IMPALA (16, 32, 32);
phase 23) and the multi-task family over keydoor, drift, banditgrid and
catch in bf16 and fp32 (phase 24). For each: N inline updates after the
replay's warmup, the median host ms of an update after the first, the ms
per update over the wall (acting included), the updates' peak device
memory above what was allocated before them; then the encoder alone on one
sampled batch's frames, forward and backward (CUDA events, median of 10
after 2). Prints one JSON line a path, with the card's nvidia-smi line.

`--root DIR` imports r2d2_tpu_torch from DIR (an unpacked `git archive`
of another commit) and builds its kernels there; the configurations are
this checkout's. Run two roots in one call on one card, in turns (A, B,
B, A), and compare the rows there.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_constants():
    """chip_smoke.py of this checkout, for its configuration constants."""
    spec = importlib.util.spec_from_file_location("chip_smoke_constants",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encoder_ms(net, obs, reps=10):
    """Median ms of the encoder's forward and backward over `obs` (B, T,
    H, W, C uint8 on the card), as the update runs it."""
    import torch

    x = obs.reshape(-1, *obs.shape[2:]).to(net.dtype) / 255.0

    def step():
        net.enc.zero_grad(set_to_none=True)
        net.enc(x).float().sum().backward()

    for _ in range(2):
        step()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    net.enc.zero_grad(set_to_none=True)
    return statistics.median(times), x.shape[0]


def row(path, ms, wall_ms, peak, enc, frames):
    return {"path": path, "ms_per_update": ms, "ms_per_update_wall": wall_ms,
            "update_peak_gib": peak, "encoder_fwd_bwd_ms": enc, "encoder_frames": frames}


def trainer_path(path, cfg, n, dev):
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch
    from r2d2_tpu_torch.train import Trainer

    tr = Trainer(cfg.replace(training_steps=n), device=dev)
    tr.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    tr.run_inline()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    ms = statistics.median(s * 1e3 for s in tr.update_seconds[1:])
    ends = tr.update_ends[-n:]
    obs = DeviceBatch.from_sampled(tr.replay.sample_batch(tr.sample_rng), dev).obs
    enc, frames = encoder_ms(tr.state.net, obs)
    return row(path, ms, (ends[-1] - ends[0]) * 1e3 / (n - 1), peak, enc, frames)


def multitask_path(path, cfg, tasks, cap, n, dev):
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch
    from r2d2_tpu_torch.multitask import MultiTaskTrainer

    tr = MultiTaskTrainer(cfg, tasks, device=dev)
    tr.warmup(max_steps_per_task=cap)
    ms, update = [], tr.update

    def timed():
        t = time.perf_counter()
        m = update()  # ends in the priorities' copy to the host
        ms.append((time.perf_counter() - t) * 1e3)
        return m

    tr.update = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    tr.train(n)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    obs = DeviceBatch.from_sampled(tr.draw_stratified()[0], dev).obs
    enc, frames = encoder_ms(tr.state.net, obs)
    return row(path, statistics.median(ms[1:]), wall_ms, peak, enc, frames)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout to import r2d2_tpu_torch from")
    ap.add_argument("--updates", type=int, default=8)
    ap.add_argument("--out", help="append the JSON lines to this file too")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    c = smoke_constants()
    sys.path.insert(0, root)
    import torch
    from r2d2_tpu_torch.config import PRESETS, set_fp32_numerics

    if not torch.cuda.is_available():
        sys.exit("update_times: needs a CUDA device")
    dev = torch.device("cuda")
    set_fp32_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    atari, n = PRESETS["atari"](), args.updates
    runs = (
        lambda: trainer_path("atari bf16", atari.replace(**c.ON_CATCH_BF16), n, dev),
        lambda: trainer_path("atari fp32", atari.replace(**c.ON_CATCH), n, dev),
        lambda: trainer_path("procgen bf16",
                             PRESETS["procgen_impala"]().replace(**c.PROCGEN_CUT), n, dev),
        lambda: multitask_path("multitask bf16", atari.replace(**c.MULTITASK_CUT),
                               c.MULTITASK_TASKS, c.MULTITASK_WARMUP_CAP, n, dev),
        lambda: multitask_path("multitask fp32",
                               atari.replace(**c.MULTITASK_CUT, compute_dtype="float32"),
                               c.MULTITASK_TASKS, c.MULTITASK_WARMUP_CAP, n, dev),
    )
    for run in runs:
        r = dict(run(), root=os.path.relpath(root, HERE), card=card)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
