#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, each on
its own lines; any failure exits non-zero and prints no result:

1. card   the card's name, power limit and SM clock (nvidia-smi).
2. build  the five kernels from r2d2_tpu_torch/csrc with nvcc, in parallel;
          registers, shared memory and spills as ptxas reports them; the
          HMMA (tensor-core) instructions of each form in the built
          library's SASS (cuobjdump -sass): every bf16 form (K1, K2, K3, K4
          and K5) must have some, in every instantiation.
3. check  each kernel against its plain PyTorch version on the card: at the
          atari widths (T=85, B=64, H=512, fp32), at the xl width (H=2048)
          and at ragged small shapes, with seams at 0, mid, T-1 and mixed
          per row; the checkpointed backward at every divisor stride of T,
          with seams on segment boundaries too. The column split of every
          kernel (units per block, grid, threads, k-tile, wh slice pinned
          or streamed) is printed per shape; at the atari widths two
          launches of each must give the same bits (K3: dz, dh0, dc0; K4:
          dz and dWh; K5: dz and dWh at S=5), K4's dz must equal K2's bit
          for bit at the same inputs (the same walk in the same geometry),
          and whether K5's dz equals K2's is printed (not required).
4. train  the main path: Trainer.run_inline at the atari preset's widths
          (84x84x1 frames, nature encoder, hidden 512, burn-in / learning /
          forward 40/40/5, batch 64, fp32) on catch, with only the host
          replay sizes cut. The launch counters are zeroed just before it
          and read just after: every update launches the forward kernel
          twice (online and target unroll) and the seam backward once.
5. agree  one update's loss, priorities, gradient norm and each
          parameter's gradient norm on a sampled batch at those widths,
          through the kernels on the card, against the same update through
          the plain versions on the CPU.
6. arms   the same path under each other backward: backward_arm=fused_dwh,
          backward_arm=ckpt (stride 5) and fused_sequence=False, each with
          its counters zeroed just before and read just after (2 forward
          launches and 1 of the arm's backward kernel per update), and one
          update against the CPU as in phase 5.
7. xl     the atari preset under model preset xl (hidden 2048), fp32, the
          default backward_arm=auto, which resolves to the checkpointed arm
          at stride 85; two updates and their ms per update, and one update
          against the CPU as in phase 5.
8. time   each kernel, its plain version, its bound and, where one PyTorch
          call computes the same function, that call (the cuDNN LSTM
          forward, and its backward for the seamless backward), with CUDA
          events, at the main path's shapes and with the seams of a batch
          the main path sampled; the default arm's backward pair (K2 and
          the hprev^T @ dz matmul) beside K4, as a yardstick; T grid
          barriers alone at the forward's geometry (the column split's
          floor); the forward and the four backwards also at xl, with
          cuDNN's fp32 LSTM forward and backward there (TF32 off); and the
          SM clock read while forward launches are queued.
9. chunks all five kernels with the batch in row chunks, at B=1024, H=512
          and B=256, H=2048 (T=85): against their plain versions, two
          launches each giving the same bits, and their times; the bf16
          forms of K2, K3, K4 and K5 likewise, K4-bf16's dz equal to
          K2-bf16's rounded to bf16.
10. bf16  the bf16 forms of all five kernels against their plain versions
          at the atari and xl widths and at the wide model's batch 96
          (H=1024, B=96), seams 0, mid, T-1 and mixed, K5 at S=5 and
          S=85, two launches each giving the same bits; K4-bf16's dz
          equal to K2-bf16's f32 dz rounded to bf16, bit for bit.
11. train bf16  the atari preset with its own compute dtype (bfloat16) on
          catch: 8 updates, each 2 lstm_fwd_bf16 + 1 lstm_seq_bwd_bf16
          launches, ms per update and peak memory; its xl model, whose
          backward_arm=auto resolves to ("ckpt", 5) in bf16: 2 updates of 2
          lstm_fwd_bf16 + 1 lstm_seq_bwd_ckpt_bf16; precision="bf16"
          (carries stored in bf16): 4 updates. Then the two paths of the
          bf16 forms of K4 and K3: the wide model (hidden 1024) at batch
          96, whose auto resolves to ("fused_dwh", 0) in bf16 (4 updates
          of 2 lstm_fwd_bf16 + 1 lstm_seq_bwd_fused_bf16), the same model
          at backward_arm=default (2 updates, for its peak memory beside
          the fused arm's), backward_arm=fused_dwh at the atari widths and
          fused_sequence=False (4 updates each; 2 lstm_fwd_bf16 + 1
          lstm_bwd_bf16), one update of the wide model with
          fused_sequence=False, and backward_arm=ckpt at the atari widths
          (stride 5; 4 updates of 2 lstm_fwd_bf16 + 1
          lstm_seq_bwd_ckpt_bf16), the second path of K5's bf16 form.
12. agree bf16  one bf16 update on the card against the same update
          through the plain versions on the CPU, and the bf16 update
          against the fp32 update on the card from the same parameters and
          batch (tests/test_precision.py's class: loss within 5%,
          priorities rtol 0.2 / atol 0.05): the main path, the wide model
          at batch 96 (fused_dwh), fused_sequence=False, and both paths of
          K5's bf16 form, ckpt at the atari widths and xl.
13. time bf16  each bf16 form, its plain version, its bounds (the bytes,
          and the operations at the fp32 FMA peak and at the bf16 tensor
          cores' dense peak) and cuDNN's LSTM forward and backward in bf16
          where torch takes them, at the atari widths, at the wide model's
          batch 96 and at xl; beside K4-bf16 the bf16 default arm's pair
          (K2-bf16 and the hprev^T @ dz matmul). Every bf16 form runs its
          products on the tensor cores.

14. e2e   the main path through the entry points a user calls, with
          checkpoints and a metrics file (log_interval 0): the atari preset
          in its own bf16 through Trainer.run_threaded (actor and sampler
          threads, batches staged through pinned memory), 12 updates of 2
          lstm_fwd_bf16 + 1 lstm_seq_bwd_bf16 (counts zeroed just before
          and read just after), checkpoints [6, 12], 12 finite metrics
          records; Trainer(resume=True) restores step, networks and Adam
          state bit for bit; evaluate_series over both checkpoints on 8
          catch envs, its rows printed. Then fp32 through run_inline: 8
          updates, checkpoints [4, 8].
15. modes ms per learner update over the wall (acting and sampling
          included) of run_inline and run_threaded on the bf16 and the
          fp32 main path (threaded also with samples_per_insert set so
          that it acts as much per update as inline; each threaded run
          with its batches staged through the pinned ring, and again with
          the sampler copying them from pageable memory through
          DeviceBatch.from_sampled, as inline does; inline and threaded
          also with use_native_replay=False, the numpy gathers, beside the
          native core's), env steps per update, the updates' peak device
          memory, and in threaded mode TransferTimer's overlap fraction,
          h2d and wait seconds; then 6 more updates under
          torch.profiler (inline and threaded, native and numpy, always;
          the other rows with --profile): the device's busy share and the
          host time under the spans replay/sample and learner_update, the
          rest of the wall beside them. Printed, not held to a limit.
16. odd    hidden 510 (a multiple of neither 4 nor 8) in fp32 and bf16: one
          update of 2 forward + 1 seam backward launches at 512 units (the
          model pads zero units), against the CPU as in phases 5 and 12.

The script's wall time is printed last among the phases. The
next-to-last lines are the kernels as one JSON object (each form with
the unit its products run on: "tensor_cores" or "fma") and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile N

adds N more updates of the main path (fp32, then bf16), of the wide
model at batch 96 (bf16, fused_dwh) and of bf16 xl (ckpt, 5) under
torch.profiler after the last phase and prints where their device time
goes, by kernel, and the device's busy share.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (NVIDIA H100 SXM data sheet): float32 outside
# the tensor cores, bf16 on the tensor cores (dense), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel vs plain version: both float32, dot products summed in other
# orders, differences carried through T recurrent steps
ATOL = 1e-4
RTOL = 1e-4
# dWh summed in the kernel (per column slice; K4 over (t, b), K5 segments
# newest first) against the plain version's per-step matmuls: each entry
# sums T*B products of both signs, so the error is held against the
# largest entry, not entry by entry
DWH_TOL = 1e-4
# a bf16 kernel form vs its plain version: both sum exact products of bf16
# values in float32 in other orders, so a value can round to the
# neighbouring bf16 value (2^-8 relative) where the two sums straddle a
# rounding boundary, and that step feeds the later steps
BF16_ATOL = 2e-2
BF16_RTOL = 2e-2
BF16_DWH_TOL = 1e-2
# one bf16 update on the card vs the same on the CPU: the same casts, the
# encoder's and heads' bf16 products summed in other orders
BF16_AGREE = dict(rtol=1e-2, atol=1e-3)

UPDATES = 8
ARM_UPDATES = 4
XL_UPDATES = 2
PRECISION_UPDATES = 4
# the atari preset on catch, with only the host replay sizes cut from the
# preset's 2,000,000 and 50,000; ON_CATCH trains in fp32, ON_CATCH_BF16 in
# the preset's own bfloat16
ON_CATCH_BF16 = dict(env_name="catch", buffer_capacity=16_000, learning_starts=2_000)
ON_CATCH = dict(ON_CATCH_BF16, compute_dtype="float32")
# phase 14: (updates, save_interval) of the end-to-end runs through the
# entry points, bf16 threaded and fp32 inline
E2E = {"bf16": (12, 6), "fp32": (8, 4), "long_context bf16": (4, 2),
       "long_context fp32": (4, 2)}
# phase 15: learner updates timed per mode, after 2 that warm the path, and
# the updates profiled after them (processing the trace of each costs time)
MODE_UPDATES = 24
PROFILED_UPDATES = 6
# phase 16: a hidden size that is a multiple of neither 4 nor 8
ODD_HIDDEN = 510
# phase 17: batches compared bit for bit, and timed, native against numpy
NATIVE_COMPARES = 5
NATIVE_TIMED = 20
# phase 18: the long_context preset with only the host replay sizes cut
# (2,048,000 -> 16 blocks of 1024; 50,000 -> 6,144 transitions, eight
# 768-step episodes); inline updates, updates held against the CPU one by
# one (fp32), and the chunk of the chunked LRU form
LONG_CONTEXT_CUT = dict(buffer_capacity=16_384, learning_starts=6_144)
LC_UPDATES = 4
LC_AGREE = 2
LC_CHUNK = 128
# the row-chunk shapes of phase 9: twice the rows a block holds at once
CHUNKED = ((85, 1024, 512), (85, 256, 2048))
# the wide model preset's hidden size, and the batch at which its
# backward_arm=auto resolves to ("fused_dwh", 0) in bf16 (the default arm's
# 133.7 MB of f32 dz over the 128 MiB budget, the fused arm's bf16 dz under)
WIDE_H = 1024
WIDE_BATCH = 96
T0 = time.perf_counter()


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def say(phase, msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase:6s} {msg}", flush=True)


def smi(query):
    """nvidia-smi's csv line for card 0 and the given fields."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_line():
    return smi("name,power.limit")


def hmma_counts(libraries):
    """{kernel form: [HMMA instructions of each instantiation]} in the SASS
    of the built libraries ({source: path}), by cuobjdump."""
    import re

    from r2d2_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    counts = {}
    for src, path in libraries.items():
        out = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                             timeout=120)
        if out.returncode != 0:
            fail(f"cuobjdump -sass {path} failed: {out.stderr.strip()[:300]}")
        for function in out.stdout.split("Function : ")[1:]:
            name = function.split("\n", 1)[0]
            for dtype, form in (("I13__nv_bfloat16", f"{src}_bf16"), ("If", src)):
                if f"{src}_kernel{dtype}" in name:
                    counts.setdefault(form, []).append(len(re.findall(r"\bHMMA\b", function)))
    return counts


def median_ms(fn, reps=15, flush=None):
    """Median of `reps` timed calls (CUDA events), after warm-up; `flush`
    runs untimed before each call so the call finds a cold L2."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want):
    """(max |got - want|, whether every element is within ATOL + RTOL*|want|)."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= ATOL + RTOL * want.abs()).all())


def dwh_err(got, want):
    """(max |got - want|, whether it is within DWH_TOL * max |want|)."""
    diff = float((got - want).abs().max())
    return diff, diff <= DWH_TOL * float(want.abs().max())


def drive(cfg, updates, dev):
    """Build a Trainer on cfg, fill its replay, then zero the launch counts,
    run `updates` updates and read the counts. -> (trainer, launches,
    metrics, host ms per update, the updates' peak device memory in GiB
    above what was allocated before them: activations, residuals and
    kernel workspaces, without parameters or optimizer state)."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer

    tr = Trainer(cfg.replace(training_steps=updates), device=dev)
    tr.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    tr.run_inline()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts.items() if v}
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    m = tr.metrics()
    if m["step"] != updates or not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        fail(f"training did not finish with a finite loss: {m}")
    return tr, launches, m, [s * 1e3 for s in tr.update_seconds], peak


def one_update(net, target, cfg, sampled, where):
    """(loss, priorities, gradient norm, each parameter's gradient norm) of
    one update of `net` on a sampled batch, on `where`, without stepping
    the optimizer."""
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch, make_loss_fn

    net = copy.deepcopy(net).to(where)
    net.zero_grad(set_to_none=True)
    target = copy.deepcopy(target).to(where)
    b = DeviceBatch.from_sampled(sampled, where)
    denom = torch.clamp(b.learning_steps.sum().float(), min=1.0)
    loss, (prio, _) = make_loss_fn(cfg)(net, target, b, denom)
    loss.backward()
    norms = torch.stack([p.grad.float().norm() for p in net.parameters()])
    return [x.detach().cpu() for x in (loss, prio, norms.norm(), norms)]


def agree(tr, label, rtol=1e-4, atol=1e-5):
    """One update on a sampled batch through the kernels on the card against
    the same update through the plain versions on the CPU; -> the batch."""
    import torch

    sampled = tr.replay.sample_batch(tr.sample_rng)
    t = time.perf_counter()
    results = {where: one_update(tr.state.net, tr.state.target_net, tr.cfg, sampled, where)
               for where in ("cuda", "cpu")}
    for name, a, b in zip(("loss", "priorities", "grad_norm", "grad_norm per parameter"),
                          results["cuda"], results["cpu"]):
        diff = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            fail(f"{label}: {name} through the kernels differs from the CPU's plain "
                 f"versions: {diff:.3e}")
        say("agree", f"{label} {name}: card {a.flatten()[0].item():.6f} vs cpu "
            f"{b.flatten()[0].item():.6f} (max |diff| {diff:.3e}, rtol {rtol} atol {atol})")
    say("agree", f"{label}: {len(sampled.idxes)} rows, {time.perf_counter() - t:.1f}s")
    return sampled


# the trainer's host spans (utils/profiling.py); the profiler also shows
# each as a device-side annotation over the kernels it launched
SPANS = ("replay/sample", "learner_update")


def device_us(e):
    """A profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(events):
    """The device's own events (kernels, copies, memsets) of key_averages():
    not the span annotations, whose time is their kernels' again."""
    return [e for e in events if str(e.device_type).endswith("CUDA") and e.key not in SPANS
            and device_us(e) > 0]


def span_ms(events):
    """{span: (host ms, device ms)} summed over key_averages()."""
    out = {k: [0.0, 0.0] for k in SPANS}
    for e in events:
        if e.key in SPANS:
            cuda = str(e.device_type).endswith("CUDA")
            out[e.key][cuda] += (device_us(e) if cuda else e.cpu_time_total) / 1e3
    return out


def profile_updates(tr, n, label):
    """Run n more updates of a path under torch.profiler; print the device
    time by kernel name and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr.cfg = tr.cfg.replace(training_steps=tr.cfg.training_steps + n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        tr.run_inline()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    # device-side events only (kernels, copies, memsets): the operators that
    # launch them report the same time again as their own
    events = prof.key_averages()
    rows = sorted(((device_us(e), e.count, e.key) for e in device_events(events)), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    say("prof", f"{label}: {n} updates (actor steps included) in {wall_ms:.1f} ms wall; device busy "
        f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}; per "
        "update, host and device ms under each span: " + ", ".join(
            f"{k} {h / n:.2f} / {d / n:.2f}" for k, (h, d) in span_ms(events).items()))
    for us, count, key in rows[:16]:
        say("prof", f"{us / 1e3 / n:9.3f} ms/update {us / 1e3 / busy_ms:6.1%} x{count // n:<4d} "
            f"{key[:90]}")


def states_equal(a, b):
    """Whether two TrainStates hold the same step and every tensor of their
    networks and optimizer state bit for bit."""
    import torch

    if a.step != b.step:
        return False
    for x, y in ((a.net, b.net), (a.target_net, b.target_net)):
        sx, sy = x.state_dict(), y.state_dict()
        if list(sx) != list(sy) or not all(torch.equal(sx[k], sy[k]) for k in sx):
            return False
    ox, oy = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return bool(ox) and set(ox) == set(oy) and all(
        torch.equal(v, oy[i][k]) for i in ox for k, v in ox[i].items())


def e2e(label, cfg, mode, dev, tmp, expect=None):
    """A path through the entry points a user calls: train with
    checkpoints and a metrics file (run_threaded or run_inline), resume
    from the last checkpoint, evaluate the checkpoint series. The launch
    counts are zeroed just before the run and read just after: by default
    2 forward and 1 seam backward launches an update; `expect(updates)`
    gives another path's."""
    import torch
    from r2d2_tpu_torch.envs.catch import CatchVecEnv, catch_params
    from r2d2_tpu_torch.evaluate import evaluate_series
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps

    updates, every = E2E[label]
    cfg = cfg.replace(training_steps=updates, save_interval=every, log_interval=0.0,
                      checkpoint_dir=os.path.join(tmp, f"{label}_ckpt"),
                      metrics_path=os.path.join(tmp, f"{label}.jsonl"))
    t = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    tr.warmup()
    K.reset_launch_counts()
    t_run = time.perf_counter()
    (tr.run_threaded if mode == "threaded" else tr.run_inline)()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {k: v for k, v in K.launch_counts.items() if v}
    tr.metrics_logger.close()
    sfx = "_bf16" if cfg.resolved_compute_dtype == "bfloat16" else ""
    want = expect(updates) if expect else {f"lstm_fwd{sfx}": 2 * updates,
                                           f"lstm_seq_bwd{sfx}": updates}
    if launches != want:
        fail(f"e2e {label} {mode}: expected the launches {want}, got {launches}")
    steps = list_checkpoint_steps(cfg.checkpoint_dir)
    if steps != list(range(every, updates + 1, every)):
        fail(f"e2e {label} {mode}: checkpoints {steps}")
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    recs = [r for r in recs if "loss" in r]
    if [r["step"] for r in recs] != list(range(1, updates + 1)) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["q_mean"]) for r in recs):
        fail(f"e2e {label} {mode}: the metrics file holds {len(recs)} update records, "
             f"expected {updates} finite ones")
    say("e2e", f"{label} {mode}: {updates} updates in {t_run:.2f}s after warmup "
        f"({time.perf_counter() - t:.1f}s with it), launches {launches}, checkpoints "
        f"{steps}, {len(recs)} metrics records, last {json.dumps(recs[-1])}")
    resumed = Trainer(cfg, device=dev, resume=True)
    if not states_equal(resumed.state, tr.state):
        fail(f"e2e {label}: the resumed TrainState differs from the trained one")
    say("e2e", f"{label}: Trainer(resume=True) restored step {resumed.state.step}, online and "
        f"target nets and the Adam state bit for bit on the card; env steps carried "
        f"{resumed.env_steps_offset}")
    del resumed
    t = time.perf_counter()
    rows = evaluate_series(tr.cfg, CatchVecEnv(8, cfg.obs_shape[0], cfg.obs_shape[1], seed=123,
                                               **catch_params(cfg.env_name)), device=dev)
    if [r["step"] for r in rows] != steps or not all(math.isfinite(r["mean_reward"])
                                                       for r in rows):
        fail(f"e2e {label}: evaluation rows {rows}")
    say("e2e", f"{label}: evaluate_series over {steps} on 8 catch envs in "
        f"{time.perf_counter() - t:.1f}s")
    return tr


def modes(label, cfg, dev, profile):
    """ms per learner update over the wall, acting and sampling included,
    of run_inline and run_threaded (free-running actors, and throttled by
    samples_per_insert to inline's env steps per update; each with the
    batches staged through the pinned ring, and "pageable": the sampler's
    batches copied by DeviceBatch.from_sampled on its thread; inline and
    threaded also with the numpy replay gathers, use_native_replay=False,
    beside the native core's) on one path: after
    2 updates that warm it, MODE_UPDATES more, timed from the end of the
    first to the end of the last (the steady state; run_ms_per_update is
    the whole run's wall, the threads' start and stop included); TransferTimer's overlap, h2d and wait seconds;
    the updates' peak device memory above what was allocated before them
    (in threaded mode with the queued batches). Then PROFILED_UPDATES more
    under torch.profiler (for inline and threaded mode always, native and
    numpy; for the other rows with `profile`): the device's busy share and
    the host time under each span."""
    import torch
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.profiling import start_trace

    out = {}
    # the samples_per_insert at which threaded mode acts as much per update
    # as inline mode (one actor step of num_actors env steps per update)
    matched = cfg.batch_size * cfg.learning_steps / cfg.num_actors
    for mode, spi, native in (
            ("inline", 0.0, True), ("threaded", 0.0, True), ("threaded pageable", 0.0, True),
            ("threaded", matched, True), ("threaded pageable", matched, True),
            ("inline", 0.0, False), ("threaded", 0.0, False)):
        tr = Trainer(cfg.replace(training_steps=2, samples_per_insert=spi,
                                 use_native_replay=native), device=dev)
        if mode == "threaded pageable":
            tr._sample_staged = tr.sample  # the sampler copies as inline mode does
        run = tr.run_inline if mode == "inline" else tr.run_threaded
        run()
        # inline and threaded mode, with the native core and with numpy, are
        # always profiled too: the host time under replay/sample and the
        # device's busy share
        profiled = profile or (not spi and mode in ("inline", "threaded"))
        if spi:
            mode = f"{mode} spi={spi:g}"
        if not native:
            mode = f"{mode} numpy"
        row = {"path": label, "mode": mode}
        for phase in ("timed", "profiled") if profiled else ("timed",):
            n = MODE_UPDATES if phase == "timed" else PROFILED_UPDATES
            tr.cfg = tr.cfg.replace(training_steps=tr.cfg.training_steps + n)
            tr.xfer.reset()
            acted = tr.actor.total_steps
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            prof = start_trace() if phase == "profiled" else None
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if prof is None:
                ends = tr.update_ends[-MODE_UPDATES:]
                row.update(ms_per_update=(ends[-1] - ends[0]) * 1e3 / (MODE_UPDATES - 1),
                           run_ms_per_update=wall_ms / MODE_UPDATES,
                           env_steps_per_update=(tr.actor.total_steps - acted) / MODE_UPDATES,
                           peak_gib=(torch.cuda.max_memory_allocated() - before) / 2**30,
                           **(tr.xfer.stats() if run == tr.run_threaded else {}))
                continue
            prof.__exit__(None, None, None)
            events = prof.key_averages()
            busy = sum(device_us(e) for e in device_events(events)) / 1e3
            row.update(profiled_ms_per_update=wall_ms / n, device_busy=busy / wall_ms)
            for k, (host, device) in span_ms(events).items():
                row[f"{k}_host_ms_per_update"] = host / n
                row[f"{k}_device_ms_per_update"] = device / n
            # inline: the actor's share; threaded: the spans overlap on
            # their threads, and this is what the main thread's span leaves
            row["rest_ms_per_update"] = row["profiled_ms_per_update"] - sum(
                row[f"{k}_host_ms_per_update"] for k in SPANS)
        say("modes", json.dumps(row))
        out[mode] = row
        del tr
    say("modes", f"{label}: ms per update over the wall of {MODE_UPDATES} updates, acting "
        "included (env steps per update): " + ", ".join(
            f"{m} {r['ms_per_update']:.2f} ({r['env_steps_per_update']:.1f})"
            for m, r in out.items()))
    say("modes", f"{label}: replay/sample host ms per update and the device's busy share, "
        "profiled: " + ", ".join(
            f"{m} {r['replay/sample_host_ms_per_update']:.2f} ms, {r['device_busy']:.1%}"
            for m, r in out.items() if "device_busy" in r))
    return out


def openmp_runtimes():
    """The OpenMP runtime libraries (GNU, LLVM or Intel) mapped into this
    process."""
    import re

    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if line.strip()}
    return sorted(p for p in paths if re.match(r"lib(g|i|)omp", os.path.basename(p)))


def native_phase(tr):
    """The native replay core at the main path's shapes: a numpy ReplayBuffer
    given the trainer's replay contents (every store, the sum tree and the
    ring's counters) and both sampled with equal Generator streams must give
    the same batches bit for bit; then both sample_batch host times, the
    gather's OpenMP threads and the OpenMP runtimes in the process (torch's
    and the core's)."""
    import numpy as np
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    native = tr.replay
    if native.native is None:
        fail("native: the main path's replay does not run the native core")
    numpy_rb = ReplayBuffer(tr.cfg.replace(use_native_replay=False))
    for k, v in vars(native).items():
        if isinstance(v, np.ndarray):
            setattr(numpy_rb, k, v.copy())
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            setattr(numpy_rb, k, v)
    numpy_rb.tree.tree[:] = native.tree.tree
    for seed in range(NATIVE_COMPARES):
        a = native.sample_batch(np.random.default_rng(seed))
        b = numpy_rb.sample_batch(np.random.default_rng(seed))
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            same = (np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
                    if isinstance(x, np.ndarray) else x == y)
            if not same:
                fail(f"native: sample_batch's {f.name} differs from the numpy path's (seed {seed})")
    times = {}
    for label, rb in (("native", native), ("numpy", numpy_rb)):
        rng = np.random.default_rng(0)
        ts = []
        for _ in range(NATIVE_TIMED):
            t = time.perf_counter()
            rb.sample_batch(rng)
            ts.append((time.perf_counter() - t) * 1e3)
        times[label] = statistics.median(ts)
    c = tr.cfg
    say("native", f"{NATIVE_COMPARES} batches at B={c.batch_size} T={c.seq_len} obs "
        f"{c.obs_shape} ({c.batch_size * c.seq_len * math.prod(c.obs_shape) / 1e6:.1f} MB of "
        f"frames) equal the numpy path's bit for bit; sample_batch host ms, median of "
        f"{NATIVE_TIMED}: native {times['native']:.2f}, numpy {times['numpy']:.2f}; the gather "
        f"runs {native.native.gather_threads()} OpenMP threads; OpenMP runtimes in the "
        f"process: {openmp_runtimes()}")


def long_context_phase(dev, tmp):
    """The long_context preset at full width (memory_catch:10:8:4 at 26x26,
    IMPALA (8, 16), LRU hidden 128, T=581, B=64) as it ships (bf16) and in
    float32: LC_UPDATES inline updates (no LSTM kernel may launch), ms per
    update, the update's peak memory and the LRU core's own, the wall per
    update over acting and sampling; agreement with the CPU (float32: the
    same LC_AGREE updates stepped on both, update for update; bf16: one
    update); lru_chunk=128: one update that agrees with the scan form on the
    same batch; then e2e (checkpoints, bitwise resume, evaluate_series).
    Only the host replay sizes are cut."""
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.learner import DeviceBatch, make_optimizer, make_train_step
    from r2d2_tpu_torch.models.r2d2 import R2D2Network

    for label, extra, tol in (("bf16", {}, BF16_AGREE),
                              ("fp32", {"compute_dtype": "float32"}, {})):
        cfg = PRESETS["long_context"]().replace(**LONG_CONTEXT_CUT, **extra)
        t = time.perf_counter()
        tr, launches, m, ms, peak = drive(cfg, LC_UPDATES, dev)
        ends = tr.update_ends
        wall = (ends[-1] - ends[0]) * 1e3 / (len(ends) - 1)
        c = tr.cfg
        say("long", f"{label}: {c.env_name} obs {c.obs_shape}, {c.encoder} "
            f"{c.impala_channels}, {c.recurrent_core} hidden {c.hidden_dim}, T={c.seq_len} "
            f"({c.burn_in_steps}/{c.learning_steps}/{c.forward_steps}), batch {c.batch_size}, "
            f"{c.resolved_compute_dtype}, cosine lr, arm {tr.backward_arm}; cut: "
            f"buffer_capacity {c.buffer_capacity} (preset 2048000), learning_starts "
            f"{c.learning_starts} (preset 50000); {LC_UPDATES} updates, loss {m['loss']:.6f}; "
            f"ms/update {', '.join(f'{v:.1f}' for v in ms)} (host clock); wall per update "
            f"over acting and sampling {wall:.1f} ms; update peak device memory {peak:.3f} GiB; "
            f"LSTM kernel launches {launches} ({time.perf_counter() - t:.1f}s with warmup)")
        if launches:
            fail(f"long_context {label}: the LRU path launched LSTM kernels: {launches}")
        if c.resolved_compute_dtype != ("bfloat16" if label == "bf16" else "float32"):
            fail(f"long_context {label}: compute dtype {c.resolved_compute_dtype}")
        say("long", f"{label}: the LRU core alone (forward and backward, B={c.batch_size} "
            f"T={c.seq_len}): peak {lru_core_peak(tr, dev):.3f} GiB above its inputs")

        # the CPU, update for update (bf16: one update)
        if label == "fp32":
            states = {}
            for where in ("cuda", "cpu"):
                s_ = copy.deepcopy(tr.state)
                for net in (s_.net, s_.target_net):
                    net.to(where)
                s_.optimizer = make_optimizer(c, s_.net.parameters())
                s_.optimizer.load_state_dict(tr.state.optimizer.state_dict())
                states[where] = s_
            step = make_train_step(c)
            for i in range(LC_AGREE):
                sampled = tr.replay.sample_batch(tr.sample_rng)
                res = {w: step(states[w], DeviceBatch.from_sampled(sampled, w))
                       for w in states}
                for name, a, b in (("loss", res["cuda"][1]["loss"], res["cpu"][1]["loss"]),
                                   ("priorities", res["cuda"][2], res["cpu"][2])):
                    a, b = a.detach().cpu(), b.detach()
                    diff = float((a - b).abs().max())
                    if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                        fail(f"long_context fp32 update {i + 1}: {name} on the card differs "
                             f"from the CPU's: {diff:.3e}")
                    say("agree", f"long_context fp32 update {i + 1} {name}: max |card - cpu| "
                        f"{diff:.3e} (rtol 1e-4 atol 1e-5)")
            for (name, a), b in zip(states["cuda"].net.state_dict().items(),
                                    states["cpu"].net.state_dict().values()):
                if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5):
                    fail(f"long_context fp32: parameter {name} after {LC_AGREE} updates "
                         f"differs: {float((a.cpu() - b).abs().max()):.3e}")
            say("agree", f"long_context fp32: every parameter after {LC_AGREE} updates within "
                "rtol 1e-4 atol 1e-5 of the CPU's")
            del states
        else:
            agree(tr, "long_context bf16", **tol)

        # lru_chunk=128: one update on the card against the scan form
        k_cfg = c.replace(lru_chunk=LC_CHUNK, training_steps=1)
        k_tr, k_launches, k_m, k_ms, k_peak = drive(k_cfg, 1, dev)
        if k_launches:
            fail(f"long_context {label} lru_chunk: LSTM kernel launches {k_launches}")
        sampled = tr.replay.sample_batch(tr.sample_rng)
        res = {}
        for form, f_cfg in (("scan", c), ("chunk", k_cfg)):
            nets = []
            for src in (tr.state.net, tr.state.target_net):
                n = R2D2Network.from_config(f_cfg, device=dev)
                n.load_state_dict(src.state_dict())
                nets.append(n)
            res[form] = one_update(*nets, f_cfg, sampled, "cuda")
        rt = tol.get("rtol", 1e-4)
        at = tol.get("atol", 1e-5)
        for name, a, b in zip(("loss", "priorities", "grad_norm", "grad_norm per parameter"),
                              res["chunk"], res["scan"]):
            diff = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=rt, atol=at):
                fail(f"long_context {label}: lru_chunk={LC_CHUNK}'s {name} differs from the "
                     f"scan form's: {diff:.3e}")
        say("long", f"{label} lru_chunk={LC_CHUNK}: 1 update {k_ms[0]:.1f} ms, peak "
            f"{k_peak:.3f} GiB; one update on a sampled batch agrees with the scan form "
            f"(loss {float(res['chunk'][0]):.6f} vs {float(res['scan'][0]):.6f}; rtol {rt} "
            f"atol {at})")
        del k_tr

        e2e(f"long_context {label}", cfg, "inline", dev, tmp, expect=lambda n: {})
        del tr


def lru_core_peak(tr, dev):
    """Peak device memory (GiB) of one forward and backward of a trainer's
    LRU core alone, on a batch of its width and length, above its inputs."""
    import torch

    c = tr.cfg
    core = copy.deepcopy(tr.state.net.core)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(c.batch_size, c.seq_len, core.in_dim, device=dev, generator=g)
    x = x.to(c.torch_compute_dtype).requires_grad_(True)
    carry = (torch.zeros(c.batch_size, c.hidden_dim, device=dev),) * 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    outs, _ = core(x, carry)
    outs.float().sum().backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**30


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="profile N more updates of the main path after the checks")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        from r2d2_tpu_torch.config import PRESETS, apply_model_preset, set_fp32_numerics
        from r2d2_tpu_torch.models.r2d2 import R2D2Network
        from r2d2_tpu_torch.ops import _build, lstm_kernel as K
    except ImportError as e:
        fail(f"the r2d2_tpu_torch package must sit beside this script ({e})")
    dev = torch.device("cuda")
    set_fp32_numerics()

    # 1. card ---------------------------------------------------------------
    card = card_line()
    say("card", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    say("card", f"SM clock now, max: {smi('clocks.sm,clocks.max.sm')}")

    # 2. build --------------------------------------------------------------
    t = time.perf_counter()
    names = _build.sources()
    libraries = _build.build(names)
    say("build", f"nvcc built {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("build", f"{name}: {line.strip()[:160]}")
    hmma = hmma_counts(libraries)
    say("build", "HMMA instructions per instantiation (one chunk, row chunks): " + ", ".join(
        f"{k} {v}" for k, v in sorted(hmma.items())))
    for src in K.TENSOR_CORE:
        if not hmma.get(f"{src}_bf16") or min(hmma[f"{src}_bf16"]) == 0:
            fail(f"{src}_bf16 runs no tensor-core instruction: {hmma.get(f'{src}_bf16')}")

    def unit(name):
        """The unit a kernel form's products run on."""
        return ("tensor_cores" if K.tensor_cores(K._SOURCE[name], 2 if name in K.BF16_FORMS else 4)
                else "fma")

    # 3. kernels against plain versions ------------------------------------
    errs = dict.fromkeys(K.KERNELS, 0.0)

    def hold(name, got, want, where):
        e, ok = max_err(got, want)
        errs[name] = max(errs[name], e)
        if not ok:
            fail(f"{name} disagrees with its plain version {where}: {e:.3e}")

    def hold_dwh(name, got, want, where):
        e, ok = dwh_err(got, want)
        errs[name] = max(errs[name], e)
        if not ok:
            fail(f"{name}: dWh off by {e:.3e} {where}, over {DWH_TOL} x max|dWh| "
                 f"{float(want.abs().max()):.3e}")

    def zero_below(name, dz, burn, where):
        below = torch.arange(dz.shape[0], device=dev)[:, None] < burn[None, :].long()
        if dz[below].any():
            fail(f"{name}: nonzero dz below the seam {where}")

    def check(T, B, H, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        s = H ** -0.5
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g)
        wh = (torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * s
        h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        at = f"at T={T} B={B} H={H}"
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        for got, want in zip((outs, cs), K.lstm_fwd_plain(proj, wh, h0, c0)):
            hold("lstm_fwd", got, want, at)
        hprev = torch.cat([h0[None], outs[:-1]])
        cprev = torch.cat([c0[None], cs[:-1]])
        dout = torch.randn(T, B, H, device=dev, generator=g)
        dcT = torch.randn(B, H, device=dev, generator=g)
        walk = (dout, proj, hprev, cprev, cs, wh, dcT)
        # the seamless backward: dz and the initial state's cotangents
        for got, want in zip(K.lstm_bwd(*walk), K.lstm_bwd_plain(*walk)):
            hold("lstm_bwd", got, want, at)
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        seams = (("0", torch.zeros_like(mixed)), ("mid", torch.full_like(mixed, T // 2)),
                 ("T-1", torch.full_like(mixed, T - 1)), ("mixed", mixed))
        for label, burn in seams:
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold("lstm_seq_bwd", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            p_dz, p_dwh = K.lstm_seq_bwd_fused_plain(*walk, burn)
            hold("lstm_seq_bwd_fused", f_dz, p_dz, where)
            hold_dwh("lstm_seq_bwd_fused", f_dwh, p_dwh, where)
            zero_below("lstm_seq_bwd_fused", f_dz, burn, where)
        strides = [S for S in range(1, T + 1) if T % S == 0]
        for S in strides:
            # one more seam kind: every row's seam on a segment boundary
            boundary = torch.randint(0, T // S, (B,), device=dev, generator=g,
                                     dtype=torch.int32) * S
            h_ckpt = torch.cat([h0[None], outs[S - 1 : T - 1 : S]])
            c_ckpt = torch.cat([c0[None], cs[S - 1 : T - 1 : S]])
            for label, burn in (*seams, ("boundary", boundary)):
                args = (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
                k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*args)
                p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*args)
                where = f"{at} S={S} seam {label}"
                hold("lstm_seq_bwd_ckpt", k_dz, p_dz, where)
                hold_dwh("lstm_seq_bwd_ckpt", k_dwh, p_dwh, where)
                zero_below("lstm_seq_bwd_ckpt", k_dz, burn, where)
        if (T, B, H) == (85, 64, 512):
            # no float atomics: two launches give the same bits
            again = K.lstm_fwd(proj, wh, h0, c0)
            if not (torch.equal(outs, again[0]) and torch.equal(cs, again[1])):
                fail(f"lstm_fwd: two launches differ {at}")
            seam_dz = K.lstm_seq_bwd(*walk, mixed)
            if not torch.equal(seam_dz, K.lstm_seq_bwd(*walk, mixed)):
                fail(f"lstm_seq_bwd: two launches differ {at}")
            if not all(map(torch.equal, K.lstm_bwd(*walk), K.lstm_bwd(*walk))):
                fail(f"lstm_bwd: two launches differ (dz, dh0 or dc0) {at}")
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, mixed)
            again = K.lstm_seq_bwd_fused(*walk, mixed)
            if not (torch.equal(f_dz, again[0]) and torch.equal(f_dwh, again[1])):
                fail(f"lstm_seq_bwd_fused: two launches differ (dz or dWh) {at}")
            # the same walk in the same geometry: the same dz
            if not torch.equal(f_dz, seam_dz):
                fail(f"lstm_seq_bwd_fused: dz differs from lstm_seq_bwd's {at} seam mixed "
                     f"(max |diff| {float((f_dz - seam_dz).abs().max()):.3e})")
            S = 5
            args = (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                    torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, dcT, mixed, S)
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*args)
            again = K.lstm_seq_bwd_ckpt(*args)
            if not (torch.equal(k_dz, again[0]) and torch.equal(k_dwh, again[1])):
                fail(f"lstm_seq_bwd_ckpt: two launches differ (dz or dWh) {at} S={S}")
            say("check", f"{at}: two launches each of lstm_fwd, lstm_seq_bwd, lstm_bwd, "
                f"lstm_seq_bwd_fused and lstm_seq_bwd_ckpt (S={S}) give identical bits; "
                f"lstm_seq_bwd_fused's dz equals lstm_seq_bwd's bit for bit, seam mixed")
            same = torch.equal(k_dz, seam_dz)
            say("check", f"{at}: lstm_seq_bwd_ckpt's dz (S={S}) {'equals' if same else 'differs from'}"
                f" lstm_seq_bwd's bit for bit at the same inputs, seam mixed (max |diff| "
                f"{float((k_dz - seam_dz).abs().max()):.3e}; not required)")
        torch.cuda.synchronize()
        say("check", f"T={T} B={B} H={H}: all five kernels (seams 0, mid, T-1, mixed; ckpt "
            f"at S in {strides}, plus seams on segment boundaries) within atol {ATOL} + rtol "
            f"{RTOL}, dWh within {DWH_TOL} x max|dWh|")

    for i, shape in enumerate(((7, 5, 32), (13, 67, 96), (3, 2, 640), (85, 64, 512),
                               (85, 64, 2048))):
        for kernel in K.COLUMN_SPLIT:
            say("check", f"T={shape[0]} B={shape[1]} H={shape[2]}: {kernel} column split "
                f"{K._geometry(shape[1], shape[2], kernel, dev)}")
        check(*shape, seed=i)
    say("check", "max |kernel - plain| (dz, dh0/dc0 and dWh alike): " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))

    def hold_bf16(name, got, want, where):
        diff = (got.float() - want.float()).abs()
        e = float(diff.max())
        errs[name] = max(errs[name], e)
        if not bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()):
            fail(f"{name} disagrees with its plain version {where}: {e:.3e}")

    def hold_dwh_bf16(name, got, want, where):
        e, _ = dwh_err(got, want)
        errs[name] = max(errs[name], e)
        if e > BF16_DWH_TOL * float(want.abs().max()):
            fail(f"{name}: dWh off by {e:.3e} {where}, over {BF16_DWH_TOL} x max|dWh|")

    def one_split(B, H, at):
        """K2-bf16 and K4-bf16 take one column split at (B, H)."""
        geos = [K._geometry(B, H, n, dev, torch.bfloat16)
                for n in ("lstm_seq_bwd", "lstm_seq_bwd_fused")]
        if geos[0] != geos[1]:
            fail(f"lstm_seq_bwd_bf16 and lstm_seq_bwd_fused_bf16 split {at} differently: {geos}")

    def hold_fused_dz(f_dz, seam_dz, where):
        """K4-bf16's dz against K2-bf16's f32 dz at the same inputs: rounded
        to bf16, bit for bit (the two walk in one split)."""
        if not torch.equal(f_dz, seam_dz.to(torch.bfloat16)):
            fail(f"lstm_seq_bwd_fused_bf16: dz differs from lstm_seq_bwd_bf16's rounded to bf16 "
                 f"{where} (max |diff| {float((f_dz.float() - seam_dz).abs().max()):.3e})")

    def check_chunks(T, B, H, seed):
        """All five kernels with the batch in row chunks (float32): against
        the plain versions, seams 0 and mixed, K5 at S=5; two launches each
        give the same bits, K4's dz is K2's; then each one's time."""
        at = f"at T={T} B={B} H={H}"
        for kernel in K.COLUMN_SPLIT:
            geo = K._geometry(B, H, kernel, dev)
            if geo.chunks(B) < 2:
                fail(f"{kernel} {at}: {geo} takes the batch in one chunk")
            say("chunks", f"{at}: {kernel} column split {geo}, {geo.chunks(B)} row chunks")
        g = torch.Generator(device=dev).manual_seed(seed)
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g)
        wh = (torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * H ** -0.5
        h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        for got, want in zip((outs, cs), K.lstm_fwd_plain(proj, wh, h0, c0)):
            hold("lstm_fwd", got, want, at)
        if not all(map(torch.equal, (outs, cs), K.lstm_fwd(proj, wh, h0, c0))):
            fail(f"lstm_fwd: two launches differ {at}")
        walk = (torch.randn(T, B, H, device=dev, generator=g), proj,
                torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]]), cs, wh,
                torch.randn(B, H, device=dev, generator=g))
        got = K.lstm_bwd(*walk)
        for a, b in zip(got, K.lstm_bwd_plain(*walk)):
            hold("lstm_bwd", a, b, at)
        if not all(map(torch.equal, got, K.lstm_bwd(*walk))):
            fail(f"lstm_bwd: two launches differ {at}")
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        S = 5
        ckpt = (walk[0], proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, walk[6])
        for label, burn in (("0", torch.zeros_like(mixed)), ("mixed", mixed)):
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold("lstm_seq_bwd", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            hold_dwh("lstm_seq_bwd_fused", f_dwh, K.lstm_seq_bwd_fused_plain(*walk, burn)[1],
                     where)
            if not torch.equal(f_dz, dz):
                fail(f"lstm_seq_bwd_fused: dz differs from lstm_seq_bwd's {where}")
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt, burn, S)
            p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt, burn, S)
            hold("lstm_seq_bwd_ckpt", k_dz, p_dz, f"{where} S={S}")
            hold_dwh("lstm_seq_bwd_ckpt", k_dwh, p_dwh, f"{where} S={S}")
            zero_below("lstm_seq_bwd_ckpt", k_dz, burn, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd: two launches differ {at}")
        if not all(map(torch.equal, (f_dz, f_dwh), K.lstm_seq_bwd_fused(*walk, mixed))):
            fail(f"lstm_seq_bwd_fused: two launches differ {at}")
        if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt, mixed, S))):
            fail(f"lstm_seq_bwd_ckpt: two launches differ {at}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
        t_ms = {
            "lstm_fwd": median_ms(lambda: K.lstm_fwd(proj, wh, h0, c0), 5, flush),
            "lstm_seq_bwd": median_ms(lambda: K.lstm_seq_bwd(*walk, mixed), 5, flush),
            "lstm_bwd": median_ms(lambda: K.lstm_bwd(*walk), 5, flush),
            "lstm_seq_bwd_fused": median_ms(lambda: K.lstm_seq_bwd_fused(*walk, mixed), 5, flush),
            "lstm_seq_bwd_ckpt": median_ms(lambda: K.lstm_seq_bwd_ckpt(*ckpt, mixed, S), 5,
                                           flush),
        }
        say("chunks", f"{at}: all five kernels within atol {ATOL} + rtol {RTOL} (dWh within "
            f"{DWH_TOL} x max|dWh|), seams 0 and mixed, K5 at S={S}; two launches of each give "
            f"identical bits; lstm_seq_bwd_fused's dz equals lstm_seq_bwd's")
        say("chunks", f"{at}, seam mixed, on {card}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in t_ms.items()) + " (median of 5)")

    def bf16_operands(T, B, H, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        bf = torch.bfloat16
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g).to(bf)
        wh = ((torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * H ** -0.5).to(bf)
        h0 = (torch.randn(B, H, device=dev, generator=g) * 0.3).to(bf)
        c0 = (torch.randn(B, H, device=dev, generator=g) * 0.3).to(bf)
        dout = torch.randn(T, B, H, device=dev, generator=g)
        dcT = torch.randn(B, H, device=dev, generator=g)
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        outs, cs = K.lstm_fwd_plain(proj, wh, h0, c0)
        walk = (dout, proj, torch.cat([h0[None], outs[:-1]]),
                torch.cat([c0.float()[None], cs[:-1]]), cs, wh, dcT)

        def ckpt(S):
            return (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                    torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]]), wh, dcT)

        return proj, wh, h0, c0, (outs, cs), walk, ckpt, mixed

    def check_chunks_bf16(T, B, H, seed):
        """The bf16 forms of K2, K3, K4 and K5 with the batch in row chunks:
        against their plain versions, seams 0 and mixed for K2, K4 and K5
        (S=5); two launches each give the same bits, K4-bf16's dz is
        K2-bf16's rounded; their times."""
        at = f"at T={T} B={B} H={H} bf16"
        for kernel in ("lstm_seq_bwd", "lstm_bwd", "lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt"):
            geo = K._geometry(B, H, kernel, dev, torch.bfloat16)
            if geo.chunks(B) < 2:
                fail(f"{kernel}_bf16 {at}: {geo} takes the batch in one chunk")
            say("chunks", f"{at}: {kernel}_bf16 column split {geo}, {geo.chunks(B)} row chunks")
        *_, walk, ckpt, mixed = bf16_operands(T, B, H, seed)
        S = 5
        got = K.lstm_bwd(*walk)
        for a, b in zip(got, K.lstm_bwd_plain(*walk)):
            hold_bf16("lstm_bwd_bf16", a, b, at)
        if not all(map(torch.equal, got, K.lstm_bwd(*walk))):
            fail(f"lstm_bwd_bf16: two launches differ {at}")
        one_split(B, H, at)
        for label, burn in (("0", torch.zeros_like(mixed)), ("mixed", mixed)):
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold_bf16("lstm_seq_bwd_bf16", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd_bf16", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            p_dz, p_dwh = K.lstm_seq_bwd_fused_plain(*walk, burn)
            hold_bf16("lstm_seq_bwd_fused_bf16", f_dz, p_dz, where)
            hold_dwh_bf16("lstm_seq_bwd_fused_bf16", f_dwh, p_dwh, where)
            zero_below("lstm_seq_bwd_fused_bf16", f_dz, burn, where)
            hold_fused_dz(f_dz, dz, where)
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S)
            p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)
            hold_bf16("lstm_seq_bwd_ckpt_bf16", k_dz, p_dz, f"{where} S={S}")
            hold_dwh_bf16("lstm_seq_bwd_ckpt_bf16", k_dwh, p_dwh, f"{where} S={S}")
            zero_below("lstm_seq_bwd_ckpt_bf16", k_dz, burn, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd_bf16: two launches differ {at}")
        if not all(map(torch.equal, (f_dz, f_dwh), K.lstm_seq_bwd_fused(*walk, mixed))):
            fail(f"lstm_seq_bwd_fused_bf16: two launches differ {at}")
        if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S))):
            fail(f"lstm_seq_bwd_ckpt_bf16: two launches differ {at}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
        t_ms = {
            "lstm_seq_bwd_bf16": median_ms(lambda: K.lstm_seq_bwd(*walk, mixed), 5, flush),
            "lstm_bwd_bf16": median_ms(lambda: K.lstm_bwd(*walk), 5, flush),
            "lstm_seq_bwd_fused_bf16": median_ms(lambda: K.lstm_seq_bwd_fused(*walk, mixed), 5,
                                                 flush),
            "lstm_seq_bwd_ckpt_bf16": median_ms(lambda: K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S),
                                                5, flush),
        }
        say("chunks", f"{at}: lstm_seq_bwd_bf16, lstm_bwd_bf16, lstm_seq_bwd_fused_bf16 and "
            f"lstm_seq_bwd_ckpt_bf16 (S={S}) within atol {BF16_ATOL} + rtol {BF16_RTOL} (dWh "
            f"within {BF16_DWH_TOL} x max|dWh|), seams 0 and mixed; two launches of each give "
            f"identical bits; lstm_seq_bwd_fused_bf16's dz equals lstm_seq_bwd_bf16's rounded to "
            f"bf16; on {card}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in t_ms.items())
            + " (median of 5, seam mixed)")

    def check_bf16(T, B, H, seed):
        """The bf16 forms of all five kernels against their plain versions,
        the walks on the plain forward's residuals; two launches, one
        result; K4-bf16's dz against K2-bf16's."""
        at = f"at T={T} B={B} H={H} bf16"
        for kernel in K.SOURCES:
            say("check", f"{at}: {kernel}_bf16 column split "
                f"{K._geometry(B, H, kernel, dev, torch.bfloat16)}")
        proj, wh, h0, c0, (p_outs, p_cs), walk, ckpt, mixed = bf16_operands(T, B, H, seed)
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        if outs.dtype != torch.bfloat16 or cs.dtype != torch.float32:
            fail(f"lstm_fwd_bf16 {at}: outs {outs.dtype}, cs {cs.dtype}")
        hold_bf16("lstm_fwd_bf16", outs, p_outs, at)
        hold_bf16("lstm_fwd_bf16", cs, p_cs, at)
        if not all(map(torch.equal, (outs, cs), K.lstm_fwd(proj, wh, h0, c0))):
            fail(f"lstm_fwd_bf16: two launches differ {at}")
        # the seamless backward: dz, dh0 and dc0, all f32
        got = K.lstm_bwd(*walk)
        for a, b in zip(got, K.lstm_bwd_plain(*walk)):
            hold_bf16("lstm_bwd_bf16", a, b, at)
        if not all(map(torch.equal, got, K.lstm_bwd(*walk))):
            fail(f"lstm_bwd_bf16: two launches differ {at}")
        one_split(B, H, at)
        seams = (("0", torch.zeros_like(mixed)), ("mid", torch.full_like(mixed, T // 2)),
                 ("T-1", torch.full_like(mixed, T - 1)), ("mixed", mixed))
        for label, burn in seams:
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold_bf16("lstm_seq_bwd_bf16", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd_bf16", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            p_dz, p_dwh = K.lstm_seq_bwd_fused_plain(*walk, burn)
            hold_bf16("lstm_seq_bwd_fused_bf16", f_dz, p_dz, where)
            hold_dwh_bf16("lstm_seq_bwd_fused_bf16", f_dwh, p_dwh, where)
            zero_below("lstm_seq_bwd_fused_bf16", f_dz, burn, where)
            hold_fused_dz(f_dz, dz, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd_bf16: two launches differ {at}")
        if not all(map(torch.equal, (f_dz, f_dwh), K.lstm_seq_bwd_fused(*walk, mixed))):
            fail(f"lstm_seq_bwd_fused_bf16: two launches differ {at}")
        for S in (5, T):
            for label, burn in seams:
                where = f"{at} S={S} seam {label}"
                k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S)
                p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)
                hold_bf16("lstm_seq_bwd_ckpt_bf16", k_dz, p_dz, where)
                hold_dwh_bf16("lstm_seq_bwd_ckpt_bf16", k_dwh, p_dwh, where)
                zero_below("lstm_seq_bwd_ckpt_bf16", k_dz, burn, where)
            if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S))):
                fail(f"lstm_seq_bwd_ckpt_bf16: two launches differ {at} S={S}")
        torch.cuda.synchronize()
        say("check", f"{at}: lstm_fwd_bf16, lstm_bwd_bf16, lstm_seq_bwd_bf16 and "
            f"lstm_seq_bwd_fused_bf16 (seams 0, mid, T-1, mixed) and lstm_seq_bwd_ckpt_bf16 (S=5 "
            f"and {T}) within atol {BF16_ATOL} + rtol {BF16_RTOL}, dWh within {BF16_DWH_TOL} x "
            f"max|dWh|; two launches of each give identical bits; lstm_seq_bwd_fused_bf16's dz "
            f"equals lstm_seq_bwd_bf16's rounded to bf16, every seam")

    def time_bf16(T, B, H, D, burn, kept, carried, flush, label):
        """The bf16 forms' times at (T, B, H) with the main path's seams,
        and one bf16 LSTM layer of input width D through the port and
        through cuDNN: {name: (ms, plain ms, bound ms, bound by, library
        ms or None)}."""
        proj, wh, h0, c0, _, walk, ckpt, _ = bf16_operands(T, B, H, 40)
        S = 5
        reps = 15 if H <= 512 else 5
        runs = {
            "lstm_fwd_bf16": (lambda: K.lstm_fwd(proj, wh, h0, c0),
                              lambda: K.lstm_fwd_plain(proj, wh, h0, c0)),
            "lstm_seq_bwd_bf16": (lambda: K.lstm_seq_bwd(*walk, burn),
                                  lambda: K.lstm_seq_bwd_plain(*walk, burn)),
            "lstm_bwd_bf16": (lambda: K.lstm_bwd(*walk), lambda: K.lstm_bwd_plain(*walk)),
            "lstm_seq_bwd_fused_bf16": (lambda: K.lstm_seq_bwd_fused(*walk, burn),
                                        lambda: K.lstm_seq_bwd_fused_plain(*walk, burn)),
            "lstm_seq_bwd_ckpt_bf16": (lambda: K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S),
                                       lambda: K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)),
        }
        mm = 2 * H * 4 * H
        bh, bh4, f4, b2 = B * H, B * 4 * H, 4, 2
        # the matmul FLOPs and the bytes each function must move: bf16
        # proj, wh and h rows (and K4's and K5's dz), f32 c rows,
        # cotangents, K2's and K3's dz and dWh
        walk_in = b2 * (T * bh4 + T * bh + H * 4 * H) + f4 * (3 * T * bh + bh)
        work = {
            "lstm_fwd_bf16": (mm * T * B, b2 * (T * bh4 + H * 4 * H + 2 * bh + T * bh)
                              + f4 * T * bh),
            "lstm_seq_bwd_bf16": (mm * (kept + carried), walk_in + f4 * (B + T * bh4)),
            # no seam: both products on every (row, step); dz, dh0, dc0 out
            "lstm_bwd_bf16": (mm * 2 * T * B, walk_in + f4 * (T * bh4 + 2 * bh)),
            # plus dWh on every kept (row, step); bf16 dz and f32 dWh out
            "lstm_seq_bwd_fused_bf16": (mm * (2 * kept + carried),
                                        walk_in + f4 * (B + H * 4 * H) + b2 * T * bh4),
            "lstm_seq_bwd_ckpt_bf16": (mm * (T * B + 2 * kept + carried),
                                       b2 * (T * bh4 + (T // S) * bh + H * 4 * H + T * bh4)
                                       + f4 * (T * bh + (T // S) * bh + bh + B + H * 4 * H)),
        }
        # one LSTM layer, input projection included, as in phase 8: the
        # port's forward (a bf16 matmul, then lstm_fwd_bf16), and cuDNN's
        # LSTM forward and backward in bf16 where torch takes them, the
        # yardsticks of K1's and K3's bf16 forms
        lib = {}
        x16 = torch.randn(T, B, D, device=dev).to(torch.bfloat16)
        wi16 = (torch.randn(D, 4 * H, device=dev) * D ** -0.5).to(torch.bfloat16)
        layer_ms = median_ms(
            lambda: K.lstm_fwd((x16.reshape(T * B, D) @ wi16).reshape(T, B, 4 * H), wh, h0, c0),
            reps, flush)
        try:
            lstm16 = torch.nn.LSTM(D, H).to(dev, torch.bfloat16)
            with torch.no_grad():
                lib["lstm_fwd_bf16"] = median_ms(lambda: lstm16(x16, (h0[None], c0[None])),
                                                 reps, flush)
            xg = x16.clone().requires_grad_(True)
            h0g, c0g = (v[None].clone().requires_grad_(True) for v in (h0, c0))
            y, (hT, cT) = lstm16(xg, (h0g, c0g))
            leaves = [xg, h0g, c0g, *lstm16.parameters()]
            grads = tuple(v.to(torch.bfloat16) for v in (walk[0], walk[6][None], walk[6][None]))
            lib["lstm_bwd_bf16"] = median_ms(
                lambda: torch.autograd.grad((y, hT, cT), leaves, grads, retain_graph=True),
                reps, flush)
        except Exception as e:  # a yardstick only: the port never calls it
            say("time", f"{label}: cuDNN LSTM in bf16 not taken by torch: {e!r}"[:300])
        say("time", f"one bf16 LSTM layer at {label}, input projection included, T={T} B={B} "
            f"D={D} H={H}: forward through the port (matmul + lstm_fwd_bf16) {layer_ms:.3f} ms; "
            f"torch.nn.LSTM (cuDNN, bf16) " + (
                f"forward {lib['lstm_fwd_bf16']:.3f} ms, backward (dx, dWi, dWh, db, dh0, dc0) "
                f"{lib['lstm_bwd_bf16']:.3f} ms" if len(lib) == 2 else "not taken"))
        # the bf16 default arm's backward, two calls: a yardstick for K4's
        # bf16 form, not one call for its function
        pair_ms = median_ms(lambda: K._outer_dwh(walk[2], K.lstm_seq_bwd(*walk, burn), wh),
                            reps, flush)
        out = {}
        for name, (fn, plain) in runs.items():
            t_ms = median_ms(fn, reps, flush)
            p_ms = median_ms(plain, 3, flush)
            flops, nbytes = work[name]
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_tc, t_fma = flops / PEAK_BF16_FLOPS * 1e3, flops / PEAK_FP32_FLOPS * 1e3
            b_ms, b_by = (t_tc, "operations") if t_tc >= t_bytes else (t_bytes, "bytes")
            fma_ms = max(t_fma, t_bytes)
            out[name] = (t_ms, p_ms, b_ms, b_by, lib.get(name))
            lib_s = f"{lib[name]:.3f} ms" if name in lib else "none"
            say("time", f"{name} at {label} (T={T} B={B} H={H}, "
                f"{K._geometry(B, H, K._SOURCE[name], dev, torch.bfloat16)}): {t_ms:.3f} ms "
                f"(plain {p_ms:.3f} ms); bound {b_ms:.4f} ms by {b_by} at the bf16 tensor "
                f"cores' {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s ({b_ms / t_ms:.1%}), {fma_ms:.4f} ms "
                f"at the fp32 FMA peak ({fma_ms / t_ms:.1%}); {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; cuDNN LSTM bf16 {lib_s}; on {card}")
        say("time", f"bf16 default arm's pair at {label} (lstm_seq_bwd_bf16 + hprev^T @ dz "
            f"matmul) {pair_ms:.3f} ms beside lstm_seq_bwd_fused_bf16 "
            f"{out['lstm_seq_bwd_fused_bf16'][0]:.3f} ms")
        return out

    # 4. the main path -------------------------------------------------------
    cfg = PRESETS["atari"]().replace(**ON_CATCH)
    t = time.perf_counter()
    tr, launches, m, ms, peak = drive(cfg, UPDATES, dev)
    cfg = tr.cfg
    say("train", f"atari preset on catch: obs {cfg.obs_shape} {cfg.encoder}, hidden "
        f"{cfg.hidden_dim}, T={cfg.seq_len} ({cfg.burn_in_steps}/{cfg.learning_steps}/"
        f"{cfg.forward_steps}), batch {cfg.batch_size}, {cfg.num_actors} envs, "
        f"{cfg.resolved_compute_dtype}, arm {tr.backward_arm[0]}; cut: buffer_capacity "
        f"{cfg.buffer_capacity} (atari 2000000), learning_starts {cfg.learning_starts} "
        f"(atari 50000); warmup and {UPDATES} updates in {time.perf_counter() - t:.1f}s")
    say("train", f"{m['step']} updates: loss {m['loss']:.6f}, grad_norm "
        f"{m['grad_norm']:.4f}, q_mean {m['q_mean']:.4f}; ms/update first {ms[0]:.1f}, "
        f"median of the rest {statistics.median(ms[1:]):.2f} (host clock, ends in the "
        f"priorities' device->host copy); update peak device memory {peak:.3f} GiB")
    say("train", f"launches during the main path: {launches}")
    if launches != {"lstm_fwd": 2 * UPDATES, "lstm_seq_bwd": UPDATES}:
        fail(f"expected {2 * UPDATES} forward and {UPDATES} backward launches, got {launches}")
    path_launches = {"lstm_fwd": launches["lstm_fwd"], "lstm_seq_bwd": launches["lstm_seq_bwd"]}

    # 5. one update on the card against the plain versions on the CPU -------
    sampled = agree(tr, "default arm")

    # 6. the other backward arms ------------------------------------------
    for label, knobs, arm, kernel in (
        ("fused_dwh", {"backward_arm": "fused_dwh"}, ("fused_dwh", 0), "lstm_seq_bwd_fused"),
        ("ckpt", {"backward_arm": "ckpt"}, ("ckpt", 5), "lstm_seq_bwd_ckpt"),
        ("fused_sequence=False", {"fused_sequence": False}, ("default", 0), "lstm_bwd"),
    ):
        t = time.perf_counter()
        a_tr, a_launches, a_m, a_ms, a_peak = drive(cfg.replace(**knobs), ARM_UPDATES, dev)
        if a_tr.backward_arm != arm:
            fail(f"{label}: resolved to {a_tr.backward_arm}, expected {arm}")
        say("arms", f"{label}: arm {a_tr.backward_arm}, {ARM_UPDATES} updates, loss "
            f"{a_m['loss']:.6f}; ms/update first {a_ms[0]:.1f}, median of the rest "
            f"{statistics.median(a_ms[1:]):.2f}; update peak device memory {a_peak:.3f} GiB; "
            f"launches {a_launches} "
            f"({time.perf_counter() - t:.1f}s with warmup)")
        if a_launches != {"lstm_fwd": 2 * ARM_UPDATES, kernel: ARM_UPDATES}:
            fail(f"{label}: expected {2 * ARM_UPDATES} lstm_fwd and {ARM_UPDATES} {kernel} "
                 f"launches, got {a_launches}")
        path_launches[kernel] = a_launches[kernel]
        agree(a_tr, label)
        del a_tr

    # 7. the xl model preset, backward arm resolved by the budget ----------
    xl_cfg = apply_model_preset(PRESETS["atari"](), "xl").replace(**ON_CATCH)
    t = time.perf_counter()
    x_tr, x_launches, x_m, x_ms, x_peak = drive(xl_cfg, XL_UPDATES, dev)
    say("xl", f"model preset xl: hidden {x_tr.cfg.hidden_dim}, backward_arm "
        f"{x_tr.cfg.backward_arm!r} budget {x_tr.cfg.backward_residual_budget_mb} MiB -> "
        f"{x_tr.backward_arm}; {XL_UPDATES} updates, loss {x_m['loss']:.6f}; ms/update "
        f"{', '.join(f'{v:.1f}' for v in x_ms)} (host clock) on {card}; update peak "
        f"device memory {x_peak:.3f} GiB; launches "
        f"{x_launches} ({time.perf_counter() - t:.1f}s with warmup)")
    if x_tr.backward_arm != ("ckpt", 85):
        fail(f"xl resolved to {x_tr.backward_arm}, expected ('ckpt', 85)")
    if x_launches != {"lstm_fwd": 2 * XL_UPDATES, "lstm_seq_bwd_ckpt": XL_UPDATES}:
        fail(f"xl: expected {2 * XL_UPDATES} lstm_fwd and {XL_UPDATES} lstm_seq_bwd_ckpt "
             f"launches, got {x_launches}")
    agree(x_tr, "xl")
    del x_tr

    # 8. timings at the main path's shapes ----------------------------------
    T, B, H = cfg.seq_len, cfg.batch_size, cfg.hidden_dim
    D = tr.state.net.core.wi.shape[0]
    burn = torch.from_numpy(sampled.burn_in_steps).to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(T, B, D, device=dev, generator=g)
    wi = tr.state.net.core.wi.detach()
    bias = tr.state.net.core.b.detach()
    wh = tr.state.net.core.wh.detach()
    proj = (x.reshape(T * B, D) @ wi + bias).reshape(T, B, 4 * H)
    h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
    c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
    outs, cs = K.lstm_fwd(proj, wh, h0, c0)
    hprev = torch.cat([h0[None], outs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dout = torch.randn(T, B, H, device=dev, generator=g)
    dcT = torch.randn(B, H, device=dev, generator=g)
    walk = (dout, proj, hprev, cprev, cs, wh, dcT)
    S = 5
    ckpt_args = (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                 torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, dcT, burn, S)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    flush = scratch.zero_

    times = {}
    for name, fn, plain in (
        ("lstm_fwd", lambda: K.lstm_fwd(proj, wh, h0, c0),
         lambda: K.lstm_fwd_plain(proj, wh, h0, c0)),
        ("lstm_seq_bwd", lambda: K.lstm_seq_bwd(*walk, burn),
         lambda: K.lstm_seq_bwd_plain(*walk, burn)),
        ("lstm_bwd", lambda: K.lstm_bwd(*walk), lambda: K.lstm_bwd_plain(*walk)),
        ("lstm_seq_bwd_fused", lambda: K.lstm_seq_bwd_fused(*walk, burn),
         lambda: K.lstm_seq_bwd_fused_plain(*walk, burn)),
        ("lstm_seq_bwd_ckpt", lambda: K.lstm_seq_bwd_ckpt(*ckpt_args),
         lambda: K.lstm_seq_bwd_ckpt_plain(*ckpt_args)),
    ):
        times[name] = (median_ms(fn, flush=flush), median_ms(plain, flush=flush))

    # library calls: cuDNN's LSTM forward on the same layer, and its backward
    # (which also computes dx, dWi and the bias gradient)
    cudnn = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        cudnn_ms = median_ms(lambda: cudnn(x, (h0[None], c0[None])), flush=flush)
        layer_ms = median_ms(
            lambda: K.lstm_fwd((x.reshape(T * B, D) @ wi + bias).reshape(T, B, 4 * H), wh, h0, c0),
            flush=flush)
    xg = x.clone().requires_grad_(True)
    h0g, c0g = h0[None].clone().requires_grad_(True), c0[None].clone().requires_grad_(True)
    y, (hT, cT) = cudnn(xg, (h0g, c0g))
    leaves = [xg, h0g, c0g, *cudnn.parameters()]
    cudnn_bwd_ms = median_ms(
        lambda: torch.autograd.grad((y, hT, cT), leaves, (dout, dcT[None], dcT[None]),
                                    retain_graph=True),
        flush=flush)
    say("time", f"one LSTM layer forward, input projection included, T={T} B={B} D={D} H={H}: "
        f"port (matmul + lstm_fwd) {layer_ms:.3f} ms, torch.nn.LSTM (cuDNN) {cudnn_ms:.3f} ms; "
        f"cuDNN's backward of the same layer (dx, dWi, dWh, db, dh0, dc0) {cudnn_bwd_ms:.3f} ms")

    # bounds: the bytes each function must move (inputs read once, outputs
    # written once) and its matmul FLOPs; the gate math adds under 1%
    f32 = 4
    # the seam backward needs the gate recompute for steps t >= burn[b] and
    # the carry product for steps t > burn[b]; below the seam dz is zero
    kept = int((T - burn.long()).sum())
    carried = int((T - 1 - burn.long()).clamp(min=0).sum())

    def works(h, s):
        """{kernel: (FLOPs, bytes)} at hidden size h, K5 at stride s."""
        mm = 2 * h * 4 * h  # one (row, step) through an h x 4h product
        walk_bytes = f32 * (4 * T * B * h + T * B * 4 * h + h * 4 * h + B * h)
        return {
            "lstm_fwd": (mm * T * B,
                         f32 * (T * B * 4 * h + h * 4 * h + 2 * B * h + 2 * T * B * h)),
            "lstm_seq_bwd": (mm * (kept + carried), walk_bytes + f32 * (B + T * B * 4 * h)),
            # no seam: the recompute and the carry on every (row, step), and
            # the outputs dz, dh0, dc0
            "lstm_bwd": (mm * 2 * T * B, walk_bytes + f32 * (T * B * 4 * h + 2 * B * h)),
            # plus dWh on every kept (row, step), and dWh written once
            "lstm_seq_bwd_fused": (mm * (2 * kept + carried),
                                   walk_bytes + f32 * (B + T * B * 4 * h + h * 4 * h)),
            # plus the forward recompute of every (row, step); reads T/s
            # checkpoints instead of the h, c sequences
            "lstm_seq_bwd_ckpt": (mm * (T * B + 2 * kept + carried),
                                  f32 * (T * B * h + T * B * 4 * h + 2 * (T // s) * B * h
                                         + h * 4 * h + B * h + B + T * B * 4 * h + h * 4 * h)),
        }

    work = works(H, S)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    sources = {"lstm_fwd": 68, "lstm_seq_bwd": 287, "lstm_bwd": 125,
               "lstm_seq_bwd_fused": 451, "lstm_seq_bwd_ckpt": 615}
    library = {"lstm_fwd": cudnn_ms, "lstm_bwd": cudnn_bwd_ms}
    kernels = []
    for name in K.SOURCES:
        t_ms, p_ms = times[name]
        flops, nbytes = work[name]
        b_ms, b_by = bound(flops, nbytes)
        say("time", f"{name}: {t_ms:.3f} ms (plain {p_ms:.3f} ms), bound {b_ms:.4f} ms by "
            f"{b_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
            f"{flops / t_ms / 1e6:.1f} GFLOP/s = {b_ms / t_ms:.1%} of the bound; "
            f"launches on its path {path_launches[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": f"r2d2_tpu_torch/csrc/{name}.cu",
            "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[name]}",
            "launches": path_launches[name], "max_abs_err": errs[name], "ms": t_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library.get(name), "unit": unit(name),
        })
    # the default arm's backward, two calls: the seam walk, then dWh as one
    # matmul outside it; a yardstick for K4, not one call for its function
    pair_ms = median_ms(lambda: K._outer_dwh(hprev, K.lstm_seq_bwd(*walk, burn), wh), flush=flush)
    say("time", f"default arm's pair (lstm_seq_bwd + hprev^T @ dz matmul) {pair_ms:.3f} ms beside "
        f"lstm_seq_bwd_fused {times['lstm_seq_bwd_fused'][0]:.3f} ms; lstm_seq_bwd alone "
        f"{times['lstm_seq_bwd'][0]:.3f} ms, so K4's dWh pass takes about "
        f"{times['lstm_seq_bwd_fused'][0] - times['lstm_seq_bwd'][0]:.3f} ms")
    say("time", f"seams of the sampled batch: {sorted(set(sampled.burn_in_steps.tolist()))}, "
        f"backward steps kept {kept} of {T * B}; ckpt at S={S}")
    # the column split's floor: one grid barrier per step and nothing else
    bar_ms = median_ms(lambda: K.grid_barriers(T, B, H, dev))
    say("time", f"{T} grid barriers alone at lstm_fwd's geometry {K._geometry(B, H, 'lstm_fwd', dev)}: "
        f"{bar_ms:.3f} ms, {bar_ms / T * 1e3:.2f} us per barrier; lstm_fwd "
        f"{times['lstm_fwd'][0]:.3f} ms, lstm_seq_bwd {times['lstm_seq_bwd'][0]:.3f} ms")

    # the forward and the four backwards at the xl width, where auto takes
    # the checkpointed arm
    Hx, Sx = 2048, 85
    gx = torch.Generator(device=dev).manual_seed(8)
    projx = torch.randn(T, B, 4 * Hx, device=dev, generator=gx)
    whx = (torch.rand(Hx, 4 * Hx, device=dev, generator=gx) * 2 - 1) * Hx ** -0.5
    hx = torch.randn(1, B, Hx, device=dev, generator=gx) * 0.3
    cx = torch.randn(1, B, Hx, device=dev, generator=gx) * 0.3
    outsx, csx = K.lstm_fwd(projx, whx, hx[0], cx[0])
    walkx = (torch.randn(T, B, Hx, device=dev, generator=gx), projx,
             torch.cat([hx, outsx[:-1]]), torch.cat([cx, csx[:-1]]), csx, whx,
             torch.randn(B, Hx, device=dev, generator=gx))
    work_x = works(Hx, Sx)
    for name, fn, reps in (
        ("lstm_fwd", lambda: K.lstm_fwd(projx, whx, hx[0], cx[0]), 15),
        ("lstm_seq_bwd", lambda: K.lstm_seq_bwd(*walkx, burn), 15),
        ("lstm_bwd", lambda: K.lstm_bwd(*walkx), 15),
        ("lstm_seq_bwd_fused", lambda: K.lstm_seq_bwd_fused(*walkx, burn), 15),
        ("lstm_seq_bwd_ckpt",
         lambda: K.lstm_seq_bwd_ckpt(walkx[0], projx, hx, cx, whx, walkx[6], burn, Sx), 5),
    ):
        t_ms = median_ms(fn, reps=reps, flush=flush)
        b_ms, b_by = bound(*work_x[name])
        stride = f" S={Sx}" if name == "lstm_seq_bwd_ckpt" else ""
        say("time", f"{name} at xl (T={T} B={B} H={Hx}{stride}, "
            f"{K._geometry(B, Hx, name, dev)}): {t_ms:.3f} ms (median of {reps}), bound "
            f"{b_ms:.4f} ms by {b_by} ({work_x[name][0] / 1e9:.2f} GFLOP) = {b_ms / t_ms:.1%} "
            f"of the bound")
    pair_x = median_ms(lambda: K._outer_dwh(walkx[2], K.lstm_seq_bwd(*walkx, burn), whx),
                       flush=flush)
    say("time", f"default arm's pair at xl (lstm_seq_bwd + hprev^T @ dz matmul): "
        f"{pair_x:.3f} ms (median of 15)")
    # cuDNN's fp32 LSTM at xl under the port's fp32 numerics (TF32 off): the
    # yardsticks of fp32 K1 and K3 there
    Dx = D - H + Hx
    xx = torch.randn(T, B, Dx, device=dev, generator=gx)
    cudnn_x = torch.nn.LSTM(Dx, Hx).to(dev)
    with torch.no_grad():
        cudnn_x_ms = median_ms(lambda: cudnn_x(xx, (hx, cx)), reps=5, flush=flush)
    xg = xx.clone().requires_grad_(True)
    hxg, cxg = hx.clone().requires_grad_(True), cx.clone().requires_grad_(True)
    y, (hT, cT) = cudnn_x(xg, (hxg, cxg))
    leaves = [xg, hxg, cxg, *cudnn_x.parameters()]
    cudnn_x_bwd_ms = median_ms(
        lambda: torch.autograd.grad((y, hT, cT), leaves, (walkx[0], walkx[6][None],
                                                          walkx[6][None]), retain_graph=True),
        reps=5, flush=flush)
    say("time", f"torch.nn.LSTM (cuDNN, fp32, TF32 "
        f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}) at xl, T={T} B={B} D={Dx} "
        f"H={Hx}: forward {cudnn_x_ms:.3f} ms, backward (dx, dWi, dWh, db, dh0, dc0) "
        f"{cudnn_x_bwd_ms:.3f} ms (median of 5)")
    del cudnn_x, y, hT, cT, leaves

    for _ in range(120):  # about a second of queued forward launches
        K.lstm_fwd(proj, wh, h0, c0)
    loaded = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    say("time", f"SM clock under a queue of lstm_fwd launches, max: {loaded}")

    # 9. the batch in row chunks --------------------------------------------
    for i, shape in enumerate(CHUNKED):
        check_chunks(*shape, seed=20 + i)
        check_chunks_bf16(*shape, seed=25 + i)

    # 10. the bf16 forms against their plain versions -----------------------
    for i, shape in enumerate(((T, B, H), (T, B, 2048), (T, WIDE_BATCH, WIDE_H))):
        check_bf16(*shape, seed=30 + i)
    say("check", "max |kernel - plain| (dz, dh0/dc0 and dWh alike), every check: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))

    # 11. the atari preset in its own bf16 -----------------------------------
    b_cfg = PRESETS["atari"]().replace(**ON_CATCH_BF16)
    t = time.perf_counter()
    b_tr, b_launches, b_m, b_ms, b_peak = drive(b_cfg, UPDATES, dev)
    say("bf16", f"atari preset as shipped: compute {b_tr.cfg.resolved_compute_dtype}, state "
        f"{b_tr.cfg.state_dtype}, arm {b_tr.backward_arm}; {UPDATES} updates, loss "
        f"{b_m['loss']:.6f}, grad_norm {b_m['grad_norm']:.4f}; ms/update first {b_ms[0]:.1f}, "
        f"median of the rest {statistics.median(b_ms[1:]):.2f} (fp32 main path "
        f"{statistics.median(ms[1:]):.2f}); update peak device memory {b_peak:.3f} GiB "
        f"(fp32 {peak:.3f}); launches {b_launches} ({time.perf_counter() - t:.1f}s with warmup)")
    if b_tr.cfg.resolved_compute_dtype != "bfloat16" or b_tr.backward_arm != ("default", 0):
        fail(f"the atari preset resolved to {b_tr.cfg.resolved_compute_dtype}, "
             f"{b_tr.backward_arm}; expected bfloat16, ('default', 0)")
    if b_launches != {"lstm_fwd_bf16": 2 * UPDATES, "lstm_seq_bwd_bf16": UPDATES}:
        fail(f"bf16: expected {2 * UPDATES} lstm_fwd_bf16 and {UPDATES} lstm_seq_bwd_bf16 "
             f"launches, got {b_launches}")
    path_launches.update(b_launches)

    bx_cfg = apply_model_preset(PRESETS["atari"](), "xl").replace(**ON_CATCH_BF16)
    t = time.perf_counter()
    bx_tr, bx_launches, bx_m, bx_ms, bx_peak = drive(bx_cfg, XL_UPDATES, dev)
    say("bf16", f"xl in bf16: hidden {bx_tr.cfg.hidden_dim}, backward_arm "
        f"{bx_tr.cfg.backward_arm!r} budget {bx_tr.cfg.backward_residual_budget_mb} MiB -> "
        f"{bx_tr.backward_arm}; {XL_UPDATES} updates, loss {bx_m['loss']:.6f}; ms/update "
        f"{', '.join(f'{v:.1f}' for v in bx_ms)} (host clock) on {card}; update peak device "
        f"memory {bx_peak:.3f} GiB; launches {bx_launches} "
        f"({time.perf_counter() - t:.1f}s with warmup)")
    if bx_tr.backward_arm != ("ckpt", 5):
        fail(f"xl in bf16 resolved to {bx_tr.backward_arm}, expected ('ckpt', 5)")
    if bx_launches != {"lstm_fwd_bf16": 2 * XL_UPDATES, "lstm_seq_bwd_ckpt_bf16": XL_UPDATES}:
        fail(f"bf16 xl: expected {2 * XL_UPDATES} lstm_fwd_bf16 and {XL_UPDATES} "
             f"lstm_seq_bwd_ckpt_bf16 launches, got {bx_launches}")
    path_launches["lstm_seq_bwd_ckpt_bf16"] = bx_launches["lstm_seq_bwd_ckpt_bf16"]

    p_cfg = b_cfg.replace(precision="bf16")
    t = time.perf_counter()
    p_tr, p_launches, p_m, p_ms, p_peak = drive(p_cfg, PRECISION_UPDATES, dev)
    store = p_tr.replay.hidden_store
    say("bf16", f"precision=bf16 (carries stored in {p_tr.cfg.state_dtype}, host store "
        f"{store.dtype}): {PRECISION_UPDATES} updates, loss {p_m['loss']:.6f}; ms/update first "
        f"{p_ms[0]:.1f}, median of the rest {statistics.median(p_ms[1:]):.2f}; update peak "
        f"device memory {p_peak:.3f} GiB; launches {p_launches} "
        f"({time.perf_counter() - t:.1f}s with warmup)")
    if store.dtype.name != "uint16" or p_launches != {
            "lstm_fwd_bf16": 2 * PRECISION_UPDATES, "lstm_seq_bwd_bf16": PRECISION_UPDATES}:
        fail(f"precision=bf16: store {store.dtype}, launches {p_launches}")
    del p_tr

    # the paths of K4-bf16 and K3-bf16: the wide model at batch 96, where
    # auto resolves to the fused arm, beside the same model's default arm;
    # the fused arm and the seamless backward at the atari widths; one
    # update of the wide model with no seam
    wide_cfg = apply_model_preset(PRESETS["atari"](), "wide").replace(
        batch_size=WIDE_BATCH, **ON_CATCH_BF16)
    bf16_paths = {}
    for label, path_cfg, n, arm, kernel in (
        ("wide B=96 auto", wide_cfg, ARM_UPDATES, ("fused_dwh", 0), "lstm_seq_bwd_fused_bf16"),
        ("wide B=96 default", wide_cfg.replace(backward_arm="default"), 2, ("default", 0),
         "lstm_seq_bwd_bf16"),
        ("fused_dwh", b_cfg.replace(backward_arm="fused_dwh"), ARM_UPDATES, ("fused_dwh", 0),
         "lstm_seq_bwd_fused_bf16"),
        ("fused_sequence=False", b_cfg.replace(fused_sequence=False), ARM_UPDATES, ("default", 0),
         "lstm_bwd_bf16"),
        ("wide B=96 fused_sequence=False", wide_cfg.replace(fused_sequence=False), 1,
         ("default", 0), "lstm_bwd_bf16"),
        ("ckpt", b_cfg.replace(backward_arm="ckpt"), ARM_UPDATES, ("ckpt", 5),
         "lstm_seq_bwd_ckpt_bf16"),
    ):
        t = time.perf_counter()
        a_tr, a_launches, a_m, a_ms, a_peak = drive(path_cfg, n, dev)
        say("bf16", f"{label}: hidden {a_tr.cfg.hidden_dim}, batch {a_tr.cfg.batch_size}, "
            f"compute {a_tr.cfg.resolved_compute_dtype}, arm {a_tr.backward_arm}; {n} updates, "
            f"loss {a_m['loss']:.6f}; ms/update {', '.join(f'{v:.2f}' for v in a_ms)} (host "
            f"clock) on {card}; update peak device memory {a_peak:.3f} GiB; launches "
            f"{a_launches} ({time.perf_counter() - t:.1f}s with warmup)")
        if a_tr.cfg.resolved_compute_dtype != "bfloat16" or a_tr.backward_arm != arm:
            fail(f"{label}: resolved to {a_tr.cfg.resolved_compute_dtype}, {a_tr.backward_arm}; "
                 f"expected bfloat16, {arm}")
        if a_launches != {"lstm_fwd_bf16": 2 * n, kernel: n}:
            fail(f"{label}: expected {2 * n} lstm_fwd_bf16 and {n} {kernel} launches, got "
                 f"{a_launches}")
        path_launches.setdefault(kernel, a_launches[kernel])
        bf16_paths[label] = (a_tr, a_peak)

    def core_peak(a_tr, arm):
        """Peak device memory (GiB) above the start of one forward and
        backward of a trainer's LSTM core alone under `arm`, on a batch of
        its width with every row's seam at the burn-in: the residuals the
        arm choice budgets, without the rest of the update."""
        c = a_tr.cfg
        core = copy.deepcopy(a_tr.state.net.core)
        core.backward_arm = arm
        g = torch.Generator(device=dev).manual_seed(9)
        x = torch.randn(c.batch_size, c.seq_len, core.wi.shape[0], device=dev, generator=g)
        x.requires_grad_(True)
        carry = (torch.zeros(c.batch_size, c.hidden_dim, device=dev),) * 2
        burn = torch.full((c.batch_size,), c.burn_in_steps, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        outs, _ = core(x, carry, burn)
        outs.float().sum().backward()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2**30

    w_tr = bf16_paths["wide B=96 auto"][0]
    say("bf16", f"wide B=96 update peak device memory: fused_dwh arm "
        f"{bf16_paths['wide B=96 auto'][1]:.3f} GiB, default arm "
        f"{bf16_paths['wide B=96 default'][1]:.3f} GiB; the LSTM core alone (forward and "
        f"backward, seams at {w_tr.cfg.burn_in_steps}): fused_dwh "
        f"{core_peak(w_tr, ('fused_dwh', 0)):.3f} GiB, default "
        f"{core_peak(w_tr, ('default', 0)):.3f} GiB")
    n_tr = bf16_paths["fused_sequence=False"][0]
    c_tr = bf16_paths["ckpt"][0]
    del bf16_paths

    # 12. bf16 against the CPU, and against fp32 on the card -----------------
    def rebuilt(a_tr, dtype):
        """(cfg, net, target) of a trainer's parameters in compute dtype
        `dtype`, on the card."""
        c = a_tr.cfg.replace(compute_dtype=dtype)
        nets = []
        for src in (a_tr.state.net, a_tr.state.target_net):
            n = R2D2Network.from_config(c, device=dev)
            n.load_state_dict(src.state_dict())
            nets.append(n)
        return c, *nets

    def vs_fp32(a_tr, label):
        """One bf16 update against the fp32 update on the card from the same
        parameters and batch, in tests/test_precision.py's class."""
        s = a_tr.replay.sample_batch(a_tr.sample_rng)
        c16, *nets16 = rebuilt(a_tr, "bfloat16")
        c32, *nets32 = rebuilt(a_tr, "float32")
        r16 = one_update(*nets16, c16, s, "cuda")
        r32 = one_update(*nets32, c32, s, "cuda")
        l32, l16 = float(r32[0]), float(r16[0])
        p_diff = float((r16[1] - r32[1]).abs().max())
        say("agree", f"{label}: bf16 vs fp32 on the card, same parameters and batch: loss "
            f"{l16:.6f} vs {l32:.6f} (limit 5% of max(|fp32|, 1)), priorities max |diff| "
            f"{p_diff:.3e} (rtol 0.2 atol 0.05), grad_norm {float(r16[2]):.4f} vs "
            f"{float(r32[2]):.4f}")
        if abs(l16 - l32) > 0.05 * max(abs(l32), 1.0) or not torch.allclose(
                r16[1], r32[1], rtol=0.2, atol=0.05):
            fail(f"{label}: the bf16 update leaves the fp32 update's drift class")

    b_sampled = agree(b_tr, "bf16 main path", **BF16_AGREE)
    vs_fp32(tr, "main path")
    w_sampled = agree(w_tr, "bf16 wide B=96 fused_dwh", **BF16_AGREE)
    vs_fp32(w_tr, "wide B=96 fused_dwh")
    agree(n_tr, "bf16 fused_sequence=False", **BF16_AGREE)
    vs_fp32(n_tr, "fused_sequence=False")
    del n_tr
    # K5's bf16 form, on the tensor cores, on both its paths
    agree(c_tr, "bf16 ckpt", **BF16_AGREE)
    vs_fp32(c_tr, "ckpt")
    del c_tr
    agree(bx_tr, "bf16 xl (ckpt, 5)", **BF16_AGREE)
    vs_fp32(bx_tr, "xl")
    if not args.profile:
        del bx_tr

    # 13. the bf16 forms' times and bounds -----------------------------------
    burn16 = torch.from_numpy(b_sampled.burn_in_steps).to(dev)
    kept16 = int((T - burn16.long()).sum())
    carried16 = int((T - 1 - burn16.long()).clamp(min=0).sum())
    burn_w = torch.from_numpy(w_sampled.burn_in_steps).to(dev)
    kept_w = int((T - burn_w.long()).sum())
    carried_w = int((T - 1 - burn_w.long()).clamp(min=0).sum())
    for Bh, Hh, seams, label in ((B, H, (burn16, kept16, carried16), "atari"),
                                 (WIDE_BATCH, WIDE_H, (burn_w, kept_w, carried_w), "wide B=96"),
                                 (B, 2048, (burn16, kept16, carried16), "xl")):
        rows = time_bf16(T, Bh, Hh, D - H + Hh, *seams, flush, label)
        if label == "atari":
            for name, (t_ms, p_ms, b_ms, b_by, lib_ms) in rows.items():
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
                    "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
                    "launches": path_launches[name], "max_abs_err": errs[name], "ms": t_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "unit": unit(name),
                })

    # 14. the main path end to end: checkpoints, metrics, resume, evaluation
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        e2e("bf16", b_cfg, "threaded", dev, tmp)
        e2e("fp32", cfg, "inline", dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 15. threaded against inline on both main paths --------------------------
    for label, m_cfg in (("bf16", b_cfg), ("fp32", cfg)):
        modes(label, m_cfg, dev, args.profile)

    # 16. a hidden size off the kernels' row, padded on the card ---------------
    for label, o_extra, tol in (("fp32", ON_CATCH, {}), ("bf16", ON_CATCH_BF16, BF16_AGREE)):
        o_cfg = PRESETS["atari"]().replace(hidden_dim=ODD_HIDDEN, **o_extra)
        o_tr, o_launches, o_m, o_ms, _ = drive(o_cfg, 1, dev)
        sfx = "_bf16" if label == "bf16" else ""
        padded = o_tr.state.net.core.padded_units(dev)
        say("odd", f"{label} hidden {ODD_HIDDEN}: the kernels run at {padded} units (zero "
            f"units padded in the model); 1 update, loss {o_m['loss']:.6f}, {o_ms[0]:.1f} ms; "
            f"launches {o_launches}")
        if o_launches != {f"lstm_fwd{sfx}": 2, f"lstm_seq_bwd{sfx}": 1} or padded == ODD_HIDDEN:
            fail(f"hidden {ODD_HIDDEN} {label}: launches {o_launches}, {padded} units")
        agree(o_tr, f"{label} hidden {ODD_HIDDEN}", **tol)
        del o_tr

    # 17. the native replay core against the numpy gathers ------------------
    native_phase(tr)

    # 18. the long_context preset at full width -------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        long_context_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if args.profile:
        profile_updates(tr, args.profile, "fp32 main path")
        profile_updates(b_tr, args.profile, "bf16 main path")
        profile_updates(w_tr, args.profile, "bf16 wide B=96 (fused_dwh)")
        profile_updates(bx_tr, args.profile, "bf16 xl (ckpt, 5)")

    say("done", f"every phase passed; wall {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
