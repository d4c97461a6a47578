#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, each on
its own lines; any failure exits non-zero and prints no result:

1. card   the card's name, power limit and SM clock (nvidia-smi).
2. build  the five kernels from r2d2_tpu_torch/csrc with nvcc, in parallel;
          registers, shared memory and spills as ptxas reports them.
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
5. agree  one update's loss, priorities and gradient norm on a sampled
          batch at those widths, through the kernels on the card, against
          the same update through the plain versions on the CPU.
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
          floor); the forward and the four backwards also at xl; and the
          SM clock read while forward launches are queued.
9. chunks all five kernels with the batch in row chunks, at B=1024, H=512
          and B=256, H=2048 (T=85): against their plain versions, two
          launches each giving the same bits, and their times.
10. bf16  the bf16 forms of K1, K2 and K5 against their plain versions at
          the atari and xl widths, seams 0, mid, T-1 and mixed, K5 at S=5
          and S=85, two launches each giving the same bits.
11. train bf16  the atari preset with its own compute dtype (bfloat16) on
          catch: 8 updates, each 2 lstm_fwd_bf16 + 1 lstm_seq_bwd_bf16
          launches, ms per update and peak memory; its xl model, whose
          backward_arm=auto resolves to ("ckpt", 5) in bf16: 2 updates of 2
          lstm_fwd_bf16 + 1 lstm_seq_bwd_ckpt_bf16; precision="bf16"
          (carries stored in bf16): 4 updates.
12. agree bf16  one bf16 update on the card against the same update
          through the plain versions on the CPU, and the bf16 update
          against the fp32 update on the card from the same parameters and
          batch (tests/test_precision.py's class: loss within 5%,
          priorities rtol 0.2 / atol 0.05).
13. time bf16  each bf16 form, its plain version, its bounds (the bytes,
          and the operations at the fp32 FMA peak and at the bf16 tensor
          cores' dense peak) and cuDNN's LSTM forward in bf16 where torch
          takes it, at the atari and xl widths.

The next-to-last lines are the kernels as one JSON object and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile N

adds N more updates of the main path (fp32, then bf16) under torch.profiler
after the last phase and prints where their device time goes, by kernel,
and the device's busy share.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import copy
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
# the row-chunk shapes of phase 9: twice the rows a block holds at once
CHUNKED = ((85, 1024, 512), (85, 256, 2048))
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
    """(loss, priorities, gradient norm) of one update of `net` on a sampled
    batch, on `where`, without stepping the optimizer."""
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch, make_loss_fn

    net = copy.deepcopy(net).to(where)
    net.zero_grad(set_to_none=True)
    target = copy.deepcopy(target).to(where)
    b = DeviceBatch.from_sampled(sampled, where)
    denom = torch.clamp(b.learning_steps.sum().float(), min=1.0)
    loss, (prio, _) = make_loss_fn(cfg)(net, target, b, denom)
    loss.backward()
    gnorm = torch.sqrt(sum(torch.sum(p.grad.float() ** 2) for p in net.parameters()))
    return [x.detach().cpu() for x in (loss, prio, gnorm)]


def agree(tr, label, rtol=1e-4, atol=1e-5):
    """One update on a sampled batch through the kernels on the card against
    the same update through the plain versions on the CPU; -> the batch."""
    import torch

    sampled = tr.replay.sample_batch(tr.sample_rng)
    t = time.perf_counter()
    results = {where: one_update(tr.state.net, tr.state.target_net, tr.cfg, sampled, where)
               for where in ("cuda", "cpu")}
    for name, a, b in zip(("loss", "priorities", "grad_norm"), results["cuda"], results["cpu"]):
        diff = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            fail(f"{label}: {name} through the kernels differs from the CPU's plain "
                 f"versions: {diff:.3e}")
        say("agree", f"{label} {name}: card {a.flatten()[0].item():.6f} vs cpu "
            f"{b.flatten()[0].item():.6f} (max |diff| {diff:.3e}, rtol {rtol} atol {atol})")
    say("agree", f"{label}: {len(sampled.idxes)} rows, {time.perf_counter() - t:.1f}s")
    return sampled


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

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies, memsets): the operators that
    # launch them report the same time again as their own
    rows = sorted(((device_us(e), e.count, e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and device_us(e) > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    say("prof", f"{label}: {n} updates (actor steps included) in {wall_ms:.1f} ms wall; device busy "
        f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}")
    for us, count, key in rows[:16]:
        say("prof", f"{us / 1e3 / n:9.3f} ms/update {us / 1e3 / busy_ms:6.1%} x{count // n:<4d} "
            f"{key[:90]}")


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
    _build.build(names)
    say("build", f"nvcc built {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

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

    def check_bf16(T, B, H, seed):
        """The bf16 forms of K1, K2 and K5 against their plain versions, the
        walks on the plain forward's residuals; two launches, one result."""
        at = f"at T={T} B={B} H={H} bf16"
        for kernel in ("lstm_fwd", "lstm_seq_bwd", "lstm_seq_bwd_ckpt"):
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
        seams = (("0", torch.zeros_like(mixed)), ("mid", torch.full_like(mixed, T // 2)),
                 ("T-1", torch.full_like(mixed, T - 1)), ("mixed", mixed))
        for label, burn in seams:
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold_bf16("lstm_seq_bwd_bf16", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd_bf16", dz, burn, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd_bf16: two launches differ {at}")
        for S in (5, T):
            for label, burn in seams:
                where = f"{at} S={S} seam {label}"
                k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S)
                p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)
                hold_bf16("lstm_seq_bwd_ckpt_bf16", k_dz, p_dz, where)
                e, ok = dwh_err(k_dwh, p_dwh)
                errs["lstm_seq_bwd_ckpt_bf16"] = max(errs["lstm_seq_bwd_ckpt_bf16"], e)
                if e > BF16_DWH_TOL * float(p_dwh.abs().max()):
                    fail(f"lstm_seq_bwd_ckpt_bf16: dWh off by {e:.3e} {where}")
                zero_below("lstm_seq_bwd_ckpt_bf16", k_dz, burn, where)
            if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S))):
                fail(f"lstm_seq_bwd_ckpt_bf16: two launches differ {at} S={S}")
        torch.cuda.synchronize()
        say("check", f"{at}: lstm_fwd_bf16, lstm_seq_bwd_bf16 (seams 0, mid, T-1, mixed) and "
            f"lstm_seq_bwd_ckpt_bf16 (S=5 and {T}) within atol {BF16_ATOL} + rtol {BF16_RTOL}, "
            f"dWh within {BF16_DWH_TOL} x max|dWh|; two launches of each give identical bits")

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
            "lstm_seq_bwd_ckpt_bf16": (lambda: K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S),
                                       lambda: K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)),
        }
        mm = 2 * H * 4 * H
        bh, bh4, f4, b2 = B * H, B * 4 * H, 4, 2
        # the matmul FLOPs and the bytes each function must move: bf16
        # proj, wh and h rows, f32 c rows, cotangents and dWh
        work = {
            "lstm_fwd_bf16": (mm * T * B, b2 * (T * bh4 + H * 4 * H + 2 * bh + T * bh)
                              + f4 * T * bh),
            "lstm_seq_bwd_bf16": (mm * (kept + carried),
                                  b2 * (T * bh4 + T * bh + H * 4 * H)
                                  + f4 * (3 * T * bh + bh + B + T * bh4)),
            "lstm_seq_bwd_ckpt_bf16": (mm * (T * B + 2 * kept + carried),
                                       b2 * (T * bh4 + (T // S) * bh + H * 4 * H + T * bh4)
                                       + f4 * (T * bh + (T // S) * bh + bh + B + H * 4 * H)),
        }
        # one LSTM layer forward, input projection included, as in phase 8:
        # the port (a bf16 matmul, then lstm_fwd_bf16), and cuDNN's LSTM in
        # bf16 where torch takes it, the yardstick of K1's bf16 form
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
        except Exception as e:  # a yardstick only: the port never calls it
            say("time", f"{label}: cuDNN LSTM in bf16 not taken by torch: {e!r}"[:300])
        say("time", f"one bf16 LSTM layer forward at {label}, input projection included, T={T} "
            f"B={B} D={D} H={H}: port (matmul + lstm_fwd_bf16) {layer_ms:.3f} ms, "
            f"torch.nn.LSTM (cuDNN, bf16) "
            + (f"{lib['lstm_fwd_bf16']:.3f} ms" if lib else "not taken"))
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
            "library_ms": library.get(name),
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

    for _ in range(120):  # about a second of queued forward launches
        K.lstm_fwd(proj, wh, h0, c0)
    loaded = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    say("time", f"SM clock under a queue of lstm_fwd launches, max: {loaded}")

    # 9. the batch in row chunks --------------------------------------------
    for i, shape in enumerate(CHUNKED):
        check_chunks(*shape, seed=20 + i)

    # 10. the bf16 forms against their plain versions -----------------------
    for i, shape in enumerate(((T, B, H), (T, B, 2048))):
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
    del bx_tr

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

    # 12. bf16 against the CPU, and against fp32 on the card -----------------
    b_sampled = agree(b_tr, "bf16 main path", **BF16_AGREE)
    s32 = tr.replay.sample_batch(tr.sample_rng)
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    nets16 = []
    for src in (tr.state.net, tr.state.target_net):
        n16 = R2D2Network.from_config(cfg16, device=dev)
        n16.load_state_dict(src.state_dict())
        nets16.append(n16)
    r32 = one_update(tr.state.net, tr.state.target_net, cfg, s32, "cuda")
    r16 = one_update(*nets16, cfg16, s32, "cuda")
    l32, l16 = float(r32[0]), float(r16[0])
    p_diff = float((r16[1] - r32[1]).abs().max())
    say("agree", f"bf16 vs fp32 on the card, same parameters and batch: loss {l16:.6f} vs "
        f"{l32:.6f} (limit 5% of max(|fp32|, 1)), priorities max |diff| {p_diff:.3e} "
        f"(rtol 0.2 atol 0.05), grad_norm {float(r16[2]):.4f} vs {float(r32[2]):.4f}")
    if abs(l16 - l32) > 0.05 * max(abs(l32), 1.0) or not torch.allclose(
            r16[1], r32[1], rtol=0.2, atol=0.05):
        fail("the bf16 update leaves the fp32 update's drift class")
    del nets16

    # 13. the bf16 forms' times and bounds -----------------------------------
    burn16 = torch.from_numpy(b_sampled.burn_in_steps).to(dev)
    kept16 = int((T - burn16.long()).sum())
    carried16 = int((T - 1 - burn16.long()).clamp(min=0).sum())
    for Hh, label in ((H, "atari"), (2048, "xl")):
        rows = time_bf16(T, B, Hh, D - H + Hh, burn16, kept16, carried16, flush, label)
        if label == "atari":
            for name, (t_ms, p_ms, b_ms, b_by, lib_ms) in rows.items():
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
                    "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
                    "launches": path_launches[name], "max_abs_err": errs[name], "ms": t_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms,
                })

    if args.profile:
        profile_updates(tr, args.profile, "fp32 main path")
        profile_updates(b_tr, args.profile, "bf16 main path")

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
