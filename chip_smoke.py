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
          with seams on segment boundaries too. The column split of K1,
          K2, K3 and K5 (units per block, grid, threads, k-tile, wh slice
          pinned or streamed) is printed per shape; at the atari widths two
          launches of each must give the same bits (K3: dz, dh0, dc0; K5:
          dz and dWh at S=5), and whether K5's dz equals K2's bit for bit
          at the same inputs is printed (not required).
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
          the main path sampled; T grid barriers alone at the forward's
          geometry (the column split's floor); the forward, the seam and
          seamless backwards and the checkpointed backward also at xl; and
          the SM clock read while forward launches are queued.

The next-to-last lines are the kernels as one JSON object and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile N

adds N more updates of the main path under torch.profiler after phase 8 and
prints where their device time goes, by kernel, and the device's busy share.

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
# the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel vs plain version: both float32, dot products summed in other
# orders, differences carried through T recurrent steps
ATOL = 1e-4
RTOL = 1e-4
# dWh summed in the kernel (K4: per-block partials, then over blocks; K5:
# per column slice, segments newest first) against the plain version's
# per-step matmuls: each entry sums T*B products of both signs, so the
# error is held against the largest entry, not entry by entry
DWH_TOL = 1e-4

UPDATES = 8
ARM_UPDATES = 4
XL_UPDATES = 2
# the atari preset on catch in fp32 (bf16 is queued), with only the host
# replay sizes cut from the preset's 2,000,000 and 50,000
ON_CATCH = dict(env_name="catch", compute_dtype="float32",
                buffer_capacity=16_000, learning_starts=2_000)
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


def agree(tr, label):
    """One update on a sampled batch through the kernels on the card against
    the same update through the plain versions on the CPU; -> the batch."""
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch, make_loss_fn

    sampled = tr.replay.sample_batch(tr.sample_rng)
    loss_fn = make_loss_fn(tr.cfg)
    results = {}
    for where in ("cuda", "cpu"):
        net = copy.deepcopy(tr.state.net).to(where)
        net.zero_grad(set_to_none=True)
        target = copy.deepcopy(tr.state.target_net).to(where)
        b = DeviceBatch.from_sampled(sampled, where)
        denom = torch.clamp(b.learning_steps.sum().float(), min=1.0)
        loss, (prio, _) = loss_fn(net, target, b, denom)
        loss.backward()
        gnorm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in net.parameters()))
        results[where] = [x.detach().cpu() for x in (loss, prio, gnorm)]
    for name, a, b in zip(("loss", "priorities", "grad_norm"), results["cuda"], results["cpu"]):
        diff = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
            fail(f"{label}: {name} through the kernels differs from the CPU's plain "
                 f"versions: {diff:.3e}")
        say("agree", f"{label} {name}: card {a.flatten()[0].item():.6f} vs cpu "
            f"{b.flatten()[0].item():.6f} (max |diff| {diff:.3e}, rtol 1e-4 atol 1e-5)")
    return sampled


def profile_updates(tr, n):
    """Run n more updates of the main path under torch.profiler; print the
    device time by kernel name and the device's busy share of the wall."""
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
    say("prof", f"{n} updates (actor steps included) in {wall_ms:.1f} ms wall; device busy "
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
            S = 5
            args = (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                    torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, dcT, mixed, S)
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*args)
            again = K.lstm_seq_bwd_ckpt(*args)
            if not (torch.equal(k_dz, again[0]) and torch.equal(k_dwh, again[1])):
                fail(f"lstm_seq_bwd_ckpt: two launches differ (dz or dWh) {at} S={S}")
            say("check", f"{at}: two launches each of lstm_fwd, lstm_seq_bwd, lstm_bwd and "
                f"lstm_seq_bwd_ckpt (S={S}) give identical bits")
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
    for name in K.KERNELS:
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
    say("time", f"seams of the sampled batch: {sorted(set(sampled.burn_in_steps.tolist()))}, "
        f"backward steps kept {kept} of {T * B}; ckpt at S={S}")
    # the column split's floor: one grid barrier per step and nothing else
    bar_ms = median_ms(lambda: K.grid_barriers(T, B, H, dev))
    say("time", f"{T} grid barriers alone at lstm_fwd's geometry {K._geometry(B, H, 'lstm_fwd', dev)}: "
        f"{bar_ms:.3f} ms, {bar_ms / T * 1e3:.2f} us per barrier; lstm_fwd "
        f"{times['lstm_fwd'][0]:.3f} ms, lstm_seq_bwd {times['lstm_seq_bwd'][0]:.3f} ms")

    # the forward, the seam and seamless backwards and the checkpointed
    # backward at the xl width, where auto takes the checkpointed arm
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

    for _ in range(120):  # about a second of queued forward launches
        K.lstm_fwd(proj, wh, h0, c0)
    loaded = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    say("time", f"SM clock under a queue of lstm_fwd launches, max: {loaded}")

    if args.profile:
        profile_updates(tr, args.profile)

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
