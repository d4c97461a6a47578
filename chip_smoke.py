#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, each on
its own lines; any failure exits non-zero and prints no result:

1. card   the card's name, power limit and SM clock (nvidia-smi).
2. build  both kernels from r2d2_tpu_torch/csrc with nvcc, in parallel;
          registers, shared memory and spills as ptxas reports them.
3. check  each kernel against its plain PyTorch version on the card: at the
          atari widths (T=85, B=64, H=512, fp32) and at ragged small shapes,
          with seams at 0, mid, T-1 and mixed per row.
4. train  the main path: Trainer.run_inline at the atari preset's widths
          (84x84x1 frames, nature encoder, hidden 512, burn-in / learning /
          forward 40/40/5, batch 64, fp32) on catch, with only the host
          replay sizes cut. The launch counters are zeroed just before it
          and read just after: every update launches the forward kernel
          twice (online and target unroll) and the seam backward once.
5. agree  one update's loss, priorities and gradient norm on a sampled
          batch at those widths, through the kernels on the card, against
          the same update through the plain versions on the CPU.
6. time   each kernel, its plain version, its bound and (forward only) the
          cuDNN LSTM on the same layer, with CUDA events, at the main path's
          shapes and with the seams of a batch the main path sampled; and
          the SM clock read while forward launches are queued.

The next-to-last lines are the kernels as one JSON object and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile N

adds N more updates of the main path under torch.profiler after phase 6 and
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

UPDATES = 8
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
        from r2d2_tpu_torch.config import PRESETS, set_fp32_numerics
        from r2d2_tpu_torch.ops import _build, lstm_kernel as K
        from r2d2_tpu_torch.train import Trainer
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
    _build.build(["lstm_fwd", "lstm_seq_bwd"])
    say("build", f"nvcc built lstm_fwd.cu and lstm_seq_bwd.cu in {time.perf_counter() - t:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    # 3. kernels against plain versions ------------------------------------
    errs = {"lstm_fwd": 0.0, "lstm_seq_bwd": 0.0}

    def check(T, B, H, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        s = H ** -0.5
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g)
        wh = (torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * s
        h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        p_outs, p_cs = K.lstm_fwd_plain(proj, wh, h0, c0)
        for got, want in ((outs, p_outs), (cs, p_cs)):
            e, ok = max_err(got, want)
            errs["lstm_fwd"] = max(errs["lstm_fwd"], e)
            if not ok:
                fail(f"lstm_fwd disagrees with its plain version at T={T} B={B} H={H}: {e:.3e}")
        hprev = torch.cat([h0[None], outs[:-1]])
        cprev = torch.cat([c0[None], cs[:-1]])
        dout = torch.randn(T, B, H, device=dev, generator=g)
        dcT = torch.randn(B, H, device=dev, generator=g)
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        for label, burn in (("0", torch.zeros_like(mixed)), ("mid", torch.full_like(mixed, T // 2)),
                            ("T-1", torch.full_like(mixed, T - 1)), ("mixed", mixed)):
            args = (dout, proj, hprev, cprev, cs, wh, dcT, burn)
            dz = K.lstm_seq_bwd(*args)
            e, ok = max_err(dz, K.lstm_seq_bwd_plain(*args))
            errs["lstm_seq_bwd"] = max(errs["lstm_seq_bwd"], e)
            if not ok:
                fail(f"lstm_seq_bwd disagrees at T={T} B={B} H={H} seam {label}: {e:.3e}")
            below = torch.arange(T, device=dev)[:, None] < burn[None, :].long()
            if dz[below].any():
                fail(f"lstm_seq_bwd: nonzero dz below the seam ({label}) at T={T} B={B} H={H}")
        torch.cuda.synchronize()
        say("check", f"T={T} B={B} H={H}: fwd and seam bwd (seams 0, mid, T-1, mixed) within "
            f"atol {ATOL} + rtol {RTOL}")

    for i, shape in enumerate(((7, 5, 32), (13, 67, 96), (3, 2, 640), (85, 64, 512))):
        check(*shape, seed=i)
    say("check", f"max |kernel - plain|: lstm_fwd {errs['lstm_fwd']:.3e}, "
        f"lstm_seq_bwd {errs['lstm_seq_bwd']:.3e} (tolerance {ATOL} + {RTOL}*|plain|)")

    # 4. the main path -------------------------------------------------------
    cfg = PRESETS["atari"]().replace(
        env_name="catch", compute_dtype="float32",
        buffer_capacity=16_000, learning_starts=2_000, training_steps=UPDATES,
    )
    tr = Trainer(cfg, device=dev)
    cfg = tr.cfg
    say("train", f"atari preset on catch: obs {cfg.obs_shape} {cfg.encoder}, hidden "
        f"{cfg.hidden_dim}, T={cfg.seq_len} ({cfg.burn_in_steps}/{cfg.learning_steps}/"
        f"{cfg.forward_steps}), batch {cfg.batch_size}, {cfg.num_actors} envs, "
        f"{cfg.resolved_compute_dtype}, arm {tr.backward_arm[0]}; cut: buffer_capacity "
        f"{cfg.buffer_capacity} (atari 2000000), learning_starts {cfg.learning_starts} "
        f"(atari 50000)")
    t = time.perf_counter()
    tr.warmup()
    say("train", f"warmup filled replay to {len(tr.replay)} transitions in "
        f"{time.perf_counter() - t:.1f}s")
    K.reset_launch_counts()
    t = time.perf_counter()
    tr.run_inline()
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    wall = time.perf_counter() - t
    m = tr.metrics()
    ms = [s * 1e3 for s in tr.update_seconds]
    say("train", f"{m['step']} updates in {wall:.2f}s: loss {m['loss']:.6f}, grad_norm "
        f"{m['grad_norm']:.4f}, q_mean {m['q_mean']:.4f}; ms/update first {ms[0]:.1f}, "
        f"median of the rest {statistics.median(ms[1:]):.2f} (host clock, ends in the "
        f"priorities' device->host copy)")
    say("train", f"launches during the main path: {launches}")
    if m["step"] != UPDATES or not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        fail(f"training did not finish with a finite loss: {m}")
    if launches != {"lstm_fwd": 2 * UPDATES, "lstm_seq_bwd": UPDATES}:
        fail(f"expected {2 * UPDATES} forward and {UPDATES} backward launches, got {launches}")

    # 5. one update on the card against the plain versions on the CPU -------
    from r2d2_tpu_torch.learner import DeviceBatch, make_loss_fn

    sampled = tr.replay.sample_batch(tr.sample_rng)
    loss_fn = make_loss_fn(cfg)
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
            fail(f"{name} through the kernels differs from the CPU's plain versions: {diff:.3e}")
        say("agree", f"{name}: card {a.flatten()[0].item():.6f} vs cpu "
            f"{b.flatten()[0].item():.6f} (max |diff| {diff:.3e}, rtol 1e-4 atol 1e-5)")

    # 6. timings at the main path's shapes ----------------------------------
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
    bwd_args = (dout, proj, hprev, cprev, cs, wh, dcT, burn)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    flush = scratch.zero_

    fwd_ms = median_ms(lambda: K.lstm_fwd(proj, wh, h0, c0), flush=flush)
    fwd_plain_ms = median_ms(lambda: K.lstm_fwd_plain(proj, wh, h0, c0), flush=flush)
    bwd_ms = median_ms(lambda: K.lstm_seq_bwd(*bwd_args), flush=flush)
    bwd_plain_ms = median_ms(lambda: K.lstm_seq_bwd_plain(*bwd_args), flush=flush)
    cudnn = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        cudnn_ms = median_ms(lambda: cudnn(x, (h0[None], c0[None])), flush=flush)
        layer_ms = median_ms(
            lambda: K.lstm_fwd((x.reshape(T * B, D) @ wi + bias).reshape(T, B, 4 * H), wh, h0, c0),
            flush=flush)
    say("time", f"one LSTM layer forward, input projection included, T={T} B={B} D={D} H={H}: "
        f"port (matmul + lstm_fwd) {layer_ms:.3f} ms, torch.nn.LSTM (cuDNN) {cudnn_ms:.3f} ms")

    # bounds: the bytes each function must move (inputs read once, outputs
    # written once) and its matmul FLOPs; the gate math adds under 1%
    f32 = 4
    fwd_flops = 2 * T * B * H * 4 * H
    fwd_bytes = f32 * (T * B * 4 * H + H * 4 * H + 2 * B * H + 2 * T * B * H)
    # the seam backward needs the gate recompute for steps t >= burn[b] and
    # the carry product for steps t > burn[b]; below the seam dz is zero
    kept = int((T - burn.long()).sum())
    carried = int((T - 1 - burn.long()).clamp(min=0).sum())
    bwd_flops = 2 * H * 4 * H * (kept + carried)
    bwd_bytes = f32 * (4 * T * B * H + T * B * 4 * H + H * 4 * H + B * H + B + T * B * 4 * H)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    kernels = []
    for name, src, replaces, t_ms, p_ms, (b_ms, b_by), lib_ms, flops, nbytes in (
        ("lstm_fwd", "r2d2_tpu_torch/csrc/lstm_fwd.cu", "r2d2_tpu/ops/pallas_lstm.py:68",
         fwd_ms, fwd_plain_ms, bound(fwd_flops, fwd_bytes), cudnn_ms, fwd_flops, fwd_bytes),
        ("lstm_seq_bwd", "r2d2_tpu_torch/csrc/lstm_seq_bwd.cu", "r2d2_tpu/ops/pallas_lstm.py:287",
         bwd_ms, bwd_plain_ms, bound(bwd_flops, bwd_bytes), None, bwd_flops, bwd_bytes),
    ):
        say("time", f"{name}: {t_ms:.3f} ms (plain {p_ms:.3f} ms), bound {b_ms:.4f} ms by "
            f"{b_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
            f"{flops / t_ms / 1e6:.1f} GFLOP/s = {b_ms / t_ms:.1%} of the bound; "
            f"launches on the main path {launches[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": t_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
    say("time", f"seams of the sampled batch: {sorted(set(sampled.burn_in_steps.tolist()))}, "
        f"backward steps kept {kept} of {T * B}")
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
