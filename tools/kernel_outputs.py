#!/usr/bin/env python3
"""Record the port's kernel outputs and times at fixed inputs on the card,
or compare two records: the check that a change to the kernels leaves the
forms it did not mean to change with the same bits, and the time of every
form at every shape beside another commit's.

    python3 tools/kernel_outputs.py save OUT [--root DIR]
    python3 tools/kernel_outputs.py compare A B

`save` runs every kernel form, the five kernels in float32 and in bf16, at
eight shapes (ragged small ones, the atari, wide B=96 and xl widths, and two
batches walked in row chunks), on inputs drawn from fixed seeds on the card
(K2, K4 and K5 with mixed seams; K5 at S=5 where 5 divides T, else 1, and
where T > 5 also at S=T, one segment: "lstm_seq_bwd_ckpt_whole"), and
the default arm's backward beside K4 ("default_pair": K2, then dWh =
hprev^T @ dz as one matmul outside it, the same function in two calls), and
writes to OUT each output's SHA-256, an evenly strided sample of at most
2^16 of its values, and the form's time (median of 5 launches, CUDA events,
each after a write of 64 MiB that evicts the 50 MB L2). `--root DIR`
imports r2d2_tpu_torch from DIR instead of this checkout, e.g. an unpacked
`git archive` of another commit; make both records in one run on one card.
`compare` prints, per form and shape, whether the two records hold the
same bits and, where they do not, the largest difference over the sample
against the sample's largest value, and the two times; for K1, K4 and K5
also the bound (bound_ms): the least time an H100 could take for the same
work, the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its matmul FLOPs (K4
and K5: on the (row, step) pairs the seams keep) over the FMA units' 67
TFLOP/s (float32) or the tensor cores' 989 TFLOP/s (bf16), as
chip_smoke.py counts them.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import hashlib
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (T, B, H): ragged small shapes, atari, xl, wide B=96, two row-chunk shapes
SHAPES = ((7, 5, 32), (13, 67, 96), (3, 2, 640), (85, 64, 512), (85, 64, 2048),
          (85, 96, 1024), (85, 1024, 512), (85, 256, 2048))
SAMPLE = 1 << 16
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12


def bound_ms(name, T, B, H, burn, S):
    """(ms, "bytes" or "operations") of K1, K4 or K5 (`name`, a bf16 form's
    ending in _bf16) at (T, B, H), K4 and K5 with seams `burn`, K5 at
    stride S; else None."""
    bf16 = name.endswith("_bf16")
    e, f4, mm, bh, bh4, h4h = (2 if bf16 else 4), 4, 2 * H * 4 * H, B * H, B * 4 * H, H * 4 * H
    kept = int((T - burn.long()).sum())
    carried = int((T - 1 - burn.long()).clamp(min=0).sum())
    if name.startswith("lstm_fwd"):
        flops, nbytes = mm * T * B, e * (T * bh4 + h4h + 2 * bh + T * bh) + f4 * T * bh
    elif name.startswith("lstm_seq_bwd_fused"):
        # the gate recompute and dWh on the kept (row, step) pairs, the carry
        # on the carried ones; proj, hprev, wh and the dz out in the compute
        # dtype, dout, cprev, cs, dcT, burn and dWh in f32
        flops = mm * (2 * kept + carried)
        nbytes = (e * (T * bh4 + T * bh + h4h + T * bh4)
                  + f4 * (3 * T * bh + bh + B + h4h))
    elif name.startswith("lstm_seq_bwd_ckpt"):
        flops = mm * (T * B + 2 * kept + carried)
        # proj, the checkpoints' h, wh and the dz out in the compute dtype;
        # dout, the checkpoints' c, dcT, burn and dWh in f32
        nbytes = (e * (T * bh4 + (T // S) * bh + h4h + T * bh4)
                  + f4 * (T * bh + (T // S) * bh + bh + B + h4h))
    else:
        return None
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def default_pair(K, walk, burn):
    """The default arm's backward: (dz, dWh) of K2 and one matmul."""
    dz = K.lstm_seq_bwd(*walk, burn)
    return dz, K._outer_dwh(walk[2], dz, walk[5])


def record(t):
    """(SHA-256 of the tensor's bytes, a strided f32 sample of its values)."""
    import torch

    t = t.detach().contiguous()
    digest = hashlib.sha256(t.view(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    flat = t.view(-1)
    step = max(1, flat.numel() // SAMPLE)
    return digest, flat[::step][:SAMPLE].float().cpu()


def median_ms(fn, flush, reps=5):
    """Median of `reps` timed calls (CUDA events) after one untimed call,
    each after `flush`."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def save(out, root):
    sys.path.insert(0, root)
    import torch
    from r2d2_tpu_torch.ops import lstm_kernel as K

    if not torch.cuda.is_available():
        sys.exit("kernel_outputs: needs a CUDA device")
    dev = torch.device("cuda")
    print(f"r2d2_tpu_torch from {os.path.dirname(os.path.dirname(os.path.dirname(K.__file__)))}"
          f" on {torch.cuda.get_device_name(0)}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    rec = {}
    for i, (T, B, H) in enumerate(SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(100 + i)
            proj = torch.randn(T, B, 4 * H, device=dev, generator=g).to(dt)
            wh = ((torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * H ** -0.5).to(dt)
            h0, c0 = ((torch.randn(B, H, device=dev, generator=g) * 0.3).to(dt) for _ in "hc")
            dout = torch.randn(T, B, H, device=dev, generator=g)
            dcT = torch.randn(B, H, device=dev, generator=g)
            burn = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
            outs, cs = K.lstm_fwd(proj, wh, h0, c0)
            walk = (dout, proj, torch.cat([h0[None], outs[:-1]]),
                    torch.cat([c0.float()[None], cs[:-1]]), cs, wh, dcT)
            S = 5 if T % 5 == 0 else 1
            ckpt = (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                    torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]]), wh, dcT, burn, S)
            whole = (dout, proj, h0[None], c0.float()[None], wh, dcT, burn, T)
            sfx = "" if dt == torch.float32 else "_bf16"
            forms = [("lstm_fwd", lambda: K.lstm_fwd(proj, wh, h0, c0)),
                     ("lstm_seq_bwd", lambda: (K.lstm_seq_bwd(*walk, burn),)),
                     ("lstm_bwd", lambda: K.lstm_bwd(*walk)),
                     ("lstm_seq_bwd_fused", lambda: K.lstm_seq_bwd_fused(*walk, burn)),
                     ("lstm_seq_bwd_ckpt", lambda: K.lstm_seq_bwd_ckpt(*ckpt))]
            if T > 5:
                forms.append(("lstm_seq_bwd_ckpt_whole", lambda: K.lstm_seq_bwd_ckpt(*whole)))
            forms.append(("default_pair", lambda: default_pair(K, walk, burn)))
            for name, fn in forms:
                s = T if name.endswith("whole") else S
                rec[(name + sfx, (T, B, H))] = ([record(x) for x in fn()], median_ms(fn, flush),
                                                bound_ms(name + sfx, T, B, H, burn, s))
        print(f"T={T} B={B} H={H}: every form in float32 and bf16 recorded", flush=True)
    torch.save(rec, out)
    print(f"{len(rec)} output sets -> {out}")


def compare(a_path, b_path):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    same = 0
    for key in sorted(set(a) | set(b)):
        name, shape = key
        if key not in a or key not in b:
            print(f"{name} {shape}: in one record only")
            continue
        (outs_a, ms_a, bound), (outs_b, ms_b, _) = a[key], b[key]
        times = f"; {ms_a:.3f} ms, {ms_b:.3f} ms"
        if bound:
            times += f" (bound {bound[0]:.4f} ms by {bound[1]})"
        diffs = []
        for (ha, sa), (hb, sb) in zip(outs_a, outs_b):
            if ha == hb:
                diffs.append(None)
            else:
                diffs.append((float((sa - sb).abs().max()), float(sa.abs().max())))
        if all(d is None for d in diffs):
            same += 1
            print(f"{name} {shape}: the same bits{times}")
        else:
            print(f"{name} {shape}: differs: " + ", ".join(
                "same bits" if d is None else f"max |diff| {d[0]:.3e} of max |value| {d[1]:.3e}"
                for d in diffs) + times)
    print(f"{same} of {len(set(a) | set(b))} output sets hold the same bits")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("out")
    s.add_argument("--root", default=HERE, help="the checkout to import r2d2_tpu_torch from")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "save":
        save(args.out, os.path.abspath(args.root))
    else:
        compare(args.a, args.b)


if __name__ == "__main__":
    main()
