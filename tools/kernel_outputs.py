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
(K2, K4 and K5 with mixed seams; K5 at S=5 where 5 divides T, else 1), and
writes to OUT each output's SHA-256, an evenly strided sample of at most
2^16 of its values, and the form's time (median of 5 launches, CUDA events,
each after a write of 64 MiB that evicts the 50 MB L2). `--root DIR`
imports r2d2_tpu_torch from DIR instead of this checkout, e.g. an unpacked
`git archive` of another commit; make both records in one run on one card.
`compare` prints, per form and shape, whether the two records hold the
same bits and, where they do not, the largest difference over the sample
against the sample's largest value, and the two times.

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
            sfx = "" if dt == torch.float32 else "_bf16"
            for name, fn in (("lstm_fwd", lambda: K.lstm_fwd(proj, wh, h0, c0)),
                             ("lstm_seq_bwd", lambda: (K.lstm_seq_bwd(*walk, burn),)),
                             ("lstm_bwd", lambda: K.lstm_bwd(*walk)),
                             ("lstm_seq_bwd_fused", lambda: K.lstm_seq_bwd_fused(*walk, burn)),
                             ("lstm_seq_bwd_ckpt", lambda: K.lstm_seq_bwd_ckpt(*ckpt))):
                rec[(name + sfx, (T, B, H))] = ([record(x) for x in fn()], median_ms(fn, flush))
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
        (outs_a, ms_a), (outs_b, ms_b) = a[key], b[key]
        times = f"; {ms_a:.3f} ms, {ms_b:.3f} ms"
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
