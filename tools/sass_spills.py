#!/usr/bin/env python3
"""Where the column-split kernels spill: ptxas's registers and spill bytes
for every kernel instantiation, and each local-memory access (STL, LDL) in
its SASS with the loops around it.

    python3 tools/sass_spills.py [--root DIR]

Builds the kernels of the checkout at DIR (default this one; e.g. an
unpacked `git archive` of another commit) with r2d2_tpu_torch.ops._build,
whose flags carry `-Xptxas -v`, and disassembles each library with
cuobjdump. A loop is the address range from a backward branch's target to
the branch; an access's depth is the number of such ranges around it (the
walk's step loop is one, a tile loop inside a step two, a loop inside a
tile three). Prints, per kernel, ptxas's line and the STL and LDL counts
at each depth. Needs nvcc and cuobjdump (the CUDA toolkit), not a card.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an instruction line of cuobjdump -sass: /*0a30*/  [@P0] OPCODE ...
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def ptxas_lines(log):
    """{mangled kernel: 'N registers, S bytes spill stores, L bytes spill
    loads'} from nvcc's -Xptxas -v text."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def local_accesses(function):
    """[(opcode, depth)] of the STL and LDL of one function's SASS."""
    insns = []
    for m in _INSN.finditer(function):
        insns.append((int(m.group(1), 16), m.group(3), m.group(4)))
    loops = []
    for addr, op, rest in insns:
        if op.startswith("BRA"):
            t = _TARGET.search(rest)
            if t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
    return [(op.split(".")[0], sum(lo <= addr <= hi for lo, hi in loops))
            for addr, op, _ in insns if op.split(".")[0] in ("STL", "LDL")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout to build the kernels of")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from r2d2_tpu_torch.ops import _build

    libs = _build.build(_build.sources())
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    print(f"kernels of {os.path.abspath(args.root)}", flush=True)
    for src, path in sorted(libs.items()):
        info = ptxas_lines(_build.build_logs.get(src, ""))
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        for function in sass.split("Function : ")[1:]:
            name = function.split("\n", 1)[0].strip()
            acc = local_accesses(function)
            by = {}
            for op, depth in acc:
                by[(op, depth)] = by.get((op, depth), 0) + 1
            i = info.get(name, {})
            spills = i.get("spills")
            print(f"{src} {name}: {i.get('registers', '?')} registers, spill stores/loads "
                  f"{spills if spills else '? (built before this process)'} bytes; "
                  f"local accesses {len(acc)}"
                  + "".join(f", {op} at depth {d}: {n}" for (op, d), n in sorted(by.items())),
                  flush=True)


if __name__ == "__main__":
    main()
