#!/usr/bin/env python3
"""The instructions nvcc emits for the Keccak permutation, against the cost model.

``utils/roofline.py`` counts the least 32-bit instructions of a Keccak-f[1600]
round (``KECCAK_ROUND_OPS``: every logical function of up to three inputs one
LOP3 a 32-bit half, a 64-bit rotation two funnel shifts). This script builds
``csrc/transcript_kernels.cu``, disassembles its library with ``cuobjdump``
and, for ``keccak_f_kernel`` and each instantiation of ``round_step_kernel``
(rows, first round or not, and where a tree has it the permutation's
variant), prints the opcode counts of the whole function and of each loop
(the instructions from a backward branch's target to the branch), so the
permutation can be read against the model: unrolled, it has no loop, and pi's
renaming of the lanes costs no MOV. Needs the CUDA toolkit; no card is used beyond the build:

    python3 scripts/keccak_sass.py [--dump FILE]

``--dump`` also writes the library's whole disassembly to FILE.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zktpu_torch import _build  # noqa: E402
from zktpu_torch.utils import roofline  # noqa: E402

KERNELS = ("keccak_f_kernel", "round_step_kernel")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def functions(sass: str):
    """(function name -> its (address, instruction) list, function name +
    label -> the address of the instruction after the label)."""
    out: dict[str, list[tuple[int, str]]] = {}
    labels: dict[str, int] = {}
    current, pending = None, []
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            out[current] = []
            continue
        if current is None:
            continue
        found = _LABEL.match(line)
        if found:
            pending.append(found.group(1))
            continue
        found = _INSN.search(line)
        if found:
            addr = int(found.group(1), 16)
            for label in pending:
                labels[current + label] = addr
            pending = []
            out[current].append((addr, found.group(2)))
    return out, labels


def opcode(insn: str) -> str:
    words = insn.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def histogram(insns) -> str:
    counts = collections.Counter(opcode(i) for _, i in insns)
    return f"{sum(counts.values())} instructions: " + ", ".join(
        f"{op} {n}" for op, n in counts.most_common())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dump", help="write the whole disassembly here")
    args = parser.parse_args()
    path = _build.cuda_library_path("transcript_kernels")
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    if args.dump:
        with open(args.dump, "w") as f:
            f.write(sass)
    print(f"model: {roofline.KECCAK_ROUND_OPS} instructions a round, "
          f"{roofline.KECCAK_F_OPS} a permutation (utils/roofline.py)")
    found = set()
    insns_of, labels = functions(sass)
    for name, insns in insns_of.items():
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        found.add(kernel)
        args = re.findall(r"L(?:i|b|N[^E]*E)(\d+)E", name.split(kernel, 1)[1].split("EE", 1)[0] + "E")
        print(f"{kernel}{'<' + ', '.join(args) + '>' if args else ''}: {histogram(insns)}")
        for addr, insn in insns:
            target = _TARGET.search(insn)
            if not target:
                continue
            start = (labels.get(name + target.group(1)) if target.group(1)
                     else int(target.group(2), 16))
            if start is not None and start < addr:
                body = [(a, i) for a, i in insns if start <= a <= addr]
                print(f"  loop {start:#06x}-{addr:#06x}: {histogram(body)}")
    if found != set(KERNELS):
        print(f"found {sorted(found)} of the kernels {KERNELS} in the SASS", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
