"""The EMD kernels' instructions and occupancy, as the card's compiler
builds `csrc/emd.cu` (kernels 4, 5 and 6): a measurement, run by hand on
a machine with `nvcc` and a card, not part of any path.

    python -m go_with_the_flows_tpu_torch.tools.emd_sass [--out DIR]
        [--lib SO]

It builds the kernel library (`ops/kernels/build.py`), disassembles it
with `cuobjdump -sass`, and prints, for `emd_cost_kernel` and
`pairwise_emd_kernel`, each innermost loop's instructions, MUFU.EX2,
MUFU.RSQ and shared-memory loads, per point pair, and the instructions
a point pair over a pair's 19 passes. The loop kinds are the present
design's: exps without a root are sweep 1 or a column pass (10 passes),
twice as many exps as roots the fused row pass (8), other loops with
roots the last level's sweep 3 (1). For `emd_backward_kernel` it
prints, for each innermost loop with roots (one root a point pair a
pass), its issue slots, MUFU, shared-memory loads (LDS) and shuffles
(SHFL) a point pair, and their sum over the loops: a point pair of the
function, however many passes form it. Then it builds a probe that
includes `csrc/emd.cu` and prints how many forward blocks fit on one SM
(`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) at 2,048 and 2,500
points, and how many backward blocks. The SASS and the probe go to DIR
(default: the build directory). `--lib` reads another build of the
library instead (for example an older checkout's; no probe then).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess

from ..ops.kernels import build

# forward passes a pair makes over its point pairs, by loop kind
PASSES = {"EX2 only": 10, "fused": 8, "last": 1}
# special-function operations per point pair, by loop kind
MUFU = {"EX2 only": 1, "fused": 3, "last": 2}

PROBE = r"""
#include "%s"
extern "C" int probe_threads(int N, int M) {
  return block_threads(N, M, kRows);
}
extern "C" int probe_backward_blocks_per_sm() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, emd_backward_kernel, kBwdThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
extern "C" int probe_blocks_per_sm(int N, int M) {
  int blocks = -1;
  const int smem = static_cast<int>(forward_smem(N, M));
  if (cudaFuncSetAttribute(pairwise_emd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, pairwise_emd_kernel, block_threads(N, M, kRows),
          smem) != cudaSuccess)
    return -1;
  return blocks;
}
"""


def inner_loops(lines):
    """(first address, instructions, MUFU.EX2, MUFU.RSQ, LDS, SHFL) of each
    innermost loop of one function's SASS, in address order: a loop is a
    branch back to an earlier address, innermost if no other such branch
    lies inside it."""
    instr = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            instr.append((int(m.group(1), 16), m.group(2).strip()))
    backs = []
    for addr, text in instr:
        b = re.search(r"\bBRA(?:\.\w+)*\s+0x([0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            backs.append((int(b.group(1), 16), addr))
    loops = []
    for lo, hi in backs:
        if any(lo <= a < hi and (a, t) != (hi, lo)
               for t, a in backs if lo <= t):
            continue
        body = [t for a, t in instr if lo <= a <= hi]
        loops.append((lo, len(body),
                      sum("MUFU.EX2" in t for t in body),
                      sum("MUFU.RSQ" in t for t in body),
                      sum(re.search(r"\bLDS\b|\bLDS\.", t) is not None
                          for t in body),
                      sum("SHFL" in t for t in body)))
    return sorted(loops)


def sass_report(out_dir: str, lib_path: str) -> None:
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or ""
    if not tool:
        raise SystemExit("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name:
            funcs[name].append(line)
    with open(os.path.join(out_dir, "emd.sass"), "w") as f:
        for fname, lines in funcs.items():
            if "emd" in fname:
                f.write(f"Function : {fname}\n" + "\n".join(lines) + "\n")
    for kernel in ("emd_cost_kernel", "pairwise_emd_kernel"):
        hits = [ls for n, ls in funcs.items() if kernel in n]
        if not hits:
            raise SystemExit(f"{kernel} is not in the library")
        best = {}
        for lo, n, ex2, rsq, lds, _ in inner_loops(hits[0]):
            if ex2 == 0:
                continue
            kind = ("EX2 only" if rsq == 0 else
                    "fused" if ex2 == 2 * rsq else "last")
            elems = ex2 if rsq == 0 else rsq
            print(f"{kernel} loop at {lo:#x} ({kind}): {n} instructions, "
                  f"{ex2} MUFU.EX2, {rsq} MUFU.RSQ, {lds} LDS for {elems} "
                  f"point pairs: {n / elems:.2f} a pair")
            # each kind's main loop: the one that does the most pairs at once
            if elems > best.get(kind, (0, 0.0))[0]:
                best[kind] = (elems, n / elems)
        if set(best) != set(PASSES):
            print(f"{kernel}: loop kinds {sorted(best)}, not this design's "
                  "three; no per-pair total")
            continue
        total = sum(PASSES[k] * best[k][1] for k in PASSES)
        mufu = sum(PASSES[k] * MUFU[k] for k in PASSES)
        print(f"{kernel}: {total:.1f} instructions and {mufu} MUFU a point "
              "pair over the 19 passes (each kind's main loop)")
    hits = [ls for n, ls in funcs.items() if "emd_backward_kernel" in n]
    if not hits:
        raise SystemExit("emd_backward_kernel is not in the library")
    total = [0.0] * 4
    for lo, n, ex2, rsq, lds, shfl in inner_loops(hits[0]):
        if rsq:
            per = (n / rsq, (ex2 + rsq) / rsq, lds / rsq, shfl / rsq)
            total = [t + p for t, p in zip(total, per)]
            print(f"emd_backward_kernel loop at {lo:#x}: {n} instructions, "
                  f"{ex2} MUFU.EX2, {rsq} MUFU.RSQ, {lds} LDS, {shfl} SHFL "
                  f"for {rsq} point pairs: a pair {per[0]:.2f} issue slots, "
                  f"{per[1]:.2f} MUFU, {per[2]:.3f} LDS, {per[3]:.3f} SHFL")
    print(f"emd_backward_kernel: a point pair of the function over its "
          f"loops with roots: {total[0]:.2f} issue slots, {total[1]:.2f} "
          f"MUFU, {total[2]:.3f} LDS, {total[3]:.3f} SHFL")


def occupancy_report(out_dir: str) -> None:
    src = os.path.join(out_dir, "emd_probe.cu")
    lib_path = os.path.join(out_dir, "libemd_probe.so")
    with open(src, "w") as f:
        f.write(PROBE % os.path.join(build.CSRC, "emd.cu"))
    subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    for n in (2048, 2500):
        print(f"forward at N = M = {n}: {lib.probe_threads(n, n)} threads, "
              f"{24 * 2 * n} B of shared memory, "
              f"{lib.probe_blocks_per_sm(n, n)} block(s) per SM")
    print(f"backward: {lib.probe_backward_blocks_per_sm()} block(s) per SM")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=build.BUILD_DIR)
    parser.add_argument("--lib", default=None)
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.lib:
        sass_report(args.out, args.lib)
        return
    build.build()
    sass_report(args.out, build.LIB_PATH)
    occupancy_report(args.out)


if __name__ == "__main__":
    main()
