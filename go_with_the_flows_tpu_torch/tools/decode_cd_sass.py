"""Instructions of the eval decode (kernel 1, `csrc/point_decode.cu`), of
the nearest-neighbour distances (kernel 2, `csrc/nn_distance.cu`) and of
the pairwise Chamfer grid (kernel 3, `csrc/pairwise_cd.cu`) as the card's
compiler builds them: a measurement, run by hand on a machine with
`nvcc`, not part of any path.

    python -m go_with_the_flows_tpu_torch.tools.decode_cd_sass [--lib SO]
        [--points P] [--f F] [--mode MODE] [--distance-kernels NAME ...]
        [--out DIR]

It disassembles the kernel library (`cuobjdump -sass`; by default this
checkout's, built first) and prints:

  * kernel 1 at FP = 40 (f = 37) in the precision mode --mode (default
    'highest'; a build without modes is read as 'highest'), both
    directions: at 'highest' (and in a build from before the tensor-core
    modes) issue slots, FFMA and shared-memory loads (LDS) a point and
    coupling, from the coupling loop's own instructions and f times each
    head's W1 row loop, divided by the points a thread carries (P, as the
    source sets it unless given); loops nested in the coupling loop that
    are not W1 row loops (staging loops) are printed apart, by the
    iteration; at 'high' and 'fast' (a thread a point, the products on
    the tensor cores) the coupling loop's own instructions, HMMA, LDS and
    SHFL, and each loop nested in it (the heads' loop, a loop over the
    16-row halves, staging) apart, by the iteration: a warp's issue slots
    for its 32 points;
  * kernels 2 (`nn_distance_kernel`, with and without the indices) and 3
    (`cd_stats_kernel`), or the kernels `--distance-kernels` names: issue
    slots, FMNMX, SHFL and LDS a point pair, from the innermost loops
    that form distances (3 FMUL a distance), the ones with the most
    distances an iteration (one a pass over all pairs); a loop nested in
    one of them is counted once an iteration.

`--lib` takes another build of the library (for example an older
checkout's, with `--points 1` and its kernels' names). The SASS goes to
DIR (default: the build directory) as decode_cd.sass.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess

from ..ops.kernels import build

OPS = ("FFMA", "FMUL", "FMNMX", "LDS", "SHFL", "BAR", "LDGSTS", "HMMA")
MODES = ("highest", "high", "fast")  # kernel 1's MODE template argument


def functions(lib_path: str):
    """{mangled name: [(address, instruction)]} of the library's SASS."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or ""
    if not tool:
        raise SystemExit("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def counts(instr):
    """Instructions and the OPS among them (predicates and modifiers
    aside) of a list of (address, instruction)."""
    out = {"all": len(instr)}
    for op in OPS:
        out[op] = sum(re.match(rf"(@!?U?P\w+\s+)?{op}(32I)?\b", t)
                      is not None
                      for _, t in instr)
    return out


def loops(instr):
    """(first, last address) of each loop: a branch back to an earlier
    address."""
    found = []
    for addr, text in instr:
        b = re.search(r"\bBRA(?:\.\w+)*\s+0x([0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            found.append((int(b.group(1), 16), addr))
    return sorted(set(found))


def inside(loop, other):
    return other != loop and loop[0] <= other[0] and other[1] <= loop[1]


def body(instr, loop, holes=()):
    return [(a, t) for a, t in instr if loop[0] <= a <= loop[1]
            and not any(h[0] <= a <= h[1] for h in holes)]


def point_decode_report(instr, P, f, FP, tag, mode="highest"):
    every = loops(instr)
    innermost = [lp for lp in every if not any(inside(lp, o) for o in every)]
    # a W1 row's FMAs a thread: dot, FiLM, W2; at 'high' two a product
    per_row = P * (2 * FP + 7 if mode == "high" else FP + 4)
    rows = {lp: round(counts(body(instr, lp))["FFMA"] / per_row)
            for lp in innermost}
    row_loops = [lp for lp in innermost if rows[lp] >= 1
                 and counts(body(instr, lp))["LDS"] > 0]
    if not row_loops:
        print(f"{tag}: no W1 row loop found")
        return
    coupling = min((lp for lp in every
                    if all(inside(lp, r) for r in row_loops)),
                   key=lambda lp: lp[1] - lp[0], default=None)
    if coupling is None:
        print(f"{tag}: no loop holds the W1 row loops")
        return
    nested = [lp for lp in every if inside(coupling, lp)]
    outer_nested = [lp for lp in nested
                    if not any(inside(o, lp) for o in nested)]
    own = counts(body(instr, coupling, outer_nested))
    unroll = max(rows[lp] for lp in row_loops)
    main = [lp for lp in row_loops if rows[lp] == unroll]
    total = dict(own)
    for lp in main:
        c = counts(body(instr, lp))
        print(f"{tag}: W1 row loop at {lp[0]:#x}: {c['all']} instructions, "
              f"{c['FFMA']} FFMA, {c['LDS']} LDS for {unroll} row(s) of "
              f"{P} point(s)")
        for k in total:
            total[k] += f * c[k] / unroll
    for lp in outer_nested:
        if lp not in row_loops:
            c = counts(body(instr, lp))
            print(f"{tag}: other loop in the coupling loop at {lp[0]:#x} "
                  f"(staging): {c['all']} instructions an iteration, "
                  f"{c['LDGSTS']} LDGSTS")
    print(f"{tag}: coupling loop's own {own['all']} instructions, "
          f"{own['LDS']} LDS, {own['BAR']} BAR; a point and coupling at "
          f"f = {f}: {total['all'] / P:.0f} issue slots, "
          f"{total['FFMA'] / P:.0f} FFMA, {total['LDS'] / P:.0f} LDS "
          "(staging loops aside)")


def point_decode_tc_report(instr, tag):
    """Kernel 1 at 'high' and 'fast': the coupling loop (the outermost
    loop that holds the block barrier) by its own instructions and its
    nested loops, each by the iteration."""
    every = loops(instr)
    barred = [lp for lp in every if counts(body(instr, lp))["BAR"] > 0]
    if not barred:
        print(f"{tag}: no coupling loop found")
        return
    coupling = max(barred, key=lambda lp: lp[1] - lp[0])
    nested = [lp for lp in every if inside(coupling, lp)]
    outer_nested = [lp for lp in nested
                    if not any(inside(o, lp) for o in nested)]
    own = counts(body(instr, coupling, outer_nested))
    print(f"{tag}: coupling loop's own {own['all']} instructions (a warp, "
          f"32 points), {own['HMMA']} HMMA, {own['LDS']} LDS, "
          f"{own['SHFL']} SHFL, {own['FFMA']} FFMA, {own['BAR']} BAR")
    for lp in outer_nested:
        c = counts(body(instr, lp))
        print(f"{tag}: loop in the coupling loop at {lp[0]:#x}: {c['all']} "
              f"instructions an iteration, {c['HMMA']} HMMA, {c['LDS']} LDS, "
              f"{c['LDGSTS']} LDGSTS")


def cd_stats_report(instr, tag):
    every = loops(instr)
    # the innermost loops that form distances (nested loops without FMUL,
    # such as an exchange left as a loop, counted once in their body)
    fmul = {lp: counts(body(instr, lp))["FMUL"] for lp in every}
    dist = {lp: counts(body(instr, lp)) for lp in every
            if fmul[lp] >= 3 and not any(
                inside(lp, o) and fmul[o] >= 3 for o in every)}
    if not dist:
        print(f"{tag}: no distance loop found")
        return
    most = max(c["FMUL"] for c in dist.values())
    per_pair = {k: 0.0 for k in ("all",) + OPS}
    for lp, c in dist.items():
        pairs = c["FMUL"] // 3
        nested = sum(inside(lp, o) for o in every)
        print(f"{tag}: distance loop at {lp[0]:#x}: {c['all']} instructions "
              f"for {pairs} point pairs ({c['all'] / pairs:.2f} a pair), "
              f"{c['FMNMX']} FMNMX, {c['SHFL']} SHFL, {c['LDS']} LDS, "
              f"{c['BAR']} BAR; {nested} nested loop(s)")
        if c["FMUL"] == most:
            for k in per_pair:
                per_pair[k] += c[k] / pairs
    print(f"{tag}: a point pair of the function: {per_pair['all']:.2f} issue "
          f"slots, {per_pair['FMNMX']:.2f} FMNMX, {per_pair['SHFL']:.3f} "
          f"SHFL, {per_pair['LDS']:.3f} LDS (the main distance loops, one a "
          "pass over all pairs)")


def points_a_thread(FP: int, mode: str = "highest") -> int:
    """Kernel 1's points a thread at width FP at 'highest', as the source
    sets them ('high' and 'fast' take one)."""
    if mode != "highest":
        return 1
    with open(os.path.join(build.CSRC, "point_decode.cu")) as f:
        text = f.read()
    const = {name: int(value) for name, value in
             re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    P = (const["kNarrowPoints"] if FP <= const["kNarrowFP"]
         else const["kWidePoints"])
    return P


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lib", default=None)
    parser.add_argument("--points", type=int, default=None)
    parser.add_argument("--f", type=int, default=37)
    parser.add_argument("--mode", default="highest",
                        choices=["highest", "high", "fast"])
    parser.add_argument("--distance-kernels", nargs="+",
                        default=["nn_distance_kernel", "cd_stats_kernel"])
    parser.add_argument("--out", default=build.BUILD_DIR)
    args = parser.parse_args()
    lib = args.lib
    if lib is None:
        build.build()
        lib = build.LIB_PATH
    FP = (args.f + 7) // 8 * 8
    P = args.points or points_a_thread(FP, args.mode)
    funcs = functions(lib)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "decode_cd.sass"), "w") as f:
        for name, instr in funcs.items():
            if any(k in name for k in ("point_decode_kernel",
                                       *args.distance_kernels)):
                f.write(f"Function : {name}\n" + "".join(
                    f"/*{a:04x}*/ {t};\n" for a, t in instr))
    for name, instr in sorted(funcs.items()):
        m = re.search(r"point_decode_kernelILi(\d+)ELb([01])E(?:Li(\d)E)?",
                      name)
        if m:
            if int(m.group(1)) == FP and MODES[int(m.group(3) or 0)] \
                    == args.mode:
                tag = (f"point_decode {args.mode} FP={FP} "
                       f"{'inverse' if m.group(2) == '1' else 'direct'}")
                if any("HMMA" in t for _, t in instr):
                    point_decode_tc_report(instr, tag)
                else:
                    point_decode_report(instr, P, args.f, FP, tag, args.mode)
            continue
        for kernel in args.distance_kernels:
            if kernel in name:
                idx = re.search(r"ILb([01])E", name)
                cd_stats_report(instr, kernel if idx is None else
                                f"{kernel} with"
                                + ("" if idx.group(1) == "1" else "out")
                                + " idx")


if __name__ == "__main__":
    main()
