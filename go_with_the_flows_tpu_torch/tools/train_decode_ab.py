"""Kernels 7 and 8 of two versions of their CUDA source side by side on the
card: a measurement, run by hand on a machine with `nvcc` and a card, not
part of any path.

    python -m go_with_the_flows_tpu_torch.tools.train_decode_ab \
        --parent DIR [--out DIR] [--turns 2]

DIR is another checkout of the repository (an older commit, unpacked
with `git archive`); its `go_with_the_flows_tpu_torch/csrc/train_decode*`
files are the parent (one `train_decode.cu`, or a `train_decode.cuh` and
the units that include it). Both versions are compiled alone, one after
the other from the same directory (the instruction schedule of some
functions depends on the file's path), with the library's flags
(`ops/kernels/build.py`) into DIR/_train_decode_ab/. Then:

  * SASS (`cuobjdump -sass`): for every kernel function of the parent,
    whether this checkout's instantiation of it in the same MODE (the
    same name where the function has no MODE) has the same instructions
    at the same addresses (the encoding words left out): equal, or the
    count of lines that differ (an instruction more or less shifts every
    line after it), with both instruction counts and the opcodes whose
    counts differ;
  * time: kernel 7 (`gwtf_train_decode_fwd`) and kernel 8
    (`gwtf_train_decode_bwd`) of both libraries at 'highest' (and at
    'high' and 'fast', the weights split or rounded, where both take a
    mode) on the flagship's inputs (K=4, B=64, N=2048, 11 flows of f=37:
    random weights from seed 19, as chip_smoke.py's phase 2 makes them),
    in turns parent, this, this, parent (`--turns` times), each the mean
    of CUDA-event windows; whether both libraries' outputs are equal bit
    for bit, by kernel and mode (kernel 8 of both on the same residuals,
    the parent's forward's); the ratio this / parent per kernel.

`--control` compiles the parent a second time and prints which kernels'
SASS differ between its two builds. The parent's C entries may predate
the `mode` argument, and its workspace entry the mode after the sizes:
the tool reads the parent source to call them either way. A last line
holds the summary as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

from ..ops.kernels import build

_CSRC = os.path.join("go_with_the_flows_tpu_torch", "csrc")


def source_files(csrc):
    """The kernels' source files in a csrc directory: train_decode.cu, and
    the header and the per-mode units where the source is split, and the
    tensor-core step's header where the kernels include it."""
    import glob

    return sorted(glob.glob(os.path.join(csrc, "train_decode*.cu"))
                  + glob.glob(os.path.join(csrc, "train_decode*.cuh"))
                  + glob.glob(os.path.join(csrc, "mma_bf16.cuh")))


def compile_all(sources, out_dir):
    """Compile each version (a csrc directory) alone into
    out_dir/<tag>.so, one after the other from the same directory,
    out_dir/src/ (a version's units by one nvcc each, at once, as
    build.py does): the compiler names the anonymous namespace after the
    file's path, and those names move the instruction schedule of some
    functions (two compiles of one source from two paths differ in
    bwd_dw1_kernel's SASS)."""
    import shutil

    at = os.path.join(out_dir, "src")
    nvcc = build._nvcc()
    out = {}
    for tag, csrc in sources.items():
        shutil.rmtree(at, ignore_errors=True)
        os.makedirs(at)
        units = [f for f in (shutil.copy(f, at) for f in source_files(csrc))
                 if f.endswith(".cu")]
        objs = [u[:-3] + ".o" for u in units]
        procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", o, u],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for u, o in zip(units, objs)]
        logs = [p.communicate()[0] for p in procs]
        so = os.path.join(out_dir, f"{tag}.so")
        for u, p, log in zip(units, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {tag} "
                                   f"{os.path.basename(u)}:\n{log[-4000:]}")
        link = subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", so]
                              + objs, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed on {tag}:\n"
                               f"{link.stdout[-4000:]}")
        out[tag] = so
    return out


def sass_functions(so):
    """{function name: [instruction text]} of a library's SASS."""
    text = subprocess.run(["cuobjdump", "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?;)", line)
        if m and name:
            funcs[name].append(" ".join(m.group(2).split()))
    return funcs


# the __global__ functions of kernels 7 and 8
KERNELS = ("seed_moments_kernel", "fwd_hidden_kernel", "fwd_stats_kernel",
           "group_sums_kernel", "bn1_stats_kernel", "moment_rows_kernel",
           "scale_sums_kernel", "fwd_update_kernel", "sum_rows_kernel",
           "bwd_head_kernel", "bwd_hidden_kernel", "bwd_dw1_kernel",
           "bwd_input_kernel")


def kernel_key(name):
    """(kernel, FP, MODE) of a mangled kernel name; MODE 0 where the
    function takes none; None for another function."""
    m = re.search("(" + "|".join(KERNELS) + r")(?:ILi(\d+)E(?:Li(\d)E)?E)?",
                  name)
    if not m:
        return None
    fp, mode = m.group(2), m.group(3)
    if m.group(1) == "seed_moments_kernel":
        fp, mode = None, fp  # seed_moments_kernel<MODE>
    return m.group(1), int(fp) if fp else None, int(mode or 0)


def opcode_delta(a, b):
    """{opcode: count in b less count in a} where they differ."""
    from collections import Counter

    def ops(lines):
        return Counter(line.split()[0] if not line.startswith("@")
                       else line.split()[1] for line in lines)

    pa, pb = ops(a), ops(b)
    return {op: pb[op] - pa[op] for op in sorted(set(pa) | set(pb))
            if pb[op] != pa[op]}


def compare_sass(parent_so, this_so, out_dir=None):
    """[(kernel, FP, MODE, lines differing or 0, (parent's instructions,
    this one's, opcode_delta))] for each parent kernel; the two listings
    of a kernel that differs go to out_dir."""
    parent = {kernel_key(n): v for n, v in sass_functions(parent_so).items()}
    this = {kernel_key(n): v for n, v in sass_functions(this_so).items()}
    rows = []
    for key in sorted(k for k in parent if k is not None):
        if key not in this:
            rows.append(key + (None, None))
            continue
        a, b = parent[key], this[key]
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        rows.append(key + (diff, (len(a), len(b), opcode_delta(a, b))))
        if diff and out_dir:
            name = (f"{key[0]}_{key[1]}" if key[1] else key[0]) + \
                f"_m{key[2]}"
            for tag, lines in (("parent", a), ("this", b)):
                with open(os.path.join(out_dir, f"{name}.{tag}.sass"),
                          "w") as f:
                    f.write("\n".join(lines) + "\n")
    return rows


def takes_mode(csrc):
    text = "".join(open(f).read() for f in source_files(csrc))
    return "int f, int mode" in text or "GWTF_DIMS, int mode" in text


def workspace_takes_mode(csrc):
    """Whether the source's gwtf_train_decode_workspace takes the mode
    after the sizes (the forward keeps its h2 cache at 'highest' only)."""
    text = "".join(open(f).read() for f in source_files(csrc))
    return re.search(r"gwtf_train_decode_workspace\([^)]*int f,\s*int mode\)",
                     text) is not None


def flagship_inputs():
    import torch

    from ..models.mixture import FlowMixtureModel
    from ..ops.kernels.train_decode import (film_ab_train,
                                            pack_point_decoder_train)
    from ..utils.config import FLAGSHIP_AIRPLANE

    gen = torch.Generator().manual_seed(19)
    model = FlowMixtureModel(**FLAGSHIP_AIRPLANE, generator=gen)
    dec = model.pc_decoder.cuda()
    packed = {k: v.detach() for k, v in pack_point_decoder_train(dec).items()}
    g = torch.randn(64, model.g_latent_space_size, generator=gen).cuda()
    ab, _ = film_ab_train(packed, g)
    p = 0.3 * torch.randn(model.n_components, 64, 3, 2048,
                          generator=gen).cuda()
    return packed, ab.detach().contiguous(), p


def runner(so, with_mode, mode=0, ws_mode=False):
    """fwd(), bwd() of one library in `mode` (a kernel MODE; 'highest'
    when the library takes none) on the flagship inputs, each returning
    its outputs; `ws_mode`: its workspace entry takes the mode."""
    import torch

    from ..ops.kernels.point_decode import KERNEL_MODES
    from ..ops.kernels.train_decode import _KERNEL_KEYS, kernel_weights_train

    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    extra = [I] if with_mode else []
    lib.gwtf_train_decode_fwd.argtypes = [P] * 13 + [I] * 5 + extra + [P]
    lib.gwtf_train_decode_bwd.argtypes = [P] * 20 + [I] * 5 + extra + [P]
    lib.gwtf_train_decode_workspace.argtypes = [I] * (7 if ws_mode else 6)
    lib.gwtf_train_decode_workspace.restype = ctypes.c_longlong
    name = next(k for k, v in KERNEL_MODES.items() if v == mode)
    packed, ab, p = flagship_inputs()
    kw = kernel_weights_train(packed, name)
    ws_arg = [mode] if ws_mode else []
    mode = [mode] if with_mode else []
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    # the statistics read the fp32 W0, the products the weights of the mode
    ws = [packed[k] for k in _KERNEL_KEYS]
    fws = [ws[0]] + ws[1:3] + [kw["w1"], kw["w2"], ws[5]]
    bws = [kw["w0"]] + fws[1:]
    stream = torch.cuda.current_stream().cuda_stream
    fwd_out = [torch.empty_like(p), torch.empty_like(p),
               p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
    fwd_work = p.new_empty(lib.gwtf_train_decode_workspace(0, K, B, C, N, f,
                                                           *ws_arg))
    gen = torch.Generator(device="cuda").manual_seed(19)
    dp0 = torch.randn(p.shape, device="cuda", generator=gen)
    dlv = torch.randn(p.shape, device="cuda", generator=gen)
    bwd_out = [torch.empty_like(dp0)] + [torch.empty_like(w) for w in ws] + [
        torch.empty_like(ab)]
    bwd_work = p.new_empty(lib.gwtf_train_decode_workspace(1, K, B, C, N, f,
                                                           *ws_arg))

    def fwd():
        args = [p] + fws + [ab] + fwd_out + [fwd_work]
        code = lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, *mode, stream)
        if code:
            raise RuntimeError(f"{so}: forward error {code}")
        return fwd_out

    def bwd(res=None):
        xsave, stats = res or fwd_out[2:]
        args = [xsave, stats] + bws + [ab, dp0, dlv] + bwd_out + [bwd_work]
        code = lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, *mode, stream)
        if code:
            raise RuntimeError(f"{so}: backward error {code}")
        return bwd_out

    return fwd, bwd


def window_ms(fn, reps):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="another checkout of the repository")
    parser.add_argument("--out", default=None, help="build directory "
                        "(default: PARENT/_train_decode_ab)")
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--control", action="store_true",
                        help="compile the parent twice and compare the two "
                             "builds' SASS too")
    args = parser.parse_args(argv)
    import torch

    sources = {"parent": os.path.join(args.parent, _CSRC),
               "this": build.CSRC}
    if args.control:
        sources["parent_again"] = sources["parent"]
    out_dir = args.out or os.path.join(args.parent, "_train_decode_ab")
    libs = compile_all(sources, out_dir)

    summary = {"sass": {}, "ms": {}}
    rows = compare_sass(libs["parent"], libs["this"], out_dir)
    names = ("highest", "high", "fast")  # MODE
    for kernel, fp, mode, diff, counts in rows:
        what = ("missing" if diff is None else
                "equal" if diff == 0 else
                f"{diff} lines differ; {counts[0]} and {counts[1]} "
                f"instructions, opcodes this less parent {counts[2]}")
        print(f"SASS {kernel}" + (f" FP={fp}" if fp else "")
              + f" '{names[mode]}': {what}", flush=True)
        summary["sass"][f"{kernel}" + (f"<{fp}>" if fp else "")
                        + f"[{names[mode]}]"] = diff
    summary["sass_all_equal"] = all(d == 0 for *_, d, _ in rows)
    if args.control:
        again = [(k, fp, m, d) for k, fp, m, d, _ in
                 compare_sass(libs["parent"], libs.pop("parent_again")) if d]
        print(f"SASS of two compiles of the parent: {len(again)} kernels "
              f"differ {again}", flush=True)
        summary["control_differs"] = [f"{k}<{fp}>[{names[m]}]"
                                      for k, fp, m, _ in again]

    # 'highest', and 'high' and 'fast' where both libraries take a mode
    with_mode = {tag: takes_mode(sources[tag]) for tag in libs}
    ws_mode = {tag: workspace_takes_mode(sources[tag]) for tag in libs}
    modes = [0, 1, 2] if all(with_mode.values()) else [0]
    summary["bit_equal"] = {}
    for mode in modes:
        run = {tag: runner(so, with_mode[tag], mode, ws_mode[tag])
               for tag, so in libs.items()}
        # kernel 8 of both on the same residuals, the parent's forward's
        outs = {tag: [[t.clone() for t in fwd()]] for tag, (fwd, _) in
                run.items()}
        res = outs["parent"][0][2:]
        for tag, (_, bwd) in run.items():
            outs[tag].append([t.clone() for t in bwd(res)])
        torch.cuda.synchronize()
        for i, k in enumerate(("fwd", "bwd")):
            summary["bit_equal"][f"{k}_{names[mode]}"] = all(
                torch.equal(a, b) for a, b in zip(outs["parent"][i],
                                                  outs["this"][i]))
        del outs
        order = ["parent", "this", "this", "parent"] * args.turns
        times = {(tag, k): [] for tag in run for k in ("fwd", "bwd")}
        for tag in order:
            fwd, bwd = run[tag]
            times[tag, "fwd"].append(window_ms(fwd, 5))
            times[tag, "bwd"].append(window_ms(bwd, 3))
        for k in ("fwd", "bwd"):
            par = sum(times["parent", k]) / len(times["parent", k])
            this = sum(times["this", k]) / len(times["this", k])
            summary["ms"][f"{k}_{names[mode]}"] = {
                "parent": times["parent", k], "this": times["this", k],
                "ratio": this / par}
            print(f"kernel {7 if k == 'fwd' else 8} ({k}) '{names[mode]}', "
                  f"flagship shape: parent {par:.3f} ms, this {this:.3f} ms, "
                  f"ratio {this / par:.4f} (turns parent, this, this, "
                  f"parent); outputs bit-equal "
                  f"{summary['bit_equal'][f'{k}_{names[mode]}']}",
                  flush=True)
        del run
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
