"""Layouts of the eval decode (kernel 1, `csrc/point_decode.cu`), the
nearest-neighbour distances (kernel 2, `csrc/nn_distance.cu`), the
pairwise Chamfer grid (kernel 3, `csrc/pairwise_cd.cu`) and the EMD
backward (kernel 6, `csrc/emd.cu`) timed against each other on the card:
a measurement, run by hand on a machine with `nvcc` and a card, not part
of any path.

    python -m go_with_the_flows_tpu_torch.tools.decode_cd_variants
        [--out DIR] [--sources SRC ...]
    python -m go_with_the_flows_tpu_torch.tools.decode_cd_variants
        --modes [SPEC.json] [--parent DIR] [--turns 3] [--svr] [--out DIR]

`--modes` times kernel 1 at 'fast' and 'high' (`time_modes`): the
checkout's `point_decode.cu`, each variant of SPEC (a JSON object: a
variant's name -> {"patch": [[old, new], ...]}, exact replacements in the
checkout's source, each of which must occur) and with `--parent` the
`point_decode.cu` of another tree (a parent unpacked with `git archive`;
before the tensor-core design its modes read `parent_layout`), each built
alone by `nvcc` beside its own csrc's headers, all at once. At the
flagship shape (K=4, B=64, N=2048, C=33, f=37; `--svr`: also the SVR
configuration's, B=128, N=2500, f=33), direct, it prints each library's
ptxas registers and spills by mode and FP and its HMMA count a function,
whether the parent's 'highest' SASS equals the checkout's instantiation
by instantiation, the mean of CUDA-event windows of 10 launches in turns
(the libraries in order, then in reverse, `--turns` times) in each mode,
and each output's largest difference to the checkout's and to the plain
version of its mode (a variant that removes a part, such as the W1
product, computes something else: its time says what the part costs);
the checkout's 'highest' beside them, and whether the parent's 'highest'
output equals it bit for bit.

Each variant is a copy of a source with other values of its layout
constants (threads a block, points or rows a thread), built alone by
`nvcc` into its own library under DIR (default: the build directory's
`variants/`) and called through its C entry point at the main path's
shapes: the flagship decoder (K=4, C=33, f=37; random weights from seed
0) at B=64, N=2048, direct and inverse; a 64 x 64 grid of 2,048-point
clouds; kernel 2 without and with the indices and kernel 6 on kernel 5's
residuals, each on 64 pairs of 2,048-point clouds; kernel 1 in its
'highest' mode. `--sources` takes
some of the sources (default: all). It prints each variant's ptxas
registers, spills and stack frame, its mean time over 10 launches (5 for
the grid; CUDA events) and whether its outputs equal the checkout's
kernel's bit for bit (the layouts change no arithmetic, but kernel 6's
change the order of its column sums: it is held at rtol 1e-5 instead).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess

import torch

from ..ops.kernels import build
from ..ops.kernels.chamfer import nn_distance
from ..ops.kernels.emd import emd_backward, emd_cost_kernel
from ..ops.kernels.pairwise import pairwise_cd_stats
from ..ops.kernels.point_decode import (
    KERNEL_MODES,
    _layout,
    film_alpha_beta,
    kernel_film,
    kernel_layout,
    point_decode,
    point_decode_plain,
)
from ..ops.precision import bf16_round, bf16_split, matmul_precision_scope

VARIANTS = {
    "point_decode.cu": [dict(kBlockPoints=256, kNarrowPoints=1),
                        dict(kBlockPoints=512, kNarrowPoints=2),
                        dict(kBlockPoints=256, kNarrowPoints=2),
                        dict(kBlockPoints=512, kNarrowPoints=4),
                        dict(kBlockPoints=1024, kNarrowPoints=4)],
    "nn_distance.cu": [dict(kThreads=128, kRows=4),
                       dict(kThreads=64, kRows=8),
                       dict(kThreads=128, kRows=8),
                       dict(kThreads=256, kRows=2),
                       dict(kThreads=256, kRows=4)],
    "pairwise_cd.cu": [dict(kThreads=256, kRows=8),
                       dict(kThreads=128, kRows=8),
                       dict(kThreads=128, kRows=16),
                       dict(kThreads=256, kRows=4)],
    "emd.cu": [dict(kBwdThreads=64, kBwdRows=4),
               dict(kBwdThreads=128, kBwdRows=4),
               dict(kBwdThreads=32, kBwdRows=4),
               dict(kBwdThreads=64, kBwdRows=2),
               dict(kBwdThreads=128, kBwdRows=2),
               dict(kBwdThreads=64, kBwdRows=8)],
}
MODES = ("highest", "high", "fast")  # kernel 1's MODE: KERNEL_MODES' order
# source -> (kernel whose ptxas lines are read, C entry points it holds)
KERNELS = {
    "point_decode.cu": ("point_decode_kernel", ("gwtf_point_decode",)),
    "nn_distance.cu": ("nn_distance_kernel",
                       ("gwtf_nn_distance", "gwtf_nn_distance_chunks")),
    "pairwise_cd.cu": ("cd_stats_kernel", ("gwtf_pairwise_cd_stats",)),
    "emd.cu": ("emd_backward_kernel",
               ("gwtf_emd_backward", "gwtf_emd_backward_chunks")),
}


def variant_source(text: str, consts) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in the source")
    return text


def build_variants(out_dir: str, sources):
    """{(source, label): (library, ptxas log)} of the VARIANTS of
    `sources`, all nvcc at once; each library with its entry points'
    argument types (`build.load`)."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for src in sources:
        with open(os.path.join(build.CSRC, src)) as f:
            text = f.read()
        for consts in VARIANTS[src]:
            label = " ".join(f"{k}={v}" for k, v in consts.items())
            stem = src[:-3] + "_" + "_".join(str(v) for v in consts.values())
            cu = os.path.join(out_dir, stem + ".cu")
            with open(cu, "w") as f:
                f.write(variant_source(text, consts))
            so = os.path.join(out_dir, "lib" + stem + ".so")
            jobs[(src, label)] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        out[key] = (build.load(so, KERNELS[key[0]][1]), log)
    return out


def ptxas(log: str, kernel: str, only: str = ""):
    """(most registers, most spill bytes, most stack frame bytes) over the
    kernel's instantiations whose name holds `only`."""
    regs, spills, stacks, name = [0], [0], [0], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if kernel not in name or only not in name:
                name = None
        elif name and "spill stores" in line:
            spills.append(int(line.split("bytes spill stores")[0]
                              .split(",")[-1]))
            stacks.append(int(line.split("bytes stack frame")[0].split()[-1]))
        elif name and "Used" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
            name = None
    return max(regs), max(spills), max(stacks)


def cuda_ms(fn, reps=10):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def decode_inputs(config=None, B=64, N=2048):
    """A decoder of `config` (default the flagship's) packed on the card
    (random weights from seed 0), FiLM affines for B random latents and a
    state p (K, B, 3, N)."""
    from ..models.mixture import FlowMixtureModel
    from ..utils.config import FLAGSHIP_AIRPLANE

    gen = torch.Generator().manual_seed(0)
    model = FlowMixtureModel(**(config or FLAGSHIP_AIRPLANE),
                             generator=gen).cuda().eval()
    packed = model.pack_decoder()
    g = torch.randn(B, model.g_latent_space_size, generator=gen).cuda()
    ab = film_alpha_beta(packed, g)
    p = 0.3 * torch.randn(model.n_components, B, 3, N, generator=gen).cuda()
    return packed, ab, p


def variants_of(built, source):
    """(label, library, ptxas log) of each built variant of `source`."""
    return [(label, lib, log) for (src, label), (lib, log) in built.items()
            if src == source]


def check_code(label: str, code: int) -> None:
    if code:
        raise SystemExit(f"{label}: CUDA error {code}")


def time_point_decode(built, stream) -> None:
    packed, ab, p = decode_inputs()
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    film = kernel_film(ab)
    for inverse in (False, True):
        want = point_decode(packed, ab, p, inverse)
        ms = cuda_ms(lambda: point_decode(packed, ab, p, inverse))
        print(f"point_decode {'inverse' if inverse else 'direct'} "
              f"(checkout): {ms:.3f} ms")
        for label, lib, log in variants_of(built, "point_decode.cu"):
            out, lv = torch.empty_like(p), torch.empty_like(p)

            def run():
                check_code(label, lib.gwtf_point_decode(
                    p.data_ptr(), packed["kernel"].data_ptr(),
                    film.data_ptr(), out.data_ptr(), lv.data_ptr(), K, B, C,
                    N, f, int(inverse), 0, stream))  # mode 0: 'highest'

            ms = cuda_ms(run)
            same = torch.equal(out, want[0]) and torch.equal(lv, want[1])
            fp = (f + 7) // 8 * 8
            at = ptxas(log, "point_decode_kernel",
                       f"ILi{fp}ELb{int(inverse)}ELi0E")
            most = ptxas(log, "point_decode_kernel")
            print(f"  point_decode {label}: {ms:.3f} ms; at FP={fp} {at[0]} "
                  f"registers, {at[1]} B spilled, {at[2]} B stack; at most "
                  f"{most[0]} registers, {most[1]} B spilled, {most[2]} B "
                  f"stack over FP 8-64; equal bits {same}")


def time_nn_distance(built, stream, B=64, N=2048) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    b = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    for with_idx in (False, True):
        want = nn_distance(a, b, with_idx)
        ms = cuda_ms(lambda: nn_distance(a, b, with_idx))
        tag = "with idx" if with_idx else "without idx"
        print(f"nn_distance {tag} (checkout): {ms:.3f} ms")
        for label, lib, log in variants_of(built, "nn_distance.cu"):
            chunks = lib.gwtf_nn_distance_chunks(N)
            dist = [torch.empty(B, N, device="cuda") for _ in range(2)]
            col_d = torch.empty(B, chunks, N, device="cuda")
            idx = [torch.empty(n, dtype=torch.int32, device="cuda")
                   for n in ((B, N), (B, N), (B, chunks, N))]
            ip = [t.data_ptr() if with_idx else None for t in idx]

            def run():
                check_code(label, lib.gwtf_nn_distance(
                    a.data_ptr(), b.data_ptr(), dist[0].data_ptr(), ip[0],
                    dist[1].data_ptr(), ip[1], col_d.data_ptr(), ip[2], B, N,
                    N, stream))

            ms = cuda_ms(run)
            got = ([dist[0], idx[0].long(), dist[1], idx[1].long()]
                   if with_idx else dist)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            regs, spill, stack = ptxas(log, "nn_distance_kernel",
                                       f"ILb{int(with_idx)}E")
            print(f"  nn_distance {tag} {label}: {ms:.3f} ms, {chunks} row "
                  f"chunks, {regs} registers, {spill} B spilled, {stack} B "
                  f"stack; equal bits {same}")


def time_cd_stats(built, stream) -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)
    s = 0.3 * torch.randn(64, 2048, 3, device="cuda", generator=gen)
    r = 0.3 * torch.randn(64, 2048, 3, device="cuda", generator=gen)
    want = pairwise_cd_stats(s, r, 1e-3)
    ms = cuda_ms(lambda: pairwise_cd_stats(s, r, 1e-3), 5)
    print(f"pairwise_cd_stats 64 x 64 (checkout): {ms:.3f} ms")
    for label, lib, log in variants_of(built, "pairwise_cd.cu"):
        outs = [torch.empty_like(w) for w in want]

        def run():
            check_code(label, lib.gwtf_pairwise_cd_stats(
                s.data_ptr(), r.data_ptr(), *(o.data_ptr() for o in outs),
                64, 64, 2048, 2048, 1e-3, stream))

        ms = cuda_ms(run, 5)
        same = all(torch.equal(a, b) for a, b in zip(outs[2:], want[2:]))
        regs, spill, stack = ptxas(log, "cd_stats_kernel")
        print(f"  pairwise_cd_stats {label}: {ms:.3f} ms, {regs} registers, "
              f"{spill} B spilled, {stack} B stack, precision and recall "
              f"equal {same}")


def time_emd_backward(built, stream, B=64, N=2048) -> None:
    gen = torch.Generator(device="cuda").manual_seed(14)
    a = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    b = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    _, rl, rr = emd_cost_kernel(a, b, True)
    want = emd_backward(a, b, rl, rr)
    ms = cuda_ms(lambda: emd_backward(a, b, rl, rr))
    print(f"emd_backward (checkout): {ms:.3f} ms")
    for label, lib, log in variants_of(built, "emd.cu"):
        chunks = lib.gwtf_emd_backward_chunks(N)
        da, db = torch.empty_like(a), torch.empty_like(b)
        col = torch.empty(B, chunks, N, 3, device="cuda")

        def run():
            check_code(label, lib.gwtf_emd_backward(
                a.data_ptr(), b.data_ptr(), rl.data_ptr(), rr.data_ptr(),
                da.data_ptr(), db.data_ptr(), col.data_ptr(), B, N, N,
                stream))

        ms = cuda_ms(run)
        close = all(torch.allclose(x, y, rtol=1e-5, atol=1e-7)
                    for x, y in zip((da, db), want))
        regs, spill, stack = ptxas(log, "emd_backward_kernel")
        print(f"  emd_backward {label}: {ms:.3f} ms, {chunks} row chunks, "
              f"{regs} registers, {spill} B spilled, {stack} B stack; "
              f"within rtol 1e-5 of the checkout's {close}")


def parent_layout(packed, mode: str) -> torch.Tensor:
    """Kernel 1's weights at 'fast' and 'high' as the CUDA-core kernels
    before the tensor-core design read them: the 'highest' layout of the
    rounded weights, or of the hi parts followed by that of the lo parts
    (biases 0)."""
    w0, b0, w1, w2, b2 = (packed[k] for k in ("w0", "b0", "w1", "w2", "b2"))
    if mode == "fast":
        return _layout(*(bf16_round(w0), b0, bf16_round(w1),
                         bf16_round(w2), b2)).contiguous()
    (w0, w0l), (w1, w1l), (w2, w2l) = (bf16_split(t) for t in (w0, w1, w2))
    return torch.cat([_layout(w0, b0, w1, w2, b2),
                      _layout(w0l, torch.zeros_like(b0), w1l, w2l,
                              torch.zeros_like(b2))], -1).contiguous()


def build_mode_libraries(out: str, spec, parent=None):
    """{name: (library, ptxas log, the source's text)}: 'checkout', each
    variant of `spec` and 'parent' (the point_decode.cu of the tree
    `parent`), each source in a copy of its csrc directory, one nvcc each,
    all at once."""
    jobs = {}

    def start(name, csrc, patch=()):
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        cu = os.path.join(d, "point_decode.cu")
        with open(cu) as f:
            text = f.read()
        for old, new in patch:
            if old not in text:
                raise SystemExit(f"variant {name}: no {old[:60]!r} in the "
                                 "source")
            text = text.replace(old, new)
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(d, "libpoint_decode.so")
        jobs[name] = (so, text, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    os.makedirs(out, exist_ok=True)
    start("checkout", build.CSRC)
    for name, v in spec.items():
        start(name, build.CSRC, v.get("patch", []))
    if parent:
        start("parent", os.path.join(parent, "go_with_the_flows_tpu_torch",
                                     "csrc"))
    libs = {}
    for name, (so, text, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            if name == "checkout":
                raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
            print(f"  {name}: nvcc failed, left out:\n{log[-1500:]}",
                  flush=True)
            continue
        libs[name] = (build.load(so, ["gwtf_point_decode"]), log, text)
    return libs


def time_modes(libs, stream, turns: int, config=None, B=64, N=2048) -> None:
    """Kernel 1 of each library at 'fast' and 'high' (and the checkout's
    and the parent's at 'highest'), direct, timed in turns: see the
    module's docstring."""
    packed, ab, p = decode_inputs(config, B, N)
    K = p.shape[0]
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    fp = (f + 7) // 8 * 8
    film = kernel_film(ab)
    print(f"point_decode modes K={K} B={B} N={N} C={C} f={f} (FP {fp})",
          flush=True)
    runs = {}
    for name, (lib, log, text) in libs.items():
        modes = ["fast", "high"] + (["highest"] if name in ("checkout",
                                                            "parent") else [])
        for mode in modes:
            new = "TcLayout" in text or mode == "highest"
            weights = (kernel_layout(packed, mode) if new
                       else parent_layout(packed, mode))
            out, lv = torch.empty_like(p), torch.empty_like(p)

            def run(lib=lib, weights=weights, out=out, lv=lv, mode=mode,
                    name=name):
                check_code(name, lib.gwtf_point_decode(
                    p.data_ptr(), weights.data_ptr(), film.data_ptr(),
                    out.data_ptr(), lv.data_ptr(), K, B, C, N, f, 0,
                    KERNEL_MODES[mode], stream))

            runs[name, mode] = (run, out)
    ms = {key: [] for key in runs}
    names = list(libs)
    for _ in range(turns):
        for name in names + names[::-1]:
            for (n, mode), (run, _) in runs.items():
                if n == name:
                    ms[n, mode].append(cuda_ms(run))
    want = {}
    for mode in ("fast", "high", "highest"):
        with matmul_precision_scope(mode):
            want[mode] = point_decode_plain(packed, ab, p)[0]
    for (name, mode), (run, out) in runs.items():
        run()
        torch.cuda.synchronize()
        ref = runs["checkout", mode][1]
        mean = sum(ms[name, mode]) / len(ms[name, mode])
        print(f"  {name:>16} {mode:>7}: {mean:.3f} ms ("
              + ", ".join(f"{t:.3f}" for t in ms[name, mode]) + "); against "
              f"the checkout's max |diff| {(out - ref).abs().max().item():.3g}"
              f", against plain {mode} "
              f"{(out - want[mode]).abs().max().item():.3g}"
              + (f"; bit-equal {torch.equal(out, ref)}"
                 if mode == "highest" else ""), flush=True)


def _decode_key(name):
    """(FP, INVERSE, MODE) of a mangled point_decode_kernel name (its
    anonymous namespace's hash differs between two builds), else None."""
    m = re.search(r"point_decode_kernelILi(\d+)ELb([01])ELi(\d)E", name)
    return tuple(int(v) for v in m.groups()) if m else None


def compare_highest_sass(libs) -> None:
    """Each library's ptxas registers and spills of kernel 1 by mode and
    FP and its HMMA count a function by mode; then the SASS (`cuobjdump
    -sass`) of every 'highest' (MODE 0) instantiation in the parent's
    library against the checkout's."""
    from .train_decode_ab import opcode_delta, sass_functions

    funcs = {}
    for name, (lib, log, _) in libs.items():
        funcs[name] = {_decode_key(fn): lines for fn, lines in
                       sass_functions(lib._name).items() if _decode_key(fn)}
        for mode in (2, 1):
            print(f"  {name}: ptxas {MODES[mode]} registers (B spilled) by "
                  "FP " + ", ".join(
                      "{} {} ({})".format(fp, *ptxas(
                          log, "point_decode_kernel",
                          f"ILi{fp}ELb0ELi{mode}E")[:2])
                      for fp in range(8, 72, 8)), flush=True)
        hmma = {}
        for (_, _, mode), lines in funcs[name].items():
            hmma.setdefault(mode, []).append(sum("HMMA" in line
                                                 for line in lines))
        print(f"  {name}: HMMA a function by MODE " + "; ".join(
            f"{m}: {min(v)}-{max(v)} over {len(v)}"
            for m, v in sorted(hmma.items())), flush=True)
    if "parent" not in funcs:
        return
    mine, theirs = funcs["checkout"], funcs["parent"]
    highest = sorted(k for k in mine if k[2] == 0)
    same = [k for k in highest if mine[k] == theirs.get(k)]
    print(f"  'highest' SASS: {len(same)} of {len(highest)} instantiations "
          "equal to the parent's", flush=True)
    for k in highest:
        if k not in same:
            print(f"    <FP {k[0]}, INVERSE {k[1]}>: "
                  f"{len(theirs.get(k, []))} -> {len(mine[k])} lines, "
                  f"opcodes {opcode_delta(theirs.get(k, []), mine[k])}",
                  flush=True)


RUNNERS = {"point_decode.cu": time_point_decode,
           "nn_distance.cu": time_nn_distance,
           "pairwise_cd.cu": time_cd_stats,
           "emd.cu": time_emd_backward}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(build.BUILD_DIR,
                                                      "variants"))
    parser.add_argument("--sources", nargs="+", choices=list(VARIANTS),
                        default=list(VARIANTS))
    parser.add_argument("--modes", nargs="?", const="", default=None,
                        metavar="SPEC", help="time kernel 1 at 'fast' and "
                        "'high', with the variants of SPEC (JSON) if given")
    parser.add_argument("--parent", help="--modes: a tree whose "
                        "point_decode.cu is timed too")
    parser.add_argument("--turns", type=int, default=3)
    parser.add_argument("--svr", action="store_true",
                        help="--modes: also at the SVR configuration's shape")
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    if args.modes is not None:
        spec = {}
        if args.modes:
            with open(args.modes) as f:
                spec = json.load(f)
        libs = build_mode_libraries(os.path.join(args.out, "modes"), spec,
                                    args.parent)
        print(f"card: {card}")
        compare_highest_sass(libs)
        time_modes(libs, stream, args.turns)
        if args.svr:
            from ..utils.config import (SVR_RUN, SVR_SHAPENETALL13,
                                        model_config_kwargs)
            time_modes(libs, stream, args.turns,
                       model_config_kwargs(SVR_SHAPENETALL13),
                       SVR_RUN["batch_size"], SVR_RUN["cloud_size"])
        return
    built = build_variants(args.out, args.sources)
    print(f"card: {card}")
    for src in args.sources:
        RUNNERS[src](built, stream)


if __name__ == "__main__":
    main()
