"""Layouts of the eval decode (kernel 1, `csrc/point_decode.cu`) and of
the pairwise Chamfer grid (kernel 3, `csrc/pairwise_cd.cu`) timed against
each other on the card: a measurement, run by hand on a machine with
`nvcc` and a card, not part of any path.

    python -m go_with_the_flows_tpu_torch.tools.decode_cd_variants [--out DIR]

Each variant is a copy of a source with other values of its layout
constants (threads a block, points or rows a thread), built alone by
`nvcc` into its own library under DIR (default: the build directory's
`variants/`) and called through its C entry point at the main path's
shapes: the flagship decoder (K=4, C=33, f=37; random weights from seed
0) at B=64, N=2048, direct and inverse, and a 64 x 64 grid of 2,048-point
clouds. It prints each variant's ptxas registers and spills, its mean
time over 10 launches (CUDA events) and whether its outputs equal the
checkout's kernel's bit for bit (the layouts change no arithmetic).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

import torch

from ..ops.kernels import build
from ..ops.kernels.pairwise import pairwise_cd_stats
from ..ops.kernels.point_decode import (
    film_alpha_beta,
    kernel_film,
    point_decode,
)

VARIANTS = {
    "point_decode.cu": [dict(kBlockPoints=256, kNarrowPoints=1),
                        dict(kBlockPoints=512, kNarrowPoints=2),
                        dict(kBlockPoints=256, kNarrowPoints=2),
                        dict(kBlockPoints=512, kNarrowPoints=4),
                        dict(kBlockPoints=1024, kNarrowPoints=4)],
    "pairwise_cd.cu": [dict(kThreads=256, kRows=8),
                       dict(kThreads=128, kRows=8),
                       dict(kThreads=128, kRows=16),
                       dict(kThreads=256, kRows=4)],
}
KERNELS = {"point_decode.cu": "point_decode_kernel",
           "pairwise_cd.cu": "cd_stats_kernel"}


def variant_source(text: str, consts) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in the source")
    return text


def build_variants(out_dir: str):
    """{(source, label): (library path, ptxas log)}, all nvcc at once."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for src, variants in VARIANTS.items():
        with open(os.path.join(build.CSRC, src)) as f:
            text = f.read()
        for consts in variants:
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
        out[key] = (so, log)
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


def decode_inputs():
    from ..models.mixture import FlowMixtureModel
    from ..utils.config import FLAGSHIP_AIRPLANE

    gen = torch.Generator().manual_seed(0)
    model = FlowMixtureModel(**FLAGSHIP_AIRPLANE, generator=gen).cuda().eval()
    packed = model.pack_decoder()
    g = torch.randn(64, model.g_latent_space_size, generator=gen).cuda()
    ab = film_alpha_beta(packed, g)
    p = 0.3 * torch.randn(model.n_components, 64, 3, 2048,
                          generator=gen).cuda()
    return packed, ab, p


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(build.BUILD_DIR,
                                                      "variants"))
    args = parser.parse_args()
    built = build_variants(args.out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    packed, ab, p = decode_inputs()
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    film = kernel_film(ab)
    for inverse in (False, True):
        want = point_decode(packed, ab, p, inverse)
        ms = cuda_ms(lambda: point_decode(packed, ab, p, inverse))
        print(f"point_decode {'inverse' if inverse else 'direct'} "
              f"(checkout): {ms:.3f} ms")
        for (src, label), (so, log) in built.items():
            if src != "point_decode.cu":
                continue
            fn = ctypes.CDLL(so).gwtf_point_decode
            fn.argtypes = [P] * 5 + [I] * 6 + [P]
            out, lv = torch.empty_like(p), torch.empty_like(p)

            def run():
                code = fn(p.data_ptr(), packed["kernel"].data_ptr(),
                          film.data_ptr(), out.data_ptr(), lv.data_ptr(), K,
                          B, C, N, f, int(inverse), stream)
                if code:
                    raise SystemExit(f"{label}: CUDA error {code}")

            ms = cuda_ms(run)
            same = torch.equal(out, want[0]) and torch.equal(lv, want[1])
            fp = (f + 7) // 8 * 8
            at = ptxas(log, KERNELS[src], f"ILi{fp}ELb{int(inverse)}E")
            most = ptxas(log, KERNELS[src])
            print(f"  point_decode {label}: {ms:.3f} ms; at FP={fp} {at[0]} "
                  f"registers, {at[1]} B spilled, {at[2]} B stack; at most "
                  f"{most[0]} registers, {most[1]} B spilled, {most[2]} B "
                  f"stack over FP 8-64; equal bits {same}")

    gen = torch.Generator(device="cuda").manual_seed(2)
    s = 0.3 * torch.randn(64, 2048, 3, device="cuda", generator=gen)
    r = 0.3 * torch.randn(64, 2048, 3, device="cuda", generator=gen)
    want = pairwise_cd_stats(s, r, 1e-3)
    ms = cuda_ms(lambda: pairwise_cd_stats(s, r, 1e-3), 5)
    print(f"pairwise_cd_stats 64 x 64 (checkout): {ms:.3f} ms")
    for (src, label), (so, log) in built.items():
        if src != "pairwise_cd.cu":
            continue
        fn = ctypes.CDLL(so).gwtf_pairwise_cd_stats
        fn.argtypes = [P] * 6 + [I] * 4 + [ctypes.c_float, P]
        outs = [torch.empty_like(w) for w in want]

        def run():
            code = fn(s.data_ptr(), r.data_ptr(),
                      *(o.data_ptr() for o in outs), 64, 64, 2048, 2048,
                      1e-3, stream)
            if code:
                raise SystemExit(f"{label}: CUDA error {code}")

        ms = cuda_ms(run, 5)
        same = all(torch.equal(a, b) for a, b in zip(outs[2:], want[2:]))
        regs, spill, stack = ptxas(log, KERNELS[src])
        print(f"  pairwise_cd_stats {label}: {ms:.3f} ms, {regs} registers, "
              f"{spill} B spilled, {stack} B stack, precision and recall "
              f"equal {same}")


if __name__ == "__main__":
    main()
