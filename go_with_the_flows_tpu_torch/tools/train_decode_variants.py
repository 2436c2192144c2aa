"""Kernel 7 at 'fast' and 'high' from variants of `csrc/train_decode.cuh`
timed against the checkout's on the card: a measurement, run by hand on
a machine with `nvcc` and a card, not part of any path.

    python -m go_with_the_flows_tpu_torch.tools.train_decode_variants \\
        SPEC.json [--out DIR] [--turns 2]

SPEC maps a variant's name to {"patch": [[old, new], ...]} (exact
replacements in the checkout's header) and, optionally, "header": a
whole header to start from (a path from the repository's root). The
checkout's four units are built once, and each variant's 'fast' and
'high' units (`train_decode_fast.cu`, `train_decode_high.cu`), each by
its own `nvcc`, all at once, under DIR (default: the build directory's
`train_decode_variants/`); a variant's library links its two units
beside the checkout's entry and 'highest' units. It prints the 'fast'
and 'high' units' ptxas registers and spills of the forward's passes at
FP 40 (and any instantiation that spills), then each library's kernel 7
at the flagship shape (`chip_smoke.train_decode_inputs`, seed 19) in
each of the two modes: the mean of CUDA-event windows in turns (the
libraries in order, then in reverse, `--turns` times), one profiled call
by pass, and whether p0 equals the checkout's bit for bit (ptxas may
fuse an unrounded multiply and add differently in another build, and at
'fast' 33 couplings widen a last-bit difference: read the difference).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

from ..ops.kernels import build

ROOT = os.path.dirname(build._PKG)
HEADER = "train_decode.cuh"
UNITS = ("train_decode.cu", "train_decode_highest.cu", "train_decode_high.cu",
         "train_decode_fast.cu")
MODE_UNITS = ("train_decode_fast.cu", "train_decode_high.cu")


def variant_source(out, name, patch, header=None):
    """The checkout's csrc copied to out/name with `header` in place of
    its train_decode.cuh and `patch` applied; returns the directory."""
    d = os.path.join(out, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    path = os.path.join(d, HEADER)
    if header:
        shutil.copy(os.path.join(ROOT, header), path)
    with open(path) as f:
        text = f.read()
    for old, new in patch:
        if old not in text:
            raise SystemExit(f"variant {name}: no {old[:60]!r} in the header")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return d


def ptxas_rows(log):
    """(function, registers line, spill line) of the forward's passes."""
    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and fn and (
                "fwd_hidden" in fn or "fwd_update" in fn):
            rows.append((fn, line.strip(), spill))
    return rows


def build_all(spec, out):
    """{name: library path}: 'checkout' and each variant of `spec`."""
    nvcc = build._nvcc()
    os.makedirs(out, exist_ok=True)
    base = variant_source(out, "checkout", [])
    jobs = [(os.path.join(base, u), os.path.join(out, f"checkout_{u}.o"))
            for u in UNITS]
    for name, v in spec.items():
        d = variant_source(out, name, v.get("patch", []), v.get("header"))
        jobs += [(os.path.join(d, u), os.path.join(out, f"{name}_{u}.o"))
                 for u in MODE_UNITS]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", o, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, o in jobs]
    logs = [p.communicate()[0] for p in procs]
    for (src, _), p, log in zip(jobs, procs, logs):
        if p.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{log[-3000:]}")
        if os.path.basename(src) in MODE_UNITS:
            for fn, regs, spill in ptxas_rows(log):
                if "ILi40E" in fn or "0 bytes spill stores" not in spill:
                    print(f"  {os.path.relpath(src, out)}: {fn[:48]} "
                          f"{regs} | {spill}", flush=True)
    libs = {}
    for name in ["checkout"] + list(spec):
        objs = [os.path.join(out, f"{name if u in MODE_UNITS else 'checkout'}"
                                  f"_{u}.o") for u in UNITS]
        so = os.path.join(out, f"{name}.so")
        link = subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", so]
                              + objs, capture_output=True, text=True)
        if link.returncode:
            raise SystemExit(f"link failed for {name}:\n{link.stderr}")
        libs[name] = so
    return libs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("spec", help="JSON file of the variants")
    parser.add_argument("--out", default=os.path.join(
        build.BUILD_DIR, "train_decode_variants"))
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops.kernels.train_decode import kernel_weights_train
    from ..utils.config import FLAGSHIP_AIRPLANE

    with open(args.spec) as f:
        spec = json.load(f)
    libs = build_all(spec, args.out)
    packed, ab, p = cs.train_decode_inputs(FLAGSHIP_AIRPLANE, cs.BATCH,
                                           cs.N_POINTS, 19)
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    for name, so in libs.items():
        lib = build.load(so, ["gwtf_train_decode_fwd",
                              "gwtf_train_decode_workspace"])
        for mode, code in (("fast", 2), ("high", 1)):
            kw = kernel_weights_train(packed, mode)
            ws = [packed["w0"], packed["bn0_scale"], packed["bn0_bias"],
                  kw["w1"], kw["w2"], packed["b2"]]
            out = [torch.empty_like(p), torch.empty_like(p),
                   p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
            work = p.new_empty(lib.gwtf_train_decode_workspace(
                0, K, B, C, N, f, code))
            ptrs = [t.data_ptr() for t in [p] + ws + [ab] + out + [work]]

            def fwd(lib=lib, ptrs=ptrs, code=code, name=name):
                err = lib.gwtf_train_decode_fwd(*ptrs, K, B, C, N, f, code,
                                                stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            runs[name, mode] = (fwd, out)
    ms = {key: [] for key in runs}
    for _ in range(args.turns):
        for name in list(libs) + list(libs)[::-1]:
            for mode in ("fast", "high"):
                ms[name, mode].append(cs.cuda_ms(runs[name, mode][0], 5))
    ref = {}
    passes = cs.TRAIN_DECODE_PASSES["kernel 7 (train_decode_fwd)"]
    for (name, mode), (fwd, out) in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        by = cs.passes_of(cs.device_kernels(prof), passes)
        ref.setdefault(mode, [t.clone() for t in out])
        diff = (out[0] - ref[mode][0]).abs().max().item()
        mean = sum(ms[name, mode]) / len(ms[name, mode])
        print(f"{name:>16} {mode}: {mean:.3f} ms ("
              + ", ".join(f"{t:.3f}" for t in ms[name, mode]) + "); "
              + "; ".join(f"{k} {t:.3f}" for k, (t, _) in by.items())
              + f"; p0 against the checkout's max |diff| {diff:.3g}",
              flush=True)


if __name__ == "__main__":
    main()
