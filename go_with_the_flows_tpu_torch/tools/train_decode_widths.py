"""Kernels 7 and 8 at 'high' and 'fast' across decoder widths, on one
checkout's source: a measurement, run by hand on a machine with `nvcc`
and a card, not part of any path.

    python go_with_the_flows_tpu_torch/tools/train_decode_widths.py \
        [--tree DIR] [--widths 19 24 27 41] [--seeds 7] [--turns 0]

DIR is a checkout of the repository (by default the one that holds this
file; or an older commit unpacked with `git archive`). Its `chip_smoke.py`
and its package are imported from DIR, so DIR's kernels are built (into
DIR's `_build/`) and measured; run it on two checkouts to compare them.
For each seed, width f and mode, on 9 couplings (K=2, 3 flows of width
f, not reduced, B=3 clouds of N=600 points, random weights from the
seed, as phase 2 of `chip_smoke.py` checks f=8):

  * `chip_smoke.check_train_decode_mode` with the mode's
    TRAIN_MODE_BOUNDS and MODE_EFFECT_GAP, as phase 2 calls it: its
    lines, and its failure reported, not raised;
  * kernel 8 alone on one set of residuals, the plain forward's and then
    kernel 7's (as the check takes them), in the mode: dp in norm, the
    count of dp entries more than 1e-3 of its largest off, and each
    gradient by its largest entry against the plain version of the mode;
    the mode's effect on dW1 against the plain version's (kernel 8 and
    its plain version each at the mode and at 'highest' on those
    residuals, `chip_smoke.mode_effect_gap`); and, in norm against the
    float64 plain version at 'highest', dp of kernel 8 and of the plain
    version in the mode and of kernel 8 at 'highest' (how far the
    width's data itself spreads two float32 orders of operations).

`--turns T` then times kernels 7 and 8 at the flagship shape (K=4, B=64,
N=2048, 11 flows of f=37, seed 19) in all three modes in one window, T
turns of 'highest', 'high', 'fast', 'fast', 'high', 'highest' (each the
mean of a CUDA-event window; the backward on its mode's forward
residuals). The last line holds every reading as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel8_alone(cs, config, B, N, seed, mode, forward):
    """Kernel 8 in `mode` and at 'highest' on the residuals of `forward`
    (the plain forward or kernel 7) in `mode`, against its plain version
    and float64."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_bwd_plain, train_decode_fwd,
        train_decode_fwd_plain)

    packed, ab, p = cs.train_decode_inputs(config, B, N, seed)
    gen = torch.Generator(device=p.device).manual_seed(seed)
    dp0 = torch.randn(p.shape, device=p.device, generator=gen)
    dlv = torch.randn(p.shape, device=p.device, generator=gen)
    fwd = train_decode_fwd_plain if forward == "plain" else train_decode_fwd
    _, _, xsave, stats = fwd(packed, ab, p, mode)
    res = (xsave, stats, dp0, dlv)
    kb = train_decode_bwd(packed, ab, *res, mode)
    pb = train_decode_bwd_plain(packed, ab, *res, mode)
    kh = train_decode_bwd(packed, ab, *res, "highest")
    ph = train_decode_bwd_plain(packed, ab, *res, "highest")
    f64 = train_decode_bwd_plain(
        {k: v.double() for k, v in packed.items()}, ab.double(),
        *(t.double() for t in res), "highest")

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()

    grads = {f"d{k}": rel(kb[1][k], v) for k, v in pb[1].items()}
    grads["dab"] = rel(kb[2], pb[2])
    far = (kb[0] - pb[0]).abs() > 1e-3 * pb[0].abs().max()
    return {
        "dp_norm": cs.rel_norm(kb[0], pb[0]),
        "dp_far": int(far.sum().item()), "dp_entries": far.numel(),
        "grad_max": max(grads.values()), "grads": grads,
        "dw1_gap": cs.mode_effect_gap(kb[1]["w1"], kh[1]["w1"],
                                      pb[1]["w1"], ph[1]["w1"]),
        "dp_f64": {"kernel": cs.rel_norm(kb[0], f64[0]),
                   "plain": cs.rel_norm(pb[0], f64[0]),
                   "kernel_highest": cs.rel_norm(kh[0], f64[0])},
    }


def modes_in_turns(cs, turns):
    """{mode: (kernel 7 ms, kernel 8 ms)} at the flagship shape, in turns."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    packed, ab, p = cs.train_decode_inputs(FLAGSHIP_AIRPLANE, cs.BATCH,
                                           cs.N_POINTS, 19)
    gen = torch.Generator(device="cuda").manual_seed(19)
    dp0 = torch.randn(p.shape, device="cuda", generator=gen)
    dlv = torch.randn(p.shape, device="cuda", generator=gen)
    order = ("highest", "high", "fast", "fast", "high", "highest")
    res = {m: train_decode_fwd(packed, ab, p, m)[2:] for m in order[:3]}
    ms = {m: ([], []) for m in order[:3]}
    for _ in range(turns):
        for m in order:
            ms[m][0].append(cs.cuda_ms(
                lambda: train_decode_fwd(packed, ab, p, m), 5))
            ms[m][1].append(cs.cuda_ms(lambda: train_decode_bwd(
                packed, ab, *res[m], dp0, dlv, m), 3))
    return {m: (sum(a) / len(a), sum(b) / len(b)) for m, (a, b) in ms.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        HERE)), help="checkout whose kernels are measured")
    parser.add_argument("--widths", type=int, nargs="+",
                        default=[19, 24, 27, 41])
    parser.add_argument("--seeds", type=int, nargs="+", default=[7])
    parser.add_argument("--turns", type=int, default=0)
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from go_with_the_flows_tpu_torch.ops.kernels import build
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    if not cs.__file__.startswith(tree):
        raise SystemExit(f"imported {cs.__file__}, not from {tree}")
    print(f"tree {tree}: build {build.build():.1f} s", flush=True)
    out = {"tree": tree, "widths": []}
    for seed in args.seeds:
        for f in args.widths:
            config = dict(FLAGSHIP_AIRPLANE, n_components=2,
                          g_latent_space_size=12, g_prior_n_flows=2,
                          p_decoder_n_flows=3, p_decoder_n_features=f,
                          params_reduce_mode="none")
            for mode in ("high", "fast"):
                failed = False
                try:
                    cs.check_train_decode_mode(
                        config, 3, 600, seed, timed=False, mode=mode,
                        gap_bound=cs.MODE_EFFECT_GAP[mode])
                except SystemExit:  # chip_smoke.fail printed the reason
                    failed = True
                row = dict(seed=seed, f=f, mode=mode, check_failed=failed)
                for forward in ("plain", "kernel"):
                    a = kernel8_alone(cs, config, 3, 600, seed, mode,
                                      forward)
                    print(f"    seed {seed} f={f} {mode}, kernel 8 alone on "
                          f"the {forward} forward's residuals: dp in norm "
                          f"{a['dp_norm']:.3g}, {a['dp_far']} of "
                          f"{a['dp_entries']} entries beyond 1e-3 of its "
                          f"largest, gradients at most {a['grad_max']:.3g} "
                          "of their largest entries, dW1's mode gap "
                          f"{a['dw1_gap']:.3g}; dp against float64 "
                          "'highest' in norm: kernel "
                          f"{a['dp_f64']['kernel']:.3g}, plain "
                          f"{a['dp_f64']['plain']:.3g}, kernel at 'highest' "
                          f"{a['dp_f64']['kernel_highest']:.3g}", flush=True)
                    row[forward] = a
                out["widths"].append(row)
    if args.turns:
        times = modes_in_turns(cs, args.turns)
        for m, (t7, t8) in times.items():
            print(f"    flagship in turns ({args.turns}): {m} kernel 7 "
                  f"{t7:.3f} ms, kernel 8 {t8:.3f} ms, both {t7 + t8:.3f} "
                  "ms", flush=True)
        out["turns"] = {m: {"fwd_ms": a, "bwd_ms": b}
                        for m, (a, b) in times.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
