#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, imports nothing of JAX, and exits
non-zero at the first failure:

  0. device: needs CUDA; prints the card's name and power limit;
  1. build: compiles every kernel of go_with_the_flows_tpu_torch/csrc;
     ptxas registers and spills of kernel 1 (`point_decode_kernel`, all
     16 instantiations), kernel 2 (`nn_distance_kernel` and its chunk
     fold), kernel 3 (`cd_stats_kernel`), kernel 6 (`emd_backward_kernel`
     and its chunk sum), kernel 7's hidden and update passes, kernel 8's
     B1/B2 and the EMD forward; all but kernel 8's must not spill, and
     kernels 1, 2, 3 and 6 keep no stack frame;
  2. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (jiggled BatchNorm statistics), with times; the EMD
     kernels also at ragged and unequal sizes and at the SVR protocol's
     2500 points, the EMD backward through autograd, and the EMD grid
     against the paired EMD kernel bit for bit;
  3. slice: the flagship airplane model (random weights from seed 0) on
     the card, `evaluate` in generating and autoencoding modes with CD,
     EMD and F1 over two seeded batches of 64 reference clouds of 2048
     points, then the EMD between the samples and their references as a
     differentiable loss, with all six kernel launch counters read around
     them; a small-input check against the CPU path; sample+CD clouds/s
     at B=64 and B=1024 for the kernel path and the plain path;
  4. train: the flagship model's training step (make_train_step) at
     B=64: one step from one state through the train-decode kernels and
     through the decoder's modules (the plain path), compared; twenty
     kernel-path steps on seeded clouds with the two train-decode launch
     counters read around them; ms/step, clouds/s and peak memory of both
     paths; a torch.profiler pass over one warm kernel-path step.

Phase 2 also checks that two launches of kernels 1, 2 and 6 give equal
bits, holds kernel 2's minima equal to the plain version's (its indices
may differ only at an exact tie) and kernel 3's precision and recall
equal to the plain version's (its minima are the plain version's bit for
bit); it holds the train-decode
kernels (forward, backward) against their plain versions at the flagship
decoder's shape and at a ragged N and a small batch, and checks that two
launches give equal bits; beside kernel 1 and the train forward's hidden
pass it times torch.bmm of their W1 products alone, and beside the
backward's dW1 pass torch.bmm on the materialised operands (yardsticks
the port never calls). Phase 3 also times kernel 1 alone at the B=1024
sampling batch, the decode's share of sample+CD. Phase 4's profile splits
both kernels into their passes, fails if a pass took no time, and
counts the forward's statistics launches (at most one a coupling and
the seed).

Its last two lines are a JSON object with one entry per kernel (its time
beside `bound_ms`, the least time the card could take for the same work
at the published peaks, from the operations and bytes that the timed
call's shapes need) and the JSON status line {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 2048
BATCH = 64
# optimizer keys of configs/config_generative_modeling_airplane.yaml
# (epoch_length is the dataset's; the flagship's lr and beta2 are
# constant, so it does not matter here)
TRAIN_HP = dict(epoch_length=100, cycle_length=400, min_lr=0.000256,
                max_lr=0.000256, beta1=0.9, min_beta2=0.99, max_beta2=0.99,
                wd=1e-6)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------- #
# helpers                                                               #
# --------------------------------------------------------------------- #

# published peaks of one H100 SXM at 700 W: FP32 outside the tensor cores,
# the special-function units (exp, rsqrt: 16 a clock per SM against 128
# FP32 lanes, so 1/16 of the FP32 FLOP rate), HBM3
FP32_FLOPS = 67e12
SFU_OPS = FP32_FLOPS / 16
HBM_BYTES = 3.35e12
# an exp or a root can also run on the FP32 pipe as a polynomial: a range
# reduction (3 adds) and a degree-5 polynomial (5 FMAs), 13 FLOP
SFU_AS_FLOP = 13
# the EMD cost's work per point pair (kernels 4 and 5) as the function
# needs it, D, sqrt D and each level's E formed once (the TPU kernel
# caches them, emd_kernel.py:133-156): the distance (8 FLOP) and its root;
# each of the 9 levels the exponent's product (1), its exp, sweep 1's and
# sweep 2's products and sums (4), sweep 3's two products and two sums (4)
EMD_FLOP = 8 + 9 * 9
EMD_SFU = 1 + 9
# what kernels 4 and 5 do instead, having no room for those caches: each
# of the 19 passes forms D again, 27 exps and 9 roots
EMD_SFU_RECOMPUTED = 27 + 9
# the EMD gradient's (kernel 6) per point pair: the distance (8), its
# rsqrt; 9 levels of the exponent's product, exp and the match's two
# products and sum (4); the coefficient (1); da's and db's 3 FMAs (12)
EMD_BWD_FLOP = 8 + 9 * 4 + 1 + 12
EMD_BWD_SFU = 1 + 9
# a Chamfer point pair's work: the distance (8 FLOP) and two minima
CD_FLOP = 8 + 2


def bound(flop: float = 0.0, sfu: float = 0.0, nbytes: float = 0.0):
    """(bound_ms, bound_by): the larger of the operations' time and the
    bytes' time at the HBM rate. The operations' time: the FP32 work at its
    peak, the special-function operations split between their units and
    the FP32 pipe (SFU_AS_FLOP each there) so that both finish soonest."""
    ops_s = max(flop / FP32_FLOPS,
                min(sfu / SFU_OPS, (flop + SFU_AS_FLOP * sfu)
                    / (FP32_FLOPS + SFU_AS_FLOP * SFU_OPS)))
    ops_ms = 1e3 * ops_s
    bytes_ms = 1e3 * nbytes / HBM_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def decode_work(K, B, N, C, f, flop_per_point, extra_bytes_per_point=0):
    """Operations and bytes of a coupling-chain kernel: `flop_per_point`
    per point, coupling and component; the points read once (12 B) and
    `extra_bytes_per_point` more per point and component."""
    points = K * B * N
    return dict(flop=points * C * flop_per_point,
                nbytes=points * (12 + extra_bytes_per_point))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def jiggle_batch_norms(model, seed: int) -> None:
    """Move every BatchNorm's running statistics away from 0 / 1, so the
    kernels' constant folding is exercised."""
    import torch

    from go_with_the_flows_tpu_torch.ops.layers import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                shape = m.running_mean.shape
                m.running_mean.copy_(0.3 * torch.randn(shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(shape, generator=gen))


def make_model(config, seed: int, device):
    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    import torch

    model = FlowMixtureModel(**config,
                             generator=torch.Generator().manual_seed(seed))
    jiggle_batch_norms(model, seed + 1000)
    return model.to(device).eval()


def reference_clouds(rng, n: int):
    """Seeded clouds on random ellipsoid surfaces, (n, 3, N_POINTS)."""
    import numpy as np

    dirs = rng.standard_normal((n, 3, N_POINTS))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    axes = rng.uniform(0.1, 0.5, (n, 3, 1))
    return (dirs * axes).astype(np.float32)


def ptxas_summary(log_path: str):
    """(kernel, registers, spill bytes, stack frame bytes) per compiled
    entry function."""
    rows, name, spill, stack = [], None, 0, 0
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill stores" in line:
                spill = int(line.split("bytes spill stores")[0].split(",")[-1])
                stack = int(line.split("bytes stack frame")[0].split()[-1])
            elif "Used" in line and "registers" in line and name:
                regs = int(line.split("Used")[1].split("registers")[0])
                rows.append((name, regs, spill, stack))
                name = None
    return rows


# --------------------------------------------------------------------- #
# phases                                                                #
# --------------------------------------------------------------------- #

def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a GPU")
    kind = torch.cuda.get_device_name(0)
    say(f"[0] device: {kind}, count={torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    return kind, card


def phase_build():
    from go_with_the_flows_tpu_torch.ops.kernels import build

    seconds = build.build(force=True)
    build.library()
    say(f"[1] build: {len(build.sources())} sources -> "
        f"{os.path.relpath(build.LIB_PATH, ROOT)} in {seconds:.1f} s")
    report = ptxas_summary(build.PTXAS_LOG)
    for name, regs, spill, stack in report:
        at = name.find("_kernel")
        short = name[max(0, at - 12):at + 24] if at >= 0 else name[:36]
        say(f"    ptxas {short}: {regs} registers, {spill} B spilled, "
            f"{stack} B stack frame")
    # kernels 1, 2, 3 and 6 (2 and 6 with their chunk folds), kernel 7's
    # hidden and update passes, kernel 8's hidden pass (B1 and B2, built
    # to fit 128 registers) and the EMD forward (kernels 4 and 5); all but
    # kernel 8's must not spill, and kernels 1, 2, 3 and 6 keep no array in
    # local memory (a stack frame)
    for kernel, no_spill, no_stack in (
            ("point_decode_kernel", True, True),
            ("nn_distance_kernel", True, True),
            ("nn_combine_kernel", True, True),
            ("cd_stats_kernel", True, True),
            ("emd_backward_kernel", True, True),
            ("emd_backward_sum_kernel", True, True),
            ("fwd_hidden_kernel", True, False),
            ("fwd_update_kernel", True, False),
            ("bwd_hidden_kernel", False, False),
            ("bwd_dw1_kernel", False, False),
            ("emd_cost_kernel", True, False),
            ("pairwise_emd_kernel", True, False)):
        mine = [(regs, spill, stack) for name, regs, spill, stack in report
                if kernel in name]
        if not mine:
            fail(f"ptxas reported no instantiation of {kernel}")
        say(f"    ptxas {kernel}: {len(mine)} instantiation(s), at most "
            f"{max(m[0] for m in mine)} registers, "
            f"{max(m[1] for m in mine)} B spilled, "
            f"{max(m[2] for m in mine)} B stack frame")
        if no_spill and max(m[1] for m in mine) > 0:
            fail(f"{kernel} spills registers")
        if no_stack and max(m[2] for m in mine) > 0:
            fail(f"{kernel} keeps a stack frame in local memory")


def check_close(what, got, want, atol, rtol=0.0):
    import torch

    err = (got - want).abs().max().item()
    bound = (atol + rtol * want.abs()).min().item() if rtol else atol
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    # the largest |diff| over its allowance, atol + rtol |want|
    used = ((got - want).abs() / (atol + rtol * want.abs()).clamp_min(
        1e-30)).max().item()
    say(f"    {what}: max |diff| {err:.3g} (atol {atol:g}, rtol {rtol:g}; "
        f"{used:.3g} of the allowance)")
    if not ok:
        fail(f"{what} disagrees with the plain version (bound {bound:g})")
    return err


def check_point_decode(config, B, N, seed, timed):
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode, point_decode_plain)

    model = make_model(config, seed, "cuda")
    packed = model.pack_decoder()
    K = model.n_components
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(B, model.g_latent_space_size, device="cuda",
                    generator=gen)
    ab = film_alpha_beta(packed, g).contiguous()
    p = 0.3 * torch.randn(K, B, 3, N, device="cuda", generator=gen)
    errs, times = [], {}
    for inverse in (False, True):
        name = "inverse" if inverse else "direct"
        out, lv = point_decode(packed, ab, p, inverse)
        want_out, want_lv = point_decode_plain(packed, ab, p, inverse)
        torch.cuda.synchronize()
        C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
        times["dims"] = (K, B, N, C, f)
        tag = f"point_decode {name} K={K} B={B} N={N} C={C} f={f}"
        errs.append(check_close(f"{tag} points", out, want_out, 1e-4))
        errs.append(check_close(f"{tag} logvar", lv, want_lv, 1e-4))
        again = point_decode(packed, ab, p, inverse)
        if not (torch.equal(out, again[0]) and torch.equal(lv, again[1])):
            fail(f"{tag}: two launches differ")
        if timed:
            ms = cuda_ms(lambda: point_decode(packed, ab, p, inverse), 10)
            plain = cuda_ms(
                lambda: point_decode_plain(packed, ab, p, inverse), 3)
            times[name] = (ms, plain)
            say(f"    {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms")
    if timed:
        w1 = w1_bmm_ms(K, B * N, f, C)
        say(f"    point_decode K={K} B={B} N={N} C={C} f={f}: its W1 "
            f"products alone as torch.bmm of (2K, f, f) W1 and (2K, f, BN) "
            f"h0, fp32 highest: {w1:.3f} ms for all {C} couplings")
    return max(errs), times


def step_sq_dist(q, r):
    """Squared distances of paired points (..., 3), rounded step by step,
    (dx dx + dy dy) + dz dz, as kernel 2 and its plain version form them."""
    d = q - r
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def check_nn_distance(B, N, M, seed, timed, grid=False):
    """Kernel 2 against its plain version: every minimum equal (tolerance
    0), with and without the indices; an index that differs from the
    plain argmin must be an exact tie (its distance equal to the
    minimum); two launches give equal bits. `grid` puts the coordinates
    on a 1/64 grid, where ties are common."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import (
        nn_distance, nn_distance_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    b = 0.3 * torch.randn(B, M, 3, device="cuda", generator=gen)
    if grid:
        a, b = ((64 * t).round() / 64 for t in (a, b))
    got = nn_distance(a, b)
    da, ia, db, ib = got
    pa, pia, pdb, pib = nn_distance_plain(a, b)
    tag = f"nn_distance B={B} N={N} M={M}" + (" (1/64 grid)" if grid else "")
    err = max(check_close(f"{tag} dist_a (exact)", da, pa, 0.0),
              check_close(f"{tag} dist_b (exact)", db, pdb, 0.0))
    for name, q, r, idx, want_idx, dist in (("idx_a", a, b, ia, pia, pa),
                                            ("idx_b", b, a, ib, pib, pdb)):
        chosen = step_sq_dist(
            q, torch.gather(r, 1, idx[..., None].expand(-1, -1, 3)))
        n_diff = int((idx != want_idx).sum())
        tie_err = (chosen - dist).abs().max().item()
        say(f"    {tag} {name}: {n_diff} indices differ from the plain "
            f"argmin, their distances within {tie_err:.3g} of the minimum")
        if tie_err > 0:
            fail(f"{tag} {name}: a differing index is not an exact tie")
    plain = nn_distance(a, b, with_idx=False)
    err = max(err, check_close(f"{tag} no-idx dist_a (exact)", plain[0], pa,
                               0.0),
              check_close(f"{tag} no-idx dist_b (exact)", plain[1], pdb, 0.0))
    if not (all(torch.equal(x, y) for x, y in zip(got, nn_distance(a, b)))
            and all(torch.equal(x, y) for x, y in
                    zip(plain, nn_distance(a, b, with_idx=False)))):
        fail(f"{tag}: two launches differ")
    times = None
    if timed:
        ms = cuda_ms(lambda: nn_distance(a, b, with_idx=False), 10)
        ms_idx = cuda_ms(lambda: nn_distance(a, b), 10)
        plain_ms = cuda_ms(lambda: nn_distance_plain(a, b, with_idx=False), 3)
        times = (ms, plain_ms)
        say(f"    {tag}: kernel {ms:.3f} ms (with idx {ms_idx:.3f} ms), "
            f"plain {plain_ms:.3f} ms")
    return err, times


def check_pairwise(S, R, N, M, seed, timed, thr=1e-3):
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_cd_stats, pairwise_cd_stats_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.3 * torch.randn(S, N, 3, device="cuda", generator=gen)
    b = 0.3 * torch.randn(R, M, 3, device="cuda", generator=gen)
    got = pairwise_cd_stats(a, b, thr)
    want = pairwise_cd_stats_plain(a, b, thr)
    tag = f"pairwise_cd_stats S={S} R={R} N={N} M={M}"
    err = max(check_close(f"{tag} cdl", got[0], want[0], 0.0, 1e-5),
              check_close(f"{tag} cdr", got[1], want[1], 0.0, 1e-5))
    # every minimum is the plain version's bit for bit, so every count is
    check_close(f"{tag} precision (exact)", got[2], want[2], 0.0)
    check_close(f"{tag} recall (exact)", got[3], want[3], 0.0)
    say(f"    {tag}: mean precision {got[2].mean().item():.2f} %, "
        f"recall {got[3].mean().item():.2f} %")
    times = None
    if timed:
        ms = cuda_ms(lambda: pairwise_cd_stats(a, b, thr), 5)
        plain = cuda_ms(lambda: pairwise_cd_stats_plain(a, b, thr), 1)
        times = (ms, plain)
        say(f"    {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms")
    return err, times


def check_emd(B, N, M, seed, timed):
    """Kernel 5 against its plain version; kernel 6 against the plain
    backward on the kernel's own residuals, reached through autograd with
    a non-uniform upstream weight."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_cost_kernel, emd_backward, emd_backward_plain, emd_cost,
        emd_cost_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    b = 0.3 * torch.randn(B, M, 3, device="cuda", generator=gen)
    tag = f"emd B={B} N={N} M={M}"
    cost = emd_cost(a, b)
    cost_err = check_close(f"{tag} cost", cost, emd_cost_plain(a, b), 0.0,
                           1e-4)
    cost_r, rl, rr = emd_cost_kernel(a, b, True)
    check_close(f"{tag} cost with residuals saved (exact)", cost_r, cost,
                0.0)
    once = emd_backward(a, b, rl, rr)
    again = emd_backward(a, b, rl, rr)
    if not (torch.equal(once[0], again[0]) and torch.equal(once[1], again[1])):
        fail(f"{tag}: two backward launches differ")
    da, db = emd_backward_plain(a, b, rl, rr)
    w = 0.5 + torch.rand(B, device="cuda", generator=gen)
    ga, gb = a.clone().requires_grad_(), b.clone().requires_grad_()
    (w * emd_cost(ga, gb)).sum().backward()
    w3 = w[:, None, None]
    bwd_err = max(
        check_close(f"{tag} da (autograd, weighted)", ga.grad, w3 * da,
                    1e-5, 1e-4),
        check_close(f"{tag} db (autograd, weighted)", gb.grad, w3 * db,
                    1e-5, 1e-4))
    check_match_forms(tag, a, b, rl, rr)
    times = None
    if timed:
        fwd = cuda_ms(lambda: emd_cost(a, b), 5)
        fwd_plain = cuda_ms(lambda: emd_cost_plain(a, b), 1)
        bwd = cuda_ms(lambda: emd_backward(a, b, rl, rr), 5)
        bwd_plain = cuda_ms(lambda: emd_backward_plain(a, b, rl, rr), 1)
        times = {"emd_cost": (fwd, fwd_plain),
                 "emd_backward": (bwd, bwd_plain)}
        say(f"    {tag}: cost kernel {fwd:.3f} ms, plain {fwd_plain:.3f} ms;"
            f" backward kernel {bwd:.3f} ms, plain {bwd_plain:.3f} ms")
    return cost_err, bwd_err, times


def check_match_forms(tag, a, b, rl, rr, pairs=4):
    """The kernels' E (the forward's, which kernel 6 shares) and the plain
    versions' on the same residuals (kernel 5's, of the first `pairs`
    pairs): the gradient of the match that each form defines, in float64
    (emd_backward_f64), held against the other, and kernel 6's gradient
    against both, at the EMD backward's tolerance (atol 1e-5, rtol
    1e-4)."""
    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_backward, emd_backward_f64)

    a, b, rl, rr = (t[:pairs] for t in (a, b, rl, rr))
    fwd = emd_backward_f64(a, b, rl, rr, "forward")
    bwd = emd_backward_f64(a, b, rl, rr, "backward")
    kernel = emd_backward(a, b, rl, rr)
    for i, side in enumerate(("da", "db")):
        check_close(f"{tag} {side} of the kernels' match vs the plain "
                    "versions' (float64)", fwd[i], bwd[i], 1e-5, 1e-4)
        check_close(f"{tag} {side} kernel 6 vs its own form, the "
                    "forward's (float64)", kernel[i].double(), fwd[i], 1e-5,
                    1e-4)
        check_close(f"{tag} {side} kernel 6 vs the plain versions' form "
                    "(float64)", kernel[i].double(), bwd[i], 1e-5, 1e-4)


def check_pairwise_emd(S, R, N, M, seed, timed):
    """The EMD grid against the paired EMD kernel on the same pairs
    (exact: the same device function) and against its plain version."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.emd import emd_cost
    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_emd, pairwise_emd_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = 0.3 * torch.randn(S, N, 3, device="cuda", generator=gen)
    r = 0.3 * torch.randn(R, M, 3, device="cuda", generator=gen)
    tag = f"pairwise_emd S={S} R={R} N={N} M={M}"
    got = pairwise_emd(s, r)
    paired = emd_cost(s[:, None].expand(S, R, N, 3).reshape(S * R, N, 3),
                      r[None].expand(S, R, M, 3).reshape(S * R, M, 3))
    check_close(f"{tag} vs the paired kernel (exact)", got,
                paired.reshape(S, R), 0.0)
    err = check_close(f"{tag} vs plain", got, pairwise_emd_plain(s, r),
                      1e-5, 2e-4)
    times = None
    if timed:
        ms = cuda_ms(lambda: pairwise_emd(s, r), 2)
        plain = cuda_ms(lambda: pairwise_emd_plain(s, r), 1, warmup=0)
        times = (ms, plain)
        say(f"    {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms")
    return err, times


def train_decode_inputs(config, B, N, seed):
    """Packed train-mode arrays of the config's K-component decoder (random
    weights from `seed`, as the training path's first step sees them),
    FiLM affines for a random latent, and a state p (K, B, 3, N), all on
    the card."""
    import torch

    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        film_ab_train, pack_point_decoder_train)

    gen = torch.Generator().manual_seed(seed)
    model = FlowMixtureModel(**config, generator=gen)
    dec = model.pc_decoder.cuda()
    packed = {k: v.detach() for k, v in pack_point_decoder_train(dec).items()}
    g = torch.randn(B, model.g_latent_space_size, generator=gen).cuda()
    ab, _ = film_ab_train(packed, g)
    p = 0.3 * torch.randn(model.n_components, B, 3, N, generator=gen).cuda()
    return packed, ab.detach(), p


def check_train_decode(config, B, N, seed, timed):
    """Kernel 7 against its plain version (p0, logvar sum and saved states
    atol 1e-4; batch statistics rtol 1e-5, atol 1e-5 for entries near 0);
    kernel 8 against its plain version on kernel 7's residuals (every
    packed array's and ab's gradient within 3e-2 of its own largest
    entry); both bit-equal over two launches.

    The input cotangent is held in norm: |dp - plain| / |plain| <= 3e-3,
    and at most 3 in 10,000 entries beyond 1e-3 of the largest. Its
    largest entries differ more, in both versions alike: a point whose
    pre-ReLU value lies within rounding of 0 in a BatchNorm feature of
    small batch variance (1 / sqrt(var + eps) up to about 300) takes the
    other side of the kink in each float32 order of operations, and its
    gradient moves by that factor. At the flagship shape the plain
    version is itself up to 2.6e-2 of its largest entry from the same
    computation in float64, on a few dozen of 1.6 M entries (the timed
    call prints kernel and plain against float64)."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_bwd_plain, train_decode_fwd,
        train_decode_fwd_plain)

    packed, ab, p = train_decode_inputs(config, B, N, seed)
    K, C, _, f = packed["w1"].shape[:4]
    tag = f"train_decode K={K} B={B} N={N} C={C} f={f}"
    got = train_decode_fwd(packed, ab, p)
    want = train_decode_fwd_plain(packed, ab, p)
    fwd_err = max(check_close(f"{tag} p0", got[0], want[0], 1e-4),
                  check_close(f"{tag} logvar", got[1], want[1], 1e-4))
    check_close(f"{tag} saved states", got[2], want[2], 1e-4)
    check_close(f"{tag} batch stats", got[3], want[3], 1e-5, 1e-5)
    if not all(torch.equal(a, b) for a, b in
               zip(got, train_decode_fwd(packed, ab, p))):
        fail(f"{tag}: two forward launches differ")
    _, _, xsave, stats = got
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dp0 = torch.randn(p.shape, device="cuda", generator=gen)
    dlv = torch.randn(p.shape, device="cuda", generator=gen)
    kb = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv)
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv)

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()

    pairs = [("dp", kb[0], dp)] + [
        (f"d{k}", kb[1][k], v) for k, v in grads.items()] + [
        ("dab", kb[2], dab)]
    bwd_err = max((a - b).abs().max().item() for _, a, b in pairs)
    dp_norm = ((kb[0] - dp).norm() / dp.norm()).item()
    dp_far = ((kb[0] - dp).abs() > 1e-3 * dp.abs().max()).float().mean().item()
    say(f"    {tag} backward, |diff| / max |plain|: " + ", ".join(
        f"{name} {rel(a, b):.2g}" for name, a, b in pairs)
        + f"; dp in norm {dp_norm:.2g}, share of dp beyond 1e-3 of its "
        f"max {dp_far:.2g}; max |diff| {bwd_err:.3g}")
    if not (dp_norm <= 3e-3 and dp_far <= 3e-4):
        fail(f"{tag} backward dp: {dp_norm:.3g} in norm (bound 3e-3), "
             f"{dp_far:.3g} of entries beyond 1e-3 of the max (bound 3e-4)")
    for name, a, b in pairs[1:]:
        if not rel(a, b) <= 3e-2:
            fail(f"{tag} backward {name}: {rel(a, b):.3g} of its largest "
                 "entry (bound 3e-2)")
    again = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv)
    if not (torch.equal(kb[0], again[0]) and torch.equal(kb[2], again[2])
            and all(torch.equal(kb[1][k], again[1][k]) for k in grads)):
        fail(f"{tag}: two backward launches differ")
    times = None
    if timed:
        f64 = train_decode_bwd_plain(
            {k: v.double() for k, v in packed.items()}, ab.double(),
            xsave.double(), stats.double(), dp0.double(), dlv.double())
        say(f"    {tag} backward against float64 (|diff| / max), kernel / "
            f"plain: dp {rel(kb[0], f64[0]):.2g} / {rel(dp, f64[0]):.2g}, dw1 "
            f"{rel(kb[1]['w1'], f64[1]['w1']):.2g} / "
            f"{rel(grads['w1'], f64[1]['w1']):.2g}, dab "
            f"{rel(kb[2], f64[2]):.2g} / {rel(dab, f64[2]):.2g}")
        del f64
        fwd = cuda_ms(lambda: train_decode_fwd(packed, ab, p), 5)
        fwd_plain = cuda_ms(lambda: train_decode_fwd_plain(packed, ab, p), 2)
        bwd = cuda_ms(
            lambda: train_decode_bwd(packed, ab, xsave, stats, dp0, dlv), 3)
        bwd_plain = cuda_ms(lambda: train_decode_bwd_plain(
            packed, ab, xsave, stats, dp0, dlv), 1)
        times = {"train_decode_fwd": (fwd, fwd_plain),
                 "train_decode_bwd": (bwd, bwd_plain)}
        say(f"    {tag}: forward kernel {fwd:.3f} ms, plain {fwd_plain:.3f} "
            f"ms; backward kernel {bwd:.3f} ms, plain {bwd_plain:.3f} ms")
        w1 = w1_bmm_ms(K, B * N, f, C)
        say(f"    {tag}: the forward's W1 product alone as torch.bmm of "
            f"(2K, f, f) W1 and (2K, f, BN) a, fp32 highest: {w1:.3f} ms "
            f"for all {C} couplings")
        bmm = dw1_bmm_ms(K, B * N, f, C)
        say(f"    {tag}: the backward's dW1 pass as torch.bmm of the "
            f"materialised (2K, f, BN) dh2 and (2K, BN, f) a, fp32 highest: "
            f"{bmm:.3f} ms for all {C} couplings")
    return fwd_err, bwd_err, times


def w1_bmm_ms(K, n, f, C):
    """C times one torch.bmm of one coupling's hidden W1 product, (2K, f,
    f) by (2K, f, n) (random values), at fp32 'highest': the library
    yardstick of kernel 1 and of kernel 7's hidden pass (their W1
    products alone, without the FiLM, the BatchNorms, the cache and the
    sums), which the port never calls."""
    import torch

    if torch.get_float32_matmul_precision() != "highest":
        fail("the fp32 matmul precision is not 'highest'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    w1 = torch.randn(2 * K, f, f, device="cuda", generator=gen)
    a = torch.randn(2 * K, f, n, device="cuda", generator=gen)
    return C * cuda_ms(lambda: torch.bmm(w1, a), 10)


def dw1_bmm_ms(K, n, f, C):
    """C times one torch.bmm of one coupling's dW1 operands, (2K, f, n) and
    (2K, n, f) (random values: the time does not depend on them), at fp32
    'highest': the library yardstick of kernel 8's dW1 pass, which the
    port never calls."""
    import torch

    if torch.get_float32_matmul_precision() != "highest":
        fail("the fp32 matmul precision is not 'highest'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dh2 = torch.randn(2 * K, f, n, device="cuda", generator=gen)
    a = torch.randn(2 * K, n, f, device="cuda", generator=gen)
    return C * cuda_ms(lambda: torch.bmm(dh2, a), 10)


def phase_kernels():
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    say("[2] kernels against their plain versions")
    small = dict(FLAGSHIP_AIRPLANE, n_components=2, g_latent_space_size=12,
                 g_prior_n_flows=2, p_decoder_n_flows=3,
                 p_decoder_n_features=8)
    # ragged shapes and the narrow (f=8) instantiation go through the same
    # kernels as the flagship's
    check_point_decode(small, 3, 50, 7, timed=False)
    check_nn_distance(3, 50, 77, 8, timed=False)
    # three row chunks, the last partial, with ties in both directions
    check_nn_distance(2, 1100, 700, 20, timed=False, grid=True)
    check_pairwise(3, 5, 50, 77, 9, timed=False, thr=0.01)
    pd_err, pd_times = check_point_decode(FLAGSHIP_AIRPLANE, BATCH, N_POINTS,
                                          0, timed=True)
    nn_err, nn_times = check_nn_distance(BATCH, N_POINTS, N_POINTS, 1,
                                         timed=True)
    S = R = 64  # the timed CD grid
    pw_err, pw_times = check_pairwise(S, R, N_POINTS, N_POINTS, 2,
                                      timed=True)
    # the (S, R) grid that phase 3's evaluate gives it: 2 x BATCH clouds
    # on each side
    pw_main_err, _ = check_pairwise(2 * BATCH, 2 * BATCH, N_POINTS, N_POINTS,
                                    3, timed=False)

    # EMD: ragged, unequal capacities (multiL = 2, then multiR = 2), the
    # flagship batch (timed) and the SVR protocol's 2500 points, the
    # largest cloud of the JAX package's protocols
    cost_errs, bwd_errs = [], []
    for B, N, M, seed in ((3, 50, 77, 10), (2, 40, 100, 11),
                          (2, 100, 40, 12), (4, 2500, 2500, 13)):
        c, g, _ = check_emd(B, N, M, seed, timed=False)
        cost_errs.append(c)
        bwd_errs.append(g)
    c, g, emd_times = check_emd(BATCH, N_POINTS, N_POINTS, 14, timed=True)
    pe_err, _ = check_pairwise_emd(5, 7, 50, 77, 15, timed=False)
    E = 32  # the timed EMD grid, E x E pairs
    pe_big_err, pe_times = check_pairwise_emd(E, E, N_POINTS, N_POINTS, 16,
                                              timed=True)

    # train decode: a ragged N, a small batch, then the flagship shape
    td_fwd, td_bwd = [], []
    for B, N, seed in ((16, 2000, 17), (2, N_POINTS, 18)):
        f_err, b_err, _ = check_train_decode(FLAGSHIP_AIRPLANE, B, N, seed,
                                             timed=False)
        td_fwd.append(f_err)
        td_bwd.append(b_err)
    f_err, b_err, td_times = check_train_decode(
        FLAGSHIP_AIRPLANE, BATCH, N_POINTS, 19, timed=True)

    # the least time of each timed call: operations per point, pair or
    # pair element as the kernels' sources count them (an FMA is 2 FLOP;
    # an exp and a root or rsqrt one special-function operation each)
    B, N = BATCH, N_POINTS
    K, _, _, C, f = pd_times["dims"]
    fwd_flop = 4 * f * f + 24 * f  # 2 heads x (W0, W1, W2 products)
    pairs = B * N * N
    bounds = {
        "point_decode": bound(**decode_work(K, B, N, C, f, fwd_flop, 24)),
        # the Chamfer kernels need each point pair's distance once, 3
        # differences, 3 squares and 2 sums (8 FLOP), and its two minima,
        # the row's and the column's (2), as the TPU's CD grid takes both
        # from one distance tile (pairwise_kernel.py:90-97)
        "nn_distance": bound(flop=pairs * CD_FLOP, nbytes=2 * B * N * 16),
        "pairwise_cd_stats": bound(flop=S * R * N * N * CD_FLOP,
                                   nbytes=(S + R) * N * 12 + S * R * 16),
        "emd_cost": bound(flop=pairs * EMD_FLOP, sfu=pairs * EMD_SFU,
                          nbytes=2 * B * N * 12),
        # it reads both clouds and both residuals, writes da and db
        "emd_backward": bound(flop=pairs * EMD_BWD_FLOP,
                              sfu=pairs * EMD_BWD_SFU,
                              nbytes=2 * B * N * (12 + 12 + 36)),
        "pairwise_emd": bound(flop=E * E * N * N * EMD_FLOP,
                              sfu=E * E * N * N * EMD_SFU,
                              nbytes=2 * E * N * 12),
        # kernel 7 writes xsave (12 C bytes a point)
        "train_decode_fwd": bound(**decode_work(K, B, N, C, f, fwd_flop,
                                                24 + 12 * C)),
        # kernel 8: the forward's recompute, dW2 and dfz (24 f), dW1 and
        # W1^T dh2 (8 f^2 + 12 f), the input pass (36 f); it reads xsave,
        # dp0 and dlv, writes dp
        "train_decode_bwd": bound(**decode_work(
            K, B, N, C, f, 12 * f * f + 96 * f, 24 + 12 * C)),
    }
    say(f"    EMD forward: the cost needs {EMD_SFU} exps and roots and "
        f"{EMD_FLOP} FLOP a point pair, the kernels do {EMD_SFU_RECOMPUTED} "
        f"exps and roots ({EMD_SFU_RECOMPUTED / EMD_SFU:.1f}x); the grid "
        f"{pe_times[0]:.3f} ms against its bound "
        f"{bounds['pairwise_emd'][0]:.3f} ms")
    return {
        "point_decode": (pd_err, pd_times["direct"]),
        "nn_distance": (nn_err, nn_times),
        "pairwise_cd_stats": (max(pw_err, pw_main_err), pw_times),
        "emd_cost": (max(cost_errs + [c]), emd_times["emd_cost"]),
        "emd_backward": (max(bwd_errs + [g]), emd_times["emd_backward"]),
        "pairwise_emd": (max(pe_err, pe_big_err), pe_times),
        "train_decode_fwd": (max(td_fwd + [f_err]),
                             td_times["train_decode_fwd"]),
        "train_decode_bwd": (max(td_bwd + [b_err]),
                             td_times["train_decode_bwd"]),
    }, bounds


def plain_sample_cd(model, packed, g_in, ref, gen):
    """The sampling step and paired CD composed from the plain versions
    (the same draws as train/step.make_sample_step)."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import (
        nn_distance_plain)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode_plain)

    with torch.inference_mode():
        B, K, G = g_in.shape[0], model.n_components, model.g_latent_space_size
        g0_eps = torch.randn(B, G, generator=gen, device=g_in.device)
        g = model.encode(g_in, "generating", g0_eps)["g_sample"]
        logits = model.get_weights(g)
        ids = torch.multinomial(logits.softmax(-1), N_POINTS,
                                replacement=True, generator=gen)
        base_eps = torch.randn(K, B, 3, N_POINTS, generator=gen,
                               device=g_in.device)
        mus, logvars = model.point_base(g)
        base = mus[None] + torch.exp(0.5 * logvars)[None] * base_eps
        decoded, _ = point_decode_plain(packed, film_alpha_beta(packed, g),
                                        base)
        pick = ids[None, :, None, :].expand(1, B, 3, N_POINTS)
        samples = torch.gather(decoded, 0, pick)[0]
        dl, dr = nn_distance_plain(samples.transpose(1, 2).contiguous(), ref,
                                   with_idx=False)
        return dl.mean(1) + dr.mean(1)


def kernel_sample_cd(step, g_in, ref, gen):
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import chamfer

    with torch.inference_mode():
        samples, _, _ = step(g_in, gen)
        dl, dr = chamfer(samples.transpose(1, 2).contiguous(), ref)
        return dl.mean(1) + dr.mean(1)


def check_small_against_cpu(model, seed):
    """The card's path against the CPU path (plain versions) on a small
    input with the same weights and the same noise."""
    import copy

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.metrics.evaluation import (
        EMD_CD_F1, compute_all_metrics)

    cpu = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(seed)
    B, K, G = 2, model.n_components, model.g_latent_space_size
    g_in = torch.from_numpy(reference_clouds(np.random.default_rng(seed), B))
    g0_eps = torch.randn(B, G, generator=gen)
    base_eps = torch.randn(K, B, 3, N_POINTS, generator=gen)
    outs = []
    with torch.inference_mode():
        for m, dev in ((model, "cuda"), (cpu, "cpu")):
            for mode in ("generating", "autoencoding"):
                g = m.encode(g_in.to(dev), mode, g0_eps.to(dev))["g_sample"]
                logits = m.get_weights(g)
                ids = logits.argmax(-1)[:, None].expand(B, N_POINTS)
                samples, _ = m.decode_sampling(g, ids, base_eps.to(dev),
                                               m.pack_decoder())
                outs.append((logits.cpu(), samples.cpu()))
    for (lg, sg), (lc, sc) in zip(outs[:2], outs[2:]):
        check_close("slice logits, card vs CPU", lg, lc, 1e-6, 1e-5)
        check_close("slice samples, card vs CPU", sg, sc, 1e-4)
    rng = np.random.default_rng(seed + 1)
    gen_pcs = reference_clouds(rng, 8).transpose(0, 2, 1)
    ref_pcs = reference_clouds(rng, 8).transpose(0, 2, 1)
    on_card = compute_all_metrics(gen_pcs, ref_pcs, 60, cd_option=True,
                                  f1_option=True, device="cuda")
    on_cpu = compute_all_metrics(gen_pcs, ref_pcs, 60, cd_option=True,
                                 f1_option=True, device="cpu")
    for key in ("lgan_mmd-CD", "lgan_cov-CD", "1-NN-CD-acc",
                "lgan_mmd-F1", "lgan_cov-F1", "1-NN-F1-acc"):
        a, b = float(on_card[key]), float(on_cpu[key])
        if abs(a - b) > 1e-5 * abs(b) + 1e-7:
            fail(f"metric {key}: card {a!r} vs CPU {b!r}")
    say("    metrics on 8 vs 8 clouds: card equals CPU (rtol 1e-5)")
    # EMD on the first 256 points of each cloud, so that the CPU's plain
    # auction stays short; MMD and paired EMD rtol 1e-4 (the auction's sums
    # run in another order), COV and 1-NNA equal
    gen_pcs = np.ascontiguousarray(gen_pcs[:, :256])
    ref_pcs = np.ascontiguousarray(ref_pcs[:, :256])
    on_card = compute_all_metrics(gen_pcs, ref_pcs, 60, emd_option=True,
                                  device="cuda")
    on_cpu = compute_all_metrics(gen_pcs, ref_pcs, 60, emd_option=True,
                                 device="cpu")
    on_card["EMD"] = EMD_CD_F1(gen_pcs, ref_pcs, 60, emd_option=True,
                               device="cuda")["EMD"]
    on_cpu["EMD"] = EMD_CD_F1(gen_pcs, ref_pcs, 60, emd_option=True,
                              device="cpu")["EMD"]
    for key, rtol in (("lgan_mmd-EMD", 1e-4), ("EMD", 1e-4),
                      ("lgan_cov-EMD", 0.0), ("1-NN-EMD-acc", 0.0)):
        a, b = float(on_card[key]), float(on_cpu[key])
        if abs(a - b) > rtol * abs(b):
            fail(f"metric {key}: card {a!r} vs CPU {b!r}")
    say("    EMD metrics on 8 vs 8 clouds of 256 points: card equals CPU "
        "(MMD-EMD and EMD rtol 1e-4, COV-EMD and 1-NNA-EMD exact)")


def emd_loss_grad(samples, ref_clouds):
    """The EMD between generated clouds (B, 3, N) and their references
    (B, 3, N) as a differentiable loss, as a user fitting clouds calls it:
    emd_cost forward (kernel 5) and backward (kernel 6)."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.emd import emd_cost

    x = samples.detach().transpose(1, 2).contiguous().requires_grad_()
    ref = torch.from_numpy(ref_clouds.transpose(0, 2, 1).copy()).cuda()
    loss = emd_cost(x, ref).mean() / x.shape[1]
    loss.backward()
    return loss.item(), x.grad


def phase_slice(card):
    import math

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.eval.evaluating import evaluate
    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import nn_distance
    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_backward, emd_cost)
    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_cd_stats, pairwise_emd)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode)
    from go_with_the_flows_tpu_torch.train.step import make_sample_step
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    say("[3] slice: flagship airplane model on the card")
    model = make_model(FLAGSHIP_AIRPLANE, 0, "cuda")
    K = model.n_components
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        clouds = reference_clouds(rng, BATCH)
        batches.append({"cloud": clouds, "eval_cloud": clouds})
    wrappers = (point_decode, nn_distance, pairwise_cd_stats, emd_cost,
                emd_backward, pairwise_emd)
    gen_step = make_sample_step(model, N_POINTS, "generating")
    ae_step = make_sample_step(model, N_POINTS, "autoencoding")
    metrics = dict(cd=True, emd=True, f1=True)

    def run_evaluate(mode, **flags):
        step = gen_step if mode == "generating" else ae_step
        t = time.perf_counter()
        res = evaluate(batches, step, gen, "cuda", util_mode=mode, **flags)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    for w in wrappers:
        w.launches = 0
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    samples, labels, _ = gen_step(
        torch.from_numpy(batches[0]["cloud"]).cuda(), gen)
    res_g, sec_g = run_evaluate("generating", **metrics)
    res_a, sec_a = run_evaluate("autoencoding", **metrics)
    loss, grad = emd_loss_grad(samples, batches[0]["eval_cloud"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    say(f"    evaluate with CD, EMD and F1 (2 x {BATCH} clouds): generating "
        f"{sec_g:.2f} s, autoencoding {sec_a:.2f} s; with the EMD loss "
        f"gradient {seconds:.2f} s in all; launches {launches}")

    if tuple(samples.shape) != (BATCH, 3, N_POINTS):
        fail(f"samples shape {tuple(samples.shape)}")
    if int(labels.min()) < 1 or int(labels.max()) > K:
        fail(f"labels outside 1..{K}: {int(labels.min())}..{int(labels.max())}")
    if tuple(grad.shape) != (BATCH, N_POINTS, 3) \
            or not bool(torch.isfinite(grad).all()):
        fail("the EMD loss gradient is not finite or has the wrong shape")
    report = {
        "MMD-CD": res_g["cd_mmds"], "COV-CD": res_g["cd_covs"],
        "1-NNA-CD": res_g["cd_1nns"], "MMD-EMD": res_g["emd_mmds"],
        "COV-EMD": res_g["emd_covs"], "1-NNA-EMD": res_g["emd_1nns"],
        "CD": res_a["cd"], "EMD": res_a["emd"], "F1": res_a["f1_0.0010"],
        "EMD loss": loss,
    }
    say("    " + ", ".join(f"{k} {v:.4f}" for k, v in report.items()))
    for k, v in report.items():
        if not math.isfinite(v):
            fail(f"{k} is not finite: {v}")
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched on the main path")

    # the EMD part of evaluate's time: warm passes without and with it
    for mode in ("generating", "autoencoding"):
        _, cd_only = run_evaluate(mode, cd=True, f1=True)
        _, with_emd = run_evaluate(mode, **metrics)
        say(f"    evaluate {mode} (warm): CD+F1 {cd_only:.3f} s, "
            f"CD+EMD+F1 {with_emd:.3f} s [{card}]")

    check_small_against_cpu(model, 5)

    rates = {}
    for B, reps in ((BATCH, 10), (1024, 3)):
        g_in = torch.from_numpy(reference_clouds(rng, B)).cuda()
        ref = torch.from_numpy(
            reference_clouds(rng, B).transpose(0, 2, 1).copy()).cuda()
        packed = model.pack_decoder()
        kernel = cuda_ms(lambda: kernel_sample_cd(gen_step, g_in, ref, gen),
                         reps)
        plain = cuda_ms(
            lambda: plain_sample_cd(model, packed, g_in, ref, gen), reps)
        rates[B] = (1000.0 * B / kernel, 1000.0 * B / plain)
        # the decode alone at the batch's shape (K, B, 3, N)
        ab = film_alpha_beta(packed, torch.randn(
            B, model.g_latent_space_size, device="cuda", generator=gen))
        base = torch.randn(K, B, 3, N_POINTS, device="cuda", generator=gen)
        decode = cuda_ms(lambda: point_decode(packed, ab, base), reps)
        say(f"    sample+CD B={B}: kernel path {rates[B][0]:.1f} clouds/s "
            f"({kernel:.2f} ms; the decode alone {decode:.2f} ms, "
            f"{100.0 * decode / kernel:.1f} %), plain path "
            f"{rates[B][1]:.1f} clouds/s ({plain:.2f} ms) [{card}]")
    return launches


def device_kernels(prof):
    """(milliseconds, launches, name) of every kernel and copy that ran on
    the card in a profile, the longest first (user annotations, which
    span other kernels, left out)."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / 1000.0, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, reverse=True)


# the device functions of the two train-decode kernels, by pass
TRAIN_DECODE_PASSES = {
    "kernel 8 (train_decode_bwd)": {
        "head": "bwd_head_kernel", "B1 hidden": "bwd_hidden_kernel",
        "B2 dW1": "bwd_dw1_kernel", "input": "bwd_input_kernel",
        "reductions": "sum_rows_kernel"},
    "kernel 7 (train_decode_fwd)": {
        "hidden": "fwd_hidden_kernel", "update": "fwd_update_kernel",
        "statistics": ("seed_moments_kernel", "fwd_stats_kernel")},
}


def passes_of(rows, passes):
    """{label: (ms, launches)} of the profile rows whose name holds one of
    the pass's device function names."""
    out = {}
    for label, names in passes.items():
        names = (names,) if isinstance(names, str) else names
        hit = [(t, n) for t, n, name in rows if any(x in name for x in names)]
        out[label] = (sum(t for t, _ in hit), sum(n for _, n in hit))
    return out


def host_ops(prof):
    """(self host milliseconds, calls, name) of the host-side operations
    of a profile, the longest first."""
    from torch.autograd import DeviceType

    rows = [(e.self_cpu_time_total / 1000.0, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    return sorted(rows, reverse=True)


def train_step_ms(step, batches, reps):
    """Host milliseconds per step over `reps` steps, ending in a
    synchronize, and the peak device memory over them (GB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for i in range(reps):
        clouds = batches[i % len(batches)]
        step(clouds, clouds)
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t) / reps
    return ms, torch.cuda.max_memory_allocated() / 1e9


def check_train_steps(base, clouds, eps):
    """One step from one state through the kernels and through the
    decoder's modules: metrics rtol 1e-4, every parameter's gradient
    within 3e-2 of its own largest entry, parameters atol 5e-4, BatchNorm
    buffers atol 1e-4. The PointNet's last BatchNorm bias is invariant
    under the loss (the posterior's first BatchNorm removes it), so its
    gradient is rounding noise and AMSGrad moves it by +-lr either way
    (RESULTS.md round 5): it is held to 2 lr. The step runs at lr 2e-4,
    as tests/test_train_kernel.py holds the TPU kernels' step."""
    import copy

    import torch

    from go_with_the_flows_tpu_torch.ops.layers import BatchNorm
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train.step import make_train_step

    hp = dict(TRAIN_HP, min_lr=2e-4, max_lr=2e-4)
    walker = "pc_encoder." + [n for n, m in base.pc_encoder.named_modules()
                              if isinstance(m, BatchNorm)][-1] + ".bias"
    say(f"    one step at B={clouds.shape[0]}, lr {hp['max_lr']:g}")
    out = {}
    for fused in (False, True):
        model = copy.deepcopy(base).cuda()
        step = make_train_step(model, make_optimizer(
            list(model.parameters()), **hp), fused_decoder=fused)
        metrics = step(clouds, clouds, posterior_eps=eps)
        grads = {n: q.grad for n, q in model.named_parameters()}
        out[fused] = ({k: float(v) for k, v in metrics.items()}, grads,
                      model.state_dict())
        del model, step
    (mp, gp, sp), (mk, gk, sk) = out[False], out[True]
    for k in mp:
        if abs(mk[k] - mp[k]) > 1e-4 * abs(mp[k]):
            fail(f"train step {k}: kernel path {mk[k]!r}, plain {mp[k]!r}")
    say("    one step, kernel path vs plain path: " + ", ".join(
        f"{k} {mk[k]:.6g} vs {mp[k]:.6g}" for k in mp))
    worst_grad = (0.0, "")
    for name, want in gp.items():
        got = gk[name]
        if (want is None) != (got is None):
            fail(f"train step: {name} has a gradient on one path only")
        if want is None:
            continue
        rel = ((got - want).abs().max()
               / (want.abs().max() + 1e-30)).item()
        if name != walker:
            worst_grad = max(worst_grad, (rel, name))
    buffers = {n for n, _ in base.named_buffers()}
    worst = {True: (0.0, ""), False: (0.0, "")}
    for name, want in sp.items():
        diff = (sk[name].float() - want.float()).abs().max().item()
        if name == walker:
            bound = 2 * hp["max_lr"] * (1 + 1e-3)
            walk = diff
        else:
            bound = 1e-4 if name in buffers else 5e-4
            worst[name in buffers] = max(worst[name in buffers],
                                         (diff, name))
        if diff > bound:
            fail(f"train step: {name} differs by {diff:.3g} (bound {bound:g})")
    if worst_grad[0] > 3e-2:
        fail(f"train step: gradient of {worst_grad[1]} differs by "
             f"{worst_grad[0]:.3g} of its largest entry (bound 3e-2)")
    say(f"    worst gradient {worst_grad[0]:.3g} of its max "
        f"({worst_grad[1]}); worst parameter |diff| {worst[False][0]:.3g} "
        f"({worst[False][1]}); worst buffer |diff| {worst[True][0]:.3g} "
        f"({worst[True][1]}); {walker} |diff| {walk:.3g} (bound 2 lr)")


def phase_train(card):
    import copy
    import math

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train.step import make_train_step
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    say(f"[4] train: flagship airplane model, B={BATCH}, N={N_POINTS}")
    base = FlowMixtureModel(**FLAGSHIP_AIRPLANE,
                            generator=torch.Generator().manual_seed(0))
    jiggle_batch_norms(base, 1000)
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(reference_clouds(rng, BATCH)).cuda()
               for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    eps = torch.randn(BATCH, base.g_latent_space_size, device="cuda",
                      generator=gen)
    # the plain path's autograd holds every coupling's activations: the
    # comparison runs at the largest batch at which it fits
    for B in (BATCH, BATCH // 2, BATCH // 4):
        try:
            check_train_steps(base, batches[0][:B].contiguous(), eps[:B])
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            say(f"    one-step comparison: the plain path is out of memory "
                f"at B={B}")
    else:
        fail("the plain training path does not fit at any batch tried")
    torch.cuda.empty_cache()

    def trainer(fused):
        model = copy.deepcopy(base).cuda()
        opt = make_optimizer(list(model.parameters()), **TRAIN_HP)
        step = make_train_step(model, opt, fused_decoder=fused)
        return lambda p, g: step(p, g, gen)

    # the main path: twenty kernel-path steps from the seeded state
    step_k = trainer(None)
    wrappers = (train_decode_fwd, train_decode_bwd)
    for w in wrappers:
        w.launches = 0
    losses = []
    for i in range(20):
        clouds = batches[i % len(batches)]
        losses.append(step_k(clouds, clouds)["loss"])
    losses = [float(v) for v in losses]
    launches = {w.__name__: w.launches for w in wrappers}
    say(f"    20 kernel-path steps: loss {losses[0]:.2f} -> {losses[-1]:.2f}"
        f"; launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train losses are not finite: {losses}")
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched on the training path")

    ms_k, mem_k = train_step_ms(step_k, batches, 10)
    say(f"    kernel path B={BATCH}: {ms_k:.2f} ms/step, "
        f"{1000.0 * BATCH / ms_k:.1f} train clouds/s, peak "
        f"{mem_k:.2f} GB [{card}]")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_k(batches[0], batches[0])
        torch.cuda.synchronize()
    rows = device_kernels(prof)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        say("    profiler: no device time recorded (idle share not "
            "measured)")
    else:
        # one stream: the kernels' sum is the time the card was busy
        say(f"    profiled step: device busy {busy:.2f} ms of {ms_k:.2f} "
            f"ms/step, idle share {max(0.0, 1.0 - busy / ms_k):.3f}; "
            f"{sum(r[1] for r in rows)} device operations")
        for t, n, name in rows[:12]:
            say(f"      {t:9.3f} ms {n:6d}x {name[:70]}")
        for what, passes in TRAIN_DECODE_PASSES.items():
            split = passes_of(rows, passes)
            say(f"    {what} by pass: " + "; ".join(
                f"{label} {t:.3f} ms in {n} launches"
                for label, (t, n) in split.items()))
            for label, (t, _) in split.items():
                if t <= 0:
                    fail(f"{what}: the profile shows no time in its "
                         f"{label} pass")
        # kernel 7's statistics: one launch a coupling (a launch for every
        # hidden pass) and the seed
        count = {name: sum(n for _, n, key in rows if name in key)
                 for name in ("seed_moments_kernel", "fwd_stats_kernel",
                              "fwd_hidden_kernel")}
        say(f"    kernel 7 statistics launches: {count['seed_moments_kernel']}"
            f" seed, {count['fwd_stats_kernel']} for "
            f"{count['fwd_hidden_kernel']} couplings")
        if count["fwd_stats_kernel"] > count["fwd_hidden_kernel"]:
            fail("kernel 7 takes more than one statistics launch a coupling")
    hosts = host_ops(prof)
    say(f"    profiled step, host side (profiler overhead included): "
        f"{sum(r[1] for r in hosts)} operations, top by self time:")
    for t, n, name in hosts[:8]:
        say(f"      {t:9.3f} ms {n:6d}x {name[:70]}")
    del step_k
    torch.cuda.empty_cache()

    # the plain path, at the largest batch that fits on the card
    for B in (BATCH, BATCH // 2, BATCH // 4):
        try:
            step_p = trainer(False)
            small = [c[:B].contiguous() for c in batches]
            step_p(small[0], small[0])
            ms_p, mem_p = train_step_ms(step_p, small, 3)
        except torch.cuda.OutOfMemoryError:
            step_p = None
            torch.cuda.empty_cache()
            say(f"    plain path: out of memory at B={B}")
            continue
        say(f"    plain path B={B}: {ms_p:.2f} ms/step, "
            f"{1000.0 * B / ms_p:.1f} train clouds/s, peak {mem_p:.2f} GB "
            f"[{card}]")
        break
    else:
        fail("the plain training path does not fit at any batch tried")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    t_start = time.perf_counter()
    kind, card = phase_device()
    sys.path.insert(0, ROOT)
    try:
        from go_with_the_flows_tpu_torch.ops import precision
    except ImportError as e:
        fail(f"the port package is not next to chip_smoke.py ({e})")
    precision.get_matmul_precision()

    marks = [time.perf_counter()]
    phase_build()
    marks.append(time.perf_counter())
    measured, bounds = phase_kernels()
    marks.append(time.perf_counter())
    launches = phase_slice(card)
    marks.append(time.perf_counter())
    launches.update(phase_train(card))
    marks.append(time.perf_counter())
    say("phase seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in
        zip(("build", "kernels", "slice", "train"), marks, marks[1:])))
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    sources = {
        "point_decode": (
            "go_with_the_flows_tpu_torch/csrc/point_decode.cu",
            "go_with_the_flows_tpu/ops/pallas/coupling_kernel.py:453"),
        "nn_distance": (
            "go_with_the_flows_tpu_torch/csrc/nn_distance.cu",
            "go_with_the_flows_tpu/ops/pallas/chamfer_kernel.py:150"),
        "pairwise_cd_stats": (
            "go_with_the_flows_tpu_torch/csrc/pairwise_cd.cu",
            "go_with_the_flows_tpu/ops/pallas/pairwise_kernel.py:151"),
        "emd_cost": (
            "go_with_the_flows_tpu_torch/csrc/emd.cu",
            "go_with_the_flows_tpu/ops/pallas/emd_kernel.py:275"),
        "emd_backward": (
            "go_with_the_flows_tpu_torch/csrc/emd.cu",
            "go_with_the_flows_tpu/ops/pallas/emd_kernel.py:375"),
        "pairwise_emd": (
            "go_with_the_flows_tpu_torch/csrc/emd.cu",
            "go_with_the_flows_tpu/ops/pallas/pairwise_kernel.py:187"),
        "train_decode_fwd": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cu",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:806"),
        "train_decode_bwd": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cu",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:880"),
    }
    kernels = []
    for name, (err, (ms, plain_ms)) in measured.items():
        source, replaces = sources[name]
        bound_ms, bound_by = bounds[name]
        # no single PyTorch call computes any of these functions (PERF.md)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    say(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
