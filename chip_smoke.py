#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # phases 0-10, one card
    python3 chip_smoke.py --cards 4    # the build, then the NCCL launch

Runs from the root of a checkout, imports nothing of JAX, and exits
non-zero at the first failure:

  0. device: needs CUDA; prints the card's name and power limit;
  1. build: compiles every kernel of go_with_the_flows_tpu_torch/csrc;
     ptxas registers and spills of kernel 1 (`point_decode_kernel`, all
     48 instantiations: 8 widths, 2 directions, 3 precision modes),
     kernel 2 (`nn_distance_kernel` and its chunk fold), kernel 3
     (`cd_stats_kernel`), kernel 6 (`emd_backward_kernel` and its chunk
     sum), kernel 7's hidden and update passes, kernel 8's
     B1/B2 and the EMD forward; all but kernel 8's must not spill, and
     kernels 1, 2, 3 and 6 keep no stack frame; kernels 7 and 8 by
     precision mode ('highest', 'high' and 'fast', each pass at FP
     8-64): the hidden and update passes spill in no mode, B1 and B2 at
     most 128 registers with no spill in every mode; their SASS
     (`cuobjdump -sass`): kernel 7's hidden and update passes and kernel
     8's head, B1 and B2 at 'high' and 'fast' hold HMMA instructions at
     every FP (their W1 products on the tensor cores), no 'highest'
     function of kernels 7 and 8 does; kernel 1 at 'high' and 'fast' holds
     HMMA at every FP in both directions (its three products on the
     tensor cores), none of its 'highest' instantiations does;
  2. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (jiggled BatchNorm statistics), with times, kernel 1
     in each matmul precision mode against the plain version of that
     mode (ops/precision.py: 'highest', 'high', 'fast'), and the
     mode in force (its effect on the output as the plain version's,
     check_mode_in_force); kernels 7 and 8 also at 'fast' and at 'high'
     against the plain versions of their mode (check_train_decode_mode:
     9 narrow couplings, a ragged N, a small batch and the flagship
     shape, timed beside 'highest' in one window, the mode in force on p0
     and dW1; the bf16 torch.bmm times of kernel 8's W1 and dW1 products
     and its cache traffic at the HBM rate as yardsticks); the EMD
     kernels also at ragged and unequal sizes and at the SVR protocol's
     2500 points, the EMD backward through autograd, and the EMD grid
     against the paired EMD kernel bit for bit;
  3. slice: the flagship airplane model (random weights from seed 0) on
     the card, `evaluate` in generating and autoencoding modes with CD,
     EMD and F1 over two seeded batches of 64 reference clouds of 2048
     points, then the EMD between the samples and their references as a
     differentiable loss, with all six kernel launch counters read around
     them; a small-input check against the CPU path; sample+CD clouds/s
     at B=64 and B=1024 for the kernel path and the plain path, and at
     B=1024 with the sample step built under each precision mode, in
     turns, beside kernel 1 alone in each mode;
  4. train: the flagship model's training step (make_train_step) at
     B=64: one step from one state through the train-decode kernels and
     through the decoder's modules (the plain path), compared; twenty
     kernel-path steps on seeded clouds with the two train-decode launch
     counters read around them; ms/step, clouds/s and peak memory of both
     paths; a torch.profiler pass over one warm kernel-path step; then
     at 'fast' and at 'high': one step kernels against modules (the loss
     and the gradient in norm: not one function outside 'highest'),
     twenty kernel-path steps built under the mode whose losses fall,
     their launches counted by mode, and their ms/step; kernel 8 by pass
     in each mode in one window (profiled calls in turns);
  5. loop: the flagship model through the train-and-validate path at
     B=64 on seeded in-memory clouds served by the port's DataLoader:
     `train` for one epoch of 4 steps (kernels 7 and 8) with its
     checkpoint, `evaluate_val` over 2 batches (kernel 1's inverse, the
     best-model checkpoint) and `reconstruct` over 2 batches (kernel 1
     direct), with the three kernels' launch counters read around them;
     then the eval loss of one batch through kernel 1 against the loss
     through the decoder's modules (a tolerance from the decode's own
     error), the checkpoint restored into a fresh model, optimizer and
     generator (bit-equal, and one more step from each bit-equal), the
     reconstructions equal to a freshly built sample step's with no
     buffer moved and the model's modes restored; the loop's ms/step
     beside phase 4's bare step, the eval step's ms/batch through the
     kernel and through the modules, the checkpoint's size and its save
     and load seconds, and the pack_decoder cache's costs;
  6. svr: configs/config_SVR.yaml's model (FlowMixtureSVRModel: K=4, 11
     flows of f=33, freevar, g=512, a ResNet-18 on 224 x 224 images) at
     B=128, N=2500 on seeded ellipsoid clouds and noise images served by
     the DataLoader: kernels 1 (in each precision mode), 2, 7 and 8
     against their plain versions at those shapes and kernel 5 on 8 of
     the 128 pairs, timed with their bounds; one train step through the
     kernels against one through the decoder's modules (at the largest
     batch that fits);
     `train` for 4 steps, `evaluate_val` over 2 batches and
     reconstruction-mode `evaluate` (CD, EMD, F1) over 2 batches, with
     the five kernels' launch counters read around them; the meters
     against the kernels' per-batch values and, on the first batch, the
     plain versions; the samples against the plain decode; the eval loss
     through kernel 1 against the modules; the loop's and bare steps'
     ms/step in turns, peak memory, and a profiled step's busy time, the
     ResNet's share of it and kernels 7 and 8; kernels 7 and 8 at 'fast'
     and 'high' at the SVR shapes and two SVR train steps built under
     each, and one more profiled (the card's busy time);
  7. cli: the four command-line entry points' `run` functions (cli/
     train_ae, evaluate_ae, reconstruct_ae, train_svr), their arguments
     parsed as scripts/*.sh give them, on in-memory ShapeNet layouts
     (data/synthetic.py: jittered closed ellipsoids of 5,120 faces, and
     for SVR 24 noise RGBA views of 137 x 137 a shape) read by the
     port's datasets, which sample each batch's clouds from the meshes:
     the flagship config (config_generative_modeling_airplane.yaml, read
     by the port's YAML reader) through train_ae for one epoch (4 steps,
     checkpoint, validation), evaluate_ae generating (CD, EMD, JSD, 2
     reps) and autoencoding (CD, EMD, F1) on its checkpoint, the same
     autoencoding with `eval_matmul_precision: fast` in its config
     (kernel 1's 'fast' instantiation only), and
     reconstruct_ae's dump; config_SVR.yaml through train_svr for one
     epoch (4 steps at B=128) and evaluate_ae reconstruction (CD, EMD,
     F1) over 2 batches; evaluate_ae interpolation on the flagship's
     checkpoint (3 train batches of 64 shape pairs x 9 steps, the arrays
     returned: kernel 1 launched exactly 27 times; the t=0 and t=1 codes
     and their decodes bit-equal to the endpoints', every step of the
     first batch within 1e-4 of the plain decode, labels in 1..K); and
     both trained models written as the reference's .pkl, imported by
     cli/import_torch_ckpt and evaluated again (the flagship in
     autoencoding, SVR in reconstruction mode): the metrics equal the
     original models' bit for bit. Each stage's kernel launches are read
     around it; the restored models are bit-equal to the trained ones,
     every metric is finite and the JSD in [0, 1], and sampled clouds
     lie on their meshes. It prints the loader's ms/batch by part, the CLI
     loop's ms/step beside phases 5's and 6's, whether the loader keeps
     up with the step, and each evaluation's wall time. train_ae and
     train_svr run with `logging` and `logging_img` (train_svr's figures
     after its 4th step): their TensorBoard event files, read back, hold
     reconstruction/0..3 at epoch 0 and svr_reconstruction/0..3 at step
     4, each a PNG of 256 x 512 (x 768 with the image) pixels painted in
     every panel (viz/tb.py), kernel 1 launched once more in each for the
     figures' batch;
  8. dist: data-parallel training of the flagship model on 2 ranks,
     spawned processes in a gloo process group sharing this one card
     (NCCL refuses two ranks on a card), at a global B=64 (32 a rank):
     (a) kernels 7 and 8 in their SPMD form against the one-process
     kernels and the plain versions on the whole batch; (b) 3 train
     steps against 3 one-process steps from the same weights and noise
     (the losses, the reduced gradient before the first update, the
     running statistics, the parameters within a bound in lr), the
     ranks' parameters bit-equal, and the 2-rank step's ms and
     collectives (no scaling figure: the ranks share the card); (c) a
     rank-0 checkpoint restored on both ranks; (d) cli/train_ae's run
     over the 2 loader shards of phase 7's in-memory layout, then
     reconstruct gathered and equal on both ranks; then SVR at
     config_SVR.yaml's width and a global B=128 (64 a rank, 224 x 224
     images): (e) one step against one process (the loss within 1e-5
     relative, the ResNet's and the decoder's running statistics within
     atol 1e-5 + rtol 1e-5: the ResNet's BatchNorms over the global
     batch), 2 timed steps with their collectives; (f) cli/train_svr's
     run for one epoch over the 2 loader shards of phase 7's in-memory
     ShapeNetAll layout, the ranks' models equal at its end; (g) at
     'fast' and (h) at 'high', kernels 7 and 8 in their SPMD form and one
     step against one process. The ranks'
     launches add to the kernels line, each kernel's as many as the
     steps and batches give, every launch of kernels 7 and 8 in its SPMD
     form; (i) the points axis: 2 ranks as a (data, points) = (1, 2)
     grid, each the whole batch with half of every cloud's points, one
     module-path flagship step at B=64, N=2048 against one process (the
     loss rtol 1e-4, the flat gradient before the update within 1e-4 of
     its largest entry, the running statistics rtol 1e-5 + atol 1e-6),
     the fused path refused there with the JAX step's message, and the
     step's ms beside the same step in one process and (b)'s;
  9. precision: the flagship's sample step, generating and autoencoding,
     built under each matmul precision mode and called under 'highest':
     kernel 1 launched in the step's mode once a call, no plain decode
     on a CUDA tensor, the paired and pairwise metrics (kernels 2-5) bit
     for bit the same in every mode, each mode's sample-step time and
     drift from 'highest'; config_SVR.yaml's model reconstructing 8
     images under 'high' (the ResNet's convolutions as three bf16
     passes); tools/eval_precision_ab.run at 20 steps (which train at
     'high', kernels 7 and 8), B=64, S=64, one rep, its table printed;
     tools/train_quality_ab.run at 20 steps, B=16, S=16, one rep through
     its three variants (the modules at 'highest', kernels 7 and 8 at
     'high' and at 'fast', each trained and scored at 'high');
     tools/train_convergence_ab.run at 20 steps, B=32 (its three
     variants, kernels 7 and 8 once a step in the fused ones) and
     tools/svr_quality_ab.run at 20 steps (kernels 7 and 8 at 'highest'
     and 'fast', kernel 1 at 'high', kernels 2 and 5 scoring), every loss
     and metric finite;
 10. tools: tools/protocol_bench.run at the airplane protocol's size (405
     generated against 405 reference clouds of 2048 points, CD, F1 and
     EMD: the CD and EMD matrices, a cold and a warm protocol), its line
     printed, an 8 x 8 corner of its CD and EMD matrices against the
     plain versions at phase 2's tolerances; tools/train_breakdown.run at
     B=64 in 'highest', 'high' and 'fast' (the training forward, the
     gradient, the eval step and the train step, each on the host's clock
     and as the card's busy time), its three lines printed, every value
     finite and positive; kernels 1, 3, 4, 7 and 8 counted around each.

With `--cards N` it runs only phases 0 and 1 and then cli/train_ae's
data-parallel launch on N cards of the host (cli.run_ranks, one rank a
card, NCCL between them): one epoch of the flagship config on phase 7's
in-memory layout, then reconstruct gathered; the models, validation
means and reconstructions must be equal on every rank and every launch
of kernels 7 and 8 in SPMD form. It ends with the status line alone.

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

Its last two lines are a JSON object with one entry per kernel, kernel 1
once a precision mode and kernels 7 and 8 once a mode too
(train_decode_*_high and _fast: their launches those of the steps built
in that mode, phases 4, 6, 8 and 9; each time
beside `bound_ms`, the least time the card could take for the same work
at the published peaks, from the operations and bytes that the timed
call's shapes need) and the JSON status line {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 2048
BATCH = 64
MODES = ("highest", "high", "fast")  # ops/precision.py
# kernel 1 against the plain version of its mode, on decoder weights
# moved off their init: atol by mode, a few times the largest gaps
# measured at the flagship shapes (1.2e-6 'highest', 3.3e-6 'high',
# 1.2e-3 'fast'). At 'fast' a bf16 rounding of h can land the other way
# when the fp32 sums run in another order, which moves that point by a
# bf16 step and, down the chain, by up to a share of what the mode moves
# it: no more than FAST_OFF_SHARE of the elements may be off by more
# than 1e-4 (measured 2.4e-4).
DECODE_ATOL = {"highest": 1e-4, "high": 1e-5, "fast": 5e-3}
FAST_OFF_SHARE = 2e-3
# the mode in force: the kernel's effect of its mode (its output less its
# 'highest' output) within MODE_EFFECT_GAP of the plain version's effect,
# in rms over the effect's rms (measured at most 0.33 'high', 5e-3
# 'fast'; a kernel computing fp32, or dropping a term, is 1 or more
# away). A largest gap is no such test: two sum orders can round lo(h)
# ('high') or h ('fast') a bf16 step apart, which moves a few points as
# far as the mode moves them.
MODE_EFFECT_GAP = {"high": 0.5, "fast": 0.05}
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
# the tensor cores' dense bf16 rate: the products of 'high' and 'fast'
BF16_FLOPS = 989e12
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


def bound(flop: float = 0.0, sfu: float = 0.0, nbytes: float = 0.0,
          peak: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations' time and the
    bytes' time at the HBM rate. The operations' time: the work `flop` at
    `peak` (FP32 by default, BF16_FLOPS for bf16 products), the
    special-function operations split between their units and the FP32
    pipe (SFU_AS_FLOP each there) so that both finish soonest."""
    ops_s = max(flop / peak,
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


def reference_clouds(rng, n: int, n_points: int = N_POINTS):
    """Seeded clouds on random ellipsoid surfaces, (n, 3, n_points)."""
    import numpy as np

    dirs = rng.standard_normal((n, 3, n_points))
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
    # kernel 1 by precision mode: <FP, INVERSE, MODE>, MODE 0 'highest',
    # 1 'high', 2 'fast'
    by_mode = {}
    for name, regs, _, _ in report:
        m = re.search(r"point_decode_kernelILi(\d+)ELb([01])ELi(\d)E", name)
        if m:
            by_mode.setdefault(MODES[int(m.group(3))], []).append(
                (int(m.group(1)), regs))
    if sorted(len(v) for v in by_mode.values()) != [16, 16, 16]:
        fail(f"point_decode_kernel: instantiations by mode "
             f"{ {k: len(v) for k, v in by_mode.items()} }, 16 a mode "
             "expected")
    for mode, rows in by_mode.items():
        say(f"    ptxas point_decode_kernel {mode}: registers by FP "
            + ", ".join(f"{fp} {r}" for fp, r in sorted(set(rows))))
    check_train_decode_ptxas(report)
    check_train_decode_hmma(build.LIB_PATH)
    check_point_decode_hmma(build.LIB_PATH)


# kernels 7 and 8's passes templated on <FP, MODE>
TRAIN_DECODE_PASS_KERNELS = ("fwd_hidden", "fwd_update", "bwd_head",
                             "bwd_hidden", "bwd_dw1", "bwd_input")


def check_train_decode_ptxas(report):
    """Kernels 7 and 8 by precision mode (MODE 0 'highest', 1 'high', 2
    'fast'): each pass instantiated at the 8 widths FP 8-64 in every mode
    (the seed pass once a mode); the forward's hidden and update passes
    spill in no mode; B1 and B2 (bwd_hidden, bwd_dw1) at most 128
    registers with no spill in every mode."""
    rows, seeds = {}, set()
    for name, regs, spill, _ in report:
        m = re.search("(" + "|".join(TRAIN_DECODE_PASS_KERNELS)
                      + r")_kernelILi(\d+)ELi(\d)EE", name)
        if m:
            rows.setdefault((m.group(1), MODES[int(m.group(3))]), {})[
                int(m.group(2))] = (regs, spill)
        m = re.search(r"seed_moments_kernelILi(\d)EE", name)
        if m:
            seeds.add(MODES[int(m.group(1))])
    if seeds != set(MODES):
        fail(f"seed_moments_kernel instantiated for {sorted(seeds)}, "
             f"{MODES} expected")
    for kernel in TRAIN_DECODE_PASS_KERNELS:
        for mode in MODES:
            got = rows.get((kernel, mode), {})
            if sorted(got) != list(range(8, 72, 8)):
                fail(f"{kernel}_kernel {mode}: instantiations at FP "
                     f"{sorted(got)}, 8-64 expected")
            say(f"    ptxas {kernel}_kernel {mode}: registers (B spilled) by "
                "FP " + ", ".join(f"{fp} {r} ({s})"
                                  for fp, (r, s) in sorted(got.items())))
            if kernel in ("fwd_hidden", "fwd_update") and any(
                    s for _, s in got.values()):
                fail(f"{kernel}_kernel {mode} spills registers")
            if kernel in ("bwd_hidden", "bwd_dw1") and (
                    max(r for r, _ in got.values()) > 128
                    or any(s for _, s in got.values())):
                fail(f"{kernel}_kernel {mode}: above 128 registers or "
                     "spilling")


# kernels 7 and 8's passes whose W1 products are on the tensor cores at
# 'high' and 'fast' (csrc/mma_bf16.cuh): kernel 7's hidden pass and its
# update pass, which replays h2, and kernel 8's head, B1 and B2
TENSOR_CORE_PASSES = ("fwd_hidden_kernel", "fwd_update_kernel",
                      "bwd_head_kernel", "bwd_hidden_kernel",
                      "bwd_dw1_kernel")


def check_train_decode_hmma(lib_path):
    """The SASS (`cuobjdump -sass`) of kernels 7 and 8: their
    TENSOR_CORE_PASSES at 'high' and 'fast' (MODE 1, 2) hold HMMA
    instructions at every FP 8-64, and no 'highest' (MODE 0) function of
    the two kernels holds one."""
    from go_with_the_flows_tpu_torch.tools.train_decode_ab import (
        kernel_key, sass_functions)

    hmma = {}
    for name, lines in sass_functions(lib_path).items():
        key = kernel_key(name)
        if key is not None:
            hmma[key] = sum(1 for line in lines if "HMMA" in line)
    if not hmma:
        fail("cuobjdump -sass shows no function of kernels 7 and 8")
    for kernel in TENSOR_CORE_PASSES:
        for mode in (1, 2):
            got = {fp: n for (k, fp, m), n in hmma.items()
                   if k == kernel and m == mode}
            say(f"    SASS {kernel} {MODES[mode]}: HMMA by FP "
                + ", ".join(f"{fp} {n}" for fp, n in sorted(got.items())))
            if sorted(got) != list(range(8, 72, 8)) or min(got.values()) < 1:
                fail(f"{kernel} {MODES[mode]}: not every FP 8-64 holds "
                     "HMMA instructions")
    highest = sorted(f"{k}<{fp}>" for (k, fp, m), n in hmma.items()
                     if m == 0 and n)
    say(f"    SASS: {sum(1 for k in hmma if k[2] == 0)} 'highest' functions "
        f"of kernels 7 and 8, {len(highest)} with HMMA")
    if highest:
        fail(f"'highest' functions hold HMMA instructions: {highest}")


def check_point_decode_hmma(lib_path):
    """The SASS of kernel 1 (`point_decode_kernel<FP, INVERSE, MODE>`):
    at 'high' and 'fast' (MODE 1, 2) every FP 8-64 in both directions
    holds HMMA instructions (its three products on the tensor cores), and
    no 'highest' (MODE 0) instantiation holds one."""
    from go_with_the_flows_tpu_torch.tools.train_decode_ab import (
        sass_functions)

    hmma = {}
    for name, lines in sass_functions(lib_path).items():
        m = re.search(r"point_decode_kernelILi(\d+)ELb([01])ELi(\d)E", name)
        if m:
            hmma[int(m.group(3)), int(m.group(1)), int(m.group(2))] = sum(
                1 for line in lines if "HMMA" in line)
    for mode in (1, 2):
        for inverse in (0, 1):
            got = {fp: n for (m, fp, i), n in hmma.items()
                   if m == mode and i == inverse}
            say(f"    SASS point_decode_kernel {MODES[mode]} "
                f"{'inverse' if inverse else 'direct'}: HMMA by FP "
                + ", ".join(f"{fp} {n}" for fp, n in sorted(got.items())))
            if sorted(got) != list(range(8, 72, 8)) or min(got.values()) < 1:
                fail(f"point_decode_kernel {MODES[mode]}: not every FP 8-64 "
                     "holds HMMA instructions")
    highest = sorted(f"<{fp}, {i}>" for (m, fp, i), n in hmma.items()
                     if m == 0 and n)
    say(f"    SASS point_decode_kernel: "
        f"{sum(1 for k in hmma if k[0] == 0)} 'highest' instantiations, "
        f"{len(highest)} with HMMA")
    if highest or sum(1 for k in hmma if k[0] == 0) != 16:
        fail(f"point_decode_kernel 'highest': 16 instantiations without "
             f"HMMA expected; with HMMA: {highest}")


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


def mode_effect_gap(got, got_highest, want, want_highest) -> float:
    """rms of the gap between two effects of a precision mode, the
    kernel's (got less got_highest) and the plain version's (want less
    want_highest), over the rms of the latter."""
    effect = want - want_highest
    return ((got - got_highest - effect).square().mean()
            / effect.square().mean()).sqrt().item()


def check_point_decode(config, B, N, seed, timed, modes=("highest",)):
    """Kernel 1 at 'highest' and in each other precision mode of `modes`,
    both directions, against the plain version of that mode: DECODE_ATOL,
    at 'fast' also FAST_OFF_SHARE; away from 'highest' the mode in force
    (MODE_EFFECT_GAP); two launches bit-equal. Returns ({mode: max |diff|}, times): times
    holds "dims" and, when `timed`, (mode, direction) -> (kernel ms,
    plain ms), each the mean of one window of launches."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode, point_decode_plain)
    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)

    model = make_model(config, seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the decoder's weights off their init, as the emulated test moves
    # them: at init the chain is near identity and the modes' effects
    # barely clear the fp32 rounding
    with torch.no_grad():
        for q in model.pc_decoder.parameters():
            q.add_(0.05 * torch.randn(q.shape, device="cuda", generator=gen))
    packed = model.pack_decoder()
    K = model.n_components
    g = torch.randn(B, model.g_latent_space_size, device="cuda",
                    generator=gen)
    ab = film_alpha_beta(packed, g).contiguous()
    p = 0.3 * torch.randn(K, B, 3, N, device="cuda", generator=gen)
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    errs, times = {}, {"dims": (K, B, N, C, f)}
    highest = {}  # direction -> (kernel, plain) at 'highest'
    for mode in ("highest",) + tuple(m for m in modes if m != "highest"):
        atol = DECODE_ATOL[mode]
        errs[mode] = []
        for inverse in (False, True):
            name = "inverse" if inverse else "direct"
            tag = (f"point_decode {mode} {name} K={K} B={B} N={N} C={C} "
                   f"f={f}")
            with matmul_precision_scope(mode):
                got = point_decode(packed, ab, p, inverse)
                want = point_decode_plain(packed, ab, p, inverse)
                again = point_decode(packed, ab, p, inverse)
            torch.cuda.synchronize()
            for what, a, b in zip(("points", "logvar"), got, want):
                errs[mode].append(check_close(f"{tag} {what}", a, b, atol))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{tag}: two launches differ")
            if mode == "highest":
                highest[inverse] = (got, want)
            else:
                check_mode_in_force(tag, mode, got, want, *highest[inverse])
            if timed:
                with matmul_precision_scope(mode):
                    ms = cuda_ms(
                        lambda: point_decode(packed, ab, p, inverse), 10)
                    plain = cuda_ms(lambda: point_decode_plain(
                        packed, ab, p, inverse), 3)
                times[mode, name] = (ms, plain)
                say(f"    {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms")
    if timed:
        w1 = w1_bmm_ms(K, B * N, f, C)
        say(f"    point_decode K={K} B={B} N={N} C={C} f={f}: its W1 "
            f"products alone as torch.bmm of (2K, f, f) W1 and (2K, f, BN) "
            f"h0, fp32 highest: {w1:.3f} ms for all {C} couplings")
        if len(modes) > 1:
            w1 = w1_bmm_ms(K, B * N, f, C, torch.bfloat16)
            times["bf16_bmm"] = w1
            say(f"    point_decode K={K} B={B} N={N} C={C} f={f}: its W1 "
                f"products as bf16 torch.bmm: {w1:.3f} ms at 'fast' (one "
                f"pass), {3 * w1:.3f} ms at 'high' (three)")
    return {m: max(e) for m, e in errs.items()}, times


def check_mode_in_force(tag, mode, got, want, got_highest, want_highest):
    """Kernel 1's outputs `got` in `mode` against the plain version's
    `want`, each beside its 'highest' outputs on the same inputs: the
    effect of the mode within MODE_EFFECT_GAP, and at 'fast' at most
    FAST_OFF_SHARE of the elements off by more than 1e-4."""
    for what, a, b, ah, bh in zip(("points", "logvar"), got, want,
                                  got_highest, want_highest):
        gap = mode_effect_gap(a, ah, b, bh)
        line = (f"    {tag} {what}: the mode's effect within {gap:.3g} of "
                f"the plain version's in rms ({MODE_EFFECT_GAP[mode]:g})")
        off = ((a - b).abs() > 1e-4).float().mean().item()
        if mode == "fast":
            line += (f"; share off by more than 1e-4 {off:.3g} "
                     f"({FAST_OFF_SHARE:g})")
        say(line)
        if not gap <= MODE_EFFECT_GAP[mode]:
            fail(f"{tag} {what}: the kernel's effect of '{mode}' is "
                 f"{gap:.3g} away from the plain version's in rms, above "
                 f"{MODE_EFFECT_GAP[mode]:g}: the mode is not in force")
        if mode == "fast" and off > FAST_OFF_SHARE:
            fail(f"{tag} {what}: {off:.3g} of the elements off by more "
                 f"than 1e-4, above {FAST_OFF_SHARE:g}")


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


# kernels 7 and 8 at 'high' and 'fast' against the plain versions of their
# mode. At 'fast' two sum orders can put an operand on either side of a
# bf16 rounding boundary, where it moves a bf16 step (0.4 %), and 33
# train-mode couplings carry that on and widen it (on an H100 at 700 W:
# p0 off by at most 8.6e-3 and 1.1e-3 in norm at 33 couplings, 6e-7 at 9
# narrow ones); so p0, the logvar sum and the saved states are held by
# their largest difference (`atol`) and in norm (relative, `norm`), the
# batch statistics by atol + rtol (`stats`), the backward, on kernel 7's
# residuals, in norm (`dp_norm`) and by each gradient's largest entry
# (`grad`; read at most 1.4e-3 and 4.6e-3), and the mode in force by its
# effect within `gap` at the 33-coupling shapes (read 0.067-0.284; a
# kernel that left out every rounding would be near 1) and
# MODE_EFFECT_GAP's at the 9-coupling one (read 1.9e-4). At 'high' a
# step across a boundary moves an operand's hi by a bf16 step and its lo
# back by as much, about 2^-16 of it in all (read at 33 couplings: p0 off
# by at most 3.4e-5 and 7.7e-6 in norm, the statistics by 1.2e-7, dp
# 2.8e-4 in norm, the gradients at most 1.0e-2 of their largest entries);
# the mode's effect is of that size too (p0 about 9e-6 in norm), so at 33
# couplings the chain's own fp32 noise takes a share of it (read gaps
# 0.32-0.39 on p0, 0.16-0.61 on dW1; a kernel without the mode reads 1),
# and at 9 couplings MODE_EFFECT_GAP's 0.5 holds it (read 0.098, 0.022)
TRAIN_MODE_BOUNDS = {
    "fast": dict(atol=5e-2, norm=1e-2, stats=(1e-4, 1e-3), dp_norm=1e-2,
                 grad=3e-2, gap=0.5),
    "high": dict(atol=2e-4, norm=3e-5, stats=(1e-6, 1e-5), dp_norm=1e-3,
                 grad=3e-2, gap=0.9),
}


def rel_norm(a, b) -> float:
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-30)).item()


def check_train_decode_mode(config, B, N, seed, timed, mode,
                            gap_bound=None):
    """Kernels 7 and 8 in `mode` ('high' or 'fast') against the plain
    versions of that mode, with TRAIN_MODE_BOUNDS[mode]: p0, the logvar
    sum and the saved states (atol, norm), the batch statistics (atol +
    rtol); kernel 8 and its plain version on kernel 7's residuals of the
    mode: dp in norm, every packed array's and ab's gradient by its own
    largest entry; the mode in force (`gap_bound`, the mode's `gap` for
    None) on p0 and dW1, each version against its own 'highest' on its
    own residuals; two launches of each bit-equal. Prints every measure
    before it fails on one. Returns (fwd max |diff|, bwd max |diff|,
    times), times (kernel ms, plain ms) by wrapper name and mode
    ('highest' and `mode`, timed in one window) when `timed`."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_bwd_plain, train_decode_fwd,
        train_decode_fwd_plain)

    lim = TRAIN_MODE_BOUNDS[mode]
    gap_bound = lim["gap"] if gap_bound is None else gap_bound
    packed, ab, p = train_decode_inputs(config, B, N, seed)
    K, C, _, f = packed["w1"].shape[:4]
    tag = f"train_decode {mode} K={K} B={B} N={N} C={C} f={f}"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dp0 = torch.randn(p.shape, device="cuda", generator=gen)
    dlv = torch.randn(p.shape, device="cuda", generator=gen)
    bad = []
    # the mode's effect: each version at both modes on its own residuals
    eff = {}
    for m in ("highest", mode):
        got = train_decode_fwd(packed, ab, p, m)
        want = train_decode_fwd_plain(packed, ab, p, m)
        eff[m] = (got[0], want[0],
                  train_decode_bwd(packed, ab, *got[2:], dp0, dlv,
                                   m)[1]["w1"],
                  train_decode_bwd_plain(packed, ab, *want[2:], dp0, dlv,
                                         m)[1]["w1"])
    for i, what in ((0, "p0"), (2, "dW1")):
        gap = mode_effect_gap(eff[mode][i], eff["highest"][i],
                              eff[mode][i + 1], eff["highest"][i + 1])
        effect = rel_norm(eff[mode][i + 1], eff["highest"][i + 1])
        say(f"    {tag} {what}: the mode's effect ({effect:.3g} in norm) "
            f"within {gap:.3g} of the plain version's in rms "
            f"({gap_bound:g})")
        if not gap <= gap_bound:
            bad.append(f"the kernel's effect of '{mode}' on {what} is "
                       f"{gap:.3g} away from the plain version's")
    del eff
    errs = []
    for what, a, b in zip(("p0", "logvar", "saved states"), got, want):
        err = (a - b).abs().max().item()
        norm = rel_norm(a, b)
        off = ((a - b).abs() > 1e-4).float().mean().item()
        say(f"    {tag} {what}: max |diff| {err:.3g} ({lim['atol']:g}), "
            f"in norm {norm:.3g} ({lim['norm']:g}), share beyond 1e-4 "
            f"{off:.3g}")
        if err > lim["atol"] or norm > lim["norm"]:
            bad.append(f"{what} disagrees with the plain version")
        errs.append(err)
    s_atol, s_rtol = lim["stats"]
    st = ((got[3] - want[3]).abs() / (s_atol + s_rtol * want[3].abs())).max()
    say(f"    {tag} batch stats: max |diff| "
        f"{(got[3] - want[3]).abs().max().item():.3g}, {st.item():.3g} of "
        f"the allowance atol {s_atol:g} + rtol {s_rtol:g}")
    if st.item() > 1.0:
        bad.append("the batch statistics disagree with the plain version")

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()

    _, _, xsave, stats = got
    kb = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv, mode)
    pb = train_decode_bwd_plain(packed, ab, xsave, stats, dp0, dlv, mode)
    pairs = [(f"d{k}", kb[1][k], v) for k, v in pb[1].items()] + [
        ("dab", kb[2], pb[2])]
    dp_norm = rel_norm(kb[0], pb[0])
    bwd_err = max((a - b).abs().max().item() for _, a, b in
                  [("dp", kb[0], pb[0])] + pairs)
    say(f"    {tag} backward on kernel 7's residuals, |diff| / max |plain|: "
        f"dp {rel(kb[0], pb[0]):.2g}"
        + "".join(f", {n} {rel(a, b):.2g}" for n, a, b in pairs)
        + f" ({lim['grad']:g}); dp in norm {dp_norm:.2g} "
        f"({lim['dp_norm']:g}); max |diff| {bwd_err:.3g}")
    if dp_norm > lim["dp_norm"]:
        bad.append(f"backward dp {dp_norm:.3g} in norm")
    for name, a, b in pairs:
        if not rel(a, b) <= lim["grad"]:
            bad.append(f"backward {name}: {rel(a, b):.3g} of its largest "
                       "entry")
    if not all(torch.equal(a, b) for a, b in
               zip(got, train_decode_fwd(packed, ab, p, mode))):
        bad.append("two forward launches differ")
    again = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv, mode)
    if not (torch.equal(kb[0], again[0]) and torch.equal(kb[2], again[2])
            and all(torch.equal(kb[1][k], again[1][k]) for k in kb[1])):
        bad.append("two backward launches differ")
    del again, want, pb
    if bad:
        fail(f"{tag}: " + "; ".join(bad))
    times = None
    if timed:
        times = {}
        for m in ("highest", mode):
            times[f"train_decode_fwd_{m}"] = (
                cuda_ms(lambda: train_decode_fwd(packed, ab, p, m), 5),
                cuda_ms(lambda: train_decode_fwd_plain(packed, ab, p, m),
                        2))
        for m in ("highest", mode):
            times[f"train_decode_bwd_{m}"] = (
                cuda_ms(lambda: train_decode_bwd(packed, ab, xsave, stats,
                                                 dp0, dlv, m), 3),
                cuda_ms(lambda: train_decode_bwd_plain(
                    packed, ab, xsave, stats, dp0, dlv, m), 1))
        say(f"    {tag}: " + "; ".join(
            f"{name} kernel {ms:.3f} ms, plain {plain:.3f} ms"
            for name, (ms, plain) in times.items())
            + f" (the backward on the '{mode}' forward's residuals in both "
            "modes, timed in the same window)")
    return max(errs), bwd_err, times


def w1_bmm_ms(K, n, f, C, dtype=None):
    """C times one torch.bmm of one coupling's hidden W1 product, (2K, f,
    f) by (2K, f, n) (random values), at fp32 'highest' (or in `dtype`,
    torch.bfloat16 for the 'high' and 'fast' rows): the library yardstick
    of kernel 1 and of kernel 7's hidden pass (their W1 products alone,
    without the FiLM, the BatchNorms, the cache and the sums), and of
    kernel 8's head and B1 (one W1 product each), which the port never
    calls."""
    import torch

    if torch.get_float32_matmul_precision() != "highest":
        fail("the fp32 matmul precision is not 'highest'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = dtype or torch.float32
    w1 = torch.randn(2 * K, f, f, device="cuda", generator=gen).to(dt)
    a = torch.randn(2 * K, f, n, device="cuda", generator=gen).to(dt)
    return C * cuda_ms(lambda: torch.bmm(w1, a), 10)


def dw1_bmm_ms(K, n, f, C, dtype=None):
    """C times one torch.bmm of one coupling's dW1 operands, (2K, f, n) and
    (2K, n, f) (random values: the time does not depend on them), at fp32
    'highest' (or in `dtype`): the library yardstick of kernel 8's dW1
    pass, which the port never calls."""
    import torch

    if torch.get_float32_matmul_precision() != "highest":
        fail("the fp32 matmul precision is not 'highest'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = dtype or torch.float32
    dh2 = torch.randn(2 * K, f, n, device="cuda", generator=gen).to(dt)
    a = torch.randn(2 * K, n, f, device="cuda", generator=gen).to(dt)
    return C * cuda_ms(lambda: torch.bmm(dh2, a), 10)


# kernel 8's cache traffic by pass, floats a point and coupling, as f's
# linear coefficients: the head writes n1, dn1 (2f each) and the scale
# (3) and reads xsave, dp and dlv (3 each); B1 reads n1, dn1 and xsave,
# writes dn0 (2f); B2 reads n1, dn1 and xsave; the input pass reads dn0,
# xsave, the scale and dp and writes dp
KERNEL8_CACHE_FLOATS = {"head": (4, 12), "B1": (6, 3), "B2": (4, 3),
                        "input": (2, 12)}
# kernel 7's by mode, as KERNEL8_CACHE_FLOATS: at 'highest' the h2 cache,
# written by the hidden pass and read by the update pass (2f each), and
# the state: the hidden pass reads x and writes xsave, the update pass
# reads and writes x and the logvar sum (3 each); at 'high' and 'fast'
# the update pass recomputes h2 and the state is all
KERNEL7_CACHE_FLOATS = {
    "highest": {"h2 cache": (4, 0), "state": (0, 18)},
    "high": {"state": (0, 18)},
    "fast": {"state": (0, 18)},
}


def cache_floor_ms(K, B, N, C, f, floats=None):
    """{pass: ms} the port's own cache traffic of kernel 8 (or the
    `floats` of another, KERNEL7_CACHE_FLOATS[mode]) takes at the HBM
    rate over C couplings of K B N points (each byte once), and "all":
    the floor of a kernel that keeps its caches, which the TPU kernel
    holds in VMEM (csrc/train_decode.cuh's header)."""
    out = {name: 1e3 * 4.0 * (a * f + b) * K * B * N * C / HBM_BYTES
           for name, (a, b) in (floats or KERNEL8_CACHE_FLOATS).items()}
    out["all"] = sum(out.values())
    return out


def bf16_bmm_yardsticks(config, B, N):
    """Prints the bf16 torch.bmm times of kernel 8's products at 'fast'
    and 'high' for `config`'s decoder over its C couplings, B clouds of N
    points: the W1 product (the head's h2 = W1 a and B1's da = W1^T dh2
    have its shape), the dW1 product, and their sum for the three passes
    (one bmm each at 'fast', three at 'high', which bf16 operands of hi
    and lo parts would take), and kernel 7's W1 product (once at 'fast',
    three times at 'high'); also kernels 7 and 8's cache floors
    (`cache_floor_ms`); returns the yardsticks in ms."""
    import torch

    packed, _, _ = train_decode_inputs(config, 1, 8, 0)
    K, C, _, f = packed["w1"].shape[:4]
    n = B * N
    tag = f"train_decode K={K} B={B} N={N} C={C} f={f}"
    w1 = w1_bmm_ms(K, n, f, C, torch.bfloat16)
    dw1 = dw1_bmm_ms(K, n, f, C, torch.bfloat16)
    say(f"    {tag}: bf16 torch.bmm yardsticks over {C} couplings: W1 "
        f"product {w1:.3f} ms, dW1 product {dw1:.3f} ms; kernel 8's three "
        f"(head, B1, B2) {2 * w1 + dw1:.3f} ms at 'fast', "
        f"{3 * (2 * w1 + dw1):.3f} ms at 'high'")
    say(f"    {tag}: kernel 7's W1 product (the hidden pass's, which the "
        f"update pass replays at 'high' and 'fast') as bf16 torch.bmm: "
        f"{w1:.3f} ms at 'fast', {3 * w1:.3f} ms at 'high'")
    floor = cache_floor_ms(K, B, N, C, f)
    say(f"    {tag}: kernel 8's cache traffic at {HBM_BYTES / 1e12:g} TB/s "
        "(its floor while it keeps its caches): " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in floor.items()))
    for m in MODES:
        floor = cache_floor_ms(K, B, N, C, f, KERNEL7_CACHE_FLOATS[m])
        say(f"    {tag}: kernel 7's h2 cache and state traffic at '{m}': "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in floor.items()))
    return {"w1": w1, "dw1": dw1, "fast": 2 * w1 + dw1,
            "high": 3 * (2 * w1 + dw1), "fwd_fast": w1, "fwd_high": 3 * w1}


def path_bounds(K, B, N, C, f):
    """Bounds of the decodes (K components, B clouds of N points, C
    couplings of width f), the paired Chamfer and the paired EMD (B pairs
    of N points): the least time of each call, from the operations per
    point, pair or pair element as the kernels' sources count them (an
    FMA is 2 FLOP; an exp and a root or rsqrt one special-function
    operation each)."""
    fwd_flop = 4 * f * f + 24 * f  # 2 heads x (W0, W1, W2 products)
    pairs = B * N * N
    return {
        "point_decode": bound(**decode_work(K, B, N, C, f, fwd_flop, 24)),
        # the same products as bf16 passes at the tensor cores' rate:
        # one at 'fast', three at 'high'
        "point_decode_fast": bound(
            **decode_work(K, B, N, C, f, fwd_flop, 24), peak=BF16_FLOPS),
        "point_decode_high": bound(
            **decode_work(K, B, N, C, f, 3 * fwd_flop, 24), peak=BF16_FLOPS),
        # the Chamfer kernels need each point pair's distance once, 3
        # differences, 3 squares and 2 sums (8 FLOP), and its two minima,
        # the row's and the column's (2), as the TPU's CD grid takes both
        # from one distance tile (pairwise_kernel.py:90-97)
        "nn_distance": bound(flop=pairs * CD_FLOP, nbytes=2 * B * N * 16),
        "emd_cost": bound(flop=pairs * EMD_FLOP, sfu=pairs * EMD_SFU,
                          nbytes=2 * B * N * 12),
        # kernel 7 writes xsave (12 C bytes a point)
        "train_decode_fwd": bound(**decode_work(K, B, N, C, f, fwd_flop,
                                                24 + 12 * C)),
        # kernel 8: the forward's recompute, dW2 and dfz (24 f), dW1 and
        # W1^T dh2 (8 f^2 + 12 f), the input pass (36 f); it reads xsave,
        # dp0 and dlv, writes dp
        "train_decode_bwd": bound(**decode_work(
            K, B, N, C, f, 12 * f * f + 96 * f, 24 + 12 * C)),
        # the same products as bf16 passes at the tensor cores' rate: one
        # at 'fast', three at 'high'
        "train_decode_fwd_fast": bound(**decode_work(
            K, B, N, C, f, fwd_flop, 24 + 12 * C), peak=BF16_FLOPS),
        "train_decode_bwd_fast": bound(**decode_work(
            K, B, N, C, f, 12 * f * f + 96 * f, 24 + 12 * C),
            peak=BF16_FLOPS),
        "train_decode_fwd_high": bound(**decode_work(
            K, B, N, C, f, 3 * fwd_flop, 24 + 12 * C), peak=BF16_FLOPS),
        "train_decode_bwd_high": bound(**decode_work(
            K, B, N, C, f, 3 * (12 * f * f + 96 * f), 24 + 12 * C),
            peak=BF16_FLOPS),
    }


def phase_kernels():
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    say("[2] kernels against their plain versions")
    small = dict(FLAGSHIP_AIRPLANE, n_components=2, g_latent_space_size=12,
                 g_prior_n_flows=2, p_decoder_n_flows=3,
                 p_decoder_n_features=8)
    # ragged shapes and the narrow (f=8) instantiation go through the same
    # kernels as the flagship's
    check_point_decode(small, 3, 50, 7, timed=False, modes=MODES)
    # kernels 7 and 8 at 'high' and 'fast', 9 narrow couplings: the mode's
    # effect held as kernel 1's
    for mode in ("high", "fast"):
        check_train_decode_mode(small, 3, 50, 7, timed=False, mode=mode,
                                gap_bound=MODE_EFFECT_GAP[mode])
    check_nn_distance(3, 50, 77, 8, timed=False)
    # three row chunks, the last partial, with ties in both directions
    check_nn_distance(2, 1100, 700, 20, timed=False, grid=True)
    check_pairwise(3, 5, 50, 77, 9, timed=False, thr=0.01)
    pd_errs, pd_times = check_point_decode(FLAGSHIP_AIRPLANE, BATCH,
                                           N_POINTS, 0, timed=True,
                                           modes=MODES)
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
    # 'fast', then 'high': a ragged N and a small batch, then the flagship
    # shape, timed beside 'highest' in one window
    reduced = {}
    for mode, seeds in (("fast", (20, 21, 22)), ("high", (23, 24, 25))):
        fwd_errs, bwd_errs = [], []
        for (B, N), seed in zip(((16, 2000), (2, N_POINTS)), seeds):
            fe, be, _ = check_train_decode_mode(FLAGSHIP_AIRPLANE, B, N, seed,
                                                timed=False, mode=mode)
            fwd_errs.append(fe)
            bwd_errs.append(be)
        fe, be, times = check_train_decode_mode(
            FLAGSHIP_AIRPLANE, BATCH, N_POINTS, seeds[2], timed=True,
            mode=mode)
        reduced[mode] = (max(fwd_errs + [fe]), max(bwd_errs + [be]), times)
    bf16_bmm_yardsticks(FLAGSHIP_AIRPLANE, BATCH, N_POINTS)

    B, N = BATCH, N_POINTS
    pairs = B * N * N
    bounds = path_bounds(*pd_times["dims"])
    bounds.update({
        "pairwise_cd_stats": bound(flop=S * R * N * N * CD_FLOP,
                                   nbytes=(S + R) * N * 12 + S * R * 16),
        # it reads both clouds and both residuals, writes da and db
        "emd_backward": bound(flop=pairs * EMD_BWD_FLOP,
                              sfu=pairs * EMD_BWD_SFU,
                              nbytes=2 * B * N * (12 + 12 + 36)),
        "pairwise_emd": bound(flop=E * E * N * N * EMD_FLOP,
                              sfu=E * E * N * N * EMD_SFU,
                              nbytes=2 * E * N * 12),
    })
    say(f"    EMD forward: the cost needs {EMD_SFU} exps and roots and "
        f"{EMD_FLOP} FLOP a point pair, the kernels do {EMD_SFU_RECOMPUTED} "
        f"exps and roots ({EMD_SFU_RECOMPUTED / EMD_SFU:.1f}x); the grid "
        f"{pe_times[0]:.3f} ms against its bound "
        f"{bounds['pairwise_emd'][0]:.3f} ms")
    for mode in ("high", "fast"):
        ms = pd_times[mode, "direct"][0]
        base = pd_times["highest", "direct"][0]
        say(f"    point_decode {mode}: {ms:.3f} ms direct, "
            f"{ms / base:.2f} x 'highest'; bound "
            f"{bounds['point_decode_' + mode][0]:.3f} ms at the bf16 peak")
    for mode in ("high", "fast"):
        times = reduced[mode][2]
        for name in ("train_decode_fwd", "train_decode_bwd"):
            ms = times[f"{name}_{mode}"][0]
            base = times[name + "_highest"][0]
            say(f"    {name} {mode}: {ms:.3f} ms, {ms / base:.3f} x "
                f"'highest' in the same window; bound "
                f"{bounds[f'{name}_{mode}'][0]:.3f} ms at the bf16 peak")
    return {
        "point_decode": (pd_errs["highest"], pd_times["highest", "direct"]),
        "point_decode_high": (pd_errs["high"], pd_times["high", "direct"]),
        "point_decode_fast": (pd_errs["fast"], pd_times["fast", "direct"]),
        "nn_distance": (nn_err, nn_times),
        "pairwise_cd_stats": (max(pw_err, pw_main_err), pw_times),
        "emd_cost": (max(cost_errs + [c]), emd_times["emd_cost"]),
        "emd_backward": (max(bwd_errs + [g]), emd_times["emd_backward"]),
        "pairwise_emd": (max(pe_err, pe_big_err), pe_times),
        "train_decode_fwd": (max(td_fwd + [f_err]),
                             td_times["train_decode_fwd"]),
        "train_decode_bwd": (max(td_bwd + [b_err]),
                             td_times["train_decode_bwd"]),
        **{f"train_decode_{d}_{mode}": (
            reduced[mode][0 if d == "fwd" else 1],
            reduced[mode][2][f"train_decode_{d}_{mode}"])
           for mode in ("high", "fast") for d in ("fwd", "bwd")},
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
    sample_cd_by_mode(model, rng, gen, card)
    return launches


def sample_cd_by_mode(model, rng, gen, card, B=1024, turns=2):
    """Sample+CD at B clouds with the sample step built under each matmul
    precision mode (kernel 1 in that mode), timed in turns (the modes in
    order, then in reverse, `turns` times; 3 calls a window), beside the
    decode alone in each mode."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode)
    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)
    from go_with_the_flows_tpu_torch.train.step import make_sample_step

    g_in = torch.from_numpy(reference_clouds(rng, B)).cuda()
    ref = torch.from_numpy(
        reference_clouds(rng, B).transpose(0, 2, 1).copy()).cuda()
    packed = model.pack_decoder()
    ab = film_alpha_beta(packed, torch.randn(
        B, model.g_latent_space_size, device="cuda", generator=gen))
    base = torch.randn(model.n_components, B, 3, N_POINTS, device="cuda",
                       generator=gen)
    steps = {}
    for mode in MODES:
        with matmul_precision_scope(mode):
            steps[mode] = make_sample_step(model, N_POINTS, "generating")
    ms = {m: [] for m in MODES}
    decode = {m: [] for m in MODES}
    for _ in range(turns):
        for m in MODES + MODES[::-1]:
            ms[m].append(cuda_ms(
                lambda: kernel_sample_cd(steps[m], g_in, ref, gen), 3))
            with matmul_precision_scope(m):
                decode[m].append(cuda_ms(
                    lambda: point_decode(packed, ab, base), 3))
    for m in MODES:
        mean = sum(ms[m]) / len(ms[m])
        dec = sum(decode[m]) / len(decode[m])
        say(f"    sample+CD B={B} '{m}': {1000.0 * B / mean:.1f} clouds/s "
            f"({mean:.2f} ms: " + ", ".join(f"{t:.2f}" for t in ms[m])
            + f"; the decode alone {dec:.2f} ms, {100.0 * dec / mean:.1f} "
            f"%) [{card}]")


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


def train_decode_passes_by_mode(turns=2):
    """Kernels 7 and 8 at the flagship shape (B=64, N=2048) by pass in
    each mode, in one window: each mode's forward, then its backward on
    that forward's residuals, called in turns 'highest', 'high', 'fast',
    'fast', 'high', 'highest' (`turns` times), each call profiled alone;
    prints and returns {kernel: {mode: {pass: ms a call}}}, the mean over
    the mode's calls, by TRAIN_DECODE_PASSES' kernel names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    packed, ab, p = train_decode_inputs(FLAGSHIP_AIRPLANE, BATCH, N_POINTS, 19)
    gen = torch.Generator(device="cuda").manual_seed(19)
    dp0 = torch.randn(p.shape, device="cuda", generator=gen)
    dlv = torch.randn(p.shape, device="cuda", generator=gen)
    residuals = {m: train_decode_fwd(packed, ab, p, m)[2:] for m in MODES}
    calls = {
        "kernel 7 (train_decode_fwd)":
            lambda m: train_decode_fwd(packed, ab, p, m),
        "kernel 8 (train_decode_bwd)":
            lambda m: train_decode_bwd(packed, ab, *residuals[m], dp0, dlv,
                                       m),
    }
    for m in MODES:
        for call in calls.values():
            call(m)
    torch.cuda.synchronize()
    split = {what: {m: {label: [] for label in TRAIN_DECODE_PASSES[what]}
                    for m in MODES} for what in calls}
    for _ in range(turns):
        for m in MODES + MODES[::-1]:
            for what, call in calls.items():
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    call(m)
                    torch.cuda.synchronize()
                for label, (t, _) in passes_of(
                        device_kernels(prof),
                        TRAIN_DECODE_PASSES[what]).items():
                    split[what][m][label].append(t)
    means = {what: {m: {label: sum(v) / len(v) for label, v in by.items()}
                    for m, by in modes.items()}
             for what, modes in split.items()}
    K, C, _, f = packed["w1"].shape[:4]
    for what, modes in means.items():
        for m, by in modes.items():
            say(f"    {what} at '{m}' by pass, flagship shape, one window "
                f"({2 * turns} profiled calls a mode in turns): "
                + "; ".join(f"{label} {t:.3f} ms" for label, t in by.items())
                + f"; all {sum(by.values()):.3f} ms")
    for m in MODES:
        floor = cache_floor_ms(K, BATCH, N_POINTS, C, f,
                               KERNEL7_CACHE_FLOATS[m])
        say(f"    kernel 7's h2 cache and state traffic at '{m}' at the HBM "
            "rate: " + "; ".join(f"{k} {v:.3f} ms" for k, v in floor.items()))
    floor = cache_floor_ms(K, BATCH, N_POINTS, C, f)
    say("    kernel 8's cache traffic by pass at the HBM rate: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in floor.items()))
    del residuals
    return means


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


def check_train_steps(base, clouds, eps, images=None):
    """One step from one state through the kernels and through the
    decoder's modules: metrics rtol 1e-4, every parameter's gradient
    within 3e-2 of its own largest entry, parameters atol 5e-4, BatchNorm
    buffers atol 1e-4. The PointNet's last BatchNorm bias is invariant
    under the loss (the posterior's first BatchNorm removes it), so its
    gradient is rounding noise and AMSGrad moves it by +-lr either way
    (RESULTS.md round 5): it is held to 2 lr; so is an SVR model's ResNet
    fc bias (its fc_bn removes it). The step runs at lr 2e-4, as
    tests/test_train_kernel.py holds the TPU kernels' step. `images`:
    an SVR model's step (make_train_step(..., svr=True))."""
    import copy

    import torch

    from go_with_the_flows_tpu_torch.ops.layers import BatchNorm
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train.step import make_train_step

    hp = dict(TRAIN_HP, min_lr=2e-4, max_lr=2e-4)
    walkers = {"pc_encoder." + [n for n, m in base.pc_encoder.named_modules()
                                if isinstance(m, BatchNorm)][-1] + ".bias"}
    svr = {} if images is None else {"images": images}
    if svr:
        walkers.add("img_encoder.fc.bias")
    say(f"    one step at B={clouds.shape[0]}, lr {hp['max_lr']:g}")
    out = {}
    for fused in (False, True):
        model = copy.deepcopy(base).cuda()
        step = make_train_step(model, make_optimizer(
            list(model.parameters()), **hp), svr=bool(svr),
            fused_decoder=fused)
        metrics = step(clouds, clouds, posterior_eps=eps, **svr)
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
        if name not in walkers:
            worst_grad = max(worst_grad, (rel, name))
    buffers = {n for n, _ in base.named_buffers()}
    worst = {True: (0.0, ""), False: (0.0, "")}
    walk = {}
    for name, want in sp.items():
        diff = (sk[name].float() - want.float()).abs().max().item()
        if name in walkers:
            bound = 2 * hp["max_lr"] * (1 + 1e-3)
            walk[name] = diff
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
        f"({worst[True][1]}); " + ", ".join(
            f"{k} |diff| {v:.3g}" for k, v in walk.items()) + " (bound 2 lr)")


# one 'high' or 'fast' step through kernels 7 and 8 against one through the
# modules: not one function outside 'highest' (the kernels' sd0
# statistics come from the x-moments with the fp32 W0, off-centre on h0
# of the mode, and their backward takes them as h0's, as the JAX kernel
# does), so the loss is held relative and the gradient over all
# parameters in norm, by mode (read at B=64 on an H100 at 700 W: at 'fast'
# 5.3e-6 and 3.0e-3, at 'high', where the centring is off by about 2^-16
# of h0, 0 and 2.1e-5)
STEP_BOUNDS = {"fast": (1e-4, 3e-2), "high": (1e-6, 1e-4)}


def check_train_steps_mode(base, clouds, eps, mode, images=None):
    """One step in `mode` from one state through the kernels and through
    the decoder's modules (STEP_BOUNDS); prints the leaves whose
    gradients differ most. `images`: an SVR model's step."""
    import copy

    import torch

    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train.step import make_train_step

    loss_bound, grad_bound = STEP_BOUNDS[mode]
    hp = dict(TRAIN_HP, min_lr=2e-4, max_lr=2e-4)
    svr = {} if images is None else {"images": images}
    out = {}
    for fused in (False, True):
        model = copy.deepcopy(base).cuda()
        with matmul_precision_scope(mode):
            step = make_train_step(model, make_optimizer(
                list(model.parameters()), **hp), svr=bool(svr),
                fused_decoder=fused)
        metrics = step(clouds, clouds, posterior_eps=eps, **svr)
        out[fused] = ({k: float(v) for k, v in metrics.items()},
                      {n: q.grad for n, q in model.named_parameters()
                       if q.grad is not None})
        del model, step
    (mp, gp), (mk, gk) = out[False], out[True]
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    flat_p = torch.cat([g.flatten() for g in gp.values()])
    flat_k = torch.cat([gk[n].flatten() for n in gp])
    grad_norm = rel_norm(flat_k, flat_p)
    worst = sorted(((gk[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for n, g in gp.items())
    say(f"    one '{mode}' step at B={clouds.shape[0]}, kernel path vs "
        f"module path: loss {mk['loss']:.6g} vs {mp['loss']:.6g}, relative "
        f"{loss_rel:.3g} ({loss_bound:g}); all gradients in norm "
        f"{grad_norm:.3g} ({grad_bound:g}); the leaves' own "
        f"relative norms, median {worst[len(worst) // 2]:.3g}, largest "
        f"{worst[-1]:.3g}")
    if loss_rel > loss_bound or grad_norm > grad_bound:
        fail(f"the '{mode}' kernel-path step disagrees with the module path")


def mode_launches(wrappers, fn, mode):
    """fn() with kernels 7 and 8's counters, their counts by mode too, set
    to 0 before: (fn's result, {name: all launches}, {name + "_" + mode:
    the launches in `mode`})."""
    import torch

    zero(wrappers)
    for w in wrappers:
        w.launches_by_mode.update(dict.fromkeys(w.launches_by_mode, 0))
    out = fn()
    torch.cuda.synchronize()
    return out, read(wrappers), {f"{w.__name__}_{mode}":
                                 w.launches_by_mode[mode]
                                 for w in wrappers}


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

    # 'fast', then 'high': one step kernels vs modules, then the main path
    # in the mode, twenty kernel-path steps built under it (called under
    # 'highest')
    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)
    for mode in ("fast", "high"):
        for B in (BATCH, BATCH // 2, BATCH // 4):
            try:
                check_train_steps_mode(base, batches[0][:B].contiguous(),
                                       eps[:B], mode)
                break
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                say(f"    '{mode}' one-step comparison: the plain path is "
                    f"out of memory at B={B}")
        else:
            fail(f"the plain '{mode}' training path does not fit at any "
                 "batch tried")
        torch.cuda.empty_cache()
        with matmul_precision_scope(mode):
            step_m = trainer(None)

        def mode_steps():
            return [float(step_m(c, c)["loss"])
                    for c in (batches[i % len(batches)] for i in range(20))]

        m_losses, all_n, m_n = mode_launches(wrappers, mode_steps, mode)
        say(f"    20 '{mode}' kernel-path steps: loss {m_losses[0]:.2f} -> "
            f"{m_losses[-1]:.2f} (first five {np.mean(m_losses[:5]):.3f}, "
            f"last five {np.mean(m_losses[-5:]):.3f}); launches {m_n}")
        if not all(math.isfinite(v) for v in m_losses):
            fail(f"'{mode}' train losses are not finite: {m_losses}")
        if not np.mean(m_losses[-5:]) < np.mean(m_losses[:5]):
            fail(f"the '{mode}' train losses do not fall over 20 steps")
        if m_n != {f"{name}_{mode}": n for name, n in all_n.items()} or min(
                m_n.values()) < 20:
            fail(f"the '{mode}' steps launched {all_n}, of them in the "
                 f"mode {m_n}")
        launches.update(m_n)
        ms_m, mem_m = train_step_ms(step_m, batches, 10)
        say(f"    '{mode}' kernel path B={BATCH}: {ms_m:.2f} ms/step "
            f"({ms_m / ms_k:.3f} x 'highest'), {1000.0 * BATCH / ms_m:.1f} "
            f"train clouds/s, peak {mem_m:.2f} GB [{card}]")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_m(batches[0], batches[0])
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        busy = sum(r[0] for r in rows)
        if busy > 0:
            say(f"    profiled '{mode}' step: device busy {busy:.2f} ms of "
                f"{ms_m:.2f} ms/step")
            for what, passes in TRAIN_DECODE_PASSES.items():
                say(f"    {what} at '{mode}' by pass: " + "; ".join(
                    f"{label} {t:.3f} ms in {n} launches"
                    for label, (t, n) in passes_of(rows, passes).items()))
        del step_m
        torch.cuda.empty_cache()

    train_decode_passes_by_mode()
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
    return launches, ms_k


def snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def differing(a, b):
    """Names of the entries of two state dicts (same keys and shapes)
    that are not bit-equal, with each one's largest |diff| over its
    largest |entry|."""
    import torch

    out = []
    for k in a:
        if not torch.equal(a[k], b[k]):
            d = (a[k].double() - b[k].double()).abs().max().item()
            out.append((k, d / (b[k].double().abs().max().item() or 1.0)))
    return out


def optimizer_flat(opt):
    """AmsgradWD's moments and counts as a state-dict-like mapping."""
    return {k: getattr(opt, k) for k in opt._FLAT}


def check_eval_loss(model, batch, eps, pd_err, images=None):
    """The eval loss of one batch and one noise draw through kernel 1's
    inverse against the loss through the decoder's modules. Tolerance
    from the decode's own error: e, the largest |diff| of the two
    inverses' outputs (p0 and the logvar sum) on this batch, is held to
    1e-3 (phase 2 holds kernel 1 to 1e-4 of its plain version; the
    modules also fold BatchNorm another way), and the loss to twice its
    first-order change e * (sum |dL/dp0| + sum |dL/dlv|). `images`: an
    SVR model's eval step (make_eval_step(..., svr=True))."""
    import torch

    from go_with_the_flows_tpu_torch.losses import flow_mixture_nll
    from go_with_the_flows_tpu_torch.train.step import (
        eval_mode, make_eval_step)

    g, p = batch
    svr = {} if images is None else {"images": images}
    got = make_eval_step(model, svr=bool(svr))(g, p, posterior_eps=eps, **svr)
    want = make_eval_step(model, svr=bool(svr), fused_decoder=False)(
        g, p, posterior_eps=eps, **svr)
    with eval_mode(model), torch.inference_mode():
        gs = model.encode(g, "training", posterior_eps=eps,
                          **svr)["g_sample"]
        kern = model.decode_eval(p, gs)
        mods = model.decode_training(p, gs)
    e = max((kern[k] - mods[k]).abs().max().item()
            for k in ("p0_samples", "p_logvar_sums"))
    with eval_mode(model):
        p0 = mods["p0_samples"].clone().requires_grad_()
        lv = mods["p_logvar_sums"].clone().requires_grad_()
        nll = flow_mixture_nll(p0, lv, mods["p_base_mus"].clone(),
                               mods["p_base_logvars"].clone(),
                               mods["mixture_weights_logits"].clone())
        dp0, dlv = torch.autograd.grad(nll, (p0, lv))
    sens = (dp0.abs().sum() + dlv.abs().sum()).item()
    tol = 2.0 * max(e, pd_err) * sens
    diffs = {k: abs(float(got[k]) - float(want[k])) for k in got}
    say(f"    eval loss, kernel 1's inverse vs the decoder's modules: "
        + ", ".join(f"{k} {float(got[k]):.6f} vs {float(want[k]):.6f}"
                    for k in got)
        + f"; decode |diff| {e:.3g} (phase 2: {pd_err:.3g}), loss |diff| "
        f"{diffs['loss']:.3g}, tolerance {tol:.3g} = 2 x {max(e, pd_err):.3g}"
        f" x {sens:.4g}")
    if e > 1e-3:
        fail(f"eval decode: kernel 1's inverse and the modules differ by "
             f"{e:.3g} (bound 1e-3)")
    for k in ("loss", "pnll"):
        if not diffs[k] <= tol:
            fail(f"eval {k}: kernel path {float(got[k])!r}, modules "
                 f"{float(want[k])!r} (tolerance {tol:.3g})")
    for k in ("gnll", "gent"):  # the decoder does not enter these
        if not diffs[k] <= 1e-6 * abs(float(want[k])):
            fail(f"eval {k}: kernel path {float(got[k])!r}, modules "
                 f"{float(want[k])!r}")


def check_resume(state, ckpt_dir, batch):
    """Restore the checkpoint into a fresh model, optimizer and generator:
    parameters, buffers and AMSGrad moments bit-equal to the live state's;
    then one train step from each, bit-equal again (loss, every model
    tensor, the moments and counts). Returns the load seconds."""
    import torch

    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train import checkpoints
    from go_with_the_flows_tpu_torch.train.state import create_train_state
    from go_with_the_flows_tpu_torch.train.step import make_train_step
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    fresh = FlowMixtureModel(**FLAGSHIP_AIRPLANE,
                             generator=torch.Generator().manual_seed(99)
                             ).to(batch[0].device)
    other = create_train_state(
        fresh, make_optimizer(list(fresh.parameters()), **TRAIN_HP), seed=98)
    torch.cuda.synchronize()
    t = time.perf_counter()
    other, epoch, it = checkpoints.restore_checkpoint(
        ckpt_dir, "flagship.ckpt", other)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    if (epoch, it, other.step) != (1, 0, state.step):
        fail(f"restored epoch, iter, step {(epoch, it, other.step)}, "
             f"expected {(1, 0, state.step)}")
    for what, a, b in (
            ("model", snapshot(other.model), snapshot(state.model)),
            ("optimizer", optimizer_flat(other.optimizer),
             optimizer_flat(state.optimizer))):
        bad = differing(a, b)
        if bad:
            fail(f"restored {what} differs from the saved one: {bad[:5]}")
    if not torch.equal(other.generator.get_state(),
                       state.generator.get_state()):
        fail("restored generator state differs")
    g, p = batch
    after = []
    for st in (state, other):
        step = make_train_step(st.model, st.optimizer)
        loss = step(g, p, st.generator)["loss"]
        after.append((float(loss), snapshot(st.model),
                      optimizer_flat(st.optimizer)))
    (la, ma, oa), (lb, mb, ob) = after
    bad = differing(ma, mb) + differing(oa, ob)
    if la != lb or bad:
        fail(f"one step after the restore is not bit-equal to one from the "
             f"live state: loss {lb!r} vs {la!r}; {len(bad)} tensors differ:"
             f" {bad[:8]}")
    say(f"    one step from the restored state and from the live state: "
        f"bit-equal (loss {la!r}; {len(ma)} model tensors, AMSGrad "
        f"moments and counts)")
    return load_s


# the CUDA runtime calls that make the host wait for the card
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def host_waits(prof, window):
    """{name: calls} of the HOST_WAITS calls, and of the kernel launches,
    made while the host was inside the profile's record_function range
    `window` (its host-side span: the card's span of the same range runs
    on to the last kernel launched in it); and for each wait other than
    on an event, the host operations that enclose it, outermost first,
    and the one that ended last before it."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [e.time_range for e in events
             if e.name == window and e.device_type == DeviceType.CPU]

    def inside(e, r):
        return r.start <= e.time_range.start and e.time_range.end <= r.end

    out = {name: 0 for name in HOST_WAITS + ("cudaLaunchKernel",)}
    where = []
    for e in events:
        if e.name not in out or not any(inside(e, r) for r in spans):
            continue
        out[e.name] += 1
        if e.name in HOST_WAITS and e.name != "cudaEventSynchronize":
            host = [o for o in events if o is not e and o.name != window
                    and o.device_type == DeviceType.CPU]
            before = [o for o in host
                      if o.time_range.end <= e.time_range.start]
            where.append({
                "in": [o.name for o in sorted(
                    (o for o in host if inside(e, o.time_range)),
                    key=lambda o: o.time_range.start)],
                "after": max(before, key=lambda o: o.time_range.end).name
                if before else None})
    return out, where


def phase_loop(card, bare_step_ms, pd_err):
    import copy
    import math
    import tempfile

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.data import DataLoader
    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        point_decode)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train import checkpoints, loops
    from go_with_the_flows_tpu_torch.train.state import create_train_state
    from go_with_the_flows_tpu_torch.train.step import (
        make_eval_step, make_sample_step, make_train_step)
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    say(f"[5] loop: flagship airplane model, B={BATCH}, N={N_POINTS}: "
        f"train, evaluate_val, checkpoint and resume, reconstruct")
    torch.cuda.empty_cache()  # the blocks phases 3 and 4 left cached
    model = FlowMixtureModel(**FLAGSHIP_AIRPLANE,
                             generator=torch.Generator().manual_seed(0))
    jiggle_batch_norms(model, 1000)
    model.cuda()
    state = create_train_state(
        model, make_optimizer(list(model.parameters()), **TRAIN_HP), seed=5)
    rng = np.random.default_rng(6)
    train_set = [{"cloud": c, "eval_cloud": c}
                 for c in reference_clouds(rng, 4 * BATCH)]
    val_set = [{"cloud": c, "eval_cloud": c}
               for c in reference_clouds(rng, 2 * BATCH)]
    train_loader = DataLoader(train_set, BATCH, shuffle=True, seed=7)
    val_loader = DataLoader(val_set, BATCH, drop_last=False)
    train_step = make_train_step(model, state.optimizer)
    eval_step = make_eval_step(model)
    sample_step = make_sample_step(model, N_POINTS, "autoencoding")
    wrappers = (point_decode, train_decode_fwd, train_decode_bwd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        config = dict(logging=True, checkpointing=True, logging_path=tmp,
                      model_name="flagship.ckpt", num_workers=1)
        # the main path, its launches counted: one epoch of 4 train steps
        # with its end-of-epoch checkpoint, evaluate_val over 2 batches
        # (the best-model checkpoint), reconstruct over 2 batches
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = loops.train(train_loader, train_step, state, 0, 0, False,
                            "cuda", **config)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
        before_val = snapshot(model)
        t = time.perf_counter()
        min_loss = loops.evaluate_val(val_loader, eval_step, state, 0, False,
                                      math.inf,
                                      torch.Generator(device="cuda")
                                      .manual_seed(8), "cuda", **config)
        val_s = time.perf_counter() - t
        modes = [m.training for m in model.modules()]
        before_rec = snapshot(model)
        samples, gts, labels = loops.reconstruct(
            val_loader, sample_step,
            torch.Generator(device="cuda").manual_seed(9), "cuda")
        launches = {w.__name__: w.launches for w in wrappers}
        say(f"    train epoch of 4 steps {epoch_s:.2f} s (end-of-epoch "
            f"checkpoint included), train means "
            + ", ".join(f"{k} {v:.3f}" for k, v in state.train_metrics.items())
            + f"; evaluate_val {val_s:.2f} s, "
            + ", ".join(f"{k} {v:.3f}" for k, v in state.val_metrics.items())
            + f"; launches {launches}")
        # kernel 1 once an eval and once a reconstruct batch, kernels 7
        # and 8 once a train step
        want = {"point_decode": 2 * len(val_loader),
                "train_decode_fwd": len(train_loader),
                "train_decode_bwd": len(train_loader)}
        for name, n in launches.items():
            if n != want[name]:
                fail(f"{name} launched {n} times on the loop's path, "
                     f"{want[name]} expected: a step left the kernels")
        vals = list(state.train_metrics.values()) + [min_loss]
        if state.step != 4 or not all(math.isfinite(v) for v in vals):
            fail(f"loop: step {state.step}, metrics {vals}")
        for name in ("flagship.ckpt", "best_model_flagship.ckpt"):
            if not checkpoints.checkpoint_exists(tmp, name):
                fail(f"no checkpoint {name}")

        # evaluate_val and reconstruct wrote nothing into the model and
        # gave it back in train mode, as the train step left it
        after = snapshot(model)
        for what, before in (("evaluate_val", before_val),
                             ("reconstruct", before_rec)):
            bad = differing(after, before)
            if bad:
                fail(f"{what} moved {len(bad)} tensors: {bad[:5]}")
        if [m.training for m in model.modules()] != modes or not all(modes):
            fail("reconstruct did not give the model its modes back")
        if samples.shape != (2 * BATCH, 3, N_POINTS) \
                or not np.isfinite(samples).all() \
                or labels.min() < 1 or labels.max() > model.n_components:
            fail(f"reconstruct: samples {samples.shape}, labels "
                 f"{labels.min()}..{labels.max()}")
        fresh, _, fresh_labels = loops.reconstruct(
            val_loader, make_sample_step(copy.deepcopy(model), N_POINTS,
                                         "autoencoding"),
            torch.Generator(device="cuda").manual_seed(9), "cuda")
        if not (np.array_equal(fresh, samples)
                and np.array_equal(fresh_labels, labels)):
            fail("reconstruct after training differs from a freshly built "
                 "sample step's: max |diff| "
                 f"{np.abs(fresh - samples).max():.3g}")
        say(f"    reconstruct after training: {samples.shape[0]} clouds, "
            "equal to a freshly built sample step's, no buffer moved, "
            "the model back in train mode")

        # the eval loss through kernel 1 against the decoder's modules
        clouds = torch.from_numpy(np.stack(
            [d["cloud"] for d in val_set[:BATCH]])).cuda()
        eps = torch.randn(BATCH, model.g_latent_space_size, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(10))
        check_eval_loss(model, (clouds, clouds), eps, pd_err)

        # the checkpoint: size, save and load seconds, and a resume
        path = os.path.join(checkpoints._ckpt_dir(tmp, "flagship.ckpt"),
                            "checkpoint.pt")
        mb = os.path.getsize(path) / 1e6
        torch.cuda.synchronize()
        t = time.perf_counter()
        checkpoints.save_checkpoint(tmp, "again.ckpt", state, 1, 0)
        save_s = time.perf_counter() - t
        load_s = check_resume(state, tmp, (clouds, clouds))
        say(f"    checkpoint {mb:.1f} MB: save {save_s:.3f} s, load "
            f"{load_s:.3f} s [{card}]")

    # times: the loop's steps against bare steps in turns, in this phase
    # (an epoch of 16 steps, so that the first batch's assembly and the
    # last step's drain weigh little; the bare steps over the same
    # batches, already on the card), the eval step through kernel 1 and
    # through the modules, the pack's check and a full pack
    long_loader = DataLoader(
        [{"cloud": c, "eval_cloud": c}
         for c in reference_clouds(rng, 16 * BATCH)], BATCH, shuffle=True,
        seed=11)
    bare_batches = [torch.from_numpy(b["cloud"]).cuda() for b in long_loader]
    loop_ms, bare_ms = [], []
    for turn in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = loops.train(long_loader, train_step, state, 2 + turn, 0,
                            False, "cuda")
        torch.cuda.synchronize()
        loop_ms.append(1000.0 * (time.perf_counter() - t) / len(long_loader))
        t = time.perf_counter()
        for g in bare_batches:
            train_step(g, g, state.generator)
        torch.cuda.synchronize()
        bare_ms.append(1000.0 * (time.perf_counter() - t) / len(bare_batches))

    # the loop queues step i before it waits, for step i - 1's metrics
    # alone: inside train() the host waits on events only
    from torch.profiler import ProfilerActivity, profile

    retries = torch.cuda.memory_stats()["num_alloc_retries"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("loop"):
            state = loops.train(train_loader, train_step, state, 1, 0, False,
                                "cuda")
    retries = (torch.cuda.memory_stats()["num_alloc_retries"]
               - retries)
    waits, where = host_waits(prof, "loop")
    say(f"    profiled loop of {len(train_loader)} steps, the host's waits "
        f"for the card: {waits}; allocator retries {retries}")
    if waits["cudaLaunchKernel"] == 0:
        say("    profiler: no runtime calls recorded (the loop's waits not "
            "measured)")
    elif where:
        fail("the loop waits for the whole stream, so for the step it just "
             f"queued: {waits}, inside {where}")

    timings = {}
    for name, fused in (("kernel 1", True), ("modules", False)):
        step = make_eval_step(model, fused_decoder=fused)
        step(clouds, clouds, posterior_eps=eps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            step(clouds, clouds, posterior_eps=eps)
        torch.cuda.synchronize()
        timings[name] = 1000.0 * (time.perf_counter() - t) / 5
    model.pack_decoder()
    t = time.perf_counter()
    for _ in range(20):
        model.pack_decoder()  # packed already: the check alone
    key_ms = 1000.0 * (time.perf_counter() - t) / 20
    with torch.no_grad():
        model.pc_decoder.couplings()[0].T_mu_0.mu_sd1_bn.running_var.mul_(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.pack_decoder()
    torch.cuda.synchronize()
    pack_ms = 1000.0 * (time.perf_counter() - t)
    say(f"    loop over an epoch of {len(long_loader)} steps and bare "
        f"steps over its batches, in turns: loop "
        + ", ".join(f"{v:.2f}" for v in loop_ms) + " ms/step, bare "
        + ", ".join(f"{v:.2f}" for v in bare_ms) + f" ms/step (phase 4's "
        f"bare step {bare_step_ms:.2f} ms/step); eval step B={BATCH}: "
        f"kernel 1 {timings['kernel 1']:.2f} ms/batch, modules "
        f"{timings['modules']:.2f} ms/batch; "
        f"pack_decoder's check of the decoder's tensors {key_ms:.3f} ms, a "
        f"full pack {pack_ms:.2f} ms [{card}]")
    return launches, loop_ms


def resnet_device_ms(prof, window):
    """Device milliseconds of the ResNet in a profiled train step: the
    kernels launched inside the `window` annotation around its forward,
    and those of the backward functions autograd recorded for the
    forward's operations (linked by their sequence numbers). None when
    the profile holds no such annotation or no device time."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [e for e in events
             if e.name == window and e.device_type == DeviceType.CPU]
    if not spans:
        return None

    def below(e):
        for c in e.cpu_children:
            yield c
            yield from below(c)

    forward = [d for e in spans for d in below(e)]
    seqs = {d.sequence_nr for d in forward if d.sequence_nr >= 0}
    fwd_ms = sum(e.device_time_total for e in spans) / 1000.0
    bwd_ms = sum(e.device_time_total for e in events
                 if e.name.startswith("autograd::engine::evaluate_function")
                 and e.sequence_nr in seqs) / 1000.0
    if fwd_ms <= 0 or bwd_ms <= 0:
        return None
    return fwd_ms, bwd_ms


def svr_batches(rng, n):
    """n seeded SVR items, {cloud, eval_cloud, image}: ellipsoid clouds of
    the SVR configuration's size and images of noise as the normalised
    4-channel inputs the loader gives (zero mean, unit variance)."""
    from go_with_the_flows_tpu_torch.utils.config import SVR_RUN

    import numpy as np

    H, W = SVR_RUN["image_size"]
    clouds = reference_clouds(rng, n, SVR_RUN["cloud_size"])
    images = rng.standard_normal((n, 4, H, W), dtype=np.float32)
    return [{"cloud": c, "eval_cloud": c, "image": im}
            for c, im in zip(clouds, images)]


def check_svr_kernels():
    """The SVR path's kernels against their plain versions at the shapes
    the path gives them (B=128, N=2500; the decoder K=4, 11 flows of
    f=33), timed, with their bounds: kernel 1 both directions, kernel 2,
    kernels 7 and 8 as phase 2 checks them, kernel 5 (the EMD meter) on
    8 of the 128 pairs against the plain auction (rtol 1e-4, phase 2's)
    and timed on all 128."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_cost, emd_cost_plain)
    from go_with_the_flows_tpu_torch.utils.config import (
        SVR_RUN, SVR_SHAPENETALL13, model_config_kwargs)

    B, N = SVR_RUN["batch_size"], SVR_RUN["cloud_size"]
    decoder = model_config_kwargs(SVR_SHAPENETALL13)
    pd_errs, pd_times = check_point_decode(decoder, B, N, 30, timed=True,
                                           modes=MODES)
    nn_err, nn_times = check_nn_distance(B, N, N, 31, timed=True)
    f_err, b_err, td_times = check_train_decode(decoder, B, N, 32,
                                                timed=True)
    reduced = {mode: check_train_decode_mode(decoder, B, N, seed, timed=True,
                                             mode=mode)
               for mode, seed in (("fast", 34), ("high", 35))}
    bf16_bmm_yardsticks(decoder, B, N)
    gen = torch.Generator(device="cuda").manual_seed(33)
    a = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    b = 0.3 * torch.randn(B, N, 3, device="cuda", generator=gen)
    emd_err = check_close(f"emd B=8 (of {B}) N={N} M={N} cost",
                          emd_cost(a[:8], b[:8]), emd_cost_plain(a[:8], b[:8]),
                          0.0, 1e-4)
    emd_ms = cuda_ms(lambda: emd_cost(a, b), 3)
    say(f"    emd B={B} N={N} M={N}: cost kernel {emd_ms:.3f} ms")
    bounds = path_bounds(*pd_times["dims"])
    measured = {
        **{"point_decode" + ("" if m == "highest" else "_" + m): (
            pd_errs[m], pd_times[m, "direct"][0]) for m in MODES},
        "nn_distance": (nn_err, nn_times[0]),
        "emd_cost": (emd_err, emd_ms),
        "train_decode_fwd": (f_err, td_times["train_decode_fwd"][0]),
        "train_decode_bwd": (b_err, td_times["train_decode_bwd"][0]),
        **{f"train_decode_{d}_{mode}": (
            errs[0 if d == "fwd" else 1],
            errs[2][f"train_decode_{d}_{mode}"][0])
           for mode, errs in reduced.items() for d in ("fwd", "bwd")},
    }
    return measured, bounds, pd_times["dims"]


def check_svr_metrics(model, batches, drawn, gen_seed, res):
    """The reconstruction meters against the plain versions. On the first
    batch: kernel 2's minima equal to the plain version's bit for bit
    (so are the CD and F1 meters, which are made of them), kernel 5's
    cost on 8 of the pairs rtol 1e-4 (phase 2's), and the samples against
    decode_sampling's arithmetic on the plain packed path
    (point_decode_plain) with the step's component ids and base noise,
    atol 1e-4 (phase 2's kernel-1 tolerance). Over both batches: the
    meters evaluate returned are the batch-weighted means of the kernels'
    per-batch values."""
    import torch

    from go_with_the_flows_tpu_torch.metrics.evaluation import f_score
    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import (
        nn_distance, nn_distance_plain)
    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_cost, emd_cost_plain)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode_plain)
    from go_with_the_flows_tpu_torch.train.step import eval_mode
    from go_with_the_flows_tpu_torch.utils.meters import AverageMeter

    samples, labels, logits = drawn[0]
    B, _, N = samples.shape
    K = model.n_components
    images = torch.from_numpy(batches[0]["image"]).cuda()
    with eval_mode(model), torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        ids = torch.multinomial(logits.softmax(-1), N, replacement=True,
                                generator=gen)
        base_eps = torch.randn(K, B, 3, N, generator=gen, device="cuda")
        if not torch.equal(ids + 1, labels):
            fail("svr: the sample step's labels are not its ids redrawn")
        g = model.encode(None, "reconstruction", images=images)["g_sample"]
        packed = model.pack_decoder()
        mus, logvars = model.point_base(g)
        base = mus[None] + torch.exp(0.5 * logvars)[None] * base_eps
        decoded, _ = point_decode_plain(packed, film_alpha_beta(packed, g),
                                        base)
        pick = ids[None, :, None, :].expand(1, B, 3, N)
        want = torch.gather(decoded, 0, pick)[0]
    check_close(f"svr samples B={B} N={N} against the plain decode", samples,
                want, 1e-4)
    meters = {k: AverageMeter() for k in res}
    for i, (batch, (smp, _, _)) in enumerate(zip(batches, drawn)):
        r = smp.transpose(1, 2).contiguous()
        p = torch.from_numpy(
            batch["eval_cloud"].transpose(0, 2, 1).copy()).cuda()
        with torch.inference_mode():
            dl, dr = nn_distance(r, p, with_idx=False)
            emd = emd_cost(r, p) / N
            if i == 0:
                pl, pr = nn_distance_plain(r, p, with_idx=False)
                check_close(f"svr CD minima B={B} N={N} (exact)",
                            torch.cat([dl, dr]), torch.cat([pl, pr]), 0.0)
                check_close(f"svr EMD meter, 8 of {B} pairs", emd[:8],
                            emd_cost_plain(r[:8], p[:8]) / N, 0.0, 1e-4)
            n = r.shape[0]
            meters["cd"].update(float((dl.mean(dim=1)
                                       + dr.mean(dim=1)).mean()), n)
            meters["emd"].update(float(emd.mean()), n)
            meters["f1_0.0010"].update(float(f_score(r, p, 1e-3).mean()), n)
    for k, m in meters.items():
        if abs(m.avg - res[k]) > 1e-6 * abs(res[k]):
            fail(f"svr evaluate {k} {res[k]!r}, the kernels' per-batch "
                 f"values give {m.avg!r}")
    say("    reconstruction meters: evaluate's equal the kernels' per-batch "
        "values, the first batch's CD and F1 inputs equal the plain "
        "version's bit for bit")


def phase_svr(card, pd_err):
    import copy
    import math

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.data import DataLoader
    from go_with_the_flows_tpu_torch.eval.evaluating import evaluate
    from go_with_the_flows_tpu_torch.models.mixture import (
        FlowMixtureSVRModel)
    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import nn_distance
    from go_with_the_flows_tpu_torch.ops.kernels.emd import emd_cost
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        point_decode)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train import loops
    from go_with_the_flows_tpu_torch.train.state import create_train_state
    from go_with_the_flows_tpu_torch.train.step import (
        make_eval_step, make_sample_step, make_train_step)
    from go_with_the_flows_tpu_torch.utils.config import (
        SVR_RUN, SVR_SHAPENETALL13, svr_model_config_kwargs)

    B, N = SVR_RUN["batch_size"], SVR_RUN["cloud_size"]
    H, W = SVR_RUN["image_size"]
    say(f"[6] svr: configs/config_SVR.yaml's model (K=4, 11 flows of f=33, "
        f"freevar, g=512, ResNet-18 on {H} x {W} images), B={B}, N={N}")
    torch.cuda.empty_cache()
    measured, bounds, dims = check_svr_kernels()
    torch.cuda.empty_cache()

    hp = {k: SVR_RUN[k] for k in ("cycle_length", "min_lr", "max_lr",
                                  "beta1", "min_beta2", "max_beta2", "wd")}
    hp["epoch_length"] = 4
    base = FlowMixtureSVRModel(**svr_model_config_kwargs(SVR_SHAPENETALL13),
                               generator=torch.Generator().manual_seed(0))
    jiggle_batch_norms(base, 1000)
    rng = np.random.default_rng(40)
    train_set = svr_batches(rng, 4 * B)
    val_set = svr_batches(rng, 2 * B)

    # one step through the kernels against one through the decoder's
    # modules, at the largest batch at which the modules' autograd fits
    first = train_set[:B]
    clouds = torch.from_numpy(np.stack([d["cloud"] for d in first])).cuda()
    images = torch.from_numpy(np.stack([d["image"] for d in first])).cuda()
    eps = torch.randn(B, base.g_latent_space_size, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(41))
    for b in (B, B // 2, B // 4):
        try:
            check_train_steps(base, clouds[:b].contiguous(), eps[:b],
                              images[:b].contiguous())
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            say(f"    one-step comparison: the decoder's modules are out of "
                f"memory at B={b}")
    else:
        fail("the SVR module path does not fit at any batch tried")
    torch.cuda.empty_cache()

    model = copy.deepcopy(base).cuda()
    state = create_train_state(
        model, make_optimizer(list(model.parameters()), **hp), seed=42)
    train_loader = DataLoader(train_set, B, shuffle=True, seed=43)
    val_loader = DataLoader(val_set, B, drop_last=False)
    train_step = make_train_step(model, state.optimizer, svr=True)
    eval_step = make_eval_step(model, svr=True)
    sample_step = make_sample_step(model, N, "reconstruction", svr=True)
    drawn = []

    def recording_step(g, generator, images):
        out = sample_step(g, generator, images=images)
        drawn.append(out)
        return out

    wrappers = (point_decode, nn_distance, emd_cost, train_decode_fwd,
                train_decode_bwd)
    # the main path, its launches counted: one epoch of 4 train steps,
    # evaluate_val over 2 batches, reconstruction metrics over 2 batches
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = loops.train(train_loader, train_step, state, 0, 0, False, "cuda",
                        svr=True)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t
    t = time.perf_counter()
    min_loss = loops.evaluate_val(
        val_loader, eval_step, state, 0, False, math.inf,
        torch.Generator(device="cuda").manual_seed(44), "cuda", svr=True)
    val_s = time.perf_counter() - t
    t = time.perf_counter()
    res = evaluate(val_loader, recording_step,
                   torch.Generator(device="cuda").manual_seed(45), "cuda",
                   svr=True, util_mode="reconstruction", cd=True, emd=True,
                   f1=True)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t
    launches = {w.__name__: w.launches for w in wrappers}
    say(f"    train epoch of 4 steps {epoch_s:.2f} s, train means "
        + ", ".join(f"{k} {v:.3f}" for k, v in state.train_metrics.items())
        + f"; evaluate_val {val_s:.2f} s, "
        + ", ".join(f"{k} {v:.3f}" for k, v in state.val_metrics.items())
        + f"; evaluate (reconstruction) {rec_s:.2f} s, "
        + ", ".join(f"{k} {v:.6f}" for k, v in res.items())
        + f"; launches {launches}")
    # kernel 1 once an eval and once a sampled batch; kernel 2 twice a
    # reconstruction batch (the CD meter and f_score), kernel 5 once;
    # kernels 7 and 8 once a train step
    want = {"point_decode": 2 * len(val_loader),
            "nn_distance": 2 * len(val_loader),
            "emd_cost": len(val_loader),
            "train_decode_fwd": len(train_loader),
            "train_decode_bwd": len(train_loader)}
    for name, n in launches.items():
        if n != want[name]:
            fail(f"{name} launched {n} times on the SVR path, {want[name]} "
                 "expected: a step left the kernels")
    vals = list(state.train_metrics.values()) + [min_loss] + list(
        res.values())
    if state.step != 4 or not all(math.isfinite(v) for v in vals):
        fail(f"svr loop: step {state.step}, metrics {vals}")
    samples = drawn[0][0]
    if tuple(samples.shape) != (B, 3, N) \
            or not bool(torch.isfinite(samples).all()):
        fail(f"svr samples: {tuple(samples.shape)}, finite "
             f"{bool(torch.isfinite(samples).all())}")

    # the reconstruction meters against the plain versions, then the eval
    # loss through kernel 1 against the decoder's modules
    val_batches = list(val_loader)
    check_svr_metrics(model, val_batches, drawn, 45, res)
    batch0 = val_batches[0]
    g0 = torch.from_numpy(batch0["cloud"]).cuda()
    check_eval_loss(model, (g0, g0), eps, pd_err,
                    torch.from_numpy(batch0["image"]).cuda())

    # times: the loop's 4 steps against 4 bare steps over the same
    # batches, in turns; peak memory over them
    bare = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
            for b in train_loader]
    loop_ms, bare_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for turn in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = loops.train(train_loader, train_step, state, 1 + turn, 0,
                            False, "cuda", svr=True)
        torch.cuda.synchronize()
        loop_ms.append(1000.0 * (time.perf_counter() - t) / len(train_loader))
        t = time.perf_counter()
        for b in bare:
            train_step(b["cloud"], b["eval_cloud"], state.generator,
                       images=b["image"])
        torch.cuda.synchronize()
        bare_ms.append(1000.0 * (time.perf_counter() - t) / len(bare))
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"    SVR train step B={B}: loop " + ", ".join(
        f"{v:.2f}" for v in loop_ms) + " ms/step, bare " + ", ".join(
        f"{v:.2f}" for v in bare_ms) + f" ms/step, in turns; "
        f"{1000.0 * B / min(bare_ms):.1f} clouds/s (bare, best turn); peak "
        f"{peak:.2f} GB [{card}]")

    # one profiled bare step: the card's busy time, the ResNet's share
    # (its forward in an annotation, its backward by autograd's sequence
    # numbers) and kernels 7 and 8
    from torch.profiler import ProfilerActivity, profile, record_function

    scope = []
    hooks = [model.img_encoder.register_forward_pre_hook(
                 lambda m, a: scope.append(
                     record_function("resnet_forward").__enter__())),
             model.img_encoder.register_forward_hook(
                 lambda m, a, o: scope.pop().__exit__(None, None, None))]
    b = bare[0]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_step(b["cloud"], b["eval_cloud"], state.generator,
                       images=b["image"])
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    rows = device_kernels(prof)
    busy = sum(r[0] for r in rows)
    resnet = resnet_device_ms(prof, "resnet_forward")
    # the ResNet alone, forward and backward in train mode, on a copy
    enc = copy.deepcopy(model.img_encoder)
    alone = cuda_ms(lambda: enc(b["image"]).sum().backward(), 3)
    del enc
    if busy <= 0:
        say("    profiler: no device time recorded (idle share and the "
            f"ResNet's share not measured); the ResNet alone, forward and "
            f"backward: {alone:.2f} ms [{card}]")
    else:
        split = {what: passes_of(rows, passes)
                 for what, passes in TRAIN_DECODE_PASSES.items()}
        k78 = {what: sum(t for t, _ in d.values())
               for what, d in split.items()}
        share = ("not measured (no annotation or backward linked in the "
                 "profile)" if resnet is None else
                 f"{resnet[0]:.2f} ms forward + {resnet[1]:.2f} ms backward,"
                 f" {100.0 * sum(resnet) / busy:.1f} % of the busy time")
        say(f"    profiled SVR step: device busy {busy:.2f} ms of "
            f"{min(bare_ms):.2f} ms/step, idle share "
            f"{max(0.0, 1.0 - busy / min(bare_ms)):.3f}; the ResNet {share}"
            f" (alone, forward and backward: {alone:.2f} ms); "
            + "; ".join(f"{what} {ms:.3f} ms" for what, ms in k78.items())
            + f" [{card}]")
        for t_ms, n, name in rows[:10]:
            say(f"      {t_ms:9.3f} ms {n:6d}x {name[:70]}")

    # 'fast' and 'high': two SVR steps built under the mode (called under
    # 'highest'), through kernels 7 and 8 in that mode, on the first batch
    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)
    for mode in ("fast", "high"):
        with matmul_precision_scope(mode):
            mode_step = make_train_step(model, state.optimizer, svr=True)

        def two_steps():
            t = time.perf_counter()
            out = [float(mode_step(b["cloud"], b["eval_cloud"],
                                   state.generator,
                                   images=b["image"])["loss"])
                   for _ in range(2)]
            torch.cuda.synchronize()
            return out, 1000.0 * (time.perf_counter() - t) / 2

        (m_loss, m_ms), all_n, m_n = mode_launches(
            (train_decode_fwd, train_decode_bwd), two_steps, mode)
        say(f"    two '{mode}' SVR steps B={B}: losses "
            + ", ".join(f"{v:.4f}" for v in m_loss)
            + f", {m_ms:.2f} ms/step (host clock, the first step included);"
            f" launches {m_n} [{card}]")
        if not all(math.isfinite(v) for v in m_loss) or m_n != {
                f"{name}_{mode}": 2 for name in all_n} or all_n != {
                name: 2 for name in all_n}:
            fail(f"the '{mode}' SVR steps: losses {m_loss}, launches "
                 f"{all_n}, of them in the mode {m_n}")
        launches.update(m_n)
        # one more step profiled: the card's busy time in the mode
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mode_step(b["cloud"], b["eval_cloud"], state.generator,
                      images=b["image"])
            torch.cuda.synchronize()
        say(f"    profiled '{mode}' SVR step: device busy "
            f"{sum(r[0] for r in device_kernels(prof)):.2f} ms")
        del mode_step

    say("    SVR-shape kernels (K={}, B={}, N={}, C={}, f={}): ".format(*dims)
        + "; ".join(
        f"{name} {ms:.3f} ms, bound {bounds[name][0]:.3f} ms "
        f"({bounds[name][1]}), {launches.get(name, 0)} launches in phase 6"
        for name, (_, ms) in measured.items()) + f" [{card}]")
    return launches, loop_ms


# --------------------------------------------------------------------- #
# phase 7: the command-line entry points on mesh-sampled data          #
# --------------------------------------------------------------------- #

# shapes of the in-memory ShapeNet layouts (data/synthetic.py): closed
# jittered ellipsoids of 5,120 faces (icosphere level 4), 2,562 vertices
SPHERE_LEVEL = 4
FLAGSHIP_SHAPES = {"train": 256, "val": 128, "test": 64}
# 24 views a shape: 22 shapes give 4 train batches of 128 views, 10 test
# shapes 2 reconstruction batches (128 and 112 views)
SVR_SHAPES = {"train": 22, "test": 10}
SURFACE_ATOL = 1e-5


def surface_distance(points, vertices, faces):
    """Each point's distance to the nearest triangle that contains its
    projection (float64, on the card): 0 up to rounding for a point
    sampled from the surface."""
    import torch

    tri = torch.as_tensor(vertices, dtype=torch.float64,
                          device="cuda")[torch.as_tensor(
                              faces.astype("int64"), device="cuda")]
    a, e0, e1 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e0, e1)
    n = n / n.norm(dim=1, keepdim=True)
    d00, d01, d11 = ((e0 * e0).sum(1), (e0 * e1).sum(1), (e1 * e1).sum(1))
    den = d00 * d11 - d01 * d01
    pts = torch.as_tensor(points, dtype=torch.float64, device="cuda")
    out = []
    for chunk in pts.split(512):
        d = chunk[:, None, :] - a[None]
        dist = (d * n).sum(-1).abs()
        d20, d21 = (d * e0).sum(-1), (d * e1).sum(-1)
        s = (d11 * d20 - d01 * d21) / den
        t = (d00 * d21 - d01 * d20) / den
        inside = (s >= -1e-6) & (t >= -1e-6) & (s + t <= 1 + 1e-6)
        out.append(torch.where(inside, dist, torch.inf).min(1).values)
    return torch.cat(out)


def shape_of(dataset, i) -> int:
    """The mesh index of a ShapeNet dataset's item i."""
    if hasattr(dataset, "_view"):
        return dataset._view(i)[0]
    if dataset.chosen_label is not None:
        return int(dataset.chosen_label_inds[i])
    return int(i)


def check_on_surface(dataset, scale, n_clouds=4):
    """The clouds that the dataset's get_batch draws for its first items
    (both halves, cloud and eval_cloud, undone by the config's scale)
    lie on their meshes."""
    indices = list(range(n_clouds))
    shapes = [shape_of(dataset, i) for i in indices]
    worst = 0.0
    for sample, shape in zip(dataset.get_batch(indices), shapes):
        vertices, faces = dataset._read_mesh(shape)
        for key in ("cloud", "eval_cloud"):
            pts = sample[key].T.astype("float64") * scale
            worst = max(worst, float(surface_distance(pts, vertices,
                                                      faces).max()))
    if not worst <= SURFACE_ATOL:
        fail(f"sampled clouds lie up to {worst:.3g} off their meshes' "
             f"surfaces (tolerance {SURFACE_ATOL})")
    return worst


def loader_breakdown(dataset, batch_size, reps=3):
    """Host milliseconds per batch of the data path, its parts timed
    alone on the same batches: mesh sampling (one native call), the cloud
    transforms, the image transforms (SVR), the collate, and the whole
    assembly of a batch as the loader does it (get_batch and collate)."""
    import numpy as np

    from go_with_the_flows_tpu_torch.data.loader import DataLoader, _collate

    loader = DataLoader(dataset, batch_size, shuffle=True, seed=3,
                        prefetch=0)
    chunks = [np.arange(b * batch_size, (b + 1) * batch_size)
              for b in range(min(reps, len(dataset) // batch_size))]
    parts = {"sampling": [], "clouds": [], "images": [], "collate": [],
             "batch": []}
    for chunk in chunks:
        views = [dataset._view(i) for i in chunk] \
            if hasattr(dataset, "_view") else None
        shapes = [shape_of(dataset, i) for i in chunk]
        t = time.perf_counter()
        pts = dataset._sample_batch(shapes, views[0][1] if views
                                    else shapes[0])
        parts["sampling"].append(time.perf_counter() - t)
        samples = [dataset._split(p) for p in pts]
        if views:
            raw = [dataset._image(im) for _, im in views]
            t = time.perf_counter()
            images = [dataset.image_transform(im) for im in raw]
            parts["images"].append(time.perf_counter() - t)
            for s, im in zip(samples, images):
                s["image"] = im
        t = time.perf_counter()
        samples = [dataset.cloud_transform(s) for s in samples]
        parts["clouds"].append(time.perf_counter() - t)
        t = time.perf_counter()
        _collate(samples)
        parts["collate"].append(time.perf_counter() - t)
        t = time.perf_counter()
        loader._assemble(chunk)
        parts["batch"].append(time.perf_counter() - t)
    return {k: 1000.0 * sum(v) / len(v) for k, v in parts.items() if v}


def zero(wrappers):
    for w in wrappers:
        w.launches = 0


def read(wrappers):
    return {w.__name__: w.launches for w in wrappers}


def expect_launches(stage, got, named, exact=None):
    """Fail unless each kernel named for the stage launched (exactly
    `exact[name]` times where given)."""
    for name in named:
        if got[name] == 0:
            fail(f"{stage}: {name} was not launched")
    for name, n in (exact or {}).items():
        if got[name] != n:
            fail(f"{stage}: {name} launched {got[name]} times, {n} "
                 "expected")


def same_model(stage, restored, saved_state):
    import torch

    got = restored.state_dict()
    want = saved_state.model.state_dict()
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    if sorted(got) != sorted(want) or bad:
        fail(f"{stage}: the restored model differs from the trained one "
             f"in {bad[:5]}")


def finite_metrics(stage, results):
    import math

    for res in results:
        bad = {k: v for k, v in res.items() if not math.isfinite(v)}
        if bad or not res:
            fail(f"{stage}: metrics {res}")
        if "jsd" in res and not -1e-9 <= res["jsd"] / 100.0 <= 1.0 + 1e-9:
            fail(f"{stage}: JSD {res['jsd'] / 100.0} outside [0, 1]")


class TimedLoader:
    """A DataLoader whose batches are timed on the host, per epoch: the
    main thread's wait in next() for each batch, and each batch's
    assembly on the producer thread (wall time, and that thread's own
    CPU time)."""

    def __init__(self, loader):
        self.loader = loader
        self.waits, self.prod_wall, self.prod_cpu = [], 0.0, 0.0
        assemble = loader._assemble

        def timed(chunk):
            cpu, wall = time.thread_time(), time.perf_counter()
            out = assemble(chunk)
            self.prod_cpu += time.thread_time() - cpu
            self.prod_wall += time.perf_counter() - wall
            return out

        loader._assemble = timed

    def set_epoch(self, epoch):
        self.waits, self.prod_wall, self.prod_cpu = [], 0.0, 0.0
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            self.waits.append(time.perf_counter() - t)
            yield batch


def paired_turns(dataset, batch_size, num_workers, seed, step, state, svr,
                 first_epoch, turns=3):
    """train() epochs (the loop alone: no checkpoint) over the mesh loader
    and over the same dataset's samples drawn once into memory, whose
    loader only collates, in alternating turns (memory, mesh, mesh,
    memory, ...). Per turn and loader, in ms: a step's wall time, the
    step's wall time after the first batch (whose assembly nothing
    overlaps), the main thread's wait for a batch after the first, its
    CPU time a step, the producer's wall and CPU time a batch; and the
    CPU cores the whole process kept busy (all threads' CPU time over the
    wall time)."""
    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.data.loader import DataLoader
    from go_with_the_flows_tpu_torch.train import loops

    items = []
    for b in range(0, len(dataset), batch_size):
        items += dataset.get_batch(np.arange(b, min(b + batch_size,
                                                    len(dataset))))
    loaders = {
        "memory": TimedLoader(DataLoader(items, batch_size, shuffle=True,
                                         seed=seed)),
        "mesh": TimedLoader(DataLoader(dataset, batch_size, shuffle=True,
                                       seed=seed, num_workers=num_workers))}
    out = {name: [] for name in loaders}
    epoch = first_epoch
    for turn in range(turns):
        for name in (("memory", "mesh") if turn % 2 == 0
                     else ("mesh", "memory")):
            loader = loaders[name]
            torch.cuda.synchronize()
            wall, main, proc = (time.perf_counter(), time.thread_time(),
                                time.process_time())
            state = loops.train(loader, step, state, epoch, 0, False, "cuda",
                                svr=svr)
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
            main = time.thread_time() - main
            proc = time.process_time() - proc
            n = len(loader)
            first = loader.waits[0]
            out[name].append({
                "ms": 1000.0 * wall / n,
                "ms_after_first": 1000.0 * (wall - first) / n,
                "wait": 1000.0 * sum(loader.waits[1:]) / max(n - 1, 1),
                "main_cpu": 1000.0 * main / n,
                "producer_wall": 1000.0 * loader.prod_wall / n,
                "producer_cpu": 1000.0 * loader.prod_cpu / n,
                "cores": proc / wall})
            epoch += 1
    return out


INTERP_BATCHES, INTERP_STEPS = 3, 9


def reference_state_dict(model, prefix="module."):
    """The port's model as the reference saves it (the inverse of
    utils/torch_import.py): every key under DDP's `prefix`, the K
    decoders as `pc_decoder.{k}.`, SharedDot tensors with their leading
    1, the ResNet's blocks as `layer{l}.{b}` with `downsample.{0,1}`, and
    a num_batches_tracked beside every BatchNorm; on the CPU."""
    import torch

    from go_with_the_flows_tpu_torch.ops.layers import SharedDot

    dots = {f"{name}.{p}" for name, m in model.named_modules()
            if isinstance(m, SharedDot) for p in ("weight", "bias")
            if getattr(m, p) is not None}
    out = {}

    def put(key, value):
        if key.startswith("img_encoder.layer"):
            head, block, rest = key.split(".", 2)
            stage, b = block[len("layer"):].split("_")
            rest = rest.replace("downsample_conv.", "downsample.0.").replace(
                "downsample_bn.", "downsample.1.")
            key = f"{head}.layer{stage}.{b}.{rest}"
        out[prefix + key] = value.detach().cpu().clone()
        if key.endswith(".running_mean"):
            out[prefix + key[:-len("running_mean")] + "num_batches_tracked"] \
                = torch.tensor(0)

    for key, value in model.state_dict().items():
        if key.startswith("pc_decoder."):
            for k in range(model.n_components):
                put(f"pc_decoder.{k}.{key[len('pc_decoder.'):]}",
                    value[k][None] if key in dots else value[k])
        else:
            put(key, value[None] if key in dots else value)
    return out


def import_reference(model, exp, out_dir, model_name, work):
    """Write `model` as a reference .pkl (protocol 4, DDP's keys) and
    import it with cli/import_torch_ckpt into out_dir beside exp's
    config: the import's wall seconds."""
    import torch

    from go_with_the_flows_tpu_torch.cli import import_torch_ckpt

    pkl = os.path.join(work, model_name.replace(".ckpt", ".pkl"))
    torch.save({"epoch": 1, "iter": 0,
                "model_state": reference_state_dict(model),
                "optimizer_state": {}}, pkl, pickle_protocol=4)
    t = time.perf_counter()
    import_torch_ckpt.main([pkl, os.path.join(exp, "config.yaml"), out_dir,
                            "--model_name", model_name])
    return time.perf_counter() - t


def check_interpolation(model, arrays, seed):
    """evaluate_ae's interpolation arrays against the model: shapes,
    labels in 1..K; on the first batch, the t=0 and t=1 codes equal the
    endpoints' codes bit for bit, the endpoints' interpolants equal
    kernel 1's decode of those codes bit for bit, and every step's
    interpolants equal the plain decode (point_decode_plain) of the same
    noise within 1e-4 (phase 2's tolerance). Returns that error."""
    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.eval.interpolate import (
        decode_codes, derived_seed, draw_noise, encode_codes, lerp_codes)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        film_alpha_beta, point_decode_plain)
    from go_with_the_flows_tpu_torch.train.step import eval_mode

    c1, c2 = arrays["clouds1"], arrays["clouds2"]
    interps, labels = arrays["interpolations"], arrays["labels"]
    S, _, N, steps = interps.shape
    K = model.n_components
    if (steps != INTERP_STEPS or S != INTERP_BATCHES * BATCH
            or labels.shape != (S, N, steps) or c1.shape != (S, 3, N)
            or c2.shape != (S, 3, N) or not np.isfinite(interps).all()
            or labels.min() < 1 or labels.max() > K):
        fail(f"interpolation: shapes {interps.shape}, {labels.shape}, "
             f"labels {labels.min()}..{labels.max()}")

    def gen(s):
        return torch.Generator(device="cuda").manual_seed(
            derived_seed(seed, 0, s))

    want = torch.from_numpy(interps[:BATCH])
    codes1 = encode_codes(model, torch.from_numpy(c1[:BATCH]).cuda())
    codes2 = encode_codes(model, torch.from_numpy(c2[:BATCH]).cuda())
    codes = lerp_codes(codes1, codes2, steps)
    if not (torch.equal(codes[0], codes1) and torch.equal(codes[-1], codes2)):
        fail("interpolation: the t=0 and t=1 codes differ from the "
             "endpoints' encode")
    for s, c in ((0, codes1), (steps - 1, codes2)):
        if not torch.equal(decode_codes(model, c, N, gen(s))[0].cpu(),
                           want[..., s]):
            fail(f"interpolation: step {s}'s interpolants differ from the "
                 "endpoint's decode")
    worst = 0.0
    with eval_mode(model), torch.inference_mode():
        packed = model.pack_decoder()
        for s in range(steps):
            ids, base_eps = draw_noise(gen(s), model.get_weights(codes[s]), N)
            mus, logvars = model.point_base(codes[s])
            base = mus[None] + torch.exp(0.5 * logvars)[None] * base_eps
            decoded, _ = point_decode_plain(
                packed, film_alpha_beta(packed, codes[s]), base)
            pick = ids[None, :, None, :].expand(1, BATCH, 3, N)
            plain = torch.gather(decoded, 0, pick)[0].cpu()
            worst = max(worst, (plain - want[..., s]).abs().max().item())
            if not np.array_equal(ids.cpu().numpy() + 1,
                                  labels[:BATCH, :, s]):
                fail(f"interpolation: step {s}'s labels differ from the "
                     "drawn components")
    if worst > 1e-4:
        fail(f"interpolation: kernel 1's interpolants {worst:.3g} off the "
             "plain decode (atol 1e-4)")
    return worst


FIGURES = 4  # viz/tb.py's max_figures


def check_figures(stage, logdir, prefix, steps, panels):
    """Fail unless the TensorBoard event files in `logdir` hold the images
    `prefix`/0..FIGURES-1, each written once at each of `steps`, each a
    PNG of (PANEL, panels x PANEL) pixels (viz/tb.py) painted off the
    white background in every panel; returns the painted share of the
    first image. Read back with tensorboard's EventAccumulator and
    decoded by the port's own PNG reader."""
    import numpy as np

    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            IMAGES, EventAccumulator)
    except ImportError as e:
        fail(f"{stage}: tensorboard is not installed ({e})")
    from go_with_the_flows_tpu_torch.data.png import decode_png
    from go_with_the_flows_tpu_torch.viz.tb import BACKGROUND, PANEL

    events = EventAccumulator(logdir, size_guidance={IMAGES: 0})
    events.Reload()
    tags = sorted(t for t in events.Tags()["images"]
                  if t.startswith(prefix + "/"))
    if tags != [f"{prefix}/{i}" for i in range(FIGURES)]:
        fail(f"{stage}: figure tags {tags}, {prefix}/0..{FIGURES - 1} "
             "expected")
    share = None
    for tag in tags:
        written = events.Images(tag)
        if [e.step for e in written] != list(steps):
            fail(f"{stage}: {tag} written at steps "
                 f"{[e.step for e in written]}, {list(steps)} expected")
        for e in written:
            rgb = decode_png(e.encoded_image_string)[..., :3]
            painted = (rgb != BACKGROUND).any(axis=2)
            if rgb.shape != (PANEL, panels * PANEL, 3) or not all(
                    painted[:, i * PANEL:(i + 1) * PANEL].any()
                    for i in range(panels)):
                fail(f"{stage}: {tag} at step {e.step} is {rgb.shape} with "
                     f"{int(painted.sum())} painted pixels; "
                     f"({PANEL}, {panels * PANEL}, 3) painted in each panel "
                     "expected")
            if share is None:
                share = float(painted.mean())
    return share


def phase_cli(card, loop_ms, svr_loop_ms):
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.cli import (
        evaluate_ae, reconstruct_ae, train_ae, train_svr)
    from go_with_the_flows_tpu_torch.data.synthetic import (
        synthetic_images, synthetic_meshes)
    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import nn_distance
    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_backward, emd_cost)
    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_cd_stats, pairwise_emd)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        point_decode)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.train.step import make_train_step
    from go_with_the_flows_tpu_torch.utils.config import (
        load_config, write_config)

    wrappers = (point_decode, nn_distance, pairwise_cd_stats, emd_cost,
                emd_backward, pairwise_emd, train_decode_fwd,
                train_decode_bwd)
    total = {w.__name__: 0 for w in wrappers}

    def stage(name, fn, named, exact=None):
        zero(wrappers)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        got = read(wrappers)
        expect_launches(name, got, named, exact)
        for k, n in got.items():
            total[k] += n
        say(f"    {name}: {seconds:.2f} s, launches "
            + ", ".join(f"{k} {n}" for k, n in got.items() if n)
            + f" [{card}]")
        return out, seconds

    say(f"[7] cli: train_ae, evaluate_ae, reconstruct_ae and train_svr "
        f"(their run functions) on in-memory ShapeNet layouts of "
        f"{20 * 4 ** SPHERE_LEVEL}-face meshes; the training CLIs with "
        f"logging and logging_img (the TensorBoard figures)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        # ---- the flagship: train_ae, evaluate_ae, reconstruct_ae ----
        yaml_path = os.path.join(tmp, "airplane.yaml")
        raw = load_config(os.path.join(
            ROOT, "configs", "config_generative_modeling_airplane.yaml"))
        write_config(dict(raw, path2save=os.path.join(tmp, "results"),
                          logging=True, logging_img=True), yaml_path)
        t = time.perf_counter()
        store = synthetic_meshes(n_shapes=FLAGSHIP_SHAPES,
                                 labels=raw["chosen_label"], seed=70,
                                 sphere_level=SPHERE_LEVEL)
        make_s = time.perf_counter() - t
        # scripts/train_airplane_gen.sh's first command, 1 epoch
        args = train_ae.define_options_parser().parse_args([
            yaml_path, "airplane_gen_model", "1", "0.000256",
            "--weights_type", "learned_weights", "--warmup_epoch", "5",
            "--jobid", "chip"])
        config = train_ae.configure(args)
        exp = config["logging_path"]
        if load_config(yaml_path).get("logging_path") != exp:
            fail("train_ae did not write logging_path back into its config")
        train_ds, val_ds = train_ae.build_datasets(config, seed=args.seed,
                                                   store=store)
        scale = config["cloud_scale_scale"]
        worst = check_on_surface(train_ds, scale)
        ae_load = loader_breakdown(train_ds, config["batch_size"])
        say(f"    flagship data: {FLAGSHIP_SHAPES} shapes of "
            f"{20 * 4 ** SPHERE_LEVEL} faces made in {make_s:.2f} s; "
            f"sampled clouds at most {worst:.3g} off their meshes "
            f"(tolerance {SURFACE_ATOL}); loader ms/batch at "
            f"B={config['batch_size']}: "
            + ", ".join(f"{k} {v:.2f}" for k, v in ae_load.items())
            + f" [{card}]")
        # train_ae.run imports torch.utils.tensorboard when tensorboard
        # is installed: the first time, part of its set-up
        say("    tensorboard installed: "
            f"{importlib.util.find_spec('tensorboard') is not None}")
        (state, timings), run_s = stage(
            "train_ae.run (1 epoch)",
            lambda: train_ae.run(config, train_ds, val_ds, "cuda",
                                 seed=args.seed,
                                 warmup_epoch=args.warmup_epoch),
            ["train_decode_fwd", "train_decode_bwd", "point_decode"],
            # validation's 2 batches and the figures' one
            {"train_decode_fwd": 4, "train_decode_bwd": 4,
             "point_decode": 3})
        epoch = timings[0]
        t = time.perf_counter()
        share = check_figures("train_ae's figures", os.path.join(exp, "log"),
                              "reconstruction", [0], 2)
        say(f"    train_ae's figures: reconstruction/0..{FIGURES - 1} at "
            f"epoch 0, each ground truth beside its reconstruction, "
            f"{100 * share:.1f}% of the first one's pixels painted; read "
            f"back and decoded in {time.perf_counter() - t:.2f} s")
        cli_ms = 1000.0 * epoch["train_s"] / epoch["steps"]
        rest = run_s - epoch["train_s"] - epoch["val_s"]
        say(f"    train_ae.run: set-up and close {rest:.2f} s (the model "
            f"built and moved, logging), train {epoch['train_s']:.2f} s, "
            f"validation {epoch['val_s']:.2f} s [{card}]")
        finite_metrics("train_ae", [state.train_metrics, state.val_metrics])

        def evaluate(mode, *flags, part="test", path=exp, precision=None):
            n = str(config["cloud_size"])
            eargs = evaluate_ae.define_options_parser().parse_args([
                path, "airplane_gen_model.ckpt", part, n, n, mode,
                "--weights_type", "learned_weights", "--batch_size",
                str(config["batch_size"]), *flags])
            econfig = evaluate_ae.eval_config(eargs)
            if precision is not None:  # as a key of the experiment's yaml
                econfig["eval_matmul_precision"] = precision
            dataset = evaluate_ae.build_dataset(econfig, eargs.part,
                                                seed=eargs.seed, store=store)
            return evaluate_ae.run(econfig, dataset, "cuda", reps=eargs.reps,
                                   seed=eargs.seed)

        # scripts/run_evaluate_gen.sh, 2 reps (10 there)
        (model, gen_res), gen_s = stage(
            "evaluate_ae generating --cd --emd --jsd --reps 2",
            lambda: evaluate("generating", "--reps", "2",
                             "--f1_threshold_lst", "0.0001", "--cd", "--emd",
                             "--jsd"),
            ["point_decode", "pairwise_cd_stats", "pairwise_emd"])
        same_model("evaluate_ae generating", model, state)
        finite_metrics("evaluate_ae generating", gen_res)
        (model, ae_res), ae_s = stage(
            "evaluate_ae autoencoding --cd --emd --f1",
            lambda: evaluate("autoencoding", "--cd", "--emd", "--f1"),
            ["point_decode", "nn_distance", "emd_cost"])
        same_model("evaluate_ae autoencoding", model, state)
        finite_metrics("evaluate_ae autoencoding", ae_res)
        # the same protocol with `eval_matmul_precision: fast`: kernel 1's
        # 'fast' instantiation for every decode, the metrics fp32
        by_mode = point_decode.launches_by_mode
        by_mode.update(dict.fromkeys(by_mode, 0))
        (model, fast_res), fast_s = stage(
            "evaluate_ae autoencoding --cd --emd --f1 "
            "(eval_matmul_precision: fast)",
            lambda: evaluate("autoencoding", "--cd", "--emd", "--f1",
                             precision="fast"),
            ["point_decode", "nn_distance", "emd_cost"])
        if by_mode["fast"] < 1 or by_mode["highest"] or by_mode["high"]:
            fail(f"evaluate_ae with eval_matmul_precision fast launched "
                 f"kernel 1 by mode {by_mode}")
        # the kernels line counts kernel 1 by mode
        total["point_decode"] -= by_mode["fast"]
        total["point_decode_fast"] = by_mode["fast"]
        same_model("evaluate_ae autoencoding (fast)", model, state)
        finite_metrics("evaluate_ae autoencoding (fast)", fast_res)
        say("    autoencoding at 'fast' against 'highest': " + ", ".join(
            f"{k} {fast_res[0][k]:.6g} ({ae_res[0][k]:.6g})"
            for k in ae_res[0]) + f"; {fast_s:.2f} s against {ae_s:.2f} s "
            f"[{card}]")

        # interpolation: 3 train batches of 64 shape pairs, 9 steps, the
        # arrays returned (out_path None: the card's machine has no h5py)
        steps = str(INTERP_STEPS)
        (model, (arrays,)), interp_s = stage(
            f"evaluate_ae interpolation ({INTERP_BATCHES} batches x "
            f"{steps} steps)",
            lambda: evaluate("interpolation", "--interpolation_steps", steps,
                             "--interpolation_batches",
                             str(INTERP_BATCHES), part="train"),
            ["point_decode"], {"point_decode": INTERP_BATCHES * INTERP_STEPS})
        same_model("evaluate_ae interpolation", model, state)
        interp_err = check_interpolation(model, arrays, seed=1)
        say(f"    interpolation: {arrays['interpolations'].shape} "
            f"interpolants, labels 1..{int(arrays['labels'].max())}; the "
            f"endpoints' codes and decodes bit-equal; kernel 1 against the "
            f"plain decode on batch 0, all steps: {interp_err:.3g} (atol "
            f"1e-4)")
        del arrays

        # the reference's checkpoint format: the trained model exported as
        # a .pkl, imported by cli/import_torch_ckpt, evaluated again
        imported = os.path.join(tmp, "imported_airplane")
        import_s = import_reference(state.model, exp, imported,
                                    "airplane_gen_model.ckpt", tmp)
        (model, imp_res), imp_eval_s = stage(
            "evaluate_ae autoencoding --cd --emd --f1 (imported)",
            lambda: evaluate("autoencoding", "--cd", "--emd", "--f1",
                             path=imported),
            ["point_decode", "nn_distance", "emd_cost"])
        same_model("the imported flagship model", model, state)
        if imp_res != ae_res:
            fail(f"the imported model's autoencoding metrics {imp_res} "
                 f"differ from the original's {ae_res}")
        say(f"    import: the trained model as a reference .pkl, imported "
            f"in {import_s:.2f} s; its autoencoding metrics equal the "
            f"original's bit for bit [{card}]")

        def reconstruct():
            rconfig = load_config(os.path.join(exp, "config.yaml"))
            rconfig.update(logging_path=exp,
                           model_name="airplane_gen_model.ckpt")
            dataset = reconstruct_ae.build_dataset(rconfig, "val",
                                                   store=store)
            return reconstruct_ae.run(rconfig, dataset, "cuda",
                                      batch_size=config["batch_size"])

        (samples, gts, labels), rec_s = stage(
            "reconstruct_ae", reconstruct, ["point_decode"],
            {"point_decode": 2})
        cloud = (FLAGSHIP_SHAPES["val"], 3, config["cloud_size"])
        if samples.shape != cloud or gts.shape != cloud \
                or labels.shape != (cloud[0], cloud[2]) \
                or not np.isfinite(samples).all() or labels.min() < 1 \
                or labels.max() > config["n_components"]:
            fail(f"reconstruct_ae: {samples.shape}, {gts.shape}, "
                 f"{labels.shape}, labels {labels.min()}..{labels.max()}")
        for name in ("all_samples", "all_gts", "all_labels"):
            if not os.path.isfile(os.path.join(exp, name + ".npy")):
                fail(f"reconstruct_ae wrote no {name}.npy")
        say("    generating (mean of 2 reps): " + ", ".join(
            f"{k} {np.mean([r[k] for r in gen_res]):.2f}" for k in gen_res[0])
            + "; autoencoding: " + ", ".join(
                f"{k} {v:.3f}" for k, v in ae_res[0].items())
            + "; the restored models bit-equal to the trained one")
        ae_turns = paired_turns(
            train_ds, config["batch_size"], config["num_workers"], args.seed,
            make_train_step(state.model, state.optimizer), state, False, 1)
        del state, model
        torch.cuda.empty_cache()

        # ---- SVR: train_svr, evaluate_ae reconstruction ----
        svr_yaml = os.path.join(tmp, "svr.yaml")
        raw = load_config(os.path.join(ROOT, "configs", "config_SVR.yaml"))
        # figures after the epoch's 4th step (the JAX loop's cadence,
        # 100 steps by default, is beyond a 4-step epoch)
        write_config(dict(raw, path2save=os.path.join(tmp, "results"),
                          logging=True, logging_img=True,
                          logging_img_steps=4), svr_yaml)
        t = time.perf_counter()
        hw = 137
        svr_store = {**synthetic_meshes(n_shapes=SVR_SHAPES,
                                        parts=tuple(SVR_SHAPES), seed=71,
                                        sphere_level=SPHERE_LEVEL),
                     **synthetic_images(n_shapes=SVR_SHAPES,
                                        parts=tuple(SVR_SHAPES), hw=hw,
                                        seed=72)}
        make_s = time.perf_counter() - t
        # scripts/train_all_svr.sh's first command, 1 epoch
        sargs = train_svr.define_options_parser().parse_args([
            svr_yaml, "all_svr_model", "1", "0.000256", "--weights_type",
            "learned_weights", "--warmup_epoch", "1", "--jobid", "chip"])
        sconfig = train_svr.configure(sargs)
        svr_ds = train_svr.build_dataset(sconfig, seed=sargs.seed,
                                         store=svr_store)
        worst = check_on_surface(svr_ds, sconfig["cloud_scale_scale"])
        svr_load = loader_breakdown(svr_ds, sconfig["batch_size"])
        say(f"    SVR data: {SVR_SHAPES} shapes x 24 views of {hw} x {hw} "
            f"RGBA, made in {make_s:.2f} s; sampled clouds at most "
            f"{worst:.3g} off their meshes; loader ms/batch at "
            f"B={sconfig['batch_size']}: "
            + ", ".join(f"{k} {v:.2f}" for k, v in svr_load.items())
            + f" [{card}]")
        (sstate, stimings), _ = stage(
            "train_svr.run (1 epoch)",
            lambda: train_svr.run(sconfig, svr_ds, "cuda", seed=sargs.seed,
                                  warmup_epoch=sargs.warmup_epoch),
            ["train_decode_fwd", "train_decode_bwd", "point_decode"],
            # the figures' reconstruction of one batch
            {"train_decode_fwd": 4, "train_decode_bwd": 4,
             "point_decode": 1})
        svr_cli_ms = 1000.0 * stimings[0]["train_s"] / stimings[0]["steps"]
        t = time.perf_counter()
        share = check_figures("train_svr's figures",
                              os.path.join(sconfig["logging_path"], "log"),
                              "svr_reconstruction", [4], 3)
        say(f"    train_svr's figures: svr_reconstruction/0..{FIGURES - 1} "
            f"at step 4, each image beside its ground truth and "
            f"reconstruction, {100 * share:.1f}% of the first one's pixels "
            f"painted; read back and decoded in "
            f"{time.perf_counter() - t:.2f} s")
        finite_metrics("train_svr", [sstate.train_metrics])

        def evaluate_svr(path=sconfig["logging_path"]):
            # scripts/run_evaluate_svr.sh, at the training batch
            n = str(sconfig["cloud_size"])
            eargs = evaluate_ae.define_options_parser().parse_args([
                path, "all_svr_model.ckpt", "test", n, n,
                "reconstruction", "--weights_type",
                "learned_weights", "--reps", "1", "--f1_threshold_lst",
                "0.001", "--cd", "--f1", "--emd", "--unit_scale_evaluation",
                "--batch_size", str(sconfig["batch_size"])])
            econfig = evaluate_ae.eval_config(eargs)
            dataset = evaluate_ae.build_dataset(econfig, eargs.part,
                                                seed=eargs.seed,
                                                store=svr_store)
            return evaluate_ae.run(econfig, dataset, "cuda", reps=eargs.reps,
                                   seed=eargs.seed)

        (model, rec_res), svr_eval_s = stage(
            "evaluate_ae reconstruction --cd --emd --f1 (SVR)",
            evaluate_svr, ["point_decode", "nn_distance", "emd_cost"],
            {"point_decode": 2})
        same_model("evaluate_ae reconstruction", model, sstate)
        finite_metrics("evaluate_ae reconstruction", rec_res)
        say("    SVR reconstruction: " + ", ".join(
            f"{k} {v:.6f}" for k, v in rec_res[0].items())
            + "; the restored model bit-equal to the trained one")
        # the SVR model through the reference's format; an SVR model has
        # no autoencoding sampler, so it is scored in reconstruction mode
        imported = os.path.join(tmp, "imported_svr")
        svr_import_s = import_reference(sstate.model, sconfig["logging_path"],
                                        imported, "all_svr_model.ckpt", tmp)
        (model, imp_res), svr_imp_eval_s = stage(
            "evaluate_ae reconstruction (SVR, imported)",
            lambda: evaluate_svr(imported),
            ["point_decode", "nn_distance", "emd_cost"], {"point_decode": 2})
        same_model("the imported SVR model", model, sstate)
        if imp_res != rec_res:
            fail(f"the imported SVR model's metrics {imp_res} differ from "
                 f"the original's {rec_res}")
        say(f"    import (SVR): imported in {svr_import_s:.2f} s; its "
            f"reconstruction metrics equal the original's bit for bit "
            f"[{card}]")
        svr_turns = paired_turns(
            svr_ds, sconfig["batch_size"], sconfig["num_workers"], sargs.seed,
            make_train_step(sstate.model, sstate.optimizer, svr=True),
            sstate, True, 1)
        del sstate, model

    say(f"    evaluate_ae wall s: generating (2 reps) {gen_s:.2f}, "
        f"autoencoding {ae_s:.2f}, interpolation {interp_s:.2f}, "
        f"autoencoding imported {imp_eval_s:.2f}, SVR reconstruction "
        f"{svr_eval_s:.2f}, SVR imported {svr_imp_eval_s:.2f}; "
        f"reconstruct_ae {rec_s:.2f}; imports {import_s:.2f} and "
        f"{svr_import_s:.2f} [{card}]")
    from go_with_the_flows_tpu_torch.data.native import sampler_threads

    say(f"    host: {os.cpu_count()} CPUs, {sampler_threads()} in this "
        f"process's affinity (the sampler's threads a batch, at most one a "
        f"mesh)")
    for what, phase, cli, steps, loop, turns, load in (
            (f"flagship B={config['batch_size']}", 5, cli_ms,
             epoch["steps"], loop_ms, ae_turns, ae_load),
            (f"SVR B={sconfig['batch_size']}", 6, svr_cli_ms,
             stimings[0]["steps"], svr_loop_ms, svr_turns, svr_load)):
        med = {name: {k: float(np.median([t[k] for t in runs]))
                      for k in runs[0]} for name, runs in turns.items()}
        mem = [t["ms_after_first"] for t in turns["memory"]]
        step_ms = med["memory"]["ms_after_first"]
        spread = max(mem) - min(mem)
        excess = med["mesh"]["ms_after_first"] - step_ms
        # the verdict: the loader alone against the step; then whether the
        # loop over it is slower than the in-memory loop by more than the
        # in-memory turns' own spread
        if load["batch"] >= step_ms:
            keeps = (f"does NOT keep up: the loader alone takes "
                     f"{load['batch']:.2f} ms a batch against the step's "
                     f"{step_ms:.2f}")
        elif excess > spread:
            keeps = (f"keeps up alone ({load['batch']:.2f} ms a batch "
                     f"against the step's {step_ms:.2f}), but the loop over "
                     f"it is {excess:+.2f} ms/step off the in-memory loop, "
                     f"beyond that loop's spread of {spread:.2f}")
        else:
            keeps = (f"keeps up: {load['batch']:.2f} ms a batch against the "
                     f"step's {step_ms:.2f}, and the loop over it "
                     f"{excess:+.2f} ms/step off the in-memory loop, within "
                     f"that loop's spread of {spread:.2f}")
        say(f"    {what}: the input pipeline {keeps} [{card}]")
        for name in ("memory", "mesh"):
            say(f"      {name} loader, {len(turns[name])} turns "
                f"interleaved: ms/step " + ", ".join(
                    f"{t['ms']:.2f}" for t in turns[name])
                + "; medians: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in med[name].items())
                + f" [{card}]")
        say(f"      phase {phase}'s in-memory loop " + ", ".join(
            f"{v:.2f}" for v in loop) + f" ms/step; the CLI's epoch "
            f"{cli:.2f} ms/step ({steps} steps, the first batch's assembly "
            f"and the end-of-epoch checkpoint included); the loader alone "
            f"on one thread, the config's num_workers unused by get_batch "
            f"[{card}]")
    return total


# --------------------------------------------------------------------- #
# phase 8: data-parallel training on two ranks                          #
# --------------------------------------------------------------------- #

DIST_WORLD = 2
DIST_SECONDS = 600  # the two ranks' join; a rank waits 300 s in a collective
DIST_STEPS = 3
DIST_SEED = 31
# the running statistics after the last of DIST_STEPS steps, 2 ranks
# against one process, relative to their size (floor 1e-3): those steps
# read parameters that AMSGrad moved apart by up to about 4 lr (its
# normalised step on gradients at rounding noise). About twice the
# reading on an H100 (0.0446); after the first step, from equal
# parameters, they agree to atol 1e-5 + rtol 1e-5
DIST_STAT_DRIFT = 0.1
# (g) 'fast' and (h) 'high', 2 ranks against one process: the SPMD
# kernels' dp in norm and the gradients by their largest entries (each
# side on its own residuals; TRAIN_MODE_BOUNDS for the forward), one
# step's loss (relative) and reduced gradient (by its largest entry)
DIST_MODE_BOUNDS = {
    "fast": dict(dp_norm=3e-2, grad=0.1, loss=1e-4, step_grad=3e-2),
    "high": dict(dp_norm=6e-3, grad=3e-2, loss=1e-6, step_grad=1e-3),
}


def dist_train_setup(rows, fused_decoder=None):
    """The flagship model (seed 0, jiggled running statistics) on the card
    with its optimizer and train step (the kernel path, or with
    fused_decoder=False the decoder's modules), and `rows` of the seeded
    clouds and posterior noise (B=64 in all)."""
    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train.step import make_train_step
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    model = FlowMixtureModel(**FLAGSHIP_AIRPLANE,
                             generator=torch.Generator().manual_seed(0))
    jiggle_batch_norms(model, 1000)
    model.cuda()
    opt = make_optimizer(list(model.parameters()), **TRAIN_HP)
    step = make_train_step(model, opt, fused_decoder=fused_decoder)
    rng = np.random.default_rng(DIST_SEED)
    clouds = torch.from_numpy(reference_clouds(rng, BATCH)[rows]).cuda()
    eps = torch.from_numpy(rng.standard_normal(
        (BATCH, model.g_latent_space_size)).astype(np.float32)[rows]).cuda()
    return model, opt, step, clouds, eps


def dist_steps(step, opt, model, clouds, eps):
    """DIST_STEPS train steps on one batch with given noise: the losses,
    the flat gradient of the first step (the ranks' mean, before the
    update) and the state dicts after the first and the last step, on the
    host."""
    losses, grad, states = [], None, []
    for i in range(DIST_STEPS):
        losses.append(float(step(clouds, clouds, None,
                                 posterior_eps=eps)["loss"]))
        if i in (0, DIST_STEPS - 1):
            states.append({k: v.cpu().clone()
                           for k, v in model.state_dict().items()})
        if grad is None:
            grad = opt.flat_grad.cpu().clone()
    return losses, grad, states


DIST_SVR_TIMED = 2  # SVR steps timed after the compared one


def dist_svr_setup(rows):
    """config_SVR.yaml's model (seed 0, jiggled decoder statistics) on the
    card with its optimizer and kernel-path SVR train step, and `rows` of
    seeded clouds, images (224 x 224) and posterior noise (B=128 in
    all)."""
    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.models.mixture import (
        FlowMixtureSVRModel)
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.train.step import make_train_step
    from go_with_the_flows_tpu_torch.utils.config import (
        SVR_RUN, SVR_SHAPENETALL13, svr_model_config_kwargs)

    model = FlowMixtureSVRModel(**svr_model_config_kwargs(SVR_SHAPENETALL13),
                                generator=torch.Generator().manual_seed(0))
    jiggle_batch_norms(model, 1000)
    model.cuda()
    hp = {k: SVR_RUN[k] for k in ("cycle_length", "min_lr", "max_lr",
                                  "beta1", "min_beta2", "max_beta2", "wd")}
    opt = make_optimizer(list(model.parameters()), epoch_length=4, **hp)
    step = make_train_step(model, opt, svr=True)
    rng = np.random.default_rng(DIST_SEED + 1)
    items = svr_batches(rng, SVR_RUN["batch_size"])[rows]
    clouds = torch.from_numpy(np.stack([d["cloud"] for d in items])).cuda()
    images = torch.from_numpy(np.stack([d["image"] for d in items])).cuda()
    eps = torch.from_numpy(rng.standard_normal(
        (SVR_RUN["batch_size"], model.g_latent_space_size)).astype(
            np.float32)[rows]).cuda()
    return model, step, clouds, images, eps


def running_stats(model):
    """A model's running statistics on the host."""
    return {k: v.cpu().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def dist_cli_setup(work, jobid, extra=()):
    """cli/train_ae's command line for one epoch of the flagship config
    (lr 0.000256, learned weights, warmup 5 epochs, results under
    `work`) with the flags `extra`, parsed and configured, and phase 7's
    in-memory meshes in work/store.npz: (args, config)."""
    import numpy as np

    from go_with_the_flows_tpu_torch.cli import train_ae
    from go_with_the_flows_tpu_torch.data.synthetic import synthetic_meshes
    from go_with_the_flows_tpu_torch.utils.config import (load_config,
                                                          write_config)

    yaml_path = os.path.join(work, "airplane.yaml")
    raw = load_config(os.path.join(
        ROOT, "configs", "config_generative_modeling_airplane.yaml"))
    write_config(dict(raw, path2save=os.path.join(work, "results")),
                 yaml_path)
    args = train_ae.define_options_parser().parse_args([
        yaml_path, f"airplane_{jobid}", "1", "0.000256", "--weights_type",
        "learned_weights", "--warmup_epoch", "5", "--jobid", jobid,
        *extra])
    config = train_ae.configure(args)
    np.savez(os.path.join(work, "store.npz"), **synthetic_meshes(
        n_shapes=FLAGSHIP_SHAPES, labels=raw["chosen_label"], seed=70,
        sphere_level=SPHERE_LEVEL))
    return args, config


def dist_svr_cli_setup(work):
    """cli/train_svr's command line for one epoch of config_SVR.yaml (lr
    0.000256, learned weights, warmup 1 epoch, results under `work`),
    configured, and phase 7's in-memory ShapeNetAll layout in
    work/svr_store.npz: the config."""
    import numpy as np

    from go_with_the_flows_tpu_torch.cli import train_svr
    from go_with_the_flows_tpu_torch.data.synthetic import (
        synthetic_images, synthetic_meshes)
    from go_with_the_flows_tpu_torch.utils.config import (load_config,
                                                          write_config)

    yaml_path = os.path.join(work, "svr.yaml")
    raw = load_config(os.path.join(ROOT, "configs", "config_SVR.yaml"))
    write_config(dict(raw, path2save=os.path.join(work, "results")),
                 yaml_path)
    args = train_svr.define_options_parser().parse_args([
        yaml_path, "all_svr_dist", "1", "0.000256", "--weights_type",
        "learned_weights", "--warmup_epoch", "1", "--jobid", "dist"])
    np.savez(os.path.join(work, "svr_store.npz"),
             **synthetic_meshes(n_shapes=SVR_SHAPES, parts=tuple(SVR_SHAPES),
                                seed=71, sphere_level=SPHERE_LEVEL),
             **synthetic_images(n_shapes=SVR_SHAPES, parts=tuple(SVR_SHAPES),
                                hw=137, seed=72))
    return train_svr.configure(args)


def dist_rank(rank, work, config, svr_config):
    """One rank of phase 8 (spawned): kernels 7 and 8 in their SPMD form,
    the train steps, the checkpoint and the CLI's loops on this rank's
    half of every batch, then the same for SVR (a step, cli/train_svr's
    run); the results go to work/rank<r>.pt."""
    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.cli import train_ae, train_svr
    from go_with_the_flows_tpu_torch.data.loader import DataLoader
    from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import nn_distance
    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_backward, emd_cost)
    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_cd_stats, pairwise_emd)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        point_decode)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.optim import make_optimizer
    from go_with_the_flows_tpu_torch.parallel import dist
    from go_with_the_flows_tpu_torch.train import loops
    from go_with_the_flows_tpu_torch.train.checkpoints import (
        restore_checkpoint, save_checkpoint)
    from go_with_the_flows_tpu_torch.train.state import create_train_state
    from go_with_the_flows_tpu_torch.train.step import make_sample_step
    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    torch.cuda.set_device(0)
    # gloo: NCCL refuses two ranks on one card
    dist.distributed_init("gloo", f"file://{work}/rendezvous", DIST_WORLD,
                          rank, timeout=300)
    half = BATCH // DIST_WORLD
    rows = slice(rank * half, (rank + 1) * half)
    out = {}
    try:
        # (a) kernels 7 and 8, SPMD, on this rank's half of B=64
        packed, ab, p = train_decode_inputs(FLAGSHIP_AIRPLANE, BATCH,
                                            N_POINTS, DIST_SEED)
        gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
        dp0 = torch.randn(p.shape, device="cuda", generator=gen)
        dlv = torch.randn(p.shape, device="cuda", generator=gen)
        ab, p, dp0, dlv = (t[:, rows].contiguous() for t in (ab, p, dp0, dlv))
        p0, lv, xsave, stats = train_decode_fwd(packed, ab, p)
        dp, grads, dab = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv)
        torch.cuda.synchronize()
        out["kernels"] = {"p0": p0.cpu(), "lv": lv.cpu(), "stats": stats.cpu(),
                          "dp": dp.cpu(), "dab": dab.cpu(),
                          "grads": {k: v.cpu() for k, v in grads.items()}}
        fwd_ms = cuda_ms(lambda: train_decode_fwd(packed, ab, p), 3)
        bwd_ms = cuda_ms(lambda: train_decode_bwd(packed, ab, xsave, stats,
                                                  dp0, dlv), 3)
        mom = torch.ones(p.shape[0], 9, dtype=torch.float64, device="cuda")
        out["kernel_ms"] = (fwd_ms, bwd_ms,  # and one exchange alone
                            cuda_ms(lambda: dist.sum_over_ranks(mom), 20))
        del packed, xsave, stats, dp, grads, dab, p0, lv

        # (b) the main path: train steps, then the CLI's loops; every
        # kernel's launches counted over both, and those of kernels 7 and 8
        # in their SPMD form
        wrappers = (point_decode, nn_distance, pairwise_cd_stats, emd_cost,
                    emd_backward, pairwise_emd, train_decode_fwd,
                    train_decode_bwd)
        spmd = (train_decode_fwd, train_decode_bwd)
        zero(wrappers)
        for w in spmd:
            w.spmd_launches = 0
        model, opt, step, clouds, eps = dist_train_setup(rows)
        out["steps"] = dist_steps(step, opt, model, clouds, eps)
        before = dict(dist.counts)
        step(clouds, clouds, None, posterior_eps=eps)
        out["collectives"] = {k: dist.counts[k] - before[k] for k in before}
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(DIST_STEPS):
            step(clouds, clouds, None, posterior_eps=eps)
        torch.cuda.synchronize()
        dist.barrier()
        out["step_ms"] = 1e3 * (time.perf_counter() - t) / DIST_STEPS

        # (c) a checkpoint: rank 0 writes, every rank restores
        state = create_train_state(model, opt, seed=5)
        state.step = 9
        t = time.perf_counter()
        save_checkpoint(os.path.join(work, "ckpt"), "dist.pkl", state, 2, 1)
        save_s = time.perf_counter() - t
        fresh = FlowMixtureModel(
            **FLAGSHIP_AIRPLANE,
            generator=torch.Generator().manual_seed(77)).cuda()
        fopt = make_optimizer(list(fresh.parameters()), **TRAIN_HP)
        restored = create_train_state(fresh, fopt, seed=6)
        t = time.perf_counter()
        restored, epoch, it = restore_checkpoint(
            os.path.join(work, "ckpt"), "dist.pkl", restored)
        load_s = time.perf_counter() - t
        out["ckpt"] = {
            "meta": (epoch, it, restored.step),
            "model": all(torch.equal(a, b) for a, b in zip(
                model.state_dict().values(), fresh.state_dict().values())),
            "optimizer": all(torch.equal(getattr(opt, k), getattr(fopt, k))
                             for k in opt._FLAT),
            "generator": torch.equal(restored.generator.get_state(),
                                     state.generator.get_state()),
            "seconds": (save_s, load_s)}
        del model, opt, step, fresh, fopt, state, restored

        # (d) the CLI's run (loops.train and evaluate_val over this rank's
        # loader shards, rank 0's checkpoints), then reconstruct gathered
        store = dict(np.load(os.path.join(work, "store.npz")))
        train_ds, val_ds = train_ae.build_datasets(config, seed=0,
                                                   store=store)
        # the batches of this rank's loader shards, as run's loaders take
        # them: a train step, a validation pass of kernel 1 each
        shard = dict(num_replicas=DIST_WORLD, rank=rank)
        train_steps, val_batches = (
            len(DataLoader(ds, config["batch_size"] // DIST_WORLD, **shard))
            for ds in (train_ds, val_ds))
        t = time.perf_counter()
        trained, timings = train_ae.run(config, train_ds, val_ds, "cuda",
                                        seed=0, warmup_epoch=5)
        run_s = time.perf_counter() - t
        val = DataLoader(val_ds, config["batch_size"] // DIST_WORLD,
                         shuffle=False, drop_last=False,
                         num_replicas=DIST_WORLD, rank=rank)
        sample = make_sample_step(trained.model, config["cloud_size"],
                                  mode="autoencoding")
        t = time.perf_counter()
        recon = loops.reconstruct(
            val, sample, torch.Generator(device="cuda").manual_seed(8),
            "cuda", max_batches=2)
        recon_s = time.perf_counter() - t
        out["run"] = {"timings": timings, "run_s": run_s,
                      "recon_s": recon_s, "recon": recon,
                      "train_metrics": trained.train_metrics,
                      "val_metrics": trained.val_metrics,
                      "state": {k: v.cpu() for k, v in
                                trained.model.state_dict().items()}}
        val.close()
        train_ds.close()
        val_ds.close()
        recon_points = min(2, len(val))
        del trained, sample, recon
        torch.cuda.empty_cache()

        # (e) SVR at config_SVR.yaml's width, a global B=128: one step
        # against one process (the ResNet's BatchNorms over the global
        # batch), then DIST_SVR_TIMED timed steps
        svr_rows = slice(rank * 64, (rank + 1) * 64)
        model, step, clouds, images, eps = dist_svr_setup(svr_rows)
        before = dict(dist.counts)
        loss = float(step(clouds, clouds, None, posterior_eps=eps,
                          images=images)["loss"])
        out["svr_step"] = {
            "loss": loss, "buffers": running_stats(model),
            "collectives": {k: dist.counts[k] - before[k] for k in before}}
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(DIST_SVR_TIMED):
            step(clouds, clouds, None, posterior_eps=eps, images=images)
        torch.cuda.synchronize()
        dist.barrier()
        out["svr_step"]["ms"] = (1e3 * (time.perf_counter() - t)
                                 / DIST_SVR_TIMED)
        out["svr_step"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, step, clouds, images, eps
        torch.cuda.empty_cache()

        # (f) cli/train_svr's run over this rank's loader shard of phase
        # 7's in-memory ShapeNetAll layout (its 64 images a batch
        # transformed on this rank)
        svr_store = dict(np.load(os.path.join(work, "svr_store.npz")))
        svr_ds = train_svr.build_dataset(svr_config, seed=0, store=svr_store)
        svr_steps = len(DataLoader(svr_ds, svr_config["batch_size"]
                                   // DIST_WORLD, **shard))
        t = time.perf_counter()
        strained, stimings = train_svr.run(svr_config, svr_ds, "cuda",
                                           seed=0, warmup_epoch=1)
        out["svr_run"] = {"timings": stimings,
                          "run_s": time.perf_counter() - t,
                          "train_metrics": strained.train_metrics,
                          "state": {k: v.cpu() for k, v in
                                    strained.model.state_dict().items()}}
        svr_ds.close()

        out["launches"] = read(wrappers)
        out["spmd_launches"] = {w.__name__: w.spmd_launches for w in spmd}
        # (b), run's epoch, (e) and train_svr's epoch
        steps = (2 * DIST_STEPS + 1 + train_steps + 1 + DIST_SVR_TIMED
                 + svr_steps)
        out["expect"] = dict(
            {w.__name__: 0 for w in wrappers}, train_decode_fwd=steps,
            train_decode_bwd=steps,
            # validation, the figures' batch (the airplane config's
            # logging_img: every rank reconstructs, rank 0 draws) and
            # reconstruct's 2
            point_decode=val_batches + 1 + recon_points)
        del strained
        torch.cuda.empty_cache()

        # (g) 'fast' and (h) 'high': kernels 7 and 8 in their SPMD form in
        # the mode on this rank's half, then one train step built under it
        for mode in ("fast", "high"):
            packed, ab, p = train_decode_inputs(FLAGSHIP_AIRPLANE, BATCH,
                                                N_POINTS, DIST_SEED)
            gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
            dp0 = torch.randn(p.shape, device="cuda", generator=gen)
            dlv = torch.randn(p.shape, device="cuda", generator=gen)
            ab, p, dp0, dlv = (t[:, rows].contiguous()
                               for t in (ab, p, dp0, dlv))
            p0, lv, xsave, stats = train_decode_fwd(packed, ab, p, mode)
            dp, grads, dab = train_decode_bwd(packed, ab, xsave, stats, dp0,
                                              dlv, mode)
            torch.cuda.synchronize()
            out[f"kernels_{mode}"] = {
                "p0": p0.cpu(), "lv": lv.cpu(), "stats": stats.cpu(),
                "dp": dp.cpu(), "dab": dab.cpu(),
                "grads": {k: v.cpu() for k, v in grads.items()}}
            del packed, ab, p, dp0, dlv, p0, lv, xsave, stats, dp, grads, dab
            with matmul_precision_scope(mode):
                model, opt, step, clouds, eps = dist_train_setup(rows)
            spmd_before = {w.__name__: w.spmd_launches for w in spmd}
            (loss, grad), all_n, m_n = mode_launches(spmd, lambda: (
                float(step(clouds, clouds, None, posterior_eps=eps)["loss"]),
                opt.flat_grad.cpu().clone()), mode)
            out[f"{mode}_step"] = {
                "loss": loss, "grad": grad, "launches": all_n, "mode": m_n,
                "spmd": {w.__name__: w.spmd_launches - spmd_before[w.__name__]
                         for w in spmd}}
            del model, opt, step
    finally:
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.shutdown()


def phase_dist(card):
    """Phase 8: data-parallel training, two ranks on this one card."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        _KERNEL_KEYS, train_decode_bwd, train_decode_bwd_plain,
        train_decode_fwd, train_decode_fwd_plain)
    from go_with_the_flows_tpu_torch.ops.precision import (
        matmul_precision_scope)
    from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

    say(f"[8] dist: data-parallel training of the flagship model on "
        f"{DIST_WORLD} ranks (processes, gloo) sharing this one card, a "
        f"global B={BATCH}, N={N_POINTS}")
    torch.cuda.empty_cache()
    lr = TRAIN_HP["max_lr"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as work:
        # the one-process references: kernels 7 and 8 (the single entries)
        # and their plain versions on the whole batch
        packed, ab, p = train_decode_inputs(FLAGSHIP_AIRPLANE, BATCH,
                                            N_POINTS, DIST_SEED)
        gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
        dp0 = torch.randn(p.shape, device="cuda", generator=gen)
        dlv = torch.randn(p.shape, device="cuda", generator=gen)
        one = list(train_decode_fwd(packed, ab, p))
        one_b = train_decode_bwd(packed, ab, one[2], one[3], dp0, dlv)
        plain = list(train_decode_fwd_plain(packed, ab, p))
        plain_b = train_decode_bwd_plain(packed, ab, plain[2], plain[3], dp0,
                                         dlv)
        refs = {}
        for name, f, b in (("1-process kernel", one, one_b),
                           ("plain", plain, plain_b)):
            refs[name] = {"p0": f[0].cpu(), "lv": f[1].cpu(),
                          "stats": f[3].cpu(), "dp": b[0].cpu(),
                          "dab": b[2].cpu(),
                          "grads": {k: v.cpu() for k, v in b[1].items()}}
        del packed, ab, p, dp0, dlv, one, one_b, plain, plain_b
        # ... and DIST_STEPS one-process train steps
        model, opt, step, clouds, eps = dist_train_setup(slice(None))
        one_steps = dist_steps(step, opt, model, clouds, eps)
        del model, opt, step, clouds, eps
        # ... and at 'fast' and 'high': the kernels and one step
        one_mode, one_mode_step = {}, {}
        for mode in ("fast", "high"):
            packed, ab, p = train_decode_inputs(FLAGSHIP_AIRPLANE, BATCH,
                                                N_POINTS, DIST_SEED)
            gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
            dp0 = torch.randn(p.shape, device="cuda", generator=gen)
            dlv = torch.randn(p.shape, device="cuda", generator=gen)
            f = train_decode_fwd(packed, ab, p, mode)
            b = train_decode_bwd(packed, ab, f[2], f[3], dp0, dlv, mode)
            one_mode[mode] = {
                "p0": f[0].cpu(), "lv": f[1].cpu(), "stats": f[3].cpu(),
                "dp": b[0].cpu(), "dab": b[2].cpu(),
                "grads": {k: v.cpu() for k, v in b[1].items()}}
            del packed, ab, p, dp0, dlv, f, b
            with matmul_precision_scope(mode):
                model, opt, step, clouds, eps = dist_train_setup(slice(None))
            one_mode_step[mode] = (float(step(clouds, clouds, None,
                                              posterior_eps=eps)["loss"]),
                                   opt.flat_grad.cpu().clone())
            del model, opt, step, clouds, eps
        torch.cuda.empty_cache()
        # ... and one one-process SVR step at B=128
        model, step, clouds, images, eps = dist_svr_setup(slice(None))
        one_svr = {"loss": float(step(clouds, clouds, None,
                                      posterior_eps=eps,
                                      images=images)["loss"])}
        one_svr["buffers"] = running_stats(model)
        del model, step, clouds, images, eps
        torch.cuda.empty_cache()

        # the CLIs' configs and in-memory layouts (phase 7's)
        _, config = dist_cli_setup(work, "dist")
        svr_config = dist_svr_cli_setup(work)

        t = time.perf_counter()
        ctx = mp.start_processes(dist_rank, args=(work, config, svr_config),
                                 nprocs=DIST_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t > DIST_SECONDS:
                    fail(f"the {DIST_WORLD} ranks were not done within "
                         f"{DIST_SECONDS} s")
        except mp.ProcessRaisedException as e:
            fail(f"a rank failed:\n{e}")
        except mp.ProcessExitedException as e:
            fail(f"a rank exited: {e}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks_s = time.perf_counter() - t
        got = [torch.load(os.path.join(work, f"rank{r}.pt"),
                          weights_only=False) for r in range(DIST_WORLD)]

    # (a) kernels 7 and 8: the ranks' halves against the whole batch
    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()

    k = [g["kernels"] for g in got]
    kcat = {key: torch.cat([x[key] for x in k], 1)
            for key in ("p0", "lv", "dp", "dab")}
    for name, ref in refs.items():
        errs = {key: (kcat[key] - ref[key]).abs().max().item()
                for key in ("p0", "lv")}
        stat_used = max(((x["stats"] - ref["stats"]).abs()
                         / (1e-5 + 1e-5 * ref["stats"].abs())).max().item()
                        for x in k)
        dp_norm = ((kcat["dp"] - ref["dp"]).norm() / ref["dp"].norm()).item()
        dp_far = ((kcat["dp"] - ref["dp"]).abs()
                  > 1e-3 * ref["dp"].abs().max()).float().mean().item()
        grad_rel = {key: rel(k[0]["grads"][key] + k[1]["grads"][key],
                             ref["grads"][key]) for key in _KERNEL_KEYS}
        grad_rel["ab"] = rel(kcat["dab"], ref["dab"])
        say(f"    (a) SPMD kernels 7 and 8 on {DIST_WORLD} ranks against the "
            f"{name} version at B={BATCH}: p0 {errs['p0']:.3g}, logvar "
            f"{errs['lv']:.3g} (atol 1e-4); stats {stat_used:.3g} of the "
            f"allowance atol 1e-5 + rtol 1e-5; dp in norm {dp_norm:.2g} "
            f"(3e-3), beyond 1e-3 of its max {dp_far:.2g} (3e-4); gradients "
            f"summed over the ranks, |diff| / max: " + ", ".join(
                f"d{key} {v:.2g}" for key, v in grad_rel.items())
            + " (3e-2)")
        if (max(errs.values()) > 1e-4 or stat_used > 1.0 or dp_norm > 3e-3
                or dp_far > 3e-4 or max(grad_rel.values()) > 3e-2):
            fail(f"(a) the SPMD kernels disagree with the {name} version")
    say(f"    (a) SPMD kernel 7 {got[0]['kernel_ms'][0]:.3f} ms, kernel 8 "
        f"{got[0]['kernel_ms'][1]:.3f} ms on rank 0's B={BATCH // 2} (66 "
        f"exchanges each; one exchange of a (K, 9) float64 tensor alone "
        f"{got[0]['kernel_ms'][2]:.3f} ms), both ranks' processes "
        f"time-sharing one card [{card}]")

    # (b) train steps: 2 ranks against one process; ranks bit-equal
    losses, grad, states = got[0]["steps"]
    if not all(torch.equal(a[key], b[key]) for a, b in
               zip(states, got[1]["steps"][2]) for key in a):
        fail("(b) the ranks' parameters or statistics differ after the "
             "steps")
    one_losses, one_grad, one_states = one_steps
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    grad_rel = rel(grad, one_grad)
    # the model's buffers are its BatchNorms' running statistics
    sd, one_sd = states[-1], one_states[-1]
    buffers = [n for n in sd if n.endswith(("running_mean", "running_var"))]
    # after the first step: the initial weights' global-batch statistics,
    # summed in another order; later steps start from parameters that
    # AMSGrad's normalised update moved apart (below), so after the last
    # step they are held to DIST_STAT_DRIFT of their size (floor 1e-3)
    stat_used = max(((states[0][n] - one_states[0][n]).abs()
                     / (1e-5 + 1e-5 * one_states[0][n].abs())).max().item()
                    for n in buffers)
    stat_last = max(((sd[n] - one_sd[n]).abs()
                     / one_sd[n].abs().clamp_min(1e-3)).max().item()
                    for n in buffers)
    param_err = max((sd[n] - one_sd[n]).abs().max().item()
                    for n in sd if n not in buffers)
    say(f"    (b) {DIST_STEPS} train steps, {DIST_WORLD} ranks against one "
        f"process: losses " + ", ".join(f"{v:.6f}" for v in losses)
        + f" (one process " + ", ".join(f"{v:.6f}" for v in one_losses)
        + f"), max relative diff {loss_rel:.3g} (1e-5); the reduced "
        f"gradient before the first update {grad_rel:.3g} of its max "
        f"(1e-4); running statistics after the first step {stat_used:.3g} "
        f"of the allowance atol 1e-5 + rtol 1e-5, after the last "
        f"{stat_last:.3g} of their size, floor 1e-3 ({DIST_STAT_DRIFT}); "
        f"parameters after the last "
        f"{param_err:.3g} (bound {2 * DIST_STEPS} lr = "
        f"{2 * DIST_STEPS * lr:.3g}: AMSGrad moves a parameter whose "
        f"gradient is rounding noise by up to lr a step, either way); the "
        f"ranks' parameters and statistics bit-equal")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and stat_used <= 1.0
            and stat_last <= DIST_STAT_DRIFT
            and param_err <= 2 * DIST_STEPS * lr):
        fail("(b) the 2-rank steps disagree with the one-process steps")
    coll = got[0]["collectives"]
    say(f"    (b) the 2-rank step: {got[0]['step_ms']:.2f} ms/step (rank 1 "
        f"{got[1]['step_ms']:.2f}); per step {coll['all_reduce']} "
        f"all_reduces, {coll['broadcast']} broadcasts, "
        f"{coll['all_gather']} all_gathers. Both ranks share one card "
        f"through gloo (host copies), so the time is no scaling figure "
        f"[{card}]")

    # (c) the checkpoint
    for r, g in enumerate(got):
        ck = g["ckpt"]
        if not (ck["model"] and ck["optimizer"] and ck["generator"]
                and ck["meta"] == (2, 1, 9)):
            fail(f"(c) rank {r}'s restored state differs from the saved one")
    save_s, load_s = got[0]["ckpt"]["seconds"]
    say(f"    (c) checkpoint: rank 0 saved in {save_s:.2f} s; restored on "
        f"both ranks (rank 0 reads and broadcasts) in {load_s:.2f} s; equal "
        f"to the saved state")

    # (d) the CLI's loops and the gathered reconstructions
    runs = [g["run"] for g in got]
    if not all(torch.equal(runs[0]["state"][key], runs[1]["state"][key])
               for key in runs[0]["state"]):
        fail("(d) the ranks' models differ after train_ae.run")
    if runs[0]["val_metrics"] != runs[1]["val_metrics"]:
        fail("(d) the ranks' validation means differ")
    finite_metrics("(d) train_ae.run", [runs[0]["train_metrics"],
                                        runs[0]["val_metrics"]])
    for a, b in zip(runs[0]["recon"], runs[1]["recon"]):
        if not np.array_equal(a, b):
            fail("(d) the ranks' gathered reconstructions differ")
    samples = runs[0]["recon"][0]
    if samples.shape != (2 * BATCH, 3, N_POINTS) or not np.isfinite(
            samples).all():
        fail(f"(d) reconstructions of shape {samples.shape}, finite "
             f"{np.isfinite(samples).all()}")
    epoch = runs[0]["timings"][0]
    say(f"    (d) train_ae.run on {DIST_WORLD} ranks: {epoch['steps']} steps "
        f"in {epoch['train_s']:.2f} s, validation {epoch['val_s']:.2f} s, "
        f"{runs[0]['run_s']:.2f} s in all; reconstruct of 2 global batches "
        f"gathered on both ranks in {runs[0]['recon_s']:.2f} s, equal there "
        f"[{card}]")

    # (e) the SVR step: 2 ranks against one process
    ranks = [g["svr_step"] for g in got]
    if ranks[0]["loss"] != ranks[1]["loss"] or not all(
            torch.equal(ranks[0]["buffers"][k], ranks[1]["buffers"][k])
            for k in ranks[0]["buffers"]):
        fail("(e) the ranks' SVR losses or running statistics differ")
    svr_loss_rel = abs(ranks[0]["loss"] - one_svr["loss"]) / abs(
        one_svr["loss"])
    used = {}
    for part, pick in (("ResNet", lambda k: k.startswith("img_encoder.")),
                       ("rest", lambda k: not k.startswith("img_encoder."))):
        used[part] = max(
            ((ranks[0]["buffers"][k] - v).abs()
             / (1e-5 + 1e-5 * v.abs())).max().item()
            for k, v in one_svr["buffers"].items() if pick(k))
    coll = ranks[0]["collectives"]
    say(f"    (e) SVR step at B=128 (64 a rank, 224 x 224 images), "
        f"{DIST_WORLD} ranks against one process: loss {ranks[0]['loss']:.6f} "
        f"({one_svr['loss']:.6f}), relative diff {svr_loss_rel:.3g} (1e-5); "
        f"running statistics after the step: the ResNet's "
        f"{used['ResNet']:.3g}, the others' {used['rest']:.3g} of the "
        f"allowance atol 1e-5 + rtol 1e-5; the ranks bit-equal")
    if not (svr_loss_rel <= 1e-5 and max(used.values()) <= 1.0):
        fail("(e) the 2-rank SVR step disagrees with the one-process step")
    say(f"    (e) the 2-rank SVR step: {ranks[0]['ms']:.2f} ms/step (rank 1 "
        f"{ranks[1]['ms']:.2f}), {DIST_SVR_TIMED} steps; per step "
        f"{coll['all_reduce']} all_reduces, {coll['broadcast']} broadcasts, "
        f"{coll['all_gather']} all_gathers; peak {ranks[0]['peak_gb']:.2f} "
        f"GB a rank. Both ranks share one card through gloo, so the time is "
        f"no scaling figure [{card}]")

    # (f) train_svr's run
    sruns = [g["svr_run"] for g in got]
    if not all(torch.equal(sruns[0]["state"][k], sruns[1]["state"][k])
               for k in sruns[0]["state"]):
        fail("(f) the ranks' SVR models differ after train_svr.run")
    finite_metrics("(f) train_svr.run", [sruns[0]["train_metrics"]])
    sepoch = sruns[0]["timings"][0]
    say(f"    (f) train_svr.run on {DIST_WORLD} ranks: {sepoch['steps']} steps "
        f"of B=128 (64 images transformed a rank) in "
        f"{sepoch['train_s']:.2f} s, "
        f"{1e3 * sepoch['train_s'] / max(sepoch['steps'], 1):.2f} ms/step, "
        f"{sruns[0]['run_s']:.2f} s in all; the ranks' models equal [{card}]")

    def summed(key):
        return {name: sum(g[key][name] for g in got) for name in got[0][key]}

    launches = summed("launches")
    expect_launches("phase 8's main path", launches,
                    ["train_decode_fwd", "train_decode_bwd", "point_decode"],
                    exact=summed("expect"))
    spmd = summed("spmd_launches")
    # inside the group every launch of kernels 7 and 8 is in SPMD form
    expect_launches("phase 8's main path in SPMD form", spmd, list(spmd),
                    exact={name: launches[name] for name in spmd})
    say(f"    the ranks' main path (b, d, e, f), launches summed over the "
        f"ranks: "
        + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
        + " (each as expected from the steps and batches), of them in SPMD "
        "form " + ", ".join(f"{k} {n}" for k, n in spmd.items())
        + f"; the ranks ran {ranks_s:.1f} s")

    # (g) 'fast' and (h) 'high': the SPMD kernels and one step against one
    # process
    for part, mode in (("g", "fast"), ("h", "high")):
        lim, dlim = TRAIN_MODE_BOUNDS[mode], DIST_MODE_BOUNDS[mode]
        one_k = one_mode[mode]
        kf = [g[f"kernels_{mode}"] for g in got]
        kcat = {key: torch.cat([x[key] for x in kf], 1)
                for key in ("p0", "lv", "dp", "dab")}
        errs = {key: (kcat[key] - one_k[key]).abs().max().item()
                for key in ("p0", "lv")}
        norms = {key: rel_norm(kcat[key], one_k[key]) for key in ("p0", "lv")}
        s_atol, s_rtol = lim["stats"]
        stat_used = max(((x["stats"] - one_k["stats"]).abs()
                         / (s_atol + s_rtol * one_k["stats"].abs())
                         ).max().item() for x in kf)
        dp_norm = rel_norm(kcat["dp"], one_k["dp"])
        grad_rel = {key: rel(kf[0]["grads"][key] + kf[1]["grads"][key],
                             one_k["grads"][key]) for key in _KERNEL_KEYS}
        grad_rel["ab"] = rel(kcat["dab"], one_k["dab"])
        # each side's backward runs on its own forward's residuals, which
        # the 33 couplings have moved apart (read on an H100 at 700 W, at
        # 'fast': dp 8.8e-3 in norm, the gradients at most 2.5e-2; at
        # 'high' 1.8e-3 and 1.1e-2)
        say(f"    ({part}) '{mode}' SPMD kernels 7 and 8 on {DIST_WORLD} "
            f"ranks against the 1-process '{mode}' kernels at B={BATCH}: p0 "
            f"{errs['p0']:.3g}, logvar {errs['lv']:.3g} ({lim['atol']:g}), "
            f"in norm {norms['p0']:.3g}, {norms['lv']:.3g} "
            f"({lim['norm']:g}); stats {stat_used:.3g} of the allowance "
            f"atol {s_atol:g} + rtol {s_rtol:g}; each on its own residuals, "
            f"dp in norm {dp_norm:.2g} ({dlim['dp_norm']:g}); gradients "
            f"summed over the ranks, |diff| / max: " + ", ".join(
                f"d{key} {v:.2g}" for key, v in grad_rel.items())
            + f" ({dlim['grad']:g})")
        if (max(errs.values()) > lim["atol"]
                or max(norms.values()) > lim["norm"] or stat_used > 1.0
                or dp_norm > dlim["dp_norm"]
                or max(grad_rel.values()) > dlim["grad"]):
            fail(f"({part}) the '{mode}' SPMD kernels disagree with the "
                 "one-process ones")
        fs = [g[f"{mode}_step"] for g in got]
        one_step = one_mode_step[mode]
        if fs[0]["loss"] != fs[1]["loss"]:
            fail(f"({part}) the ranks' '{mode}' losses differ")
        loss_rel = abs(fs[0]["loss"] - one_step[0]) / abs(one_step[0])
        step_grad = rel(fs[0]["grad"], one_step[1])
        mode_n = {k: sum(x["mode"][k] for x in fs) for k in fs[0]["mode"]}
        say(f"    ({part}) one '{mode}' step, {DIST_WORLD} ranks against one "
            f"process: loss {fs[0]['loss']:.6f} ({one_step[0]:.6f}), "
            f"relative diff {loss_rel:.3g} ({dlim['loss']:g}); the reduced "
            f"gradient {step_grad:.3g} of its max ({dlim['step_grad']:g}); "
            f"'{mode}' launches summed over the ranks {mode_n}, in SPMD form "
            + ", ".join(f"{k} {sum(x['spmd'][k] for x in fs)}"
                        for k in fs[0]["spmd"]))
        if loss_rel > dlim["loss"] or step_grad > dlim["step_grad"]:
            fail(f"({part}) the 2-rank '{mode}' step disagrees with the "
                 "one-process step")
        for x in fs:
            if x["mode"] != {f"{k}_{mode}": 1 for k in x["spmd"]} or x[
                    "spmd"] != dict.fromkeys(x["spmd"], 1) or x[
                    "launches"] != dict.fromkeys(x["spmd"], 1):
                fail(f"({part}) a rank's '{mode}' step launched "
                     f"{x['launches']}, of them '{mode}' {x['mode']}, in "
                     f"SPMD form {x['spmd']}")
        launches.update(mode_n)
    phase_points(card, got[0]["step_ms"])
    return launches


# (i) the points axis: a (data, points) = (1, 2) grid of 2 ranks on this
# card, each rank the whole batch's clouds and half of their points
POINTS_GRID = (1, 2)
POINTS_TIMED = 2  # steps timed after the compared one


def points_rank(rank, work):
    """One rank of phase 8 (i) (spawned): the flagship's module-path train
    step on a (1, 2) grid, the rank's half of every cloud's points, then
    the fused path's refusal there. The results go to
    work/points<r>.pt."""
    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.parallel import dist
    from go_with_the_flows_tpu_torch.train.step import (FUSED_POINTS_ERROR,
                                                        make_train_step)

    torch.cuda.set_device(0)
    out = {}
    try:
        dist.distributed_init("gloo", f"file://{work}/rendezvous_points",
                              DIST_WORLD, rank, timeout=300,
                              points_parallelism=POINTS_GRID[1])
        zero((train_decode_fwd, train_decode_bwd))
        model, opt, step, clouds, eps = dist_train_setup(
            slice(None), fused_decoder=False)
        mine = dist.place_batch({"cloud": clouds}, "cuda",
                                shard_points=True)["cloud"]
        before = dict(dist.counts)
        loss = float(step(mine, mine, None, posterior_eps=eps)["loss"])
        out["points"] = {
            "grid": (dist.data_size(), dist.points_size()),
            "shape": tuple(mine.shape), "loss": loss,
            "grad": opt.flat_grad.cpu().clone(),
            "stats": running_stats(model),
            "collectives": {k: dist.counts[k] - before[k] for k in before}}
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(POINTS_TIMED):
            step(mine, mine, None, posterior_eps=eps)
        torch.cuda.synchronize()
        dist.barrier()
        out["points"]["ms"] = 1e3 * (time.perf_counter() - t) / POINTS_TIMED
        out["points"]["launches"] = read((train_decode_fwd, train_decode_bwd))
        try:  # the card's default: kernels 7 and 8, refused on the grid
            make_train_step(model, opt)(mine, mine, None, posterior_eps=eps)
            out["refusal"] = None
        except NotImplementedError as e:
            out["refusal"] = str(e) == FUSED_POINTS_ERROR
    finally:
        torch.save(out, os.path.join(work, f"points{rank}.pt"))
        dist.shutdown()


def phase_points(card, rows_ms=None):
    """Phase 8 (i): the points axis (parallel/dist.py's grid, the JAX
    mesh's `points`): one flagship step at B=64, N=2048 on the decoder's
    modules over a (1, 2) grid against one process on the card (the
    loss, the flat gradient before the update, the running statistics),
    the fused path refused there, and the step's time beside the same
    step in one process and `rows_ms`, phase 8 (b)'s 2-rank step on a
    (2, 1) grid (kernels 7 and 8 in SPMD form)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    say(f"    (i) the points axis: a {POINTS_GRID} (data, points) grid of "
        f"{DIST_WORLD} ranks on this card, the flagship's module-path step "
        f"at B={BATCH}, N={N_POINTS} ({N_POINTS // POINTS_GRID[1]} points a "
        "rank)")
    torch.cuda.empty_cache()
    model, opt, step, clouds, eps = dist_train_setup(slice(None),
                                                     fused_decoder=False)
    one = {"loss": float(step(clouds, clouds, None,
                              posterior_eps=eps)["loss"]),
           "grad": opt.flat_grad.cpu().clone(), "stats": running_stats(model)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(POINTS_TIMED):
        step(clouds, clouds, None, posterior_eps=eps)
    torch.cuda.synchronize()
    one["ms"] = 1e3 * (time.perf_counter() - t) / POINTS_TIMED
    del model, opt, step, clouds, eps
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_points_") as work:
        t = time.perf_counter()
        ctx = mp.start_processes(points_rank, args=(work,),
                                 nprocs=DIST_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t > DIST_SECONDS:
                    fail(f"(i) the {DIST_WORLD} ranks were not done within "
                         f"{DIST_SECONDS} s")
        except mp.ProcessRaisedException as e:
            fail(f"(i) a rank failed:\n{e}")
        except mp.ProcessExitedException as e:
            fail(f"(i) a rank exited: {e}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        got = [torch.load(os.path.join(work, f"points{r}.pt"),
                          weights_only=False) for r in range(DIST_WORLD)]

    pts = [g["points"] for g in got]
    if pts[0]["loss"] != pts[1]["loss"] or not all(
            torch.equal(pts[0]["stats"][k], pts[1]["stats"][k])
            for k in pts[0]["stats"]):
        fail("(i) the ranks' losses or running statistics differ")
    if pts[0]["grid"] != POINTS_GRID or pts[0]["shape"] != (
            BATCH, 3, N_POINTS // POINTS_GRID[1]):
        fail(f"(i) grid {pts[0]['grid']}, a rank's clouds {pts[0]['shape']}")
    loss_rel = abs(pts[0]["loss"] - one["loss"]) / abs(one["loss"])
    grad_rel = ((pts[0]["grad"].double() - one["grad"].double()).abs().max()
                / one["grad"].double().abs().max()).item()
    stat_used = max(((pts[0]["stats"][k] - v).abs()
                     / (1e-6 + 1e-5 * v.abs())).max().item()
                    for k, v in one["stats"].items())
    coll = pts[0]["collectives"]
    say(f"    (i) one step on the (1, 2) grid against one process: loss "
        f"{pts[0]['loss']:.6f} ({one['loss']:.6f}), relative diff "
        f"{loss_rel:.3g} (rtol 1e-4); the reduced gradient {grad_rel:.3g} of "
        f"its max (1e-4); running statistics {stat_used:.3g} of the "
        f"allowance rtol 1e-5 + atol 1e-6; the ranks bit-equal; per step "
        f"{coll['all_reduce']} all_reduces, {coll['all_gather']} "
        f"all_gathers, {coll['broadcast']} broadcasts")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-4 and stat_used <= 1.0):
        fail("(i) the points-split step disagrees with one process")
    if any(n for g in pts for n in g["launches"].values()):
        fail(f"(i) the module-path step launched kernels 7 and 8: "
             f"{[g['launches'] for g in pts]}")
    if not all(g["refusal"] for g in got):
        fail(f"(i) the fused path on the (1, 2) grid: refused with JAX's "
             f"message {[g['refusal'] for g in got]} (None: not refused)")
    rows = "" if rows_ms is None else (
        f"; (b)'s kernel-path step on the (2, 1) grid {rows_ms:.2f} ms")
    say(f"    (i) the module-path step at B={BATCH}, N={N_POINTS}: "
        f"{pts[0]['ms']:.2f} ms on the (1, 2) grid (rank 1 "
        f"{pts[1]['ms']:.2f}), {one['ms']:.2f} ms in one process, "
        f"{POINTS_TIMED} steps each after the compared one{rows}. The ranks "
        f"share one card through gloo (host copies): no scaling figure. The "
        f"fused path refused on the (1, 2) grid with the JAX step's "
        f"message; {time.perf_counter() - t0:.1f} s in all [{card}]")


# --------------------------------------------------------------------- #
# --cards N: the data-parallel launch on N cards, NCCL between them      #
# --------------------------------------------------------------------- #

def nccl_rank(device, config, work):
    """One rank of the --cards run, as cli.run_ranks starts it (device
    cuda:<local>, its process group NCCL): train_ae.run over this rank's
    loader shards of the in-memory layout, then reconstruct gathered;
    the results go to work/nccl<rank>.pt."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from go_with_the_flows_tpu_torch.cli import train_ae
    from go_with_the_flows_tpu_torch.data.loader import DataLoader
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        point_decode)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.parallel import dist
    from go_with_the_flows_tpu_torch.train import loops
    from go_with_the_flows_tpu_torch.train.step import make_sample_step

    world, rank = dist.world_size(), dist.rank()
    store = dict(np.load(os.path.join(work, "store.npz")))
    train_ds, val_ds = train_ae.build_datasets(config, seed=0, store=store)
    try:
        t = time.perf_counter()
        trained, timings = train_ae.run(config, train_ds, val_ds, device,
                                        seed=0, warmup_epoch=5)
        run_s = time.perf_counter() - t
        val = DataLoader(val_ds, config["batch_size"] // world,
                         shuffle=False, drop_last=False, num_replicas=world,
                         rank=rank)
        sample = make_sample_step(trained.model, config["cloud_size"],
                                  mode="autoencoding")
        recon = loops.reconstruct(
            val, sample, torch.Generator(device=device).manual_seed(8),
            device, max_batches=2)
        val.close()
        out = {"backend": tdist.get_backend(), "device": str(device),
               "world": world, "timings": timings, "run_s": run_s,
               "val_metrics": trained.val_metrics,
               "train_metrics": trained.train_metrics, "recon": recon,
               "state": {k: v.cpu() for k, v in
                         trained.model.state_dict().items()},
               "launches": {w.__name__: w.launches for w in
                            (train_decode_fwd, train_decode_bwd,
                             point_decode)},
               "spmd_launches": {w.__name__: w.spmd_launches for w in
                                 (train_decode_fwd, train_decode_bwd)},
               "collectives": dict(dist.counts)}
    finally:
        train_ds.close()
        val_ds.close()
    torch.save(out, os.path.join(work, f"nccl{rank}.pt"))


def phase_nccl(card, cards):
    """cli/train_ae's data-parallel launch (cli.run_ranks, as
    `--distributed -n 1 -g <cards>` starts it) on `cards` cards of this
    host, one rank a card and NCCL between them, at the flagship's width
    and global B=64: one epoch of train_ae.run (the train steps,
    evaluate_val's count-weighted reduce of CPU sums, rank 0's
    checkpoints), then reconstruct gathered on every rank."""
    import tempfile

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.cli import run_ranks

    if torch.cuda.device_count() < cards:
        fail(f"--cards {cards}: this host has "
             f"{torch.cuda.device_count()} cards")
    say(f"[nccl] train_ae --distributed -n 1 -g {cards}: the flagship "
        f"model on {cards} cards, one rank a card, a global B={BATCH}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as work:
        args, config = dist_cli_setup(work, "nccl", [
            "--distributed", "-n", "1", "-g", str(cards), "--coordinator",
            f"file://{work}/rendezvous"])
        t = time.perf_counter()
        try:
            run_ranks(args, nccl_rank, config, work)
        except Exception as e:  # noqa: BLE001  (fails the run)
            fail(f"a rank failed:\n{e}")
        ranks_s = time.perf_counter() - t
        got = [torch.load(os.path.join(work, f"nccl{r}.pt"),
                          weights_only=False) for r in range(cards)]

    devices = [g["device"] for g in got]
    if {g["backend"] for g in got} != {"nccl"} or len(set(devices)) != cards:
        fail(f"backends {[g['backend'] for g in got]} on {devices}: one "
             "NCCL rank a card expected")
    for r, g in enumerate(got[1:], 1):
        if not all(torch.equal(got[0]["state"][k], g["state"][k])
                   for k in g["state"]):
            fail(f"rank {r}'s model differs from rank 0's after the epoch")
        if g["val_metrics"] != got[0]["val_metrics"]:
            fail(f"rank {r}'s validation means differ from rank 0's")
        if not all(np.array_equal(a, b)
                   for a, b in zip(got[0]["recon"], g["recon"])):
            fail(f"rank {r}'s gathered reconstructions differ")
    finite_metrics("train_ae.run on NCCL", [got[0]["train_metrics"],
                                            got[0]["val_metrics"]])
    samples = got[0]["recon"][0]
    if samples.shape != (2 * BATCH, 3, N_POINTS) or not np.isfinite(
            samples).all():
        fail(f"reconstructions of shape {samples.shape}, finite "
             f"{np.isfinite(samples).all()}")
    for r, g in enumerate(got):
        steps = g["timings"][0]["steps"]
        for name, n in g["spmd_launches"].items():
            if not steps or n != g["launches"][name] or n < steps:
                fail(f"rank {r}: {name} launched {g['launches'][name]} "
                     f"times, {n} in SPMD form, over {steps} steps")
    epoch = got[0]["timings"][0]
    say(f"    {cards} NCCL ranks on {devices}: {epoch['steps']} steps in "
        f"{epoch['train_s']:.2f} s, validation {epoch['val_s']:.2f} s "
        f"(means {', '.join(f'{k} {v:.6f}' for k, v in got[0]['val_metrics'].items())}), "
        f"{got[0]['run_s']:.2f} s in all; models, validation means and "
        f"the gathered reconstructions equal on every rank; rank 0's "
        f"launches {got[0]['launches']}, collectives "
        f"{got[0]['collectives']}; the ranks ran {ranks_s:.1f} s [{card}]")


# --------------------------------------------------------------------- #
# phase 9: the matmul precision modes on the sampling path              #
# --------------------------------------------------------------------- #

AB_STEPS, AB_S = 20, 64  # eval_precision_ab.run's size here
# train_quality_ab.run's size here: steps, B (its 'xla' variant's autograd
# holds every coupling's activations), S
QA_STEPS, QA_B, QA_S = 20, 16, 16
# tools/train_convergence_ab.run's and tools/svr_quality_ab.run's sizes
# here: 20 steps each, the convergence A/B at half its batch
CA_STEPS, CA_B, CA_LOG = 20, 32, 10
SA_STEPS = 20
SVR_IMAGES = 8


def phase_precision(card):
    """The flagship's sample steps built under each mode, SVR
    reconstruction under 'high', eval_precision_ab.run (which trains at
    'high') and train_quality_ab.run; returns the launches of every
    kernel, kernels 1, 7 and 8 by mode."""
    import math

    import numpy as np
    import torch

    from go_with_the_flows_tpu_torch.metrics.evaluation import (
        EMD_CD_F1, pairwise_EMD_CD_F1)
    from go_with_the_flows_tpu_torch.models.mixture import (
        FlowMixtureSVRModel)
    from go_with_the_flows_tpu_torch.ops.kernels import (
        point_decode as pd_module)
    from go_with_the_flows_tpu_torch.ops.kernels.chamfer import nn_distance
    from go_with_the_flows_tpu_torch.ops.kernels.emd import (
        emd_backward, emd_cost)
    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_cd_stats, pairwise_emd)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.ops.precision import (
        get_matmul_precision, matmul_precision_scope)
    from go_with_the_flows_tpu_torch.tools import (eval_precision_ab,
                                                   svr_quality_ab,
                                                   train_convergence_ab,
                                                   train_quality_ab)
    from go_with_the_flows_tpu_torch.train.step import make_sample_step
    from go_with_the_flows_tpu_torch.utils.config import (
        FLAGSHIP_AIRPLANE, SVR_RUN, SVR_SHAPENETALL13,
        svr_model_config_kwargs)

    say("[9] precision: the sampling path in each matmul precision mode")
    point_decode = pd_module.point_decode
    by_mode = point_decode.launches_by_mode
    wrappers = (point_decode, nn_distance, pairwise_cd_stats, emd_cost,
                emd_backward, pairwise_emd, train_decode_fwd,
                train_decode_bwd)
    launches = dict.fromkeys((w.__name__ for w in wrappers), 0)
    moded = (point_decode, train_decode_fwd, train_decode_bwd)
    launches.update({f"{w.__name__}_{m}": 0 for w in moded
                     for m in ("high", "fast")})

    def count(fn):
        """fn() with the kernels' counters set to 0 before and added into
        `launches` after; kernels 1, 7 and 8 by mode."""
        zero(wrappers)
        for w in moded:
            w.launches_by_mode.update(dict.fromkeys(w.launches_by_mode, 0))
        out = fn()
        torch.cuda.synchronize()
        for k, n in read(wrappers).items():
            launches[k] += n
        for w in moded:
            for mode in ("high", "fast"):
                launches[w.__name__] -= w.launches_by_mode[mode]
                launches[f"{w.__name__}_{mode}"] += w.launches_by_mode[mode]
        return out, dict(by_mode)

    # a plain decode on a CUDA tensor would be a fallback: fail on one
    plain = pd_module.point_decode_plain

    def no_fallback(packed, ab, p, *args, **kwargs):
        if p.is_cuda:
            fail("point_decode ran its plain version on a CUDA tensor")
        return plain(packed, ab, p, *args, **kwargs)

    pd_module.point_decode_plain = no_fallback
    try:
        t0 = time.perf_counter()
        model = make_model(FLAGSHIP_AIRPLANE, 0, "cuda")
        rng = np.random.default_rng(90)
        g_in = torch.from_numpy(reference_clouds(rng, BATCH)).cuda()
        ref = reference_clouds(rng, BATCH).transpose(0, 2, 1).copy()
        samples, paired = {}, {}
        for mode in MODES:
            with matmul_precision_scope(mode):
                gen_step = make_sample_step(model, N_POINTS, "generating")
                ae_step = make_sample_step(model, N_POINTS, "autoencoding")
            if get_matmul_precision() != "highest":
                fail("building a step changed the current mode")
            for name, step in (("generating", gen_step),
                               ("autoencoding", ae_step)):
                gen = torch.Generator(device="cuda").manual_seed(91)
                (out, _, _), got = count(lambda: step(g_in, gen))
                want = {m: int(m == mode) for m in MODES}
                if got != want:
                    fail(f"{name} step built under {mode!r}, called under "
                         f"'highest': kernel 1 launched by mode {got}")
                if not bool(torch.isfinite(out).all()) \
                        or tuple(out.shape) != (BATCH, 3, N_POINTS):
                    fail(f"{name} step under {mode!r}: not finite or of "
                         f"shape {tuple(out.shape)}")
                samples[mode, name] = out.transpose(1, 2).cpu().numpy()
            ms = cuda_ms(lambda: gen_step(g_in, gen), 5)
            paired[mode] = EMD_CD_F1(
                samples[mode, "autoencoding"],
                g_in.transpose(1, 2).cpu().numpy(), BATCH, cd_option=True,
                emd_option=True, f1_option=True, f1_threshold=1e-4,
                device="cuda")
            drift = {n: float(np.abs(samples[mode, n]
                                     - samples["highest", n]).max())
                     for n in ("generating", "autoencoding")}
            say(f"    {mode}: generating step B={BATCH} {ms:.2f} ms; drift "
                f"from 'highest' generating {drift['generating']:.3g}, "
                f"autoencoding {drift['autoencoding']:.3g}; autoencoding "
                f"CD x1e4 {1e4 * float(paired[mode]['CD']):.6g}, EMD x1e2 "
                f"{1e2 * float(paired[mode]['EMD']):.6g}, F1@1e-4 "
                f"{float(paired[mode]['F1']):.6g} [{card}]")
        # the metric kernels (2-5) take fp32 in every mode: equal bits on
        # the same clouds
        a = samples["highest", "generating"]
        metrics = {}
        for mode in MODES:
            with matmul_precision_scope(mode):
                metrics[mode], _ = count(lambda: (
                    EMD_CD_F1(a, ref, BATCH, cd_option=True, emd_option=True,
                              f1_option=True, reduced=False, device="cuda"),
                    pairwise_EMD_CD_F1(a[:16], ref[:16], 16, cd_option=True,
                                       emd_option=True, f1_option=True,
                                       device="cuda")))
        for mode in ("high", "fast"):
            for x, y in zip(
                    [metrics[mode][0][k] for k in ("CD", "EMD", "F1")]
                    + list(metrics[mode][1]),
                    [metrics["highest"][0][k] for k in ("CD", "EMD", "F1")]
                    + list(metrics["highest"][1])):
                if not np.array_equal(np.asarray(x), np.asarray(y)):
                    fail(f"a metric differs between {mode!r} and "
                         "'highest'")
        say("    paired CD/EMD/F1 of 64 pairs and the 16 x 16 CD/EMD/F1 "
            "grids: equal bits in every mode")
        flag_s = time.perf_counter() - t0

        # SVR reconstruction under 'high': the ResNet's convolutions as
        # three bf16 passes, kernel 1's 'high' instantiation
        t0 = time.perf_counter()
        svr = FlowMixtureSVRModel(
            **svr_model_config_kwargs(SVR_SHAPENETALL13),
            generator=torch.Generator().manual_seed(92))
        jiggle_batch_norms(svr, 93)
        svr = svr.cuda().eval()
        n_svr = SVR_RUN["cloud_size"]
        gen = torch.Generator(device="cuda").manual_seed(94)
        images = torch.rand(SVR_IMAGES, 4, 224, 224, device="cuda",
                            generator=gen)
        g0 = torch.zeros(SVR_IMAGES, 3, n_svr, device="cuda")
        recon = {}
        for mode in ("highest", "high"):
            with matmul_precision_scope(mode):
                step = make_sample_step(svr, n_svr, "reconstruction",
                                        svr=True)
            gen = torch.Generator(device="cuda").manual_seed(95)
            (out, _, _), got = count(lambda: step(g0, gen, images=images))
            if got != {m: int(m == mode) for m in MODES}:
                fail(f"SVR reconstruction under {mode!r}: kernel 1 by mode "
                     f"{got}")
            if not bool(torch.isfinite(out).all()):
                fail(f"SVR reconstruction under {mode!r} is not finite")
            recon[mode] = out
            ms = cuda_ms(lambda: step(g0, gen, images=images), 3)
            say(f"    SVR reconstruction of {SVR_IMAGES} images under "
                f"{mode!r}: {ms:.2f} ms a batch [{card}]")
        say(f"    SVR 'high' against 'highest': max |diff| "
            f"{(recon['high'] - recon['highest']).abs().max().item():.3g}")
        del svr
        svr_s = time.perf_counter() - t0

        # the A/B tool at a short size
        t0 = time.perf_counter()
        results, _ = count(lambda: eval_precision_ab.run(
            FLAGSHIP_AIRPLANE, N_POINTS, AB_STEPS, BATCH, AB_S, 1, MODES,
            "cuda"))
        for mode, agg in results.items():
            for k, (mu, _) in agg.items():
                if not math.isfinite(mu):
                    fail(f"eval_precision_ab: {mode} {k} = {mu}")
        if results["highest"]["max_point_drift_vs_first_mode"][0] != 0.0:
            fail("eval_precision_ab: 'highest' drifts from itself")
        say("    eval_precision_ab (20 steps at 'high', S=64, 1 rep): "
            + json.dumps(results))
        ab_s = time.perf_counter() - t0

        # the training A/B at a short size: its three variants, each
        # trained and scored
        t0 = time.perf_counter()
        before = {k: launches[k] for k in launches}
        qa, _ = count(lambda: train_quality_ab.run(
            FLAGSHIP_AIRPLANE, N_POINTS, QA_STEPS, QA_B, QA_S, 1,
            train_quality_ab.VARIANTS, "high", "cuda"))
        qa_n = {k: launches[k] - before[k] for k in launches}
        if set(qa) != set(train_quality_ab.VARIANTS):
            fail(f"train_quality_ab ran the variants {sorted(qa)}")
        for variant, rec in qa.items():
            if set(rec) != {"train_wall_s", "steps_per_s", "final_loss",
                            "loss_curve", "metrics"} or not all(
                    math.isfinite(mu) for mu, _ in rec["metrics"].values()):
                fail(f"train_quality_ab {variant}: {rec}")
            say(f"    train_quality_ab {variant} ({QA_STEPS} steps at "
                f"B={QA_B}, S={QA_S}, 1 rep): {rec['steps_per_s']} steps/s, "
                f"loss curve {rec['loss_curve']}, metrics "
                + json.dumps({k: round(mu, 6) for k, (mu, _)
                              in rec["metrics"].items()}) + f" [{card}]")
        # 'xla' trains through the modules; each 'fused' variant through
        # kernels 7 and 8 in its mode, once a step
        for name in ("train_decode_fwd", "train_decode_bwd"):
            if (qa_n[name] or qa_n[name + "_high"] != QA_STEPS
                    or qa_n[name + "_fast"] != QA_STEPS):
                fail(f"train_quality_ab launched {name} {qa_n[name]}, at "
                     f"'high' {qa_n[name + '_high']}, at 'fast' "
                     f"{qa_n[name + '_fast']}; {QA_STEPS} a fused variant "
                     "expected")
        qa_s = time.perf_counter() - t0

        # the convergence A/B at a short size: the modules at 'highest',
        # kernels 7 and 8 at 'high' and at 'fast', once a step
        t0 = time.perf_counter()
        before = dict(launches)
        ca, _ = count(lambda: train_convergence_ab.run(
            CA_STEPS, CA_B, CA_LOG))
        ca_n = {k: launches[k] - before[k] for k in launches}
        if [x["variant"] for x in ca] != list(train_convergence_ab.VARIANTS):
            fail(f"train_convergence_ab ran {[x['variant'] for x in ca]}")
        for x in ca:
            if set(x) != {"variant", "steps", "losses", "wall_s"} or [
                    i for i, _ in x["losses"]] != [1, 10, 20] or not all(
                    math.isfinite(v) for _, v in x["losses"]):
                fail(f"train_convergence_ab: {x}")
        for name in ("train_decode_fwd", "train_decode_bwd"):
            if (ca_n[name] or ca_n[name + "_high"] != CA_STEPS
                    or ca_n[name + "_fast"] != CA_STEPS):
                fail(f"train_convergence_ab launched {name} {ca_n[name]}, "
                     f"at 'high' {ca_n[name + '_high']}, at 'fast' "
                     f"{ca_n[name + '_fast']}; {CA_STEPS} a fused variant "
                     "expected")
        ca_s = time.perf_counter() - t0
        say(f"    train_convergence_ab ({CA_STEPS} steps at B={CA_B}): "
            + "; ".join(f"{x['variant']} {x['losses']} in {x['wall_s']} s"
                        for x in ca) + f"; {ca_s:.1f} s [{card}]")

        # the SVR A/B at a short size: kernels 7 and 8 at 'highest' and
        # 'fast', then kernel 1 at 'high' and kernels 2 and 5 scoring
        t0 = time.perf_counter()
        before = dict(launches)
        sa, _ = count(lambda: svr_quality_ab.run(steps=SA_STEPS))
        sa_n = {k: launches[k] - before[k] for k in launches}
        if list(sa) != ["highest", "fast"]:
            fail(f"svr_quality_ab ran the modes {list(sa)}")
        for mode, rec in sa.items():
            keys = ("final_loss", "recon_CD_x1e4", "recon_EMD_x1e2",
                    "recon_F1")
            if set(rec) != {"wall_s", "loss_curve", *keys} or not all(
                    math.isfinite(rec[k]) for k in keys) or not all(
                    math.isfinite(v) for _, v in rec["loss_curve"]):
                fail(f"svr_quality_ab {mode}: {rec}")
        want = {"train_decode_fwd": SA_STEPS, "train_decode_fwd_fast":
                SA_STEPS, "train_decode_bwd": SA_STEPS,
                "train_decode_bwd_fast": SA_STEPS, "point_decode_high": 2}
        if any(sa_n[k] != n for k, n in want.items()) or not (
                sa_n["nn_distance"] and sa_n["emd_cost"]):
            fail(f"svr_quality_ab launched {sa_n}; {want} and kernels 2 "
                 "and 5 expected")
        sa_s = time.perf_counter() - t0
        say(f"    svr_quality_ab ({SA_STEPS} steps at B=16, 64 shapes "
            f"scored at 'high'): {json.dumps(sa)}; {sa_s:.1f} s [{card}]")
    finally:
        pd_module.point_decode_plain = plain
    say(f"    phase 9 seconds: flagship steps and metrics {flag_s:.1f}, "
        f"SVR {svr_s:.1f}, eval_precision_ab {ab_s:.1f}, train_quality_ab "
        f"{qa_s:.1f}, train_convergence_ab {ca_s:.1f}, svr_quality_ab "
        f"{sa_s:.1f}; launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
    for mode in ("high", "fast"):
        if launches["point_decode_" + mode] < 1:
            fail(f"kernel 1's {mode!r} instantiation was not launched")
    if launches["train_decode_fwd_high"] < AB_STEPS + QA_STEPS:
        fail("eval_precision_ab did not train through kernels 7 and 8 at "
             "'high'")
    return launches


def phase_tools(card):
    """Phase 10: tools/protocol_bench.run at the airplane protocol's size
    (405 x 405 clouds of 2048 points, EMD on), its line printed and an 8
    x 8 corner of its CD and EMD matrices held against the plain
    versions; tools/train_breakdown.run at B=64 in all three modes, its
    three lines printed, every value finite and positive. Returns the
    launches of every kernel, kernels 1, 7 and 8 by mode."""
    import math

    import torch

    from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
        pairwise_cd_stats, pairwise_cd_stats_plain, pairwise_emd,
        pairwise_emd_plain)
    from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
        point_decode)
    from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
        train_decode_bwd, train_decode_fwd)
    from go_with_the_flows_tpu_torch.tools import (protocol_bench,
                                                   train_breakdown)

    say("[10] tools: protocol_bench at 405 x 405 clouds of 2048 points "
        "with EMD; train_breakdown at B=64 in each mode")
    wrappers = (point_decode, pairwise_cd_stats, pairwise_emd,
                train_decode_fwd, train_decode_bwd)
    moded = (point_decode, train_decode_fwd, train_decode_bwd)
    launches = dict.fromkeys((w.__name__ for w in wrappers), 0)
    launches.update({f"{w.__name__}_{m}": 0 for w in moded
                     for m in ("high", "fast")})

    def count(fn):
        """fn() with the kernels' counters set to 0 before and added into
        `launches` after (kernels 1, 7 and 8 by mode); the stage's own
        counts by kernel."""
        zero(wrappers)
        for w in moded:
            w.launches_by_mode.update(dict.fromkeys(w.launches_by_mode, 0))
        out = fn()
        torch.cuda.synchronize()
        stage = read(wrappers)
        for w in moded:
            for mode in ("high", "fast"):
                stage[w.__name__] -= w.launches_by_mode[mode]
                stage[f"{w.__name__}_{mode}"] = w.launches_by_mode[mode]
        for k, n in stage.items():
            launches[k] += n
        return out, stage

    t0 = time.perf_counter()
    matrices = {}
    line, stage = count(lambda: protocol_bench.run(
        405, 405, N_POINTS, emd=True, matrices=matrices))
    print(json.dumps(line), flush=True)
    protocol_s = time.perf_counter() - t0
    for name in ("pairwise_cd_stats", "pairwise_emd"):
        if stage[name] < 1:
            fail(f"protocol_bench did not launch {name}")
    times = [line[k] for k in ("cd_matrix_sec", "emd_matrix_sec",
                               "protocol_sec", "warm_rep_sec")]
    if not all(math.isfinite(t) and t > 0 for t in times) or not (
            math.isfinite(line["mmd_cd"]) and 0 <= line["nna_cd"] <= 1):
        fail(f"protocol_bench's line: {line}")
    # an 8 x 8 corner of the same clouds' matrices through the plain
    # versions, at check_pairwise's and check_pairwise_emd's tolerances
    gen = torch.from_numpy(matrices["gen"][:8]).cuda()
    ref = torch.from_numpy(matrices["ref"][:8]).cuda()
    cdl, cdr, _, _ = pairwise_cd_stats_plain(gen, ref, 1e-3)
    check_close("protocol CD matrix, 8 x 8 corner, vs plain",
                torch.from_numpy(matrices["cd"][:8, :8]).cuda(), cdl + cdr,
                0.0, 1e-5)
    check_close("protocol EMD matrix (x N), 8 x 8 corner, vs plain",
                N_POINTS * torch.from_numpy(matrices["emd"][:8, :8]).cuda(),
                pairwise_emd_plain(gen, ref), 1e-5, 2e-4)
    say(f"    protocol_bench: CD matrix {line['cd_matrix_sec']:.3f} s, EMD "
        f"matrix {line['emd_matrix_sec']:.3f} s, cold protocol "
        f"{line['protocol_sec']:.3f} s, warm {line['warm_rep_sec']:.3f} s, "
        f"10 reps {line['protocol_min_10rep']:.3f} min; launches {stage} "
        f"[{card}]")
    del matrices

    t0 = time.perf_counter()
    lines, stage = count(lambda: train_breakdown.run(b=(BATCH,),
                                                     modes=MODES, iters=10))
    breakdown_s = time.perf_counter() - t0
    if [(x["mode"], x["B"]) for x in lines] != [(m, BATCH) for m in MODES]:
        fail(f"train_breakdown made the lines {lines}")
    for x in lines:
        bad = {k: v for k, v in x.items() if k not in ("mode", "B")
               and not (math.isfinite(v) and v > 0)}
        if bad:
            fail(f"train_breakdown at '{x['mode']}': {bad}")
        say(f"    train_breakdown '{x['mode']}' B={BATCH} (ms a call, host "
            "clock / card busy): " + "; ".join(
                f"{p} {x[p + '_ms']:.2f} / {x[p + '_device_ms']:.2f}"
                for p in train_breakdown.PARTS)
            + f"; {x['clouds_per_sec']:.1f} clouds/s [{card}]")
    for mode in MODES:
        tag = "" if mode == "highest" else "_" + mode
        for name in ("point_decode", "train_decode_fwd", "train_decode_bwd"):
            if stage[name + tag] < 1:
                fail(f"train_breakdown did not launch {name} at '{mode}'")
    say(f"    phase 10 seconds: protocol_bench {protocol_s:.1f}, "
        f"train_breakdown {breakdown_s:.1f}; launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
    return launches


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--cards", type=int, default=None,
                        help="Run only cli/train_ae's data-parallel launch "
                             "on this many cards (NCCL), after the build.")
    cli = parser.parse_args()
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
    if cli.cards is not None:
        phase_nccl(card, cli.cards)
        say(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    marks.append(time.perf_counter())
    measured, bounds = phase_kernels()
    marks.append(time.perf_counter())
    launches = phase_slice(card)
    marks.append(time.perf_counter())
    train_launches, bare_step_ms = phase_train(card)
    launches.update(train_launches)
    marks.append(time.perf_counter())
    loop_launches, loop_ms = phase_loop(card, bare_step_ms,
                                        measured["point_decode"][0])
    for name, n in loop_launches.items():
        launches[name] += n
    marks.append(time.perf_counter())
    svr_launches, svr_loop_ms = phase_svr(card, measured["point_decode"][0])
    for name, n in svr_launches.items():
        launches[name] += n
    marks.append(time.perf_counter())
    for name, n in phase_cli(card, loop_ms, svr_loop_ms).items():
        launches[name] = launches.get(name, 0) + n
    marks.append(time.perf_counter())
    for name, n in phase_dist(card).items():
        launches[name] += n
    marks.append(time.perf_counter())
    for name, n in phase_precision(card).items():
        launches[name] = launches.get(name, 0) + n
    marks.append(time.perf_counter())
    for name, n in phase_tools(card).items():
        launches[name] = launches.get(name, 0) + n
    marks.append(time.perf_counter())
    say("phase seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in
        zip(("build", "kernels", "slice", "train", "loop", "svr", "cli",
             "dist", "precision", "tools"), marks, marks[1:])))
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    sources = {
        "point_decode": (
            "go_with_the_flows_tpu_torch/csrc/point_decode.cu",
            "go_with_the_flows_tpu/ops/pallas/coupling_kernel.py:453"),
        "point_decode_high": (
            "go_with_the_flows_tpu_torch/csrc/point_decode.cu",
            "go_with_the_flows_tpu/ops/pallas/coupling_kernel.py:453"),
        "point_decode_fast": (
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
            "go_with_the_flows_tpu_torch/csrc/train_decode.cuh",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:806"),
        "train_decode_bwd": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cuh",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:880"),
        "train_decode_fwd_fast": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cuh",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:806"),
        "train_decode_bwd_fast": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cuh",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:880"),
        "train_decode_fwd_high": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cuh",
            "go_with_the_flows_tpu/ops/pallas/train_kernel.py:806"),
        "train_decode_bwd_high": (
            "go_with_the_flows_tpu_torch/csrc/train_decode.cuh",
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
