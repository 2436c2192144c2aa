"""Training end-metric A/B: train the flagship generative model from
scratch under each training variant, then score the complete protocol
(MMD / COV / 1-NNA over CD and EMD, the JSD, paired reps) per variant.
The port of the JAX package's tools/train_quality_ab.py, with its flags,
its synthetic clouds, its optimizer recipe and its output:

    python -m go_with_the_flows_tpu_torch.tools.train_quality_ab \\
        [--steps 3000] [--b 64] [--s 128] [--reps 3] \\
        [--variants xla-highest,fused-high,fused-fast] [--eval_mode high] \\
        [--out PATH] [--device cuda]

Variants (the training path only; the evaluation is the same for all):

  xla-highest  the decoder's modules under autograd
               (make_train_step(fused_decoder=False)), fp32 'highest'
  fused-high   kernels 7 and 8 (ops/kernels/train_decode.py), three bf16
               products a product ('high')
  fused-fast   kernels 7 and 8, one bf16 product ('fast')

A variant is PATH-MODE: 'xla' or 'fused', then a matmul precision mode
(ops/precision.py). On a CPU device `fused` runs the kernels' plain
versions (make_train_step(fused_decoder="plain")).

Each variant trains its own model (utils/config.FLAGSHIP_AIRPLANE, seed
0) for --steps fresh batches of --b clouds of 2048 points drawn from
RandomState(0), with the JAX tool's optimizer (a cosine cycle of the lr
between 2e-4 and 5e-4, warmup for the first 10 steps) and one generator
seeded 1 for the posterior noise. Then, under --eval_mode, it samples S
labeled clouds a rep from the inputs drawn with RandomState(7), the
noise from a torch.Generator seeded 1000 + rep (paired across variants),
and scores them against the reference set drawn with RandomState(123):
the compute_all_metrics scalars over CD and EMD, and the occupancy-grid
JSD. It prints a block a variant (mean +/- std over the reps), writes
the JSON of every variant to --out (default
go_with_the_flows_tpu_torch/_build/train_quality_ab.json) and prints,
as its last line, the JSON of the metrics. `run` takes the model's
keyword arguments and sizes, so that a test can call it at a small size
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..metrics.evaluation import (compute_all_metrics,
                                  jsd_between_point_cloud_sets)
from ..models.mixture import FlowMixtureModel
from ..ops.precision import matmul_precision_scope
from ..optim import make_optimizer
from ..train.step import make_sample_step, make_train_step
from ..utils.config import FLAGSHIP_AIRPLANE
from .eval_precision_ab import N_POINTS, _nc3, _sync, make_clouds

VARIANTS = ("xla-highest", "fused-high", "fused-fast")
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "train_quality_ab.json")


def train_variant(model_kwargs: Dict, n_points: int, steps: int, b: int,
                  variant: str, device) -> tuple:
    """A model trained from seed 0 under `variant`: (model, train
    seconds, [(step, loss)] at the JAX tool's ten marks)."""
    path, mode = variant.split("-")
    if path not in ("xla", "fused"):
        raise ValueError(f"variant {variant!r}: the path is 'xla' or "
                         "'fused'")
    device = torch.device(device)
    fused = False if path == "xla" else (
        True if device.type == "cuda" else "plain")
    model = FlowMixtureModel(
        **model_kwargs, generator=torch.Generator().manual_seed(0)).to(device)
    # a fresh, identical data stream per variant
    rng = np.random.RandomState(0)
    make_clouds(b, rng, n_points)  # the JAX tool's init batch
    opt = make_optimizer(list(model.parameters()), epoch_length=steps,
                         cycle_length=4, min_lr=2e-4, max_lr=5e-4,
                         beta1=0.9, min_beta2=0.99, max_beta2=0.99, wd=1e-6)
    with matmul_precision_scope(mode):
        step = make_train_step(model, opt, fused_decoder=fused)
    generator = torch.Generator(device=device).manual_seed(1)
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        c = torch.from_numpy(make_clouds(b, rng, n_points)).to(device)
        m = step(c, c, generator, warmup=i < 10)
        if (i + 1) % max(1, steps // 10) == 0 or i == 0:
            loss = float(m["loss"])
            losses.append((i + 1, round(loss, 3)))
            print(f"# [{variant}] step {i + 1}: loss {loss:.2f}", flush=True)
    _sync(device)
    return model, time.perf_counter() - t0, losses


def run(model_kwargs: Dict, n_points: int, steps: int, b: int, s: int,
        reps: int, variants: Sequence[str] = VARIANTS,
        eval_mode: str = "high", device="cuda",
        out: Optional[str] = None) -> Dict:
    """Train and score each variant; returns {variant: {"train_wall_s",
    "steps_per_s", "final_loss", "loss_curve", "metrics": {metric:
    (mean, std)}}}, the JSON it writes to `out` (when given)."""
    device = torch.device(device)
    ref_nc3 = np.ascontiguousarray(make_clouds(
        s, np.random.RandomState(123), n_points).transpose(0, 2, 1))
    g_in = torch.from_numpy(make_clouds(s, np.random.RandomState(7),
                                        n_points)).to(device)
    results = {}
    for variant in variants:
        model, train_s, losses = train_variant(model_kwargs, n_points, steps,
                                               b, variant, device)
        with matmul_precision_scope(eval_mode):
            sample_step = make_sample_step(model, n_points)
        per_rep = []
        for rep in range(reps):
            # paired across variants
            generator = torch.Generator(device=device).manual_seed(1000 + rep)
            samples, _, _ = sample_step(g_in, generator)
            s_nc3 = _nc3(samples)
            res = compute_all_metrics(s_nc3, ref_nc3, batch_size=min(s, 64),
                                      cd_option=True, emd_option=True,
                                      device=device)
            res = {k: float(v) for k, v in res.items() if np.size(v) == 1}
            res["JSD"] = float(jsd_between_point_cloud_sets(s_nc3, ref_nc3,
                                                            device=device))
            per_rep.append(res)
        agg = {k: (float(np.mean([r[k] for r in per_rep])),
                   float(np.std([r[k] for r in per_rep])))
               for k in per_rep[0]}
        results[variant] = {
            "train_wall_s": round(train_s, 1),
            "steps_per_s": round(steps / train_s, 1),
            "final_loss": losses[-1][1],
            "loss_curve": losses,
            "metrics": agg,
        }
        print(f"## variant={variant}  train {train_s:.0f}s "
              f"({steps / train_s:.1f} steps/s)  final loss {losses[-1][1]}")
        for k, (mu, sd) in sorted(agg.items()):
            print(f"  {k}: {mu:.6g} +/- {sd:.2g}")
        sys.stdout.flush()
        del model, sample_step
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(results, fh, indent=1)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--s", type=int, default=128,
                    help="sample / reference set size per rep")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--eval_mode", default="high",
                    help="matmul precision for the SAMPLING side")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(FLAGSHIP_AIRPLANE, N_POINTS, args.steps, args.b, args.s,
                  args.reps, args.variants.split(","), args.eval_mode,
                  args.device, args.out)
    print(json.dumps({v: r["metrics"] for v, r in results.items()}))
    print(f"# wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
