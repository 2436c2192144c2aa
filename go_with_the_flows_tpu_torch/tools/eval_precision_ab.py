"""Generative-eval precision A/B at flagship scale: does sampling in the
'high' or 'fast' matmul precision mode (ops/precision.py) change the
reported protocol numbers? The port of the JAX package's
tools/eval_precision_ab.py, with its flags, its synthetic clouds and its
output:

    python -m go_with_the_flows_tpu_torch.tools.eval_precision_ab \\
        [--steps 400] [--b 64] [--s 128] [--reps 3] \\
        [--modes highest,high,fast] [--state_cache [PATH]] [--device cuda]

  1. train the flagship airplane model (utils/config.FLAGSHIP_AIRPLANE,
     clouds of 2048 points) for --steps steps on synthetic mixture clouds
     at B=--b, at 'high', as the JAX tool does (its training default);
  2. per mode: sample S labeled clouds a rep, the noise drawn from a
     torch.Generator seeded 1000 + rep on the device in every mode (so
     the modes are paired), and evaluate them against one reference set:
     the compute_all_metrics scalars over CD and EMD, the occupancy-grid
     JSD, and the largest per-point drift from the first mode's samples
     of the same rep; then autoencode the S input clouds and score the
     paired CD x1e4, EMD x1e2 and F1 at 1e-4. The metrics are fp32 in
     every mode, so only the model's products and kernel 1 differ;
  3. print a block a mode (mean +/- std over the reps) and, as the last
     line, the JSON of every block.

`--state_cache` keeps the trained model's state dict (torch.save): with
no PATH at go_with_the_flows_tpu_torch/_build/eval_ab_state.pt, reused
when it exists, so that a rerun of the metric side skips the training.
The file holds a model trained at 'high' (a file written by an earlier
version of the tool holds one trained at 'highest').
`run` takes the model's keyword arguments and sizes, so that a test can
call it at a small size on the CPU.
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

from ..metrics.evaluation import (EMD_CD_F1, compute_all_metrics,
                                  jsd_between_point_cloud_sets)
from ..models.mixture import FlowMixtureModel
from ..ops.precision import matmul_precision_scope
from ..optim import make_optimizer
from ..train.step import make_sample_step, make_train_step
from ..utils.config import FLAGSHIP_AIRPLANE

N_POINTS = 2048
CENTERS = np.array([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0],
                    [0.0, 0.6, 0.0], [0.0, 0.0, -0.6]])
DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "eval_ab_state.pt")


def make_clouds(n_clouds: int, rstate: np.random.RandomState,
                n_points: int = N_POINTS) -> np.ndarray:
    """(n_clouds, 3, n_points) float32 clouds around the four CENTERS,
    with the JAX tool's draws from `rstate`."""
    which = rstate.randint(0, len(CENTERS), size=(n_clouds, n_points))
    scale = 0.1 + 0.1 * rstate.rand(n_clouds, 1, 1)
    pts = CENTERS[which] + rstate.randn(n_clouds, n_points, 3) * scale
    return pts.transpose(0, 2, 1).astype(np.float32)


def _nc3(clouds: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(clouds.transpose(1, 2).cpu().numpy(),
                                np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model_kwargs: Dict, n_points: int, steps: int, b: int,
          device, state_cache: Optional[str] = None):
    """The model trained for `steps` steps at 'high' on make_clouds
    batches from RandomState(0) (or loaded from `state_cache`)."""
    device = torch.device(device)
    model = FlowMixtureModel(
        **model_kwargs, generator=torch.Generator().manual_seed(0)).to(device)
    rng = np.random.RandomState(0)
    make_clouds(b, rng, n_points)  # the JAX tool's init batch
    if state_cache and os.path.exists(state_cache):
        model.load_state_dict(torch.load(state_cache, map_location=device))
        print(f"# loaded trained state from {state_cache}")
        return model
    opt = make_optimizer(list(model.parameters()), epoch_length=steps,
                         cycle_length=4, min_lr=2e-4, max_lr=5e-4,
                         beta1=0.9, min_beta2=0.99, max_beta2=0.99, wd=1e-6)
    with matmul_precision_scope("high"):
        step = make_train_step(model, opt)
    # one generator seeded 1 for the run, its draws moving on each step,
    # as the JAX step folds the step count into the tool's PRNGKey(1)
    generator = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    for i in range(steps):
        c = torch.from_numpy(make_clouds(b, rng, n_points)).to(device)
        m = step(c, c, generator, warmup=i < 10)
        if (i + 1) % 100 == 0:
            print(f"# step {i + 1}: loss {float(m['loss']):.2f}", flush=True)
    _sync(device)
    print(f"# trained {steps} steps in {time.perf_counter() - t0:.1f}s")
    if state_cache:
        os.makedirs(os.path.dirname(os.path.abspath(state_cache)),
                    exist_ok=True)
        torch.save(model.state_dict(), state_cache)
    return model


def run(model_kwargs: Dict, n_points: int, steps: int, b: int, s: int,
        reps: int, modes: Sequence[str], device="cuda",
        state_cache: Optional[str] = None) -> Dict:
    """Train (or load) the model, then score each mode; returns {mode:
    {metric: (mean, std)}} as the last line prints it."""
    device = torch.device(device)
    model = train(model_kwargs, n_points, steps, b, device, state_cache)
    ref_nc3 = np.ascontiguousarray(make_clouds(
        s, np.random.RandomState(123), n_points).transpose(0, 2, 1))
    g_in = torch.from_numpy(make_clouds(s, np.random.RandomState(7),
                                        n_points)).to(device)
    g_nc3 = _nc3(g_in)
    batch = min(s, 64)
    results, baseline = {}, {}
    for mode in modes:
        with matmul_precision_scope(mode):
            sample_step = make_sample_step(model, n_points)
            ae_step = make_sample_step(model, n_points, mode="autoencoding")
        per_rep, sample_s = [], []
        for rep in range(reps):
            generator = torch.Generator(device=device).manual_seed(1000 + rep)
            _sync(device)
            t = time.perf_counter()
            samples, _, _ = sample_step(g_in, generator)
            _sync(device)
            sample_s.append(time.perf_counter() - t)
            s_nc3 = _nc3(samples)
            if mode == modes[0]:
                baseline[rep] = s_nc3
            res = compute_all_metrics(s_nc3, ref_nc3, batch_size=batch,
                                      cd_option=True, emd_option=True,
                                      device=device)
            res = {k: float(v) for k, v in res.items() if np.size(v) == 1}
            res["JSD"] = jsd_between_point_cloud_sets(s_nc3, ref_nc3,
                                                      device=device)
            res["max_point_drift_vs_first_mode"] = float(
                np.max(np.abs(s_nc3 - baseline[rep])))
            per_rep.append(res)
        agg = {k: (float(np.mean([r[k] for r in per_rep])),
                   float(np.std([r[k] for r in per_rep])))
               for k in per_rep[0]}
        # autoencoding: the paired metrics, which per-point drift moves
        recon, _, _ = ae_step(g_in,
                              torch.Generator(device=device).manual_seed(7))
        ae = EMD_CD_F1(_nc3(recon), g_nc3, batch_size=batch, cd_option=True,
                       emd_option=True, f1_option=True, f1_threshold=1e-4,
                       device=device)
        agg["AE-CD_x1e4"] = (float(ae["CD"]) * 1e4, 0.0)
        agg["AE-EMD_x1e2"] = (float(ae["EMD"]) * 1e2, 0.0)
        agg["AE-F1"] = (float(ae["F1"]), 0.0)
        results[mode] = agg
        print(f"## mode={mode}")
        for k, (mu, sd) in sorted(agg.items()):
            print(f"  {k}: {mu:.6g} +/- {sd:.2g}")
        print(f"# mode={mode}: sample step of {s} clouds, seconds a rep "
              + ", ".join(f"{t:.4f}" for t in sample_s))
        sys.stdout.flush()
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--s", type=int, default=128,
                    help="sample / reference set size per rep")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--modes", default="highest,high,fast")
    ap.add_argument("--state_cache", nargs="?", const=DEFAULT_CACHE,
                    default=None,
                    help="torch.save of the trained state dict; reused if "
                         "present so metric-side reruns skip the training")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(FLAGSHIP_AIRPLANE, N_POINTS, args.steps, args.b, args.s,
                  args.reps, args.modes.split(","), args.device,
                  args.state_cache)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
