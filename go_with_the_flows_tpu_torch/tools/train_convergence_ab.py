"""Training-convergence A/B: do the train-decode kernels (kernels 7 and
8) and the reduced matmul precision modes change how the flagship model
converges? The port of the JAX package's tools/train_convergence_ab.py,
with its flags, its synthetic clouds, its optimizer recipe and its
output:

    python -m go_with_the_flows_tpu_torch.tools.train_convergence_ab \\
        [--steps 300] [--b 64] [--log_every 50] \\
        [--variants xla-highest,fused-high,fused-fast] [--device cuda]

Each variant trains its own flagship model (utils/config.FLAGSHIP_AIRPLANE,
seed 0) for --steps optimizer steps on one shared stream of two-blob
clouds of 2048 points (RandomState(0), drawn anew for each variant, so
that every variant sees the same batches), with the JAX tool's optimizer
(a cosine cycle of the lr between 5e-4 and 1e-3, warmup for the first
10 steps) and one generator seeded 1 for the posterior noise, and prints
one JSON line a variant: {"variant", "steps", "losses" ([step, loss] at
step 1 and every --log_every steps), "wall_s"}. A variant is PATH-MODE:

  xla-highest  the decoder's modules under autograd
               (make_train_step(fused_decoder=False)), fp32 'highest'
  fused-high   kernels 7 and 8 (ops/kernels/train_decode.py), three bf16
               products a product ('high')
  fused-fast   kernels 7 and 8, one bf16 product ('fast')

On a CPU device `fused` runs the kernels' plain versions
(make_train_step(fused_decoder="plain")). `run` takes the model's keyword
arguments and sizes, so that a test can call it at a small size on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..models.mixture import FlowMixtureModel
from ..ops.precision import matmul_precision_scope
from ..optim import make_optimizer
from ..train.step import make_train_step
from ..utils.config import FLAGSHIP_AIRPLANE

VARIANTS = ("xla-highest", "fused-high", "fused-fast")
N_POINTS = 2048
CENTERS = np.array([[-0.5, 0, 0], [0.5, 0, 0]])
OPTIMIZER = dict(cycle_length=4, min_lr=5e-4, max_lr=1e-3, beta1=0.9,
                 min_beta2=0.99, max_beta2=0.99, wd=1e-6)
WARMUP_STEPS = 10


def stream(steps: int, b: int, n_points: int = N_POINTS
           ) -> Iterator[np.ndarray]:
    """The JAX tool's data stream: `steps` batches (b, 3, n_points) of
    float32 clouds, each point on one of the two CENTERS (chosen
    uniformly) plus N(0, 0.15^2) noise, drawn from RandomState(0)."""
    rng = np.random.RandomState(0)
    for _ in range(steps):
        which = rng.randint(0, 2, size=(b, n_points))
        pts = CENTERS[which] + rng.randn(b, n_points, 3) * 0.15
        yield pts.transpose(0, 2, 1).astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_variant(variant: str, steps: int, b: int, log_every: int, device,
                model_kwargs: Dict, n_points: int) -> Dict:
    """Train one variant from seed 0; returns its JSON line."""
    path, mode = variant.split("-")
    if path not in ("xla", "fused"):
        raise ValueError(f"variant {variant!r}: the path is 'xla' or "
                         "'fused'")
    fused = False if path == "xla" else (
        True if device.type == "cuda" else "plain")
    model = FlowMixtureModel(
        **model_kwargs, generator=torch.Generator().manual_seed(0)).to(device)
    opt = make_optimizer(list(model.parameters()), epoch_length=steps,
                         **OPTIMIZER)
    with matmul_precision_scope(mode):
        step = make_train_step(model, opt, fused_decoder=fused)
    generator = torch.Generator(device=device).manual_seed(1)
    curve = []
    _sync(device)
    t0 = time.perf_counter()
    for i, cloud in enumerate(stream(steps, b, n_points)):
        c = torch.from_numpy(cloud).to(device)
        m = step(c, c, generator, warmup=i < WARMUP_STEPS)
        if (i + 1) % log_every == 0 or i == 0:
            curve.append((i + 1, round(float(m["loss"]), 3)))
    _sync(device)
    return {"variant": variant, "steps": steps, "losses": curve,
            "wall_s": round(time.perf_counter() - t0, 1)}


def run(steps: int = 300, b: int = 64, log_every: int = 50,
        variants: Sequence[str] = VARIANTS, device="cuda",
        model_kwargs: Optional[Dict] = None,
        n_points: int = N_POINTS) -> List[Dict]:
    """One line a variant, in order, each printed as JSON when done."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    lines = []
    for variant in variants:
        line = run_variant(variant, steps, b, log_every, device,
                           model_kwargs or FLAGSHIP_AIRPLANE, n_points)
        print(json.dumps(line), flush=True)
        lines.append(line)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.steps, args.b, args.log_every,
               args.variants.split(","), args.device)


if __name__ == "__main__":
    main()
