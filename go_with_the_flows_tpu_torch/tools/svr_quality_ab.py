"""SVR training-precision A/B: does training in a reduced matmul
precision mode hold for the single-view-reconstruction model family?
The port of the JAX package's tools/svr_quality_ab.py, with its flags,
its synthetic task, its optimizer recipe and its output:

    python -m go_with_the_flows_tpu_torch.tools.svr_quality_ab \\
        [--steps 400] [--b 16] [--n 512] [--hw 137] \\
        [--modes highest,fast] [--eval_s 64] [--device cuda]

The task has real signal: each image is a 2-D occupancy rendering (the
xy plane) of its own cloud of two blobs, so a reconstruction must route
information through the ResNet-18 image encoder, whose convolutions run
in the mode too. Each mode trains the JAX tool's small
FlowMixtureSVRModel (MODEL, seed 0) for --steps steps of --b fresh
clouds of --n points and their --hw x --hw images, one stream drawn from
RandomState(1) for every mode, with the JAX tool's optimizer (a cosine
cycle of the lr between 2e-4 and 5e-4, warmup for the first 10 steps)
and one generator seeded 1 for the posterior noise: kernels 7 and 8 in
the mode on the card, the decoder's modules on the CPU. Then, at 'high'
(the AE/SVR evaluation default), it reconstructs --eval_s shapes drawn
from RandomState(123) from their images (kernel 1; the noise from a
generator seeded 7) and scores them against their clouds (EMD_CD_F1,
batch 32: CD x1e4, EMD x1e2, F1 at 1e-3; kernels 2 and 5 on the card).
It prints a line a mode and, last, the JSON of {mode: {"wall_s",
"final_loss", "loss_curve" ([step, loss] at step 1 and every tenth of
the steps), "recon_CD_x1e4", "recon_EMD_x1e2", "recon_F1"}}.

Images are (B, 4, H, W) here, the port's layout (the JAX tool's are
(B, H, W, 4)). The JAX tool's first batch, drawn from RandomState(0),
only shapes its model's init; the port's model needs none. `run` takes
the model's keyword arguments and sizes, so that a test can call it at a
small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..metrics.evaluation import EMD_CD_F1
from ..models.mixture import FlowMixtureSVRModel
from ..ops.precision import matmul_precision_scope
from ..optim import make_optimizer
from ..train.step import make_sample_step, make_train_step

MODEL = dict(
    n_components=2, params_reduce_mode="none",
    weights_type="learned_weights", g_latent_space_size=64,
    g_prior_n_flows=3, g_prior_n_features=64,
    p_decoder_n_flows=6, p_decoder_n_features=32,
    pc_enc_init_n_features=32, pc_enc_n_features=(64, 128),
)
OPTIMIZER = dict(cycle_length=4, min_lr=2e-4, max_lr=5e-4, beta1=0.9,
                 min_beta2=0.99, max_beta2=0.99, wd=1e-6)
STREAM_SEED, EVAL_SEED, NOISE_SEED, RECON_SEED = 1, 123, 1, 7
WARMUP_STEPS = 10
EVAL_MODE = "high"
EVAL_BATCH = 32
F1_THRESHOLD = 1e-3


def make_batch(rstate: np.random.RandomState, b: int, n: int, hw: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX tool's batch, from `rstate`: clouds (b, 3, n) of 2 blobs
    whose centers vary per shape, and images (b, 4, hw, hw), the coarse
    occupancy rendering of the same cloud in the xy plane in channels
    0-2, channel 3 all ones."""
    c1 = rstate.uniform(-0.6, 0.6, size=(b, 1, 3))
    c2 = rstate.uniform(-0.6, 0.6, size=(b, 1, 3))
    which = rstate.randint(0, 2, size=(b, n, 1))
    pts = np.where(which == 0, c1, c2) + rstate.randn(b, n, 3) * 0.08
    clouds = pts.transpose(0, 2, 1).astype(np.float32)
    ij = np.clip(((pts[..., :2] + 1.0) * 0.5 * (hw - 1)).astype(int),
                 0, hw - 1)
    images = np.zeros((b, 4, hw, hw), np.float32)
    for k in range(b):
        images[k, :3, ij[k, :, 1], ij[k, :, 0]] = 1.0
    images[:, 3] = 1.0
    return clouds, images


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def run(steps: int = 400, b: int = 16, n: int = 512, hw: int = 137,
        modes: Sequence[str] = ("highest", "fast"), eval_s: int = 64,
        device="cuda", model_kwargs: Optional[Dict] = None) -> Dict:
    """Train and score each mode; returns {mode: {...}}, the JSON the
    command prints last."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    ec, ei = make_batch(np.random.RandomState(EVAL_SEED), eval_s, n, hw)
    ec_dev, ei_dev = _to(device, ec, ei)
    ec_nc3 = np.ascontiguousarray(ec.transpose(0, 2, 1))
    results = {}
    for mode in modes:
        rng = np.random.RandomState(STREAM_SEED)  # one stream per mode
        model = FlowMixtureSVRModel(
            **(model_kwargs or MODEL),
            generator=torch.Generator().manual_seed(0)).to(device)
        opt = make_optimizer(list(model.parameters()), epoch_length=steps,
                             **OPTIMIZER)
        with matmul_precision_scope(mode):
            step = make_train_step(model, opt, svr=True)
        generator = torch.Generator(device=device).manual_seed(NOISE_SEED)
        losses = []
        _sync(device)
        t0 = time.perf_counter()
        for i in range(steps):
            c, im = _to(device, *make_batch(rng, b, n, hw))
            m = step(c, c, generator, images=im, warmup=i < WARMUP_STEPS)
            if (i + 1) % max(1, steps // 10) == 0 or i == 0:
                loss = float(m["loss"])
                losses.append((i + 1, round(loss, 3)))
                print(f"# [{mode}] step {i + 1}: loss {loss:.2f}",
                      flush=True)
        _sync(device)
        wall = time.perf_counter() - t0

        # paired reconstruction at the AE/SVR evaluation default
        with matmul_precision_scope(EVAL_MODE):
            rec_step = make_sample_step(model, n, mode="reconstruction",
                                        svr=True)
        recon, _, _ = rec_step(
            ec_dev, torch.Generator(device=device).manual_seed(RECON_SEED),
            images=ei_dev)
        r_nc3 = np.ascontiguousarray(recon.transpose(1, 2).cpu().numpy())
        tab = EMD_CD_F1(r_nc3, ec_nc3, batch_size=EVAL_BATCH,
                        cd_option=True, emd_option=True, f1_option=True,
                        f1_threshold=F1_THRESHOLD, device=device)
        results[mode] = {
            "wall_s": round(wall, 1),
            "final_loss": losses[-1][1],
            "loss_curve": losses,
            "recon_CD_x1e4": round(float(tab["CD"]) * 1e4, 2),
            "recon_EMD_x1e2": round(float(tab["EMD"]) * 1e2, 3),
            "recon_F1": round(float(tab["F1"]), 3),
        }
        r = results[mode]
        print(f"## mode={mode}: final loss {r['final_loss']}, "
              f"CD {r['recon_CD_x1e4']} EMD {r['recon_EMD_x1e2']} "
              f"F1 {r['recon_F1']} ({wall:.0f}s)", flush=True)
        del model, opt, step, rec_step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--b", type=int, default=16)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--hw", type=int, default=137)
    ap.add_argument("--modes", default="highest,fast")
    ap.add_argument("--eval_s", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(args.steps, args.b, args.n, args.hw,
                  args.modes.split(","), args.eval_s, args.device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
