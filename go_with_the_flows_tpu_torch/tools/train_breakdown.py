"""The flagship training step split into its parts, on the card (the port
of the JAX package's tools/train_breakdown.py, with its flags, its model,
its inputs and its line):

    python -m go_with_the_flows_tpu_torch.tools.train_breakdown \\
        [--b 64 256] [--modes highest high fast] [--iters 10] \\
        [--device cuda]

For each matmul precision mode and batch size B it builds the JAX tool's
model (FLAGSHIP_CONFIG below, a copy of tools/tpu_drift_audit.py's: the
airplane flagship's widths) from seed 0, RandomState(0) clouds of N=2048
points, the tool's AMSGrad settings, and times, each over `iters` calls
after one warm-up call:

  * fwd     - the training-mode forward and the loss (BatchNorm on the
              batch's statistics), recorded for autograd as in the step;
  * grad    - the same, then the backward; no optimizer step;
  * evalfwd - the port's eval step (make_eval_step: running statistics,
              kernel 1's inverse on the card);
  * step    - the port's make_train_step, built under the mode.

On a CUDA device the training parts run kernels 7 and 8 in the mode, as
the train step does. `<part>_ms` is the host's clock a call, between two
synchronizes of the device; `<part>_device_ms` is the card's busy time a
call: the device kernels and copies of one more pass of the same loop
(`min(iters, 2)` calls) under torch.profiler, summed. CUDA events around
the loop would read nearly the host's span, since the card waits inside
it whenever the host is late; the gap between `_ms` and `_device_ms` is
the part of the call in which the card is idle, the host's share. On the
CPU `_device_ms` is the host's clock (the device is the host).

Prints one JSON line a (mode, B): mode, B, fwd_ms, grad_ms, evalfwd_ms,
step_ms (the JAX line's keys), the four `_device_ms` beside them, and
clouds_per_sec (B over step_ms). `run` takes the model's keyword
arguments and N, so that a test can call it small on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..losses import flow_mixture_loss
from ..models.mixture import FlowMixtureModel
from ..ops.precision import matmul_precision_scope
from ..optim import make_optimizer
from ..train.step import make_eval_step, make_train_step
from ..utils.config import model_config_kwargs

# tools/tpu_drift_audit.py's FLAGSHIP_CONFIG and N, the JAX tool's model
FLAGSHIP_CONFIG = dict(
    train_mode="p_rnvp_mc_g_rnvp_vae",
    util_mode="training",
    deterministic=False,
    n_components=4,
    params_reduce_mode="depth_and_feature",
    weights_type="learned_weights",
    pc_enc_init_n_channels=3,
    pc_enc_init_n_features=64,
    pc_enc_n_features=[128, 256, 512],
    g_latent_space_size=128,
    g_prior_n_flows=7,
    g_prior_n_features=128,
    g_posterior_n_layers=1,
    p_latent_space_size=3,
    p_prior_n_layers=1,
    p_decoder_n_flows=21,
    p_decoder_n_features=64,
    p_decoder_base_type="free",
    p_decoder_base_var=-3.9551,
)
N = 2048
# the JAX tool's optimizer arguments
OPTIMIZER = dict(epoch_length=10, cycle_length=4, min_lr=1e-4,
                 max_lr=2.56e-4, beta1=0.9, min_beta2=0.99, max_beta2=0.99,
                 wd=1e-6)
PARTS = ("fwd", "grad", "evalfwd", "step")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def busy_ms(fn: Callable, calls: int) -> float:
    """The card's busy milliseconds a call of fn(): the device kernels
    and copies of `calls` profiled calls, summed (user annotations, which
    span other kernels, left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    return total / 1000.0 / calls


def timed(fn: Callable, iters: int, device: torch.device):
    """(host ms a call over `iters` calls after a warm-up call, the
    device's busy ms a call)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    host = 1e3 * (time.perf_counter() - t0) / iters
    if device.type != "cuda":
        return host, host
    return host, busy_ms(fn, min(iters, 2))


def run(b: Sequence[int] = (64,), modes: Sequence[str] = ("highest", "high",
                                                          "fast"),
        iters: int = 10, device="cuda", model_kwargs: Optional[Dict] = None,
        n_points: int = N) -> List[Dict]:
    """One line (a dict, the module's docstring lists its keys) for each
    (mode, B), in that order; each line is printed as it is made."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if model_kwargs is None:
        model_kwargs = model_config_kwargs(FLAGSHIP_CONFIG)
    fused = device.type == "cuda"  # the train step's own choice
    lines = []
    for mode in modes:
        for B in b:
            rng = np.random.RandomState(0)
            g = torch.from_numpy(
                (rng.randn(B, 3, n_points) * 0.2).astype(np.float32)
            ).to(device)
            p = torch.from_numpy(
                (rng.randn(B, 3, n_points) * 0.2).astype(np.float32)
            ).to(device)
            model = FlowMixtureModel(
                **model_kwargs,
                generator=torch.Generator().manual_seed(0)).to(device)
            opt = make_optimizer(list(model.parameters()), **OPTIMIZER)
            gen = torch.Generator(device=device).manual_seed(1)
            with matmul_precision_scope(mode):
                step = make_train_step(model, opt)
                eval_step = make_eval_step(model)

            def fwd_loss():
                model.train()
                with matmul_precision_scope(mode):
                    eps = torch.randn(B, model.g_latent_space_size,
                                      generator=gen, device=device)
                    out = model.encode(g, "training", posterior_eps=eps)
                    out.update(model.decode_training(p, out["g_sample"],
                                                     False, fused))
                    return flow_mixture_loss(out, 1.0, 1.0, 1.0)[0]

            def grad_only():
                opt.zero_grad(set_to_none=True)
                loss = fwd_loss()
                with matmul_precision_scope(mode):
                    loss.backward()

            calls = {
                "fwd": fwd_loss,
                "grad": grad_only,
                "evalfwd": lambda: eval_step(g, p, gen),
                "step": lambda: step(g, p, gen, warmup=False),
            }
            line = {"mode": mode, "B": B}
            for part in PARTS:
                host, busy = timed(calls[part], iters, device)
                line[f"{part}_ms"] = host
                line[f"{part}_device_ms"] = busy
            line["clouds_per_sec"] = B / (line["step_ms"] / 1e3)
            print(json.dumps(line), flush=True)
            lines.append(line)
            del model, opt, step, eval_step, calls
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, nargs="+", default=[64])
    ap.add_argument("--modes", nargs="+",
                    default=["highest", "high", "fast"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.b, args.modes, args.iters, args.device)


if __name__ == "__main__":
    main()
