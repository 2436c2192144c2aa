"""Traffic of kind "train": the port's training loop, closed, from a pool
of seeded batches in host memory.

Set-up builds one training state (the model with its weights drawn on
the device from the seed, the optimizer, the step, the posterior-noise
generator) and drives it through the loop's own call, `train/loops.py:
train`, one batch at a time for the first `checked_steps` steps (rows
that all differ), then `warm_steps` more. The window hands the same
state to `train` over a loader that serves the pool in turn until
`--seconds` have passed; the loop copies each batch to the card itself.
With --trace 1 a slice of `profile_steps` more steps runs under the
profiler after the window.

Once the window has closed, the state is freed and the plain reference
(`reference/train.py`) follows the checked steps from the same weights,
batches and noise. Compared, each against its limit
(`limits/<cell>.json`):
  * loss_gap: the largest relative gap of a checked step's loss;
  * grad_gap: over the leaves, the largest gap between the norms of the
    program's and the reference's first gradient (the program's worked
    out from AMSGrad's first moment after one step), over the larger of
    the reference's norm of that leaf and of the median leaf;
  * change_gap: the same gap of the parameters' change over the checked
    steps, leaf by leaf, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (the others move by
    round-off), and of those leaves' gaps the median. Not the worst
    leaf: AMSGrad's first steps move an entry by lr g / (|g| + 1e-8), so
    a leaf whose few moved entries sit among entries of round-off
    gradients (a PointNet BatchNorm bias ahead of the max-pool, on some
    seeds) reads a gap of 0.16-0.26 between any two float32 orders of
    summation and float64 alike; the median leaf's gap is steady.
"""

from __future__ import annotations

import gc
import itertools
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference.train import follow
from ..trace import profile_slice


def make_pool(seed: int, batches: int, B: int, N: int,
              image_size=None) -> List[Dict[str, np.ndarray]]:
    """`batches` batches of B clouds (B, 3, N) for the encoder ("cloud")
    and the decoder ("eval_cloud"), and with `image_size` images
    (B, 4, H, W): every seed the same sizes. A cloud is an anisotropic
    Gaussian, axes drawn from U(0.05, 0.35)."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(batches):
        axes = rng.uniform(0.05, 0.35, (B, 3, 1)).astype(np.float32)
        batch = {k: rng.standard_normal((B, 3, N), np.float32) * axes
                 for k in ("cloud", "eval_cloud")}
        if image_size is not None:
            batch["image"] = rng.standard_normal((B, 4, *image_size),
                                                 np.float32)
        pool.append(batch)
    return pool


class PoolLoader:
    """The loop's loader over pool batches `order`; with a `deadline` it
    serves the pool in turn until the host's clock passes it, and
    stamps each request."""

    def __init__(self, pool, order, deadline: Optional[float] = None):
        self.pool, self.order, self.deadline = pool, list(order), deadline
        self.stamps: List[float] = []

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.order) if self.deadline is None else 1 << 40

    def __iter__(self):
        for i in itertools.count():
            now = time.perf_counter()
            if (now >= self.deadline if self.deadline is not None
                    else i >= len(self.order)):
                return
            self.stamps.append(now)
            yield self.pool[self.order[i % len(self.order)]]


def _leaf_norms(flat: torch.Tensor, names, sizes) -> Dict[str, float]:
    return {n: float(t.norm()) for n, t in zip(names, flat.split(sizes))}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves=None) -> List[float]:
    """|prog - ref| / max(ref, the median leaf's ref) of each of
    `leaves` (default: all)."""
    leaves = list(ref) if leaves is None else list(leaves)
    floor = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in leaves]


class Program:
    """The system under test: one training state of the port and the
    loop's call that drives it."""

    def __init__(self, cfg, traffic, seed, device, hooks):
        from go_with_the_flows_tpu_torch.models.mixture import (
            FlowMixtureModel, FlowMixtureSVRModel)
        from go_with_the_flows_tpu_torch.optim import make_optimizer
        from go_with_the_flows_tpu_torch.train import loops
        from go_with_the_flows_tpu_torch.train.state import (
            create_train_state)
        from go_with_the_flows_tpu_torch.train.step import make_train_step
        from go_with_the_flows_tpu_torch.utils.config import (
            model_config_kwargs, svr_model_config_kwargs)

        self.loops = loops
        self.dev = dev = torch.device(device)
        self.svr = cfg["train_mode"].endswith("_ic")
        self.B, self.N = cfg["batch_size"], cfg["cloud_size"]
        self.pool = make_pool(seed, traffic["pool_batches"], self.B, self.N,
                              tuple(cfg["image_size"]) if self.svr else None)
        with torch.device(dev):
            gen = torch.Generator(dev).manual_seed(seed)
            if self.svr:
                model = FlowMixtureSVRModel(**svr_model_config_kwargs(cfg),
                                            generator=gen)
            else:
                model = FlowMixtureModel(**model_config_kwargs(cfg),
                                         generator=gen)
        self.names = [n for n, _ in model.named_parameters()]
        self.sizes = [p.numel() for p in model.parameters()]
        self.weights0 = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        self.epoch_length = traffic["pool_batches"]
        optimizer = make_optimizer(list(model.parameters()),
                                   self.epoch_length, **cfg)
        self.state = create_train_state(model, optimizer, seed=seed + 1)
        step = make_train_step(model, optimizer, cfg["pnll_weight"],
                               cfg["gnll_weight"], cfg["gent_weight"],
                               svr=self.svr)
        if "step" in hooks:  # a fault planted under the loop
            step = hooks["step"](step, model, optimizer)
        self.step = step
        self.beta1 = cfg["beta1"]

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def train(self, loader):
        return self.loops.train(loader, self.step, self.state, 0, 0, False,
                                device=self.dev, svr=self.svr,
                                logging=False, checkpointing=False)

    def checked(self, steps: int) -> Dict:
        """The first `steps` steps, one batch each through the loop: each
        step's loss, the first gradient's norm by leaf (from AMSGrad's
        first moment after one step) and the change of the parameters
        over all of them by leaf."""
        model, opt = self.state.model, self.state.optimizer
        out = {"loss": [], "grad": {}}
        for i in range(steps):
            self.train(PoolLoader(self.pool, [i]))
            out["loss"].append(self.state.train_metrics["loss"])
            if i == 0:
                out["grad"] = _leaf_norms(opt.exp_avg / (1.0 - self.beta1),
                                          self.names, self.sizes)
        out["change"] = {n: float((p.detach() - self.weights0[n]).norm())
                         for n, p in model.named_parameters()}
        return out

    def free(self) -> None:
        del self.state, self.step
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_batches(pool, steps: int, seed: int, G: int, svr: bool, dev):
    """The checked steps' batches on the device, with the posterior noise
    drawn as the program's generator draws it (same seed, same device,
    same shapes and order)."""
    noise = torch.Generator(dev).manual_seed(seed + 1)
    batches = []
    for b in pool[:steps]:
        B = b["cloud"].shape[0]
        one = {"g": torch.from_numpy(b["cloud"]).to(dev),
               "p": torch.from_numpy(b["eval_cloud"]).to(dev),
               "eps": torch.randn(B, G, generator=noise, device=dev)}
        if svr:
            one["images"] = torch.from_numpy(b["image"]).to(dev)
        batches.append(one)
    return batches


def gaps(prog: Dict, ref: Dict, worst_change: bool = False
         ) -> Dict[str, float]:
    """The three numbers compared (module docstring); with
    `worst_change` also the worst leaf's change gap, which is not."""
    median = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * median]
    change = leaf_gaps(prog["change"], ref["change"], moved)
    out = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"])),
        "change_gap": statistics.median(change),
    }
    if worst_change:
        out["change_gap_worst_leaf"] = max(change)
    return out


def run(cell, cfg, traffic, limits, seed, seconds, trace, device, hooks,
        t_start) -> Dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    build_s = 0.0
    if on_card:
        from go_with_the_flows_tpu_torch.ops.kernels import build
        build_s = build.build()
        build.library()
    checked = traffic["checked_steps"]
    prog = Program(cfg, traffic, seed, device, hooks)
    pool = prog.pool
    readings = prog.checked(checked)
    prog.train(PoolLoader(pool, [(checked + i) % len(pool)
                                 for i in range(traffic["warm_steps"])]))
    prog.sync()
    setup_s = time.perf_counter() - t_start

    failed = 0
    window = PoolLoader(pool, range(len(pool)),
                        deadline=time.perf_counter() + seconds)
    w0 = time.perf_counter()
    try:
        prog.train(window)
    except prog.loops.NaNLossError:
        failed = 1
    prog.sync()
    window_s = time.perf_counter() - w0
    steps = len(window.stamps)

    traced = None
    if trace:
        n = traffic["profile_steps"]
        traced = profile_slice(
            lambda: prog.train(PoolLoader(pool, [i % len(pool)
                                                 for i in range(n)])),
            prog.sync)
        traced["steps"] = n
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else device
    prog.free()

    r0 = time.perf_counter()
    ref = follow(prog.weights0, reference_batches(
        pool, checked, seed, cfg["g_latent_space_size"], prog.svr, dev),
        cfg, prog.epoch_length)
    prog.sync()
    reference_s = time.perf_counter() - r0
    values = gaps(readings, ref)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = (failed == 0 and steps > 0
               and all(math.isfinite(v) and v <= limits[k]
                       for k, v in values.items()))
    B = prog.B
    return {
        "correct": correct, "attempted": steps, "failed": failed,
        "checks": checks, "memory_peak_bytes": peak, "device_kind": kind,
        "setup_s": setup_s, "build_s": build_s, "window_s": window_s,
        "reference_s": reference_s, "steps": steps, "clouds": steps * B,
        "stamps": window.stamps, "trace": traced, "cfg": cfg,
        "svr": prog.svr, "batch": B,
    }
