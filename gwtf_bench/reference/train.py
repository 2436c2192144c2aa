"""The reference's first training steps: the plain forward of `model.py`,
autograd's backward and the published optimizer, AMSGrad Adam with
decoupled weight decay (not scaled by the learning rate) whose learning
rate and beta2 follow a cosine cycle of the global step. A leaf is
stepped, and its own step count advances, only when its gradient has a
non-zero entry.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import model


def cosine(step: int, epoch_length: int, cycle: int, lo: float,
           hi: float) -> float:
    epoch, it = divmod(step, epoch_length)
    s = ((epoch % cycle) * epoch_length + it) / (cycle * epoch_length)
    return lo + 0.5 * (hi - lo) * (1.0 + math.cos(math.pi * s))


class Amsgrad:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict,
                 epoch_length: int):
        self.params = params
        self.cfg = cfg
        self.epoch_length = epoch_length
        self.step_count = 0
        self.state = {k: [0, torch.zeros_like(p), torch.zeros_like(p),
                          torch.zeros_like(p)] for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        c = self.cfg
        args = (self.step_count, self.epoch_length, c["cycle_length"])
        lr = cosine(*args, c["min_lr"], c["max_lr"])
        b2 = cosine(*args, c["min_beta2"], c["max_beta2"])
        b1, wd, eps = c["beta1"], c["wd"], 1e-8
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None or not bool((g != 0).any()):
                continue
            st = self.state[k]
            st[0] += 1
            t = st[0]
            st[1].mul_(b1).add_((1.0 - b1) * g)
            st[2].mul_(b2).add_((1.0 - b2) * g * g)
            torch.maximum(st[3], st[2], out=st[3])
            denom = torch.sqrt(st[3]) / math.sqrt(1.0 - b2 ** t) + eps
            p.sub_(wd * p + lr * (st[1] / (1.0 - b1 ** t)) / denom)
        self.step_count += 1


def follow(weights: Dict[str, torch.Tensor], batches: Sequence[Dict],
           cfg: Dict, epoch_length: int, full_fp32: bool = True) -> Dict:
    """Follow the program's first len(batches) training steps from
    `weights` (copied, not changed). Each batch: g and p clouds, the
    posterior noise `eps`, and `images` for single-view reconstruction.

    Returns {"loss": [each step's loss], "grad": {leaf: norm of the
    first step's gradient}, "change": {leaf: norm of the change of the
    parameters over all the steps}}."""
    model.fp32_switches(full_fp32)
    try:
        params = {k: v.detach().clone() for k, v in weights.items()}
        opt = Amsgrad(params, cfg, epoch_length)
        losses: List[float] = []
        first_grad = {}
        for i, b in enumerate(batches):
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss, _ = model.training_loss(leaves, b["g"], b["p"], b["eps"],
                                          cfg["p_decoder_base_type"],
                                          b.get("images"))
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = dict(zip(leaves, grads))
            for v in params.values():
                v.requires_grad_(False)
            losses.append(float(loss.detach()))
            if i == 0:
                first_grad = {k: float(g.norm()) if g is not None else 0.0
                              for k, g in grads.items()}
            opt.step(grads)
            del loss, grads
        change = {k: float((params[k] - weights[k]).norm()) for k in params}
        return {"loss": losses, "grad": first_grad, "change": change}
    finally:
        model.fp32_switches(True)
