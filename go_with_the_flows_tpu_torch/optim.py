"""AMSGrad Adam with decoupled weight decay and cosine-cycled lr and
beta2 (counterpart of go_with_the_flows_tpu/optim.py), the reference's
own optimizer:

  * the decay is applied inside the update and is NOT scaled by lr:
    p <- p - (wd * p + lr * m_hat / denom);
  * m_hat = m / (1 - b1^t), denom = sqrt(max_v) / sqrt(1 - b2^t) + eps;
  * lr and b2 follow a cosine cycle of the global step, evaluated at the
    step before it is incremented.

Inside a process group of several ranks (parallel/dist.py) the step
first averages the flat gradient over the ranks (one all_reduce), so
that every rank takes the same step on the global batch's gradient; the
step keeps that gradient as `flat_grad`. A parameter is stepped only
when its `.grad` exists (on some rank) and has a non-zero entry; only
then do its own count t and its moments advance (the JAX package gates
each leaf on `any(g != 0)`, since it sees zeros where torch sees no
gradient).

The moments of all parameters live in flat buffers, and one step is a
few dozen launches over them whatever the number of parameters: the
flagship model has about 1,300 parameter tensors, and a loop over them
would spend the step enqueueing small kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable

import torch

from .parallel import dist


@dataclass(frozen=True)
class CosineCycle:
    """The reference's LRUpdater as a pure function of the global step:
    s = ((epoch % cycle_length) * epoch_length + iteration)
        / (cycle_length * epoch_length);
    v = min + 0.5 * (max - min) * (1 + cos(pi * s)).

    A plain object rather than a closure, so that an optimizer's
    `state_dict`, whose parameter group holds it, pickles."""

    epoch_length: int
    cycle_length: int
    min_value: float
    max_value: float

    def __call__(self, step: int) -> float:
        epoch, iteration = divmod(int(step), self.epoch_length)
        s = ((epoch % self.cycle_length) * self.epoch_length + iteration) / (
            self.cycle_length * self.epoch_length)
        return self.min_value + 0.5 * (self.max_value - self.min_value) * (
            1.0 + math.cos(math.pi * s))


# checkpoints load with torch.load's default weights_only=True
torch.serialization.add_safe_globals([CosineCycle])


def cosine_cycle_schedule(epoch_length: int, cycle_length: int,
                          min_value: float, max_value: float) -> CosineCycle:
    """The cosine cycle of `CosineCycle` from the reference's config keys."""
    return CosineCycle(epoch_length, cycle_length, min_value, max_value)


class AmsgradWD(torch.optim.Optimizer):
    """The reference's Adam (amsgrad, decoupled weight decay) with lr and
    b2 given as constants or as schedules of the global step.

    One parameter group. The state is flat: `exp_avg`, `exp_avg_sq` and
    `max_exp_avg_sq` hold every parameter's elements in order, `counts`
    each parameter's own step count, `global_step` the steps taken.
    `state_dict()` carries all five (under "flat") beside the parameter
    group, and `load_state_dict` restores them onto the parameters'
    device, so that save, load and step equals steps without a break.
    """

    _FLAT = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "counts")

    def __init__(self, params: Iterable[torch.Tensor], lr, b1: float = 0.9,
                 b2=0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("AmsgradWD takes one parameter group")
        self.global_step = 0
        self.flat_grad = None  # the last step's gradient, flat
        params = self.param_groups[0]["params"]
        if not params:
            raise ValueError("AmsgradWD got no parameters")
        first = params[0]
        self._sizes = [p.numel() for p in params]
        total = sum(self._sizes)
        self.exp_avg = first.new_zeros(total)
        self.exp_avg_sq = first.new_zeros(total)
        self.max_exp_avg_sq = first.new_zeros(total)
        self.counts = torch.zeros(len(params), dtype=torch.int32,
                                  device=first.device)
        # parameter index of every flat element
        self._owner = torch.repeat_interleave(
            torch.arange(len(params)), torch.tensor(self._sizes)
        ).to(first.device)

    def state_dict(self):
        state = super().state_dict()
        state["flat"] = {k: getattr(self, k).clone() for k in self._FLAT}
        state["flat"]["global_step"] = self.global_step
        return state

    def load_state_dict(self, state_dict) -> None:
        flat = state_dict["flat"]
        for k in self._FLAT:
            mine, saved = getattr(self, k), flat[k]
            if saved.shape != mine.shape or saved.dtype != mine.dtype:
                raise ValueError(
                    f"AmsgradWD.load_state_dict: {k} is {saved.dtype} "
                    f"{tuple(saved.shape)}, this optimizer's "
                    f"{mine.dtype} {tuple(mine.shape)}")
        super().load_state_dict(
            {k: v for k, v in state_dict.items() if k != "flat"})
        for k in self._FLAT:
            getattr(self, k).copy_(flat[k])
        self.global_step = int(flat["global_step"])

    @staticmethod
    def _at(value, step: int) -> float:
        return value(step) if callable(value) else value

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AmsgradWD.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        b1, eps, wd = group["b1"], group["eps"], group["weight_decay"]
        lr = self._at(group["lr"], self.global_step)
        b2 = self._at(group["b2"], self.global_step)
        g = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in params])
        # data-parallel: the global batch's gradient, before the used
        # flags, so every rank steps the same parameters the same way
        dist.all_reduce_mean(g)
        self.flat_grad = g
        p_flat = torch.cat([p.reshape(-1) for p in params])
        owner = self._owner
        # any(g != 0) per parameter (NaN counts as non-zero, as in JAX)
        hits = torch.zeros(len(params), device=g.device).index_add_(
            0, owner, (g != 0).to(g.dtype))
        used_p = hits > 0
        self.counts += used_p.to(torch.int32)
        used = used_p[owner]
        m1 = torch.where(used, b1 * self.exp_avg + (1.0 - b1) * g,
                         self.exp_avg)
        v1 = torch.where(used, b2 * self.exp_avg_sq + (1.0 - b2) * g * g,
                         self.exp_avg_sq)
        vmax1 = torch.maximum(self.max_exp_avg_sq, v1)
        t = torch.clamp(self.counts, min=1).to(g.dtype)[owner]
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = torch.sqrt(1.0 - torch.pow(b2, t))
        delta = -(wd * p_flat + lr * (m1 / bc1) / (torch.sqrt(vmax1) / bc2
                                                   + eps))
        delta = torch.where(used, delta, torch.zeros_like(delta))
        self.exp_avg.copy_(m1)
        self.exp_avg_sq.copy_(v1)
        self.max_exp_avg_sq.copy_(vmax1)
        torch._foreach_add_(
            params, [d.view_as(p) for d, p in
                     zip(delta.split(self._sizes), params)])
        self.global_step += 1


def make_optimizer(params: Iterable[torch.Tensor], epoch_length: int,
                   cycle_length: int, min_lr: float, max_lr: float,
                   beta1: float, min_beta2: float, max_beta2: float,
                   wd: float, eps: float = 1e-8, **_unused) -> AmsgradWD:
    """The training optimizer from the reference's config keys."""
    return AmsgradWD(
        params,
        lr=cosine_cycle_schedule(epoch_length, cycle_length, min_lr, max_lr),
        b1=beta1,
        b2=cosine_cycle_schedule(epoch_length, cycle_length, min_beta2,
                                 max_beta2),
        eps=eps, weight_decay=wd)
