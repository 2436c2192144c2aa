"""Primitive layers (counterpart of go_with_the_flows_tpu/ops/layers.py).

Point features are (..., B, C, N) and latent features (..., B, C). Every
layer takes a `stack` shape: its parameters get that leading shape and
it maps inputs with the same leading shape (or none, then they are
broadcast). The mixture uses `stack=(K,)` to hold its K point decoders
as one module with K-stacked weights.

Products are matmuls, never `conv1d`: cuDNN convolutions default to TF32,
and the port keeps full fp32 (ops/precision.py).

Parameters are drawn by `reset_parameters(generator)` with the JAX
package's initialisers (torch-style uniform for plain layers, normal for
the near-identity heads).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel import dist
from . import precision  # noqa: F401  (sets the fp32 switches)


class SharedDot(nn.Module):
    """Per-point linear map: out[..., b, o, n] = sum_i W[..., o, i] x[..., b, i, n]
    (+ bias[..., o]). Weight (..., out, in), as the JAX package's kernel.

    `init_std=None` draws the torch kaiming-uniform scale of the
    reference's (1, out, in) weight, U(+-sqrt(6 / (out * in)));
    otherwise N(0, init_std). The bias starts at 0.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, stack: Sequence[int] = (),
                 init_std: Optional[float] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.init_std = init_std
        self.weight = nn.Parameter(
            torch.empty(*stack, out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(*stack, out_features))
                     if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            bound = math.sqrt(6.0 / (self.out_features * self.in_features))
            _uniform(self.weight, bound, generator)
        else:
            _normal(self.weight, self.init_std, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (..., 1, out, in) @ (..., B, in, N) -> (..., B, out, N)
        y = torch.matmul(self.weight.unsqueeze(-3), x)
        if self.bias is not None:
            y = y + self.bias[..., None, :, None]
        return y


class Linear(nn.Module):
    """Dense layer on (..., B, in) -> (..., B, out), weight (..., out, in).

    `init_std=None` draws torch's nn.Linear scale U(+-1/sqrt(in));
    otherwise N(0, init_std). The bias starts at `bias_value`.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, stack: Sequence[int] = (),
                 init_std: Optional[float] = None, bias_value: float = 0.0):
        super().__init__()
        self.in_features = in_features
        self.init_std = init_std
        self.bias_value = bias_value
        self.weight = nn.Parameter(
            torch.empty(*stack, out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(*stack, out_features))
                     if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            _uniform(self.weight, 1.0 / math.sqrt(self.in_features),
                     generator)
        else:
            _normal(self.weight, self.init_std, generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.transpose(-1, -2))
        if self.bias is not None:
            y = y + self.bias[..., None, :]
        return y


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis, as the JAX package's TorchBatchNorm:
    (x - mean) * rsqrt(var + eps), then * weight + bias when affine.

    Eval mode uses the running statistics. Training mode
    (`self.training`) normalises with the batch statistics, reduced over
    every axis but the stack axes and the channel axis ((B, N) for point
    features, B for latents), with the biased variance
    max(E[x^2] - E[x]^2, 0), and blends them into the running statistics
    with `momentum` in the flax convention (0.9 here is torch's 0.1):
    running_var takes the Bessel-corrected variance var * n / (n - 1),
    as torch does. Inside a process group of several ranks
    (parallel/dist.py) the batch is the global one, each rank's input its
    shard of it (SyncBatchNorm's semantics, the JAX mesh's).
    """

    def __init__(self, num_features: int, affine: bool = True,
                 stack: Sequence[int] = (), eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.stack = tuple(stack)
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("running_mean",
                             torch.zeros(*stack, num_features))
        self.register_buffer("running_var", torch.ones(*stack, num_features))
        if affine:
            self.weight = nn.Parameter(torch.ones(*stack, num_features))
            self.bias = nn.Parameter(torch.zeros(*stack, num_features))
        else:
            self.weight = self.bias = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (..., B, C) or (..., B, C, N): one trailing axis after C for points
        s = len(self.stack)
        trailing = x.ndim - s - 2
        shape = self.running_mean.shape[:-1] + (1, -1) + (1,) * trailing

        def view(t):
            return t.reshape(shape)

        if self.training:
            red = (s,) + tuple(range(s + 2, x.ndim))
            n = math.prod(x.shape[i] for i in red) * dist.world_size()
            mean, var = batch_stats(x, red)
            update_running_stats([self], [mean.detach()], [var.detach()], n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - view(mean)) * torch.rsqrt(view(var) + self.eps)
        if self.weight is not None:
            y = y * view(self.weight) + view(self.bias)
        return y


def batch_stats(x: torch.Tensor, dims: Sequence[int]):
    """(mean, biased var) of x over `dims`; inside a process group of
    several ranks (parallel/dist.py) over every rank's x too: each rank's
    sums of x and x^2 summed over the ranks (differentiably, the backward
    summing the cotangents over the ranks too), over a count world_size()
    times this rank's (the ranks hold equal shards)."""
    if not dist.active():
        mean = x.mean(dim=dims)
        return mean, torch.clamp(x.square().mean(dim=dims) - mean.square(),
                                 min=0.0)
    n = math.prod(x.shape[d] for d in dims) * dist.world_size()
    sums = dist.sum_over_ranks(
        torch.stack([x.sum(dim=dims), x.square().sum(dim=dims)]))
    mean = sums[0] / n
    return mean, torch.clamp(sums[1] / n - mean.square(), min=0.0)


@torch.no_grad()
def update_running_stats(bns: Sequence[BatchNorm],
                         means: Sequence[torch.Tensor],
                         variances: Sequence[torch.Tensor], n: int) -> None:
    """Blend batch statistics (mean, biased var), each over n values,
    into the running statistics of BatchNorms of one momentum m:
    ra = m * ra + (1 - m) * batch, the running variance taking
    var * n / (n - 1). One launch per operation for the whole list."""
    m = bns[0].momentum
    if any(bn.momentum != m for bn in bns):
        raise ValueError("update_running_stats: BatchNorms of different "
                         "momenta")
    bessel = float(n) / float(max(n - 1, 1))
    ra_mean = [bn.running_mean for bn in bns]
    ra_var = [bn.running_var for bn in bns]
    torch._foreach_mul_(ra_mean, m)
    torch._foreach_add_(ra_mean, list(means), alpha=1.0 - m)
    torch._foreach_mul_(ra_var, m)
    torch._foreach_add_(ra_var, torch._foreach_mul(list(variances), bessel),
                        alpha=1.0 - m)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every layer's parameters under `module` from `generator`, in
    module registration order (the draws happen on the CPU, so one seed
    gives the same weights on every device)."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def _uniform(t: torch.Tensor, bound: float, generator) -> None:
    draw = torch.rand(t.shape, generator=generator, dtype=t.dtype)
    t.copy_((2.0 * draw - 1.0) * bound)


def _normal(t: torch.Tensor, std: float, generator) -> None:
    t.copy_(torch.randn(t.shape, generator=generator, dtype=t.dtype) * std)
