"""ResNet-18 image encoder for single-view reconstruction (counterpart of
go_with_the_flows_tpu/models/resnet.py).

A torchvision-style ResNet-18 with a 4-channel input (RGB and a
grayscale channel) and a BatchNorm + ReLU after the fc head, no
pretrained weights. Images are NCHW, (B, 4, H, W), the reference's
layout (the JAX package takes NHWC).

The convolutions are `nn.Conv2d` (cuDNN on the card, at fp32: the TF32
switches are off, ops/precision.py) and the BatchNorms torch's fused
`batch_norm` in one process; inside a process group of several ranks
the training-mode BatchNorms take their statistics over the global
batch (`ops/layers.batch_stats`). The JAX package computes both with
XLA, outside any Pallas kernel. Module names follow the JAX package's (`conv1`, `bn1`,
`layer{s}_{b}.{conv1,bn1,conv2,bn2,downsample_conv,downsample_bn}`,
`fc`, `fc_bn`).

Parameters are drawn with the JAX package's initialisers from an
explicit generator: convolutions kaiming-normal over fan_out, the fc
layer flax's Dense default (LeCun truncated normal, zero bias).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import (Linear, batch_stats, reset_parameters,
                          update_running_stats)
from ..parallel import dist


class Conv2d(nn.Conv2d):
    """Bias-free k x k convolution with padding k // 2, weight
    (out, in, k, k) drawn N(0, 2 / (out k k)) (torch's
    kaiming_normal_(mode='fan_out'))."""

    def __init__(self, in_features: int, out_features: int, kernel: int,
                 stride: int):
        super().__init__(in_features, out_features, kernel, stride,
                         padding=kernel // 2, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:  # nn.Conv2d's constructor: drawn later
            return
        out, _, kh, kw = self.weight.shape
        std = math.sqrt(2.0 / (out * kh * kw))
        self.weight.copy_(
            torch.randn(self.weight.shape, generator=generator) * std)


class FusedBatchNorm(nn.Module):
    """BatchNorm over the channel axis of (B, C) or (B, C, H, W) through
    torch's fused `batch_norm`, with the JAX package's TorchBatchNorm
    settings: eps 1e-5, running statistics blended with momentum 0.9 in
    the flax convention (torch's 0.1), the running var Bessel-corrected.
    Training mode (`self.training`) normalises with the batch statistics
    and updates the running ones in place.

    Inside a process group of several ranks (parallel/dist.py) each
    rank's input is its shard of the global batch, and training mode
    takes the global batch's statistics, as the JAX package's
    TorchBatchNorm does under a sharded batch: (mean, biased var) from
    `batch_stats` (E[x^2] - E[x]^2 over every rank's sums, differentiable
    across the ranks), the running var Bessel-corrected with the global
    count. One process keeps torch's fused kernel."""

    def __init__(self, num_features: int):
        super().__init__()
        self.eps = 1e-5
        self.momentum = 0.9
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and dist.active()):
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, self.training,
                                1.0 - self.momentum, self.eps)
        red = (0,) + tuple(range(2, x.ndim))
        mean, var = batch_stats(x, red)
        n = math.prod(x.shape[d] for d in red) * dist.world_size()
        update_running_stats([self], [mean.detach()], [var.detach()], n)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


class Dense(Linear):
    """Linear layer with flax's default Dense initialisers: the weight a
    normal truncated at +-2 standard deviations, scaled to variance
    1 / in_features; the bias 0."""

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # jax.nn.initializers.lecun_normal: truncated N(0, 1) on [-2, 2]
        # over the truncated normal's own std, 0.8796...
        std = math.sqrt(1.0 / self.in_features) / 0.87962566103423978
        draw = nn.init.trunc_normal_(torch.empty(self.weight.shape),
                                     generator=generator)
        self.weight.copy_(draw * std)
        self.bias.zero_()


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with BatchNorm; the shortcut is a strided 1x1
    convolution with BatchNorm when the stride or the width changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride)
        self.bn1 = FusedBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1)
        self.bn2 = FusedBatchNorm(features)
        if stride != 1 or in_features != features:
            self.downsample_conv = Conv2d(in_features, features, 1, stride)
            self.downsample_bn = FusedBatchNorm(features)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet18(nn.Module):
    """4-channel-input ResNet-18 with an fc -> BatchNorm -> ReLU head:
    (B, 4, H, W) images -> (B, num_classes) features.

    Parameters are drawn from `generator` (a CPU torch.Generator, so one
    seed gives the same weights on every device; None means seed 0)."""

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_features: Sequence[int] = (64, 128, 256, 512),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(4, 64, 7, 2)
        self.bn1 = FusedBatchNorm(64)
        self.blocks = []
        prev = 64
        for s, (n_blocks, feats) in enumerate(zip(stage_sizes,
                                                  stage_features)):
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                name = f"layer{s + 1}_{b}"
                self.add_module(name, BasicBlock(prev, feats, stride))
                self.blocks.append(name)
                prev = feats
        self.fc = Dense(prev, num_classes)
        self.fc_bn = FusedBatchNorm(num_classes)
        reset_parameters(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        # -inf padding, as flax's max_pool pads
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = self.fc(h.mean(dim=(2, 3)))  # global average pool
        return F.relu(self.fc_bn(h))
