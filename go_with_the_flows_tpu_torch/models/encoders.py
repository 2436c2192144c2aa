"""Encoders (counterpart of go_with_the_flows_tpu/models/encoders.py).

Point clouds are (B, C, N); latent features are (B, F). Module names
follow the reference's torch modules (`features.init_sd`,
`features.mlp0_bn`, `mus.mu_mlp0`, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import BatchNorm, Linear, SharedDot


class PointNetCloudEncoder(nn.Module):
    """Per-point SharedDot + BN + ReLU stack, channels
    init_n_channels -> init_n_features -> n_features[0..]. The caller
    max-pools over the point axis."""

    def __init__(self, init_n_channels: int, init_n_features: int,
                 n_features: Sequence[int]):
        super().__init__()
        self.n_stages = len(n_features)
        self.features = nn.Module()
        self.features.add_module(
            "init_sd", SharedDot(init_n_channels, init_n_features))
        self.features.add_module("init_sd_bn", BatchNorm(init_n_features))
        prev = init_n_features
        for i, f in enumerate(n_features):
            self.features.add_module(f"sd{i}", SharedDot(prev, f))
            self.features.add_module(f"sd{i}_bn", BatchNorm(f))
            prev = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.features
        h = F.relu(m.init_sd_bn(m.init_sd(x)))
        for i in range(self.n_stages):
            h = F.relu(getattr(m, f"sd{i}_bn")(getattr(m, f"sd{i}")(h)))
        return h


class FeatureEncoder(nn.Module):
    """n-layer Linear + BN + SiLU MLP with a `mus` head and, unless
    deterministic, a `logvars` head (near-identity heads: weight
    N(0, std), constant bias). `bn_momentum` is its BatchNorms' running
    statistics momentum (flax convention)."""

    def __init__(self, in_features: int, n_layers: int,
                 latent_space_size: int, deterministic: bool = False,
                 mu_weight_std: float = 0.001, mu_bias: float = 0.0,
                 logvar_weight_std: float = 0.01, logvar_bias: float = 0.0,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.n_layers = n_layers
        self.deterministic = deterministic
        self.features = nn.Module()
        for i in range(n_layers):
            self.features.add_module(
                f"mlp{i}", Linear(in_features, in_features, bias=False))
            self.features.add_module(
                f"mlp{i}_bn", BatchNorm(in_features, momentum=bn_momentum))
        self.mus = nn.Module()
        self.mus.mu_mlp0 = Linear(in_features, latent_space_size,
                                  init_std=mu_weight_std, bias_value=mu_bias)
        if not deterministic:
            self.logvars = nn.Module()
            self.logvars.logvar_mlp0 = Linear(
                in_features, latent_space_size, init_std=logvar_weight_std,
                bias_value=logvar_bias)

    def forward(self, x: torch.Tensor):
        h = x
        for i in range(self.n_layers):
            h = getattr(self.features, f"mlp{i}")(h)
            h = F.silu(getattr(self.features, f"mlp{i}_bn")(h))
        mus = self.mus.mu_mlp0(h)
        if self.deterministic:
            return mus
        return mus, self.logvars.logvar_mlp0(h)


class WeightsEncoder(FeatureEncoder):
    """Deterministic FeatureEncoder whose mus are log-softmax'd into
    mixture log-weights."""

    def __init__(self, in_features: int, n_layers: int, n_components: int,
                 mu_weight_std: float = 0.001, mu_bias: float = 0.0):
        super().__init__(in_features, n_layers, n_components,
                         deterministic=True, mu_weight_std=mu_weight_std,
                         mu_bias=mu_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(super().forward(x), dim=-1)
