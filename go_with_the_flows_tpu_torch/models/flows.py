"""Conditional RealNVP coupling flows (counterpart of
go_with_the_flows_tpu/models/flows.py); their BatchNorms follow the
module's train/eval mode.

Module and parameter names follow the reference's torch modules, as
go_with_the_flows_tpu/utils/torch_import.py spells them
(e.g. `flows.{i}.nvp{j}.T_mu_0.mu_sd0.weight`), so that a reference
state_dict maps onto the port key by key.

Two couplings with different formulas, both reproduced exactly:

  * point coupling: logvar = softsign(T_logvar), scale =
    sqrt(eps + exp(logvar)), applied over all three channels with mu and
    logvar zero-filled on the kept channels, so kept channels are scaled
    by sqrt(1 + eps), not 1;
  * latent coupling: logvar = log(eps + exp(T_logvar)),
    g' = exp(0.5 * logvar) * g + mu.

Stacks return (output, sum of the per-coupling logvars). Inverse runs
the exact reverse coupling order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import BatchNorm, Linear, SharedDot

EPS = 1e-6
WEIGHT_STD = 0.01

# warp patterns of a coupling triple: pattern 0 warps one channel at a
# time, pattern 1 warps pairs (JAX flows.py _TRIPLE_PATTERNS)
TRIPLE_PATTERNS = {
    0: ((0,), (1,), (2,)),
    1: ((0, 1), (0, 2), (1, 2)),
}


def point_decoder_param_count(n_flows: int, f_features: int,
                              g_features: int) -> int:
    """Parameter-count formula used for mixture parameter budgeting."""
    per_coupling = (18 * f_features + 4 * f_features * g_features
                    + 6 * f_features ** 2)
    return n_flows * 3 * per_coupling


def _as_slice(inds: Tuple[int, ...]) -> slice:
    """Channel indices as a slice. Selecting and scattering channels by a
    slice stays on the device; a list index is first copied from the host,
    which synchronises the card once per use. Every warp pattern here is
    an increasing arithmetic progression."""
    step = inds[1] - inds[0] if len(inds) > 1 else 1
    if step < 1 or tuple(inds) != tuple(range(inds[0], inds[-1] + 1, step)):
        raise ValueError(f"channel indices {inds} are not an increasing "
                         "arithmetic progression")
    return slice(inds[0], inds[-1] + 1, step)


def _set_modules(parent: nn.Module, **children: nn.Module) -> None:
    # reference names such as `mu_sd1_film_w0` are built at run time
    for name, child in children.items():
        parent.add_module(name, child)


class FiLMNet(nn.Module):
    """Linear(g -> f, no bias) -> BN -> SiLU -> Linear(f -> f) with a
    near-identity last layer; children `{short}0`, `{short}0_bn`,
    `{short}1`."""

    def __init__(self, short: str, f: int, g: int, stack: Sequence[int]):
        super().__init__()
        self.short = short
        _set_modules(self, **{
            f"{short}0": Linear(g, f, bias=False, stack=stack),
            f"{short}0_bn": BatchNorm(f, stack=stack),
            f"{short}1": Linear(f, f, stack=stack, init_std=WEIGHT_STD),
        })

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        s = self.short
        h = getattr(self, f"{s}0_bn")(getattr(self, f"{s}0")(g))
        return getattr(self, f"{s}1")(F.silu(h))


class _PointT0(nn.Module):
    """SharedDot -> BN -> ReLU -> SharedDot -> BN(affine-free)."""

    def __init__(self, head: str, n_keep: int, f: int, stack):
        super().__init__()
        self.head = head
        _set_modules(self, **{
            f"{head}_sd0": SharedDot(n_keep, f, stack=stack),
            f"{head}_sd0_bn": BatchNorm(f, stack=stack),
            f"{head}_sd1": SharedDot(f, f, stack=stack),
            f"{head}_sd1_bn": BatchNorm(f, affine=False, stack=stack),
        })

    def forward(self, p_keep: torch.Tensor) -> torch.Tensor:
        h = self.head
        x = getattr(self, f"{h}_sd0_bn")(getattr(self, f"{h}_sd0")(p_keep))
        x = getattr(self, f"{h}_sd1")(F.relu(x))
        return getattr(self, f"{h}_sd1_bn")(x)


class _PointT1(nn.Module):
    """The head's output SharedDot(f -> |warp|, bias), near-identity."""

    def __init__(self, head: str, f: int, n_warp: int, stack):
        super().__init__()
        self.head = head
        self.add_module(f"{head}_sd2", SharedDot(
            f, n_warp, bias=True, stack=stack, init_std=WEIGHT_STD))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{self.head}_sd2")(h)


class CondAffineCoupling3D(nn.Module):
    """One conditional affine coupling over the xyz channels of
    p (..., B, 3, N), conditioned on the kept channels and g (B, G).

    Each head (logvar, mu) computes
      T1(relu((eps + exp(FiLM_w(g))) * T0(p_keep) + FiLM_b(g))).
    Returns (p_out, logvar) with logvar zero on the kept channels.
    """

    def __init__(self, warp_inds: Tuple[int, ...], f: int, g: int,
                 stack: Sequence[int] = ()):
        super().__init__()
        self.warp_inds = tuple(warp_inds)
        self.keep_inds = tuple(i for i in range(3) if i not in warp_inds)
        self._warp, self._keep = _as_slice(self.warp_inds), _as_slice(
            self.keep_inds)
        for head in ("mu", "logvar"):
            _set_modules(self, **{
                f"T_{head}_0": _PointT0(head, len(self.keep_inds), f, stack),
                f"T_{head}_0_cond_w": FiLMNet(f"{head}_sd1_film_w", f, g,
                                              stack),
                f"T_{head}_0_cond_b": FiLMNet(f"{head}_sd1_film_b", f, g,
                                              stack),
                f"T_{head}_1": _PointT1(head, f, len(self.warp_inds), stack),
            })

    def _head(self, head: str, p_keep, g):
        h = getattr(self, f"T_{head}_0")(p_keep)
        w = getattr(self, f"T_{head}_0_cond_w")(g)
        b = getattr(self, f"T_{head}_0_cond_b")(g)
        h = (EPS + torch.exp(w))[..., None] * h + b[..., None]
        return getattr(self, f"T_{head}_1")(F.relu(h))

    def forward(self, p, g, mode: str = "direct"):
        p_keep = p[..., self._keep, :]
        lv_w = F.softsign(self._head("logvar", p_keep, g))
        mu_w = self._head("mu", p_keep, g)
        logvar = torch.zeros_like(p)
        mu = torch.zeros_like(p)
        logvar[..., self._warp, :] = lv_w
        mu[..., self._warp, :] = mu_w
        scale = torch.sqrt(EPS + torch.exp(logvar))
        if mode == "direct":
            return scale * p + mu, logvar
        if mode == "inverse":
            return (p - mu) / scale, logvar
        raise ValueError(f"unknown mode: {mode}")


class _CouplingTriple(nn.Module):
    def __init__(self, pattern: int, f: int, g: int, stack):
        super().__init__()
        for j, warp in enumerate(TRIPLE_PATTERNS[pattern]):
            self.add_module(f"nvp{j + 1}",
                            CondAffineCoupling3D(warp, f, g, stack))


class PointDecoderFlow(nn.Module):
    """`n_flows` coupling triples; flow i uses warp pattern i % 2.

    `stack=(K,)` holds K independent decoders as one module: points are
    then (K, B, 3, N) and every weight has a leading K axis.
    """

    def __init__(self, n_flows: int, f_features: int, g_features: int,
                 stack: Sequence[int] = ()):
        super().__init__()
        self.n_flows = n_flows
        self.f_features = f_features
        self.stack = tuple(stack)
        self.flows = nn.ModuleList(
            _CouplingTriple(i % 2, f_features, g_features, stack)
            for i in range(n_flows))

    def couplings(self):
        """The couplings in direct order."""
        return [getattr(t, f"nvp{j}") for t in self.flows for j in (1, 2, 3)]

    def forward(self, p, g, mode: str = "direct"):
        order = self.couplings()
        if mode == "inverse":
            order = order[::-1]
        lv_sum = torch.zeros_like(p)
        for coupling in order:
            p, lv = coupling(p, g, mode)
            lv_sum = lv_sum + lv
        return p, lv_sum


class _LatentT0(nn.Module):
    """Linear(keep -> f, no bias) -> BN -> SiLU -> Linear(f -> |warp|),
    near-identity last layer."""

    def __init__(self, head: str, n_keep: int, f: int, n_warp: int):
        super().__init__()
        self.head = head
        _set_modules(self, **{
            f"{head}_mlp0": Linear(n_keep, f, bias=False),
            f"{head}_mlp0_bn": BatchNorm(f),
            f"{head}_mlp1": Linear(f, n_warp, init_std=WEIGHT_STD),
        })

    def forward(self, g_keep):
        h = self.head
        x = getattr(self, f"{h}_mlp0_bn")(getattr(self, f"{h}_mlp0")(g_keep))
        return getattr(self, f"{h}_mlp1")(F.silu(x))


class LatentAffineCoupling(nn.Module):
    """Affine coupling over the g-dimensional latent:
    logvar = log(eps + exp(net_logvar)); direct g' = exp(lv/2) g + mu,
    inverse g' = exp(-lv/2) (g - mu)."""

    def __init__(self, g_features: int, n_features: int,
                 warp_inds: Tuple[int, ...]):
        super().__init__()
        warp = set(warp_inds)
        self.warp_inds = tuple(warp_inds)
        self.keep_inds = tuple(i for i in range(g_features) if i not in warp)
        self._warp, self._keep = _as_slice(self.warp_inds), _as_slice(
            self.keep_inds)
        for head in ("mu", "logvar"):
            self.add_module(f"T_{head}_0", _LatentT0(
                head, len(self.keep_inds), n_features, len(self.warp_inds)))

    def forward(self, g, mode: str = "direct"):
        g_keep = g[..., self._keep]
        lv_w = torch.log(EPS + torch.exp(self.T_logvar_0(g_keep)))
        mu_w = self.T_mu_0(g_keep)
        logvar = torch.zeros_like(g)
        mu = torch.zeros_like(g)
        logvar[..., self._warp] = lv_w
        mu[..., self._warp] = mu_w
        if mode == "direct":
            return torch.exp(0.5 * logvar) * g + mu, logvar
        if mode == "inverse":
            return torch.exp(-0.5 * logvar) * (g - mu), logvar
        raise ValueError(f"unknown mode: {mode}")


def couple_patterns(g_features: int, pattern: int):
    """Warp index sets of a latent coupling couple: pattern 0 = (even,
    odd), pattern 1 = (first half, second half)."""
    idx = tuple(range(g_features))
    if pattern == 0:
        return idx[::2], idx[1::2]
    return idx[: g_features // 2], idx[g_features // 2:]


class _LatentCouple(nn.Module):
    def __init__(self, pattern: int, n_features: int, g_features: int):
        super().__init__()
        for j, warp in enumerate(couple_patterns(g_features, pattern)):
            self.add_module(f"nvp{j + 1}", LatentAffineCoupling(
                g_features, n_features, warp))


class LatentPriorFlow(nn.Module):
    """`n_flows` latent coupling couples with alternating patterns."""

    def __init__(self, n_flows: int, n_features: int, g_features: int):
        super().__init__()
        self.flows = nn.ModuleList(
            _LatentCouple(i % 2, n_features, g_features)
            for i in range(n_flows))

    def forward(self, g, mode: str = "direct"):
        order = [c for couple in self.flows for c in (couple.nvp1, couple.nvp2)]
        if mode == "inverse":
            order = order[::-1]
        lv_sum = torch.zeros_like(g)
        for coupling in order:
            g, lv = coupling(g, mode)
            lv_sum = lv_sum + lv
        return g, lv_sum
