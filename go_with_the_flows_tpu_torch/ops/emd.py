"""Approximate Earth Mover's Distance (auction / soft-assignment match),
plain PyTorch (counterpart of go_with_the_flows_tpu/ops/emd.py).

Iterative proportional soft assignment with per-point capacities over 9
temperature levels, level = -4^j for j = 7..-1. Per level:

    suml_i   = 1e-9 + sum_j exp(level * D_ij) * remainR_j
    ratioL_i = remainL_i / suml_i
    sumr_j   = remainR_j * sum_i exp(level * D_ij) * ratioL_i
    ratioR_j = min(remainR_j / (sumr_j + 1e-9), 1) * remainR_j
    remainR  = max(0, remainR - sumr)
    w_ij     = exp(level * D_ij) * ratioL_i * ratioR_j
    match   += w;  remainL = max(0, remainL - sum_j w_ij)

with D the squared distances. Clouds of different sizes get integer
capacities (C integer division). The cost is sum_ij match_ij * ||a_i - b_j||
and its gradient holds the match constant.

This is the algorithm's plain reference: it builds the (B, N, M) match.
The metrics call `ops/kernels/emd.emd_cost`, whose plain version keeps the
match implicit.
"""

from __future__ import annotations

import torch

from . import precision  # noqa: F401  (sets the fp32 switches)
from .chamfer import pairwise_sqdists

N_LEVELS = 9


def levels():
    """The 9 temperatures -4^(7-j), j = 0..8; powers of 4 are exact in
    fp32, and an error of 1e-6 in a temperature moves exp(level * d) by
    about 1 % where |level| * d is near 1e4."""
    return [-(4.0 ** (7 - j)) for j in range(N_LEVELS)]


def _capacities(n: int, m: int):
    """(multiL, multiR): integer multiplicities for n != m, with C integer
    division."""
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


def approx_match(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Soft match matrix (B, N, M) between clouds a (B, N, 3) and
    b (B, M, 3)."""
    B, N, _ = a.shape
    M = b.shape[1]
    multi_l, multi_r = _capacities(N, M)
    d = pairwise_sqdists(a, b)
    match = torch.zeros_like(d)
    remain_l = d.new_full((B, N), multi_l)
    remain_r = d.new_full((B, M), multi_r)
    for level in levels():
        e = torch.exp(level * d)
        suml = 1e-9 + torch.einsum("bnm,bm->bn", e, remain_r)
        ratio_l = remain_l / suml
        sumr = remain_r * torch.einsum("bnm,bn->bm", e, ratio_l)
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        w = e * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + w
        remain_l = torch.clamp(remain_l - w.sum(dim=2), min=0.0)
    return match


def match_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """EMD cost (B,): sum_ij match_ij * ||a_i - b_j||, differentiable in
    both clouds with the match held constant."""
    match = approx_match(a.detach(), b.detach())
    dist = torch.sqrt(torch.clamp(pairwise_sqdists(a, b), min=1e-12))
    return (match * dist).sum(dim=(1, 2))


def emd_approx(sample: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Normalised EMD, cost / N."""
    n = sample.shape[1]
    if n != ref.shape[1]:
        raise ValueError("EMD requires equal cloud sizes")
    return match_cost(sample, ref) / float(n)
