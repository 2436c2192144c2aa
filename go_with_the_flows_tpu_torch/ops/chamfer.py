"""Chamfer / nearest-neighbour distance, plain PyTorch (counterpart of
go_with_the_flows_tpu/ops/chamfer.py).

Clouds are (B, N, 3). Squared distances are sum_c (a_c - b_c)^2 summed
channel by channel, never the |a|^2 + |b|^2 - 2ab expansion (and never
`torch.cdist`, which switches to the expansion past 25 points): the
expansion's cancellation error does not shrink with the distance.

These are the plain versions. The hot path calls the kernel wrappers of
`ops/kernels/chamfer.py`, which use these for CPU tensors.
"""

from __future__ import annotations

import torch

# elements of one (b, N, M) distance block; bounds the plain version's
# memory at large batch
_BLOCK_ELEMS = 1 << 27


def pairwise_sqdists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared euclidean distances,
    accumulated as ((dx^2 + dy^2) + dz^2)."""
    d = None
    for c in range(3):
        diff = a[:, :, None, c] - b[:, None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def nn_distance(a: torch.Tensor, b: torch.Tensor):
    """(dist_a (B,N), idx_a (B,N), dist_b (B,M), idx_b (B,M)): per-point
    min squared distance and first argmin, both directions. Works in
    batch blocks so that no distance block exceeds 2^27 elements."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    step = max(1, _BLOCK_ELEMS // max(N * M, 1))
    outs = []
    for s in range(0, B, step):
        d = pairwise_sqdists(a[s:s + step], b[s:s + step])
        dist_a, idx_a = d.min(dim=2)
        dist_b, idx_b = d.min(dim=1)
        outs.append((dist_a, idx_a, dist_b, idx_b))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def chamfer(a: torch.Tensor, b: torch.Tensor):
    """(dl, dr): per-point min squared distances."""
    dist_a, _, dist_b, _ = nn_distance(a, b)
    return dist_a, dist_b
