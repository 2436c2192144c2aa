"""Bidirectional nearest-neighbour distance: the CUDA kernel
`csrc/nn_distance.cu`, its plain PyTorch version, and the differentiable
Chamfer built on it.

Replaces `_nn_kernel` of go_with_the_flows_tpu/ops/pallas/chamfer_kernel.py
(`nn_distance_pallas`, `chamfer_pallas`). As there, the backward is not a
kernel: it gathers each point's nearest neighbour and scatter-adds
2 g (x - y) into both clouds (the JAX backward is an XLA gather/scatter).
"""

from __future__ import annotations

import torch

from .. import chamfer as plain_chamfer
from . import build


def nn_distance_plain(a: torch.Tensor, b: torch.Tensor,
                      with_idx: bool = True):
    """Plain PyTorch version of the kernel (ops/chamfer.py)."""
    dist_a, idx_a, dist_b, idx_b = plain_chamfer.nn_distance(a, b)
    if with_idx:
        return dist_a, idx_a, dist_b, idx_b
    return dist_a, dist_b


def nn_distance(a: torch.Tensor, b: torch.Tensor, with_idx: bool = True):
    """a (B, N, 3), b (B, M, 3) -> (dist_a (B,N), idx_a (B,N),
    dist_b (B,M), idx_b (B,M)); `with_idx=False` returns (dist_a, dist_b)
    and skips the index stores. Indices are int64, the first argmin.
    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return nn_distance_plain(a, b, with_idx)
    if a.ndim != 3 or b.ndim != 3 or a.shape[2] != 3 or b.shape[2] != 3 \
            or a.shape[0] != b.shape[0]:
        raise ValueError(f"nn_distance: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}, expected (B, N, 3), (B, M, 3)")
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    if min(B, N, M) < 1 or B > 65535:
        raise ValueError(f"nn_distance: B={B}, N={N}, M={M} outside the "
                         "kernel's launch limits")
    build.check_tensors((a, b), a.device)
    dist_a = a.new_empty(B, N)
    dist_b = a.new_empty(B, M)
    idx_a = idx_b = None
    if with_idx:
        idx_a = torch.empty(B, N, dtype=torch.int32, device=a.device)
        idx_b = torch.empty(B, M, dtype=torch.int32, device=a.device)
    lib = build.library()
    with torch.cuda.device(a.device):
        code = lib.gwtf_nn_distance(
            a.data_ptr(), b.data_ptr(), dist_a.data_ptr(),
            idx_a.data_ptr() if with_idx else None, dist_b.data_ptr(),
            idx_b.data_ptr() if with_idx else None, B, N, M,
            build.stream_handle(a.device))
    nn_distance.launches += 1
    build.check(lib, code, "nn_distance")
    if with_idx:
        return dist_a, idx_a.long(), dist_b, idx_b.long()
    return dist_a, dist_b


nn_distance.launches = 0


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        if not any(ctx.needs_input_grad):
            # the metric path differentiates nothing: skip the indices
            return nn_distance(a, b, with_idx=False)
        dist_a, idx_a, dist_b, idx_b = nn_distance(a, b)
        ctx.save_for_backward(a, b, idx_a, idx_b)
        return dist_a, dist_b

    @staticmethod
    def backward(ctx, g_a, g_b):
        a, b, idx_a, idx_b = ctx.saved_tensors
        b_near = torch.gather(b, 1, idx_a[..., None].expand(-1, -1, 3))
        a_near = torch.gather(a, 1, idx_b[..., None].expand(-1, -1, 3))
        dl = 2.0 * g_a[..., None] * (a - b_near)  # d dist_a / d a
        dr = 2.0 * g_b[..., None] * (b - a_near)  # d dist_b / d b
        return (_scatter_add(dl, idx_b, -dr), _scatter_add(dr, idx_a, -dl))


def _scatter_add(base, idx, upd):
    """base (B, L, 3) plus upd (B, K, 3) added at rows idx (B, K)."""
    B, L, _ = base.shape
    rows = idx + torch.arange(B, device=idx.device)[:, None] * L
    out = base.reshape(B * L, 3).clone()
    out.index_add_(0, rows.reshape(-1), upd.reshape(-1, 3))
    return out.reshape(B, L, 3)


def chamfer(a: torch.Tensor, b: torch.Tensor):
    """(dl (B,N), dr (B,M)) per-point min squared distances, differentiable
    in both clouds."""
    return _Chamfer.apply(a, b)
