"""Auction EMD cost with its gradient: the CUDA kernels of `csrc/emd.cu`
and their plain PyTorch versions.

Replaces `_emd_kernel` (`emd_cost_pallas`) and `_emd_bwd_kernel`
(`_emd_backward`) of go_with_the_flows_tpu/ops/pallas/emd_kernel.py.
The match stays implicit: it is fully determined by the per-level
vectors ratioL (B, 9, N) and ratioR (B, 9, M),

    match_ij = sum_l exp(level_l * D_ij) * ratioL_l,i * ratioR_l,j,

so the forward keeps those as its residuals when a gradient is wanted,
and the backward rebuilds the match from them.
"""

from __future__ import annotations

import torch

from ..chamfer import pairwise_sqdists
from ..emd import N_LEVELS, _capacities, levels
from . import build

# elements of one (b, N, M) block of the plain versions: bounds their
# memory at large batch
_BLOCK_ELEMS = 1 << 27
# dynamic shared memory a block of an H100 may ask for: 227 KB, less the
# 128 B of static shared memory of the forward kernels
SMEM_LIMIT = 232448 - 128


def _blocks(B: int, N: int, M: int):
    step = max(1, _BLOCK_ELEMS // max(N * M, 1))
    return [(s, min(B, s + step)) for s in range(0, B, step)]


def _cost_block(a, b, save_ratios: bool):
    B, N, _ = a.shape
    M = b.shape[1]
    multi_l, multi_r = _capacities(N, M)
    d = pairwise_sqdists(a, b)
    sqd = torch.sqrt(torch.clamp(d, min=1e-12))
    remain_l = d.new_full((B, N), multi_l)
    remain_r = d.new_full((B, M), multi_r)
    cost = d.new_zeros(B)
    rls, rrs = [], []
    for level in levels():
        e = torch.exp(level * d)
        ratio_l = remain_l / (1e-9 + (e * remain_r[:, None, :]).sum(dim=2))
        sumr = remain_r * (e * ratio_l[:, :, None]).sum(dim=1)
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        p = e * ratio_r[:, None, :]
        cost = cost + (ratio_l * (p * sqd).sum(dim=2)).sum(dim=1)
        remain_l = torch.clamp(remain_l - ratio_l * p.sum(dim=2), min=0.0)
        rls.append(ratio_l)
        rrs.append(ratio_r)
    if save_ratios:
        return cost, torch.stack(rls, dim=1), torch.stack(rrs, dim=1)
    return cost


def emd_cost_plain(a: torch.Tensor, b: torch.Tensor,
                   save_ratios: bool = False):
    """Plain PyTorch version of kernel 5: cost (B,) for a (B, N, 3),
    b (B, M, 3), accumulated level by level as
    sum_i ratioL_i * sum_j E_ij * ratioR_j * sqrt(D_ij). With
    `save_ratios`, also ratioL (B, 9, N) and ratioR (B, 9, M). Works in
    batch blocks of at most 2^27 distance elements."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    outs = [_cost_block(a[s:e], b[s:e], save_ratios)
            for s, e in _blocks(B, N, M)]
    if save_ratios:
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def emd_backward_plain(a: torch.Tensor, b: torch.Tensor,
                       ratio_l: torch.Tensor, ratio_r: torch.Tensor):
    """Plain PyTorch version of kernel 6: (da (B, N, 3), db (B, M, 3)),
    the gradient of the cost with the match rebuilt from the residuals
    and held constant. coeff_ij = match_ij * rsqrt(D_ij) where
    D_ij > 1e-12 and 0 elsewhere; da_i = sum_j coeff_ij (a_i - b_j),
    db_j = sum_i coeff_ij (b_j - a_i)."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    das, dbs = [], []
    for s, e in _blocks(B, N, M):
        ab, bb = a[s:e], b[s:e]
        d = pairwise_sqdists(ab, bb)
        match = torch.zeros_like(d)
        for j, level in enumerate(levels()):
            match = match + (torch.exp(level * d)
                             * ratio_l[s:e, j, :, None]) * ratio_r[s:e, j,
                                                                   None, :]
        coeff = torch.where(d > 1e-12,
                            match * torch.rsqrt(torch.clamp(d, min=1e-12)),
                            torch.zeros_like(d))
        da, db = [], []
        for c in range(3):
            diff = ab[:, :, None, c] - bb[:, None, :, c]
            da.append((coeff * diff).sum(dim=2))
            db.append(-(coeff * diff).sum(dim=1))
        das.append(torch.stack(da, dim=2))
        dbs.append(torch.stack(db, dim=2))
    return torch.cat(das), torch.cat(dbs)


def emd_backward_f64(a: torch.Tensor, b: torch.Tensor,
                     ratio_l: torch.Tensor, ratio_r: torch.Tensor,
                     rounding: str):
    """(da, db) in float64 of the match that the residuals define, with
    D and the exponent rounded to float32 in one of two forms: "forward"
    as kernels 4 and 5 (D as fma(dx, dx, fma(dy, dy,
    dz dz)), E = 2^fl(c_l D) with c_l = fl(level_l log2 e)), as kernel 6
    rebuilds the match too; "backward" as the plain versions (D as (dx^2 +
    dy^2) + dz^2, E = exp(level_l D)), the plain backward's form. The
    float32 roundings are reproduced, the rest is exact to float64 (an
    FMA's sum is rounded twice, through float64, which differs from one
    rounding about once in 2^29). The two forms hold the kernels' match
    against the plain versions' on the same residuals. One pair at a
    time."""
    if rounding not in ("forward", "backward"):
        raise ValueError(f"rounding {rounding!r}: 'forward' or 'backward'")
    log2e = torch.tensor(1.44269504088896341, dtype=torch.float32)
    das, dbs = [], []
    for k in range(a.shape[0]):
        diff = a[k, :, None, :] - b[k, None, :, :]  # float32, (N, M, 3)
        sq = diff * diff
        if rounding == "forward":
            inner = (diff[..., 1].double() ** 2 + sq[..., 2].double()).float()
            d = (diff[..., 0].double() ** 2 + inner.double()).float()
        else:
            d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        match = torch.zeros(d.shape, dtype=torch.float64, device=d.device)
        for j, level in enumerate(levels()):
            if rounding == "forward":
                c = (log2e * level).to(d.device)  # exact: level is 2^(2k)
                e = torch.exp2((c * d).double())
            else:
                e = torch.exp((level * d).double())
            match += e * ratio_l[k, j, :, None].double() \
                * ratio_r[k, j, None, :].double()
        coeff = torch.where(d > 1e-12, match * torch.rsqrt(
            torch.clamp(d, min=1e-12).double()), torch.zeros_like(match))
        grad = coeff[..., None] * diff.double()
        das.append(grad.sum(dim=1))
        dbs.append(-grad.sum(dim=0))
    return torch.stack(das), torch.stack(dbs)


def _check_pair(what: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 3 or b.ndim != 3 or a.shape[2] != 3 or b.shape[2] != 3 \
            or a.shape[0] != b.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}, expected (B, N, 3), (B, M, 3)")
    if min(a.shape[0], b.shape[0], a.shape[1], b.shape[1]) < 1 \
            or a.shape[0] > 2 ** 31 - 1:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} outside the kernel's limits")


def forward_smem_bytes(N: int, M: int) -> int:
    """Dynamic shared memory of kernels 4 and 5: both clouds as float4
    and the four auction vectors."""
    return 24 * (N + M)


def check_smem(what: str, need: int) -> None:
    if need > SMEM_LIMIT:
        raise ValueError(f"{what}: needs {need} bytes of shared memory, "
                         f"more than a block may use ({SMEM_LIMIT})")


def emd_cost_kernel(a: torch.Tensor, b: torch.Tensor,
                    save_ratios: bool = False):
    """Kernel 5 on CUDA tensors, the counterpart of `emd_cost_plain`: the
    cost (B,), and with `save_ratios` also ratioL and ratioR."""
    _check_pair("emd_cost", a, b)
    B, N, _ = a.shape
    M = b.shape[1]
    check_smem("emd_cost", forward_smem_bytes(N, M))
    build.check_tensors((a, b), a.device)
    multi_l, multi_r = _capacities(N, M)
    cost = a.new_empty(B)
    rl = a.new_empty(B, N_LEVELS, N) if save_ratios else None
    rr = a.new_empty(B, N_LEVELS, M) if save_ratios else None
    lib = build.library()
    with torch.cuda.device(a.device):
        code = lib.gwtf_emd_cost(
            a.data_ptr(), b.data_ptr(), cost.data_ptr(),
            rl.data_ptr() if save_ratios else None,
            rr.data_ptr() if save_ratios else None, B, N, M,
            multi_l, multi_r, build.stream_handle(a.device))
    emd_cost.launches += 1
    build.check(lib, code, "emd_cost")
    return (cost, rl, rr) if save_ratios else cost


def emd_backward(a: torch.Tensor, b: torch.Tensor, ratio_l: torch.Tensor,
                 ratio_r: torch.Tensor):
    """(da, db) of the summed cost from the residuals. A CPU tensor goes
    to the plain version; a CUDA tensor launches kernel 6."""
    if all(t.device.type == "cpu" for t in (a, b, ratio_l, ratio_r)):
        return emd_backward_plain(a, b, ratio_l, ratio_r)
    _check_pair("emd_backward", a, b)
    B, N, _ = a.shape
    M = b.shape[1]
    if tuple(ratio_l.shape) != (B, N_LEVELS, N) \
            or tuple(ratio_r.shape) != (B, N_LEVELS, M):
        raise ValueError(f"emd_backward: residuals {tuple(ratio_l.shape)} "
                         f"and {tuple(ratio_r.shape)}, expected "
                         f"{(B, N_LEVELS, N)} and {(B, N_LEVELS, M)}")
    build.check_tensors((a, b, ratio_l, ratio_r), a.device)
    da = torch.empty_like(a)
    db = torch.empty_like(b)
    lib = build.library()
    # each row chunk's column sums, added by a second launch
    chunks = lib.gwtf_emd_backward_chunks(N)
    col = a.new_empty(B, chunks, M, 3) if chunks > 1 else None
    with torch.cuda.device(a.device):
        code = lib.gwtf_emd_backward(
            a.data_ptr(), b.data_ptr(), ratio_l.data_ptr(),
            ratio_r.data_ptr(), da.data_ptr(), db.data_ptr(),
            None if col is None else col.data_ptr(), B, N, M,
            build.stream_handle(a.device))
    emd_backward.launches += 1
    build.check(lib, code, "emd_backward")
    return da, db


emd_backward.launches = 0


class _EMDCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        on_cpu = a.device.type == "cpu" and b.device.type == "cpu"
        run = emd_cost_plain if on_cpu else emd_cost_kernel
        if not any(ctx.needs_input_grad):
            return run(a, b, False)
        cost, rl, rr = run(a, b, True)
        ctx.save_for_backward(a, b, rl, rr)
        return cost

    @staticmethod
    def backward(ctx, g):
        a, b, rl, rr = ctx.saved_tensors
        da, db = emd_backward(a, b, rl, rr)
        g = g[:, None, None]
        return g * da, g * db


def emd_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Auction EMD cost (B,) for a (B, N, 3), b (B, M, 3), not divided by
    the point count; differentiable in both clouds with the match held
    constant. CPU tensors run the plain versions; CUDA tensors launch
    kernel 5 forward and kernel 6 backward. Residuals are kept only when
    an input requires grad."""
    return _EMDCost.apply(a, b)


emd_cost.launches = 0
