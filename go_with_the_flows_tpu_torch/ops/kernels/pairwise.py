"""Metrics over an (S, R) grid of cloud pairs: the CUDA kernels
`csrc/pairwise_cd.cu` and `csrc/emd.cu` (pairwise entry) and their plain
PyTorch versions.

`pairwise_cd_stats` replaces `_cd_stats_kernel` of
go_with_the_flows_tpu/ops/pallas/pairwise_kernel.py
(`pairwise_cd_stats_pallas`). Each pair (sample i, ref j) is reduced to
four scalars: mean row min (cdl), mean column min (cdr), and the x100
fractions of column / row mins under the F1 threshold (precision,
recall), all on squared distances.

`pairwise_emd` replaces the (S, R) grid of `_emd_kernel` in the same file
(`pairwise_emd_pallas`): the auction EMD cost of every pair, not divided
by the point count. It runs the device function of the paired EMD kernel,
so its entries equal `emd_cost` of the same pair bit for bit.
"""

from __future__ import annotations

import torch

from ..chamfer import pairwise_sqdists
from ..emd import _capacities
from . import build
from .emd import check_smem, emd_cost_plain, forward_smem_bytes

# pairs per block of the plain version: bounds its (pairs, N, M) memory
_PLAIN_BLOCK_ELEMS = 1 << 27
# pairs per launch of the EMD grid kernel
EMD_LAUNCH_PAIRS = 16384


def pairwise_cd_stats_plain(samples: torch.Tensor, refs: torch.Tensor,
                            f1_threshold: float):
    """Plain PyTorch version: chunked over pairs, never building the
    whole (S, R, N, M) distance array."""
    S, N, _ = samples.shape
    R, M, _ = refs.shape
    step = max(1, _PLAIN_BLOCK_ELEMS // (N * M))
    outs = [samples.new_empty(S, R) for _ in range(4)]
    for i in range(S):
        for j0 in range(0, R, step):
            r = refs[j0:j0 + step]
            d = pairwise_sqdists(samples[i:i + 1].expand(r.shape[0], -1, -1),
                                 r)
            row = d.min(dim=2).values  # (rc, N)
            col = d.min(dim=1).values  # (rc, M)
            cdl, cdr, prec, rec = outs
            cdl[i, j0:j0 + step] = row.sum(1) / N
            cdr[i, j0:j0 + step] = col.sum(1) / M
            prec[i, j0:j0 + step] = 100.0 * (col < f1_threshold).sum(1) / M
            rec[i, j0:j0 + step] = 100.0 * (row < f1_threshold).sum(1) / N
    return tuple(outs)


def pairwise_cd_stats(samples: torch.Tensor, refs: torch.Tensor,
                      f1_threshold: float):
    """(cdl, cdr, precision, recall), each (S, R), for samples (S, N, 3)
    vs refs (R, M, 3). A CPU tensor goes to the plain version; a CUDA
    tensor launches the kernel."""
    if samples.device.type == "cpu" and refs.device.type == "cpu":
        return pairwise_cd_stats_plain(samples, refs, f1_threshold)
    if samples.ndim != 3 or refs.ndim != 3 or samples.shape[2] != 3 \
            or refs.shape[2] != 3:
        raise ValueError(f"pairwise_cd_stats: shapes {tuple(samples.shape)}"
                         f" and {tuple(refs.shape)}, expected (S, N, 3), "
                         "(R, M, 3)")
    S, N, _ = samples.shape
    R, M, _ = refs.shape
    if min(S, R, N, M) < 1 or S * R >= 2 ** 31:
        raise ValueError(f"pairwise_cd_stats: S={S}, R={R}, N={N}, M={M} "
                         "outside the kernel's launch limits")
    build.check_tensors((samples, refs), samples.device)
    outs = [samples.new_empty(S, R) for _ in range(4)]
    lib = build.library()
    with torch.cuda.device(samples.device):
        code = lib.gwtf_pairwise_cd_stats(
            samples.data_ptr(), refs.data_ptr(),
            *(o.data_ptr() for o in outs), S, R, N, M, float(f1_threshold),
            build.stream_handle(samples.device))
    pairwise_cd_stats.launches += 1
    build.check(lib, code, "pairwise_cd_stats")
    return tuple(outs)


pairwise_cd_stats.launches = 0


def pairwise_emd_plain(samples: torch.Tensor, refs: torch.Tensor):
    """Plain PyTorch version: one sample against all refs at a time, in
    blocks of at most 2^27 distance elements (a (pairs, N, M) block is
    16 MB per pair at N = M = 2048)."""
    R = refs.shape[0]
    return torch.stack([emd_cost_plain(s[None].expand(R, -1, -1), refs)
                        for s in samples])


def pairwise_emd(samples: torch.Tensor, refs: torch.Tensor):
    """(S, R) auction EMD costs of samples (S, N, 3) vs refs (R, M, 3).
    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel, once per EMD_LAUNCH_PAIRS pairs."""
    if samples.device.type == "cpu" and refs.device.type == "cpu":
        return pairwise_emd_plain(samples, refs)
    if samples.ndim != 3 or refs.ndim != 3 or samples.shape[2] != 3 \
            or refs.shape[2] != 3:
        raise ValueError(f"pairwise_emd: shapes {tuple(samples.shape)} and "
                         f"{tuple(refs.shape)}, expected (S, N, 3), "
                         "(R, M, 3)")
    S, N, _ = samples.shape
    R, M, _ = refs.shape
    if min(S, R, N, M) < 1 or S * R >= 2 ** 31:
        raise ValueError(f"pairwise_emd: S={S}, R={R}, N={N}, M={M} "
                         "outside the kernel's launch limits")
    check_smem("pairwise_emd", forward_smem_bytes(N, M))
    build.check_tensors((samples, refs), samples.device)
    multi_l, multi_r = _capacities(N, M)
    cost = samples.new_empty(S, R)
    lib = build.library()
    stream = build.stream_handle(samples.device)
    for p0 in range(0, S * R, EMD_LAUNCH_PAIRS):
        pairs = min(EMD_LAUNCH_PAIRS, S * R - p0)
        with torch.cuda.device(samples.device):
            code = lib.gwtf_pairwise_emd(
                samples.data_ptr(), refs.data_ptr(), cost.data_ptr(), R, N,
                M, multi_l, multi_r, p0, pairs, stream)
        pairwise_emd.launches += 1
        build.check(lib, code, "pairwise_emd")
    return cost


pairwise_emd.launches = 0
