"""The evaluation protocol's metrics: CD / EMD / F1 / MMD / COV / 1-NNA
(counterpart of go_with_the_flows_tpu/metrics/evaluation.py).

Cloud arguments are (S, N, 3) numpy arrays or tensors; `device` says
where the metric work runs: the card (the default) unless the caller
names the CPU. On the card the paired metrics go through the
`nn_distance` and `emd_cost` kernels and the (S, R) matrices through the
`pairwise_cd_stats` and `pairwise_emd` kernels; on the CPU through their
plain versions. The voxel JSD (`voxel_jsd`) is host numpy, as in the
JAX package, its entropies written out instead of taken from scipy; so
is the occupancy-grid JSD (`jsd_between_point_cloud_sets`, which
tools/eval_precision_ab.py reports), but for its nearest-centre search,
which runs on `device`.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.kernels.chamfer import chamfer
from ..ops.kernels.emd import emd_cost
from ..ops.kernels.pairwise import pairwise_cd_stats, pairwise_emd
from ..parallel import dist

# pairs per chunk of the pairwise grid, as in the JAX package's grid loop
_GRID_PAIR_BUDGET = 16384


def _as_tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _paired_stats(sample, ref, f1_threshold: float, with_emd: bool):
    """Per-pair CD parts, EMD (cost / N, zeros without `with_emd`) and F1
    for equal-length batches."""
    dl, dr = chamfer(sample, ref)
    emd = (emd_cost(sample, ref) / sample.shape[1] if with_emd
           else sample.new_zeros(sample.shape[0]))
    return dl.mean(dim=1), dr.mean(dim=1), emd, _f1(dl, dr, f1_threshold)


def _f1(dl, dr, threshold: float) -> torch.Tensor:
    """F1 (in %) per pair from the nearest-neighbour squared distances
    (B, N) of the sample's points (dl) and of the reference's (dr)."""
    precision = 100.0 * (dr < threshold).float().mean(dim=1)
    recall = 100.0 * (dl < threshold).float().mean(dim=1)
    return 2.0 * precision * recall / (precision + recall + 1e-7)


def f_score(predicted: torch.Tensor, true: torch.Tensor,
            threshold: float = 1e-3) -> torch.Tensor:
    """Per-pair F1 (B,) of paired clouds (B, N, 3) and (B, M, 3), the
    reconstruction protocol's streaming F1: the `nn_distance` kernel on
    CUDA tensors, its plain version on CPU tensors."""
    dl, dr = chamfer(predicted, true)
    return _f1(dl, dr, threshold)


def EMD_CD_F1(
    sample_pcs,
    ref_pcs,
    batch_size: int,
    reduced: bool = True,
    cd_option: bool = False,
    emd_option: bool = False,
    one_part_of_cd: bool = False,
    f1_option: bool = False,
    f1_threshold: float = 1e-4,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Paired (i-th sample vs i-th ref) metrics."""
    n = sample_pcs.shape[0]
    if n != ref_pcs.shape[0]:
        raise ValueError(f"REF:{ref_pcs.shape[0]} SMP:{n}")
    parts = []
    with torch.inference_mode():
        for s in range(0, n, batch_size):
            e = min(n, s + batch_size)
            stats = _paired_stats(_as_tensor(sample_pcs[s:e], device),
                                  _as_tensor(ref_pcs[s:e], device),
                                  f1_threshold, emd_option)
            parts.append([x.cpu().numpy() for x in stats])
    cdl, cdr, emd, f1 = (np.concatenate(p) for p in zip(*parts))

    def red(x):
        return x.mean() if reduced else x

    return {
        "CD": red(cdl + cdr) if cd_option else 0,
        "EMD": red(emd) if emd_option else 0,
        "F1": red(f1) if f1_option else 0,
        "CDL": red(cdl) if one_part_of_cd else 0,
        "CDR": red(cdr) if one_part_of_cd else 0,
    }


def pairwise_EMD_CD_F1(
    sample_pcs,
    ref_pcs,
    batch_size: int,
    f1_threshold: float = 1e-3,
    cd_option: bool = False,
    one_part_of_cd: bool = False,
    emd_option: bool = False,
    f1_option: bool = False,
    verbose: bool = False,
    device="cuda",
):
    """Full (N_sample, N_ref) matrices (cd, emd, f1, cdl, cdr) as numpy
    float32; emd is the cost / N and stays zero without `emd_option`.
    Samples are chunked so that one chunk covers at most
    _GRID_PAIR_BUDGET pairs. `batch_size` is accepted for the JAX
    package's signature and unused: the pair grid needs no
    reference-side batching.

    Inside a process group of several ranks (parallel/dist.py), whose
    every rank calls it on the same clouds, rank r computes the rows
    [r P, (r + 1) P) of P = ceil(N_sample / W), the last block padded by
    repeating the last sample, and every rank returns the gathered
    matrices (a pair's entries do not depend on the block it is in)."""
    args = (f1_threshold, emd_option, verbose, device)
    n_sample = sample_pcs.shape[0]
    world = dist.world_size()
    if world == 1 or n_sample < 2:
        return _pairwise_grid(sample_pcs, ref_pcs, *args)
    rows = -(-n_sample // world)
    lo = dist.rank() * rows
    idx = np.minimum(np.arange(lo, lo + rows), n_sample - 1)
    block = _pairwise_grid(sample_pcs[idx], ref_pcs, *args)
    full = dist.gather_global(np.stack(block, axis=1))[:n_sample]
    return tuple(np.ascontiguousarray(full[:, i]) for i in range(5))


def _pairwise_grid(sample_pcs, ref_pcs, f1_threshold, emd_option, verbose,
                   device):
    """pairwise_EMD_CD_F1's matrices over all the rows, in this process."""
    n_sample, n_ref = sample_pcs.shape[0], ref_pcs.shape[0]
    n_pts = sample_pcs.shape[1]
    emd_m = np.zeros((n_sample, n_ref), np.float32)
    cdl_m = np.zeros((n_sample, n_ref), np.float32)
    cdr_m = np.zeros((n_sample, n_ref), np.float32)
    f1_m = np.zeros((n_sample, n_ref), np.float32)
    s_chunk = max(1, _GRID_PAIR_BUDGET // max(n_ref, 1))
    with torch.inference_mode():
        refs = _as_tensor(ref_pcs, device)
        samples = _as_tensor(sample_pcs, device)
        for i0 in range(0, n_sample, s_chunk):
            i1 = min(n_sample, i0 + s_chunk)
            cdl, cdr, prec, rec = (x.cpu().numpy() for x in pairwise_cd_stats(
                samples[i0:i1], refs, f1_threshold))
            cdl_m[i0:i1] = cdl
            cdr_m[i0:i1] = cdr
            f1_m[i0:i1] = 2.0 * prec * rec / (prec + rec + 1e-7)
            if emd_option:
                emd_m[i0:i1] = pairwise_emd(samples[i0:i1],
                                            refs).cpu().numpy() / n_pts
            if verbose:
                print(f"pairwise: {i1}/{n_sample}")
    return cdl_m + cdr_m, emd_m, f1_m, cdl_m, cdr_m


def knn_two_sample(Mxx, Mxy, Myy, k: int = 1) -> Dict[str, float]:
    """k-NN two-sample classifier accuracies from precomputed distance
    blocks. 1-NNA ideal = 50%."""
    Mxx, Mxy, Myy = map(np.asarray, (Mxx, Mxy, Myy))
    n0, n1 = Mxx.shape[0], Myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    M = np.block([[Mxx, Mxy], [Mxy.T, Myy]])
    np.fill_diagonal(M, np.inf)
    # indices of the k smallest per column (reference topk(k, 0, False))
    idx = np.argpartition(M, k - 1, axis=0)[:k]
    count = label[idx].sum(axis=0)
    pred = (count >= k / 2.0).astype(np.float64)

    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


def lgan_mmd_cov(all_dist, mode: str = "min") -> Dict[str, np.ndarray]:
    """MMD + coverage from a (N_sample, N_ref) distance matrix."""
    all_dist = np.asarray(all_dist)
    n_ref = all_dist.shape[1]
    if mode == "min":
        val_fromsmp = all_dist.min(axis=1)
        idx = all_dist.argmin(axis=1)
        val = all_dist.min(axis=0)
        idx_mmd = all_dist.argmin(axis=0)
    else:
        val_fromsmp = all_dist.max(axis=1)
        idx = all_dist.argmax(axis=1)
        val = all_dist.max(axis=0)
        idx_mmd = all_dist.argmax(axis=0)
    return {
        "lgan_mmd": val.mean(),
        "lgan_cov": float(len(np.unique(idx))) / float(n_ref),
        "lgan_mmd_smp": val_fromsmp.mean(),
        "idx_mmd": idx_mmd,
        "mmd_contrib": val,
    }


def compute_all_metrics(
    sample_pcs,
    ref_pcs,
    batch_size: int,
    f1_threshold: float = 1e-3,
    cd_option: bool = False,
    one_part_of_cd: bool = False,
    emd_option: bool = False,
    f1_option: bool = False,
    verbose: bool = False,
    ref_cache: Optional[dict] = None,
    device="cuda",
) -> Dict[str, float]:
    """MMD/COV (sample vs ref) and 1-NNA (ss, rs, rr) over CD, EMD and F1.

    `ref_cache`: a dict owned by the caller that survives repeated calls
    with the same reference set; the ref-vs-ref matrices are computed
    once, keyed by the options and guarded by a content hash of
    `ref_pcs`."""
    results: Dict[str, float] = {}
    opts = dict(f1_threshold=f1_threshold, cd_option=cd_option,
                one_part_of_cd=one_part_of_cd, emd_option=emd_option,
                f1_option=f1_option, verbose=verbose, device=device)
    rs_cd, rs_emd, rs_f1, rs_cdl, rs_cdr = pairwise_EMD_CD_F1(
        sample_pcs, ref_pcs, batch_size, **opts)

    def upd(prefix, res):
        results.update({f"{k}-{prefix}": v for k, v in res.items()})

    if cd_option:
        upd("CD", lgan_mmd_cov(rs_cd))
    if emd_option:
        upd("EMD", lgan_mmd_cov(rs_emd))
    if f1_option:
        upd("F1", lgan_mmd_cov(rs_f1, "max"))
    if one_part_of_cd:
        upd("CD-left", lgan_mmd_cov(rs_cdl))
        upd("CD-right", lgan_mmd_cov(rs_cdr))

    rr = None
    if ref_cache is not None:
        key = ("rr", tuple(ref_pcs.shape), float(f1_threshold), cd_option,
               one_part_of_cd, emd_option, f1_option)
        checksum = hashlib.sha1(
            np.ascontiguousarray(ref_pcs, np.float32).tobytes()).hexdigest()
        hit = ref_cache.get(key)
        if hit is not None and hit[0] == checksum:
            rr = hit[1]
    if rr is None:
        rr = pairwise_EMD_CD_F1(ref_pcs, ref_pcs, batch_size, **opts)
        if ref_cache is not None:
            ref_cache[key] = (checksum, rr)
    ss = pairwise_EMD_CD_F1(sample_pcs, sample_pcs, batch_size, **opts)

    def upd_nn(prefix, Mss, Mrs, Mrr):
        res = knn_two_sample(Mss, Mrs, Mrr, k=1)
        results.update({
            f"1-NN-{prefix}-{k}": v for k, v in res.items() if "acc" in k
        })

    if cd_option:
        upd_nn("CD", ss[0], rs_cd, rr[0])
    if emd_option:
        upd_nn("EMD", ss[1], rs_emd, rr[1])
    if f1_option:
        upd_nn("F1", ss[2], rs_f1, rr[2])
    if one_part_of_cd:
        upd_nn("CD-left", ss[3], rs_cdl, rr[3])
        upd_nn("CD-right", ss[4], rs_cdr, rr[4])
    return results


# --------------------------------------------------------------------- #
# The voxel JSD of the generative protocol (JAX metrics/evaluation.py:  #
# 581-618; reference lib/networks/utils.py:45-87): the JSD between two  #
# sets' 28^3 voxel point-count distributions                            #
# --------------------------------------------------------------------- #

def voxel_occupancy_dist(all_clouds, res: int = 28, bound: float = 0.5,
                         warn: bool = True, flag: str = "gen") -> np.ndarray:
    """Normalised voxel point-count histogram over [-bound, bound)^3 of
    clouds (S, N, 3); points outside the cube (and NaN points) are
    dropped."""
    all_clouds = np.asarray(all_clouds)
    if warn and np.any(np.fabs(all_clouds) > bound):
        print(f"{flag} clouds out of cube bounds: [-{bound}; {bound}]")
    n_nans = int(np.isnan(all_clouds).sum())
    if n_nans > 0:
        print(f"{n_nans} NaN values in point cloud tensors.")

    edges = -bound + np.arange(res + 1) * (2 * bound / res)
    pts = all_clouds.reshape(-1, 3)
    hist = np.zeros((res, res, res), np.uint64)
    idx = np.stack([np.digitize(pts[:, c], edges) - 1 for c in range(3)],
                   axis=1)
    valid = ((idx >= 0) & (idx < res)).all(axis=1)
    idx = idx[valid]
    np.add.at(hist, (idx[:, 0], idx[:, 1], idx[:, 2]), 1)
    return np.float64(hist) / max(hist.sum(), 1)


def _entropy2(p: np.ndarray) -> float:
    """Base-2 entropy -sum p log2 p over the cells with p > 0."""
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def voxel_jsd(clouds1, clouds2, warn: bool = True) -> float:
    """Base-2 JSD between the voxel point-count distributions of two sets
    of clouds (S, N, 3), in [0, 1]."""
    d1 = voxel_occupancy_dist(clouds1, warn=warn, flag="gen").ravel()
    d2 = voxel_occupancy_dist(clouds2, warn=warn, flag="ref").ravel()
    return _entropy2((d1 + d2) / 2.0) - 0.5 * (_entropy2(d1) + _entropy2(d2))


# --------------------------------------------------------------------- #
# The occupancy-grid JSD of latent_3d_points (JAX metrics/evaluation.py: #
# 486-572, `jsd_between_point_cloud_sets`), the JSD that the JAX         #
# package's tools/eval_precision_ab.py reports                           #
# --------------------------------------------------------------------- #

_GRID_CHUNK = 1024  # points a nearest-centre search takes at a time


def _sphere_grid(resolution: int):
    """The centres of a resolution^3 grid in the unit cube that lie within
    0.5 of the origin, (M, 3)."""
    ax = (np.arange(resolution, dtype=np.float32)
          * (1.0 / float(resolution - 1)) - 0.5)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    axis=-1).astype(np.float32).reshape(-1, 3)
    return grid[np.linalg.norm(grid, axis=1) <= 0.5]


def occupancy_grid_counts(pclouds, resolution: int = 28,
                          device="cuda") -> np.ndarray:
    """Points (S, N, 3) per cell of the sphere-clipped unit-cube grid, each
    point counted in its nearest cell centre (the first on a tie), as the
    JAX package's `entropy_of_occupancy_grid(..., in_sphere=True)` counts
    them with a nearest-neighbour search (its second output). The search
    is brute force on `device`, _GRID_CHUNK points at a time."""
    grid = _sphere_grid(resolution)
    centres = torch.from_numpy(grid).to(device)
    pts = torch.from_numpy(
        np.asarray(pclouds, np.float32).reshape(-1, 3)).to(device)
    cell = torch.cat([
        ((pts[s:s + _GRID_CHUNK, None, :] - centres[None]) ** 2).sum(-1)
        .argmin(1) for s in range(0, len(pts), _GRID_CHUNK)])
    return np.bincount(cell.cpu().numpy(),
                       minlength=len(grid)).astype(np.float64)


def jensen_shannon_divergence(P, Q) -> float:
    """Base-2 JSD between two non-negative histograms of one length."""
    P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
    if np.any(P < 0) or np.any(Q < 0):
        raise ValueError("Negative values.")
    if len(P) != len(Q):
        raise ValueError("Non equal size.")
    P_, Q_ = P / P.sum(), Q / Q.sum()
    return _entropy2((P_ + Q_) / 2.0) - (_entropy2(P_) + _entropy2(Q_)) / 2.0


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, resolution: int = 28,
                                 device="cuda") -> float:
    """JSD between two sets of clouds (S, N, 3) through their counts on
    the sphere-clipped resolution^3 grid."""
    return jensen_shannon_divergence(
        occupancy_grid_counts(sample_pcs, resolution, device),
        occupancy_grid_counts(ref_pcs, resolution, device))
