"""The evaluation protocol's metrics: CD / EMD / F1 / MMD / COV / 1-NNA
(counterpart of go_with_the_flows_tpu/metrics/evaluation.py).

Cloud arguments are (S, N, 3) numpy arrays or tensors; `device` says
where the metric work runs: the card (the default) unless the caller
names the CPU. On the card the paired metrics go through the
`nn_distance` and `emd_cost` kernels and the (S, R) matrices through the
`pairwise_cd_stats` and `pairwise_emd` kernels; on the CPU through their
plain versions.

Not ported yet: the voxel JSD (the card's machine has no scikit-learn).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.kernels.chamfer import chamfer
from ..ops.kernels.emd import emd_cost
from ..ops.kernels.pairwise import pairwise_cd_stats, pairwise_emd

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
    cdl = dl.mean(dim=1)
    cdr = dr.mean(dim=1)
    precision = 100.0 * (dr < f1_threshold).float().mean(dim=1)
    recall = 100.0 * (dl < f1_threshold).float().mean(dim=1)
    f1 = 2.0 * precision * recall / (precision + recall + 1e-7)
    return cdl, cdr, emd, f1


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
    reference-side batching."""
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
