"""Evaluation pass (counterpart of go_with_the_flows_tpu/eval/evaluating.py):
generating and autoencoding modes over the whole set, and single-view
reconstruction with per-batch CD, EMD and F1 meters.

`loader` is any iterable of batch dicts with numpy arrays: `cloud`
(B, 3, N) for the encoder, `eval_cloud` (B, 3, N) for the metrics,
`image` (B, 4, H, W) for SVR, and `orig_s` / `orig_c` when
`orig_scale_evaluation` rescales. With `saving`, the sampled and
ground-truth clouds, the labels and (SVR) the images go into an h5 file
beside the checkpoint (h5py is imported only then); `jsd` adds the voxel
JSD to the generating protocol.

Data-parallel (inside a process group of several ranks,
parallel/dist.py), each rank samples its loader's shard; every batch's
rows are gathered from all the ranks (a shorter last batch padded for
the gather and trimmed after it), so that every rank computes the
metrics over the whole set and returns the same numbers (the pairwise
matrices split their rows over the ranks), and rank 0 alone writes the
h5 dump.
"""

from __future__ import annotations

import os
from time import perf_counter
from typing import Callable, Dict

import numpy as np
import torch

from ..metrics.evaluation import (
    EMD_CD_F1,
    _as_tensor,
    compute_all_metrics,
    f_score,
    voxel_jsd,
)
from ..ops.kernels.chamfer import chamfer
from ..ops.kernels.emd import emd_cost
from ..parallel import dist
from ..utils.meters import AverageMeter


def _denormalize(r_clouds, p_clouds, batch, **kwargs):
    """Rescale model-frame clouds back to the evaluation frame. Clouds
    are (B, 3, N) numpy."""
    if kwargs.get("unit_scale_evaluation"):
        if kwargs.get("cloud_scale"):
            scale = kwargs["cloud_scale_scale"]
            r_clouds = r_clouds * scale
            p_clouds = p_clouds * scale
    if kwargs.get("orig_scale_evaluation"):
        if kwargs.get("cloud_scale"):
            scale = kwargs["cloud_scale_scale"]
            r_clouds = r_clouds * scale
            p_clouds = p_clouds * scale
        if kwargs.get("cloud_translate"):
            shift = np.asarray(
                kwargs["cloud_translate_shift"], np.float32
            ).reshape(1, -1, 1)
            r_clouds = r_clouds + shift
            p_clouds = p_clouds + shift
        if not kwargs.get("cloud_rescale2orig"):
            s = np.asarray(batch["orig_s"]).reshape(-1, 1, 1)
            r_clouds = r_clouds * s
            p_clouds = p_clouds * s
        if not kwargs.get("cloud_recenter2orig"):
            c = np.asarray(batch["orig_c"]).reshape(-1, 3, 1)
            r_clouds = r_clouds + c
            p_clouds = p_clouds + c
    return r_clouds, p_clouds


class _CloudsDump:
    """The h5 dump of an evaluation pass (JAX eval/evaluating.py:106-140,
    185-203): `sampled_clouds` (S, 3, N), `gt_clouds` (S, 3, N'),
    `sampled_labels` (S, N) int8 and, for SVR, `image_clouds` (S, 4, H,
    W), S = N_sets x the dataset's length, rows written in loader order
    up to S."""

    def __init__(self, loader, svr: bool, **kwargs):
        import h5py

        n_total = kwargs.get("N_sets", 1) * len(loader.dataset)
        n_points = kwargs["sampled_cloud_size"]
        name = "{}_{}_{}_{}_clouds_{}.h5".format(
            os.path.splitext(kwargs["model_name"])[0], loader.dataset.part,
            kwargs["cloud_size"], n_points, kwargs["util_mode"])
        self.path = os.path.join(kwargs["logging_path"], name)
        print(self.path)
        self.file = h5py.File(self.path, "w")
        f = self.file
        self.sets = {
            "sampled": f.create_dataset("sampled_clouds",
                                        shape=(n_total, 3, n_points),
                                        dtype=np.float32),
            "gt": f.create_dataset("gt_clouds",
                                   shape=(n_total, 3, kwargs["cloud_size"]),
                                   dtype=np.float32),
            "labels": f.create_dataset("sampled_labels",
                                       shape=(n_total, n_points),
                                       dtype=np.int8),
        }
        if svr:
            h, w = kwargs.get("image_size", [224, 224])
            self.sets["images"] = f.create_dataset(
                "image_clouds", shape=(n_total, 4, h, w), dtype=np.float32)
        self.pos = 0

    def write(self, **rows) -> None:
        take = max(0, min(len(rows["sampled"]),
                          self.sets["sampled"].shape[0] - self.pos))
        for key, ds in self.sets.items():
            ds[self.pos:self.pos + take] = np.asarray(
                rows[key][:take]).astype(ds.dtype)
        self.pos += take

    def close(self) -> None:
        self.file.close()


def evaluate(loader, sample_step: Callable, generator: torch.Generator,
             device, svr: bool = False, **kwargs) -> Dict[str, float]:
    """One evaluation pass; returns the metric dict and prints the
    reference's protocol lines.

    `sample_step` comes from train/step.make_sample_step (with `svr`, an
    SVR step, handed each batch's `image`); `generator` (on `device`)
    drives every random draw, so a seed fixes the result. kwargs are the
    flat config keys the JAX `evaluate` reads (util_mode, cd, emd, f1,
    f1_threshold_lst, the de-normalisation keys, ref_cache, jsd, and
    with saving: model_name, logging_path, cloud_size,
    sampled_cloud_size, N_sets and, for SVR, image_size).

    Reconstruction keeps per-batch meters, each batch weighted by its
    size: CD as mean(dl) + mean(dr) per cloud (the `nn_distance` kernel
    on the card), EMD as the auction cost / N (`emd_cost`), F1 at each
    threshold (`f_score`); it returns `cd`, `emd` and `f1_{thr:.4f}`.
    """
    util_mode = kwargs.get("util_mode")
    if util_mode not in ("generating", "autoencoding", "reconstruction"):
        raise ValueError(f"unknown util_mode {util_mode!r}")
    device = torch.device(device)
    dump = (_CloudsDump(loader, svr, **kwargs)
            if kwargs.get("saving") and dist.rank() == 0 else None)
    try:
        return _evaluate(loader, sample_step, generator, device, svr, dump,
                         **kwargs)
    finally:
        if dump is not None:
            dump.close()


def _evaluate(loader, sample_step, generator, device, svr, dump,
              **kwargs) -> Dict[str, float]:
    util_mode = kwargs["util_mode"]
    inf_time = AverageMeter()
    gen_buf, ref_buf = [], []
    thresholds = kwargs.get("f1_threshold_lst", [1e-3])
    cd_meter, emd_meter = AverageMeter(), AverageMeter()
    f1_meters = [AverageMeter() for _ in thresholds]
    keys = ["cloud", "eval_cloud", "orig_s", "orig_c"] + (
        ["image"] if svr else [])
    # the images' rows are gathered only for the dump (the same choice on
    # every rank: the gathers are collectives)
    gathered = [k for k in keys if k != "image" or kwargs.get("saving")]
    for batch in loader:
        host, trim = dist.place_batch_uneven(
            {k: batch[k] for k in keys if k in batch})
        g_clouds = _as_tensor(host["cloud"], device)
        start = perf_counter()
        if svr:
            samples, labels, _ = sample_step(
                g_clouds, generator, images=_as_tensor(host["image"], device))
        else:
            samples, labels, _ = sample_step(g_clouds, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        real = len(batch["cloud"])
        inf_time.update((perf_counter() - start) / real, real)
        samples = trim(dist.gather_global(samples))
        labels = trim(dist.gather_global(labels))
        batch = {k: trim(dist.gather_global(v)) for k, v in host.items()
                 if k in gathered}
        bsz = samples.shape[0]
        r_clouds, p_clouds = _denormalize(samples, batch["eval_cloud"],
                                          batch, **kwargs)
        if dump is not None:
            rows = dict(sampled=r_clouds, gt=p_clouds, labels=labels)
            if svr:
                rows["images"] = batch["image"]
            dump.write(**rows)
        if util_mode != "reconstruction":
            gen_buf.append(r_clouds)
            ref_buf.append(p_clouds)
            continue
        with torch.inference_mode():
            r = _as_tensor(np.transpose(r_clouds, (0, 2, 1)), device)
            p = _as_tensor(np.transpose(p_clouds, (0, 2, 1)), device)
            if kwargs.get("cd"):
                dl, dr = chamfer(r, p)
                cd_meter.update(
                    float((dl.mean(dim=1) + dr.mean(dim=1)).mean()), bsz)
            if kwargs.get("emd"):
                emd_meter.update(float((emd_cost(r, p) / r.shape[1]).mean()),
                                 bsz)
            if kwargs.get("f1"):
                for meter, thr in zip(f1_meters, thresholds):
                    meter.update(float(f_score(r, p, thr).mean()), bsz)
    print(f"Inference time: {inf_time.avg} sec/sample")

    res: Dict[str, float] = {}
    if util_mode == "reconstruction":
        if kwargs.get("cd"):
            print("CD: {:.6f}".format(cd_meter.avg))
            res["cd"] = cd_meter.avg
        if kwargs.get("emd"):
            print("EMD: {:.6f}".format(emd_meter.avg))
            res["emd"] = emd_meter.avg
        if kwargs.get("f1"):
            for meter, thr in zip(f1_meters, thresholds):
                print("F1-%.4f: %.2f" % (thr, meter.avg))
                res[f"f1_{thr:.4f}"] = meter.avg
        return res

    gen = np.transpose(np.concatenate(gen_buf), (0, 2, 1))
    ref = np.transpose(np.concatenate(ref_buf), (0, 2, 1))
    if util_mode == "autoencoding":
        for thr in thresholds:
            metrics = EMD_CD_F1(
                gen, ref, batch_size=60, reduced=True,
                cd_option=kwargs.get("cd", False),
                emd_option=kwargs.get("emd", False),
                f1_option=kwargs.get("f1", False), f1_threshold=thr,
                device=device,
            )
            if kwargs.get("cd"):
                res["cd"] = float(metrics["CD"]) * 1e4
                print("CD:\t{:.2f}".format(res["cd"]))
            if kwargs.get("emd"):
                res["emd"] = float(metrics["EMD"]) * 1e2
                print("EMD:\t{:.2f}".format(res["emd"]))
            if kwargs.get("f1"):
                res[f"f1_{thr:.4f}"] = float(metrics["F1"])
                print("F1-%.4f: %.2f" % (thr, res[f"f1_{thr:.4f}"]))
        return res

    # generating: a cloud with NaNs is replaced by a valid one, drawn with
    # a seed taken from the evaluation generator
    nan_inds = sorted(set(np.isnan(gen).sum(axis=(1, 2)).nonzero()[0]))
    if nan_inds:
        ok = sorted(set(range(gen.shape[0])) - set(nan_inds))
        seed = int(torch.randint(2 ** 31 - 1, (1,), generator=generator,
                                 device=device).item())
        dup = np.random.default_rng(seed).choice(ok, size=len(nan_inds))
        gen[nan_inds] = gen[dup]

    if kwargs.get("jsd"):
        res["jsd"] = voxel_jsd(gen, ref, warn=False) * 1e2
        print("JSD:\t{:.2f}".format(res["jsd"]))

    for thr in thresholds:
        metrics = compute_all_metrics(
            gen, ref, batch_size=60, f1_threshold=thr,
            cd_option=kwargs.get("cd", False),
            emd_option=kwargs.get("emd", False),
            f1_option=kwargs.get("f1", False),
            ref_cache=kwargs.get("ref_cache"), device=device,
        )
        if kwargs.get("cd"):
            res["cd_mmds"] = float(metrics["lgan_mmd-CD"]) * 1e4
            res["cd_covs"] = float(metrics["lgan_cov-CD"]) * 1e2
            res["cd_1nns"] = float(metrics["1-NN-CD-acc"]) * 1e2
            print("MMD-CD:\t{:.2f}".format(res["cd_mmds"]))
            print("COV-CD:\t{:.2f}".format(res["cd_covs"]))
            print("1NN-CD:\t{:.2f}".format(res["cd_1nns"]))
        if kwargs.get("emd"):
            res["emd_mmds"] = float(metrics["lgan_mmd-EMD"]) * 1e2
            res["emd_covs"] = float(metrics["lgan_cov-EMD"]) * 1e2
            res["emd_1nns"] = float(metrics["1-NN-EMD-acc"]) * 1e2
            print("MMD-EMD:\t{:.2f}".format(res["emd_mmds"]))
            print("COV-EMD:\t{:.2f}".format(res["emd_covs"]))
            print("1NN-EMD:\t{:.2f}".format(res["emd_1nns"]))
        if kwargs.get("f1"):
            res[f"f1_{thr:.4f}_mmds"] = float(metrics["lgan_mmd-F1"])
            res[f"f1_{thr:.4f}_covs"] = float(metrics["lgan_cov-F1"]) * 1e2
            res[f"f1_{thr:.4f}_1nns"] = float(metrics["1-NN-F1-acc"]) * 1e2
            print("MMD-F1-%.4f: %.2f" % (thr, res[f"f1_{thr:.4f}_mmds"]))
            print("COV-F1-%.4f: %.2f" % (thr, res[f"f1_{thr:.4f}_covs"]))
            print("1NN-F1-%.4f: %.2f" % (thr, res[f"f1_{thr:.4f}_1nns"]))
    return res
