"""Evaluation CLI (counterpart of the JAX package's evaluate_ae.py, with
the same arguments):

    python -m go_with_the_flows_tpu_torch.cli.evaluate_ae EXPERIMENT_PATH \\
        NAME PART CLOUD_SIZE SAMPLED_CLOUD_SIZE MODE [--cd] [--emd] \\
        [--f1] [--jsd] [--save] [--reps R] [--device cpu] ...

Loads EXPERIMENT_PATH/config.yaml and the checkpoint NAME written by
train_ae or train_svr, and runs the protocol in MODE: `autoencoding`
(paired CD x1e4, EMD x1e2, F1 over the split), `generating` (MMD, COV
and 1-NNA over CD, EMD and F1, and the voxel JSD x1e2; repeated --reps
times with one shared cache of the reference-vs-reference matrices,
then mean ± std) or `reconstruction` (per-batch meters; the SVR model's
image-conditioned samples when the config's train_mode is
p_rnvp_mc_g_rnvp_vae_ic) or `interpolation` (posterior-mean codes of
--interpolation_batches batches and of their shuffled partners,
interpolated over --interpolation_steps and decoded with labels through
kernel 1; written to EXPERIMENT_PATH/interpolations_PART.h5, keys
clouds1, clouds2, interpolations (B, 3, N, S) and labels (B, N, S)
uint8; eval/interpolate.py). `--save` writes the clouds of the other
modes into an h5 file in EXPERIMENT_PATH.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.cloud_transforms import ComposeCloudTransformation
from ..data.datasets import ShapeNetAllDataset, ShapeNetCoreDataset
from ..data.image_transforms import ComposeImageTransformation
from ..data.loader import DataLoader
from ..eval.evaluating import evaluate
from ..eval.interpolate import interpolate
from ..models.mixture import FlowMixtureModel, FlowMixtureSVRModel
from ..optim import make_optimizer
from ..train.checkpoints import restore_checkpoint
from ..train.state import create_train_state
from ..train.step import make_sample_step
from ..utils.config import (load_config, model_config_kwargs,
                            svr_model_config_kwargs)
from . import (add_device_option, check_precision, derived_seed,
               resolve_device)

SVR_TRAIN_MODE = "p_rnvp_mc_g_rnvp_vae_ic"


def define_options_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Model evaluation script.")
    p.add_argument("experiment_path", type=str,
                   help="Experiment dir containing config.yaml + ckpt.")
    p.add_argument("modelname", type=str, help="Checkpoint name.")
    p.add_argument("part", type=str, help="Dataset part: train/val/test.")
    p.add_argument("cloud_size", type=int, help="GT cloud size.")
    p.add_argument("sampled_cloud_size", type=int, help="Sampled size.")
    p.add_argument("mode", type=str,
                   help="autoencoding | generating | reconstruction | "
                        "interpolation.")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--weights_type", type=str, default="global_weights")
    p.add_argument("--reps", type=int, default=10,
                   help="Repetitions for generating mode.")
    p.add_argument("--orig_scale_evaluation", action="store_true")
    p.add_argument("--unit_scale_evaluation", action="store_true")
    p.add_argument("--save", action="store_true",
                   help="Dump sampled/gt clouds + labels to h5.")
    p.add_argument("--f1_threshold_lst", type=float, nargs="+",
                   default=[1e-3])
    p.add_argument("--jsd", action="store_true")
    p.add_argument("--cd", action="store_true")
    p.add_argument("--emd", action="store_true")
    p.add_argument("--f1", action="store_true")
    p.add_argument("--N_sets", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--interpolation_steps", type=int, default=9,
                   help="Latent interpolation steps between each shape "
                        "pair (interpolation mode).")
    p.add_argument("--interpolation_batches", type=int, default=3,
                   help="Loader batches to interpolate "
                        "(interpolation mode).")
    add_device_option(p)
    return p


def eval_config(args) -> Dict:
    """The experiment's config.yaml with the command's settings."""
    config = load_config(os.path.join(args.experiment_path, "config.yaml"))
    config.update(
        logging_path=args.experiment_path,
        model_name=args.modelname,
        cloud_size=args.cloud_size,
        sampled_cloud_size=args.sampled_cloud_size,
        util_mode=args.mode,
        batch_size=args.batch_size,
        weights_type=args.weights_type,
        saving=args.save,
        N_sets=args.N_sets,
        orig_scale_evaluation=args.orig_scale_evaluation,
        unit_scale_evaluation=args.unit_scale_evaluation,
        f1_threshold_lst=args.f1_threshold_lst,
        jsd=args.jsd, cd=args.cd, emd=args.emd, f1=args.f1,
        interpolation_steps=args.interpolation_steps,
        interpolation_batches=args.interpolation_batches,
    )
    return config


def is_svr(config: Dict) -> bool:
    return config.get("train_mode") == SVR_TRAIN_MODE


def build_dataset(config: Dict, part: str, seed: int = 0, store=None):
    """The evaluated split: ShapeNetAll views for an SVR config, else
    ShapeNetCore meshes, with the val transforms; from config["path2data"]
    or from `store`."""
    _, transform_val = ComposeCloudTransformation(**config)
    common = dict(
        path2data=config["path2data"],
        meshes_fname=config["meshes_fname"],
        cloud_size=config["cloud_size"],
        return_eval_cloud=True,
        return_original_scale=bool(config.get("orig_scale_evaluation")),
        chosen_label=config.get("chosen_label"),
        base_seed=seed,
        store=store,
        part=part,
        cloud_transform=transform_val,
    )
    if is_svr(config):
        return ShapeNetAllDataset(
            images_fname=config["images_fname"],
            image_transform=ComposeImageTransformation(**config), **common)
    return ShapeNetCoreDataset(**common)


def run(config: Dict, dataset, device="cuda", reps: int = 10, seed: int = 0,
        out_path: Optional[str] = None
        ) -> Tuple[torch.nn.Module, List[Dict]]:
    """Restore the checkpoint config["model_name"] from
    config["logging_path"] and evaluate `dataset` in config["util_mode"].
    Returns the restored model and the metric dicts (one a rep in
    generating mode, else one). In interpolation mode the one dict holds
    the arrays {"clouds1", "clouds2", "interpolations", "labels"}, also
    written to the h5 file `out_path` unless it is None."""
    check_precision(config)
    mode = config["util_mode"]
    if mode not in ("autoencoding", "generating", "reconstruction",
                    "interpolation"):
        raise ValueError(f"Unknown mode {mode}")
    if mode == "interpolation" and config["interpolation_steps"] < 2:
        raise SystemExit("--interpolation_steps must be >= 2 (the endpoints "
                         "themselves)")
    device = torch.device(device)
    svr = is_svr(config)
    loader = DataLoader(dataset, batch_size=config["batch_size"],
                        shuffle=False, drop_last=False,
                        num_workers=config.get("num_workers", 0),
                        worker_type=config.get("worker_type", "thread"))
    print(f"Dataset init: done ({len(dataset)} items).")
    try:
        kwargs = (svr_model_config_kwargs(config) if svr
                  else model_config_kwargs(config))
        kwargs["weights_type"] = config["weights_type"]
        model = (FlowMixtureSVRModel if svr else FlowMixtureModel)(
            **kwargs).to(device)
        optimizer = make_optimizer(list(model.parameters()),
                                   epoch_length=max(len(loader), 1),
                                   **config)
        state = create_train_state(model, optimizer, seed=seed)
        state, epoch, _ = restore_checkpoint(
            config["logging_path"], config["model_name"], state,
            restore_optimizer=False)
        print(f"Model loaded (epoch {epoch}).")

        if mode == "interpolation":
            arrays = interpolate(
                loader, model, seed=seed + 1,
                n_steps=config["interpolation_steps"],
                n_batches=config["interpolation_batches"],
                out_path=out_path, device=device)
            c1, _, interps, labels = arrays
            print(f"Interpolated {c1.shape[0]} shape pairs x "
                  f"{interps.shape[-1]} steps (labels "
                  f"1..{int(labels.max())}).")
            if out_path is not None:
                print(f"Saved interpolations to {out_path}.")
            return model, [dict(zip(("clouds1", "clouds2", "interpolations",
                                     "labels"), arrays))]

        # without SVR, reconstruction samples in autoencoding mode and
        # keeps the per-batch meters
        sample_mode = ("autoencoding" if mode == "reconstruction"
                       and not svr else mode)
        sample_step = make_sample_step(model, config["sampled_cloud_size"],
                                       sample_mode, svr=svr)
        if mode != "generating":
            generator = torch.Generator(device=device).manual_seed(seed + 1)
            return model, [evaluate(loader, sample_step, generator, device,
                                    svr=svr, **config)]

        # the reference-vs-reference matrices are the same in every rep:
        # computed in rep 0 and reused (compute_all_metrics's ref_cache)
        results, ref_cache = [], {}
        for rep in range(reps):
            generator = torch.Generator(device=device).manual_seed(
                derived_seed(seed + 1, rep))
            results.append(evaluate(loader, sample_step, generator, device,
                                    svr=svr, ref_cache=ref_cache, **config))
        print("==== mean ± std over", reps, "reps ====")
        for key in results[0]:
            vals = np.array([r[key] for r in results])
            print(f"{key}: {vals.mean():.2f} ± {vals.std():.2f}")
        return model, results
    finally:
        loader.close()


def main(argv: Optional[List[str]] = None):
    args = define_options_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = eval_config(args)
    dataset = build_dataset(config, args.part, seed=args.seed)
    out_path = os.path.join(args.experiment_path,
                            f"interpolations_{args.part}.h5")
    try:
        return run(config, dataset, device, reps=args.reps, seed=args.seed,
                   out_path=out_path)
    finally:
        dataset.close()


if __name__ == "__main__":
    main()
