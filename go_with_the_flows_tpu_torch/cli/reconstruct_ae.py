"""Reconstruction dump CLI (counterpart of the JAX package's
reconstruct_ae.py, with the same arguments):

    python -m go_with_the_flows_tpu_torch.cli.reconstruct_ae \\
        EXPERIMENT_PATH NAME [--part val] [--batch_size 16] [--device cpu]

Loads an experiment, reconstructs the split in autoencoding mode and
writes all_samples.npy (S, 3, N), all_gts.npy (S, 3, N) and
all_labels.npy (S, N) into EXPERIMENT_PATH. (The reference passes the
(train, val) transform pair as one transform; here the val transform is
used, as in the JAX package.)

The matmul precision mode is evaluate_ae's: the config's
`eval_matmul_precision`, else its `matmul_precision`, else 'highest' (the
JAX script's default is 'high'; see cli/evaluate_ae.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from ..data.cloud_transforms import ComposeCloudTransformation
from ..data.datasets import ShapeNetCoreDataset
from ..data.loader import DataLoader
from ..models.mixture import FlowMixtureModel
from ..optim import make_optimizer
from ..train.checkpoints import restore_checkpoint
from ..train.loops import predict
from ..train.state import create_train_state
from ..train.step import make_sample_step
from ..utils.config import load_config, model_config_kwargs
from ..ops.precision import matmul_precision_scope
from . import add_device_option, eval_precision, resolve_device


def define_options_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AE reconstruction dump.")
    p.add_argument("experiment_path", type=str)
    p.add_argument("modelname", type=str)
    p.add_argument("--part", type=str, default="val")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    add_device_option(p)
    return p


def build_dataset(config: Dict, part: str, seed: int = 0,
                  store=None) -> ShapeNetCoreDataset:
    _, transform_val = ComposeCloudTransformation(**config)
    return ShapeNetCoreDataset(
        path2data=config["path2data"], part=part,
        meshes_fname=config["meshes_fname"],
        cloud_size=config["cloud_size"], return_eval_cloud=True,
        cloud_transform=transform_val,
        chosen_label=config.get("chosen_label"), base_seed=seed,
        store=store)


def run(config: Dict, dataset, device="cuda", batch_size: int = 16,
        seed: int = 0):
    """Restore config["model_name"] from config["logging_path"],
    reconstruct `dataset` and write the three .npy files there. Returns
    (samples, gts, labels). Runs in the matmul precision mode
    `eval_precision(config)` and restores the mode it found."""
    with matmul_precision_scope(eval_precision(config)):
        return _run(config, dataset, device, batch_size, seed)


def _run(config, dataset, device, batch_size, seed):
    device = torch.device(device)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        drop_last=False)
    model = FlowMixtureModel(**model_config_kwargs(config)).to(device)
    optimizer = make_optimizer(list(model.parameters()),
                               epoch_length=max(len(loader), 1), **config)
    state = create_train_state(model, optimizer, seed=seed)
    state, epoch, _ = restore_checkpoint(config["logging_path"],
                                         config["model_name"], state,
                                         restore_optimizer=False)
    print(f"Model loaded (epoch {epoch}).")
    sample_step = make_sample_step(model, config["cloud_size"],
                                   "autoencoding")
    out = predict(loader, sample_step,
                  torch.Generator(device=device).manual_seed(seed + 1),
                  config["logging_path"], device)
    print("Saved all_samples.npy / all_gts.npy / all_labels.npy to",
          config["logging_path"])
    return out


def main(argv: Optional[List[str]] = None):
    args = define_options_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(os.path.join(args.experiment_path, "config.yaml"))
    config.update(logging_path=args.experiment_path,
                  model_name=args.modelname)
    dataset = build_dataset(config, args.part, seed=args.seed)
    try:
        return run(config, dataset, device, batch_size=args.batch_size,
                   seed=args.seed)
    finally:
        dataset.close()


if __name__ == "__main__":
    main()
