"""Training CLI for single-view reconstruction (counterpart of the JAX
package's train_svr.py, with the same arguments):

    python -m go_with_the_flows_tpu_torch.cli.train_svr CONFIG NAME \\
        N_EPOCHS LR [--weights_type ...] [--warmup_epoch ...] \\
        [--resume [--resume_optimizer]] [--device cpu] \\
        [--distributed -n NODES -g CARDS [-nr NODE] [--coordinator ...]]

ShapeNetAll13 clouds and renderings (the image transforms of the
config), FlowMixtureSVRModel and the `svr=True` train step; training
only, as in the reference (no SVR validation loop). TensorBoard scalars
at every step when tensorboard is installed; with the config's
`logging_img`, SVR reconstruction figures on the checkpoint cadence
(viz/tb.py: the first training batch reconstructed from its images,
kernel 1, the images beside the clouds). With --distributed every
rank trains on its shard of each global batch of the config's
batch_size, its loader transforming only its own images (cli/__init__.py
says how the ranks start); the ResNet's BatchNorms, like every other,
take the global batch's statistics; rank 0 logs and writes the
checkpoints and the figures.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..data.cloud_transforms import ComposeCloudTransformation
from ..data.datasets import ShapeNetAllDataset
from ..data.image_transforms import ComposeImageTransformation
from ..data.loader import DataLoader
from ..models.mixture import FlowMixtureSVRModel
from ..ops.precision import matmul_precision_scope
from ..optim import make_optimizer
from ..train import loops
from ..train.state import TrainState, create_train_state
from ..train.step import make_sample_step, make_train_step
from ..utils.config import (count_params, load_config, resolve_config,
                            svr_model_config_kwargs)
from . import (add_common_train_options, derived_seed, maybe_resume,
               rank_config, resolve_device, run_ranks, start_logging,
               training_precision)


def define_options_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SVR model training script. Provide a suitable config.")
    parser.add_argument("config", type=str)
    parser.add_argument("modelname", type=str)
    parser.add_argument("n_epochs", type=int)
    parser.add_argument("lr", type=float)
    add_common_train_options(parser)
    return parser


def build_dataset(config: Dict, seed: int = 0,
                  store=None) -> ShapeNetAllDataset:
    """The train split of ShapeNetAll: views with the config's image
    transforms, clouds with its train transform."""
    transform, _ = ComposeCloudTransformation(**config)
    return ShapeNetAllDataset(
        path2data=config["path2data"], part="train",
        images_fname=config["images_fname"],
        meshes_fname=config["meshes_fname"],
        cloud_size=config["cloud_size"], return_eval_cloud=True,
        image_transform=ComposeImageTransformation(**config),
        cloud_transform=transform, base_seed=seed, store=store)


def run(config: Dict, train_dataset, device="cuda", seed: int = 0,
        warmup_epoch: int = 5
        ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Train a resolved SVR config's model to n_epochs. Returns the state
    and, per epoch run, {"epoch", "steps", "train_s"}. Inside a process
    group every rank calls it: its loader takes its shard of the dataset,
    batch_size / world views a batch. The train step, and the figures'
    sample step, run in the config's `matmul_precision` ('highest'
    without it; cli/__init__.py)."""
    mode = training_precision(config)
    device = torch.device(device)
    config, world, rank = rank_config(config)
    writer = start_logging(config)
    train_loader = DataLoader(
        train_dataset, config["batch_size"] // world,
        shuffle=config.get("shuffle", True), seed=seed,
        num_workers=config.get("num_workers", 0),
        worker_type=config.get("worker_type", "thread"),
        num_replicas=world, rank=rank)
    if config["logging"]:
        print(f"Size of training data: {len(train_dataset)}")
    try:
        model = FlowMixtureSVRModel(
            **svr_model_config_kwargs(config),
            generator=torch.Generator().manual_seed(seed)).to(device)
        optimizer = make_optimizer(list(model.parameters()),
                                   epoch_length=len(train_loader), **config)
        state = create_train_state(model, optimizer, seed=seed)
        if config["logging"]:
            print("Total number of parameters:", count_params(model))
        state, cur_epoch, cur_iter = maybe_resume(config, state)
        with matmul_precision_scope(mode):
            train_step = make_train_step(
                model, state.optimizer, svr=True,
                **{k: config.get(k, 1.0)
                   for k in ("pnll_weight", "gnll_weight", "gent_weight")})
            svr_sample_step = make_sample_step(
                model, config["cloud_size"], mode="reconstruction", svr=True)

        def svr_recon_fn(st):
            # the same noise at every call, as the JAX script's fixed key
            return loops.reconstruct(
                train_loader, svr_sample_step, torch.Generator(
                    device=device).manual_seed(derived_seed(seed, 888)),
                device, max_batches=1, svr=True, return_images=True)

        timings = []
        for epoch in range(cur_epoch, config["n_epochs"]):
            t0 = time.perf_counter()
            steps = state.step
            state = loops.train(train_loader, train_step, state, epoch,
                                cur_iter, epoch < warmup_epoch, device,
                                svr=True, writer=writer, per_step_tb=True,
                                svr_recon_fn=svr_recon_fn, **config)
            t1 = time.perf_counter()
            timings.append({"epoch": epoch, "steps": state.step - steps,
                            "train_s": t1 - t0})
            if config["logging"]:
                print(f"epoch {epoch}: train {t1 - t0:.2f} s "
                      f"({timings[-1]['steps']} steps)")
            cur_iter = 0
        return state, timings
    finally:
        if writer is not None:
            writer.close()
        train_loader.close()


def configure(args) -> Dict:
    """The resolved config of a parsed command line; a generated
    logging_path is written back into the file args.config."""
    return resolve_config(
        load_config(args.config), modelname=args.modelname,
        n_epochs=args.n_epochs, lr=args.lr,
        weights_type=args.weights_type, jobid=args.jobid,
        resume=args.resume, resume_optimizer=args.resume_optimizer,
        config_path=args.config,
        profile_dir=args.profile, profile_steps=args.profile_steps)


def main(argv: Optional[List[str]] = None):
    """Run the command line `argv`: (state, timings) of `run`, or None
    with --distributed (the ranks are other processes)."""
    args = define_options_parser().parse_args(argv)
    resolve_device(args.device)  # before the config file is written
    config = configure(args)
    return run_ranks(args, _train, config, args.seed, args.warmup_epoch)


def _train(device, config: Dict, seed: int, warmup_epoch: int):
    dataset = build_dataset(config, seed=seed)
    try:
        return run(config, dataset, device, seed=seed,
                   warmup_epoch=warmup_epoch)
    finally:
        dataset.close()


if __name__ == "__main__":
    main()
