"""Training CLI for generative modeling and autoencoding (counterpart of
the JAX package's train_ae.py, with the same arguments):

    python -m go_with_the_flows_tpu_torch.cli.train_ae CONFIG NAME \\
        N_EPOCHS LR [--weights_type ...] [--warmup_epoch ...] \\
        [--resume [--resume_optimizer]] [--device cpu] \\
        [--distributed -n NODES -g CARDS [-nr NODE] [--coordinator ...]]

Reads the YAML config (utils/config.load_config), writes the generated
logging_path back into it, and trains on the ShapeNetCore h5 meshes:
each epoch a training pass (kernels 7 and 8 on the card) with its
checkpoint and a validation pass (kernel 1's inverse) with the
best-model checkpoint. TensorBoard scalars go to logging_path/log when
tensorboard is installed. With --distributed every rank trains on its
shard of each global batch of the config's batch_size (cli/__init__.py
says how the ranks start); rank 0 logs and writes the checkpoints. Not
ported: the TensorBoard reconstruction figures (`logging_img`,
ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..data.cloud_transforms import ComposeCloudTransformation
from ..data.datasets import ShapeNetCoreDataset
from ..data.loader import DataLoader
from ..models.mixture import FlowMixtureModel
from ..optim import make_optimizer
from ..train import loops
from ..train.state import TrainState, create_train_state
from ..train.step import make_eval_step, make_train_step
from ..utils.config import (count_params, load_config, model_config_kwargs,
                            resolve_config)
from . import (add_common_train_options, check_precision, derived_seed,
               maybe_resume, rank_config, resolve_device, run_ranks,
               start_logging)


def define_options_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Model training script. Provide a suitable config.")
    parser.add_argument("config", type=str, help="Path to YAML config.")
    parser.add_argument("modelname", type=str, help="Checkpoint name.")
    parser.add_argument("n_epochs", type=int, help="Total epochs.")
    parser.add_argument("lr", type=float, help="Learning rate value.")
    parser.add_argument("--cloud_random_rotate", action="store_true",
                        help="Random 3D rotation augmentation.")
    add_common_train_options(parser)
    return parser


def build_datasets(config: Dict, seed: int = 0, store=None
                   ) -> Tuple[ShapeNetCoreDataset, ShapeNetCoreDataset]:
    """The train and val ShapeNetCore datasets of a resolved config, read
    from config["path2data"] or from `store` (arrays with the h5 keys)."""
    transform, transform_val = ComposeCloudTransformation(**config)
    common = dict(
        path2data=config["path2data"],
        meshes_fname=config["meshes_fname"],
        cloud_size=config["cloud_size"],
        return_eval_cloud=True,
        return_original_scale=bool(config.get("cloud_rescale2orig")
                                   or config.get("cloud_recenter2orig")),
        chosen_label=config.get("chosen_label"),
        base_seed=seed,
        store=store,
    )
    return (ShapeNetCoreDataset(part="train", cloud_transform=transform,
                                **common),
            ShapeNetCoreDataset(part="val", cloud_transform=transform_val,
                                **common))


def run(config: Dict, train_dataset, val_dataset, device="cuda",
        seed: int = 0, warmup_epoch: int = 5
        ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Train a resolved config's model from epoch 0 (or its checkpoint,
    with `resume`) to n_epochs. Returns the state and, per epoch run,
    {"epoch", "steps", "train_s", "val_s"} (wall seconds, the card's work
    included). Inside a process group every rank calls it: its loaders
    take its shard of the datasets, batch_size / world clouds a batch."""
    check_precision(config)
    device = torch.device(device)
    config, world, rank = rank_config(config)
    writer = start_logging(config)
    batch_size = config["batch_size"] // world
    workers = dict(num_workers=config.get("num_workers", 0),
                   worker_type=config.get("worker_type", "thread"),
                   num_replicas=world, rank=rank)
    train_loader = DataLoader(train_dataset, batch_size,
                              shuffle=config.get("shuffle", True),
                              seed=seed, **workers)
    val_loader = DataLoader(val_dataset, batch_size, shuffle=False,
                            seed=seed, **workers)
    if config["logging"]:
        print(f"Size of training data: {len(train_dataset)}")
        print(f"Size of validation data: {len(val_dataset)}")
    try:
        model = FlowMixtureModel(
            **model_config_kwargs(config),
            generator=torch.Generator().manual_seed(seed)).to(device)
        optimizer = make_optimizer(list(model.parameters()),
                                   epoch_length=len(train_loader), **config)
        state = create_train_state(model, optimizer, seed=seed)
        if config["logging"]:
            print("Total number of parameters:", count_params(model))
        state, cur_epoch, cur_iter = maybe_resume(config, state)
        weights = {k: config.get(k, 1.0)
                   for k in ("pnll_weight", "gnll_weight", "gent_weight")}
        train_step = make_train_step(model, state.optimizer, **weights)
        eval_step = make_eval_step(model, **weights)

        timings = []
        min_loss = 1e4
        for epoch in range(cur_epoch, config["n_epochs"]):
            warmup = epoch < warmup_epoch
            t0 = time.perf_counter()
            steps = state.step
            state = loops.train(train_loader, train_step, state, epoch,
                                cur_iter, warmup, device, writer=writer,
                                **config)
            t1 = time.perf_counter()
            min_loss = loops.evaluate_val(
                val_loader, eval_step, state, epoch, warmup, min_loss,
                torch.Generator(device=device).manual_seed(
                    derived_seed(seed, 10_000 + epoch)),
                device, writer=writer, **config)
            t2 = time.perf_counter()
            timings.append({"epoch": epoch, "steps": state.step - steps,
                            "train_s": t1 - t0, "val_s": t2 - t1})
            if config["logging"]:
                print(f"epoch {epoch}: train {t1 - t0:.2f} s "
                      f"({timings[-1]['steps']} steps), validation "
                      f"{t2 - t1:.2f} s")
            cur_iter = 0
        return state, timings
    finally:
        if writer is not None:
            writer.close()
        train_loader.close()
        val_loader.close()


def configure(args) -> Dict:
    """The resolved config of a parsed command line; a generated
    logging_path is written back into the file args.config."""
    loaded = load_config(args.config)
    return resolve_config(
        loaded,
        modelname=args.modelname,
        n_epochs=args.n_epochs,
        lr=args.lr,
        weights_type=args.weights_type,
        jobid=args.jobid,
        resume=args.resume,
        resume_optimizer=args.resume_optimizer,
        cloud_random_rotate=bool(args.cloud_random_rotate
                                 or loaded.get("cloud_random_rotate")),
        config_path=args.config,
        profile_dir=args.profile,
        profile_steps=args.profile_steps,
    )


def main(argv: Optional[List[str]] = None):
    """Run the command line `argv`: (state, timings) of `run`, or None
    with --distributed (the ranks are other processes)."""
    args = define_options_parser().parse_args(argv)
    resolve_device(args.device)  # before the config file is written
    config = configure(args)
    return run_ranks(args, _train, config, args.seed, args.warmup_epoch)


def _train(device, config: Dict, seed: int, warmup_epoch: int):
    train_dataset, val_dataset = build_datasets(config, seed=seed)
    try:
        return run(config, train_dataset, val_dataset, device, seed=seed,
                   warmup_epoch=warmup_epoch)
    finally:
        train_dataset.close()
        val_dataset.close()


if __name__ == "__main__":
    main()
