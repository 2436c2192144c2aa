"""Import a reference PyTorch checkpoint into a checkpoint of the port
(counterpart of the JAX package's tools/import_torch_ckpt.py, with the
same arguments but --unrolled: the port has one decoder layout):

    python -m go_with_the_flows_tpu_torch.cli.import_torch_ckpt \\
        TORCH_CKPT CONFIG OUT_DIR [--model_name model.ckpt] [--seed 0] \\
        [--device cpu]

The reference saves {'epoch', 'iter', 'model_state', 'optimizer_state'}
with torch.save(..., pickle_protocol=4). Its model_state (DDP's
`module.` keys too) is mapped onto the port's FlowMixtureModel, or
FlowMixtureSVRModel when the config's train_mode is
p_rnvp_mc_g_rnvp_vae_ic (utils/torch_import.py), and written as the
port's checkpoint OUT_DIR/<model_name> with the payload's epoch and
iter, beside the config as OUT_DIR/config.yaml (its logging_path
OUT_DIR, its model_name --model_name). evaluate_ae reads it, and so does
train_ae (or train_svr) --resume without --resume_optimizer: the
optimizer state is not converted, the optimizer starts fresh, as in the
JAX package's tool. The training generator saved with it lives on
`--device` (default cuda, as the other entry points), where the
checkpoint is to be restored.

The checkpoint is unpickled with torch.load(weights_only=False), since
the reference's protocol-4 pickles hold more than tensors: import
trusted files only.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from ..optim import make_optimizer
from ..train.checkpoints import _ckpt_dir, save_checkpoint
from ..train.state import create_train_state
from ..utils.config import load_config, write_config
from ..utils.torch_import import build_model, load_reference
from . import add_device_option, resolve_device
from .evaluate_ae import is_svr


def define_options_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference PyTorch checkpoint (.pkl) into a "
                    "checkpoint of the port. The file is unpickled "
                    "(torch.load with weights_only=False): import trusted "
                    "files only. The port has one decoder layout, so "
                    "there is no --unrolled.")
    p.add_argument("torch_ckpt", help="The reference's .pkl checkpoint.")
    p.add_argument("config", help="The experiment's config.yaml.")
    p.add_argument("out_dir", help="Where the port's checkpoint and the "
                                   "config go.")
    p.add_argument("--model_name", default="model.ckpt",
                   help="Name of the port's checkpoint.")
    p.add_argument("--seed", type=int, default=0,
                   help="Seed of the template model and of the training "
                        "generator saved with the checkpoint.")
    add_device_option(p)
    return p


def import_checkpoint(torch_ckpt: str, config_path: str, out_dir: str,
                      model_name: str = "model.ckpt", seed: int = 0,
                      device="cuda"):
    """Read the reference checkpoint, map it onto the port's model, and
    write the port's checkpoint (its training generator on `device`) and
    the config into out_dir. Returns (model on `device`, epoch, iter)."""
    config = load_config(config_path)
    svr = is_svr(config)
    payload = torch.load(torch_ckpt, map_location="cpu", weights_only=False)
    model = build_model(config, svr, torch.Generator().manual_seed(seed))
    load_reference(model, payload["model_state"], config, svr)
    model.to(device)
    optimizer = make_optimizer(
        list(model.parameters()),
        epoch_length=max(int(config.get("epoch_length", 100)), 1),
        cycle_length=config.get("cycle_length", 1),
        min_lr=config.get("min_lr", 1e-4), max_lr=config.get("max_lr", 1e-3),
        beta1=config.get("beta1", 0.9),
        min_beta2=config.get("min_beta2", 0.99),
        max_beta2=config.get("max_beta2", 0.99), wd=config.get("wd", 0.0))
    state = create_train_state(model, optimizer, seed=seed)
    epoch = int(payload.get("epoch", 0))
    iteration = int(payload.get("iter", 0))
    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(out_dir, model_name, state, epoch, iteration)
    write_config(dict(config, logging_path=os.path.abspath(out_dir),
                      model_name=model_name),
                 os.path.join(out_dir, "config.yaml"))
    print(f"Imported {torch_ckpt} -> {_ckpt_dir(out_dir, model_name)} "
          f"(epoch {epoch}, iter {iteration}, "
          f"{'SVR' if svr else 'AE/gen'} model)")
    return model, epoch, iteration


def main(argv: Optional[List[str]] = None):
    args = define_options_parser().parse_args(argv)
    device = resolve_device(args.device)
    return import_checkpoint(args.torch_ckpt, args.config, args.out_dir,
                             args.model_name, args.seed, device)


if __name__ == "__main__":
    main()
