"""The port's command-line entry points (counterparts of the JAX
package's root scripts train_ae.py, evaluate_ae.py, reconstruct_ae.py
and train_svr.py), with the same positional arguments and flags:

    python -m go_with_the_flows_tpu_torch.cli.train_ae \
        CONFIG NAME N_EPOCHS LR [flags]
    python -m go_with_the_flows_tpu_torch.cli.evaluate_ae EXPERIMENT_PATH \
        NAME PART CLOUD_SIZE SAMPLED_CLOUD_SIZE MODE [flags]
    python -m go_with_the_flows_tpu_torch.cli.reconstruct_ae \
        EXPERIMENT_PATH NAME [flags]
    python -m go_with_the_flows_tpu_torch.cli.train_svr \
        CONFIG NAME N_EPOCHS LR [flags]

Each adds `--device` (default `cuda`): with no card, a command fails
unless it is given `--device cpu`. Each module splits into `main(argv)`
(arguments and config), `build_datasets` / `build_dataset` (the h5
datasets, or in-memory arrays handed in as `store`) and `run(config,
datasets, device)`, which chip_smoke.py calls on the card.

The port runs one process at fp32 'highest': `--distributed` or more
than one node, and a config whose `matmul_precision` or
`eval_matmul_precision` names another precision, are refused.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..train.checkpoints import checkpoint_exists, restore_checkpoint
from ..train.state import TrainState
from ..utils.config import write_config


def resolve_device(name: str) -> torch.device:
    """The device `--device` names; a CUDA device without a card is an
    error, never a quiet run on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on "
                           "the card; pass --device cpu to run on the CPU")
    return device


def check_precision(config: Dict) -> None:
    for key in ("matmul_precision", "eval_matmul_precision"):
        value = config.get(key)
        if value is not None and value != "highest":
            raise ValueError(
                f"{key}: {value!r}: the port runs fp32 'highest' only "
                "(TF32 and bf16 modes wait for an end-metric A/B on the "
                "card)")


def refuse_distributed(args) -> None:
    if args.distributed or args.nodes > 1:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP.md, queue 1 "
            "item 5): run one process")


def derived_seed(seed: int, *tags: int) -> int:
    """A seed for one use of a run's seed (an epoch's validation noise, a
    rep's samples), independent of the others."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(
        1, np.uint64)[0])


def start_logging(config: Dict):
    """Create the run's logging_path, write its config.yaml there, and
    return a TensorBoard writer, or None (with one line saying so) when
    tensorboard is not installed."""
    os.makedirs(config["logging_path"], exist_ok=True)
    write_config(config, os.path.join(config["logging_path"], "config.yaml"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard is not installed: no TensorBoard scalars are "
              "written")
        return None
    return SummaryWriter(os.path.join(config["logging_path"], "log"))


def maybe_resume(config: Dict, state: TrainState
                 ) -> Tuple[TrainState, int, int]:
    """(state, epoch, iter) from the run's checkpoint with `resume`, or
    the state as it is at epoch 0."""
    if config["resume"] and checkpoint_exists(config["logging_path"],
                                              config["model_name"]):
        state, epoch, it = restore_checkpoint(
            config["logging_path"], config["model_name"], state,
            restore_optimizer=config["resume_optimizer"])
        print(f"Resumed from epoch {epoch} iter {it}.")
        return state, epoch, it
    return state, 0, 0


def add_common_train_options(parser) -> None:
    """The flags train_ae and train_svr share with the JAX scripts, and
    --device."""
    parser.add_argument("--weights_type", type=str,
                        default="global_weights",
                        help="global_weights | learned_weights.")
    parser.add_argument("--warmup_epoch", type=int, default=5,
                        help="Epochs using global weights.")
    parser.add_argument("--jobid", type=str, default="1")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_optimizer", action="store_true")
    parser.add_argument("--distributed", action="store_true",
                        help="Not ported: refused.")
    parser.add_argument("-n", "--nodes", default=1, type=int, metavar="N",
                        help="More than 1 is refused (one process).")
    parser.add_argument("-g", "--gpus", default=0, type=int,
                        help="Unused (one card); kept for CLI parity.")
    parser.add_argument("-nr", "--nr", default=0, type=int,
                        help="Unused (one process); kept for CLI parity.")
    parser.add_argument("--coordinator", type=str, default="127.0.0.1:9731",
                        help="Unused (one process); kept for CLI parity.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler trace of a few early "
                             "training steps to DIR/trace.json.")
    parser.add_argument("--profile_steps", type=int, default=3,
                        help="Number of steps to trace under --profile.")
    add_device_option(parser)


def add_device_option(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="Where to run: cuda (the default; fails "
                             "without a card) or cpu.")
