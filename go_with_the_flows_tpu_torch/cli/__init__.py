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

train_ae and train_svr train data-parallel as the reference's DDP
launch does:
`--distributed -n NODES -g PROCESSES_A_NODE -nr NODE --coordinator
HOST:PORT` spawns -g processes on this node, rank nr * g + local of
n * g, each on the card cuda:<local> (NCCL between them; gloo when
ranks share a card) or, under `--device cpu`, on the CPU (gloo); the
coordinator may also be a `file://` URL. The config's batch_size is the
global batch. The port runs at fp32 'highest': a config whose
`matmul_precision` or `eval_matmul_precision` names another precision is
refused.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..parallel import dist
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


# seconds a rank waits at the rendezvous or in a collective for the others
DIST_TIMEOUT = 300.0


def run_ranks(args, target: Callable, *target_args):
    """target(device, *target_args) in this process, or with
    `--distributed` in args.gpus spawned processes of this node, each a
    rank of args.nodes * args.gpus in a process group (a failed rank
    fails the command: the others are stopped). Returns target's result
    in this process, None with --distributed."""
    if not args.distributed:
        if args.nodes > 1:
            raise ValueError("-n above 1 needs --distributed")
        return target(resolve_device(args.device), *target_args)
    if args.gpus < 1 or args.nodes < 1 or not 0 <= args.nr < args.nodes:
        raise ValueError(f"--distributed needs -g >= 1 processes a node and "
                         f"0 <= -nr < -n, got -g {args.gpus}, -n "
                         f"{args.nodes}, -nr {args.nr}")
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(args, target, target_args),
                       nprocs=args.gpus, join=True, start_method="spawn")
    return None


def _rank_main(local: int, args, target: Callable, target_args) -> None:
    world, rank = args.nodes * args.gpus, args.nr * args.gpus + local
    device = resolve_device(args.device)
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        if args.gpus <= cards:  # NCCL refuses two ranks on one card
            backend = "nccl"
    url = args.coordinator
    dist.distributed_init(backend, url if "://" in url else f"tcp://{url}",
                          world, rank, DIST_TIMEOUT)
    try:
        target(device, *target_args)
    finally:
        dist.shutdown()


def rank_config(config: Dict) -> Tuple[Dict, int, int]:
    """(config, world size, rank) for a training run on this rank: the
    global batch_size must divide by the ranks; rank 0 alone logs and
    profiles, and every rank checkpoints (saving is a collective)."""
    world, rank = dist.world_size(), dist.rank()
    if config["batch_size"] % world:
        raise ValueError(f"batch_size {config['batch_size']} not divisible "
                         f"by the {world} ranks")
    config = dict(config, logging=rank == 0, checkpointing=True,
                  profile_dir=config.get("profile_dir") if rank == 0
                  else None)
    return config, world, rank


def derived_seed(seed: int, *tags: int) -> int:
    """A seed for one use of a run's seed (an epoch's validation noise, a
    rep's samples), independent of the others."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(
        1, np.uint64)[0])


def start_logging(config: Dict):
    """Create the run's logging_path, write its config.yaml there, and
    return a TensorBoard writer, or None (with one line saying so) when
    tensorboard is not installed; None on every rank but rank 0, which
    alone logs."""
    if dist.rank() != 0:
        return None
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
        if dist.rank() == 0:
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
                        help="Data-parallel training over -n nodes of -g "
                             "processes.")
    parser.add_argument("-n", "--nodes", default=1, type=int, metavar="N",
                        help="Nodes of the run.")
    parser.add_argument("-g", "--gpus", default=0, type=int,
                        help="Processes (cards) a node.")
    parser.add_argument("-nr", "--nr", default=0, type=int,
                        help="This node's rank among the nodes.")
    parser.add_argument("--coordinator", type=str, default="127.0.0.1:9731",
                        help="Rendezvous: HOST:PORT of rank 0 (or a URL, "
                             "file:///path for one machine).")
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
