"""Checkpoints (counterpart of go_with_the_flows_tpu/train/checkpoints.py):
a `torch.save` of {"epoch", "iter", "step", "model_state",
"optimizer_state", "generator_state"}, the reference's payload with the
step count and the training generator added, so that a resumed run
draws the same noise as one that never stopped. Every entry is a tensor,
a number or a registered safe class (optim.CosineCycle), so the file
loads under torch.load's weights_only=True.

The JAX package's names and layout stay: `<logging_path>/<model_name>`
with ".pkl" turned into ".ckpt" is a directory (`_ckpt_dir`), which holds
the file `checkpoint.pt`. The packed decoder is derived from the model's
tensors and is not saved.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ..parallel import dist
from .state import TrainState

_FILE = "checkpoint.pt"


def _ckpt_dir(logging_path: str, model_name: str) -> str:
    # the reference saves <logging_path>/<model_name>.pkl; a directory here
    name = model_name.replace(".pkl", ".ckpt")
    return os.path.abspath(os.path.join(logging_path, name))


def save_checkpoint(logging_path: str, model_name: str, state: TrainState,
                    epoch: int, iteration: int) -> None:
    """Write the state; the file is replaced whole (written beside it,
    then renamed), so a crash leaves the previous checkpoint readable.

    Data-parallel: a collective, which every rank calls at the same
    point. Rank 0 alone writes (every rank holds the same state), and no
    rank goes on before the write is done; if it fails, every rank
    raises."""
    def write():
        path = _ckpt_dir(logging_path, model_name)
        os.makedirs(path, exist_ok=True)
        payload = {
            "epoch": int(epoch),
            "iter": int(iteration),
            "step": int(state.step),
            "model_state": state.model.state_dict(),
            "optimizer_state": state.optimizer.state_dict(),
            "generator_state": state.generator.get_state(),
        }
        target = os.path.join(path, _FILE)
        tmp = target + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)

    dist.on_rank0(write)


def restore_checkpoint(logging_path: str, model_name: str,
                       state: TrainState, restore_optimizer: bool = True
                       ) -> Tuple[TrainState, int, int]:
    """Load a checkpoint into `state` (its model, optimizer and generator
    are written in place, on their own devices) and return (state, epoch,
    iter). With restore_optimizer=False the optimizer keeps its fresh
    state (the reference's --resume without --resume_optimizer).

    Data-parallel: a collective. Rank 0 reads the file and broadcasts
    it, so the other ranks need no view of its filesystem; if the read
    fails, every rank raises."""
    path = os.path.join(_ckpt_dir(logging_path, model_name), _FILE)
    payload = dist.on_rank0(
        lambda: torch.load(path, map_location="cpu", weights_only=True))
    state.model.load_state_dict(payload["model_state"])
    if restore_optimizer:
        state.optimizer.load_state_dict(payload["optimizer_state"])
    state.generator.set_state(payload["generator_state"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), int(payload["iter"])


def checkpoint_exists(logging_path: str, model_name: str) -> bool:
    """Whether the checkpoint file exists; data-parallel, rank 0's answer
    on every rank (a collective), so that every rank takes the same
    branch."""
    return dist.on_rank0(lambda: os.path.isfile(
        os.path.join(_ckpt_dir(logging_path, model_name), _FILE)))
