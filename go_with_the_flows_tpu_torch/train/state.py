"""Train state (counterpart of go_with_the_flows_tpu/train/state.py).

The JAX state is a pytree of params, BatchNorm statistics, optimizer
state and the step count. Here the model holds the first two and the
optimizer its own state, so the state is the model, the `AmsgradWD`
optimizer, the step count and the training generator, whose draws (the
posterior noise) continue from where a saved state left off.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    # the means of the last epoch of train() and of evaluate_val() by
    # metric ("loss", "pnll", "gnll", "gent"); not saved in checkpoints
    train_metrics: Dict[str, float] = field(default_factory=dict)
    val_metrics: Dict[str, float] = field(default_factory=dict)


def create_train_state(model, optimizer, seed: int = 0) -> TrainState:
    """A state at step 0 whose training generator lives on the model's
    device and is seeded with `seed`."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, generator=generator)
