"""Data-parallel processes through torch.distributed (counterpart of
go_with_the_flows_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a mesh whose `data` axis
splits the batch; here every rank is a process with its own device and
its own rows of the global batch, and the global-batch semantics are
kept by collectives:

  * BatchNorm statistics are over the global batch (`ops/layers.py`
    BatchNorm and `batch_stats`, and kernels 7 and 8, sum their partial
    sums over the ranks through `sum_over_ranks` whenever `active()`);
  * the optimizer averages the flat gradient over the ranks before it
    steps (`optim.py`), so every rank takes the same step;
  * rank 0 alone writes checkpoints and reads them back for the others
    (`train/checkpoints.py`, through `on_rank0`);
  * eval and reconstruct passes end with the same gathered arrays on
    every rank (`gather_global`, `gather_batch`).

The process group's backend is NCCL when each rank has a card of its
own, gloo on the CPU and when ranks share a card (NCCL refuses two ranks
on one device). Gathers and object broadcasts always run over a gloo
group on CPU tensors, since gloo has no all_gather of CUDA tensors, and
an all_reduce of a CPU tensor runs there too, since NCCL takes none.
Every collective must be reached by every rank in the same order; a rank
that fails alone would leave the others waiting, so `on_rank0`
broadcasts rank 0's success before anyone goes on, and the rendezvous
and every collective time out after `timeout` seconds.

Batches are split evenly: a global batch of B rows gives each of the W
ranks B / W rows, and the statistics' counts are W times a rank's.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as tdist

# the gloo group for gathers and object broadcasts: None when the
# default group is gloo itself
_cpu_group = None
# collectives issued by this process, by kind (the smoke test reads them)
counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def distributed_init(backend: str = "gloo", init_method: str = "env://",
                     world_size: int = 1, rank: int = 0,
                     timeout: float = 300.0) -> None:
    """Join the process group: `init_method` a rendezvous URL
    (`tcp://host:port` or `file:///path`), this process rank `rank` of
    `world_size`. The rendezvous and every collective fail after
    `timeout` seconds instead of waiting for a rank that never comes."""
    global _cpu_group
    span = datetime.timedelta(seconds=timeout)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank, timeout=span)
    _cpu_group = (None if backend == "gloo"
                  else tdist.new_group(backend="gloo", timeout=span))


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _cpu_group
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _cpu_group = None


def world_size() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def rank() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def active() -> bool:
    """True inside a process group of more than one rank."""
    return world_size() > 1


# --------------------------------------------------------------------- #
# reductions                                                            #
# --------------------------------------------------------------------- #

def _group(t: torch.Tensor):
    """The group a collective on `t` runs in: the gloo group for a CPU
    tensor (the default group may be NCCL, which takes CUDA tensors
    only), the default group otherwise."""
    return _cpu_group if t.device.type == "cpu" else None


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    counts["all_reduce"] += 1
    tdist.all_reduce(t, group=_group(t))
    return t


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks; its backward sums the
    cotangents over the ranks too (each rank's output feeds every rank's
    loss)."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable, as a new tensor;
    `t` itself outside a process group."""
    if not active():
        return t
    return _SumOverRanks.apply(t)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """Average `t` over the ranks in place and return it."""
    if active():
        _all_reduce(t).div_(world_size())
    return t


def barrier() -> None:
    if active():
        tdist.barrier(group=_cpu_group)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` (picklable; tensors in it on the CPU) on every
    rank."""
    if not active():
        return obj
    counts["broadcast"] += 1
    box = [obj]
    tdist.broadcast_object_list(box, src=src, group=_cpu_group)
    return box[0]


def on_rank0(fn: Callable):
    """fn() run on rank 0 alone, its result broadcast to every rank. If
    rank 0 raises, every rank raises (rank 0 its own error), so that no
    rank waits in a later collective for a rank that has gone."""
    if not active():
        return fn()
    result, error = None, None
    if rank() == 0:
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001  (raised again below)
            error = e
    ok = broadcast_object(error is None)
    if not ok:
        if error is not None:
            raise error
        raise RuntimeError("rank 0 failed (its own error is in its log)")
    return broadcast_object(result)


# --------------------------------------------------------------------- #
# placement and gathers                                                 #
# --------------------------------------------------------------------- #

def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def place_batch(batch: Dict, device="cpu") -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (a dict of (B, ...) arrays or
    tensors), as tensors on `device`: rows [r B / W, (r + 1) B / W) on
    rank r of W. Raises when B does not divide by W: the statistics'
    counts assume equal shards (mesh.py's place_batch raises as well)."""
    n = int(next(iter(batch.values())).shape[0])
    world, r = world_size(), rank()
    if n % world:
        raise ValueError(f"global batch {n} not divisible by the {world} "
                         "ranks: adjust the batch size")
    per = n // world
    return {k: _as_tensor(v[r * per:(r + 1) * per]).to(device)
            for k, v in batch.items()}


def place_batch_uneven(batch: Dict, device="cpu"
                       ) -> Tuple[Dict[str, torch.Tensor], Callable]:
    """This rank's own batch (from its loader shard) as tensors on
    `device`, padded by repeating its last row up to the largest batch of
    any rank, so that every rank contributes a block of equal size to a
    gather; and `trim`, which takes those pad rows out of a gathered
    array (W blocks of the padded size), leaving every rank's real rows
    in rank order. A collective: every rank calls it."""
    n = int(next(iter(batch.values())).shape[0])
    sizes = [n]
    if active():
        got = _gather_cpu(torch.tensor([n], dtype=torch.int64))
        sizes = [int(s) for s in got]
    padded = max(sizes)
    pad = padded - n

    def grow(v):
        t = _as_tensor(v)
        if pad:
            t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
        return t.to(device)

    def trim(arr) -> np.ndarray:
        arr = np.asarray(arr)
        if padded * len(sizes) != arr.shape[0]:
            raise ValueError(f"trim expects {len(sizes)} gathered blocks of "
                             f"{padded} rows, got {arr.shape[0]} rows")
        if all(s == padded for s in sizes):
            return arr
        return np.concatenate([arr[i * padded:i * padded + s]
                               for i, s in enumerate(sizes)])

    return {k: grow(v) for k, v in batch.items()}, trim


def _gather_cpu(t: torch.Tensor) -> torch.Tensor:
    """The concatenation over the ranks of the CPU tensors `t`, which
    have one shape on every rank."""
    counts["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(world_size())]
    tdist.all_gather(parts, t.contiguous(), group=_cpu_group)
    return torch.cat(parts)


def gather_global(x) -> np.ndarray:
    """Every rank's (B, ...) `x` (a tensor on any device, or an array)
    concatenated over the ranks in rank order, as numpy on every rank.
    The shapes must agree across the ranks (place_batch_uneven pads them
    so); a mismatch raises on every rank."""
    t = _as_tensor(x).detach().cpu()
    if not active():
        return t.numpy()
    dims = torch.full((8,), -1, dtype=torch.int64)
    dims[:t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    shapes = _gather_cpu(dims).reshape(world_size(), 8)
    if not bool((shapes == shapes[0]).all()):
        raise ValueError("gather_global: the ranks hold different shapes "
                         f"{shapes.tolist()}: pad with place_batch_uneven")
    return _gather_cpu(t).numpy()


def gather_batch(batch: Dict) -> Dict[str, np.ndarray]:
    """gather_global over a dict of (B, ...) arrays."""
    return {k: gather_global(v) for k, v in batch.items()}
