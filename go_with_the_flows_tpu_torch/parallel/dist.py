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

The ranks form a (data, points) grid, as `make_mesh` lays out the JAX
mesh: with `points_parallelism` P, rank r is row r // P of the data
axis and column r % P of the points axis, and `place_batch(...,
shard_points=True)` gives it its data row's clouds with its column's
slice of their points. The group a reduction runs in follows the
tensor: statistics of a tensor with a point axis sum over every rank
(`sum_over_ranks(t)`), those of a per-cloud tensor (each points rank
holds the same rows) over the data axis (`sum_over_ranks(t, "data")`),
a cloud's sum over its points over the points axis
(`sum_over_ranks(t, "points")`, `max_over_points`). The JAX package's
module path gets these reductions from XLA (mesh.py); here each is a
collective with its backward. With P = 1 the data axis is the whole
world and no collective changes.
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
# the points axis's size P of the (data, points) grid, and this rank's
# groups over each axis of a grid with P > 1: {axis: (group, gloo group)}
_points = 1
_axis_groups: Dict[str, tuple] = {}
AXES = ("world", "data", "points")


def distributed_init(backend: str = "gloo", init_method: str = "env://",
                     world_size: int = 1, rank: int = 0,
                     timeout: float = 300.0,
                     points_parallelism: int = 1) -> None:
    """Join the process group: `init_method` a rendezvous URL
    (`tcp://host:port` or `file:///path`), this process rank `rank` of
    `world_size`. The rendezvous and every collective fail after
    `timeout` seconds instead of waiting for a rank that never comes.
    The ranks form a (world_size / points_parallelism,
    points_parallelism) grid of the data and points axes (make_mesh's
    layout); a world that does not divide raises before joining."""
    global _cpu_group, _points
    if world_size % points_parallelism:
        raise ValueError(f"{world_size} devices not divisible by "
                         f"points={points_parallelism}")
    span = datetime.timedelta(seconds=timeout)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank, timeout=span)
    _cpu_group = (None if backend == "gloo"
                  else tdist.new_group(backend="gloo", timeout=span))
    _points = points_parallelism
    if points_parallelism == 1:
        return
    # every rank makes every group, in the same order
    P, D = points_parallelism, world_size // points_parallelism
    for axis, blocks in (
            ("data", [[d * P + p for d in range(D)] for p in range(P)]),
            ("points", [[d * P + p for p in range(P)] for d in range(D)])):
        for ranks in blocks:
            group = tdist.new_group(ranks, timeout=span)
            cpu = (group if backend == "gloo"
                   else tdist.new_group(ranks, backend="gloo", timeout=span))
            if rank in ranks:
                _axis_groups[axis] = (group, cpu)


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _cpu_group, _points
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _cpu_group = None
    _points = 1
    _axis_groups.clear()


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


def points_size() -> int:
    """The points axis's ranks: 1 outside a grid that splits points."""
    return _points


def data_size() -> int:
    """The data axis's ranks, among which a global batch's rows split."""
    return world_size() // _points


def points_rank() -> int:
    return rank() % _points


def data_rank() -> int:
    return rank() // _points


def axis_size(axis: str = "world") -> int:
    """The ranks of one axis of the grid: "world" (every rank), "data"
    or "points"."""
    if axis not in AXES:
        raise ValueError(f"axis {axis!r}: expected one of {AXES}")
    return {"world": world_size, "data": data_size,
            "points": points_size}[axis]()


# --------------------------------------------------------------------- #
# reductions                                                            #
# --------------------------------------------------------------------- #

def _group(t: torch.Tensor, axis: str = "world"):
    """The group a collective on `t` over `axis` runs in: for a CPU
    tensor a gloo group (the default group may be NCCL, which takes CUDA
    tensors only), the default backend's otherwise; the whole world's
    for "world" and, when points are not split, for "data"."""
    cpu = t.device.type == "cpu"
    if axis == "world" or (axis == "data" and _points == 1):
        return _cpu_group if cpu else None
    group, cpu_group = _axis_groups[axis]
    return cpu_group if cpu else group


def _all_reduce(t: torch.Tensor, axis: str = "world",
                op=None) -> torch.Tensor:
    counts["all_reduce"] += 1
    if op is None:
        tdist.all_reduce(t, group=_group(t, axis))
    else:
        tdist.all_reduce(t, op=op, group=_group(t, axis))
    return t


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks of an axis; its backward sums
    the cotangents over those ranks too (each rank's output feeds every
    rank's loss)."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _all_reduce(t.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.axis), None


def sum_over_ranks(t: torch.Tensor, axis: str = "world") -> torch.Tensor:
    """The sum of `t` over the ranks of `axis` ("world", "data" or
    "points"), differentiable, as a new tensor; `t` itself when the axis
    has one rank."""
    if axis_size(axis) == 1:
        return t
    return _SumOverRanks.apply(t, axis)


class _MaxOverPoints(torch.autograd.Function):
    """x.amax(dim) over the points axis's ranks' slices of `dim`. The
    backward sums the cotangent over the points axis and routes it to
    the maxima, split evenly between ties on every rank, as torch.amax
    splits it in one process."""

    @staticmethod
    def forward(ctx, x, dim):
        m = _all_reduce(x.amax(dim=dim).contiguous(), "points",
                        tdist.ReduceOp.MAX)
        hit = x == m.unsqueeze(dim)
        ctx.save_for_backward(hit)
        ctx.dim = dim
        return m

    @staticmethod
    def backward(ctx, g):
        (hit,) = ctx.saved_tensors
        ties = hit.sum(dim=ctx.dim, dtype=g.dtype)
        both = _all_reduce(torch.stack([g, ties]).contiguous(), "points")
        return hit.to(g.dtype) * (both[0] / both[1]).unsqueeze(ctx.dim), None


def max_over_points(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The max of x over its point axis `dim`, over every points rank's
    slice of it (x.amax(dim) when points are not split); differentiable."""
    if _points == 1:
        return x.amax(dim=dim)
    return _MaxOverPoints.apply(x, dim)


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


def place_batch(batch: Dict, device="cpu",
                shard_points: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (a dict of (B, ...) arrays or
    tensors), as tensors on `device`: rows [d B / D, (d + 1) B / D) on
    data rank d of D. With `shard_points`, of every 3-D array (clouds
    (B, 3, N)) only points rank p's slice [p N / P, (p + 1) N / P) of
    the last axis (mesh.py's shard_batch). Raises when B does not divide
    by D, or N by P: the statistics' counts assume equal shards
    (mesh.py's place_batch raises as well)."""
    n = int(next(iter(batch.values())).shape[0])
    D, d = data_size(), data_rank()
    if n % D:
        raise ValueError(f"global batch {n} not divisible by the {D} "
                         "ranks of the data axis: adjust the batch size")
    per = n // D
    out = {}
    for k, v in batch.items():
        t = _as_tensor(v[d * per:(d + 1) * per])
        if shard_points and t.ndim == 3:
            P, p = points_size(), points_rank()
            if t.shape[2] % P:
                raise ValueError(f"{k}: {t.shape[2]} points not divisible "
                                 f"by the {P} ranks of the points axis")
            cols = t.shape[2] // P
            t = t[:, :, p * cols:(p + 1) * cols]
        out[k] = t.contiguous().to(device)
    return out


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


def _gather_cpu(t: torch.Tensor, axis: str = "world") -> torch.Tensor:
    """The concatenation over the ranks of `axis` of the CPU tensors `t`,
    which have one shape on every rank."""
    counts["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(axis_size(axis))]
    tdist.all_gather(parts, t.contiguous(), group=_group(t, axis))
    return torch.cat(parts)


def gather_global(x) -> np.ndarray:
    """Every rank's (B, ...) `x` (a tensor on any device, or an array)
    concatenated over the ranks in rank order, as numpy on every rank.
    The shapes must agree across the ranks (place_batch_uneven pads them
    so); a mismatch raises on every rank. On a grid that splits points,
    `x` must be a per-cloud array, the same on every points rank, and is
    gathered over the data axis only; an array whose points are split
    (its copies differ over the points axis) raises on every rank, as
    mesh.py's gather_global refuses a 'points'-sharded array."""
    t = _as_tensor(x).detach().cpu()
    if not active():
        return t.numpy()
    dims = torch.full((8,), -1, dtype=torch.int64)
    dims[:t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    shapes = _gather_cpu(dims).reshape(world_size(), 8)
    if not bool((shapes == shapes[0]).all()):
        raise ValueError("gather_global: the ranks hold different shapes "
                         f"{shapes.tolist()}: pad with place_batch_uneven")
    if _points == 1:
        return _gather_cpu(t).numpy()
    copies = _gather_cpu(t, "points").reshape(_points, *t.shape)
    split = torch.tensor([float(not bool((copies == t).all()))])
    if float(_all_reduce(split, op=tdist.ReduceOp.MAX)):
        raise ValueError(
            "gather_global supports batch-axis sharding only; got an array "
            f"of shape {tuple(t.shape)} whose copies differ over the "
            "'points' axis (its points are split over it). Gather "
            "per-cloud arrays, or reshard (drop the 'points' split) "
            "before gathering.")
    return _gather_cpu(t, "data").numpy()


def gather_batch(batch: Dict) -> Dict[str, np.ndarray]:
    """gather_global over a dict of (B, ...) arrays."""
    return {k: gather_global(v) for k, v in batch.items()}
