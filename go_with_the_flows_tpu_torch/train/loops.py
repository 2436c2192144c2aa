"""Training, validation and reconstruction loops (counterpart of
go_with_the_flows_tpu/train/loops.py).

  * train(): one epoch of train steps; stdout meter lines every
    `num_workers` steps; a NaN or infinite loss raises NaNLossError;
    checkpoints every `logging_img_steps` steps and at the epoch's end.
  * evaluate_val(): the validation loss with BatchNorm running
    statistics and the best-model checkpoint.
  * reconstruct() / predict(): labeled reconstructions over a loader,
    and their .npy dump.

Loaders yield dicts of numpy arrays (`data/loader.py`): `cloud` (B, 3, N')
for the encoder, `eval_cloud` (B, 3, N) for the decoder's likelihood,
and for single-view reconstruction (`svr=True`) `image` (B, 4, H, W),
which the loops hand to the steps. The loops move them to `device`,
which defaults to the card.

train() reads each step's metrics one step behind: the host queues step
i, then waits for step i - 1's metrics alone (a copy to pinned memory and
an event recorded behind that step), never for the step it just queued;
the batches go to the card through pinned memory, asynchronously.

`writer`: a TensorBoard SummaryWriter (or anything with `add_scalar`
and `add_image`) that takes the epoch's train and val means, or with
`per_step_tb` the running train means at every global step, as the JAX
loops write them; with the config's `logging_img`, also the
reconstruction figures (viz/tb.py): train() draws SVR figures from
`svr_recon_fn` on the checkpoint cadence, evaluate_val() autoencoding
figures from `reconstruct_fn` every `logging_img_frequency` epochs.

Data-parallel (inside a process group of several ranks,
parallel/dist.py), every rank runs every loop over its loader's shard:
the train step's metrics are already the global batch's means;
evaluate_val reduces its sums and counts over the ranks, so every rank
gets the same means and takes the same best-model decision; reconstruct
gathers every rank's rows, so every rank returns the same arrays. The
config's `logging` (stdout, TensorBoard) is for rank 0 alone, and
`checkpointing` must be the same on every rank: saving is a collective.
So is a figure's reconstruction: every rank runs it, rank 0 draws.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel import dist
from ..utils import profiling
from ..utils.meters import AverageMeter
from ..viz.tb import add_figures_reconstruction_tb, add_svr_reconstruction_tb
from .checkpoints import save_checkpoint
from .state import TrainState

_KEYS = ("loss", "pnll", "gnll", "gent")


class NaNLossError(RuntimeError):
    """Raised when the loss is NaN or infinite (the reference exits the
    process instead)."""


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's clouds and images on `device`. To the card they go
    through pinned memory with an asynchronous copy: from pageable memory
    the copy would wait for the stream, that is for the step just
    queued."""
    out = {}
    for k in ("cloud", "eval_cloud", "image"):
        if k in batch:
            x = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
            if device.type == "cuda":
                x = x.pin_memory()
            out[k] = x.to(device, non_blocking=True)
    return out


def _start_fetch(metrics):
    """Begin moving a step's metrics to the host without waiting for the
    card: (values, event), the event None when they are already there."""
    values = torch.stack([metrics[k] for k in _KEYS])
    if values.device.type != "cuda":
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_fetch(fetch) -> Dict[str, float]:
    values, event = fetch
    if event is not None:
        event.synchronize()
    return dict(zip(_KEYS, values.tolist()))


def _fetch(metrics) -> Dict[str, float]:
    return _finish_fetch(_start_fetch(metrics))


def _images(dev, svr: bool) -> Dict[str, torch.Tensor]:
    """The step's `images` keyword argument: the batch's images with
    `svr`, nothing without."""
    return {"images": dev["image"]} if svr else {}


def _add_scalars(writer, prefix: str, means: Dict[str, float],
                 step: int) -> None:
    for key, tag in (("loss", "loss"), ("pnll", "PNLL"), ("gnll", "GNLL"),
                     ("gent", "GENT")):
        writer.add_scalar(f"{prefix}/{tag}", means[key], step)


def train(loader, train_step: Callable, state: TrainState, epoch: int,
          start_iter: int, warmup: bool, device="cuda", svr: bool = False,
          writer=None, per_step_tb: bool = False,
          svr_recon_fn: Optional[Callable] = None, **config) -> TrainState:
    """One training epoch; returns the state, whose model, optimizer,
    generator and step count have moved on, with the epoch's mean
    metrics in state.train_metrics.

    `train_step(g, p, generator, warmup=...)` is train/step.make_train_step's
    step over state.model and state.optimizer (with `svr`, an SVR step,
    called with images=the batch's images); its noise comes from
    state.generator. Config keys, as the JAX loop reads them: logging,
    checkpointing (defaults to logging), logging_path, model_name,
    num_workers (the stdout cadence), logging_img_steps (the checkpoint
    cadence, 100 * num_workers by default), profile_dir and
    profile_steps (a torch.profiler trace of steps 1..profile_steps into
    profile_dir; step 0 builds the kernels), logging_img (with
    `svr_recon_fn`, figures).

    `svr_recon_fn(state) -> (samples, gts, labels, images)`: with the
    config's `logging_img`, called on the checkpoint cadence by every
    rank (it gathers), its output written by the logging rank as SVR
    figures at the global step epoch * len(loader) + it + 1, as the JAX
    loop does.
    """
    device = torch.device(device)
    num_workers = max(int(config.get("num_workers", 1)), 1)
    logging = config.get("logging", False)
    ckpting = config.get("checkpointing", logging)
    logging_path = config.get("logging_path", ".")
    model_name = config.get("model_name", "model.ckpt")
    ckpt_steps = int(config.get("logging_img_steps", 100 * num_workers))
    profile_dir = config.get("profile_dir") or None
    profile_steps = max(int(config.get("profile_steps", 3)), 1)

    batch_time = AverageMeter()
    data_time = AverageMeter()
    meters = {k: AverageMeter() for k in _KEYS}

    def consume(fetch, bsz, it):
        m = _finish_fetch(fetch)
        if not np.isfinite(m["loss"]):
            raise NaNLossError(
                f"Loss is {m['loss']} at epoch {epoch} iter {it}")
        for k in meters:
            meters[k].update(m[k], bsz)
        if per_step_tb and writer is not None and logging:
            _add_scalars(writer, "train",
                         {k: v.avg for k, v in meters.items()},
                         epoch * n_batches + it + 1)

    loader.set_epoch(epoch)
    n_batches = len(loader)
    pending = None  # (fetch, bsz, it) of the step in flight
    end = time.time()
    trace_scope = contextlib.ExitStack()
    try:
        for i, batch in enumerate(loader):
            it = start_iter + i
            if it >= n_batches:
                break
            data_time.update(time.time() - end)

            if profile_dir and i == 1:
                trace_scope.enter_context(profiling.trace(profile_dir))
            dev = _to_device(batch, device)
            g, p = dev["cloud"], dev["eval_cloud"]
            with (profiling.annotate(f"train_step_{it}") if profile_dir
                  else contextlib.nullcontext()):
                metrics = train_step(g, p, state.generator, warmup=warmup,
                                     **_images(dev, svr))
            state.step += 1
            fetch = _start_fetch(metrics)
            if profile_dir and i == profile_steps:
                trace_scope.close()
                profile_dir = None

            if pending is not None:
                consume(*pending)  # waits for the previous step only
            pending = (fetch, g.shape[0], it)
            batch_time.update(time.time() - end)
            end = time.time()

            if (it + 1) % num_workers == 0 and logging:
                line = (
                    f"Epoch: [{epoch + 1}][{it + 1}/{n_batches}]"
                    f"\tTime {batch_time.val:.3f} ({batch_time.avg:.3f})"
                    f"\tData {data_time.val:.3f} ({data_time.avg:.3f})"
                    f"\tLB {meters['loss'].val:.2f}"
                    f" ({meters['loss'].avg:.2f})"
                    f"\tPNLL {meters['pnll'].val:.2f}"
                    f" ({meters['pnll'].avg:.2f})"
                    f"\tGNLL {meters['gnll'].val:.2f}"
                    f" ({meters['gnll'].avg:.2f})"
                    f"\tGENT {meters['gent'].val:.2f}"
                    f" ({meters['gent'].avg:.2f})\n"
                )
                sys.stdout.write(line)
                sys.stdout.flush()

            if (it + 1) % ckpt_steps == 0:
                if ckpting:
                    save_checkpoint(logging_path, model_name, state, epoch,
                                    it + 1)
                if svr_recon_fn is not None and config.get("logging_img"):
                    samples, gts, labels, images = svr_recon_fn(state)
                    if writer is not None and logging:
                        add_svr_reconstruction_tb(
                            images, gts, samples, labels, writer,
                            epoch * n_batches + it + 1)
    finally:
        trace_scope.close()  # epochs shorter than profile_steps

    if pending is not None:
        consume(*pending)
    if ckpting:
        save_checkpoint(logging_path, model_name, state, epoch + 1, 0)
    state.train_metrics = {k: m.avg for k, m in meters.items()}
    if logging and writer is not None and not per_step_tb:
        _add_scalars(writer, "train", state.train_metrics, epoch)
    return state


def evaluate_val(loader, eval_step: Callable, state: TrainState, epoch: int,
                 warmup: bool, min_loss: float, generator: torch.Generator,
                 device="cuda", svr: bool = False, writer=None,
                 reconstruct_fn: Optional[Callable] = None,
                 **config) -> float:
    """Validation epoch: the training-path loss with BatchNorm running
    statistics, and the best-model checkpoint ("best_model_" +
    model_name) when the mean loss beats `min_loss`. Returns the updated
    min_loss; the means go to state.val_metrics.

    `eval_step` is train/step.make_eval_step's step over state.model
    (with `svr`, called with the batch's images); its noise comes from
    `generator`, not from the state's training
    generator, so validating does not move the training draws. A short
    last batch is taken as it is and weighs its own size in the means,
    as in the JAX package's single-process run. Data-parallel, the means
    are over every rank's batches. Config keys: logging, checkpointing,
    logging_path, model_name, logging_img and logging_img_frequency.

    `reconstruct_fn(state, max_batches=1) -> (samples, gts, labels)`:
    with `logging_img`, when this rank logs or ranks are active, and on
    every `logging_img_frequency`-th epoch, called (by every rank: it
    gathers) and its output written by the logging rank as
    reconstruction figures at step `epoch`, as the JAX loop does.
    """
    device = torch.device(device)
    logging = config.get("logging", False)
    ckpting = config.get("checkpointing", logging)
    logging_path = config.get("logging_path", ".")
    model_name = config.get("model_name", "model.ckpt")
    meters = {k: AverageMeter() for k in _KEYS}

    parallel = dist.active()
    for batch in loader:
        dev = _to_device(batch, device)
        g, p = dev["cloud"], dev["eval_cloud"]
        m = _fetch(eval_step(g, p, generator, warmup=warmup,
                             **_images(dev, svr)))
        # data-parallel: checked on the global means below, so that every
        # rank raises together
        if not parallel and not np.isfinite(m["loss"]):
            raise NaNLossError(f"Eval loss is {m['loss']} at epoch {epoch}")
        for k in meters:
            meters[k].update(m[k], g.shape[0])

    means = {k: m.avg for k, m in meters.items()}
    if parallel:
        # every rank's batches, each weighed by its size
        totals = dist.all_reduce_mean(torch.tensor(
            [meters[k].sum for k in _KEYS] + [meters["loss"].count],
            dtype=torch.float64))
        means = {k: float(totals[i] / totals[-1])
                 for i, k in enumerate(_KEYS)}
        if not np.isfinite(means["loss"]):
            raise NaNLossError(f"Eval loss is {means['loss']} at epoch "
                               f"{epoch}")
    if logging:
        print(f"[epoch {epoch}]: eval loss {means['loss']:f}")
    state.val_metrics = means
    if logging and writer is not None:
        _add_scalars(writer, "val", state.val_metrics, epoch)
    if (reconstruct_fn is not None and config.get("logging_img")
            and (logging or parallel)
            and epoch % max(int(config.get("logging_img_frequency", 1)),
                            1) == 0):
        samples, gts, labels = reconstruct_fn(state, max_batches=1)
        if logging and writer is not None:
            add_figures_reconstruction_tb(gts, samples, labels, writer,
                                          epoch)
    if means["loss"] < min_loss:
        min_loss = means["loss"]
        if ckpting:
            save_checkpoint(logging_path, "best_model_" + model_name, state,
                            epoch + 1, 0)
    return min_loss


def reconstruct(loader, sample_step: Callable, generator: torch.Generator,
                device="cuda", max_batches: Optional[int] = None,
                svr: bool = False, return_images: bool = False):
    """Labeled reconstructions of a loader's clouds (`sample_step` from
    make_sample_step, usually in autoencoding mode; with `svr`, in
    reconstruction mode, from the batch's images), batched. Returns
    numpy (samples (S, 3, N), ground truths (S, 3, N'), labels (S, N)),
    and with `svr` and `return_images` the conditioning images
    (S, 4, H, W) after them (the SVR figures' input).
    Data-parallel, every rank's rows are gathered, batch by batch in rank
    order, a rank's shorter last batch padded for the gather and trimmed
    after it: every rank returns the same arrays."""
    device = torch.device(device)
    images = return_images and svr
    all_samples, all_gts, all_labels, all_images = [], [], [], []
    for b, batch in enumerate(loader):
        if max_batches is not None and b >= max_batches:
            break
        host, trim = dist.place_batch_uneven(
            {k: batch[k] for k in ("cloud", "image") if k in batch})
        dev = _to_device(host, device)
        samples, labels, _ = sample_step(dev["cloud"], generator,
                                         **_images(dev, svr))
        all_samples.append(trim(dist.gather_global(samples)))
        all_gts.append(trim(dist.gather_global(host["cloud"])))
        all_labels.append(trim(dist.gather_global(labels)))
        if images:
            all_images.append(trim(dist.gather_global(host["image"])))
    out = (np.concatenate(all_samples), np.concatenate(all_gts),
           np.concatenate(all_labels))
    return out + (np.concatenate(all_images),) if images else out


def predict(loader, sample_step: Callable, generator: torch.Generator,
            out_dir: str, device="cuda", svr: bool = False):
    """Reconstruct the whole loader and write all_samples.npy,
    all_gts.npy and all_labels.npy into out_dir (data-parallel: rank 0
    writes the gathered arrays)."""
    samples, gts, labels = reconstruct(loader, sample_step, generator,
                                       device, svr=svr)

    def write():
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "all_samples.npy"), samples)
        np.save(os.path.join(out_dir, "all_gts.npy"), gts)
        np.save(os.path.join(out_dir, "all_labels.npy"), labels)

    dist.on_rank0(write)
    return samples, gts, labels
