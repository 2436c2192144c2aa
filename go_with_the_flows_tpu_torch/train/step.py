"""Training, eval-loss and sampling steps (counterparts of
`make_train_step`, `make_eval_step` and `make_sample_step` in
go_with_the_flows_tpu/train/step.py).

The JAX steps are pure functions of a state; the port's close over a
model (and an optimizer) that change in place. So the eval and sample
steps read the model as it is at each call, as the JAX steps read the
state they are handed: each call enters eval mode and gives every module
its own mode back on exit, and the packed decoder the `point_decode`
kernel reads is rebuilt whenever the decoder's weights or running
statistics have changed (`FlowMixtureModel.pack_decoder`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

import torch

from ..losses import flow_mixture_loss
from ..parallel import dist


@contextlib.contextmanager
def eval_mode(model, modules=None) -> Iterator[None]:
    """Eval mode for the body; on exit, also when the body raises, every
    module takes back the mode it had. `modules`: list(model.modules()),
    when the caller keeps it, so that a call does not walk the model."""
    if modules is None:
        modules = list(model.modules())
    modes = [m.training for m in modules]
    for m in modules:
        m.training = False
    try:
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.training = mode


def _posterior_eps(model, g_clouds, generator, posterior_eps):
    if posterior_eps is not None:
        return posterior_eps
    return torch.randn(g_clouds.shape[0], model.g_latent_space_size,
                       generator=generator, device=g_clouds.device)


def _global_posterior_eps(model, g_clouds, generator, posterior_eps):
    """The train step's posterior noise: drawn for the global batch of
    world_size() equal shards from `generator` (the same on every rank),
    this rank's rows kept, so that a run's noise does not depend on how
    many ranks share its batch."""
    world = dist.world_size()
    if posterior_eps is not None or world == 1:
        return _posterior_eps(model, g_clouds, generator, posterior_eps)
    B = g_clouds.shape[0]
    eps = torch.randn(world * B, model.g_latent_space_size,
                      generator=generator, device=g_clouds.device)
    return eps[dist.rank() * B:(dist.rank() + 1) * B]


def _encode_training(model, g_clouds, svr, images, posterior_eps):
    """The training-mode encode, the image prior's when `svr`."""
    if svr:
        return model.encode(g_clouds, "training", images=images,
                            posterior_eps=posterior_eps)
    return model.encode(g_clouds, "training", posterior_eps=posterior_eps)


def make_train_step(model, optimizer, pnll_weight: float = 1.0,
                    gnll_weight: float = 1.0, gent_weight: float = 1.0,
                    svr: bool = False,
                    fused_decoder: Optional[bool] = None) -> Callable:
    """Training step of a FlowMixtureModel (or, with `svr`, of a
    FlowMixtureSVRModel).

    step(g_clouds (B, 3, N'), p_clouds (B, 3, N), generator, warmup=False,
    posterior_eps=None, images=None) -> {"loss", "pnll", "gnll", "gent"}
    as 0-d tensors; with `svr` the images (B, 4, H, W) give the latent
    prior's base. One forward with train-mode BatchNorm, the loss, the
    backward and one optimizer step; the model's parameters, its
    BatchNorm running statistics and the optimizer change in place. The
    posterior noise (B, G) is drawn from `generator` on the model's
    device, unless `posterior_eps` hands it in.

    fused_decoder: the point decoder's train-mode inverse and its
    backward through the `train_decode` kernels (True) or through the
    decoder's modules under autograd (False); None takes the kernels on
    a CUDA tensor and the modules on a CPU tensor. True on a CPU tensor
    raises: the kernels run only on the card.

    Data-parallel (inside a process group of several ranks,
    parallel/dist.py): the clouds are this rank's shard of the global
    batch, every rank calls the step with the same generator state, and
    the step is the global batch's: BatchNorm statistics over it (the
    kernels in their SPMD form), its posterior noise this rank's rows of
    a draw for the whole batch (a handed-in `posterior_eps` is this
    rank's rows), the gradient of its mean loss, the same optimizer step
    on every rank, and the metrics its means.
    """

    def train_step(g_clouds: torch.Tensor, p_clouds: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   warmup: bool = False,
                   posterior_eps: Optional[torch.Tensor] = None,
                   images: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        on_card = p_clouds.device.type == "cuda"
        fused = on_card if fused_decoder is None else bool(fused_decoder)
        if fused and not on_card:
            raise ValueError("fused_decoder=True needs CUDA tensors: the "
                             "train_decode kernels run only on the card")
        posterior_eps = _global_posterior_eps(model, g_clouds, generator,
                                              posterior_eps)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = _encode_training(model, g_clouds, svr, images, posterior_eps)
        out.update(model.decode_training(p_clouds, out["g_sample"], warmup,
                                         fused))
        loss, metrics = flow_mixture_loss(out, pnll_weight, gnll_weight,
                                          gent_weight)
        loss.backward()
        optimizer.step()
        if dist.active():
            values = dist.all_reduce_mean(
                torch.stack([metrics[k].detach() for k in metrics]))
            return dict(zip(metrics, values.unbind()))
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model, pnll_weight: float = 1.0, gnll_weight: float = 1.0,
                   gent_weight: float = 1.0, svr: bool = False,
                   fused_decoder: bool = True) -> Callable:
    """Validation loss step: the training forward path with BatchNorm
    running statistics (mode "training", train=False in the JAX package),
    the reference's eval() semantics.

    step(g_clouds (B, 3, N'), p_clouds (B, 3, N), generator, warmup=False,
    posterior_eps=None, images=None) -> {"loss", "pnll", "gnll", "gent"}
    as 0-d tensors (`svr`: the images as the train step takes them).
    Runs under torch.inference_mode() in eval mode and gives the
    model its modes back; changes no parameter and no buffer. The
    posterior noise is drawn as the train step draws it.

    fused_decoder=True sends the point decoder's inverse through
    `point_decode(..., inverse=True)` on the packed decoder (the kernel
    on a CUDA tensor, its plain version on a CPU tensor), as the JAX
    package sends it through its eval decode kernel; False runs the
    decoder's modules, the plain path the kernel is held against.
    """

    modules = list(model.modules())

    def eval_step(g_clouds: torch.Tensor, p_clouds: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  warmup: bool = False,
                  posterior_eps: Optional[torch.Tensor] = None,
                  images: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        with eval_mode(model, modules), torch.inference_mode():
            posterior_eps = _posterior_eps(model, g_clouds, generator,
                                           posterior_eps)
            out = _encode_training(model, g_clouds, svr, images,
                                   posterior_eps)
            if fused_decoder:
                out.update(model.decode_eval(p_clouds, out["g_sample"],
                                             warmup))
            else:
                out.update(model.decode_training(p_clouds, out["g_sample"],
                                                 warmup))
            _, metrics = flow_mixture_loss(out, pnll_weight, gnll_weight,
                                           gent_weight)
        return metrics

    return eval_step


def make_sample_step(model, n_sampled_points: int,
                     mode: str = "generating", svr: bool = False) -> Callable:
    """Labeled sampling step for evaluation and reconstruction.

    step(g_clouds (B, 3, N'), generator, images=None) -> (samples
    (B, 3, N), labels (B, N) in 1..K, logits (B, K)), with
    N = n_sampled_points. Modes: generating and autoencoding, or with
    `svr` reconstruction, whose latent is the image prior's mean for the
    images (B, 4, H, W) (g_clouds gives the batch size and the device).
    Every random draw comes from `generator`, which must live on the
    model's device. Each call runs under torch.inference_mode() in eval
    mode (BatchNorm running statistics, none of them written) on the
    model's weights of that moment, and gives the model its modes back.

    Data-parallel (inside a process group of several ranks, every rank
    calling with the same generator state), the noise is drawn for the
    global batch of world_size() equal shards and each rank keeps its
    rows, so that the ranks' clouds do not share their noise; the
    component ids then come from uniforms by the inverse of each cloud's
    weights' CDF, where one process calls torch.multinomial.
    """
    modes = ("reconstruction",) if svr else ("generating", "autoencoding")
    if mode not in modes:
        raise ValueError(f"sample mode {mode!r} with svr={svr}: expected "
                         f"one of {modes}")
    K, G = model.n_components, model.g_latent_space_size
    N = n_sampled_points
    modules = list(model.modules())

    def sample_step(g_clouds: torch.Tensor, generator: torch.Generator,
                    images: Optional[torch.Tensor] = None):
        with eval_mode(model, modules), torch.inference_mode():
            packed = model.pack_decoder()
            B = g_clouds.shape[0]
            device = g_clouds.device
            world, rank = dist.world_size(), dist.rank()

            def draw(fn, *shape, dim=0):  # this rank's rows of a global draw
                shape = list(shape)
                shape[dim] *= world
                return fn(*shape, generator=generator,
                          device=device).narrow(dim, rank * B, B)

            if svr:
                g = model.encode(g_clouds, mode, images=images)["g_sample"]
            else:
                g0_eps = None
                if mode == "generating":
                    g0_eps = draw(torch.randn, B, G)
                g = model.encode(g_clouds, mode, g0_eps)["g_sample"]
            logits = model.get_weights(g)
            probs = logits.softmax(-1)
            if world == 1:
                ids = torch.multinomial(probs, N, replacement=True,
                                        generator=generator)
            else:
                ids = torch.searchsorted(
                    probs.cumsum(-1), draw(torch.rand, B, N),
                    right=True).clamp_(max=K - 1)
            base_eps = draw(torch.randn, K, B, 3, N, dim=1)
            samples, labels = model.decode_sampling(g, ids, base_eps, packed)
            return samples, labels, logits

    return sample_step
