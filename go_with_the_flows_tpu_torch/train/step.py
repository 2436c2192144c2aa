"""Training and sampling steps (counterparts of `make_train_step` and
`make_sample_step` in go_with_the_flows_tpu/train/step.py). The eval-loss
step (`make_eval_step`) is not ported yet."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..losses import flow_mixture_loss


def make_train_step(model, optimizer, pnll_weight: float = 1.0,
                    gnll_weight: float = 1.0, gent_weight: float = 1.0,
                    fused_decoder: Optional[bool] = None) -> Callable:
    """Training step of a FlowMixtureModel.

    step(g_clouds (B, 3, N'), p_clouds (B, 3, N), generator, warmup=False,
    posterior_eps=None) -> {"loss", "pnll", "gnll", "gent"} as 0-d
    tensors. One forward with train-mode BatchNorm, the loss, the
    backward and one optimizer step; the model's parameters, its
    BatchNorm running statistics and the optimizer change in place. The
    posterior noise (B, G) is drawn from `generator` on the model's
    device, unless `posterior_eps` hands it in.

    fused_decoder: the point decoder's train-mode inverse and its
    backward through the `train_decode` kernels (True) or through the
    decoder's modules under autograd (False); None takes the kernels on
    a CUDA tensor and the modules on a CPU tensor. True on a CPU tensor
    raises: the kernels run only on the card.
    """
    G = model.g_latent_space_size

    def train_step(g_clouds: torch.Tensor, p_clouds: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   warmup: bool = False,
                   posterior_eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        on_card = p_clouds.device.type == "cuda"
        fused = on_card if fused_decoder is None else bool(fused_decoder)
        if fused and not on_card:
            raise ValueError("fused_decoder=True needs CUDA tensors: the "
                             "train_decode kernels run only on the card")
        if posterior_eps is None:
            posterior_eps = torch.randn(g_clouds.shape[0], G,
                                        generator=generator,
                                        device=g_clouds.device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model.encode(g_clouds, "training",
                           posterior_eps=posterior_eps)
        out.update(model.decode_training(p_clouds, out["g_sample"], warmup,
                                         fused))
        loss, metrics = flow_mixture_loss(out, pnll_weight, gnll_weight,
                                          gent_weight)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_sample_step(model, n_sampled_points: int,
                     mode: str = "generating") -> Callable:
    """Labeled sampling step for evaluation.

    step(g_clouds (B, 3, N'), generator) -> (samples (B, 3, N),
    labels (B, N) in 1..K, logits (B, K)), with N = n_sampled_points.
    Every random draw comes from `generator`, which must live on the
    model's device. The decoder is constant-folded once, here: build the
    step after the weights are final. Runs under torch.inference_mode()
    with BatchNorm running statistics.
    """
    if mode not in ("generating", "autoencoding"):
        raise NotImplementedError(f"sample mode {mode!r} is not ported yet")
    model.eval()
    packed = model.pack_decoder()
    K, G = model.n_components, model.g_latent_space_size
    N = n_sampled_points

    def sample_step(g_clouds: torch.Tensor, generator: torch.Generator):
        with torch.inference_mode():
            B = g_clouds.shape[0]
            device = g_clouds.device
            g0_eps = None
            if mode == "generating":
                g0_eps = torch.randn(B, G, generator=generator, device=device)
            g = model.encode(g_clouds, mode, g0_eps)["g_sample"]
            logits = model.get_weights(g)
            ids = torch.multinomial(logits.softmax(-1), N, replacement=True,
                                    generator=generator)
            base_eps = torch.randn(K, B, 3, N, generator=generator,
                                   device=device)
            samples, labels = model.decode_sampling(g, ids, base_eps, packed)
            return samples, labels, logits

    return sample_step
