"""Sampling step (counterpart of `make_sample_step` in
go_with_the_flows_tpu/train/step.py). The train and eval-loss steps are
not ported yet."""

from __future__ import annotations

from typing import Callable

import torch


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
