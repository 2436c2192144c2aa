"""Latent interpolation and unconditional sampling (counterpart of
go_with_the_flows_tpu/eval/interpolate.py).

The utilities the reference ships commented out, as the JAX package
makes them work: encode two batches to their posterior means,
interpolate the shape codes linearly over `n_steps`, decode every
interpolant with mixture labels, and dump an h5 file in the reference's
intended layout (clouds1, clouds2, interpolations, labels).

Every decode goes through `model.decode_sampling` on the packed decoder,
that is through kernel 1 (`point_decode`) on the card and its plain
version on the CPU. The noise of a decode (each point's component id and
each component's base epsilon) comes from a generator on the model's
device seeded per (batch, step) with `derived_seed`, or from `draw`,
which a caller may hand in to decode from noise of its own (the tests
hand in the JAX package's draws). The encodes and decodes run in the
matmul precision mode current at the call (ops/precision.py), which
evaluate_ae sets from the experiment's config.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..cli import derived_seed
from ..train.step import eval_mode

# draw(generator, logits (B, K), n_points) -> (ids (B, N) in 0..K-1,
# base_eps (K, B, 3, N))
Draw = Callable[[torch.Generator, torch.Tensor, int],
                Tuple[torch.Tensor, torch.Tensor]]
# draw_prior(generator, B, G, device) -> the base prior's epsilon (B, G)
DrawPrior = Callable[[torch.Generator, int, int, torch.device],
                     torch.Tensor]


def draw_prior_noise(generator: torch.Generator, batch: int, width: int,
                     device) -> torch.Tensor:
    return torch.randn(batch, width, generator=generator, device=device)


def draw_noise(generator: torch.Generator, logits: torch.Tensor,
               n_points: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode's noise, as the sample step draws it: each point's
    component from the weights softmax(logits), then each component's
    base epsilon."""
    K, (B, _) = logits.shape[-1], logits.shape
    ids = torch.multinomial(logits.softmax(-1), n_points, replacement=True,
                            generator=generator)
    base_eps = torch.randn(K, B, 3, n_points, generator=generator,
                           device=logits.device)
    return ids, base_eps


def _encode(model, g_clouds, mode="autoencoding"):
    return model.encode(g_clouds, mode)["g_sample"]


def _decode(model, codes, n_points, generator, packed, draw):
    ids, base_eps = draw(generator, model.get_weights(codes), n_points)
    return model.decode_sampling(codes, ids, base_eps, packed)


def encode_codes(model, g_clouds: torch.Tensor,
                 mode: str = "autoencoding") -> torch.Tensor:
    """Posterior-mean shape codes of a batch (B, 3, N) -> (B, G), with
    the BatchNorms' running statistics. A FlowMixtureSVRModel has no
    autoencoding encode and raises, as the JAX package's does."""
    with eval_mode(model), torch.inference_mode():
        return _encode(model, g_clouds, mode)


def decode_codes(model, codes: torch.Tensor, n_points: int,
                 generator: Optional[torch.Generator] = None,
                 draw: Draw = draw_noise
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labeled clouds of shape codes (B, G): (samples (B, 3, N), labels
    (B, N) in 1..K)."""
    with eval_mode(model), torch.inference_mode():
        return _decode(model, codes, n_points, generator,
                       model.pack_decoder(), draw)


def lerp_codes(codes1: torch.Tensor, codes2: torch.Tensor,
               n_steps: int) -> List[torch.Tensor]:
    """(1 - t) c1 + t c2 at t = s / (n_steps - 1), s = 0..n_steps-1: the
    first is c1 and the last c2, bit for bit."""
    return [(1.0 - t) * codes1 + t * codes2
            for t in (s / (n_steps - 1) for s in range(n_steps))]


def interpolate(loader, model, seed: int = 0, n_steps: int = 9,
                n_batches: int = 3, out_path: Optional[str] = None,
                device="cuda", draw: Draw = draw_noise):
    """Latent interpolation between shapes of a loader.

    Each batch's clouds are paired with a partner: the batch's eval
    clouds in the order of np.random.default_rng(0).permutation, one draw
    a batch (the JAX package's pairs). The posterior means of both are
    interpolated over `n_steps`, and every interpolant is decoded with
    labels, its noise from a generator seeded derived_seed(seed, batch,
    step). Returns numpy (clouds1 (S, 3, N), clouds2 (S, 3, N),
    interpolations (S, 3, N, n_steps), labels (S, N, n_steps)) and, with
    `out_path`, writes them into an h5 file (labels as uint8; h5py is
    imported only then)."""
    if n_steps < 2:
        raise ValueError(f"n_steps {n_steps}: at least the two endpoints")
    device = torch.device(device)
    all_c1, all_c2, all_interp, all_labels = [], [], [], []
    host_rng = np.random.default_rng(0)
    with eval_mode(model), torch.inference_mode():
        packed = model.pack_decoder()
        for i, batch in enumerate(loader):
            if i == n_batches:
                break
            clouds = np.asarray(batch["cloud"], np.float32)
            partners = np.asarray(batch["eval_cloud"], np.float32)
            partners = partners[host_rng.permutation(partners.shape[0])]
            n_points = clouds.shape[2]
            codes1 = _encode(model, torch.from_numpy(clouds).to(device))
            codes2 = _encode(model, torch.from_numpy(partners).to(device))
            steps, labels = [], []
            for s, codes in enumerate(lerp_codes(codes1, codes2, n_steps)):
                generator = torch.Generator(device=device).manual_seed(
                    derived_seed(seed, i, s))
                x, lab = _decode(model, codes, n_points, generator, packed,
                                 draw)
                steps.append(x.cpu().numpy())
                labels.append(lab.cpu().numpy())
            all_c1.append(clouds)
            all_c2.append(partners)
            all_interp.append(np.stack(steps, axis=-1))
            all_labels.append(np.stack(labels, axis=-1))

    clouds1 = np.concatenate(all_c1)
    clouds2 = np.concatenate(all_c2)
    interpolations = np.concatenate(all_interp)
    labels = np.concatenate(all_labels)
    if out_path is not None:
        import h5py

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with h5py.File(out_path, "w") as f:
            f.create_dataset("clouds1", data=clouds1)
            f.create_dataset("clouds2", data=clouds2)
            f.create_dataset("interpolations", data=interpolations)
            f.create_dataset("labels", data=labels.astype(np.uint8))
    return clouds1, clouds2, interpolations, labels


def sample_unconditional(model, seed: int, n_clouds: int, n_points: int,
                         batch_size: int = 16, device="cuda",
                         draw: Draw = draw_noise,
                         draw_prior: DrawPrior = draw_prior_noise):
    """Unconditional generation (the reference's commented `sample`
    utility): draw from the learned base prior, push it through the
    prior flow, decode labeled clouds. Batch s (its first cloud's index)
    draws from a generator seeded derived_seed(seed, s): first the base
    prior's epsilon (B, G), then the decode's noise. Returns numpy
    ((n_clouds, 3, N), (n_clouds, N) labels)."""
    device = torch.device(device)
    G = model.g_latent_space_size
    dummy = torch.zeros(batch_size, 3, 8, device=device)
    samples_all, labels_all = [], []
    with eval_mode(model), torch.inference_mode():
        packed = model.pack_decoder()
        for s in range(0, n_clouds, batch_size):
            generator = torch.Generator(device=device).manual_seed(
                derived_seed(seed, s))
            g0_eps = draw_prior(generator, batch_size, G, device)
            codes = model.encode(dummy, "generating", g0_eps)["g_sample"]
            x, lab = _decode(model, codes, n_points, generator, packed,
                             draw)
            samples_all.append(x.cpu().numpy())
            labels_all.append(lab.cpu().numpy())
    return (np.concatenate(samples_all)[:n_clouds],
            np.concatenate(labels_all)[:n_clouds])
