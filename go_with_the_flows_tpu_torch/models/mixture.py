"""Mixture-of-flows point-cloud VAE (counterpart of
go_with_the_flows_tpu/models/mixture.py): the training forward and the
eval paths, and the single-view reconstruction model
(FlowMixtureSVRModel).

The K point decoders are one PointDecoderFlow with K-stacked weights
(`stack=(K,)`), not a loop over K modules. Sampling draws per-point
component ids, decodes every point through all K components with the
`point_decode` kernel, and keeps each point's own component, as the JAX
package does.

The model's methods are deterministic: the noise (g0's epsilon, the
posterior's epsilon, the base epsilon (K, B, 3, N), the component ids)
is an argument, drawn by the caller (`train/step.py`) from an explicit
torch.Generator. The same noise therefore gives the same clouds and the
same losses as the JAX package.

Training mode is the module's `self.training` (BatchNorm batch
statistics); `decode_training` runs the point decoder's inverse either
through the modules (autograd, the plain path) or through the
`train_decode` kernels (ops/kernels/train_decode.py). In eval mode
`decode_eval` runs that inverse through the `point_decode` kernel on the
packed decoder (`pack_decoder`, cached until a decoder tensor changes),
the validation loss's path.
"""

from __future__ import annotations

import math
import operator
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.kernels.point_decode import (
    film_alpha_beta,
    pack_point_decoder,
    point_decode,
)
from ..ops.kernels.train_decode import (
    decoder_stats_update,
    film_ab_train,
    fused_train_decode,
    pack_point_decoder_train,
)
from ..ops.layers import reset_parameters
from ..parallel import dist
from .encoders import FeatureEncoder, PointNetCloudEncoder, WeightsEncoder
from .flows import LatentPriorFlow, PointDecoderFlow, point_decoder_param_count
from .resnet import ResNet18


def reduce_decoder_params(
    n_components: int,
    params_reduce_mode: str,
    p_decoder_n_flows: int,
    p_decoder_n_features: int,
    g_latent_space_size: int,
) -> Tuple[int, int]:
    """Per-component decoder (depth, width) so that K small decoders fit
    the parameter budget of one full-size decoder (the reference's
    `_get_decoder_params` arithmetic)."""
    n = n_components
    count = point_decoder_param_count
    big = count(p_decoder_n_flows, p_decoder_n_features, g_latent_space_size)

    def shrink_features(depth):
        f = p_decoder_n_features
        total = big * n
        while total > big and f > 4:
            f -= 1
            total = count(depth, f, g_latent_space_size) * n
        return f, (total > big, big, total)

    if n == 1 or params_reduce_mode == "none":
        return p_decoder_n_flows, p_decoder_n_features
    if params_reduce_mode == "depth_and_feature":
        depth = math.ceil(p_decoder_n_flows / math.sqrt(n))
        feats, _ = shrink_features(depth)
    elif params_reduce_mode == "depth_first":
        depth = math.ceil(p_decoder_n_flows / n)
        feats, _ = shrink_features(depth)
    elif params_reduce_mode == "feature_first":
        depth = p_decoder_n_flows
        feats, (over, big_, total) = shrink_features(depth)
        if over:
            while total > big_:
                depth -= 1
                total = count(depth, feats, g_latent_space_size) * n
    else:
        raise ValueError(f"Unknown params_reduce_mode: {params_reduce_mode}")
    return depth, feats


class FlowMixtureModel(nn.Module):
    """Mixture of K conditional RealNVP point decoders under a flow-prior
    VAE. Constructor arguments are the reference YAML's model keys.

    Parameters are drawn from `generator` (a CPU torch.Generator, so one
    seed gives the same weights on every device; None means seed 0);
    move the model with `.to(device)`, and call `.eval()` before sampling
    or `.train()` before a training forward.
    """

    def __init__(
        self,
        n_components: int,
        params_reduce_mode: str = "depth_and_feature",
        weights_type: str = "learned_weights",
        g_latent_space_size: int = 128,
        g_prior_n_flows: int = 7,
        g_prior_n_features: int = 128,
        g_posterior_n_layers: int = 1,
        p_latent_space_size: int = 3,
        p_prior_n_layers: int = 1,
        p_decoder_n_flows: int = 21,
        p_decoder_n_features: int = 64,
        p_decoder_base_type: str = "free",
        p_decoder_base_var: float = -3.9551,
        pc_enc_init_n_channels: int = 3,
        pc_enc_init_n_features: int = 64,
        pc_enc_n_features: Sequence[int] = (128, 256, 512),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if weights_type not in ("global_weights", "learned_weights"):
            raise ValueError(f"Unknown weights_type: {weights_type}")
        if p_decoder_base_type not in ("free", "freevar", "fixed"):
            raise ValueError(
                f"Unknown p_decoder_base_type: {p_decoder_base_type}")
        K, G = n_components, g_latent_space_size
        self.n_components = K
        self.weights_type = weights_type
        self.g_latent_space_size = G
        self.p_latent_space_size = p_latent_space_size
        self.p_decoder_base_type = p_decoder_base_type
        self.p_decoder_base_var = p_decoder_base_var

        self.pc_encoder = PointNetCloudEncoder(
            pc_enc_init_n_channels, pc_enc_init_n_features,
            tuple(pc_enc_n_features))
        self.g0_prior_mus = nn.Parameter(torch.empty(1, G))
        self.g0_prior_logvars = nn.Parameter(torch.empty(1, G))
        self.g_prior = LatentPriorFlow(g_prior_n_flows, g_prior_n_features, G)
        self.g_posterior = FeatureEncoder(
            pc_enc_n_features[-1], g_posterior_n_layers, G,
            mu_weight_std=0.0033, logvar_weight_std=0.033)
        if p_decoder_base_type in ("free", "freevar"):
            free = p_decoder_base_type == "free"
            # the reference calls the shared p_prior once per component,
            # K same-batch BatchNorm updates per step: one update with
            # momentum 0.9^K is the same
            self.p_prior = FeatureEncoder(
                G, p_prior_n_layers, p_latent_space_size,
                deterministic=not free,
                mu_weight_std=0.001 if free else 0.01,
                bn_momentum=0.9 ** K)
        depth, feats = reduce_decoder_params(
            K, params_reduce_mode, p_decoder_n_flows, p_decoder_n_features, G)
        self.pc_decoder = PointDecoderFlow(depth, feats, G, stack=(K,))
        self.mixture_weights_logits = nn.Parameter(torch.empty(K))
        self.mixture_weights_encoder = WeightsEncoder(G, 3, K)
        # pack_decoder's cache: the packed decoder, the decoder's tensors
        # it was packed from and their version counters then
        self._packed = None
        self._packed_from = ()
        self._packed_versions = None
        self._decoder_dicts = None
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)
        G = self.g_latent_space_size
        self.g0_prior_mus.copy_(
            torch.randn(1, G, generator=generator) * 0.033)
        self.g0_prior_logvars.copy_(
            torch.randn(1, G, generator=generator) * 0.33)
        self.mixture_weights_logits.zero_()

    # ------------------------------------------------------------------ #
    # encode                                                             #
    # ------------------------------------------------------------------ #

    def posterior(self, g_input: torch.Tensor):
        """PointNet -> max-pool over points -> posterior (mus, logvars)."""
        feats = self.pc_encoder(g_input)
        return self.g_posterior(feats.amax(dim=2))

    def encode(self, g_input: torch.Tensor, mode: str,
               g0_eps: Optional[torch.Tensor] = None,
               posterior_eps: Optional[torch.Tensor] = None) -> Dict:
        """Prior-flow encoding of a batch.

        training: g = mu + exp(lv / 2) * posterior_eps from the posterior
        (posterior_eps (B, G) is required); autoencoding: g = posterior
        mean; both inverted through the prior flow. generating:
        g0 = mu0 + exp(lv0 / 2) * g0_eps, pushed forward through the
        prior flow (g0_eps (B, G) is required).
        """
        B, G = g_input.shape[0], self.g_latent_space_size
        mu0 = self.g0_prior_mus.expand(B, G)
        lv0 = self.g0_prior_logvars.expand(B, G)
        out = {"g_prior_mus0": mu0, "g_prior_logvars0": lv0}
        if mode in ("training", "autoencoding"):
            g0, g_s, flow_lv_sum = self._encode_posterior(
                g_input, mode, posterior_eps, out)
        elif mode == "generating":
            if g0_eps is None:
                raise ValueError("generating mode needs g0_eps (B, G)")
            g0 = mu0 + torch.exp(0.5 * lv0) * g0_eps
            g_s, flow_lv_sum = self.g_prior(g0, "direct")
        else:
            raise ValueError(f"encode: unsupported mode {mode!r}")
        out.update(g0_sample=g0, g_sample=g_s,
                   g_prior_logvar_sum=lv0 + flow_lv_sum)
        return out

    def _encode_posterior(self, g_input, mode, posterior_eps, out):
        """The posterior's sample (training) or mean (autoencoding),
        inverted through the prior flow: (g0, g, the flow's logvar sum);
        the posterior's mus and logvars go into `out`."""
        post_mus, post_logvars = self.posterior(g_input)
        out["g_posterior_mus"] = post_mus
        out["g_posterior_logvars"] = post_logvars
        if mode == "training":
            if posterior_eps is None:
                raise ValueError("training mode needs posterior_eps (B, G)")
            g_s = post_mus + torch.exp(0.5 * post_logvars) * posterior_eps
        else:
            g_s = post_mus
        g0, flow_lv_sum = self.g_prior(g_s, "inverse")
        return g0, g_s, flow_lv_sum

    # ------------------------------------------------------------------ #
    # decode                                                             #
    # ------------------------------------------------------------------ #

    def point_base(self, g_sample: torch.Tensor):
        """Base distribution of the point flow, shared by the components:
        (mus, logvars), each (B, 3, 1)."""
        B, C = g_sample.shape[0], self.p_latent_space_size
        if self.p_decoder_base_type == "free":
            mus, logvars = self.p_prior(g_sample)
            return mus[:, :, None], logvars[:, :, None]
        if self.p_decoder_base_type == "freevar":
            logvars = self.p_prior(g_sample)
            return g_sample.new_zeros(B, C, 1), logvars[:, :, None]
        return (g_sample.new_zeros(B, C, 1),
                g_sample.new_full((B, C, 1), self.p_decoder_base_var))

    def get_weights(self, g_sample: torch.Tensor,
                    warmup: bool = False) -> torch.Tensor:
        """Mixture log-weights (B, K): the global logits during warmup or
        with global_weights, else the weights encoder. The unused one is
        not called, so its parameters get no gradient (the JAX package
        gives them zeros and its optimizer skips them)."""
        if warmup or self.weights_type == "global_weights":
            B = g_sample.shape[0]
            return self.mixture_weights_logits[None, :].expand(
                B, self.n_components)
        return self.mixture_weights_encoder(g_sample)

    def _decoder_outputs(self, p0, lv_sums, g_sample, warmup):
        base_mus, base_logvars = self.point_base(g_sample)
        return {
            "p0_samples": p0,
            "p_logvar_sums": lv_sums,
            "p_base_mus": base_mus,
            "p_base_logvars": base_logvars,
            "mixture_weights_logits": self.get_weights(g_sample, warmup),
        }

    def decode_training(self, p_input: torch.Tensor, g_sample: torch.Tensor,
                        warmup: bool = False, fused: bool = False) -> Dict:
        """Inverse-decode p_input (B, 3, N) through all K components with
        train-mode BatchNorm; returns what flow_mixture_loss reads:
        p0_samples and p_logvar_sums (K, B, 3, N), p_base_mus and
        p_base_logvars (B, 3, 1), mixture_weights_logits (B, K).

        fused=False runs the decoder's modules under autograd; fused=True
        runs `fused_train_decode` (the kernels on a CUDA tensor, their
        plain versions on a CPU tensor) and writes the batch statistics
        it returns into the decoder's running statistics. Inside a
        process group of several ranks both take their BatchNorm
        statistics over the global batch (kernels 7 and 8 in their SPMD
        form).
        """
        K = self.n_components
        B, _, N = p_input.shape
        p_stack = p_input[None].expand(K, B, 3, N)
        if fused:
            # inside a process group: statistics over the global batch of
            # `world` equal shards
            world = dist.world_size()
            packed = pack_point_decoder_train(self.pc_decoder)
            ab, film_stats = film_ab_train(packed, g_sample)
            p0, lv_sums, stats = fused_train_decode(
                packed, ab, p_stack.contiguous())
            decoder_stats_update(self.pc_decoder, stats, film_stats,
                                 n_sd=world * B * N, n_film=world * B)
        else:
            p0, lv_sums = self.pc_decoder(p_stack, g_sample, "inverse")
        return self._decoder_outputs(p0, lv_sums, g_sample, warmup)

    def decode_eval(self, p_input: torch.Tensor, g_sample: torch.Tensor,
                    warmup: bool = False) -> Dict:
        """decode_training's outputs with BatchNorm running statistics,
        the inverse through `point_decode(..., inverse=True)` on the
        packed decoder: the kernel on a CUDA tensor, its plain version on
        a CPU tensor, never the decoder's modules. Needs eval mode."""
        if self.training:
            raise RuntimeError("decode_eval needs eval mode (BatchNorm "
                               "running statistics): call model.eval()")
        K = self.n_components
        B, _, N = p_input.shape
        packed = self.pack_decoder()
        p_stack = p_input[None].expand(K, B, 3, N).contiguous()
        p0, lv_sums = point_decode(packed, film_alpha_beta(packed, g_sample),
                                   p_stack, inverse=True)
        return self._decoder_outputs(p0, lv_sums, g_sample, warmup)

    def _decoder_tensors(self):
        # the decoder's ~1,000 modules are walked once, for the parameter
        # and buffer dicts that hold something (the walk costs more host
        # time than the check itself); the tensors are read from the dicts
        # anew each time, as `.to()` puts new buffers there
        if self._decoder_dicts is None:
            self._decoder_dicts = [
                d for m in self.pc_decoder.modules()
                for d in (m._parameters, m._buffers) if d]
        return [t for d in self._decoder_dicts for t in d.values()
                if t is not None]

    def pack_decoder(self) -> Dict[str, torch.Tensor]:
        """The K decoders constant-folded for the `point_decode` kernel
        (see ops/kernels/point_decode.py), with their running statistics.

        Packed again only when the decoder changed since the last pack:
        a tensor written in place (an optimizer step, a running-statistics
        update, load_state_dict: its version counter moved) or replaced
        (`.to(device)` puts new buffers in the BatchNorms). Rebinding a
        parameter's `.data` by hand is not seen. The packed tensors are
        ordinary ones (never inference tensors), so a cached pack serves
        any later caller."""
        tensors = self._decoder_tensors()
        versions = [t._version for t in tensors]
        if not (versions == self._packed_versions
                and len(tensors) == len(self._packed_from)
                and all(map(operator.is_, tensors, self._packed_from))):
            with torch.inference_mode(False), torch.no_grad():
                self._packed = pack_point_decoder(self.pc_decoder)
            self._packed_from = tensors
            self._packed_versions = versions
        return self._packed

    def decode_sampling(self, g_sample: torch.Tensor, ids: torch.Tensor,
                        base_eps: torch.Tensor,
                        packed: Dict[str, torch.Tensor]):
        """Labeled clouds from given noise.

        ids (B, N): each point's component; base_eps (K, B, 3, N): each
        component's base noise. Every component decodes every point; each
        point keeps its own component's output. Returns samples (B, 3, N)
        and labels ids + 1.
        """
        base_mus, base_logvars = self.point_base(g_sample)
        base = base_mus[None] + torch.exp(0.5 * base_logvars)[None] * base_eps
        ab = film_alpha_beta(packed, g_sample)
        decoded, _ = point_decode(packed, ab, base.contiguous())
        B, N = ids.shape
        pick = ids[None, :, None, :].expand(1, B, 3, N)
        samples = torch.gather(decoded, 0, pick)[0]
        return samples, ids + 1


class FlowMixtureSVRModel(FlowMixtureModel):
    """Single-view reconstruction: the latent prior's base comes from a
    ResNet-18 image encoder and an image-conditioned FeatureEncoder
    (`g0_prior`), not from the learned `g0_prior_mus` / `g0_prior_logvars`,
    which stay unused (as in the JAX package: they get no gradient, so
    the optimizer leaves them as they are).

    Constructor arguments: FlowMixtureModel's, and `g_prior_n_layers`,
    the depth of g0_prior's MLP. The YAML's `img_enc_*` keys are not
    read: the image encoder is ResNet18(num_classes=g_latent_space_size)
    at its default widths, as in the JAX package.
    """

    def __init__(self, *args, g_prior_n_layers: int = 1,
                 generator: Optional[torch.Generator] = None, **kwargs):
        generator = generator or torch.Generator().manual_seed(0)
        super().__init__(*args, generator=generator, **kwargs)
        G = self.g_latent_space_size
        self.img_encoder = ResNet18(num_classes=G, generator=generator)
        self.g0_prior = FeatureEncoder(
            G, g_prior_n_layers, G, deterministic=False,
            mu_weight_std=0.0033, mu_bias=0.0, logvar_weight_std=0.033,
            logvar_bias=0.0)
        reset_parameters(self.g0_prior, generator)

    def encode(self, g_input: torch.Tensor, mode: str,
               images: Optional[torch.Tensor] = None,
               posterior_eps: Optional[torch.Tensor] = None) -> Dict:
        """Image-prior encoding of a batch; images (B, 4, H, W).

        The prior base (mu0, lv0) = g0_prior(img_encoder(images)).
        training: g = mu + exp(lv / 2) * posterior_eps from the point
        cloud's posterior (posterior_eps (B, G) is required), inverted
        through the prior flow. reconstruction: g0 = mu0, no noise,
        pushed forward through the prior flow (g_input is not read).
        """
        if images is None:
            raise ValueError("SVR encode needs images (B, 4, H, W)")
        mu0, lv0 = self.g0_prior(self.img_encoder(images))
        out = {"g_prior_mus0": mu0, "g_prior_logvars0": lv0}
        if mode == "training":
            g0, g_s, flow_lv_sum = self._encode_posterior(
                g_input, mode, posterior_eps, out)
        elif mode == "reconstruction":
            g0 = mu0
            g_s, flow_lv_sum = self.g_prior(g0, "direct")
        else:
            raise ValueError(f"SVR encode: unsupported mode {mode!r}")
        out.update(g0_sample=g0, g_sample=g_s,
                   g_prior_logvar_sum=lv0 + flow_lv_sum)
        return out
