"""Losses of the flow-mixture VAE (counterpart of
go_with_the_flows_tpu/losses.py): the same constants, sums and
reductions, the mixture NLL as one (K, B, N) logsumexp, and the legacy
single-flow loss that the mixture generalises.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .parallel import dist

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_flow_nll(g0_sample, g_prior_mus0, g_prior_logvars0,
                      g_prior_logvar_sum) -> torch.Tensor:
    """Prior-flow NLL:
    0.5 * [sum_{b,d}(logvar_sum + (s0 - mu0)^2 / exp(logvar0)) / B
           + D * log(2 pi)]."""
    B, D = g0_sample.shape
    quad = (g0_sample - g_prior_mus0) ** 2 / torch.exp(g_prior_logvars0)
    return 0.5 * (torch.sum(g_prior_logvar_sum + quad) / B + D * _LOG_2PI)


def gaussian_entropy(posterior_logvars) -> torch.Tensor:
    """Posterior Gaussian entropy:
    0.5 * (D * (1 + log 2 pi) + mean_b sum_d logvars)."""
    D = posterior_logvars.shape[1]
    return 0.5 * (D * (1.0 + _LOG_2PI)
                  + torch.mean(torch.sum(posterior_logvars, dim=1)))


def flow_mixture_nll(p0_samples, p_logvar_sums, p_base_mus, p_base_logvars,
                     mixture_weights_logits) -> torch.Tensor:
    """Mixture decoder NLL.

    p0_samples, p_logvar_sums (K, B, C, N); p_base_mus, p_base_logvars
    (B, C, 1); mixture_weights_logits (B, K).

      log p_k(x_n) = -0.5 * (sum_c [logdet_sum + (s - mu)^2 / exp(logvar0)]
                             + C * log 2 pi)
      NLL = -mean_b sum_n logsumexp_k(log_w[b, k] + log p_k(x_n))

    On a grid that splits points (parallel/dist.py) the sum over n adds
    every points rank's partial sum (differentiably), so that each rank
    holds its clouds' whole NLL.
    """
    C = p0_samples.shape[2]
    log_w = torch.log_softmax(mixture_weights_logits, dim=-1)  # (B, K)
    logdet = p_logvar_sums + p_base_logvars[None]
    quad = (p0_samples - p_base_mus[None]) ** 2 / torch.exp(
        p_base_logvars[None])
    comp_logp = -0.5 * (torch.sum(logdet + quad, dim=2) + C * _LOG_2PI)
    weighted = comp_logp + log_w.t()[:, :, None]  # (K, B, N)
    logp = torch.logsumexp(weighted, dim=0)        # (B, N)
    return -dist.sum_over_ranks(torch.mean(torch.sum(logp, dim=1)),
                                "points")


def flow_mixture_loss(outputs: Dict[str, torch.Tensor],
                      pnll_weight: float = 1.0, gnll_weight: float = 1.0,
                      gent_weight: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pnll_w * PNLL + gnll_w * GNLL - gent_w * GENT over the training
    output dict of FlowMixtureModel."""
    pnll = flow_mixture_nll(
        outputs["p0_samples"], outputs["p_logvar_sums"],
        outputs["p_base_mus"], outputs["p_base_logvars"],
        outputs["mixture_weights_logits"])
    gnll = gaussian_flow_nll(
        outputs["g0_sample"], outputs["g_prior_mus0"],
        outputs["g_prior_logvars0"], outputs["g_prior_logvar_sum"])
    gent = gaussian_entropy(outputs["g_posterior_logvars"])
    loss = pnll_weight * pnll + gnll_weight * gnll - gent_weight * gent
    return loss, {"loss": loss, "pnll": pnll, "gnll": gnll, "gent": gent}


def point_flow_nll(p0_sample, p_logvar_sum, p_base_mus,
                   p_base_logvars) -> torch.Tensor:
    """Legacy single-flow per-point NLL (the reference's PointFlowNLL):
    p0_sample, p_logvar_sum (B, C, N) of one flow, the logvar sum
    including the base; p_base_mus, p_base_logvars (B, C, 1). Returns the
    per-point NLLs (B, 1, N), the channel axis kept."""
    quad = (p0_sample - p_base_mus) ** 2 / torch.exp(p_base_logvars)
    C = p0_sample.shape[1]
    return 0.5 * (torch.sum(p_logvar_sum + quad, dim=1, keepdim=True)
                  + C * _LOG_2PI)


def single_flow_vae_loss(outputs: Dict[str, torch.Tensor],
                         pnll_weight: float = 1.0, gnll_weight: float = 1.0,
                         gent_weight: float = 1.0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Legacy DPF loss: the summed single-flow PNLL + GNLL - GENT over
    the K=1 output dict of FlowMixtureModel."""
    pnll = torch.sum(point_flow_nll(
        outputs["p0_samples"][0], outputs["p_logvar_sums"][0],
        outputs["p_base_mus"], outputs["p_base_logvars"]))
    gnll = gaussian_flow_nll(
        outputs["g0_sample"], outputs["g_prior_mus0"],
        outputs["g_prior_logvars0"], outputs["g_prior_logvar_sum"])
    gent = gaussian_entropy(outputs["g_posterior_logvars"])
    loss = pnll_weight * pnll + gnll_weight * gnll - gent_weight * gent
    return loss, {"loss": loss, "pnll": pnll, "gnll": gnll, "gent": gent}
