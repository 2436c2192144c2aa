"""Plain float32 training forward of the flow-mixture VAE of "Go with the
Flows" (3DV 2021), written from the published model and independent of
the program: no kernel, no packing, no precision modes, no ranks.

The weights are a dict {name: tensor} under the published module names
(`pc_decoder.flows.{i}.nvp{j}.T_mu_0.mu_sd0.weight`, ...), the same
names the benchmark's weights carry. Point features are (B, C, N), the
K decoders' (K, B, C, N) with K-stacked weights. BatchNorm is in
training mode everywhere (batch statistics, the biased variance in two
passes, eps 1e-5). The decoder's couplings are recomputed in the
backward (`torch.utils.checkpoint`), one coupling at a time, so that
the published batch fits beside nothing else on the card.

Run it with TF32 off (`fp32_switches(True)`): a float32 product on the
card may otherwise be a TF32 one. `fp32_switches(False)` is the
control's precision.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
BN_EPS = 1e-5
LOG_2PI = math.log(2.0 * math.pi)
# warp channels of the three couplings of a decoder flow, by flow parity
POINT_PATTERNS = {0: ((0,), (1,), (2,)), 1: ((0, 1), (0, 2), (1, 2))}


def fp32_switches(full: bool) -> None:
    """Float32 products in float32 (`full`) or in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = not full
    torch.backends.cudnn.allow_tf32 = not full
    torch.set_float32_matmul_precision("highest" if full else "high")


def bn(x, dims, weight=None, bias=None, shape=None):
    """Training-mode BatchNorm of x over `dims`; weight and bias viewed
    as `shape`."""
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    if weight is not None:
        y = y * weight.reshape(shape) + bias.reshape(shape)
    return y


def _n_layers(w, prefix):
    n = 0
    while f"{prefix}features.mlp{n}.weight" in w:
        n += 1
    return n


def feature_encoder(w, prefix, x, deterministic=False):
    """Linear (no bias) + BatchNorm + SiLU layers, then a mus head and,
    unless deterministic, a logvars head."""
    h = x
    for i in range(_n_layers(w, prefix)):
        h = h @ w[f"{prefix}features.mlp{i}.weight"].t()
        h = F.silu(bn(h, (0,), w[f"{prefix}features.mlp{i}_bn.weight"],
                      w[f"{prefix}features.mlp{i}_bn.bias"], (1, -1)))
    mus = h @ w[f"{prefix}mus.mu_mlp0.weight"].t() + w[
        f"{prefix}mus.mu_mlp0.bias"]
    if deterministic:
        return mus
    return mus, h @ w[f"{prefix}logvars.logvar_mlp0.weight"].t() + w[
        f"{prefix}logvars.logvar_mlp0.bias"]


def pointnet(w, x):
    """Per-point (B, 3, N) -> (B, 512, N): linear maps with BatchNorm
    over (B, N) and ReLU."""
    h = x
    for name in ("init_sd", "sd0", "sd1", "sd2"):
        p = f"pc_encoder.features.{name}"
        h = torch.matmul(w[f"{p}.weight"], h)
        h = F.relu(bn(h, (0, 2), w[f"{p}_bn.weight"], w[f"{p}_bn.bias"],
                      (1, -1, 1)))
    return h


def _latent_coupling(w, prefix, g, warp: slice, keep: slice):
    def head(name):
        p = f"{prefix}T_{name}_0.{name}_mlp"
        h = g[:, keep] @ w[f"{p}0.weight"].t()
        h = F.silu(bn(h, (0,), w[f"{p}0_bn.weight"], w[f"{p}0_bn.bias"],
                      (1, -1)))
        return h @ w[f"{p}1.weight"].t() + w[f"{p}1.bias"]

    lv_w = torch.log(EPS + torch.exp(head("logvar")))
    mu_w = head("mu")
    logvar = torch.zeros_like(g)
    mu = torch.zeros_like(g)
    logvar[:, warp] = lv_w
    mu[:, warp] = mu_w
    return logvar, mu


def latent_prior(w, g, inverse: bool):
    """The latent prior flow: couples of two couplings, even/odd then
    first/second half by flow parity; inverse runs them in reverse.
    Returns (g', sum of the couplings' logvars)."""
    G = g.shape[1]
    order = []
    i = 0
    while f"g_prior.flows.{i}.nvp1.T_mu_0.mu_mlp0.weight" in w:
        if i % 2 == 0:
            halves = (slice(0, G, 2), slice(1, G, 2))
        else:
            halves = (slice(0, G // 2), slice(G // 2, G))
        order += [(f"g_prior.flows.{i}.nvp1.", halves[0], halves[1]),
                  (f"g_prior.flows.{i}.nvp2.", halves[1], halves[0])]
        i += 1
    if inverse:
        order = order[::-1]
    lv_sum = torch.zeros_like(g)
    for prefix, warp, keep in order:
        logvar, mu = _latent_coupling(w, prefix, g, warp, keep)
        if inverse:
            g = torch.exp(-0.5 * logvar) * (g - mu)
        else:
            g = torch.exp(0.5 * logvar) * g + mu
        lv_sum = lv_sum + logvar
    return g, lv_sum


def _film(w, p, g):
    """FiLM net of K stacked decoders: (B, G) -> (K, B, f)."""
    h = torch.matmul(g, w[f"{p}0.weight"].transpose(-1, -2))
    h = F.silu(bn(h, (1,), w[f"{p}0_bn.weight"], w[f"{p}0_bn.bias"],
                  (h.shape[0], 1, -1)))
    return torch.matmul(h, w[f"{p}1.weight"].transpose(-1, -2)) + w[
        f"{p}1.bias"][:, None, :]


def _point_coupling(weights, prefix, warp, keep, p, g):
    """One coupling's inverse on (K, B, 3, N): (p', logvar)."""
    w = {k[len(prefix):]: v for k, v in weights.items()}
    K = p.shape[0]
    p_keep = p[:, :, list(keep), :]

    def head(name):
        h = torch.matmul(w[f"T_{name}_0.{name}_sd0.weight"][:, None], p_keep)
        h = F.relu(bn(h, (1, 3), w[f"T_{name}_0.{name}_sd0_bn.weight"],
                      w[f"T_{name}_0.{name}_sd0_bn.bias"], (K, 1, -1, 1)))
        h = bn(torch.matmul(w[f"T_{name}_0.{name}_sd1.weight"][:, None], h),
               (1, 3))
        scale = _film(w, f"T_{name}_0_cond_w.{name}_sd1_film_w", g)
        shift = _film(w, f"T_{name}_0_cond_b.{name}_sd1_film_b", g)
        h = F.relu((EPS + torch.exp(scale))[..., None] * h + shift[..., None])
        return torch.matmul(w[f"T_{name}_1.{name}_sd2.weight"][:, None], h) \
            + w[f"T_{name}_1.{name}_sd2.bias"][:, None, :, None]

    lv_w = F.softsign(head("logvar"))
    mu_w = head("mu")
    logvar = torch.zeros_like(p)
    mu = torch.zeros_like(p)
    logvar[:, :, list(warp), :] = lv_w
    mu[:, :, list(warp), :] = mu_w
    return (p - mu) / torch.sqrt(EPS + torch.exp(logvar)), logvar


def decoder_inverse(w, p, g):
    """All K decoders' inverse of p (K, B, 3, N) given g (B, G): the
    couplings in reverse order, each recomputed in the backward.
    Returns (p0, sum of the logvars), each (K, B, 3, N)."""
    couplings = []
    i = 0
    while f"pc_decoder.flows.{i}.nvp1.T_mu_0.mu_sd0.weight" in w:
        for j, warp in enumerate(POINT_PATTERNS[i % 2]):
            keep = tuple(c for c in range(3) if c not in warp)
            prefix = f"pc_decoder.flows.{i}.nvp{j + 1}."
            couplings.append((prefix, warp, keep))
        i += 1
    lv_sum = torch.zeros_like(p)
    for prefix, warp, keep in reversed(couplings):
        mine = {k: v for k, v in w.items() if k.startswith(prefix)}
        p, lv = checkpoint(_point_coupling, mine, prefix, warp, keep, p, g,
                           use_reentrant=False)
        lv_sum = lv_sum + lv
    return p, lv_sum


def resnet18(w, x):
    """The 4-channel ResNet-18 image encoder with its fc -> BatchNorm ->
    ReLU head: (B, 4, H, W) -> (B, 512)."""
    def conv_bn(prefix, conv, bn_name, h, stride, pad):
        h = F.conv2d(h, w[f"{prefix}{conv}.weight"], None, stride, pad)
        return F.batch_norm(h, None, None, w[f"{prefix}{bn_name}.weight"],
                            w[f"{prefix}{bn_name}.bias"], True, 0.0, BN_EPS)

    h = F.relu(conv_bn("img_encoder.", "conv1", "bn1", x, 2, 3))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for s in range(1, 5):
        for b in range(2):
            p = f"img_encoder.layer{s}_{b}."
            stride = 2 if (s > 1 and b == 0) else 1
            out = F.relu(conv_bn(p, "conv1", "bn1", h, stride, 1))
            out = conv_bn(p, "conv2", "bn2", out, 1, 1)
            if f"{p}downsample_conv.weight" in w:
                h = conv_bn(p, "downsample_conv", "downsample_bn", h, stride,
                            0)
            h = F.relu(out + h)
    h = h.mean(dim=(2, 3)) @ w["img_encoder.fc.weight"].t() + w[
        "img_encoder.fc.bias"]
    return F.relu(bn(h, (0,), w["img_encoder.fc_bn.weight"],
                     w["img_encoder.fc_bn.bias"], (1, -1)))


def training_loss(w: Dict[str, torch.Tensor], g_clouds, p_clouds, eps,
                  base_type: str, images: Optional[torch.Tensor] = None):
    """The training loss PNLL + GNLL - GENT (all weights 1) of one batch,
    its posterior noise `eps` (B, G) given; the mixture weights from the
    weights encoder (no warmup). With `images`, the latent prior's base
    comes from the ResNet-18 and g0_prior (single-view reconstruction).
    Returns (loss, {"pnll", "gnll", "gent"})."""
    B = g_clouds.shape[0]
    feats = pointnet(w, g_clouds).amax(dim=2)
    post_mus, post_logvars = feature_encoder(w, "g_posterior.", feats)
    g = post_mus + torch.exp(0.5 * post_logvars) * eps
    g0, flow_lv = latent_prior(w, g, inverse=True)
    G = g.shape[1]
    if images is None:
        mu0 = w["g0_prior_mus"].expand(B, G)
        lv0 = w["g0_prior_logvars"].expand(B, G)
    else:
        mu0, lv0 = feature_encoder(w, "g0_prior.", resnet18(w, images))
    gnll = 0.5 * (torch.sum(lv0 + flow_lv + (g0 - mu0) ** 2 / torch.exp(lv0))
                  / B + G * LOG_2PI)
    gent = 0.5 * (G * (1.0 + LOG_2PI)
                  + torch.mean(torch.sum(post_logvars, dim=1)))

    K = w["mixture_weights_logits"].shape[0]
    p0, lv_sum = decoder_inverse(
        w, p_clouds[None].expand(K, *p_clouds.shape).contiguous(), g)
    if base_type == "free":
        base_mus, base_lv = feature_encoder(w, "p_prior.", g)
    elif base_type == "freevar":
        base_lv = feature_encoder(w, "p_prior.", g, deterministic=True)
        base_mus = torch.zeros_like(base_lv)
    else:
        raise ValueError(f"base type {base_type!r} is not benchmarked")
    base_mus, base_lv = base_mus[:, :, None], base_lv[:, :, None]
    log_w = torch.log_softmax(torch.log_softmax(feature_encoder(
        w, "mixture_weights_encoder.", g, deterministic=True), -1), -1)
    C = p0.shape[2]
    comp = -0.5 * (torch.sum(lv_sum + base_lv[None]
                             + (p0 - base_mus[None]) ** 2
                             / torch.exp(base_lv[None]), dim=2)
                   + C * LOG_2PI)
    logp = torch.logsumexp(comp + log_w.t()[:, :, None], dim=0)
    pnll = -torch.mean(torch.sum(logp, dim=1))
    loss = pnll + gnll - gent
    return loss, {"pnll": pnll, "gnll": gnll, "gent": gent}
