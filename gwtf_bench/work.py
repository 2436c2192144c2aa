"""The work a configuration's calls need, counted from its shapes alone,
whatever implements them. An FMA is 2 FLOP.

The decoder's sizes follow the published parameter budget
(`params_reduce_mode`): K small decoders hold the parameters of one
decoder of `p_decoder_n_flows` flows of `p_decoder_n_features`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple


def _decoder_params(n_flows: int, f: int, g: int) -> int:
    return n_flows * 3 * (18 * f + 4 * f * g + 6 * f * f)


def decoder_shape(cfg: Dict) -> Tuple[int, int]:
    """(couplings C, width f) of each of the K decoders."""
    K, flows, f0, g = (cfg["n_components"], cfg["p_decoder_n_flows"],
                       cfg["p_decoder_n_features"],
                       cfg["g_latent_space_size"])
    mode = cfg["params_reduce_mode"]
    if K == 1 or mode == "none":
        return 3 * flows, f0
    if mode != "depth_and_feature":
        raise ValueError(f"params_reduce_mode {mode!r} is not counted")
    depth = math.ceil(flows / math.sqrt(K))
    big = _decoder_params(flows, f0, g)
    f = f0
    while f > 4:  # at least one step down, as the published arithmetic
        f -= 1
        if _decoder_params(depth, f, g) * K <= big:
            break
    return 3 * depth, f


def coupling_flop(f: int) -> int:
    """One point through one coupling of one component: two heads, each
    W0 (at most 2 -> f), W1 (f -> f), W2 (f -> at most 2) and the
    normalisations, FiLM and activations between them."""
    return 4 * f * f + 24 * f


def decoder_flop(cfg: Dict, n_points: int) -> float:
    """A cloud of `n_points` through all K decoders' chains, forward."""
    C, f = decoder_shape(cfg)
    return cfg["n_components"] * n_points * C * coupling_flop(f)


def pointnet_flop(cfg: Dict, n_points: int) -> float:
    """A cloud through the PointNet encoder's per-point maps, forward."""
    widths = [cfg["pc_enc_init_n_channels"], cfg["pc_enc_init_n_features"],
              *cfg["pc_enc_n_features"]]
    return n_points * sum(2 * a * b for a, b in zip(widths, widths[1:]))


def resnet18_flop(height: int, width: int, channels: int = 4,
                  out: int = 512) -> float:
    """One image through the ResNet-18 encoder's convolutions and fc,
    forward."""
    def conv(h, w, cin, cout, k, stride):
        h, w = (h + 2 * (k // 2) - k) // stride + 1, (
            w + 2 * (k // 2) - k) // stride + 1
        return h, w, 2 * h * w * cout * cin * k * k

    h, w, total = conv(height, width, channels, 64, 7, 2)
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # the 3x3 max-pool, stride 2
    cin = 64
    for stage, cout in enumerate((64, 128, 256, 512)):
        for block in range(2):
            stride = 2 if (stage > 0 and block == 0) else 1
            h1, w1, a = conv(h, w, cin, cout, 3, stride)
            _, _, b = conv(h1, w1, cout, cout, 3, 1)
            total += a + b
            if stride != 1 or cin != cout:
                total += conv(h, w, cin, cout, 1, stride)[2]
            h, w, cin = h1, w1, cout
    return total + 2 * cin * out


def train_flop_per_cloud(cfg: Dict, svr: bool) -> float:
    """A training step's needed FLOP a cloud: the decoder's chains of all
    K components (the mixture likelihood needs each), the PointNet and,
    for single-view reconstruction, the ResNet-18, each forward and twice
    for the backward. A recompute in the backward is not counted, nor the
    per-cloud MLPs (under 1 % of the step)."""
    n = cfg["cloud_size"]
    flop = decoder_flop(cfg, n) + pointnet_flop(cfg, n)
    if svr:
        flop += resnet18_flop(*cfg["image_size"])
    return 3.0 * flop
