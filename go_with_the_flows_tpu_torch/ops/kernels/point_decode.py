"""Eval-mode decode of the K-component point coupling chain: the CUDA
kernel `csrc/point_decode.cu`, its plain PyTorch version, and the
host-side packing around both.

Replaces `_decode_kernel` of go_with_the_flows_tpu/ops/pallas/coupling_kernel.py
(launched by `fused_point_decode`). As there, every coupling is constant
folded (`pack_point_decoder`): eval BatchNorm, the keep-channel selection
and the warp-channel scatter go into the weights, and the per-cloud FiLM
modulation into one affine per hidden unit (`film_alpha_beta`). Per
coupling c and head h in (logvar, mu):

    h0 = relu(W0 x + b0)                    W0 (f, 3): zero columns on warped channels
    h1 = relu(alpha * (W1 h0) + beta)       W1 (f, f); alpha, beta per cloud
    y  = W2 h1 + b2                         W2 (3, f): zero rows on kept channels
    logvar = softsign(y_lv); scale = sqrt(eps + exp(logvar))
    direct: x <- scale * x + y_mu           inverse: x <- (x - y_mu) / scale
    lv_sum <- lv_sum + logvar

Unlike the TPU kernel, the two heads are kept apart (W1 is (2, f, f), not
a (2f, 2f) block diagonal), because on the card the zeros would be paid
for in FMAs. Packed layout, leading K axis (one per mixture component):

    w0 (K, C, 2, f, 3)   b0 (K, C, 2, f)   w1 (K, C, 2, f, f)
    w2 (K, C, 2, 3, f)   b2 (K, C, 2, 3)   ab (K, B, C, 2, 2f)

where ab[..., 0, :] is alpha and ab[..., 1, :] beta, heads stacked as
[logvar f | mu f].

`pack_point_decoder` and `film_alpha_beta` are small products that stay
plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import build

BN_EPS = 1e-5  # ops/layers.py BatchNorm
EPS = 1e-6     # coupling eps (models/flows.py)
MAX_F = 64     # widest conditioner the kernel's shared-memory layout takes

_HEADS = ("logvar", "mu")


def _fold_head(coupling, head: str):
    """One conditioner head folded to (w0, b0, w1, a1, b1, w2, b2), each
    with the decoder's stack shape leading."""
    t0 = getattr(coupling, f"T_{head}_0")
    sd0 = getattr(t0, f"{head}_sd0")
    bn0 = getattr(t0, f"{head}_sd0_bn")
    sd1 = getattr(t0, f"{head}_sd1")
    bn1 = getattr(t0, f"{head}_sd1_bn")
    sd2 = getattr(getattr(coupling, f"T_{head}_1"), f"{head}_sd2")
    keep, warp = list(coupling.keep_inds), list(coupling.warp_inds)
    lead = sd1.weight.shape[:-2]
    f = sd1.weight.shape[-1]

    a0 = bn0.weight * torch.rsqrt(bn0.running_var + BN_EPS)
    b0 = bn0.bias - bn0.running_mean * a0
    w0 = sd0.weight.new_zeros(*lead, f, 3)
    w0[..., keep] = sd0.weight * a0[..., None]
    a1 = torch.rsqrt(bn1.running_var + BN_EPS)  # affine-free BN
    b1 = -bn1.running_mean * a1
    w2 = sd2.weight.new_zeros(*lead, 3, f)
    w2[..., warp, :] = sd2.weight
    b2 = sd2.bias.new_zeros(*lead, 3)
    b2[..., warp] = sd2.bias
    return w0, b0, sd1.weight, a1, b1, w2, b2


def _fold_film(film):
    """FiLM net constants (k0 (f, G), a0 (f), b0 (f), k1 (f, f), b1 (f))
    with the eval BN folded."""
    s = film.short
    lin0, bn, lin1 = (getattr(film, f"{s}0"), getattr(film, f"{s}0_bn"),
                      getattr(film, f"{s}1"))
    a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    b = bn.bias - bn.running_mean * a
    return lin0.weight, a, b, lin1.weight, lin1.bias


@torch.no_grad()
def pack_point_decoder(decoder) -> Dict[str, torch.Tensor]:
    """Constant-fold a PointDecoderFlow (any stack shape) into the packed
    arrays above; C = 3 * n_flows couplings in direct order, each array
    with the stack shape leading and C after it."""
    names = ("w0", "b0", "w1", "a1", "b1", "w2", "b2")
    acc = {k: [] for k in names + ("film_k0", "film_a0", "film_b0",
                                   "film_k1", "film_b1")}
    axis = len(decoder.stack)  # position of the coupling axis C
    for coupling in decoder.couplings():
        heads = [_fold_head(coupling, h) for h in _HEADS]
        for i, name in enumerate(names):
            acc[name].append(torch.stack([hd[i] for hd in heads], axis))
        # FiLM nets in head-stacked order (lv_w, lv_b, mu_w, mu_b)
        films = [_fold_film(getattr(coupling, f"T_{h}_0_cond_{n}"))
                 for h in _HEADS for n in ("w", "b")]
        for i, name in enumerate(("film_k0", "film_a0", "film_b0",
                                  "film_k1", "film_b1")):
            acc[name].append(torch.stack([fm[i] for fm in films], axis))
    return {k: torch.stack(v, axis).contiguous() for k, v in acc.items()}


def film_alpha_beta(packed: Dict[str, torch.Tensor],
                    g: torch.Tensor) -> torch.Tensor:
    """Per-cloud fused conditioner affines for g (B, G):
    alpha = (eps + exp(film_w(g))) * BN1_scale,
    beta = (eps + exp(film_w(g))) * BN1_shift + film_b(g).
    Returns (..., B, C, 2, 2f) with the packed arrays' stack shape
    leading."""
    h = torch.einsum("bg,...cjfg->...bcjf", g, packed["film_k0"])
    h = F.silu(h * packed["film_a0"].unsqueeze(-4)
               + packed["film_b0"].unsqueeze(-4))
    out = torch.einsum("...bcjf,...cjef->...bcje", h, packed["film_k1"])
    out = out + packed["film_b1"].unsqueeze(-4)  # (..., B, C, 4, f)
    scale = EPS + torch.exp(out[..., 0::2, :])    # (..., B, C, 2, f)
    shift = out[..., 1::2, :]
    alpha = scale * packed["a1"].unsqueeze(-4)
    beta = scale * packed["b1"].unsqueeze(-4) + shift
    return torch.stack([alpha.flatten(-2), beta.flatten(-2)], -2)


def point_decode_plain(packed, ab, p, inverse: bool = False):
    """Plain PyTorch version of the kernel: p (K, B, 3, N) through all C
    couplings of each component. Returns (p_out, logvar_sum)."""
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    ab = ab.reshape(K, B, C, 2, 2, f)
    x = p
    lv_sum = torch.zeros_like(p)
    for i in range(C):
        c = C - 1 - i if inverse else i
        h = torch.einsum("khfi,kbin->kbhfn", packed["w0"][:, c], x)
        h = F.relu(h + packed["b0"][:, c][:, None, :, :, None])
        h = torch.einsum("khoi,kbhin->kbhon", packed["w1"][:, c], h)
        alpha = ab[:, :, c, 0, :, :, None]  # (K, B, 2, f, 1)
        beta = ab[:, :, c, 1, :, :, None]
        h = F.relu(alpha * h + beta)
        y = torch.einsum("khjf,kbhfn->kbhjn", packed["w2"][:, c], h)
        y = y + packed["b2"][:, c][:, None, :, :, None]  # (K, B, 2, 3, N)
        logvar = F.softsign(y[:, :, 0])
        mu = y[:, :, 1]
        scale = torch.sqrt(EPS + torch.exp(logvar))
        x = (x - mu) / scale if inverse else scale * x + mu
        lv_sum = lv_sum + logvar
    return x, lv_sum


def point_decode(packed, ab, p, inverse: bool = False):
    """Eval pass of the coupling chain, direct or inverse.

    p: (K, B, 3, N); packed from a K-stacked decoder; ab from
    film_alpha_beta. Returns (p_out, logvar_sum) with p's shape. A CPU
    tensor goes to the plain version; a CUDA tensor launches the kernel.
    """
    if p.device.type == "cpu":
        return point_decode_plain(packed, ab, p, inverse)

    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    args = [p, packed["w0"], packed["b0"], packed["w1"], packed["w2"],
            packed["b2"], ab]
    shapes = [(K, B, 3, N), (K, C, 2, f, 3), (K, C, 2, f), (K, C, 2, f, f),
              (K, C, 2, 3, f), (K, C, 2, 3), (K, B, C, 2, 2 * f)]
    for t, shape in zip(args, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"point_decode: shape {tuple(t.shape)}, "
                             f"expected {shape}")
    build.check_tensors(args, p.device)
    if not 1 <= f <= MAX_F:
        raise ValueError(f"point_decode: f={f} outside 1..{MAX_F}")
    if min(K, B, N) < 1 or max(K, B) > 65535:
        raise ValueError(f"point_decode: grid (K={K}, B={B}, N={N}) "
                         "outside the kernel's launch limits")
    out = torch.empty_like(p)
    lv = torch.empty_like(p)
    lib = build.library()
    with torch.cuda.device(p.device):
        code = lib.gwtf_point_decode(
            *(t.data_ptr() for t in args), out.data_ptr(), lv.data_ptr(),
            K, B, C, N, f, int(inverse), build.stream_handle(p.device))
    point_decode.launches += 1
    build.check(lib, code, "point_decode")
    return out, lv


point_decode.launches = 0

