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

The kernel reads its own layout of the same numbers, padded to FP (f
rounded up to a multiple of 8) so that it stages them by plain 16-byte
copies: `kernel_weights` (made once by `pack_point_decoder`, under the
key "kernel", through `kernel_layout`, which also keeps the other modes'
layouts: at 'fast' and 'high' the products' operands as bf16 pairs, for
the tensor cores) and `kernel_film` (made per call from ab); see
csrc/point_decode.cu.

`pack_point_decoder` and `film_alpha_beta` are small products that stay
plain PyTorch, as the JAX package leaves them to XLA.

The three products (W0 x, W1 h0, W2 h1) follow the matmul precision mode
(ops/precision.py), as the TPU kernel's `_mxdot` does: the plain version
forms them with `mxdot`, the kernel in an instantiation of that mode
(at 'fast' and 'high' on the tensor cores), from a layout of the weights
rounded ('fast') or split into hi and lo parts ('high') once per pack
(`kernel_layout`). film_alpha_beta, the
FiLM affines, the softsign, exp and sqrt and the affine update stay fp32
in every mode, as on the TPU.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import precision
from ..precision import bf16_split, mxdot
from . import build

BN_EPS = 1e-5  # ops/layers.py BatchNorm
EPS = 1e-6     # coupling eps (models/flows.py)
MAX_F = 64     # widest conditioner the kernel's shared-memory layout takes

_HEADS = ("logvar", "mu")
# the kernel's MODE template argument (csrc/point_decode.cu)
KERNEL_MODES = {"highest": 0, "high": 1, "fast": 2}


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
    packed = {k: torch.stack(v, axis).contiguous() for k, v in acc.items()}
    kernel_layout(packed, "highest")
    return packed


def padded_width(f: int) -> int:
    """FP: the conditioner width f rounded up to a multiple of 8."""
    return (f + 7) // 8 * 8


def _layout(w0, b0, w1, w2, b2) -> torch.Tensor:
    f = w1.shape[-1]
    pad = padded_width(f) - f
    w1 = F.pad(w1, (0, pad, 0, pad))
    w0b0 = F.pad(torch.cat([w0, b0[..., None]], -1), (0, 0, 0, pad))
    w2 = F.pad(w2.transpose(-1, -2), (0, 1, 0, pad))
    b2 = F.pad(b2, (0, 1))
    return torch.cat([t.flatten(-3) for t in (w1, w0b0, w2)]
                     + [b2.flatten(-2)], -1)


def pair_stride(FP: int) -> int:
    """WS: the words of a row of bf16 pairs of FP depths, FP / 2 padded to
    4 mod 8 (csrc/mma_bf16.cuh `w1_pair_stride`)."""
    return FP // 2 if (FP // 2) % 8 == 4 else FP // 2 + 4


def bf16_pairs(t: torch.Tensor) -> torch.Tensor:
    """t (..., 2 m), bf16 values held in fp32, as (..., m) int32 words of
    bf16 pairs: depth 2 i in the lower half of word i, 2 i + 1 in the
    upper (the mma fragments' order)."""
    bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    words = bits[..., 0::2] | (bits[..., 1::2] << 16)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _pair_planes(w0, w1, w2, FP: int) -> list:
    """One plane each of W1 (..., 2, FP, WS), W0 (..., 2, FP, 2) and W2
    (..., 2, 4, WS) as bf16 pair words, flattened per coupling."""
    f, WS = w1.shape[-1], pair_stride(FP)
    w1 = F.pad(w1, (0, 2 * WS - f, 0, FP - f))
    w0 = F.pad(w0, (0, 1, 0, FP - f))
    w2 = F.pad(w2, (0, 2 * WS - f, 0, 1))
    return [bf16_pairs(t).flatten(-3) for t in (w1, w0, w2)]


def layout_words(f: int, mode: str) -> int:
    """Words a coupling of the kernel layout of `mode` takes
    (`kernel_weights`)."""
    FP = padded_width(f)
    if mode == "highest":
        return 2 * FP * FP + 16 * FP + 8
    planes = 2 if mode == "high" else 1
    return planes * (2 * FP * pair_stride(FP) + 4 * FP
                     + 8 * pair_stride(FP)) + 2 * FP + 8


def kernel_weights(packed: Dict[str, torch.Tensor],
                   mode: str) -> torch.Tensor:
    """The kernel's layout of the folded weights in `mode`, (..., C, L),
    zeros padding f to FP. At 'highest' L = 2 FP^2 + 16 FP + 8 floats: per
    coupling W1 (2, FP, FP), then per head and row {w0, b0} and {w2, 0} as
    4 floats each, then b2 as (2, 4). At 'fast' and 'high' the products'
    operands are bf16 pairs in 32-bit words (`bf16_pairs`, held in a
    float32 tensor): W1 (2, FP, WS) (rows the output features, WS =
    `pair_stride(FP)`), W0 (2, FP, 2) ((w0x, w0y), (w0z, 0)), W2 (2, 4, WS)
    (its three rows and a row of zeros), at 'fast' of the weights rounded
    to bf16, at 'high' of their hi parts, each plane followed by that of
    their lo parts; then fp32 b0 (2, FP) and b2 (2, 4). See
    csrc/point_decode.cu (`Layout`, `TcLayout`)."""
    w0, b0, w1, w2, b2 = (packed[k] for k in ("w0", "b0", "w1", "w2", "b2"))
    if mode == "highest":
        return _layout(w0, b0, w1, w2, b2).contiguous()
    if mode not in ("high", "fast"):
        raise ValueError(f"kernel_weights: unknown mode {mode!r}")
    FP = padded_width(w1.shape[-1])
    if mode == "high":
        (w0, w0l), (w1, w1l), (w2, w2l) = (bf16_split(t)
                                           for t in (w0, w1, w2))
        hi, lo = (_pair_planes(*ws, FP) for ws in ((w0, w1, w2),
                                                   (w0l, w1l, w2l)))
        planes = [hi[0], lo[0], hi[1], lo[1], hi[2], lo[2]]
    else:  # bf16_pairs rounds
        planes = _pair_planes(w0, w1, w2, FP)
    biases = [F.pad(b0, (0, FP - b0.shape[-1])).flatten(-2),
              F.pad(b2, (0, 1)).flatten(-2)]
    words = planes + [t.contiguous().view(torch.int32) for t in biases]
    return torch.cat(words, -1).view(torch.float32).contiguous()


def kernel_layout(packed: Dict[str, torch.Tensor],
                  mode: str) -> torch.Tensor:
    """The kernel layout of `mode` (kernel_weights), made once per pack and
    kept in it: "kernel" for 'highest' (which pack_point_decoder makes),
    "kernel_<mode>" for the others (made at their first launch). Never an inference tensor, so that a
    pack made or extended under torch.inference_mode serves any caller."""
    key = "kernel" if mode == "highest" else f"kernel_{mode}"
    if key not in packed:
        with torch.inference_mode(False), torch.no_grad():
            packed[key] = kernel_weights(packed, mode)
    return packed[key]


def kernel_film(ab: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of the FiLM affines ab (..., 2, 2f): per
    head and row {alpha, beta}, rows padded to FP, (..., 4 FP)."""
    f = ab.shape[-1] // 2
    ab = ab.unflatten(-1, (2, f)).transpose(-3, -2).transpose(-2, -1)
    return F.pad(ab, (0, 0, 0, padded_width(f) - f)).flatten(-3).contiguous()


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
    couplings of each component, the products in the current matmul
    precision mode. Returns (p_out, logvar_sum)."""
    mode = precision.get_matmul_precision()
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    ab = ab.reshape(K, B, C, 2, 2, f)
    x = p
    lv_sum = torch.zeros_like(p)
    for i in range(C):
        c = C - 1 - i if inverse else i
        # (K, 1, 2, f, 3) @ (K, B, 1, 3, N) -> (K, B, 2, f, N)
        h = mxdot(packed["w0"][:, c, None], x[:, :, None], mode)
        h = F.relu(h + packed["b0"][:, c][:, None, :, :, None])
        h = mxdot(packed["w1"][:, c, None], h, mode)
        alpha = ab[:, :, c, 0, :, :, None]  # (K, B, 2, f, 1)
        beta = ab[:, :, c, 1, :, :, None]
        h = F.relu(alpha * h + beta)
        y = mxdot(packed["w2"][:, c, None], h, mode)
        y = y + packed["b2"][:, c][:, None, :, :, None]  # (K, B, 2, 3, N)
        logvar = F.softsign(y[:, :, 0])
        mu = y[:, :, 1]
        scale = torch.sqrt(EPS + torch.exp(logvar))
        x = (x - mu) / scale if inverse else scale * x + mu
        lv_sum = lv_sum + logvar
    return x, lv_sum


def point_decode(packed, ab, p, inverse: bool = False):
    """Eval pass of the coupling chain, direct or inverse, in the current
    matmul precision mode.

    p: (K, B, 3, N); packed by pack_point_decoder from a K-stacked
    decoder; ab from film_alpha_beta. Returns (p_out, logvar_sum) with
    p's shape. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel of that mode, or raises.
    """
    if p.device.type == "cpu":
        return point_decode_plain(packed, ab, p, inverse)
    mode = precision.get_matmul_precision()

    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    if not 1 <= f <= MAX_F:
        raise ValueError(f"point_decode: f={f} outside 1..{MAX_F}")
    if min(K, B, N) < 1 or max(K, B) > 65535:
        raise ValueError(f"point_decode: grid (K={K}, B={B}, N={N}) "
                         "outside the kernel's launch limits")
    if tuple(ab.shape) != (K, B, C, 2, 2 * f):
        raise ValueError(f"point_decode: ab shape {tuple(ab.shape)}, "
                         f"expected {(K, B, C, 2, 2 * f)}")
    FP = padded_width(f)
    args = [p, kernel_layout(packed, mode), kernel_film(ab)]
    shapes = [(K, B, 3, N), (K, C, layout_words(f, mode)),
              (K, B, C, 4 * FP)]
    for t, shape in zip(args, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"point_decode: shape {tuple(t.shape)}, "
                             f"expected {shape}")
    build.check_tensors(args, p.device)
    out = torch.empty_like(p)
    lv = torch.empty_like(p)
    lib = build.library()
    with torch.cuda.device(p.device):
        code = lib.gwtf_point_decode(
            *(t.data_ptr() for t in args), out.data_ptr(), lv.data_ptr(),
            K, B, C, N, f, int(inverse), KERNEL_MODES[mode],
            build.stream_handle(p.device))
    point_decode.launches += 1
    point_decode.launches_by_mode[mode] += 1
    build.check(lib, code, "point_decode")
    return out, lv


point_decode.launches = 0
# the same launches by precision mode
point_decode.launches_by_mode = dict.fromkeys(KERNEL_MODES, 0)

