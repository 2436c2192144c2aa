"""Train-mode inverse decode of the K-component point coupling chain and
its backward: the CUDA kernels of `csrc/train_decode.cu`, their plain
PyTorch versions, and the host-side packing around both.

Replaces `_fwd_kernel` and `_make_bwd_kernel` of
go_with_the_flows_tpu/ops/pallas/train_kernel.py (launched by
`fused_train_decode` and `_bwd_call`). As there, the decoder's RAW
parameters are stacked with no BatchNorm folding, since train-mode
BatchNorm normalises with batch statistics that exist only once the
batch has gone through the coupling before; the FiLM modulation enters
as one per-(cloud, coupling) affine `ab` made by plain tensor code
(`film_ab_train`), so that the FiLM nets train by ordinary autograd
through the kernel's `dab`. Per coupling c (inverse order) and head h in
(logvar, mu), with batch statistics over every real point of the batch:

    h0 = W0 x                   W0 (f, 3): zero columns on warped channels
    a  = relu(BN0(h0))          BN0 affine (scale, bias)
    h2 = W1 a                   W1 (f, f)
    fz = relu(fw * BN1(h2) + fb)    BN1 affine-free; fw, fb per cloud
    y  = W2 fz + b2             W2 (3, f): zero rows on kept channels
    logvar = softsign(y_lv); x <- (x - y_mu) / sqrt(eps + exp(logvar))

Packed layout, leading K axis, couplings in direct order:

    w0 (K, C, 2, f, 3)   bn0_scale, bn0_bias (K, C, 2, f)   w1 (K, C, 2, f, f)
    w2 (K, C, 2, 3, f)   b2 (K, C, 2, 3)                   ab (K, B, C, 2, 2f)

with film_k0 (K, C, 4, f, G), film_scale, film_bias, film_b1 (K, C, 4, f)
and film_k1 (K, C, 4, f, f) for the FiLM nets in (lv_w, lv_b, mu_w,
mu_b) order. ab[..., 0, :] is fw = eps + exp(film_w(g)), ab[..., 1, :]
fb = film_b(g), heads stacked [logvar f | mu f]. The two heads are kept
apart (W1 is (2, f, f), not the TPU's (2f, 2f) block diagonal).

`fused_train_decode(packed, ab, p)` is differentiable in packed, ab and
p; its `stats` output (K, C, 4, 2f) = [mean0, var0, mean1, var1] of each
coupling's two BatchNorms (biased variances) is not, and
`decoder_stats_update` blends it into the decoder's running statistics.

Data-parallel (the SPMD form of `make_fused_train_decode_spmd`), inside
a process group of several ranks (parallel/dist.py's `active()`), p is
a rank's shard and every BatchNorm statistic is over the global batch.
The plain versions sum their partial sums over the ranks
(`layers.batch_stats`); the kernels run stage by stage through the
per-stage C entries (`_spmd_fwd`, `_spmd_bwd`), the sums over the ranks
between the stages taking the place of the TPU kernel's remote copies
(`_global_stat_sums`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...parallel import dist
from ..layers import batch_stats, update_running_stats
from . import build

BN_EPS = 1e-5  # ops/layers.py BatchNorm
EPS = 1e-6     # coupling eps (models/flows.py)
MAX_F = 64     # widest conditioner the kernels' shared-memory layout takes

_HEADS = ("logvar", "mu")
_KERNEL_KEYS = ("w0", "bn0_scale", "bn0_bias", "w1", "w2", "b2")


# --------------------------------------------------------------------- #
# packing                                                               #
# --------------------------------------------------------------------- #

def _head_raw(coupling, head: str):
    t0 = getattr(coupling, f"T_{head}_0")
    sd0 = getattr(t0, f"{head}_sd0")
    bn0 = getattr(t0, f"{head}_sd0_bn")
    sd1 = getattr(t0, f"{head}_sd1")
    sd2 = getattr(getattr(coupling, f"T_{head}_1"), f"{head}_sd2")
    lead, f = sd1.weight.shape[:-2], sd1.weight.shape[-1]
    # zero-filled scatters (slices, so no index is copied from the host):
    # their autograd maps the kernel's dense gradients back onto the
    # modules' parameters
    w0 = sd0.weight.new_zeros(*lead, f, 3)
    w0[..., coupling._keep] = sd0.weight
    w2 = sd2.weight.new_zeros(*lead, 3, f)
    w2[..., coupling._warp, :] = sd2.weight
    b2 = sd2.bias.new_zeros(*lead, 3)
    b2[..., coupling._warp] = sd2.bias
    return w0, bn0.weight, bn0.bias, sd1.weight, w2, b2


def pack_point_decoder_train(decoder) -> Dict[str, torch.Tensor]:
    """Stack a K-stacked PointDecoderFlow's raw parameters into the packed
    arrays above. Differentiable: gradients of the packed arrays flow to
    the decoder's parameters."""
    if len(decoder.stack) != 1:
        raise ValueError("pack_point_decoder_train takes a decoder with one "
                         f"stack axis (K,), got {decoder.stack}")
    names = _KERNEL_KEYS
    films = ("film_k0", "film_scale", "film_bias", "film_k1", "film_b1")
    acc = {k: [] for k in names + films}
    for coupling in decoder.couplings():
        heads = [_head_raw(coupling, h) for h in _HEADS]
        for i, name in enumerate(names):
            acc[name].append(torch.stack([hd[i] for hd in heads], 1))
        nets = [getattr(coupling, f"T_{h}_0_cond_{n}")
                for h in _HEADS for n in ("w", "b")]
        parts = []
        for net in nets:
            s = net.short
            lin0, bn, lin1 = (getattr(net, f"{s}0"), getattr(net, f"{s}0_bn"),
                              getattr(net, f"{s}1"))
            parts.append((lin0.weight, bn.weight, bn.bias, lin1.weight,
                          lin1.bias))
        for i, name in enumerate(films):
            acc[name].append(torch.stack([pt[i] for pt in parts], 1))
    return {k: torch.stack(v, 1) for k, v in acc.items()}


def film_ab_train(packed: Dict[str, torch.Tensor], g: torch.Tensor):
    """Train-mode FiLM affines for g (B, G): ab (K, B, C, 2, 2f) and the
    FiLM BatchNorms' batch (mean, biased var), each (K, C, 4, f), over B,
    or inside a process group over the global batch of every rank's B
    clouds."""
    h = torch.einsum("bg,kcjfg->kbcjf", g, packed["film_k0"])
    mean, var = batch_stats(h, (1,))
    n = (h - mean[:, None]) * torch.rsqrt(var[:, None] + BN_EPS)
    n = n * packed["film_scale"][:, None] + packed["film_bias"][:, None]
    y = torch.einsum("kbcjf,kcjef->kbcje", F.silu(n), packed["film_k1"])
    y = y + packed["film_b1"][:, None]               # (K, B, C, 4, f)
    fw = EPS + torch.exp(y[..., 0::2, :])            # (K, B, C, 2, f)
    fb = y[..., 1::2, :]
    ab = torch.stack([fw.flatten(-2), fb.flatten(-2)], -2)
    return ab, (mean.detach(), var.detach())


@torch.no_grad()
def decoder_stats_update(decoder, stats: torch.Tensor, film_stats,
                         n_sd: int, n_film: int) -> None:
    """Blend the batch statistics of a train-mode decode into the
    decoder's BatchNorm running statistics, as BatchNorm does in training
    mode: stats (K, C, 4, 2f) from fused_train_decode over n_sd = B * N
    points, film_stats from film_ab_train over n_film = B clouds."""
    f = stats.shape[-1] // 2
    fmean, fvar = film_stats
    groups = {"sd": ([], [], []), "film": ([], [], [])}
    for c, coupling in enumerate(decoder.couplings()):
        for hi, head in enumerate(_HEADS):
            sl = slice(hi * f, (hi + 1) * f)
            t0 = getattr(coupling, f"T_{head}_0")
            for bn_name, row in (("sd0_bn", 0), ("sd1_bn", 2)):
                bns, means, vs = groups["sd"]
                bns.append(getattr(t0, f"{head}_{bn_name}"))
                means.append(stats[:, c, row, sl])
                vs.append(stats[:, c, row + 1, sl])
            for ni, n in enumerate(("w", "b")):
                net = getattr(coupling, f"T_{head}_0_cond_{n}")
                bns, means, vs = groups["film"]
                bns.append(getattr(net, f"{net.short}0_bn"))
                means.append(fmean[:, c, 2 * hi + ni])
                vs.append(fvar[:, c, 2 * hi + ni])
    update_running_stats(*groups["sd"], n_sd)
    update_running_stats(*groups["film"], n_film)


# --------------------------------------------------------------------- #
# plain versions                                                        #
# --------------------------------------------------------------------- #

def _coupling_train(x, w0, s0, b0, w1, w2, b2, fw, fb):
    """One train-mode inverse coupling of all K components.

    x (K, B, 3, N); w0 (K, 2, f, 3); s0, b0 (K, 2, f); w1 (K, 2, f, f);
    w2 (K, 2, 3, f); b2 (K, 2, 3); fw, fb (K, B, 2, f). Returns
    (x_out, logvar, [mean0, var0, mean1, var1] each (K, 2, f)), each
    statistic of h (K, B, 2, f, N) over its batch and points."""
    def col(t):  # (K, 2, f) -> broadcast over (K, B, 2, f, N)
        return t[:, None, :, :, None]

    h0 = torch.einsum("khfi,kbin->kbhfn", w0, x)
    mean0, var0 = batch_stats(h0, (1, 4))
    n0 = (h0 - col(mean0)) * torch.rsqrt(col(var0) + BN_EPS)
    a = F.relu(n0 * col(s0) + col(b0))
    h2 = torch.einsum("khoi,kbhin->kbhon", w1, a)
    mean1, var1 = batch_stats(h2, (1, 4))
    n1 = (h2 - col(mean1)) * torch.rsqrt(col(var1) + BN_EPS)
    fz = F.relu(fw[..., None] * n1 + fb[..., None])
    y = torch.einsum("khjf,kbhfn->kbhjn", w2, fz) + b2[:, None, :, :, None]
    logvar = F.softsign(y[:, :, 0])
    scale = torch.sqrt(EPS + torch.exp(logvar))
    return (x - y[:, :, 1]) / scale, logvar, (mean0, var0, mean1, var1)


def _coupling_args(ws, ab, c):
    K, B = ab.shape[:2]
    f = ws[3].shape[-1]
    abc = ab[:, :, c].reshape(K, B, 2, 2, f)
    return [w[:, c] for w in ws] + [abc[:, :, 0], abc[:, :, 1]]


def train_decode_fwd_plain(packed, ab, p):
    """Plain PyTorch version of kernel 7: p (K, B, 3, N) through all C
    couplings in inverse order with train-mode BatchNorm. Returns
    (p0, logvar_sum, xsave (K, C, B, 3, N) = each coupling's input,
    stats (K, C, 4, 2f)). Inside a process group (parallel/dist.py), p is
    this rank's shard and the statistics are over the global batch."""
    ws = [packed[k] for k in _KERNEL_KEYS]
    K, C = ws[3].shape[:2]
    f = ws[3].shape[-1]
    x = p
    lv = torch.zeros_like(p)
    xsave = p.new_empty((K, C) + tuple(p.shape[1:]))
    stats = p.new_empty(K, C, 4, 2 * f)
    for c in reversed(range(C)):
        xsave[:, c] = x
        x, logvar, st = _coupling_train(x, *_coupling_args(ws, ab, c))
        lv = lv + logvar
        stats[:, c] = torch.stack([s.reshape(K, 2 * f) for s in st], 1)
    return x, lv, xsave, stats


def train_decode_bwd_plain(packed, ab, xsave, stats, dp0, dlv):
    """Plain PyTorch version of kernel 8: the gradients of
    sum(p0 * dp0) + sum(lv * dlv) with respect to p, the packed arrays
    and ab. Recomputes one coupling at a time from its saved input
    `xsave[:, c]` under autograd, its batch statistics recomputed from
    that input (so the BatchNorm batch-statistic terms are exact), in
    direct order; `stats` is not read. Returns (dp, d_packed (the six
    kernel arrays), dab). Inside a process group, the statistics are over
    the global batch (their cotangents summed over the ranks by
    `dist.sum_over_ranks`'s backward) and d_packed holds this rank's share
    of the gradients, which the optimizer sums over the ranks."""
    ws = [packed[k].detach() for k in _KERNEL_KEYS]
    ab = ab.detach()
    K, B, C = ab.shape[:3]
    f = ws[3].shape[-1]
    dx = dp0
    grads = {k: torch.zeros_like(w) for k, w in zip(_KERNEL_KEYS, ws)}
    dab = torch.zeros_like(ab)
    for c in range(C):
        with torch.enable_grad():
            x = xsave[:, c].detach().requires_grad_()
            args = [t.requires_grad_() for t in
                    (w[:, c].clone() for w in ws)]
            abc = ab[:, :, c].clone().requires_grad_()
            ab6 = abc.reshape(K, B, 2, 2, f)
            x_out, logvar, _ = _coupling_train(x, *args, ab6[:, :, 0],
                                               ab6[:, :, 1])
            got = torch.autograd.grad((x_out, logvar), [x, *args, abc],
                                      (dx, dlv))
        dx = got[0]
        for k, g in zip(_KERNEL_KEYS, got[1:-1]):
            grads[k][:, c] = g
        dab[:, :, c] = got[-1]
    return dx, grads, dab


# --------------------------------------------------------------------- #
# kernels                                                               #
# --------------------------------------------------------------------- #

def _check(packed, ab, p, what):
    K, B, _, N = p.shape
    C, f = packed["w1"].shape[1], packed["w1"].shape[-1]
    shapes = {"w0": (K, C, 2, f, 3), "bn0_scale": (K, C, 2, f),
              "bn0_bias": (K, C, 2, f), "w1": (K, C, 2, f, f),
              "w2": (K, C, 2, 3, f), "b2": (K, C, 2, 3)}
    for name, shape in shapes.items():
        if tuple(packed[name].shape) != shape:
            raise ValueError(f"{what}: {name} shape "
                             f"{tuple(packed[name].shape)}, expected {shape}")
    if tuple(ab.shape) != (K, B, C, 2, 2 * f):
        raise ValueError(f"{what}: ab shape {tuple(ab.shape)}, expected "
                         f"{(K, B, C, 2, 2 * f)}")
    if not 1 <= f <= MAX_F:
        raise ValueError(f"{what}: f={f} outside 1..{MAX_F}: the kernels' "
                         "shared-memory layout takes at most "
                         f"{MAX_F} features")
    if min(K, B, N, C) < 1 or max(K, B) > 65535 or 2 * f * N >= 2**31:
        raise ValueError(f"{what}: (K={K}, B={B}, C={C}, N={N}) outside "
                         "the kernels' launch limits (and 32-bit offsets "
                         "within a cloud's 2f x N cache block)")
    build.check_tensors([p, ab] + [packed[k] for k in _KERNEL_KEYS],
                        p.device)
    return K, B, C, N, f


def train_decode_fwd(packed, ab, p):
    """Kernel 7 on a CUDA tensor, its plain version on a CPU tensor.
    Returns (p0, logvar_sum, xsave, stats) as train_decode_fwd_plain.
    Inside a process group of several ranks (parallel/dist.py), p is this
    rank's shard and the statistics are over the global batch: the kernel
    runs in its SPMD form, stage by stage (`_spmd_fwd`); in one process,
    in one C call."""
    if p.device.type == "cpu":
        return train_decode_fwd_plain(packed, ab, p)
    K, B, C, N, f = _check(packed, ab, p, "train_decode_fwd")
    p0 = torch.empty_like(p)
    lv = torch.empty_like(p)
    xsave = p.new_empty(K, C, B, 3, N)
    stats = p.new_empty(K, C, 4, 2 * f)
    lib = build.library()
    work = p.new_empty(lib.gwtf_train_decode_workspace(0, K, B, C, N, f))
    args = [p] + [packed[k] for k in _KERNEL_KEYS] + [ab, p0, lv, xsave,
                                                     stats, work]
    stream = build.stream_handle(p.device)
    with torch.cuda.device(p.device):
        if dist.active():
            _drive(_spmd_fwd(lib, args, (K, B, C, N, f),
                             dist.world_size() * B * N, stream))
            train_decode_fwd.spmd_launches += 1
        else:
            code = lib.gwtf_train_decode_fwd(
                *(t.data_ptr() for t in args), K, B, C, N, f, stream)
            build.check(lib, code, "train_decode_fwd")
    train_decode_fwd.launches += 1
    return p0, lv, xsave, stats


# launches, and of them those in the SPMD form
train_decode_fwd.launches = 0
train_decode_fwd.spmd_launches = 0


def _drive(stages) -> None:
    """Run an SPMD host loop (`_spmd_fwd`, `_spmd_bwd`): each partial-sum
    tensor it yields is summed over the ranks, and the global sum goes
    back to it."""
    sums = next(stages)
    try:
        while True:
            sums = stages.send(dist.sum_over_ranks(sums))
    except StopIteration:
        pass


def _spmd_fwd(lib, args, dims, n, stream):
    """Kernel 7's SPMD form as a generator over its exchange points:
    `args` the tensors of gwtf_train_decode_fwd in order, `dims` (K, B, C,
    N, f) of this rank's shard, `n` the points of a component over all
    the ranks. It yields this rank's partial sums, (K, 9) moments or
    (K, 4f) h2 sums in float64, and is sent back their sum over the ranks;
    the stages are queued on `stream`."""
    K, B, C, N, f = dims
    ptrs = [t.data_ptr() for t in args]
    device = args[0].device
    mom = torch.empty(K, 9, dtype=torch.float64, device=device)
    h2 = torch.empty(K, 4 * f, dtype=torch.float64, device=device)

    def stage(which, c, sums_in, sums_out):
        code = lib.gwtf_train_decode_fwd_stage(
            which, c, float(n), *ptrs,
            None if sums_in is None else sums_in.data_ptr(),
            sums_out.data_ptr(), K, B, C, N, f, stream)
        build.check(lib, code, f"train_decode_fwd stage {which}")

    stage(0, 0, None, mom)
    glob = yield mom
    for c in reversed(range(C)):
        stage(1, c, glob, h2)
        glob = yield h2
        stage(2, c, glob, mom)
        if c:
            glob = yield mom


def _spmd_bwd(lib, args, dims, n, stream):
    """Kernel 8's SPMD form as a generator over its exchange points, as
    `_spmd_fwd`: `args` the tensors of gwtf_train_decode_bwd in order (its
    workspace gwtf_train_decode_workspace(2, ...) floats). Per coupling it
    yields the (K, 4f) sums [dn1 | dn1 n1] and then [db0 | ds0] of its
    BatchNorms' cotangents. The weight gradients it writes, the bn0 bias
    and scale ones included, are this rank's partial sums."""
    K, B, C, N, f = dims
    ptrs = [t.data_ptr() for t in args]
    device = args[0].device
    sums = [torch.empty(K, 4 * f, dtype=torch.float64, device=device)
            for _ in range(2)]

    def stage(which, c, sums_in, sums_out):
        code = lib.gwtf_train_decode_bwd_stage(
            which, c, float(n), *ptrs,
            None if sums_in is None else sums_in.data_ptr(),
            None if sums_out is None else sums_out.data_ptr(),
            K, B, C, N, f, stream)
        build.check(lib, code, f"train_decode_bwd stage {which}")

    stage(0, 0, None, None)
    for c in range(C):
        stage(1, c, None, sums[0])
        glob = yield sums[0]
        stage(2, c, glob, sums[1])
        glob = yield sums[1]
        stage(3, c, glob, None)


def train_decode_bwd(packed, ab, xsave, stats, dp0, dlv):
    """Kernel 8 on a CUDA tensor, its plain version on a CPU tensor.
    Returns (dp, d_packed, dab) as train_decode_bwd_plain; inside a
    process group of several ranks, in its SPMD form (`_spmd_bwd`)."""
    if dp0.device.type == "cpu":
        return train_decode_bwd_plain(packed, ab, xsave, stats, dp0, dlv)
    K, B, C, N, f = _check(packed, ab, dp0, "train_decode_bwd")
    for t, shape in ((xsave, (K, C, B, 3, N)), (stats, (K, C, 4, 2 * f)),
                     (dlv, (K, B, 3, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"train_decode_bwd: shape {tuple(t.shape)}, "
                             f"expected {shape}")
    build.check_tensors([xsave, stats, dlv], dp0.device)
    ws = [packed[k] for k in _KERNEL_KEYS]
    dp = torch.empty_like(dp0)
    grads = {k: torch.empty_like(w) for k, w in zip(_KERNEL_KEYS, ws)}
    dab = torch.empty_like(ab)
    lib = build.library()
    spmd = dist.active()
    work = dp0.new_empty(lib.gwtf_train_decode_workspace(
        2 if spmd else 1, K, B, C, N, f))
    args = ([xsave, stats] + ws + [ab, dp0, dlv, dp]
            + [grads[k] for k in _KERNEL_KEYS] + [dab, work])
    stream = build.stream_handle(dp0.device)
    with torch.cuda.device(dp0.device):
        if spmd:
            _drive(_spmd_bwd(lib, args, (K, B, C, N, f),
                             dist.world_size() * B * N, stream))
            train_decode_bwd.spmd_launches += 1
        else:
            code = lib.gwtf_train_decode_bwd(
                *(t.data_ptr() for t in args), K, B, C, N, f, stream)
            build.check(lib, code, "train_decode_bwd")
    train_decode_bwd.launches += 1
    return dp, grads, dab


train_decode_bwd.launches = 0
train_decode_bwd.spmd_launches = 0


class _FusedTrainDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w0, s0, b0, w1, w2, b2, ab, p):
        packed = dict(zip(_KERNEL_KEYS, (w0, s0, b0, w1, w2, b2)))
        p0, lv, xsave, stats = train_decode_fwd(packed, ab, p)
        ctx.save_for_backward(w0, s0, b0, w1, w2, b2, ab, xsave, stats)
        ctx.mark_non_differentiable(stats)
        return p0, lv, stats

    @staticmethod
    def backward(ctx, dp0, dlv, _dstats):
        *ws, ab, xsave, stats = ctx.saved_tensors
        ref = xsave[:, 0]
        dp0 = torch.zeros_like(ref) if dp0 is None else dp0.contiguous()
        dlv = torch.zeros_like(ref) if dlv is None else dlv.contiguous()
        packed = dict(zip(_KERNEL_KEYS, ws))
        dp, grads, dab = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv)
        return (*(grads[k] for k in _KERNEL_KEYS), dab, dp)


def fused_train_decode(packed: Dict[str, torch.Tensor], ab: torch.Tensor,
                       p: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode inverse decode of p (K, B, 3, N) through every coupling:
    (p0, logvar_sum, stats). Forward kernel 7, backward kernel 8 on CUDA
    tensors; the plain versions on CPU tensors. Differentiable in the
    packed kernel arrays, ab and p; stats is not. Inside a process group
    (parallel/dist.py), p is this rank's shard of the global batch, whose
    BatchNorm statistics both directions use."""
    return _FusedTrainDecode.apply(
        *(packed[k] for k in _KERNEL_KEYS), ab, p)
