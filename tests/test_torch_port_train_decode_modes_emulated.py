"""Kernels 7 and 8 at 'high' and 'fast' from their CUDA source, built by
g++ against the CPU stand-in for CUDA and run on the CPU (the build and
the helpers of tests/test_torch_port_train_decode_emulated.py, which
holds the 'highest' cases; this file builds its own library, so that the
two files run on two workers of the suite).

The 'fast' instantiations (MODE 2: bf16-rounded operands, fp32 sums; the
weights rounded by `kernel_weights_train`) and the 'high' ones (MODE 1:
three bf16 products of the operands' hi and lo parts, the weights split
by `kernel_weights_train`) run against the plain versions of their mode
at f=5 (padded to 8: the product's last depth step half padding) and
f=33 (padded to 40) with N=600 (ragged 128-point tiles and 512-point
segments), with the mode in force (their effect against the plain
versions'), and in their SPMD form against the single entries; the entry
points take the mode before the stream. Their W1 products run on the
tensor-core step of csrc/mma_bf16.cuh, whose emulation forms each lane's
accumulators from the shared tiles: kernel 8's head, B1 and B2, and
kernel 7's hidden pass and its update pass, which replays h2 from x (no
h2 cache at these modes: the forward's workspace is smaller than at
'highest' by exactly that cache)."""

import pytest
import torch

from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
    _KERNEL_KEYS,
    _spmd_bwd,
    _spmd_fwd,
    kernel_weights_train,
    train_decode_bwd_plain,
    train_decode_fwd_plain,
)
from test_torch_port_train_decode_emulated import (
    _inputs,
    _lockstep,
    _rel_err,
    _shards,
    load_emulated,
)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return load_emulated(tmp_path_factory)


FAST = 2  # the kernels' MODE for 'fast' (point_decode.KERNEL_MODES)
HIGH = 1


def _mode_weights(packed, mode):
    """The packed arrays as the kernels of `mode` read them: W1 and W2
    rounded (at 'high' split) for the forward, W0 too for the
    backward."""
    kw = kernel_weights_train(dict(packed), mode)
    fwd = [packed["w0"], packed["bn0_scale"], packed["bn0_bias"], kw["w1"],
           kw["w2"], packed["b2"]]
    return fwd, [kw["w0"]] + fwd[1:]


def _off_share(got, want, atol=1e-4):
    return ((got - want).abs() > atol).float().mean().item()


def _mode_gap(got, got_hi, want, want_hi):
    effect = want - want_hi
    return ((got - got_hi - effect).square().mean()
            / effect.square().mean()).sqrt().item()


@pytest.mark.parametrize("f,B,N", [(5, 2, 600), (33, 1, 600)])
def test_emulated_train_decode_fast(lib, f, B, N):
    """Kernels 7 and 8 at 'fast' (f=5 padded to 8, f=33 to 40, the
    flagship's instantiation; two 512-point segments, the last ragged)
    against their 'fast' plain versions. Kernel 7: p0, the logvar sum
    and the saved states atol 5e-3 with at most 5e-3 of the entries beyond
    1e-4 (two sum orders can put an operand a bf16 step apart; measured
    at most 8.3e-4 and 1.5e-3 at f=33, B=2, N=1250), the statistics rtol
    1e-3, atol 1e-4 (measured 1e-6); the mode's effect (the output less
    the 'highest' kernel's) within 0.05 of the plain version's in rms
    (measured 0.015). Kernel 8 on the plain forward's residuals of its
    mode, its W1 products on the emulated tensor-core step
    (csrc/mma_bf16.cuh): dp and every packed array's and ab's gradient
    within 1e-3 of their own largest entry (measured at most 6.9e-5), and
    the mode's effect on each within 1e-2 of the plain version's, each
    mode on its own forward's residuals (measured at most 3.7e-4; a copy
    of the source whose B1 stages dh2 unrounded for its product reads
    7.2e-3 and 0.42, one whose hidden pass leaves a unrounded fails the
    forward's bounds).
    Two launches of each give equal bits."""
    packed, ab, p = _inputs(f, B, N, f + 3)
    K, C = p.shape[0], packed["w1"].shape[1]
    fws, bws = _mode_weights(packed, "fast")
    hws = [packed[k] for k in _KERNEL_KEYS]

    def fwd(ws, mode):
        got = [torch.empty_like(p), torch.empty_like(p),
               p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(0, K, B, C, N, f, mode),),
            float("nan"))
        args = [p] + ws + [ab] + got + [work]
        assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, mode, None) == 0
        return got

    got, hi = fwd(fws, FAST), fwd(hws, 0)
    want = train_decode_fwd_plain(packed, ab, p, "fast")
    want_hi = train_decode_fwd_plain(packed, ab, p, "highest")
    for i in range(3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=5e-3)
        assert _off_share(got[i], want[i]) <= 5e-3
    for i in range(2):
        assert _mode_gap(got[i], hi[i], want[i], want_hi[i]) <= 0.05
    torch.testing.assert_close(got[3], want[3], rtol=1e-3, atol=1e-4)
    for a, b in zip(got, fwd(fws, FAST)):
        assert torch.equal(a, b)

    _, _, xsave, stats = want
    gen = torch.Generator().manual_seed(f)
    dp0 = torch.randn(p.shape, generator=gen)
    dlv = torch.randn(p.shape, generator=gen)

    def bwd(ws, mode, xsave, stats):
        out = [torch.empty_like(dp0)] + [torch.empty_like(w) for w in hws] + [
            torch.empty_like(ab)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(1, K, B, C, N, f, mode),),
            float("nan"))
        args = [xsave, stats] + ws + [ab, dp0, dlv] + out + [work]
        assert lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, mode, None) == 0
        return out

    kb = bwd(bws, FAST, xsave, stats)
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv, "fast")
    # the 'highest' effect's base: each version on its own forward's
    # residuals
    kb_hi = bwd(hws, 0, *hi[2:])
    dp_hi, grads_hi, dab_hi = train_decode_bwd_plain(
        packed, ab, *want_hi[2:], dp0, dlv, "highest")
    plain = [dp] + [grads[k] for k in _KERNEL_KEYS] + [dab]
    plain_hi = [dp_hi] + [grads_hi[k] for k in _KERNEL_KEYS] + [dab_hi]
    for a, b, a_hi, b_hi in zip(kb, plain, kb_hi, plain_hi):
        assert _rel_err(a, b) < 1e-3
        assert _mode_gap(a, a_hi, b, b_hi) <= 1e-2
    for a, b in zip(kb, bwd(bws, FAST, xsave, stats)):
        assert torch.equal(a, b)


def _spmd_mode(lib, mode, atol, off_share, stats_rtol, dp_rel, grad_rel):
    """Kernels 7 and 8 in `mode` in their SPMD form on two shards (f=13,
    B=4, N=130) against the single entries in `mode` on the whole batch:
    p0, the logvar sum and the saved states within `atol` with at most
    `off_share` of them beyond 1e-4, the statistics `stats_rtol` (atol
    1e-4); dp within `dp_rel`, the weight gradients summed over the
    shards and dab within `grad_rel`, each of its largest entry."""
    code = {"high": HIGH, "fast": FAST}[mode]
    f, B, N = 13, 4, 130
    packed, ab, p = _inputs(f, B, N, f + 4)
    K, C = p.shape[0], packed["w1"].shape[1]
    fws, bws = _mode_weights(packed, mode)
    hws = [packed[k] for k in _KERNEL_KEYS]
    whole = [torch.empty_like(p), torch.empty_like(p),
             p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
    work = torch.full(
        (lib.gwtf_train_decode_workspace(0, K, B, C, N, f, code),),
        float("nan"))
    args = [p] + fws + [ab] + whole + [work]
    assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B, C,
                                     N, f, code, None) == 0
    fwd, gens = [], []
    for ps, abs_ in zip(_shards(p, 1, B), _shards(ab, 1, B)):
        b = ps.shape[1]
        out = [torch.empty_like(ps), torch.empty_like(ps),
               p.new_empty(K, C, b, 3, N), p.new_empty(K, C, 4, 2 * f)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(0, K, b, C, N, f, code),),
            float("nan"))
        fwd.append(out)
        gens.append(_spmd_fwd(lib, [ps] + fws + [abs_] + out + [work],
                              (K, b, C, N, f), B * N, None, code))
    _lockstep(gens)
    for i, dim in enumerate((1, 1, 2)):
        got = torch.cat([o[i] for o in fwd], dim)
        torch.testing.assert_close(got, whole[i], rtol=0, atol=atol)
        assert _off_share(got, whole[i]) <= off_share
    for o in fwd:
        torch.testing.assert_close(o[3], whole[3], rtol=stats_rtol,
                                   atol=1e-4)

    _, _, xsave, stats = whole
    gen = torch.Generator().manual_seed(f)
    dp0 = torch.randn(p.shape, generator=gen)
    dlv = torch.randn(p.shape, generator=gen)
    want = [torch.empty_like(dp0)] + [torch.empty_like(w) for w in hws] + [
        torch.empty_like(ab)]
    work = torch.full(
        (lib.gwtf_train_decode_workspace(1, K, B, C, N, f, code),),
        float("nan"))
    args = [xsave, stats] + bws + [ab, dp0, dlv] + want + [work]
    assert lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B, C,
                                     N, f, code, None) == 0
    bwd, gens = [], []
    for xs, abs_, d0, dl in zip(_shards(xsave, 2, B), _shards(ab, 1, B),
                                _shards(dp0, 1, B), _shards(dlv, 1, B)):
        b = d0.shape[1]
        out = [torch.empty_like(d0)] + [torch.full_like(w, float("nan"))
                                        for w in hws] + [
            torch.empty_like(abs_)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(2, K, b, C, N, f, code),),
            float("nan"))
        bwd.append(out)
        gens.append(_spmd_bwd(lib, [xs, stats] + bws + [abs_, d0, dl] + out
                              + [work], (K, b, C, N, f), B * N, None, code))
    _lockstep(gens)
    assert _rel_err(torch.cat([o[0] for o in bwd], 1), want[0]) < dp_rel
    for i, k in enumerate(_KERNEL_KEYS, 1):
        assert _rel_err(bwd[0][i] + bwd[1][i], want[i]) < grad_rel, k
    assert _rel_err(torch.cat([o[-1] for o in bwd], 1), want[-1]) < grad_rel


def test_emulated_train_decode_spmd_fast(lib):
    """Kernels 7 and 8 at 'fast' in their SPMD form against the single
    entries (`_spmd_mode`), with test_emulated_train_decode_fast's bounds
    (the shards' sums come in another order, which can move an operand a
    bf16 step)."""
    _spmd_mode(lib, "fast", 5e-3, 5e-3, 1e-3, 1e-2, 3e-2)



# ------------------------------------------------------------------ #
# 'high' (MODE 1)                                                     #
# ------------------------------------------------------------------ #

# 'high' against its plain version: kernel 7's p0, logvar sum and saved
# states atol, its statistics rtol (atol 1e-5), kernel 8's bound relative
# to each output's largest entry by f, and the mode's effect on each (as
# _mode_gap) for kernel 7 and for kernel 8
HIGH_FWD_ATOL = 5e-5
HIGH_STATS_RTOL = 2e-4
HIGH_BWD_REL = {5: 4e-6, 33: 1.2e-5}
HIGH_FWD_GAP = 0.5
HIGH_BWD_GAP = 0.05


@pytest.mark.parametrize("f,B,N", [(5, 2, 600), (33, 1, 600)])
def test_emulated_train_decode_high(lib, f, B, N):
    """Kernels 7 and 8 at 'high' (the hi parts of W0, W1 and W2 followed
    by their lo parts, `kernel_weights_train`; x, a, fz, dy, dh2 and dh0
    split in the kernels) against their 'high' plain versions, at f=5
    (padded to 8) and f=33 (to 40), two 512-point segments, the last
    ragged. Measured: kernel 7's outputs within 7.0e-6 (its 'highest'
    instantiation 2.4e-7 off its own plain version; the mode's effect
    itself 1.1e-5 to 1.7e-5), the statistics within 4.3e-5 relative, the
    mode's effect within 0.08-0.23 of the plain version's (a kernel that
    ignores the mode reads 1); kernel 8, its W1 products three bf16
    products on the emulated tensor-core step, within 1.7e-6 (f=5) and
    3.9e-6 (f=33) of each output's largest entry, its effect of the mode
    within 1.2e-2 (the effect itself 3e-5 to 2e-2). HIGH_FWD_ATOL and the
    others hold them with a margin of 3 to 7, HIGH_BWD_REL of 2.4 and
    3.1. Two launches give equal bits. Copies of the source with a
    product's operand wrong fail: one whose hidden pass drops lo(W1) hi(a)
    misses the forward's bounds (a third of p0 off by more than 5e-5),
    one whose B1 stages dh2 as its fp32 word for its product, not as its
    packed parts (the step reads the word's low mantissa bits as lo),
    gives NaN."""
    packed, ab, p = _inputs(f, B, N, f + 5)
    K, C = p.shape[0], packed["w1"].shape[1]
    fws, bws = _mode_weights(packed, "high")
    hws = [packed[k] for k in _KERNEL_KEYS]

    def fwd(ws, mode):
        got = [torch.empty_like(p), torch.empty_like(p),
               p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(0, K, B, C, N, f, mode),),
            float("nan"))
        args = [p] + ws + [ab] + got + [work]
        assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, mode, None) == 0
        return got

    got, hi = fwd(fws, HIGH), fwd(hws, 0)
    want = train_decode_fwd_plain(packed, ab, p, "high")
    want_hi = train_decode_fwd_plain(packed, ab, p, "highest")
    for i in range(3):
        torch.testing.assert_close(got[i], want[i], rtol=0,
                                   atol=HIGH_FWD_ATOL)
    for i in range(2):
        assert _mode_gap(got[i], hi[i], want[i], want_hi[i]) <= HIGH_FWD_GAP
    torch.testing.assert_close(got[3], want[3], rtol=HIGH_STATS_RTOL,
                               atol=1e-5)
    for a, b in zip(got, fwd(fws, HIGH)):
        assert torch.equal(a, b)

    _, _, xsave, stats = want
    gen = torch.Generator().manual_seed(f)
    dp0 = torch.randn(p.shape, generator=gen)
    dlv = torch.randn(p.shape, generator=gen)

    def bwd(ws, mode, xsave, stats):
        out = [torch.empty_like(dp0)] + [torch.empty_like(w) for w in hws] + [
            torch.empty_like(ab)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(1, K, B, C, N, f, mode),),
            float("nan"))
        args = [xsave, stats] + ws + [ab, dp0, dlv] + out + [work]
        assert lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, mode, None) == 0
        return out

    kb = bwd(bws, HIGH, xsave, stats)
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv, "high")
    kb_hi = bwd(hws, 0, *hi[2:])
    dp_hi, grads_hi, dab_hi = train_decode_bwd_plain(
        packed, ab, *want_hi[2:], dp0, dlv, "highest")
    plain = [dp] + [grads[k] for k in _KERNEL_KEYS] + [dab]
    plain_hi = [dp_hi] + [grads_hi[k] for k in _KERNEL_KEYS] + [dab_hi]
    for a, b, a_hi, b_hi in zip(kb, plain, kb_hi, plain_hi):
        assert _rel_err(a, b) < HIGH_BWD_REL[f]
        assert _mode_gap(a, a_hi, b, b_hi) <= HIGH_BWD_GAP
    for a, b in zip(kb, bwd(bws, HIGH, xsave, stats)):
        assert torch.equal(a, b)


def test_emulated_train_decode_spmd_high(lib):
    """Kernels 7 and 8 at 'high' in their SPMD form against the single
    entries at 'high' (`_spmd_mode`): the saved states within 1e-5
    (measured 2.0e-6), the statistics rtol 1e-4 (measured 3.6e-5 of the
    larger of the value and 1e-4), dp and the gradients within 1e-6
    (measured 0 and 7e-8)."""
    _spmd_mode(lib, "high", 1e-5, 0.0, 1e-4, 1e-6, 1e-6)


@pytest.mark.parametrize("mode", ["high", "fast"])
@pytest.mark.parametrize("f,B,N", [(5, 2, 600), (33, 1, 600)])
def test_emulated_train_decode_fwd_workspace(lib, mode, f, B, N):
    """Kernel 7's workspace at 'high' and 'fast' is smaller than at
    'highest' by exactly the h2 cache, K B 2f pitch floats (pitch = N
    rounded up to a multiple of 4), and the forward needs no more: run on
    exactly its workspace, followed by a guard of sentinels, it leaves the
    guard as it was and gives the bits it gives on a workspace of the
    'highest' size. The backward's workspaces do not depend on the
    mode."""
    code = {"high": HIGH, "fast": FAST}[mode]
    packed, ab, p = _inputs(f, B, N, f + 6)
    K, C = p.shape[0], packed["w1"].shape[1]
    fws, _ = _mode_weights(packed, mode)
    size = lib.gwtf_train_decode_workspace(0, K, B, C, N, f, code)
    full = lib.gwtf_train_decode_workspace(0, K, B, C, N, f, 0)
    assert full - size == K * B * 2 * f * ((N + 3) // 4 * 4)
    for which in (1, 2):
        assert (lib.gwtf_train_decode_workspace(which, K, B, C, N, f, code)
                == lib.gwtf_train_decode_workspace(which, K, B, C, N, f, 0))

    def fwd(n_work, guard):
        got = [torch.empty_like(p), torch.empty_like(p),
               p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
        work = torch.full((n_work + guard,), float("nan"))
        work[n_work:] = 12345.0
        args = [p] + fws + [ab] + got + [work]
        assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, code, None) == 0
        assert torch.all(work[n_work:] == 12345.0)
        return got

    for a, b in zip(fwd(size, 4096), fwd(full, 0)):
        assert torch.equal(a, b)
