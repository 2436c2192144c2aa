"""Training in the 'fast' and 'high' matmul precision modes
(ops/precision.py): the products' gradients, the plain versions of
kernels 7 and 8 in both modes, the train step, the training CLIs and
tools/train_quality_ab.py, on the CPU.

- (a) `mxdot`'s and the ResNet Conv2d's gradients in each mode against a
  float64 numpy emulation of the TPU's transposed passes on ml_dtypes
  bf16 operands (XLA:CPU ignores a plain dot's precision, so JAX's own
  gradients are no oracle here): dA = dY B^T and dB = A^T dY, dx and dW
  of the convolution, each a product of the mode from the cotangent and
  the operands rounded (or split) anew, with fp32 sums. rtol 1e-5, atol
  1e-6 of the gradient's scale. At 'highest' the gradients equal
  torch.matmul's and the plain convolution's bit for bit. The form
  before the repair (the operands rounded by casts that autograd carries
  back, which rounds the gradient's result instead) misses the
  emulation by more than 100 times the tolerance.
- (b) the plain kernel 7 and kernel 8 at 'fast' (`train_decode_fwd_plain`,
  `train_decode_bwd_plain`) against JAX `fused_train_decode(...,
  interpret=True, precision_mode="fast")` and its `jax.vjp` (K=2, B=4,
  N=50, f=6, 2 flows, weights moved off their init). XLA:CPU's dot
  thunk takes no bf16 x bf16 -> fp32 product in some of the transposed
  layouts of the JAX kernel's backward, so the JAX kernels run with their
  `_mxdot` at 'fast' replaced (in this test's process only) by the same
  product of the bf16-rounded operands upcast to fp32: exact products,
  fp32 sums, what the MXU computes (the forward gives the same bits
  either way). p0 and the logvar sum atol 1e-3 (measured 8.5e-5 and
  2.7e-4, against 8e-7 at 'highest': where two fp32 sum orders put an
  operand on either side of a bf16 rounding boundary, it moves a bf16
  step), the batch statistics atol 5e-6 (measured 9.7e-7); dp, every
  weight gradient and dab within 1e-2 of their own largest entry
  (measured at most 2.7e-3, against 6.8e-4 at 'highest', where the gap
  is JAX's bf16 copy of n1 for its passes B and C: the port keeps n1 in
  fp32 in every mode). The same at 'high', where XLA:CPU runs JAX's
  three bf16 products as they are: p0 and the logvar sum atol 3e-5
  (measured 5.8e-6 and 5.5e-6, against 8.3e-7 and 2.2e-7 at 'highest'),
  the statistics atol 2e-6 (measured 3.7e-7), kernel 8 within 3e-3
  (measured at most 6.8e-4, as at 'highest': n1's bf16 copy).
- (c) the mode is in force: on p0 and on dW1 the port's effect of the
  mode (its output less its 'highest' output) within EFFECT_GAP of
  JAX's in rms over the effect's rms. At 'fast' within 0.05 (measured
  1.8e-3 and 2.4e-2; the effect itself is 1.2e-2 on p0 and 9.8e-2 of
  dW1's largest entry). At 'high' the effect is near fp32 roundoff: on
  p0 2.7e-6 in rms (2.1e-5 at most), 20 times the 'highest' gap between
  the port and JAX (1.3e-7 in rms), measured 0.21 away (bound 0.5); on
  dW1 6.0e-5 in rms, below the 'highest' gap (7.7e-4 in rms: JAX's bf16
  n1), which cancels between the modes, measured 0.43 away (bound 0.75;
  a port that ignores the mode reads 1).
- (d) a 'fast' and a 'high' train step on the CPU (the module path) run,
  differ from the 'highest' step, and three steps lower the loss; the
  fused path's plain versions give the module path's loss within 1e-3
  and its gradient within 0.1 in norm at 'fast' (the two are not one
  function there; see the test), within 1e-6 and 1e-4 at 'high';
  fused_train_decode's backward keeps its forward's mode.
- (e) train_ae and train_svr take 'fast' and 'high' (their train and
  validation steps built in the mode), and train at 'highest' without
  the key.
- (f) tools/train_quality_ab.run at a tiny size: its three variants, the
  JAX tool's keys.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.metrics import evaluation as jev
from go_with_the_flows_tpu.data.synthetic import (
    write_synthetic_images_h5,
    write_synthetic_meshes_h5,
)
from go_with_the_flows_tpu.models.flows import PointDecoderFlow as JDecoder
from go_with_the_flows_tpu.ops.pallas import train_kernel
from go_with_the_flows_tpu.ops.pallas.train_kernel import (
    film_wb_train,
    fused_train_decode as j_fused,
    pack_point_decoder_train as j_pack,
)
from go_with_the_flows_tpu_torch.cli import train_ae, train_svr
from go_with_the_flows_tpu_torch.models.flows import PointDecoderFlow
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.models.resnet import Conv2d
from go_with_the_flows_tpu_torch.ops.kernels import train_decode as td
from go_with_the_flows_tpu_torch.ops.precision import (
    bf16_round,
    get_matmul_precision,
    matmul_precision_scope,
    mxdot,
)
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.tools import train_quality_ab
from go_with_the_flows_tpu_torch.train.step import make_train_step
from go_with_the_flows_tpu_torch.utils import flax_import as fi
from go_with_the_flows_tpu_torch.utils.config import (
    FLAGSHIP_AIRPLANE,
    write_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("highest", "high", "fast")


# ------------------------------------------------------------------ #
# (a) the products' gradients                                          #
# ------------------------------------------------------------------ #

def _bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float64)


def _emulated(a, b, mode, product):
    """product(a', b') in float64 on the operands of each pass."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    if mode == "highest":
        return product(a.astype(np.float64), b.astype(np.float64))
    if mode == "fast":
        return product(_bf16(a), _bf16(b))
    a_hi, b_hi = _bf16(a), _bf16(b)
    a_lo = _bf16((a - a_hi).astype(np.float32))
    b_lo = _bf16((b - b_hi).astype(np.float32))
    return product(a_hi, b_hi) + product(a_hi, b_lo) + product(a_lo, b_hi)


def _within(got, want):
    """|got - want| over the bounds rtol 1e-5, atol 1e-6 of want's scale:
    at most 1 passes."""
    bound = 1e-6 * np.abs(want).max() + 1e-5 * np.abs(want)
    return (np.abs(got - want) / bound).max()


def _mxdot_case():
    gen = torch.Generator().manual_seed(11)
    # a weight broadcast over the batch axis, as SharedDot forms it: its
    # gradient sums over that axis
    a = torch.randn(2, 1, 8, 16, generator=gen)
    b = torch.randn(2, 3, 16, 4, generator=gen)
    dy = torch.randn(2, 3, 8, 4, generator=gen)
    return a, b, dy


def _grads(fn, a, b, dy):
    a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
    fn(a, b).backward(dy)
    return a.grad, b.grad


@pytest.mark.parametrize("mode", MODES)
def test_mxdot_gradients_keep_the_mode(mode):
    a, b, dy = _mxdot_case()
    ga, gb = _grads(lambda x, y: mxdot(x, y, mode), a, b, dy)
    an, bn, dyn = a.numpy(), b.numpy(), dy.numpy()
    want_a = _emulated(dyn, np.swapaxes(bn, -1, -2), mode,
                       np.matmul).sum(1, keepdims=True)
    want_b = _emulated(np.swapaxes(an, -1, -2), dyn, mode, np.matmul)
    assert _within(ga.numpy(), want_a) <= 1
    assert _within(gb.numpy(), want_b) <= 1
    if mode == "highest":
        ha, hb = _grads(torch.matmul, a, b, dy)
        assert torch.equal(ga, ha) and torch.equal(gb, hb)
    if mode == "fast":
        # the form before the repair: casts that autograd carries back
        ca, cb = _grads(lambda x, y: torch.matmul(bf16_round(x),
                                                  bf16_round(y)), a, b, dy)
        assert _within(ca.numpy(), want_a) > 100
        assert _within(cb.numpy(), want_b) > 100


def _conv(x, w, stride, pad):
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    k = w.shape[-1]
    win = np.lib.stride_tricks.sliding_window_view(xp, (k, k), axis=(2, 3))
    return win[:, :, ::stride, ::stride], np.einsum(
        "bchwuv,ocuv->bohw", win[:, :, ::stride, ::stride], w)


def _conv_dw(x, dy, k, stride, pad):
    win, _ = _conv(x, np.zeros((1, x.shape[1], k, k)), stride, pad)
    return np.einsum("bchwuv,bohw->ocuv", win, dy)


def _conv_dx(dy, w, x_shape, stride, pad):
    b, c, hgt, wid = x_shape
    k = w.shape[-1]
    out = np.zeros((b, c, hgt + 2 * pad, wid + 2 * pad))
    ho, wo = dy.shape[2:]
    for u in range(k):
        for v in range(k):
            out[:, :, u:u + stride * ho:stride, v:v + stride * wo:stride] += (
                np.einsum("bohw,oc->bchw", dy, w[:, :, u, v]))
    return out[:, :, pad:pad + hgt, pad:pad + wid]


@pytest.mark.parametrize("mode", MODES)
def test_conv2d_gradients_keep_the_mode(mode):
    gen = torch.Generator().manual_seed(12)
    conv = Conv2d(5, 7, 3, 2)
    conv.reset_parameters(gen)
    x = torch.randn(2, 5, 9, 9, generator=gen, requires_grad=True)
    dy = torch.randn(2, 7, 5, 5, generator=gen)
    with matmul_precision_scope(mode):
        conv(x).backward(dy)
    w, xn, dyn = conv.weight.detach().numpy(), x.detach().numpy(), dy.numpy()
    want_x = _emulated(dyn, w, mode,
                       lambda d, ww: _conv_dx(d, ww, xn.shape, 2, 1))
    want_w = _emulated(dyn, xn, mode, lambda d, xx: _conv_dw(xx, d, 3, 2, 1))
    assert _within(x.grad.numpy(), want_x) <= 1
    assert _within(conv.weight.grad.numpy(), want_w) <= 1
    if mode == "highest":
        xh = x.detach().clone().requires_grad_()
        wh = conv.weight.detach().clone().requires_grad_()
        torch.nn.functional.conv2d(xh, wh, None, 2, 1).backward(dy)
        assert torch.equal(x.grad, xh.grad)
        assert torch.equal(conv.weight.grad, wh.grad)


# ------------------------------------------------------------------ #
# (b), (c) kernels 7 and 8 at 'fast' against the JAX kernels           #
# ------------------------------------------------------------------ #

K, B, N, G, F = 2, 4, 50, 8, 6
N_FLOWS = 2
C = 3 * N_FLOWS


@pytest.fixture(scope="module")
def decoders():
    """A JAX decoder's K stacked params (moved off their init, with
    running statistics off (0, 1)) and the port's decoder with the same
    weights; the state p, the latent g and the cotangents."""
    dec = JDecoder(n_flows=N_FLOWS, f_features=F, g_features=G)
    rng = np.random.RandomState(5)
    p = (rng.randn(K, B, 3, N) * 0.5).astype(np.float32)
    g = rng.randn(B, G).astype(np.float32)
    v = jax.vmap(lambda k: dec.init(k, p[0], g, "inverse", True))(
        jax.random.split(jax.random.PRNGKey(5), K))
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), v["params"])
    stats = jax.tree.map(
        lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
        v["batch_stats"])
    sd = {}
    fi.point_decoder_to_sd(sd, "m", params, stats, N_FLOWS)
    port = PointDecoderFlow(N_FLOWS, F, G, stack=(K,))
    port.load_state_dict({k[2:]: val for k, val in sd.items()})
    dp0 = rng.randn(K, B, 3, N).astype(np.float32)
    dlv = rng.randn(K, B, 3, N).astype(np.float32)
    return params, port.train(), p, g, dp0, dlv


_JAX_MXDOT = train_kernel._mxdot


def _upcast_mxdot(a, b, mode):
    if mode != "fast":
        return _JAX_MXDOT(a, b, mode)
    a, b = (t.astype(jnp.bfloat16).astype(jnp.float32) for t in (a, b))
    return jnp.dot(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def _jax_run(params, p, g, dp0, dlv, mode):
    """JAX's kernels in interpret mode: (p0, lv, stats) and the VJP in
    the port's layouts (d_packed per head, dab (K, B, C, 2, 2f), dp)."""
    packed = jax.vmap(lambda pr: j_pack(pr, N_FLOWS, False))(params)
    ab, _ = jax.vmap(film_wb_train, in_axes=(0, None))(packed, jnp.asarray(g))
    out, vjp = jax.vjp(lambda pk, a, x: j_fused(pk, a, x, True, mode),
                       packed, ab, jnp.asarray(p))
    p0, lv, stats = (np.asarray(t) for t in out)
    d_packed, dab, dp = vjp((jnp.asarray(dp0), jnp.asarray(dlv),
                             jnp.zeros_like(out[2])))
    d = {k: np.asarray(t) for k, t in d_packed.items()}
    w1 = d["w1"].reshape(K, C, 2, F, 2, F)
    w2 = d["w2"].reshape(K, C, 2, 3, 2, F)
    grads = {
        "w0": d["w0"].reshape(K, C, 2, F, 3),
        "bn0_scale": d["bn0_scale"].reshape(K, C, 2, F),
        "bn0_bias": d["bn0_bias"].reshape(K, C, 2, F),
        "w1": np.stack([w1[:, :, 0, :, 0], w1[:, :, 1, :, 1]], 2),
        "w2": np.stack([w2[:, :, 0, :, 0], w2[:, :, 1, :, 1]], 2),
        "b2": d["b2"].reshape(K, C, 2, 3),
    }
    return (p0, lv, stats), (np.asarray(dp), grads,
                             np.swapaxes(np.asarray(dab), 1, 2))


def _port_run(port, p, g, dp0, dlv, mode):
    with torch.no_grad():
        packed = {k: v.detach() for k, v in
                  td.pack_point_decoder_train(port).items()}
        ab, _ = td.film_ab_train(packed, torch.from_numpy(g))
        p0, lv, xsave, stats = td.train_decode_fwd_plain(
            packed, ab, torch.from_numpy(p), mode)
        dp, grads, dab = td.train_decode_bwd_plain(
            packed, ab, xsave, stats, torch.from_numpy(dp0),
            torch.from_numpy(dlv), mode)
    return ((p0.numpy(), lv.numpy(), stats.numpy()),
            (dp.numpy(), {k: v.numpy() for k, v in grads.items()},
             dab.numpy()))


@pytest.fixture(scope="module")
def runs(decoders):
    params, port, p, g, dp0, dlv = decoders
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_kernel, "_mxdot", _upcast_mxdot)
        return {(who, mode): run(*args, mode)
                for mode in MODES
                for who, run, args in (
                    ("jax", _jax_run, (params, p, g, dp0, dlv)),
                    ("port", _port_run, (port, p, g, dp0, dlv)))}


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# per mode: p0 and logvar atol, statistics atol, kernel 8's bound
# relative to each gradient's largest entry (the measured values are in
# the module's docstring)
JAX_BOUNDS = {"fast": (1e-3, 5e-6, 1e-2), "high": (3e-5, 2e-6, 3e-3)}


def _kernel7_matches_jax(runs, mode):
    atol, stats_atol, _ = JAX_BOUNDS[mode]
    (p0, lv, stats), _ = runs["port", mode]
    (j_p0, j_lv, j_stats), _ = runs["jax", mode]
    np.testing.assert_allclose(p0, j_p0, rtol=0, atol=atol)
    np.testing.assert_allclose(lv, j_lv, rtol=0, atol=atol)
    np.testing.assert_allclose(stats, j_stats, rtol=0, atol=stats_atol)


def _kernel8_matches_jax_vjp(runs, mode):
    bound = JAX_BOUNDS[mode][2]
    _, (dp, grads, dab) = runs["port", mode]
    _, (j_dp, j_grads, j_dab) = runs["jax", mode]
    assert _rel(dp, j_dp) < bound
    for k, v in grads.items():
        assert _rel(v, j_grads[k]) < bound, k
    assert _rel(dab, j_dab) < bound


def test_kernel7_fast_matches_jax(runs):
    _kernel7_matches_jax(runs, "fast")


def test_kernel8_fast_matches_jax_vjp(runs):
    _kernel8_matches_jax_vjp(runs, "fast")


def test_kernel7_high_matches_jax(runs):
    _kernel7_matches_jax(runs, "high")


def test_kernel8_high_matches_jax_vjp(runs):
    _kernel8_matches_jax_vjp(runs, "high")


def _effect_gap(got, got_hi, want, want_hi):
    effect = want - want_hi
    return np.sqrt(np.mean((got - got_hi - effect) ** 2)
                   / np.mean(effect ** 2))


# the mode's effect, port against JAX (a kernel that ignores the mode
# reads 1): (mode, what) -> bound
EFFECT_GAP = {("fast", "p0"): 0.05, ("fast", "dW1"): 0.05,
              ("high", "p0"): 0.5, ("high", "dW1"): 0.75}


def _mode_in_force(runs, mode, what):
    def pick(r):
        return r[0][0] if what == "p0" else r[1][1]["w1"]

    gap = _effect_gap(pick(runs["port", mode]), pick(runs["port", "highest"]),
                      pick(runs["jax", mode]), pick(runs["jax", "highest"]))
    assert gap <= EFFECT_GAP[mode, what]


@pytest.mark.parametrize("what", ["p0", "dW1"])
def test_fast_mode_is_in_force(runs, what):
    _mode_in_force(runs, "fast", what)


@pytest.mark.parametrize("what", ["p0", "dW1"])
def test_high_mode_is_in_force(runs, what):
    _mode_in_force(runs, "high", what)


# ------------------------------------------------------------------ #
# (d) the train step                                                   #
# ------------------------------------------------------------------ #

TINY = dict(FLAGSHIP_AIRPLANE, n_components=2, g_latent_space_size=12,
            g_prior_n_flows=2, g_prior_n_features=12, p_decoder_n_flows=2,
            p_decoder_n_features=8, pc_enc_init_n_features=8,
            pc_enc_n_features=(8, 16), params_reduce_mode="none")
HP = dict(epoch_length=10, cycle_length=10, min_lr=1e-3, max_lr=1e-3,
          beta1=0.9, min_beta2=0.99, max_beta2=0.99, wd=0.0)


def _model():
    model = FlowMixtureModel(**TINY,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for q in model.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
    return model


def _clouds():
    rng = np.random.RandomState(7)
    return torch.from_numpy((rng.randn(4, 3, 64) * 0.3).astype(np.float32))


def _train_step_runs_and_lowers_the_loss(mode):
    clouds = _clouds()
    eps = torch.randn(4, 12, generator=torch.Generator().manual_seed(2))
    losses = {}
    for m in ("highest", mode):
        model = _model()
        with matmul_precision_scope(m):
            step = make_train_step(model, make_optimizer(
                list(model.parameters()), **HP))
        losses[m] = [float(step(clouds, clouds, posterior_eps=eps)["loss"])
                     for _ in range(3)]
        assert get_matmul_precision() == "highest"
    assert losses[mode][-1] < losses[mode][0]
    assert losses[mode] != losses["highest"]


def test_fast_train_step_runs_and_lowers_the_loss():
    _train_step_runs_and_lowers_the_loss("fast")


def test_high_train_step_runs_and_lowers_the_loss():
    _train_step_runs_and_lowers_the_loss("high")


def _fused_plain_path_gaps(mode):
    """(loss, gradient in norm) of decode_training's fused path
    (fused_train_decode's plain versions on the CPU, under autograd)
    against the decoder's modules, both in `mode`."""
    clouds = _clouds()
    g = torch.randn(4, 12, generator=torch.Generator().manual_seed(3))
    out = {}
    for fused in (False, True):
        model = _model().train()
        with matmul_precision_scope(mode):
            dec = model.decode_training(clouds, g, fused=fused)
            loss = dec["p0_samples"].square().mean() + dec[
                "p_logvar_sums"].mean()
            loss.backward()
        out[fused] = (loss.item(), torch.cat([
            q.grad.flatten() for q in model.pc_decoder.parameters()]))
    gap = (out[True][1] - out[False][1]).norm() / out[False][1].norm()
    return abs(out[True][0] - out[False][0]) / abs(out[False][0]), gap


def test_fused_plain_path_follows_the_modules_at_fast():
    """The fused path against the modules at 'fast': the loss within 1e-3
    (measured 2.2e-4), the decoder's gradient in norm within 0.1
    (measured 0.023; at 'highest' 2e-7). The two are not one function at
    'fast': the fused path's sd0 statistics come from the x-moments with
    the fp32 W0 and are not centred exactly on the rounded h0, and its
    backward takes them as h0's (the JAX kernel's way), so a few sd0
    leaves differ by their own size."""
    loss, grad = _fused_plain_path_gaps("fast")
    assert loss <= 1e-3 and grad <= 0.1


def test_fused_plain_path_follows_the_modules_at_high():
    """The same at 'high': the loss within 1e-6 (measured 7.8e-8), the
    gradient in norm within 1e-4 (measured 1.2e-5): the split products
    keep about 16 bits, so the moments' statistics sit near h0's."""
    loss, grad = _fused_plain_path_gaps("high")
    assert loss <= 1e-6 and grad <= 1e-4


def test_fused_backward_keeps_the_forwards_mode_high():
    _fused_backward_keeps_the_forwards_mode("high")


def test_fused_backward_keeps_the_forwards_mode():
    """fused_train_decode's backward runs in the mode its forward ran in,
    also when it is called outside that mode's scope: its gradients are
    the plain kernel 8's of that mode bit for bit ('fast' here, 'high'
    in the test above)."""
    _fused_backward_keeps_the_forwards_mode("fast")


def _fused_backward_keeps_the_forwards_mode(mode):
    model = _model().train()
    packed = {k: v.detach().requires_grad_() for k, v in
              td.pack_point_decoder_train(model.pc_decoder).items()}
    g = torch.randn(4, 12, generator=torch.Generator().manual_seed(4))
    p = _clouds()[None].expand(2, 4, 3, 64).contiguous()
    ab = td.film_ab_train(packed, g)[0].detach().requires_grad_()
    dp0 = torch.randn(p.shape, generator=torch.Generator().manual_seed(5))
    with matmul_precision_scope(mode):
        p0, lv, _ = td.fused_train_decode(packed, ab, p)
    (p0 * dp0).sum().backward()  # at 'highest'
    with torch.no_grad():
        _, _, xsave, stats = td.train_decode_fwd_plain(packed, ab, p, mode)
        _, grads, dab = td.train_decode_bwd_plain(
            packed, ab, xsave, stats, dp0, torch.zeros_like(p), mode)
    for k, v in grads.items():
        assert torch.equal(packed[k].grad, v), k
    assert torch.equal(ab.grad, dab)


# ------------------------------------------------------------------ #
# (e) the training CLIs                                                #
# ------------------------------------------------------------------ #

CLI_CONFIG = dict(
    batch_size=4, beta1=0.9, chosen_label=None, cloud_center=False,
    cloud_noise=False, cloud_noise_scale=0.002, cloud_random_rotate=False,
    cloud_recenter2orig=False, cloud_rescale2orig=False, cloud_scale=True,
    cloud_scale_scale=2.0, cloud_size=32, cloud_translate=False,
    cloud_translate_shift=[0.0, 0.0, 0.0], cycle_length=4,
    deterministic=False, g_latent_space_size=8, g_posterior_n_layers=1,
    g_prior_n_features=8, g_prior_n_flows=1, gent_weight=1.0,
    gnll_weight=1.0, logging=False, logging_img=False,
    logging_img_frequency=1, max_beta2=0.99, max_lr=1e-3,
    meshes_fname="meshes.h5", min_beta2=0.99, min_lr=1e-3,
    n_components=2, n_epochs=1, num_workers=0, p_decoder_base_type="free",
    p_decoder_base_var=-3.9551, p_decoder_n_features=8,
    p_decoder_n_flows=1, p_latent_space_size=3, p_prior_n_layers=1,
    params_reduce_mode="none", pc_enc_init_n_channels=3,
    pc_enc_init_n_features=8, pc_enc_n_features=[8, 16], pnll_weight=1.0,
    resume=False, resume_optimizer=False, saving_mode=False, shuffle=True,
    train_mode="p_rnvp_mc_g_rnvp_vae", util_mode="training", wd=1e-6,
    weights_type="learned_weights",
)
SVR_CLI_CONFIG = dict(
    CLI_CONFIG, train_mode="p_rnvp_mc_g_rnvp_vae_ic",
    meshes_fname="svr_meshes.h5", images_fname="images.h5",
    image_resize=True, image_size=[24, 24],
    image_pad=False, image_pad_size=[0, 0], image_add_grayscale=True,
    image_remove_alpha=True, image_normalize=True,
    image_means=[0.1, 0.1, 0.1, 0.1], image_stds=[0.3, 0.3, 0.3, 0.3],
    image_noise=False, image_noise_scale=0.02, g_prior_n_layers=1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_precision")
    write_synthetic_meshes_h5(str(d / "meshes.h5"), n_shapes=4)
    write_synthetic_meshes_h5(str(d / "svr_meshes.h5"), n_shapes=1,
                              parts=("train", "test"))
    write_synthetic_images_h5(str(d / "images.h5"), n_shapes=1,
                              parts=("train", "test"), hw=20)
    return d


def _built_modes(monkeypatch, module, names):
    """Record the matmul precision current when `module` builds each
    step of `names`."""
    seen = {}
    for name in names:
        real = getattr(module, name)

        def build(*args, _real=real, _name=name, **kwargs):
            seen[_name] = get_matmul_precision()
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, build)
    return seen


@pytest.mark.parametrize("cli,mode", [
    ("train_ae", "fast"), ("train_ae", None), ("train_svr", "fast"),
    ("train_ae", "high"), ("train_svr", "high")])
def test_training_clis_take_fast(monkeypatch, data_dir, cli, mode):
    module, config = ((train_ae, CLI_CONFIG) if cli == "train_ae"
                      else (train_svr, SVR_CLI_CONFIG))
    config = dict(config, path2data=str(data_dir),
                  path2save=str(data_dir / "results"))
    if mode is not None:
        config["matmul_precision"] = mode
    path = str(data_dir / f"{cli}_{mode}.yaml")
    write_config(config, path)
    argv = [path, f"{cli}_{mode}", "1", "0.001", "--jobid", "t",
            "--device", "cpu"]
    names = (["make_train_step", "make_eval_step"] if cli == "train_ae"
             else ["make_train_step"])
    seen = _built_modes(monkeypatch, module, names)
    state, timings = module.main(argv)
    assert seen == dict.fromkeys(names, mode or "highest")
    assert timings[0]["steps"] >= 1 and state.step == timings[0]["steps"]
    assert all(np.isfinite(float(p.detach().abs().sum()))
               for p in state.model.parameters())
    assert get_matmul_precision() == "highest"


# ------------------------------------------------------------------ #
# (f) tools/train_quality_ab.py                                        #
# ------------------------------------------------------------------ #

def _jax_variant_keys():
    """The keys of the JAX tool's per-variant record, from its source."""
    path = os.path.join(ROOT, "tools", "train_quality_ab.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "results"
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no results[variant] = {...} in the JAX tool")


def test_train_quality_ab_runs_its_three_variants(tmp_path, capsys,
                                                  monkeypatch):
    """run() at a tiny size on the CPU (K=2, f=8, 3 steps, B=4, S=4, one
    rep): each of the JAX tool's variants trains ('fused' through the
    plain kernels 7 and 8 in its mode, once a step, 'xla' through the
    modules) and is scored; the JSON it writes holds the JAX tool's keys
    for each, every metric of compute_all_metrics and the JSD, finite;
    no step changed the current mode."""
    modes = []
    real = td.train_decode_fwd_plain

    def fwd_plain(packed, ab, p, mode=None):
        modes.append(mode)
        return real(packed, ab, p, mode)

    monkeypatch.setattr(td, "train_decode_fwd_plain", fwd_plain)
    out = tmp_path / "ab.json"
    results = train_quality_ab.run(TINY, 64, 3, 4, 4, 1,
                                   train_quality_ab.VARIANTS, "high", "cpu",
                                   str(out))
    printed = capsys.readouterr().out
    assert get_matmul_precision() == "highest"
    written = json.loads(out.read_text())
    assert set(written) == set(train_quality_ab.VARIANTS) == {
        "xla-highest", "fused-high", "fused-fast"}
    rng = np.random.RandomState(0)
    a = (rng.randn(4, 32, 3) * 0.3).astype(np.float32)
    j = jev.compute_all_metrics(a, a[::-1].copy(), 4, cd_option=True,
                                emd_option=True)
    metric_keys = {k for k, v in j.items() if np.size(v) == 1} | {"JSD"}
    for variant, rec in written.items():
        assert f"## variant={variant}" in printed
        assert set(rec) == _jax_variant_keys()
        assert set(rec["metrics"]) == metric_keys
        assert all(np.isfinite(mu) for mu, _ in rec["metrics"].values())
        assert [s for s, _ in rec["loss_curve"]] == [1, 2, 3]
        assert rec == json.loads(json.dumps(results[variant]))
    assert modes == ["high"] * 3 + ["fast"] * 3
