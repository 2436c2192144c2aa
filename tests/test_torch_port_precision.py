"""The port's matmul precision modes (ops/precision.py): 'highest', 'high'
(three bf16 partial products, hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b),
accumulated in fp32) and 'fast' (one product of bf16-rounded operands).

- `bf16_round` equals jnp's float32 -> bfloat16 cast bit for bit, ties
  and specials included; `mxdot` matches the TPU kernels' `_mxdot`
  (coupling_kernel.py) at contraction 3, 74 and 128 within 1e-6 of
  max|a| max|b| K (the same exact partial products, summed in another
  order);
- kernel 1's plain version (`point_decode_plain`) in each mode, both
  directions, against the JAX package's `fused_point_decode` in
  interpret mode under `matmul_precision_scope` of that mode (K=2, B=2,
  N=256, f=8, 2 flows; weights moved off their init so that the modes
  differ). Tolerance atol 2e-6 at 'highest', 5e-6 at 'high' and 2e-5
  at 'fast' (a few times the largest gaps, 3.6e-7, 1.2e-6 and 2.2e-6),
  rtol 0. The mode must be in force: the port's effect of the mode (its
  output less its 'highest' output) within 0.5 ('high') or 0.05 ('fast')
  of JAX's, in rms over the effect's rms (measured at most 0.17 and
  1.8e-4; chip_smoke.py's bounds), and the port's 'fast' at least 10x
  closer to JAX's 'fast' than to JAX's 'highest' at its largest gap. (At
  'high' a largest gap is no such test: two sum orders can round lo(h) a
  bf16 step apart, as far as 'high' is from 'highest' at those few
  points.);
- SharedDot, Linear and the ResNet's Conv2d in each mode against a
  float64 numpy emulation of the TPU's passes on ml_dtypes bf16 operands
  (XLA:CPU ignores the precision of a plain dot, so the JAX modules are
  no oracle here), rtol 1e-5 and atol 1e-6 of the output's scale: fp32
  accumulation against float64;
- a step keeps the mode it was built under; make_train_step and the
  train-decode kernels refuse 'high' and take 'fast'; the metric entry points
  give equal bits in every mode; the evaluation CLIs' precedence of
  `eval_matmul_precision` over `matmul_precision`, 'highest' without
  either;
- tools/eval_precision_ab.py: its clouds equal the JAX tool's draws, and
  `run` at a small size prints a block a mode and the JSON with every
  key of the JAX tool.
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
from torch import nn

from go_with_the_flows_tpu.metrics import evaluation as jev
from go_with_the_flows_tpu.models.flows import PointDecoderFlow as JDecoder
from go_with_the_flows_tpu.ops.pallas.coupling_kernel import (
    _mxdot,
    film_alpha_beta as j_film_alpha_beta,
    fused_point_decode,
    pack_point_decoder as j_pack,
)
from go_with_the_flows_tpu.ops.precision import (
    matmul_precision_scope as j_scope)
from go_with_the_flows_tpu_torch.cli import eval_precision
from go_with_the_flows_tpu_torch.cli import evaluate_ae, reconstruct_ae
from go_with_the_flows_tpu_torch.metrics import evaluation as tev
from go_with_the_flows_tpu_torch.models.flows import PointDecoderFlow
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.models.resnet import Conv2d
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    film_alpha_beta,
    pack_point_decoder,
    point_decode,
    point_decode_plain,
)
from go_with_the_flows_tpu_torch.ops.layers import Linear, SharedDot
from go_with_the_flows_tpu_torch.ops.precision import (
    bf16_round,
    get_matmul_precision,
    matmul_precision_scope,
    mxdot,
    resolve,
)
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.tools import eval_precision_ab
from go_with_the_flows_tpu_torch.train.step import (
    make_eval_step,
    make_sample_step,
    make_train_step,
)
from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE
from go_with_the_flows_tpu_torch.utils.flax_import import point_decoder_to_sd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("highest", "high", "fast")
TINY = dict(FLAGSHIP_AIRPLANE, n_components=2, g_latent_space_size=12,
            g_prior_n_flows=2, g_prior_n_features=12, p_decoder_n_flows=2,
            p_decoder_n_features=8, pc_enc_init_n_features=8,
            pc_enc_n_features=(8, 16), params_reduce_mode="none")


# ------------------------------------------------------------------ #
# bf16_round and mxdot                                                 #
# ------------------------------------------------------------------ #

def test_bf16_round_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2 ** 31, size=4096).astype(np.uint32)
    # exact ties (low 16 bits 0x8000) with bit 16 even and odd, both signs
    ties = ((rng.randint(0, 2 ** 15, size=256).astype(np.uint32) << 16)
            | np.uint32(0x8000))
    ties |= np.uint32(1 << 31) * (np.arange(256) % 2).astype(np.uint32)
    x = np.concatenate([
        bits.view(np.float32), ties.view(np.float32),
        rng.randn(512).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39, 3.4e38],
                 np.float32)])
    x = x[np.isfinite(x) | np.isinf(x)]
    got = bf16_round(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    nan = bf16_round(torch.tensor([float("nan")]))
    assert torch.isnan(nan).all()


@pytest.mark.parametrize("mode", ["high", "fast"])
@pytest.mark.parametrize("k", [3, 74, 128])
def test_mxdot_matches_jax_mxdot(mode, k):
    rng = np.random.RandomState(k)
    a = (rng.randn(37, k) * 1.7).astype(np.float32)
    b = (rng.randn(k, 300) * 0.6).astype(np.float32)
    got = mxdot(torch.from_numpy(a), torch.from_numpy(b), mode).numpy()
    want = np.asarray(_mxdot(jnp.asarray(a), jnp.asarray(b), mode))
    bound = 1e-6 * np.abs(a).max() * np.abs(b).max() * k
    assert np.abs(got - want).max() <= bound
    if mode == "fast":  # the mode is in force: far from the fp32 product
        assert np.abs(got - a @ b).max() > 10 * bound


# ------------------------------------------------------------------ #
# kernel 1's plain version against the JAX kernel, per mode            #
# ------------------------------------------------------------------ #

K, N_FLOWS, F, G, B, N = 2, 2, 8, 12, 2, 256


@pytest.fixture(scope="module")
def decoders():
    rng = np.random.RandomState(0)
    p = rng.randn(K, B, 3, N).astype(np.float32) * 0.3
    g = rng.randn(B, G).astype(np.float32)
    jm = JDecoder(n_flows=N_FLOWS, f_features=F, g_features=G)
    trees = []
    for k in range(K):
        v = jm.init(jax.random.PRNGKey(k), p[k], g)
        r = np.random.RandomState(10 + k)
        # weights off their near-identity init and BN running means of
        # both signs, N(0, 0.3), variances in [0.5, 1.5) (else the ReLUs
        # close and every mode gives about the same clouds)
        params = jax.tree.map(
            lambda x: x + jnp.asarray(0.1 * r.randn(*x.shape), jnp.float32),
            v["params"])
        stats = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.asarray(
                0.3 * r.randn(*x.shape) if path[-1].key == "mean"
                else 0.5 + r.rand(*x.shape), jnp.float32),
            v["batch_stats"])
        trees.append({"params": params, "batch_stats": stats})
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    port = PointDecoderFlow(N_FLOWS, F, G, stack=(K,))
    sd = {}
    point_decoder_to_sd(sd, "m", stacked["params"], stacked["batch_stats"],
                        N_FLOWS, stack_ndim=1)
    holder = nn.Module()
    holder.m = port
    holder.load_state_dict(sd, strict=True)
    j_packed = jax.vmap(lambda pr, st: j_pack(pr, st, N_FLOWS, False))(
        stacked["params"], stacked["batch_stats"])
    j_ab = jax.vmap(j_film_alpha_beta, in_axes=(0, None))(j_packed, g)
    jax_out = {}
    for inverse in (False, True):
        for mode in MODES:
            with j_scope(mode):
                out = fused_point_decode(j_packed, j_ab, jnp.asarray(p),
                                         interpret=True, inverse=inverse)
            jax_out[mode, inverse] = [np.asarray(o) for o in out]
    return port.eval(), p, g, jax_out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_point_decode_plain_matches_jax_kernel(decoders, mode, inverse):
    port, p, g, jax_out = decoders
    packed = pack_point_decoder(port)
    ab = film_alpha_beta(packed, torch.from_numpy(g))
    x = torch.from_numpy(p)
    with matmul_precision_scope(mode):
        got = [o.numpy() for o in point_decode_plain(packed, ab, x, inverse)]
    atol = {"highest": 2e-6, "high": 5e-6, "fast": 2e-5}[mode]
    for a, b in zip(got, jax_out[mode, inverse]):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    if mode == "highest":
        return
    with matmul_precision_scope("highest"):
        base = [o.numpy()
                for o in point_decode_plain(packed, ab, x, inverse)]
    for a, b, ah, bh in zip(got, jax_out[mode, inverse], base,
                            jax_out["highest", inverse]):
        effect = b - bh
        assert np.sqrt(np.mean((a - ah - effect) ** 2)
                       / np.mean(effect ** 2)) <= {"high": 0.5,
                                                   "fast": 0.05}[mode]
    if mode == "fast":
        to_fast = np.abs(got[0] - jax_out["fast", inverse][0]).max()
        to_highest = np.abs(got[0] - jax_out["highest", inverse][0]).max()
        assert 10 * to_fast <= to_highest


def test_point_decode_plain_reads_the_current_mode(decoders):
    """The plain decode (and point_decode of a CPU tensor, which is it)
    follows matmul_precision_scope: 'default' is 'fast' bit for bit, and
    'high' and 'fast' each move the clouds off 'highest'."""
    port, p, g, _ = decoders
    packed = pack_point_decoder(port)
    ab = film_alpha_beta(packed, torch.from_numpy(g))
    x = torch.from_numpy(p)
    outs = {}
    for mode in MODES + ("default",):
        with matmul_precision_scope(mode):
            outs[mode] = point_decode_plain(packed, ab, x)
            via = point_decode(packed, ab, x)
        assert all(torch.equal(a, b) for a, b in zip(outs[mode], via))
    assert all(torch.equal(a, b)
               for a, b in zip(outs["default"], outs["fast"]))
    for mode in ("high", "fast"):
        assert not torch.equal(outs[mode][0], outs["highest"][0])


# ------------------------------------------------------------------ #
# the model's layers against a numpy emulation of the TPU passes       #
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


def _check_layer(got, want, fp32_want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    return np.abs(got - fp32_want).max() / scale


@pytest.mark.parametrize("mode", MODES)
def test_shared_dot_and_linear_follow_the_mode(mode):
    gen = torch.Generator().manual_seed(3)
    sd = SharedDot(37, 21, bias=True, stack=(2,))
    lin = Linear(74, 33, stack=(2,))
    for layer in (sd, lin):
        layer.reset_parameters(gen)
        with torch.no_grad():
            layer.bias.normal_(generator=gen)
    x_sd = torch.randn(2, 3, 37, 50, generator=gen)
    x_lin = torch.randn(2, 5, 74, generator=gen)
    with matmul_precision_scope(mode), torch.no_grad():
        y_sd, y_lin = sd(x_sd).numpy(), lin(x_lin).numpy()
    w, bias = sd.weight.detach().numpy(), sd.bias.detach().numpy()
    want_sd = _emulated(w, x_sd.numpy(), mode,
                        lambda a, b: np.einsum("koi,kbin->kbon", a, b)) \
        + bias[:, None, :, None]
    exact = np.einsum("koi,kbin->kbon", w.astype(np.float64),
                      x_sd.numpy().astype(np.float64)) \
        + bias[:, None, :, None]
    off_sd = _check_layer(y_sd, want_sd, exact)
    w, bias = lin.weight.detach().numpy(), lin.bias.detach().numpy()
    want_lin = _emulated(x_lin.numpy(), w, mode,
                         lambda a, b: np.einsum("kbi,koi->kbo", a, b)) \
        + bias[:, None, :]
    exact = np.einsum("kbi,koi->kbo", x_lin.numpy().astype(np.float64),
                      w.astype(np.float64)) + bias[:, None, :]
    off_lin = _check_layer(y_lin, want_lin, exact)
    if mode == "fast":  # the mode is in force
        assert min(off_sd, off_lin) > 1e-4


def _conv(x, w, stride, pad):
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    k = w.shape[-1]
    win = np.lib.stride_tricks.sliding_window_view(xp, (k, k), axis=(2, 3))
    win = win[:, :, ::stride, ::stride]
    return np.einsum("bchwuv,ocuv->bohw", win, w)


@pytest.mark.parametrize("mode", MODES)
def test_conv2d_follows_the_mode(mode):
    gen = torch.Generator().manual_seed(4)
    conv = Conv2d(5, 7, 3, 2)
    conv.reset_parameters(gen)
    x = torch.randn(2, 5, 9, 9, generator=gen)
    with matmul_precision_scope(mode), torch.no_grad():
        got = conv(x).numpy()
    w = conv.weight.detach().numpy()
    want = _emulated(x.numpy(), w, mode, lambda a, b: _conv(a, b, 2, 1))
    exact = _conv(x.numpy().astype(np.float64), w.astype(np.float64), 2, 1)
    off = _check_layer(got, want, exact)
    if mode == "fast":
        assert off > 1e-4


# ------------------------------------------------------------------ #
# the steps, the training refusal and the metrics                      #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def tiny_model():
    model = FlowMixtureModel(**TINY,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for q in model.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
    return model


def _clouds(seed, n=3, pts=64):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(n, 3, pts) * 0.3).astype(np.float32))


@pytest.mark.parametrize("kind", ["sample", "eval"])
def test_a_step_keeps_the_mode_it_was_built_under(tiny_model, kind):
    clouds = _clouds(5)

    def build():
        if kind == "sample":
            return make_sample_step(tiny_model, 64, "generating")
        return make_eval_step(tiny_model)

    def call(step):
        gen = torch.Generator().manual_seed(9)
        if kind == "sample":
            return step(clouds, gen)[0]
        return torch.stack(list(step(clouds, clouds, gen).values()))

    outs = {}
    for mode in ("highest", "fast"):
        with matmul_precision_scope(mode):
            step = build()
        for now in ("highest", "fast"):
            with matmul_precision_scope(now):
                outs[mode, now] = call(step)
            assert get_matmul_precision() == "highest"
    assert torch.equal(outs["fast", "highest"], outs["fast", "fast"])
    assert torch.equal(outs["highest", "fast"], outs["highest", "highest"])
    assert not torch.equal(outs["fast", "fast"], outs["highest", "highest"])


@pytest.mark.parametrize("mode", ["high", "fast", "default"])
def test_training_refuses_other_modes(tiny_model, mode):
    """Training takes every mode: 'high', 'fast' (and its alias
    'default') and 'highest' build a train step; only a name that is no
    mode is refused."""
    opt = make_optimizer(list(tiny_model.parameters()), epoch_length=1,
                         cycle_length=1, min_lr=1e-4, max_lr=1e-4,
                         beta1=0.9, min_beta2=0.99, max_beta2=0.99, wd=0.0)
    with matmul_precision_scope(mode):
        make_train_step(tiny_model, opt)
        assert resolve(None) == ("fast" if mode == "default" else mode)
    make_train_step(tiny_model, opt)  # 'highest' builds
    with pytest.raises(ValueError, match="must be one of"):
        resolve("tf32")


def test_metrics_are_bit_equal_across_modes():
    rng = np.random.RandomState(6)
    gen = (rng.randn(3, 40, 3) * 0.3).astype(np.float32)
    ref = (rng.randn(3, 40, 3) * 0.3).astype(np.float32)
    opts = dict(cd_option=True, emd_option=True, f1_option=True,
                f1_threshold=0.02, device="cpu")
    outs = {}
    for mode in MODES:
        with matmul_precision_scope(mode):
            outs[mode] = (
                tev.EMD_CD_F1(gen, ref, 2, **opts),
                tev.pairwise_EMD_CD_F1(gen, ref, 2, **opts),
                tev.compute_all_metrics(gen, ref, 2, **opts),
                tev.jsd_between_point_cloud_sets(gen, ref, device="cpu"))
    flat = {m: [np.asarray(v) for v in jax.tree.leaves(o)]
            for m, o in outs.items()}
    for mode in ("high", "fast"):
        assert len(flat[mode]) == len(flat["highest"])
        for a, b in zip(flat[mode], flat["highest"]):
            np.testing.assert_array_equal(a, b)


def test_occupancy_grid_jsd_matches_jax():
    """The occupancy-grid JSD of the A/B tool against the JAX package's
    (a nearest-neighbour search there): equal counts, the JSD to 1e-12."""
    rng = np.random.RandomState(8)
    a = (rng.randn(3, 300, 3) * 0.4).astype(np.float32)
    b = (rng.randn(3, 300, 3) * 0.2).astype(np.float32)
    with pytest.warns(UserWarning):
        want = jev.entropy_of_occupancy_grid(a, 28, in_sphere=True)[1]
    np.testing.assert_array_equal(
        tev.occupancy_grid_counts(a, 28, "cpu"), want)
    with pytest.warns(UserWarning):
        want = jev.jsd_between_point_cloud_sets(a, b)
    assert abs(tev.jsd_between_point_cloud_sets(a, b, device="cpu")
               - want) <= 1e-12


@pytest.mark.parametrize("config,mode", [
    ({}, "highest"),
    ({"matmul_precision": "high"}, "high"),
    ({"eval_matmul_precision": "fast"}, "fast"),
    ({"matmul_precision": "fast", "eval_matmul_precision": "high"}, "high"),
    ({"eval_matmul_precision": "default"}, "fast"),
])
def test_eval_clis_take_the_jax_precedence(monkeypatch, config, mode):
    assert eval_precision(config) == mode
    seen = []
    for cli in (evaluate_ae, reconstruct_ae):
        monkeypatch.setattr(cli, "_run", lambda *a, **k: seen.append(
            get_matmul_precision()))
        cli.run(config, None, "cpu")
        assert get_matmul_precision() == "highest"
    assert seen == [mode, mode]


def test_eval_clis_refuse_an_unknown_mode():
    with pytest.raises(ValueError, match="matmul_precision"):
        evaluate_ae.run({"eval_matmul_precision": "tf32"}, None, "cpu")


# ------------------------------------------------------------------ #
# tools/eval_precision_ab.py                                           #
# ------------------------------------------------------------------ #

def _jax_make_clouds():
    """The JAX tool's make_clouds (nested in its main) and its centers,
    taken from its source."""
    path = os.path.join(ROOT, "tools", "eval_precision_ab.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keep = [n for n in main.body
            if (isinstance(n, ast.FunctionDef) and n.name == "make_clouds")
            or (isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "centers")]
    assert len(keep) == 2
    scope = {"np": np, "N": 2048}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"),
         scope)
    return scope["make_clouds"]


def test_eval_ab_clouds_are_the_jax_tools():
    want = _jax_make_clouds()
    for seed, n in ((0, 64), (123, 5), (7, 3)):
        np.testing.assert_array_equal(
            eval_precision_ab.make_clouds(n, np.random.RandomState(seed)),
            want(n, np.random.RandomState(seed)))


def test_eval_ab_run_prints_every_jax_key(capsys):
    modes = ["highest", "high", "fast"]
    results = eval_precision_ab.run(TINY, 64, 2, 4, 4, 1, modes, "cpu")
    out = capsys.readouterr().out
    rng = np.random.RandomState(0)
    a = (rng.randn(4, 32, 3) * 0.3).astype(np.float32)
    j = jev.compute_all_metrics(a, a[::-1].copy(), 4, cd_option=True,
                                emd_option=True)
    keys = {k for k, v in j.items() if np.size(v) == 1} | {
        "JSD", "max_point_drift_vs_first_mode", "AE-CD_x1e4", "AE-EMD_x1e2",
        "AE-F1"}
    for mode in modes:
        assert f"## mode={mode}" in out
        assert set(results[mode]) == keys
        for key in keys:
            assert np.isfinite(results[mode][key][0])
    assert results["highest"]["max_point_drift_vs_first_mode"][0] == 0.0
    assert results["fast"]["max_point_drift_vs_first_mode"][0] > 0.0
    assert "# trains at" not in out
    json.dumps(results)


def test_eval_ab_trains_at_high(monkeypatch):
    """The tool trains its model at 'high', as the JAX tool does."""
    seen = []
    real = eval_precision_ab.make_train_step

    def build(*args, **kwargs):
        seen.append(get_matmul_precision())
        return real(*args, **kwargs)

    monkeypatch.setattr(eval_precision_ab, "make_train_step", build)
    eval_precision_ab.train(TINY, 64, 1, 4, "cpu")
    assert seen == ["high"]
    assert get_matmul_precision() == "highest"
