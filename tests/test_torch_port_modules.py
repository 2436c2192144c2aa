"""Port modules (go_with_the_flows_tpu_torch) against their JAX
counterparts, eval mode, on the CPU.

Weights, BatchNorm statistics and inputs are made with numpy from a seed
and handed to both sides (the flax variables through
utils/flax_import.py). Tolerance: rtol 1e-5, atol 1e-6 -- both sides run
fp32 at 'highest' with the same operations, up to reassociation of the
sums inside matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from go_with_the_flows_tpu.models import encoders as jenc
from go_with_the_flows_tpu.models import flows as jflows
from go_with_the_flows_tpu.ops.layers import SharedDot as JSharedDot
from go_with_the_flows_tpu.ops.layers import TorchBatchNorm
from go_with_the_flows_tpu_torch.models import encoders as tenc
from go_with_the_flows_tpu_torch.models import flows as tflows
from go_with_the_flows_tpu_torch.ops.layers import BatchNorm, SharedDot
from go_with_the_flows_tpu_torch.utils import flax_import as fi

RTOL, ATOL = 1e-5, 1e-6


def randomize(variables, seed):
    """Params ~ N(0, 0.3); BN running mean and var in [0.5, 1)."""
    rng = np.random.RandomState(seed)

    def params(x):
        return rng.normal(0.0, 0.3, np.shape(x)).astype(np.float32)

    def stats(x):
        return (0.5 + 0.5 * rng.rand(*np.shape(x))).astype(np.float32)

    out = {"params": jax.tree.map(params, variables.get("params", {}))}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(stats, variables["batch_stats"])
    return out


def load(module, convert, *args):
    """Convert flax variables into `module` under the prefix 'm'."""
    sd = {}
    convert(sd, "m", *args)
    holder = nn.Module()
    holder.m = module
    holder.load_state_dict(sd, strict=True)
    return module.eval()


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def close(got, want):
    if isinstance(got, (tuple, list)):
        for a, b in zip(got, want):
            close(a, b)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bias", [False, True])
def test_shared_dot(bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 11).astype(np.float32)
    jm = JSharedDot(7, use_bias=bias)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 1)
    port = SharedDot(5, 7, bias=bias)
    sd = {"weight": t(v["params"]["kernel"])}
    if bias:
        sd["bias"] = t(v["params"]["bias"])
    port.load_state_dict(sd)
    close(port(t(x)), jm.apply(v, x))


@pytest.mark.parametrize("shape,axis,affine", [
    ((3, 6, 9), 1, True), ((4, 6), -1, True), ((3, 6, 9), 1, False)])
def test_batch_norm_eval(shape, axis, affine):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jm = TorchBatchNorm(use_running_average=True, axis=axis,
                        use_scale=affine, use_bias=affine)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 3)
    port = load(BatchNorm(6, affine=affine), fi.batch_norm_to_sd,
                v["params"] if affine else None, v["batch_stats"], affine)
    close(port(t(x)), jm.apply(v, x))


def _coupling_io(G=12, B=3, N=20, seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 3, N).astype(np.float32) * 0.5,
            rng.randn(B, G).astype(np.float32))


@pytest.mark.parametrize("warp", [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2)])
def test_point_coupling(warp):
    p, g = _coupling_io()
    jm = jflows.CondAffineCoupling3D(warp_inds=warp, f_features=8)
    v = randomize(jm.init(jax.random.PRNGKey(0), p, g), 5)
    port = load(tflows.CondAffineCoupling3D(warp, 8, 12),
                fi.point_coupling_to_sd, v["params"], v["batch_stats"])
    for mode in ("direct", "inverse"):
        close(port(t(p), t(g), mode), jm.apply(v, p, g, mode))


@pytest.mark.parametrize("scan", [False, True])
def test_point_decoder_flow(scan):
    """Both JAX layouts (unrolled flow{i}_nvp{j}, scanned periods/*) load
    into the one port module; n_flows=3 has a scanned tail."""
    p, g = _coupling_io(seed=6)
    cls = jflows.ScanPointDecoderFlow if scan else jflows.PointDecoderFlow
    jm = cls(n_flows=3, f_features=8, g_features=12)
    v = randomize(jm.init(jax.random.PRNGKey(0), p, g), 7)
    port = load(tflows.PointDecoderFlow(3, 8, 12), fi.point_decoder_to_sd,
                v["params"], v["batch_stats"], 3)
    for mode in ("direct", "inverse"):
        close(port(t(p), t(g), mode), jm.apply(v, p, g, mode))


def test_latent_coupling():
    g = np.random.RandomState(8).randn(4, 12).astype(np.float32)
    warp = tuple(range(0, 12, 2))
    jm = jflows.LatentAffineCoupling(g_features=12, n_features=8,
                                     warp_inds=warp)
    v = randomize(jm.init(jax.random.PRNGKey(0), g), 9)
    port = load(tflows.LatentAffineCoupling(12, 8, warp),
                fi.latent_coupling_to_sd, v["params"], v["batch_stats"])
    for mode in ("direct", "inverse"):
        close(port(t(g), mode), jm.apply(v, g, mode))


def test_latent_prior_flow():
    g = np.random.RandomState(10).randn(4, 12).astype(np.float32)
    jm = jflows.LatentPriorFlow(n_flows=3, n_features=8, g_features=12)
    v = randomize(jm.init(jax.random.PRNGKey(0), g), 11)
    port = load(tflows.LatentPriorFlow(3, 8, 12), fi.latent_prior_to_sd,
                v["params"], v["batch_stats"])
    for mode in ("direct", "inverse"):
        close(port(t(g), mode), jm.apply(v, g, mode))


def test_pointnet_encoder():
    x = np.random.RandomState(12).randn(3, 3, 25).astype(np.float32)
    jm = jenc.PointNetCloudEncoder(init_n_features=8, n_features=(8, 16))
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 13)
    port = load(tenc.PointNetCloudEncoder(3, 8, (8, 16)), fi.pointnet_to_sd,
                v["params"], v["batch_stats"])
    close(port(t(x)), jm.apply(v, x))


@pytest.mark.parametrize("n_layers,deterministic", [(1, False), (2, True)])
def test_feature_encoder(n_layers, deterministic):
    x = np.random.RandomState(14).randn(5, 16).astype(np.float32)
    jm = jenc.FeatureEncoder(n_layers=n_layers, latent_space_size=6,
                             deterministic=deterministic)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 15)
    port = load(tenc.FeatureEncoder(16, n_layers, 6, deterministic),
                fi.feature_encoder_to_sd, v["params"], v["batch_stats"])
    close(port(t(x)), jm.apply(v, x))


def test_weights_encoder():
    x = np.random.RandomState(16).randn(5, 12).astype(np.float32)
    jm = jenc.WeightsEncoder(n_layers=3, n_components=4)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 17)
    port = load(tenc.WeightsEncoder(12, 3, 4), fi.feature_encoder_to_sd,
                v["params"]["features"], v["batch_stats"]["features"])
    close(port(t(x)), jm.apply(v, x))


def test_stacked_decoder_matches_per_component():
    """A K-stacked port decoder equals its K components run one by one."""
    p, g = _coupling_io(seed=18)
    K = 2
    stacked = tflows.PointDecoderFlow(2, 8, 12, stack=(K,)).eval()
    singles = [tflows.PointDecoderFlow(2, 8, 12).eval() for _ in range(K)]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, value in stacked.state_dict().items():
            value.copy_(torch.randn(value.shape, generator=gen) * 0.3
                        + (1.0 if "running_var" in name else 0.0))
    for k, single in enumerate(singles):
        single.load_state_dict(
            {n: v[k] for n, v in stacked.state_dict().items()})
    pk = torch.from_numpy(np.stack([p * (k + 1) for k in range(K)]))
    with torch.no_grad():
        out, lv = stacked(pk, t(g))
        for k, single in enumerate(singles):
            o, l = single(pk[k], t(g))
            torch.testing.assert_close(out[k], o, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(lv[k], l, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,axis,affine,momentum,stack", [
    ((3, 6, 9), 1, True, 0.9, ()),
    ((5, 6), -1, True, 0.9 ** 4, ()),
    ((3, 6, 9), 1, False, 0.9, ()),
    ((2, 3, 6, 9), 1, True, 0.9, (2,)),
    ((2, 5, 6), -1, True, 0.9, (2,)),
])
def test_batch_norm_train(shape, axis, affine, momentum, stack):
    """Train mode: batch statistics over every axis but the stack and
    channel axes, the biased variance for the output, and the running
    statistics blended with `momentum` and the Bessel-corrected variance,
    against TorchBatchNorm(use_running_average=False); a stack axis is
    the JAX module applied to each slice."""
    x = np.random.RandomState(20).randn(*shape).astype(np.float32) + 0.7
    jm = TorchBatchNorm(use_running_average=False, axis=axis,
                        momentum=momentum, use_scale=affine, use_bias=affine)
    K = stack[0] if stack else 1
    xs = x if stack else x[None]
    vs = [randomize(jm.init(jax.random.PRNGKey(0), xs[0]), 21 + k)
          for k in range(K)]
    port = BatchNorm(6, affine=affine, stack=stack, momentum=momentum)
    sd = {"running_mean": np.stack([v["batch_stats"]["mean"] for v in vs]),
          "running_var": np.stack([v["batch_stats"]["var"] for v in vs])}
    if affine:
        sd["weight"] = np.stack([v["params"]["scale"] for v in vs])
        sd["bias"] = np.stack([v["params"]["bias"] for v in vs])
    port.load_state_dict({k: t(a if stack else a[0]) for k, a in sd.items()})
    port.train()
    y = port(t(x))
    y = y if stack else y[None]
    for k, v in enumerate(vs):
        want, mut = jm.apply(v, xs[k], mutable=["batch_stats"])
        close(y[k], want)
        rm = port.running_mean if stack else port.running_mean[None]
        rv = port.running_var if stack else port.running_var[None]
        close(rm[k], mut["batch_stats"]["mean"])
        close(rv[k], mut["batch_stats"]["var"])
