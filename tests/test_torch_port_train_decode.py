"""The port's train-mode decode (ops/kernels/train_decode.py: packing,
FiLM affines, the plain versions of kernels 7 and 8, the running-stat
update) against the JAX PointDecoderFlow applied in train mode (the XLA
path), K components at once, on the CPU.

Tolerances, as tests/test_train_kernel.py holds the TPU kernels: p0 and
the logvar sum atol 5e-6 and the running statistics atol 1e-6 (fp32
roundoff); the input cotangent within 1e-4 of its largest entry; every
parameter gradient and the latent's within 3e-2 of its own largest
entry, because train-mode BatchNorm over a small batch is
ill-conditioned and fp32 paths in another order differ that much there
(RESULTS.md round 3, f64 study).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.models.flows import PointDecoderFlow as JDecoder
from go_with_the_flows_tpu_torch.models.flows import PointDecoderFlow
from go_with_the_flows_tpu_torch.ops.kernels import train_decode as td
from go_with_the_flows_tpu_torch.utils import flax_import as fi

K, B, N, G, F = 2, 4, 50, 8, 6
N_FLOWS = 2


def _setup(seed=0):
    dec = JDecoder(n_flows=N_FLOWS, f_features=F, g_features=G)
    rng = np.random.RandomState(seed)
    p = (rng.randn(K, B, 3, N) * 0.5).astype(np.float32)
    g = rng.randn(B, G).astype(np.float32)
    v = jax.vmap(lambda k: dec.init(k, p[0], g, "inverse", True))(
        jax.random.split(jax.random.PRNGKey(seed), K))
    # move the running statistics off their (0, 1) start and every weight
    # off its near-identity init, so that both matter
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
    return dec, params, stats, p, g, port.train()


def _jax_apply(dec, params, stats, p, g):
    def one(pr, bs, pk):
        (p0, lv), mut = dec.apply({"params": pr, "batch_stats": bs}, pk, g,
                                  "inverse", True, mutable=["batch_stats"])
        return p0, lv, mut["batch_stats"]

    return jax.vmap(one)(params, stats, jnp.asarray(p))


def _port_decode(port, p, g):
    packed = td.pack_point_decoder_train(port)
    ab, film_stats = td.film_ab_train(packed, g)
    p0, lv, stats = td.fused_train_decode(packed, ab, p)
    return p0, lv, stats, film_stats


def test_forward_and_running_stats_match_jax():
    dec, params, stats, p, g, port = _setup()
    j_p0, j_lv, j_stats = _jax_apply(dec, params, stats, p, g)
    with torch.no_grad():
        p0, lv, st, film_stats = _port_decode(port, torch.from_numpy(p),
                                              torch.from_numpy(g))
        td.decoder_stats_update(port, st, film_stats, n_sd=B * N, n_film=B)
    np.testing.assert_allclose(p0.numpy(), np.asarray(j_p0), rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(lv.numpy(), np.asarray(j_lv), rtol=0,
                               atol=5e-6)
    want = {}
    fi.point_decoder_to_sd(want, "m", params, j_stats, N_FLOWS)
    got = port.state_dict()
    running = [k for k in got if "running_" in k]
    assert len(running) == 2 * 8 * 3 * N_FLOWS
    for k in running:
        np.testing.assert_allclose(got[k].numpy(), want["m." + k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_plain_forward_matches_the_modules():
    """train_decode_fwd_plain equals the decoder's own train-mode
    modules, and saves each coupling's input."""
    _, _, _, p, g, port = _setup(1)
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    with torch.no_grad():
        packed = td.pack_point_decoder_train(port)
        ab, _ = td.film_ab_train(packed, gt)
        p0, lv, xsave, stats = td.train_decode_fwd_plain(packed, ab, pt)
        want_p0, want_lv = port(pt, gt, "inverse")
    C = 3 * N_FLOWS
    assert xsave.shape == (K, C, B, 3, N) and stats.shape == (K, C, 4, 2 * F)
    torch.testing.assert_close(xsave[:, C - 1], pt, rtol=0, atol=0)
    torch.testing.assert_close(p0, want_p0, rtol=0, atol=5e-6)
    torch.testing.assert_close(lv, want_lv, rtol=0, atol=5e-6)
    assert bool((stats[:, :, 1::2] >= 0).all())


def test_gradients_match_jax():
    dec, params, stats, p, g, port = _setup(2)
    rng = np.random.RandomState(3)
    wp = rng.randn(K, B, 3, N).astype(np.float32)
    wl = rng.randn(K, B, 3, N).astype(np.float32)

    def loss(params, p, g):
        p0, lv, _ = _jax_apply(dec, params, stats, p, g)
        return jnp.sum(p0 * wp) + jnp.sum(lv * wl)

    j_params, j_p, j_g = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(p), jnp.asarray(g))

    pt = torch.from_numpy(p).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    p0, lv, _, _ = _port_decode(port, pt, gt)
    l_port = (p0 * torch.from_numpy(wp)).sum() + (lv * torch.from_numpy(
        wl)).sum()
    l_jax = float(loss(params, jnp.asarray(p), jnp.asarray(g)))
    assert abs(l_port.item() - l_jax) < 1e-4 * abs(l_jax) + 1e-4
    l_port.backward()

    def rel(got, want):
        want = np.asarray(want)
        return np.abs(got - want).max() / (np.abs(want).max() + 1e-8)

    assert rel(pt.grad.numpy(), j_p) < 1e-4
    assert rel(gt.grad.numpy(), j_g) < 3e-2
    want = {}
    fi.point_decoder_to_sd(want, "m", j_params, stats, N_FLOWS)
    named = dict(port.named_parameters())
    assert len(named) == 32 * 3 * N_FLOWS
    for k, param in named.items():
        assert rel(param.grad.numpy(), want["m." + k].numpy()) < 3e-2, k


@pytest.mark.parametrize("missing", ["dp0", "dlv"])
def test_backward_with_one_output_unused(missing):
    """A loss that reads only one of (p0, logvar_sum) gets the same
    gradients as one that weights the other by zero."""
    _, _, _, p, g, port = _setup(4)
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    grads = []
    for zero_weight in (False, True):
        port.zero_grad()
        p0, lv, _, _ = _port_decode(port, pt, gt)
        used, other = (lv, p0) if missing == "dp0" else (p0, lv)
        loss = used.square().sum()
        if zero_weight:
            loss = loss + 0.0 * other.sum()
        loss.backward()
        grads.append([q.grad.clone() for q in port.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
