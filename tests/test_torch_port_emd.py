"""The port's auction EMD (the plain versions, which CPU tensors run)
against the JAX package: ops/emd.py's match_cost / emd_approx, the paired
kernel emd_cost_pallas and its gradient, and the (S, R) grid
pairwise_emd_pallas, both in interpret mode. The same numpy clouds, made
from a seed, go to both sides.

Tolerances:
  * costs rtol 1e-4: the bound at which the JAX package holds its Pallas
    kernel against match_cost (tests/test_pallas_kernels.py), since the
    float sums run in another order;
  * the grid against the JAX grid rtol 2e-4, atol 1e-5
    (tests/test_pairwise_kernel.py); its entries against the per-pair
    plain cost exactly (the same function on the same pair);
  * gradients against the JAX kernel's rtol 1e-2, atol 5e-4: the
    auction's min(., 1) has kinks, so a 1e-7 change in sum order can move
    a few match entries by about 1e-3 (tests/test_pallas_kernels.py);
  * emd_backward_plain against the float64 analytic gradient rebuilt from
    its own residuals rtol 1e-4, atol 1e-5 (the tight self-consistency
    bound of tests/test_pallas_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.ops import emd as jemd
from go_with_the_flows_tpu.ops.pallas.emd_kernel import emd_cost_pallas
from go_with_the_flows_tpu.ops.pallas.pairwise_kernel import (
    pairwise_emd_pallas,
)
from go_with_the_flows_tpu_torch.ops import emd as temd
from go_with_the_flows_tpu_torch.ops.kernels.emd import (
    emd_backward_plain,
    emd_cost,
    emd_cost_plain,
)
from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
    pairwise_emd,
    pairwise_emd_plain,
)


def _clouds(B, N, M, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, N, 3).astype(np.float32),
            rng.rand(B, M, 3).astype(np.float32))


@pytest.mark.parametrize("n,m", [(3, 3), (7, 2), (2, 7), (100, 40),
                                 (40, 100)])
def test_capacities_match_jax(n, m):
    assert temd._capacities(n, m) == jemd._capacities(n, m)


@pytest.mark.parametrize("N,M", [(64, 64), (96, 64), (40, 100)])
def test_match_cost_matches_jax(N, M):
    a, b = _clouds(2, N, M, seed=N + M)
    got = temd.match_cost(torch.from_numpy(a), torch.from_numpy(b))
    want = jemd.match_cost(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_emd_approx_matches_jax():
    a, b = _clouds(3, 64, 64, seed=1)
    got = temd.emd_approx(torch.from_numpy(a), torch.from_numpy(b))
    want = jemd.emd_approx(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    with pytest.raises(ValueError):
        temd.emd_approx(torch.from_numpy(a), torch.from_numpy(a[:, :40]))


@pytest.mark.parametrize("N,M", [(64, 64), (96, 64), (40, 100), (300, 300)])
def test_emd_cost_plain_matches_pallas(N, M):
    """(300, 300): the JAX kernel pads to 512 with zero capacity; the port
    loops to the real sizes."""
    a, b = _clouds(2, N, M, seed=2 * N + M)
    got = emd_cost_plain(torch.from_numpy(a), torch.from_numpy(b))
    want = emd_cost_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    # the factored form against the port's own match_cost
    np.testing.assert_allclose(
        got.numpy(),
        temd.match_cost(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        rtol=1e-4)


def test_emd_cost_plain_residuals_rebuild_the_match():
    a, b = _clouds(2, 64, 96, seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cost, rl, rr = emd_cost_plain(ta, tb, save_ratios=True)
    assert rl.shape == (2, 9, 64) and rr.shape == (2, 9, 96)
    torch.testing.assert_close(cost, emd_cost_plain(ta, tb), rtol=0, atol=0)
    d = ((ta[:, :, None] - tb[:, None]) ** 2).sum(-1)
    match = sum(torch.exp(level * d) * rl[:, j, :, None] * rr[:, j, None, :]
                for j, level in enumerate(temd.levels()))
    rebuilt = (match * torch.sqrt(torch.clamp(d, min=1e-12))).sum((1, 2))
    np.testing.assert_allclose(rebuilt.numpy(), cost.numpy(), rtol=1e-4)


@pytest.mark.parametrize("N,M", [(64, 64), (40, 100)])
def test_emd_cost_grad_matches_pallas(N, M):
    a, b = _clouds(2, N, M, seed=4 + N)
    w = np.array([0.25, -1.5], np.float32)

    def loss(a, b):
        return jnp.sum(jnp.asarray(w) * emd_cost_pallas(a, b,
                                                        interpret=True))

    want_a, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a),
                                                    jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    cost = emd_cost(ta, tb)
    (torch.from_numpy(w) * cost).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_a),
                               rtol=1e-2, atol=5e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b),
                               rtol=1e-2, atol=5e-4)
    np.testing.assert_allclose(
        cost.detach().numpy(),
        np.asarray(emd_cost_pallas(jnp.asarray(a), jnp.asarray(b),
                                   interpret=True)), rtol=1e-4)


@pytest.mark.parametrize("N,M", [(64, 64), (50, 77), (100, 40)])
def test_emd_backward_plain_is_the_analytic_gradient(N, M):
    a, b = _clouds(2, N, M, seed=5 + M)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _, rl, rr = emd_cost_plain(ta, tb, save_ratios=True)
    da, db = emd_backward_plain(ta, tb, rl, rr)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    rl64, rr64 = rl.numpy().astype(np.float64), rr.numpy().astype(np.float64)
    diff = a64[:, :, None, :] - b64[:, None, :, :]
    d = (diff * diff).sum(-1)
    match = sum(np.exp(level * d) * rl64[:, j, :, None] * rr64[:, j, None, :]
                for j, level in enumerate(temd.levels()))
    inv = np.where(d > 1e-12, 1.0 / np.sqrt(np.maximum(d, 1e-12)), 0.0)
    coeff = (match * inv)[..., None]
    np.testing.assert_allclose(da.numpy(), (coeff * diff).sum(2),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), -(coeff * diff).sum(1),
                               rtol=1e-4, atol=1e-5)


def test_emd_cost_without_grad_keeps_no_residuals():
    a, b = _clouds(2, 30, 30, seed=6)
    ta = torch.from_numpy(a)
    with torch.no_grad():
        cost = emd_cost(ta.requires_grad_(), torch.from_numpy(b))
    assert cost.grad_fn is None
    torch.testing.assert_close(
        cost, emd_cost_plain(torch.from_numpy(a), torch.from_numpy(b)),
        rtol=0, atol=0)


def test_pairwise_emd_plain_matches_pallas():
    rng = np.random.RandomState(7)
    samples = rng.rand(2, 64, 3).astype(np.float32)
    refs = rng.rand(3, 96, 3).astype(np.float32)
    ts, tr = torch.from_numpy(samples), torch.from_numpy(refs)
    got = pairwise_emd(ts, tr)
    assert got.shape == (2, 3)
    torch.testing.assert_close(got, pairwise_emd_plain(ts, tr), rtol=0,
                               atol=0)
    want = pairwise_emd_pallas(jnp.asarray(samples), jnp.asarray(refs),
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=1e-5)
    for i in range(2):
        for j in range(3):
            one = emd_cost_plain(ts[i:i + 1], tr[j:j + 1])
            assert got[i, j].item() == one.item(), (i, j)
