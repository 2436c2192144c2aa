"""The port's nearest-neighbour distance (plain version, which the CPU
dispatch runs) against the JAX package's Pallas kernel in interpret
mode, and the port's autograd Chamfer against jax.grad of chamfer_pallas.

Tolerances: distances atol 1e-6 (both sum (dx^2 + dy^2) + dz^2 in fp32;
the kernel's padding does not enter real pairs); indices exact (random
clouds have no ties); gradients atol 1e-5 (2 g (x - y) from the same
nearest neighbours, summed in another order by the scatter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.ops import chamfer as j_chamfer
from go_with_the_flows_tpu.ops.pallas.chamfer_kernel import (
    chamfer_pallas,
    nn_distance_pallas,
)
from go_with_the_flows_tpu_torch.ops import chamfer as t_chamfer
from go_with_the_flows_tpu_torch.ops.kernels.chamfer import (
    chamfer,
    nn_distance,
)

SHAPES = [(2, 37, 50), (2, 64, 64), (3, 20, 13)]


def _clouds(B, N, M, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3).astype(np.float32) * 0.3,
            rng.randn(B, M, 3).astype(np.float32) * 0.3)


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_nn_distance_matches_pallas(B, N, M):
    a, b = _clouds(B, N, M, seed=N + M)
    got = nn_distance(torch.from_numpy(a), torch.from_numpy(b))
    want = nn_distance_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    for i in (0, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=1e-6)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


def test_nn_distance_without_indices():
    a, b = _clouds(2, 30, 41, seed=1)
    dist_a, dist_b = nn_distance(torch.from_numpy(a), torch.from_numpy(b),
                                 with_idx=False)
    want = nn_distance_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True,
                              with_idx=False)
    np.testing.assert_allclose(dist_a.numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(dist_b.numpy(), np.asarray(want[1]), atol=1e-6)


def test_nn_distance_ties_take_the_first_index():
    a = np.zeros((1, 2, 3), np.float32)
    b = np.zeros((1, 4, 3), np.float32)
    b[0, :, 0] = [1.0, 0.5, 0.5, -0.5]  # three points at equal distance
    _, idx_a, _, idx_b = nn_distance(torch.from_numpy(a), torch.from_numpy(b))
    assert idx_a.tolist() == [[1, 1]]
    assert idx_b.tolist() == [[0, 0, 0, 0]]


@pytest.mark.parametrize("B,N,M", SHAPES[:2])
def test_chamfer_gradients_match_jax(B, N, M):
    a, b = _clouds(B, N, M, seed=3)
    rng = np.random.RandomState(4)
    wa = rng.rand(B, N).astype(np.float32)
    wb = rng.rand(B, M).astype(np.float32)

    def jloss(x, y):
        dl, dr = chamfer_pallas(x, y, interpret=True)
        return jnp.sum(dl * wa) + jnp.sum(dr * wb)

    want_a, want_b = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                     jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    dl, dr = chamfer(ta, tb)
    ((dl * torch.from_numpy(wa)).sum()
     + (dr * torch.from_numpy(wb)).sum()).backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_a), atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b), atol=1e-5)
    fwd = chamfer_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(dl.detach().numpy(), np.asarray(fwd[0]),
                               atol=1e-6)


def test_plain_ops_match_jax_xla_ops():
    """ops/chamfer.py against the JAX package's XLA ops/chamfer.py."""
    a, b = _clouds(2, 21, 34, seed=5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        t_chamfer.pairwise_sqdists(ta, tb).numpy(),
        np.asarray(j_chamfer.pairwise_sqdists(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)
    got = t_chamfer.nn_distance(ta, tb)
    want = j_chamfer.nn_distance(jnp.asarray(a), jnp.asarray(b))
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-6 if i % 2 == 0 else 0)
    for x, y in zip(t_chamfer.chamfer(ta, tb),
                    j_chamfer.chamfer(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
