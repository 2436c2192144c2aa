"""The port's eval decode (pack_point_decoder + film_alpha_beta +
point_decode, which on the CPU runs the kernel's plain version) against
the JAX package's Pallas kernel in interpret mode and against the flax
decoder stack, direct and inverse, K=2 components.

Tolerance rtol 1e-4, atol 1e-5, as tests/test_coupling_kernel.py: the
interpret-mode kernel's split 'highest' products (_dot6) are a few ulps
off plain f32, and the folded weights reassociate the BatchNorm affines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from go_with_the_flows_tpu.models.flows import PointDecoderFlow as JDecoder
from go_with_the_flows_tpu.ops.pallas.coupling_kernel import (
    film_alpha_beta as j_film_alpha_beta,
    fused_point_decode,
    pack_point_decoder as j_pack,
)
from go_with_the_flows_tpu_torch.models.flows import PointDecoderFlow
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    film_alpha_beta,
    pack_point_decoder,
    point_decode,
    point_decode_plain,
)
from go_with_the_flows_tpu_torch.utils.flax_import import point_decoder_to_sd

RTOL, ATOL = 1e-4, 1e-5
K, N_FLOWS, F, G, B, N = 2, 2, 8, 12, 3, 40


def jiggle(tree, seed):
    """BN running stats in [0.5, 1), as tests/test_coupling_kernel.py."""
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(0.5 + 0.5 * r.rand(*x.shape), jnp.float32), tree)


@pytest.fixture(scope="module")
def decoders():
    rng = np.random.RandomState(0)
    p = rng.randn(K, B, 3, N).astype(np.float32) * 0.3
    g = rng.randn(B, G).astype(np.float32)
    jm = JDecoder(n_flows=N_FLOWS, f_features=F, g_features=G)
    trees = []
    for k in range(K):
        v = jm.init(jax.random.PRNGKey(k), p[k], g)
        trees.append({"params": v["params"],
                      "batch_stats": jiggle(v["batch_stats"], 10 + k)})
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    port = PointDecoderFlow(N_FLOWS, F, G, stack=(K,))
    sd = {}
    point_decoder_to_sd(sd, "m", stacked["params"], stacked["batch_stats"],
                        N_FLOWS, stack_ndim=1)
    holder = nn.Module()
    holder.m = port
    holder.load_state_dict(sd, strict=True)
    return jm, trees, stacked, port.eval(), p, g


@pytest.mark.parametrize("inverse", [False, True])
def test_point_decode_matches_jax_kernel_and_stack(decoders, inverse):
    jm, trees, stacked, port, p, g = decoders
    packed = pack_point_decoder(port)
    ab = film_alpha_beta(packed, torch.from_numpy(g))
    got_p, got_lv = point_decode(packed, ab, torch.from_numpy(p), inverse)

    j_packed = jax.vmap(lambda pr, st: j_pack(pr, st, N_FLOWS, False))(
        stacked["params"], stacked["batch_stats"])
    j_ab = jax.vmap(j_film_alpha_beta, in_axes=(0, None))(j_packed, g)
    want_p, want_lv = fused_point_decode(j_packed, j_ab, jnp.asarray(p),
                                         interpret=True, inverse=inverse)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), RTOL, ATOL)
    np.testing.assert_allclose(got_lv.numpy(), np.asarray(want_lv), RTOL,
                               ATOL)

    mode = "inverse" if inverse else "direct"
    for k in range(K):
        sp, slv = jm.apply(trees[k], p[k], g, mode)
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(sp), RTOL,
                                   ATOL)
        np.testing.assert_allclose(got_lv[k].numpy(), np.asarray(slv), RTOL,
                                   ATOL)


def test_film_alpha_beta_matches_jax(decoders):
    """The port's per-cloud affines equal the JAX ones once the head
    layout is the same ([logvar f | mu f] on the last axis)."""
    _, _, stacked, port, _, g = decoders
    ab = film_alpha_beta(pack_point_decoder(port), torch.from_numpy(g))
    j_packed = jax.vmap(lambda pr, st: j_pack(pr, st, N_FLOWS, False))(
        stacked["params"], stacked["batch_stats"])
    want = jax.vmap(j_film_alpha_beta, in_axes=(0, None))(j_packed, g)
    np.testing.assert_allclose(ab.numpy(), np.asarray(want), 1e-5, 1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_folded_decode_matches_unfolded_module(decoders, inverse):
    """The folded plain decode equals the port's own module stack."""
    _, _, _, port, p, g = decoders
    packed = pack_point_decoder(port)
    ab = film_alpha_beta(packed, torch.from_numpy(g))
    got = point_decode_plain(packed, ab, torch.from_numpy(p), inverse)
    with torch.no_grad():
        want = port(torch.from_numpy(p), torch.from_numpy(g),
                    "inverse" if inverse else "direct")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
