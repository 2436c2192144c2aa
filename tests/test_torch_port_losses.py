"""The port's losses (go_with_the_flows_tpu_torch/losses.py) against the
JAX package's on the same seeded numpy inputs, on the CPU. Tolerance:
rtol 1e-5 (fp32, the same sums and reductions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu import losses as jl
from go_with_the_flows_tpu_torch import losses as tl

K, B, C, N, G = 3, 4, 3, 17, 6
RTOL = 1e-5


def _outputs(seed):
    rng = np.random.RandomState(seed)

    def r(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    return {
        "p0_samples": r(K, B, C, N), "p_logvar_sums": r(K, B, C, N, s=0.3),
        "p_base_mus": r(B, C, 1, s=0.1), "p_base_logvars": r(B, C, 1, s=0.5),
        "mixture_weights_logits": r(B, K),
        "g0_sample": r(B, G), "g_prior_mus0": r(B, G, s=0.1),
        "g_prior_logvars0": r(B, G, s=0.3),
        "g_prior_logvar_sum": r(B, G, s=0.3),
        "g_posterior_logvars": r(B, G, s=0.3),
    }


def _both(outputs):
    return ({k: jnp.asarray(v) for k, v in outputs.items()},
            {k: torch.from_numpy(v) for k, v in outputs.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("term", ["gaussian_flow_nll", "gaussian_entropy",
                                  "flow_mixture_nll"])
def test_loss_term_matches_jax(term):
    j, t = _both(_outputs(1))
    keys = {
        "gaussian_flow_nll": ("g0_sample", "g_prior_mus0",
                              "g_prior_logvars0", "g_prior_logvar_sum"),
        "gaussian_entropy": ("g_posterior_logvars",),
        "flow_mixture_nll": ("p0_samples", "p_logvar_sums", "p_base_mus",
                             "p_base_logvars", "mixture_weights_logits"),
    }[term]
    _close(getattr(tl, term)(*(t[k] for k in keys)),
           getattr(jl, term)(*(j[k] for k in keys)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (0.5, 2.0, 0.25)])
def test_flow_mixture_loss_matches_jax(weights):
    j, t = _both(_outputs(2))
    loss, metrics = tl.flow_mixture_loss(t, *weights)
    j_loss, j_metrics = jl.flow_mixture_loss(j, *weights)
    _close(loss, j_loss)
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        _close(metrics[k], j_metrics[k])
