"""The whole port FlowMixtureModel against the JAX FlowMixtureModel in
generating and autoencoding modes, with the same weights (through
utils/flax_import.state_dict_from_flax) and the same explicit noise: the
epsilon of g0, the base epsilon (K, B, 3, N) and the component ids.

The JAX side is composed with model.apply(..., method=...) so that the
noise can be handed in; with fused_sampling=True its decode runs the
Pallas kernel in interpret mode. The port's decode runs the kernel's
plain version (CPU tensors).

The evaluation pass's de-normalisation is held against the JAX one
bit for bit (the same numpy operations).

Tolerances: logits and latents rtol 1e-5 (fp32, same operations);
samples atol 1e-4 (the interpret kernel's split products and the
folded BatchNorm, compounded over the coupling chain, as in
tests/test_coupling_kernel.py); labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.eval.evaluating import (
    _denormalize as j_denormalize,
)
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureModel as JFlowMixtureModel,
)
from go_with_the_flows_tpu.utils.config import count_params as j_count_params
from go_with_the_flows_tpu_torch.eval.evaluating import _denormalize, evaluate
from go_with_the_flows_tpu_torch.metrics.evaluation import (
    EMD_CD_F1,
    compute_all_metrics,
)
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.train.step import make_sample_step
from go_with_the_flows_tpu_torch.utils.config import count_params
from go_with_the_flows_tpu_torch.utils.flax_import import state_dict_from_flax

CONFIG = dict(
    n_components=2, params_reduce_mode="depth_and_feature",
    weights_type="learned_weights", g_latent_space_size=12,
    g_prior_n_flows=2, g_prior_n_features=8, g_posterior_n_layers=1,
    p_latent_space_size=3, p_prior_n_layers=1, p_decoder_n_flows=3,
    p_decoder_n_features=8, p_decoder_base_type="free",
    p_decoder_base_var=-3.9551, pc_enc_init_n_features=8,
    pc_enc_n_features=(8, 16),
)
K, G, B, N = 2, 12, 3, 40


def _models(scan: bool, seed: int = 0):
    jm = JFlowMixtureModel(**CONFIG, scan_couplings=scan,
                           fused_sampling=True)
    x = jnp.asarray(np.random.RandomState(seed).randn(B, 3, N), jnp.float32)
    key = jax.random.PRNGKey(seed)
    v = jm.init({"params": key, "sample": key}, x, x, mode="training")
    rng = np.random.RandomState(seed + 1)
    variables = {
        "params": jax.tree.map(
            lambda a: (rng.normal(0, 0.2, a.shape)).astype(np.float32),
            v["params"]),
        "batch_stats": jax.tree.map(
            lambda a: (0.5 + 0.5 * rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"]),
    }
    port = FlowMixtureModel(**CONFIG)
    port.load_state_dict(state_dict_from_flax(variables, CONFIG), strict=True)
    return jm, variables, port.eval()


def _noise(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, G).astype(np.float32),
            rng.randn(K, B, 3, N).astype(np.float32),
            rng.randint(0, K, (B, N)))


def _jax_decode(jm, v, g_s, base_eps, ids):
    logits = jm.apply(v, g_s, False, False, method="get_weights")
    mus, logvars = jm.apply(v, g_s, False, method="_point_base")
    base = mus[None] + jnp.exp(0.5 * logvars)[None] * base_eps
    decoded = jm.apply(v, base, g_s, method="_decode_direct_eval")
    samples = jnp.take_along_axis(
        decoded, jnp.asarray(ids)[None, :, None, :], axis=0)[0]
    return np.asarray(logits), np.asarray(samples)


def _port_decode(port, g_s, base_eps, ids):
    with torch.no_grad():
        logits = port.get_weights(g_s)
        samples, labels = port.decode_sampling(
            g_s, torch.from_numpy(ids), torch.from_numpy(base_eps),
            port.pack_decoder())
    return logits.numpy(), samples.numpy(), labels.numpy()


@pytest.mark.parametrize("scan", [True, False])
def test_generating_matches_jax(scan):
    jm, v, port = _models(scan)
    g0_eps, base_eps, ids = _noise(3)
    params = v["params"]
    g0 = params["g0_prior_mus"] + np.exp(
        0.5 * params["g0_prior_logvars"]) * g0_eps
    j_g, _ = jm.apply(v, jnp.asarray(g0),
                      method=lambda m, g: m.g_prior(g, "direct", False))
    with torch.no_grad():
        enc = port.encode(torch.zeros(B, 3, N), "generating",
                          torch.from_numpy(g0_eps))
    np.testing.assert_allclose(enc["g_sample"].numpy(), np.asarray(j_g),
                               rtol=1e-5, atol=1e-6)

    want_logits, want_samples = _jax_decode(jm, v, j_g, base_eps, ids)
    logits, samples, labels = _port_decode(port, enc["g_sample"], base_eps,
                                           ids)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(samples, want_samples, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(labels, ids + 1)


def test_autoencoding_matches_jax():
    jm, v, port = _models(True, seed=4)
    g_in = (np.random.RandomState(5).randn(B, 3, N) * 0.3).astype(np.float32)
    _, base_eps, ids = _noise(6)
    j_enc = jm.apply(v, jnp.asarray(g_in), "autoencoding", train=False,
                     method="encode")
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(g_in), "autoencoding")
    for key in ("g_sample", "g0_sample", "g_prior_logvar_sum"):
        np.testing.assert_allclose(enc[key].numpy(), np.asarray(j_enc[key]),
                                   rtol=1e-5, atol=1e-5)
    want_logits, want_samples = _jax_decode(jm, v, j_enc["g_sample"],
                                            base_eps, ids)
    logits, samples, labels = _port_decode(port, enc["g_sample"], base_eps,
                                           ids)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(samples, want_samples, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(labels, ids + 1)


@pytest.mark.parametrize("mode", ["generating", "autoencoding"])
def test_sample_step_and_evaluate(mode):
    """The user-facing path on the CPU: make_sample_step + evaluate over
    in-memory batches; a seed fixes the result."""
    port = FlowMixtureModel(**CONFIG,
                            generator=torch.Generator().manual_seed(7))
    rng = np.random.RandomState(8)
    batches = [{"cloud": (rng.randn(4, 3, N) * 0.3).astype(np.float32),
                "eval_cloud": (rng.randn(4, 3, N) * 0.3).astype(np.float32)}
               for _ in range(2)]
    step = make_sample_step(port, N, mode)
    samples, labels, logits = step(torch.from_numpy(batches[0]["cloud"]),
                                   torch.Generator().manual_seed(0))
    assert samples.shape == (4, 3, N) and logits.shape == (4, K)
    assert 1 <= int(labels.min()) and int(labels.max()) <= K
    results = [evaluate(batches, step, torch.Generator().manual_seed(1),
                        "cpu", util_mode=mode, cd=True, f1=True)
               for _ in range(2)]
    assert results[0] == results[1]
    assert results[0] and all(np.isfinite(x) for x in results[0].values())


@pytest.mark.parametrize("mode,keys", [
    ("generating", ("emd_mmds", "emd_covs", "emd_1nns")),
    ("autoencoding", ("emd",)),
])
def test_evaluate_with_emd(mode, keys):
    """evaluate(..., emd=True) on the CPU: the JAX package's keys and
    scales, the CD keys unchanged by it, and the EMD values those of the
    metrics on the same clouds (the samples are fixed by the seed)."""
    port = FlowMixtureModel(**CONFIG,
                            generator=torch.Generator().manual_seed(9))
    rng = np.random.RandomState(10)
    clouds = (rng.randn(3, 3, N) * 0.3).astype(np.float32)
    batches = [{"cloud": clouds, "eval_cloud": clouds}]
    step = make_sample_step(port, N, mode)
    got = evaluate(batches, step, torch.Generator().manual_seed(2), "cpu",
                   util_mode=mode, cd=True, emd=True)
    cd_only = evaluate(batches, step, torch.Generator().manual_seed(2),
                       "cpu", util_mode=mode, cd=True)
    assert set(got) == set(cd_only) | set(keys)
    assert all(got[k] == v for k, v in cd_only.items())
    samples, _, _ = step(torch.from_numpy(clouds),
                         torch.Generator().manual_seed(2))
    gen = samples.numpy().transpose(0, 2, 1)
    ref = clouds.transpose(0, 2, 1)
    if mode == "autoencoding":
        want = {"emd": float(EMD_CD_F1(gen, ref, 60, emd_option=True,
                                       device="cpu")["EMD"]) * 1e2}
    else:
        m = compute_all_metrics(gen, ref, 60, emd_option=True, device="cpu")
        want = {"emd_mmds": float(m["lgan_mmd-EMD"]) * 1e2,
                "emd_covs": float(m["lgan_cov-EMD"]) * 1e2,
                "emd_1nns": float(m["1-NN-EMD-acc"]) * 1e2}
    for k in keys:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


@pytest.mark.parametrize("flags", [
    dict(unit_scale_evaluation=True, cloud_scale=True, cloud_scale_scale=2.5),
    dict(orig_scale_evaluation=True, cloud_scale=True, cloud_scale_scale=0.5,
         cloud_translate=True, cloud_translate_shift=[0.1, -0.2, 0.3]),
    dict(orig_scale_evaluation=True, cloud_rescale2orig=True),
])
def test_denormalize_matches_jax(flags):
    rng = np.random.RandomState(11)
    r, p = (rng.randn(2, 2, 3, 7).astype(np.float32))
    batch = {"orig_s": rng.rand(2).astype(np.float32) + 0.5,
             "orig_c": rng.randn(2, 3).astype(np.float32)}
    got = _denormalize(r, p, batch, **flags)
    want = j_denormalize(r, p, batch, **flags)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_param_count_matches_jax():
    jm, v, port = _models(False, seed=9)
    assert count_params(port) == j_count_params(v["params"])
