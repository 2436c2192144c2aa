"""Latent interpolation and unconditional sampling in the port
(eval/interpolate.py) against the JAX package's eval/interpolate.py on
the CPU, from the same weights (utils/flax_import.state_dict_from_flax)
and the same clouds. The decodes' noise is the JAX package's own: its
draws (jax.random.categorical for the component ids, jax.random.normal
for the base epsilon and the prior's) are recorded while the JAX
functions run and handed to the port's functions through their `draw`
and `draw_prior` arguments, in the order they were drawn.

A tiny model (K=2, 2 flows of f=8, g=12), batches of 4 clouds of 32
points, 4 interpolation steps over 2 of a loader's 3 batches.

Tolerances: codes rtol 1e-5 (atol 1e-6 near 0; the same fp32
operations), the pairs and the labels exact, the interpolants and the
unconditional samples atol 1e-5.
"""

import functools
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.eval import interpolate as jinterp
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureModel as JFlowMixtureModel,
    FlowMixtureSVRModel as JFlowMixtureSVRModel,
)
from go_with_the_flows_tpu_torch.eval import interpolate as interp
from go_with_the_flows_tpu_torch.models.mixture import (
    FlowMixtureModel,
    FlowMixtureSVRModel,
)
from go_with_the_flows_tpu_torch.utils.flax_import import state_dict_from_flax

CONFIG = dict(
    n_components=2, params_reduce_mode="none",
    weights_type="learned_weights", g_latent_space_size=12,
    g_prior_n_flows=2, g_prior_n_features=8, g_posterior_n_layers=1,
    p_latent_space_size=3, p_prior_n_layers=1, p_decoder_n_flows=2,
    p_decoder_n_features=8, p_decoder_base_type="free",
    p_decoder_base_var=-3.9551, pc_enc_init_n_features=8,
    pc_enc_n_features=(8, 16),
)
B, N, STEPS, BATCHES = 4, 32, 4, 2


def _running_stats(tree, rng):
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.3, tree["mean"].shape).astype(
                    np.float32),
                "var": (0.5 + rng.rand(*tree["var"].shape)).astype(
                    np.float32)}
    return {k: _running_stats(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    """The JAX model and a state of its variables, the port's model with
    the same weights, and a loader of 3 batches."""
    rng = np.random.RandomState(0)
    jm = JFlowMixtureModel(**CONFIG, scan_couplings=False)
    key = jax.random.PRNGKey(1)
    x = jnp.asarray(rng.randn(B, 3, N).astype(np.float32))
    v = jax.jit(functools.partial(jm.init, mode="training"))(
        {"params": key, "sample": key}, x, x)
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": _running_stats(v["batch_stats"], rng),
    }
    state = types.SimpleNamespace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    port = FlowMixtureModel(**CONFIG)
    port.load_state_dict(state_dict_from_flax(variables, CONFIG), strict=True)
    loader = [{"cloud": (rng.randn(B, 3, N) * 0.4).astype(np.float32),
               "eval_cloud": (rng.randn(B, 3, N) * 0.4).astype(np.float32)}
              for _ in range(3)]
    return jm, state, port, loader


class Recorder:
    """Records the JAX package's draws while installed, then hands them
    to the port's functions in the same order."""

    def __init__(self, monkeypatch):
        self.normal, self.categorical = [], []
        normal, categorical = jax.random.normal, jax.random.categorical

        def rec_normal(*args, **kwargs):
            out = normal(*args, **kwargs)
            self.normal.append(np.asarray(out))
            return out

        def rec_categorical(*args, **kwargs):
            out = categorical(*args, **kwargs)
            self.categorical.append(np.asarray(out))
            return out

        monkeypatch.setattr(jax.random, "normal", rec_normal)
        monkeypatch.setattr(jax.random, "categorical", rec_categorical)

    def draw(self, generator, logits, n_points):
        ids = torch.from_numpy(self.categorical.pop(0).astype(np.int64))
        eps = torch.from_numpy(np.array(self.normal.pop(0)))
        assert ids.shape == (logits.shape[0], n_points)
        return ids, eps

    def draw_prior(self, generator, batch, width, device):
        eps = torch.from_numpy(np.array(self.normal.pop(0)))
        assert eps.shape == (batch, width)
        return eps


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_codes_match_jax(setup):
    jm, state, port, loader = setup
    for batch in loader:
        for key in ("cloud", "eval_cloud"):
            want = jinterp.encode_codes(jm, state, jnp.asarray(batch[key]))
            got = interp.encode_codes(port, torch.from_numpy(batch[key]))
            _close(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_interpolate_matches_jax(setup, monkeypatch, tmp_path):
    """The same pairs, the endpoints' codes, the interpolants decoded
    from the JAX draws, the labels; both h5 dumps hold the same keys,
    shapes and dtypes."""
    jm, state, port, loader = setup
    rec = Recorder(monkeypatch)
    want = jinterp.interpolate(loader, jm, state, jax.random.PRNGKey(5),
                               n_steps=STEPS, n_batches=BATCHES,
                               out_path=str(tmp_path / "jax.h5"))
    assert len(rec.categorical) == len(rec.normal) == BATCHES * STEPS
    got = interp.interpolate(loader, port, seed=5, n_steps=STEPS,
                             n_batches=BATCHES,
                             out_path=str(tmp_path / "port.h5"),
                             device="cpu", draw=rec.draw)
    assert not rec.categorical and not rec.normal
    c1, c2, interps, labels = got
    assert c1.shape == c2.shape == (BATCHES * B, 3, N)
    assert interps.shape == (BATCHES * B, 3, N, STEPS)
    assert labels.shape == (BATCHES * B, N, STEPS)
    np.testing.assert_array_equal(c1, want[0])
    np.testing.assert_array_equal(c2, want[1])  # the same partners
    _close(interps, want[2], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, want[3])
    assert labels.min() >= 1 and labels.max() <= CONFIG["n_components"]
    # the first and last codes are the endpoints', bit for bit
    codes = interp.lerp_codes(torch.ones(2), torch.full((2,), 3.0), 5)
    assert [float(c[0]) for c in codes] == [1.0, 1.5, 2.0, 2.5, 3.0]
    with h5py.File(tmp_path / "jax.h5", "r") as fj, \
            h5py.File(tmp_path / "port.h5", "r") as fp:
        assert sorted(fp) == sorted(fj) == ["clouds1", "clouds2",
                                            "interpolations", "labels"]
        for key in fj:
            assert fp[key].shape == fj[key].shape, key
            assert fp[key].dtype == fj[key].dtype, key
        assert fp["labels"].dtype == np.uint8
        np.testing.assert_array_equal(fp["labels"][()], labels)
        np.testing.assert_array_equal(fp["clouds2"][()], c2)


def test_interpolate_own_noise(setup):
    """Without `draw`: noise from the seeded generators, the same on
    every call, and n_steps below 2 refused."""
    _, _, port, loader = setup
    a = interp.interpolate(loader, port, seed=3, n_steps=3, n_batches=1,
                           device="cpu")
    b = interp.interpolate(loader, port, seed=3, n_steps=3, n_batches=1,
                           device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.isfinite(a[2]).all()
    with pytest.raises(ValueError, match="n_steps"):
        interp.interpolate(loader, port, n_steps=1, device="cpu")


def test_sample_unconditional_matches_jax(setup, monkeypatch):
    jm, state, port, _ = setup
    rec = Recorder(monkeypatch)
    want = jinterp.sample_unconditional(jm, state, jax.random.PRNGKey(9),
                                        n_clouds=6, n_points=N,
                                        batch_size=4)
    got = interp.sample_unconditional(port, 9, n_clouds=6, n_points=N,
                                      batch_size=4, device="cpu",
                                      draw=rec.draw,
                                      draw_prior=rec.draw_prior)
    assert not rec.categorical and not rec.normal
    assert got[0].shape == (6, 3, N) and got[1].shape == (6, N)
    _close(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])


def test_svr_model_raises_as_jax_does(setup):
    """Interpolation encodes point clouds alone: an SVR model, whose
    encode needs images, raises ValueError in both packages."""
    _, _, _, loader = setup
    svr = FlowMixtureSVRModel(**CONFIG)
    with pytest.raises(ValueError, match="images"):
        interp.interpolate(loader, svr, device="cpu")
    jm = JFlowMixtureSVRModel(**CONFIG)
    x = jnp.asarray(loader[0]["cloud"])
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "sample": key}, x, x,
        images=jnp.zeros((B, 32, 32, 4)), mode="training"))
    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    with pytest.raises(ValueError, match="images"):
        jinterp.encode_codes(jm, types.SimpleNamespace(**zeros), x)
