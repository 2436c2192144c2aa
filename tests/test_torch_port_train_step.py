"""The port's training step (train/step.py:make_train_step on the plain
path, CPU) against the JAX package's make_train_step(fused_decoder=False)
from the same weights (through utils/flax_import.state_dict_from_flax),
on the same batch and the same posterior noise (the JAX package's
`_reparameterize` is replaced in this test, before the first trace, by
one that reads the noise handed to the port).

The JAX model is built with scan_couplings=False, so that its optimizer
gates the same leaves the port's does. Tolerances (as
tests/test_train_kernel.py holds the fused TPU step against the XLA
step): metrics rtol 1e-4, BatchNorm running statistics atol 1e-4,
parameters atol 5e-4 (AMSGrad's normalised update turns fp32 gradient
noise on near-zero-gradient leaves into parameter noise of that size).
Two loss-invariant leaves walk at +-lr per step independently in each
framework (RESULTS.md, round 5): the PointNet's last BatchNorm bias and
the running mean of the posterior's first BatchNorm, which absorbs that
walk; they are held to the walk's bound instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_with_the_flows_tpu.models.mixture as jmix
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureModel as JFlowMixtureModel,
)
from go_with_the_flows_tpu.optim import make_optimizer as j_make_optimizer
from go_with_the_flows_tpu.train.state import TrainState
from go_with_the_flows_tpu.train.step import make_train_step as j_make_step
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.train.step import make_train_step
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
HP = dict(epoch_length=4, cycle_length=2, min_lr=1e-3, max_lr=2e-3,
          beta1=0.9, min_beta2=0.99, max_beta2=0.999, wd=1e-4)
B, N, G = 4, 32, 12
WALKERS = {"pc_encoder.features.sd1_bn.bias",
           "g_posterior.features.mlp0_bn.running_mean"}


def _setup(config=CONFIG):
    rng = np.random.RandomState(0)
    g_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    p_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    eps = rng.randn(B, G).astype(np.float32)
    jm = JFlowMixtureModel(**config, scan_couplings=False)
    key = jax.random.PRNGKey(1)
    v = jm.init({"params": key, "sample": key}, g_in, p_in, mode="training")
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": jax.tree.map(
            lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"]),
    }
    return jm, variables, g_in, p_in, eps


def _jax_steps(jm, variables, g_in, p_in, eps, warmups, monkeypatch,
               config=CONFIG):
    def fixed_noise(rng, mu, logvar):
        return mu + jnp.exp(0.5 * logvar) * jnp.asarray(eps)

    monkeypatch.setattr(jmix, "_reparameterize", fixed_noise)
    opt = j_make_optimizer(**HP)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=opt.init(params))
    step = j_make_step(jm, opt, fused_decoder=False)
    out = []
    for warmup in warmups:
        state, metrics = step(state, jnp.asarray(g_in), jnp.asarray(p_in),
                              jax.random.PRNGKey(0), warmup=warmup)
        out.append(({k: float(v) for k, v in metrics.items()},
                    state_dict_from_flax(
                        {"params": jax.tree.map(np.asarray, state.params),
                         "batch_stats": jax.tree.map(np.asarray,
                                                     state.batch_stats)},
                        config)))
    return out


def _check_steps(warmups, checked, monkeypatch, config=CONFIG):
    """The port's steps with the given warmup flags against the JAX
    package's: metrics after every step, every parameter and buffer
    after the steps in `checked`."""
    jm, variables, g_in, p_in, eps = _setup(config)
    want = _jax_steps(jm, variables, g_in, p_in, eps, warmups, monkeypatch,
                      config)

    port = FlowMixtureModel(**config)
    port.load_state_dict(state_dict_from_flax(variables, config),
                         strict=True)
    opt = make_optimizer(list(port.parameters()), **HP)
    step = make_train_step(port, opt)
    buffers = {name for name, _ in port.named_buffers()}
    for t, warmup in enumerate(warmups):
        metrics = step(torch.from_numpy(g_in), torch.from_numpy(p_in),
                       warmup=warmup, posterior_eps=torch.from_numpy(eps))
        want_metrics, want_sd = want[t]
        for k, v in want_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                       err_msg=f"step {t} {k}")
        if t not in checked:
            continue
        walk = 2 * 1.5 * (t + 1) * HP["max_lr"]
        for name, got in port.state_dict().items():
            diff = np.abs(got.numpy() - want_sd[name].numpy()).max()
            bound = (walk if name in WALKERS
                     else 1e-4 if name in buffers else 5e-4)
            assert diff <= bound, (t, name, diff, bound)


@pytest.mark.parametrize("warmup", [True, False])
def test_train_steps_match_jax(warmup, monkeypatch):
    _check_steps([warmup] * 3, (0, 2), monkeypatch)


@pytest.mark.parametrize("base_type,weights_type", [
    ("freevar", "learned_weights"), ("fixed", "learned_weights"),
    ("free", "global_weights"), ("freevar", "global_weights"),
    ("fixed", "global_weights"),
])
def test_train_steps_match_jax_at_other_configs(base_type, weights_type,
                                                monkeypatch):
    """The comparison above at the other point-base types (the
    autoencoding and SVR configs use freevar) and with global weights."""
    config = dict(CONFIG, p_decoder_base_type=base_type,
                  weights_type=weights_type)
    _check_steps([False] * 3, (0, 2), monkeypatch, config)


def test_train_steps_match_jax_across_warmup(monkeypatch):
    """A run that leaves warmup after two steps, as a training run does
    after its warmup epochs: the learned weights encoder takes over."""
    _check_steps([True, True, False, False], (1, 2, 3), monkeypatch)


def test_train_step_fused_on_cpu_raises():
    port = FlowMixtureModel(**CONFIG)
    opt = make_optimizer(list(port.parameters()), **HP)
    step = make_train_step(port, opt, fused_decoder=True)
    with pytest.raises(ValueError, match="CUDA"):
        step(torch.zeros(B, 3, N), torch.zeros(B, 3, N),
             torch.Generator().manual_seed(0))


def test_train_step_reduces_the_loss():
    """Twenty plain-path steps on one seeded batch lower the loss; the
    posterior noise comes from the generator, so a seed fixes the run."""
    rng = np.random.RandomState(5)
    clouds = torch.from_numpy((rng.randn(B, 3, N) * 0.3).astype(np.float32))
    losses = []
    for _ in range(2):
        port = FlowMixtureModel(**CONFIG,
                                generator=torch.Generator().manual_seed(6))
        opt = make_optimizer(list(port.parameters()), **HP)
        step = make_train_step(port, opt)
        gen = torch.Generator().manual_seed(7)
        losses.append([float(step(clouds, clouds, gen, warmup=i < 5)["loss"])
                       for i in range(20)])
    assert losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))
    assert np.mean(losses[0][-3:]) < losses[0][0]
