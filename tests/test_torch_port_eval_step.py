"""The port's eval-loss step and sample step (train/step.py) on the CPU.

- make_eval_step against the JAX package's make_eval_step from the same
  weights (utils/flax_import.state_dict_from_flax), batch and posterior
  noise (the JAX `_reparameterize` is replaced in the test by one that
  reads the noise handed to the port), with warmup on and off, through
  the packed decoder (kernel 1's plain version, the CUDA path's
  arithmetic) and through the decoder's modules. The JAX step runs its
  XLA path on the CPU, as the JAX tests run it. Tolerance: metrics
  rtol 1e-4 (fp32; the packed path folds BatchNorm into the weights,
  as tests/test_torch_port_slice.py holds the sampling decode);
  the two port paths against each other rtol 1e-5.
- the steps read the model as it is at each call: after a train step, an
  eval step and a sample step give what freshly built steps on a copy of
  the model give, bit for bit (CPU, same operations); no BatchNorm buffer
  moves and every module gets its own mode back, also when a call
  raises.
- evaluate through the repaired sample step gives, with the seeds of
  test_torch_port_slice.py::test_sample_step_and_evaluate, the metrics of
  a sample step that packs once and is called in eval mode (the step as
  it was before the repair, on a model that has not trained).
- the legacy single-flow losses against the JAX package's, rtol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_with_the_flows_tpu.models.mixture as jmix
from go_with_the_flows_tpu import losses as jl
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureModel as JFlowMixtureModel,
)
from go_with_the_flows_tpu.train.state import TrainState
from go_with_the_flows_tpu.train.step import make_eval_step as j_make_eval
from go_with_the_flows_tpu_torch import losses as tl
from go_with_the_flows_tpu_torch.eval.evaluating import evaluate
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import point_decode
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.train.step import (
    make_eval_step,
    make_sample_step,
    make_train_step,
)
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
B, N, G, K = 4, 32, 12, 2


@pytest.fixture(scope="module")
def jax_eval():
    """JAX eval metrics for warmup False and True on one seeded setup."""
    rng = np.random.RandomState(0)
    g_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    p_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    eps = rng.randn(B, G).astype(np.float32)
    jm = JFlowMixtureModel(**CONFIG)
    key = jax.random.PRNGKey(1)
    v = jm.init({"params": key, "sample": key}, g_in, p_in, mode="training")
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": jax.tree.map(
            lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"]),
    }

    def fixed_noise(rng, mu, logvar):
        return mu + jnp.exp(0.5 * logvar) * jnp.asarray(eps)

    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmix, "_reparameterize", fixed_noise)
        step = j_make_eval(jm)
        for warmup in (False, True):
            metrics = step(state, jnp.asarray(g_in), jnp.asarray(p_in),
                           jax.random.PRNGKey(0), warmup=warmup)
            want[warmup] = {k: float(x) for k, x in metrics.items()}
    return variables, g_in, p_in, eps, want


def _port(variables):
    port = FlowMixtureModel(**CONFIG)
    port.load_state_dict(state_dict_from_flax(variables, CONFIG), strict=True)
    return port


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("warmup", [False, True])
def test_eval_step_matches_jax(jax_eval, warmup, fused):
    variables, g_in, p_in, eps, want = jax_eval
    port = _port(variables)
    before = point_decode.launches
    metrics = make_eval_step(port, fused_decoder=fused)(
        torch.from_numpy(g_in), torch.from_numpy(p_in), warmup=warmup,
        posterior_eps=torch.from_numpy(eps))
    assert point_decode.launches == before  # CPU tensors: plain version
    for k, v in want[warmup].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                   err_msg=k)
    other = make_eval_step(port, fused_decoder=not fused)(
        torch.from_numpy(g_in), torch.from_numpy(p_in), warmup=warmup,
        posterior_eps=torch.from_numpy(eps))
    for k in want[warmup]:
        np.testing.assert_allclose(float(metrics[k]), float(other[k]),
                                   rtol=1e-5, err_msg=k)


def _clouds(seed, n=B):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(n, 3, N) * 0.3).astype(np.float32))


def _trained_model(seed=7):
    """A model after one train step: it is left in train mode, with new
    weights and running statistics."""
    model = FlowMixtureModel(**CONFIG,
                             generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(list(model.parameters()), **HP)
    step = make_train_step(model, opt)
    clouds = _clouds(seed + 1)
    step(clouds, clouds, torch.Generator().manual_seed(seed + 2))
    return model, step


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _modes(model):
    return [m.training for m in model.modules()]


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_eval_step_sees_each_train_step():
    """Built once, the eval step follows the model through train steps:
    each call equals a fresh step's on a copy of the model, writes no
    buffer, and leaves the model in train mode, as the train step left
    it."""
    model, train_step = _trained_model()
    eval_step = make_eval_step(model)
    g, p = _clouds(11), _clouds(12)
    eps = torch.from_numpy(
        np.random.RandomState(13).randn(B, G).astype(np.float32))
    first = None
    for t in range(2):
        modes, state = _modes(model), _snapshot(model)
        got = eval_step(g, p, posterior_eps=eps)
        assert _modes(model) == modes and all(modes)
        _assert_same(_snapshot(model), state)
        fresh = make_eval_step(copy.deepcopy(model))(g, p, posterior_eps=eps)
        for k in got:
            assert float(got[k]) == float(fresh[k]), (t, k)
        if first is None:
            first = got
            train_step(g, g, torch.Generator().manual_seed(14))
    assert float(first["loss"]) != float(got["loss"])


@pytest.mark.parametrize("mode", ["generating", "autoencoding"])
def test_sample_step_after_a_train_step_matches_a_fresh_step(mode):
    """The regression of the stale sample step: sample, run a train step,
    sample again. The second samples equal a freshly built step's on a
    copy of the trained model, no buffer moves while sampling, and the
    model stays in train mode."""
    model, train_step = _trained_model(seed=21)
    sample_step = make_sample_step(model, N, mode)
    g = _clouds(22)
    sample_step(g, torch.Generator().manual_seed(0))
    train_step(g, g, torch.Generator().manual_seed(23))
    modes, state = _modes(model), _snapshot(model)
    got = sample_step(g, torch.Generator().manual_seed(1))
    assert _modes(model) == modes and all(modes)
    _assert_same(_snapshot(model), state)
    fresh = make_sample_step(copy.deepcopy(model), N, mode)(
        g, torch.Generator().manual_seed(1))
    for a, b in zip(got, fresh):
        assert torch.equal(a, b)


def test_steps_restore_modes_when_they_raise():
    model = FlowMixtureModel(**CONFIG)
    model.train()
    model.pc_encoder.eval()  # a mixed state comes back as it was
    modes, state = _modes(model), _snapshot(model)
    bad = torch.zeros(B, 5, N)  # the encoder takes 3 channels
    with pytest.raises(RuntimeError):
        make_sample_step(model, N, "autoencoding")(
            bad, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        make_eval_step(model)(bad, _clouds(1))
    assert _modes(model) == modes
    _assert_same(_snapshot(model), state)


def test_pack_decoder_follows_the_decoder():
    """pack_decoder packs again after an optimizer step, a running
    statistics write, load_state_dict or a replaced buffer (as `.to()`
    replaces them), and not otherwise."""
    model, train_step = _trained_model(seed=31)
    packed = model.pack_decoder()
    assert model.pack_decoder() is packed
    g = _clouds(32)
    train_step(g, g, torch.Generator().manual_seed(33))
    repacked = model.pack_decoder()
    assert repacked is not packed
    assert not torch.equal(repacked["kernel"], packed["kernel"])
    with torch.no_grad():
        model.pc_decoder.couplings()[0].T_mu_0.mu_sd1_bn.running_var.add_(1)
    assert model.pack_decoder() is not repacked
    packed = model.pack_decoder()
    model.load_state_dict(model.state_dict())
    assert model.pack_decoder() is not packed
    packed = model.pack_decoder()
    bn = model.pc_decoder.couplings()[-1].T_logvar_0.logvar_sd0_bn
    bn.running_mean = bn.running_mean.clone()
    assert model.pack_decoder() is not packed
    assert model.pack_decoder() is model.pack_decoder()


def test_evaluate_unchanged_by_the_sample_step_repair():
    """The seeds and batches of test_sample_step_and_evaluate
    (generating mode): evaluate through make_sample_step equals evaluate
    through the step as it was before the repair (eval mode and one pack
    when the step is built)."""
    port = FlowMixtureModel(**CONFIG,
                            generator=torch.Generator().manual_seed(7))
    rng = np.random.RandomState(8)
    batches = [{"cloud": (rng.randn(4, 3, 40) * 0.3).astype(np.float32),
                "eval_cloud": (rng.randn(4, 3, 40) * 0.3).astype(np.float32)}
               for _ in range(2)]

    def old_step(model, n):
        model.eval()
        packed = model.pack_decoder()

        def step(g_clouds, generator):
            with torch.inference_mode():
                bsz = g_clouds.shape[0]
                g0_eps = torch.randn(bsz, G, generator=generator)
                g = model.encode(g_clouds, "generating", g0_eps)["g_sample"]
                logits = model.get_weights(g)
                ids = torch.multinomial(logits.softmax(-1), n,
                                        replacement=True,
                                        generator=generator)
                base_eps = torch.randn(K, bsz, 3, n, generator=generator)
                samples, labels = model.decode_sampling(g, ids, base_eps,
                                                        packed)
                return samples, labels, logits
        return step

    flags = dict(util_mode="generating", cd=True, f1=True)
    new = evaluate(batches, make_sample_step(port, 40),
                   torch.Generator().manual_seed(1), "cpu", **flags)
    old = evaluate(batches, old_step(copy.deepcopy(port), 40),
                   torch.Generator().manual_seed(1), "cpu", **flags)
    assert new and new == old


def test_legacy_losses_match_jax():
    rng = np.random.RandomState(3)

    def r(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    out = {"p0_samples": r(1, B, 3, N), "p_logvar_sums": r(1, B, 3, N, s=0.3),
           "p_base_mus": r(B, 3, 1, s=0.1), "p_base_logvars": r(B, 3, 1, s=0.5),
           "g0_sample": r(B, G), "g_prior_mus0": r(B, G, s=0.1),
           "g_prior_logvars0": r(B, G, s=0.3),
           "g_prior_logvar_sum": r(B, G, s=0.3),
           "g_posterior_logvars": r(B, G, s=0.3)}
    j = {k: jnp.asarray(v) for k, v in out.items()}
    t = {k: torch.from_numpy(v) for k, v in out.items()}
    keys = ("p0_samples", "p_logvar_sums", "p_base_mus", "p_base_logvars")
    got = tl.point_flow_nll(t[keys[0]][0], t[keys[1]][0], t[keys[2]],
                            t[keys[3]])
    want = jl.point_flow_nll(j[keys[0]][0], j[keys[1]][0], j[keys[2]],
                             j[keys[3]])
    assert got.shape == (B, 1, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    weights = dict(pnll_weight=0.7, gnll_weight=1.3, gent_weight=0.9)
    loss, metrics = tl.single_flow_vae_loss(t, **weights)
    j_loss, j_metrics = jl.single_flow_vae_loss(j, **weights)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
