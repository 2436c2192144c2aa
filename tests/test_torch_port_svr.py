"""Single-view reconstruction in the port (FlowMixtureSVRModel, the steps
with svr=True, reconstruction-mode evaluate and the loops with svr=True)
against the JAX package on the CPU, from the same weights (through
utils/flax_import.state_dict_from_flax), the same clouds and images
(NHWC on the JAX side, NCHW in the port) and the same noise: the JAX
package's `_reparameterize` is replaced, before the first trace, by one
that reads the posterior noise handed to the port; the sampling noise
(component ids and base epsilon) is redrawn from the seed the port's
step draws it from and handed to the JAX decode.

A tiny decoder (K=2, 2 flows of f=8, g=16, freevar) under the real
ResNet-18 widths on 32 x 32 images, B=4. The JAX compiles (one train
step, one eval step) are shared by every case through a module-scope
fixture; the JAX model has scan_couplings=False so that its optimizer
gates the leaves the port's does.

Tolerances:
- encode, and the metrics of a train step or an eval step: rtol 1e-4,
  atol 1e-4 (tests/test_torch_port_train_step.py's metric bound; the
  ResNet's train-mode batch statistics at B=4 are the largest term,
  tests/test_torch_port_resnet.py);
- parameters after a step atol 5e-4, buffers atol 1e-4, as
  tests/test_torch_port_train_step.py holds them. Four leaves the loss
  does not see walk at +-lr a step in each framework on its own: the
  PointNet's last BatchNorm bias and the ResNet's fc bias (each followed
  by a train-mode BatchNorm that removes it), and the running means of
  those BatchNorms, which take the walk in; they are held to the walk's
  bound;
- samples atol 1e-4 (tests/test_torch_port_slice.py), labels exact;
- evaluate's CD and F1 rtol 1e-5, EMD rtol 1e-4
  (tests/test_torch_port_metrics.py: the auction's sums run in another
  order); its printed lines the same labels, their numbers within those
  bounds;
- the loops' meters rtol 1e-4, as tests/test_torch_port_loops.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import go_with_the_flows_tpu.models.mixture as jmix
from go_with_the_flows_tpu.data.loader import DataLoader as JDataLoader
from go_with_the_flows_tpu.eval.evaluating import evaluate as j_evaluate
from go_with_the_flows_tpu.metrics.evaluation import f_score as j_f_score
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureSVRModel as JFlowMixtureSVRModel,
)
from go_with_the_flows_tpu.optim import make_optimizer as j_make_optimizer
from go_with_the_flows_tpu.train import loops as jloops
from go_with_the_flows_tpu.train.state import TrainState as JTrainState
from go_with_the_flows_tpu.train.step import make_eval_step as j_make_eval
from go_with_the_flows_tpu.train.step import make_train_step as j_make_train
from go_with_the_flows_tpu_torch.data import DataLoader
from go_with_the_flows_tpu_torch.eval.evaluating import evaluate
from go_with_the_flows_tpu_torch.metrics.evaluation import f_score
from go_with_the_flows_tpu_torch.models.mixture import (
    FlowMixtureSVRModel,
    reduce_decoder_params,
)
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.train import loops
from go_with_the_flows_tpu_torch.train.state import create_train_state
from go_with_the_flows_tpu_torch.train.step import (
    make_eval_step,
    make_sample_step,
    make_train_step,
)
from go_with_the_flows_tpu_torch.utils.config import (
    SVR_RUN,
    SVR_SHAPENETALL13,
    count_params,
    svr_model_config_kwargs,
)
from go_with_the_flows_tpu_torch.utils.flax_import import state_dict_from_flax

CONFIG = dict(
    n_components=2, params_reduce_mode="depth_and_feature",
    weights_type="learned_weights", g_latent_space_size=16,
    g_prior_n_flows=2, g_prior_n_features=8, g_prior_n_layers=1,
    g_posterior_n_layers=1, p_latent_space_size=3, p_prior_n_layers=1,
    p_decoder_n_flows=2, p_decoder_n_features=8,
    p_decoder_base_type="freevar", p_decoder_base_var=0.0,
    pc_enc_init_n_features=8, pc_enc_n_features=(8, 16),
)
HP = dict(epoch_length=4, cycle_length=2, min_lr=1e-3, max_lr=2e-3,
          beta1=0.9, min_beta2=0.99, max_beta2=0.999, wd=1e-4)
B, N, G, K, HW = 4, 32, 16, 2, 32
WALKERS = {"pc_encoder.features.sd1_bn.bias",
           "g_posterior.features.mlp0_bn.running_mean",
           "img_encoder.fc.bias", "img_encoder.fc_bn.running_mean"}
THRESHOLDS = [0.05, 0.2]
# a first moment at rounding level, as a share of its tensor's largest
NOISE = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(n, seed):
    rng = np.random.RandomState(seed)
    return [{"cloud": (rng.randn(3, N) * 0.4).astype(np.float32),
             "eval_cloud": (rng.randn(3, N) * 0.4).astype(np.float32),
             "image": rng.randn(4, HW, HW).astype(np.float32)}
            for _ in range(n)]


def _stack(items, key):
    return np.stack([d[key] for d in items])


def _nhwc(images):
    return jnp.asarray(np.transpose(images, (0, 2, 3, 1)))


def _running_stats(tree, rng):
    """Running means N(0, 0.3) and variances in [0.5, 1.5)."""
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.3, tree["mean"].shape).astype(
                    np.float32),
                "var": (0.5 + rng.rand(*tree["var"].shape)).astype(
                    np.float32)}
    return {k: _running_stats(v, rng) for k, v in tree.items()}


def _record(state):
    """A JAX train state in the port's names: (parameters and BatchNorm
    statistics, AMSGrad's first moments, second moments, their maxima)."""
    opt = state.opt_state
    return (_as_sd(state),) + tuple(_as_sd(state, tree)
                                    for tree in (opt.mu, opt.nu, opt.nu_max))


def _as_sd(state, params=None):
    """A JAX train state's parameters and BatchNorm statistics (or, with
    `params`, another tree of the parameters' layout) in the port's
    state_dict names."""
    return state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, params or state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)},
        CONFIG)


@pytest.fixture(scope="module")
def jax_svr():
    """The JAX side of every comparison, on one seeded setup: encode in
    both modes, two train steps, an eval step, and the train and
    evaluate_val loops."""
    rng = np.random.RandomState(0)
    train_set, val_set = _dataset(8, 1), _dataset(8, 2)
    eps = rng.randn(B, G).astype(np.float32)
    batch = train_set[:B]
    g_in, p_in = _stack(batch, "cloud"), _stack(batch, "eval_cloud")
    images = _stack(batch, "image")
    jm = JFlowMixtureSVRModel(**CONFIG, scan_couplings=False)
    key = jax.random.PRNGKey(1)
    # jitted: one compile instead of the eager forward's many
    v = jax.jit(lambda g, p, im: jm.init({"params": key, "sample": key}, g,
                                         p, images=im, mode="training"))(
        jnp.asarray(g_in), jnp.asarray(p_in), _nhwc(images))
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": _running_stats(v["batch_stats"], rng),
    }
    out = dict(variables=variables, eps=eps, train_set=train_set,
               val_set=val_set, g_in=g_in, p_in=p_in, images=images, jm=jm)

    def fixed_noise(rng, mu, logvar):
        return mu + jnp.exp(0.5 * logvar) * jnp.asarray(eps)[:mu.shape[0]]

    def fresh_state(opt):
        params = jax.tree.map(jnp.asarray, variables["params"])
        return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(
                               jnp.asarray, variables["batch_stats"]),
                           opt_state=opt.init(params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmix, "_reparameterize", fixed_noise)
        enc, _ = jm.apply(variables, jnp.asarray(g_in), "training",
                          train=True, images=_nhwc(images),
                          rngs={"sample": key}, mutable=["batch_stats"],
                          method="encode")
        out["encode_training"] = jax.tree.map(np.asarray, enc)
        out["encode_reconstruction"] = jax.tree.map(np.asarray, jm.apply(
            variables, jnp.asarray(g_in), "reconstruction", train=False,
            images=_nhwc(images), method="encode"))

        opt = j_make_optimizer(**HP)
        train_step = j_make_train(jm, opt, svr=True, fused_decoder=False)
        eval_step = j_make_eval(jm, svr=True)
        state, steps = fresh_state(opt), []
        for _ in range(2):
            state, metrics = train_step(
                state, jnp.asarray(g_in), jnp.asarray(p_in),
                jax.random.PRNGKey(0), images=_nhwc(images), warmup=False)
            steps.append(({k: float(x) for k, x in metrics.items()},)
                         + _record(state))
        out["steps"] = steps
        out["eval"] = {k: float(x) for k, x in eval_step(
            fresh_state(opt), jnp.asarray(g_in), jnp.asarray(p_in), key,
            images=_nhwc(images)).items()}

        seen = {"train": [], "val": [], "states": []}

        def j_train(state, g, p, rng, images, warmup):
            state, metrics = train_step(state, g, p, rng, images=images,
                                        warmup=warmup)
            seen["train"].append({k: float(x) for k, x in metrics.items()})
            seen["states"].append(_record(state))
            return state, metrics

        def j_eval(state, g, p, rng, images, warmup):
            metrics = eval_step(state, g, p, rng, images=images,
                                warmup=warmup)
            seen["val"].append({k: float(x) for k, x in metrics.items()})
            return metrics

        state = jloops.train(
            JDataLoader(train_set, B, shuffle=True, seed=5, prefetch=0),
            j_train, fresh_state(opt), 0, 0, False, key, svr=True,
            checkpointing=False)
        out["val_min"] = jloops.evaluate_val(
            JDataLoader(val_set, B), j_eval, state, 0, False, float("inf"),
            key, svr=True, checkpointing=False)
        out["loops"] = seen
    return out


def _port(jax_svr):
    port = FlowMixtureSVRModel(**CONFIG)
    port.load_state_dict(state_dict_from_flax(jax_svr["variables"], CONFIG),
                         strict=True)
    return port


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("mode", ["training", "reconstruction"])
def test_svr_encode_matches_jax(jax_svr, mode):
    port = _port(jax_svr).train(mode == "training")
    with torch.no_grad():
        got = port.encode(_t(jax_svr["g_in"]), mode,
                          images=_t(jax_svr["images"]),
                          posterior_eps=_t(jax_svr["eps"]))
    want = jax_svr[f"encode_{mode}"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_svr_encode_rejects_other_modes(jax_svr):
    port = _port(jax_svr).eval()
    images = _t(jax_svr["images"])
    for mode in ("generating", "autoencoding"):
        with pytest.raises(ValueError, match="unsupported mode"):
            port.encode(_t(jax_svr["g_in"]), mode, images=images)
    with pytest.raises(ValueError, match="images"):
        port.encode(_t(jax_svr["g_in"]), "reconstruction")


def _load_jax_state(port, opt, record):
    """Bring the port's parameters, statistics and AMSGrad moments to a
    recorded JAX state (_record)."""
    sd, *moments = record
    port.load_state_dict(sd, strict=True)
    names = [n for n, _ in port.named_parameters()]
    for attr, tree in zip(("exp_avg", "exp_avg_sq", "max_exp_avg_sq"),
                          moments):
        getattr(opt, attr).copy_(torch.cat([tree[n].reshape(-1)
                                            for n in names]))


def _check_state(port, record, n_steps):
    """Every parameter and buffer against a recorded JAX state. A
    parameter may differ beyond 5e-4 only where JAX's first moment is at
    rounding level, within NOISE of the tensor's largest: AMSGrad's
    normalised update moves such an element by about lr either way, its
    sign the rounding's (in the ResNet, a few in 10^4 of the weights)."""
    want, want_mu = record[0], record[1]
    buffers = {name for name, _ in port.named_buffers()}
    walk = 2 * 1.5 * n_steps * HP["max_lr"]
    flips = 0
    for name, got in port.state_dict().items():
        diff = (got - want[name]).abs()
        if name in WALKERS:
            assert diff.max() <= walk, (name, float(diff.max()), walk)
        elif name in buffers:
            assert diff.max() <= 1e-4, (name, float(diff.max()))
        else:
            far = diff > 5e-4
            if far.any():
                mu = want_mu[name].abs()
                assert mu[far].max() <= NOISE * mu.max(), (
                    name, float(mu[far].max() / mu.max()))
                assert diff.max() <= walk, (name, float(diff.max()))
                flips += int(far.sum())
    return flips


@pytest.mark.parametrize("n_steps", [1, 2])
def test_svr_train_steps_match_jax(jax_svr, n_steps):
    """The metrics of each step and every parameter and buffer after it,
    each step from the JAX state before it (a step's rounding-level sign
    flips, _check_state, would otherwise feed the next: the ResNet's
    train-mode BatchNorms at B=4 magnify them far past rounding). The
    unused g0_prior_mus / g0_prior_logvars stay as they were."""
    port = _port(jax_svr)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(list(port.parameters()), **HP)
    step = make_train_step(port, opt, svr=True)
    n_params = sum(p.numel() for p in port.parameters())
    for t in range(n_steps):
        if t:
            _load_jax_state(port, opt, jax_svr["steps"][t - 1][1:])
        metrics = step(_t(jax_svr["g_in"]), _t(jax_svr["p_in"]),
                       posterior_eps=_t(jax_svr["eps"]),
                       images=_t(jax_svr["images"]))
        want_metrics = jax_svr["steps"][t][0]
        for k, v in want_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {t} {k}")
        flips = _check_state(port, jax_svr["steps"][t][1:], t + 1)
        assert flips <= 1e-3 * n_params, flips
    for name in ("g0_prior_mus", "g0_prior_logvars"):
        assert torch.equal(port.state_dict()[name], start[name])
    assert not torch.equal(port.state_dict()["img_encoder.conv1.weight"],
                           start["img_encoder.conv1.weight"])


def test_svr_eval_step_matches_jax(jax_svr):
    """Through the packed decoder (kernel 1's plain version) and through
    the decoder's modules; no buffer moves."""
    port = _port(jax_svr)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for fused in (True, False):
        got = make_eval_step(port, svr=True, fused_decoder=fused)(
            _t(jax_svr["g_in"]), _t(jax_svr["p_in"]),
            posterior_eps=_t(jax_svr["eps"]), images=_t(jax_svr["images"]))
        for k, v in jax_svr["eval"].items():
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{fused} {k}")
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def _jax_decode(jm, v, g_s, base_eps, ids):
    logits = jm.apply(v, g_s, False, False, method="get_weights")
    mus, logvars = jm.apply(v, g_s, False, method="_point_base")
    base = mus[None] + jnp.exp(0.5 * logvars)[None] * base_eps
    decoded = jm.apply(v, base, g_s, method="_decode_direct_eval")
    samples = jnp.take_along_axis(
        decoded, jnp.asarray(ids)[None, :, None, :], axis=0)[0]
    return np.asarray(logits), np.asarray(samples)


def test_svr_sample_step_matches_jax(jax_svr):
    """The reconstruction step: the latent from the image prior's mean,
    then the labeled decode with the step's ids and base epsilon (redrawn
    here from the step's seed, in the step's order)."""
    port = _port(jax_svr)
    step = make_sample_step(port, N, "reconstruction", svr=True)
    samples, labels, logits = step(_t(jax_svr["g_in"]),
                                   torch.Generator().manual_seed(3),
                                   images=_t(jax_svr["images"]))
    gen = torch.Generator().manual_seed(3)
    ids = torch.multinomial(logits.softmax(-1), N, replacement=True,
                            generator=gen)
    base_eps = torch.randn(K, B, 3, N, generator=gen)
    j_g = jax_svr["encode_reconstruction"]["g_sample"]
    want_logits, want_samples = _jax_decode(
        jax_svr["jm"], jax_svr["variables"], jnp.asarray(j_g),
        base_eps.numpy(), ids.numpy())
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(samples.numpy(), want_samples, rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(labels.numpy(), ids.numpy() + 1)
    with pytest.raises(ValueError, match="reconstruction"):
        make_sample_step(port, N, "autoencoding", svr=True)
    with pytest.raises(ValueError, match="reconstruction"):
        make_sample_step(port, N, "reconstruction")


_RESULT = re.compile(r"^(CD|EMD|F1-[\d.]+): ([\d.eE+-]+)$")


def _results(text):
    return [_RESULT.match(line).groups() for line in text.splitlines()
            if _RESULT.match(line)]


def test_svr_evaluate_reconstruction_matches_jax(jax_svr, capsys):
    """The port's evaluate (the SVR sample step, images from each batch)
    and the JAX evaluate handed the same samples: the same keys, values
    and printed lines."""
    port = _port(jax_svr)
    step = make_sample_step(port, N, "reconstruction", svr=True)
    val = jax_svr["val_set"]
    batches = [{k: _stack(val[i:i + B], k) for k in val[0]}
               for i in range(0, len(val), B)]
    drawn = []

    def recording_step(g, generator, images):
        out = step(g, generator, images=images)
        drawn.append(out[0].numpy())
        return out

    opts = dict(util_mode="reconstruction", cd=True, emd=True, f1=True,
                f1_threshold_lst=THRESHOLDS)
    got = evaluate(batches, recording_step, torch.Generator().manual_seed(4),
                   "cpu", svr=True, **opts)
    got_lines = _results(capsys.readouterr().out)

    replay = iter(drawn)

    def j_step(state, g, rng, images):
        assert images.shape == (B, HW, HW, 4)
        return jnp.asarray(next(replay)), None, None

    j_batches = [dict(b, image=np.transpose(b["image"], (0, 2, 3, 1)))
                 for b in batches]
    want = j_evaluate(j_batches, j_step, None, jax.random.PRNGKey(0),
                      svr=True, **opts)
    want_lines = _results(capsys.readouterr().out)

    keys = {"cd", "emd"} | {f"f1_{t:.4f}" for t in THRESHOLDS}
    assert set(got) == set(want) == keys
    assert [k for k, _ in got_lines] == [k for k, _ in want_lines] == [
        "CD", "EMD"] + [f"F1-{t:.4f}" for t in THRESHOLDS]
    assert all(0 < got[f"f1_{t:.4f}"] < 100 for t in THRESHOLDS)
    for (label, a), (_, b) in zip(got_lines, want_lines):
        rtol = 1e-4 if label == "EMD" else 1e-5
        # the printed numbers carry 6 (CD, EMD) or 2 (F1) decimals
        atol = 1e-6 if label in ("CD", "EMD") else 1e-2
        np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=atol,
                                   err_msg=label)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=1e-4 if k == "emd" else 1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("threshold", [0.01, 0.1])
def test_f_score_matches_jax(threshold):
    rng = np.random.RandomState(6)
    pred = (rng.randn(3, 50, 3) * 0.3).astype(np.float32)
    true = (rng.randn(3, 70, 3) * 0.3).astype(np.float32)
    got = f_score(_t(pred), _t(true), threshold)
    want = j_f_score(pred, true, threshold)
    assert got.shape == (3,)
    assert (got > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_svr_loops_match_jax(jax_svr, tmp_path):
    """train for one epoch of 2 steps, then evaluate_val over 2 batches,
    with svr=True, against the JAX loops from the same weights, batches
    and noise (the second step from the JAX loop's state after the first,
    as in test_svr_train_steps_match_jax); then reconstruct over the
    validation set."""
    eps = _t(jax_svr["eps"])
    port = _port(jax_svr)
    state = create_train_state(
        port, make_optimizer(list(port.parameters()), **HP), seed=0)
    train_step = make_train_step(port, state.optimizer, svr=True)
    eval_step = make_eval_step(port, svr=True)
    j_states = iter(jax_svr["loops"]["states"])

    def t_train(g, p, generator, warmup, images):
        if state.step:
            _load_jax_state(port, state.optimizer, next(j_states))
        return train_step(g, p, generator, warmup=warmup, posterior_eps=eps,
                          images=images)

    def t_eval(g, p, generator, warmup, images):
        return eval_step(g, p, generator, warmup=warmup, posterior_eps=eps,
                         images=images)

    config = dict(logging_path=str(tmp_path), model_name="svr.ckpt",
                  checkpointing=True)
    state = loops.train(
        DataLoader(jax_svr["train_set"], B, shuffle=True, seed=5, prefetch=0),
        t_train, state, 0, 0, False, device="cpu", svr=True, **config)
    val = DataLoader(jax_svr["val_set"], B)
    t_min = loops.evaluate_val(val, t_eval, state, 0, False, float("inf"),
                               torch.Generator().manual_seed(0),
                               device="cpu", svr=True, **config)
    assert state.step == 2
    for phase, got in (("train", state.train_metrics),
                       ("val", state.val_metrics)):
        seen = jax_svr["loops"][phase]
        assert len(seen) == 2
        for k in ("loss", "pnll", "gnll", "gent"):
            want = sum(m[k] for m in seen) / len(seen)
            np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                       err_msg=f"{phase} {k}")
    np.testing.assert_allclose(t_min, jax_svr["val_min"], rtol=1e-4)

    sample_step = make_sample_step(port, N, "reconstruction", svr=True)
    samples, gts, labels = loops.reconstruct(
        val, sample_step, torch.Generator().manual_seed(2), device="cpu",
        svr=True)
    assert samples.shape == (8, 3, N) and labels.shape == (8, N)
    assert np.isfinite(samples).all()
    assert 1 <= labels.min() and labels.max() <= K
    np.testing.assert_array_equal(gts, _stack(jax_svr["val_set"], "cloud"))
    gen = torch.Generator().manual_seed(2)
    for i, batch in enumerate(val):
        again, _, _ = sample_step(_t(batch["cloud"]), gen,
                                  images=_t(batch["image"]))
        np.testing.assert_array_equal(again.numpy(),
                                      samples[i * B:(i + 1) * B])


def test_to_device_moves_images():
    rng = np.random.RandomState(7)
    batch = {"cloud": rng.randn(2, 3, 5), "eval_cloud": rng.randn(2, 3, 5),
             "image": rng.randn(2, 4, 6, 6), "label": np.arange(2)}
    dev = loops._to_device(batch, torch.device("cpu"))
    assert set(dev) == {"cloud", "eval_cloud", "image"}
    for k, x in dev.items():
        assert x.dtype == torch.float32 and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(),
                                      batch[k].astype(np.float32))


def test_svr_config_is_the_yaml():
    """SVR_SHAPENETALL13 holds configs/config_SVR.yaml's model keys and
    SVR_RUN its run keys; the decoder reduces to 11 flows of f=33."""
    with open(os.path.join(ROOT, "configs", "config_SVR.yaml")) as f:
        yml = yaml.safe_load(f)
    for k, v in SVR_SHAPENETALL13.items():
        want = tuple(yml[k]) if isinstance(v, tuple) else yml[k]
        assert v == want, k
    for k, v in SVR_RUN.items():
        want = tuple(yml[k]) if isinstance(v, tuple) else yml[k]
        assert v == want, k
    kwargs = svr_model_config_kwargs(yml)
    assert kwargs["g_prior_n_layers"] == 1
    assert reduce_decoder_params(4, "depth_and_feature", 21, 64, 512) == (
        11, 33)


def test_svr_param_count_matches_jax(jax_svr):
    port = FlowMixtureSVRModel(**svr_model_config_kwargs(CONFIG))
    n_jax = sum(np.size(a) for a in jax.tree.leaves(
        jax_svr["variables"]["params"]))
    assert count_params(port) == n_jax
