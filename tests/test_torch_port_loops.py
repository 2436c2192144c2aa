"""The port's loops, checkpoints and data loader (train/loops.py,
train/checkpoints.py, data/loader.py) on the CPU.

- train for one epoch of 2 steps, then evaluate_val over 2 batches (the
  second short: 7 clouds in batches of 4, taken as they are, as the JAX
  package's single-process run takes them), against the JAX loops from
  the same weights, batches and posterior noise (the JAX
  `_reparameterize` is replaced in the test by one that reads the noise
  handed to the port; the JAX model has scan_couplings=False so that its
  optimizer gates the leaves the port's does). Tolerance: the meters'
  averages rtol 1e-4, as tests/test_torch_port_train_step.py holds the
  step's metrics; the stdout meter lines equal but for their times; the
  best-model decision the same.
- a checkpoint round trip and a resume: two epochs without a break
  equal, bit for bit, one epoch, a save, a restore into a fresh model,
  optimizer and generator, and the second epoch; the file loads under
  torch.load's weights_only=True.
- NaNLossError from train and evaluate_val on a NaN batch.
- the DataLoader against the JAX package's: the same index order for the
  same seed and epoch (also split over replicas), the same len with and
  without drop_last; process workers on a dataset that has no epoch.
- reconstruct / predict, a profiled epoch writing its trace, and the
  step timer.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_with_the_flows_tpu.models.mixture as jmix
from go_with_the_flows_tpu.data.loader import DataLoader as JDataLoader
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureModel as JFlowMixtureModel,
)
from go_with_the_flows_tpu.optim import make_optimizer as j_make_optimizer
from go_with_the_flows_tpu.train import loops as jloops
from go_with_the_flows_tpu.train.state import TrainState as JTrainState
from go_with_the_flows_tpu.train.step import make_eval_step as j_make_eval
from go_with_the_flows_tpu.train.step import make_train_step as j_make_train
from go_with_the_flows_tpu_torch.data import DataLoader
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.train import checkpoints, loops
from go_with_the_flows_tpu_torch.train.state import create_train_state
from go_with_the_flows_tpu_torch.train.step import (
    make_eval_step,
    make_sample_step,
    make_train_step,
)
from go_with_the_flows_tpu_torch.utils import profiling
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


def _dataset(n, seed):
    rng = np.random.RandomState(seed)
    return [{"cloud": (rng.randn(3, N) * 0.4).astype(np.float32),
             "eval_cloud": (rng.randn(3, N) * 0.4).astype(np.float32)}
            for _ in range(n)]


_LINE = re.compile(r"Epoch: \[(\d+)\]\[(\d+)/(\d+)\]\tTime [\d.]+ \([\d.]+\)"
                   r"\tData [\d.]+ \([\d.]+\)(\tLB .*)$")


def _meter_lines(text):
    """The meter fields of each stdout line of train (times left out)."""
    out = []
    for line in text.splitlines():
        if line.startswith("Epoch: "):
            m = _LINE.match(line)
            assert m, line
            out.append(m.groups())
    return out


def test_train_and_evaluate_val_match_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(0)
    train_set, val_set = _dataset(8, 1), _dataset(7, 2)
    eps = rng.randn(B, G).astype(np.float32)
    jm = JFlowMixtureModel(**CONFIG, scan_couplings=False)
    key = jax.random.PRNGKey(1)
    x = jnp.asarray(np.stack([d["cloud"] for d in train_set[:B]]))
    v = jm.init({"params": key, "sample": key}, x, x, mode="training")
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": jax.tree.map(
            lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"]),
    }

    # the JAX loops, recording each step's metrics
    def fixed_noise(rng, mu, logvar):
        return mu + jnp.exp(0.5 * logvar) * jnp.asarray(eps)[:mu.shape[0]]

    monkeypatch.setattr(jmix, "_reparameterize", fixed_noise)
    opt = j_make_optimizer(**HP)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray,
                                                  variables["batch_stats"]),
                         opt_state=opt.init(params))
    j_train_step, j_eval_step = j_make_train(jm, opt, fused_decoder=False), \
        j_make_eval(jm)
    j_seen = {"train": [], "val": []}

    def j_train(state, g, p, rng, warmup):
        state, metrics = j_train_step(state, g, p, rng, warmup=warmup)
        j_seen["train"].append(({k: float(x) for k, x in metrics.items()},
                                g.shape[0]))
        return state, metrics

    def j_eval(state, g, p, rng, warmup):
        metrics = j_eval_step(state, g, p, rng, warmup=warmup)
        j_seen["val"].append(({k: float(x) for k, x in metrics.items()},
                              g.shape[0]))
        return metrics

    loader_args = dict(shuffle=True, seed=5, prefetch=0)
    jstate = jloops.train(JDataLoader(train_set, B, **loader_args), j_train,
                          jstate, 0, 0, False, key, logging=True,
                          checkpointing=False, num_workers=1)
    j_lines = _meter_lines(capsys.readouterr().out)
    j_min = jloops.evaluate_val(JDataLoader(val_set, B, drop_last=False),
                                j_eval, jstate, 0, False, float("inf"), key,
                                checkpointing=False)

    # the port's loops on the same weights, batches and noise
    port = FlowMixtureModel(**CONFIG)
    port.load_state_dict(state_dict_from_flax(variables, CONFIG),
                         strict=True)
    state = create_train_state(
        port, make_optimizer(list(port.parameters()), **HP), seed=0)
    train_step, eval_step = make_train_step(port, state.optimizer), \
        make_eval_step(port)

    def t_train(g, p, generator, warmup):
        return train_step(g, p, generator, warmup=warmup,
                          posterior_eps=torch.from_numpy(eps[:g.shape[0]]))

    def t_eval(g, p, generator, warmup):
        return eval_step(g, p, generator, warmup=warmup,
                         posterior_eps=torch.from_numpy(eps[:g.shape[0]]))

    config = dict(logging_path=str(tmp_path), model_name="m.ckpt",
                  checkpointing=True)
    state = loops.train(DataLoader(train_set, B, **loader_args), t_train,
                        state, 0, 0, False, device="cpu", logging=True,
                        num_workers=1, **config)
    lines = _meter_lines(capsys.readouterr().out)
    val = DataLoader(val_set, B, drop_last=False)
    assert [len(b["cloud"]) for b in val] == [4, 3]
    t_min = loops.evaluate_val(val, t_eval, state, 0, False, float("inf"),
                               torch.Generator().manual_seed(0),
                               device="cpu", **config)

    assert state.step == 2 and len(lines) == len(j_lines) == 2
    assert lines == j_lines
    for phase, got in (("train", state.train_metrics),
                       ("val", state.val_metrics)):
        seen = j_seen[phase]
        assert len(seen) == 2
        for k in ("loss", "pnll", "gnll", "gent"):
            want = (sum(m[k] * n for m, n in seen)
                    / sum(n for _, n in seen))
            np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                       err_msg=f"{phase} {k}")
    np.testing.assert_allclose(t_min, j_min, rtol=1e-4)
    assert t_min == state.val_metrics["loss"]
    best = os.path.join(checkpoints._ckpt_dir(str(tmp_path),
                                              "best_model_m.ckpt"),
                        "checkpoint.pt")
    assert checkpoints.checkpoint_exists(str(tmp_path), "best_model_m.ckpt")
    assert checkpoints.checkpoint_exists(str(tmp_path), "m.ckpt")
    stamp = os.stat(best).st_mtime_ns
    # a loss that does not beat min_loss keeps it and the best model
    for j_loss, t_loss in ((j_min, t_min), (j_min - 1.0, t_min - 1.0)):
        j_kept = jloops.evaluate_val(
            JDataLoader(val_set, B, drop_last=False), j_eval, jstate, 1,
            False, j_loss, key, checkpointing=False)
        t_kept = loops.evaluate_val(
            DataLoader(val_set, B, drop_last=False), t_eval, state, 1, False,
            t_loss, torch.Generator().manual_seed(0), device="cpu", **config)
        assert (j_kept, t_kept) == (j_loss, t_loss)
    assert os.stat(best).st_mtime_ns == stamp


def _run(tmp_path, epochs, resume):
    """`epochs` training epochs of 2 steps on a fresh seeded setup, the
    first restored from tmp_path's checkpoint when `resume`."""
    model = FlowMixtureModel(**CONFIG,
                             generator=torch.Generator().manual_seed(
                                 8 if resume else 3))
    state = create_train_state(
        model, make_optimizer(list(model.parameters()), **HP),
        seed=9 if resume else 4)
    start = 0
    if resume:
        state, start, it = checkpoints.restore_checkpoint(
            str(tmp_path), "run.ckpt", state)
        assert (start, it) == (1, 0)
    step = make_train_step(model, state.optimizer)
    loader = DataLoader(_dataset(8, 6), B, shuffle=True, seed=2)
    for epoch in range(start, epochs):
        state = loops.train(loader, step, state, epoch, 0, epoch == 0,
                            device="cpu", checkpointing=not resume,
                            logging_path=str(tmp_path), model_name="run.ckpt")
    return state


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    _run(tmp_path, 1, resume=False)
    path = os.path.join(checkpoints._ckpt_dir(str(tmp_path), "run.ckpt"),
                        "checkpoint.pt")
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"epoch", "iter", "step", "model_state",
                            "optimizer_state", "generator_state"}
    assert payload["step"] == 2
    resumed = _run(tmp_path, 2, resume=True)
    straight = _run(tmp_path / "straight", 2, resume=False)
    assert resumed.step == straight.step == 4
    for a, b in ((resumed.model.state_dict(), straight.model.state_dict()),):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "counts"):
        assert torch.equal(getattr(resumed.optimizer, k),
                           getattr(straight.optimizer, k)), k
    assert resumed.optimizer.global_step == straight.optimizer.global_step
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())
    assert resumed.train_metrics == straight.train_metrics


def test_nan_loss_raises():
    model = FlowMixtureModel(**CONFIG)
    state = create_train_state(
        model, make_optimizer(list(model.parameters()), **HP))
    data = _dataset(8, 7)
    data[6]["eval_cloud"][0, 0] = np.nan  # the last batch
    with pytest.raises(loops.NaNLossError, match="iter 1"):
        loops.train(DataLoader(data, B), make_train_step(model,
                                                         state.optimizer),
                    state, 0, 0, False, device="cpu")
    with pytest.raises(loops.NaNLossError, match="Eval loss"):
        loops.evaluate_val(DataLoader(data, B), make_eval_step(model), state,
                           0, False, float("inf"),
                           torch.Generator().manual_seed(0), device="cpu")


def _indices(loader, epoch):
    loader.set_epoch(epoch)
    return [b["i"].tolist() for b in loader]


@pytest.mark.parametrize("replicas,rank", [(1, 0), (3, 1), (4, 3)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_matches_jax(replicas, rank, drop_last):
    data = [{"i": np.asarray(i)} for i in range(23)]
    for shuffle in (False, True):
        args = dict(shuffle=shuffle, drop_last=drop_last, seed=11,
                    num_replicas=replicas, rank=rank)
        got, want = DataLoader(data, 4, **args), JDataLoader(data, 4, **args)
        assert len(got) == len(want)
        for epoch in (0, 1):
            assert _indices(got, epoch) == _indices(want, epoch)


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_loader_workers_on_a_dataset_without_epoch(worker_type):
    data = [{"i": np.asarray(i)} for i in range(10)]
    loader = DataLoader(data, 3, shuffle=True, seed=1, num_workers=2,
                        worker_type=worker_type)
    try:
        plain = DataLoader(data, 3, shuffle=True, seed=1)
        for epoch in (0, 1):
            assert _indices(loader, epoch) == _indices(plain, epoch)
    finally:
        loader.close()


def test_reconstruct_predict_and_profile(tmp_path):
    model = FlowMixtureModel(**CONFIG)
    state = create_train_state(
        model, make_optimizer(list(model.parameters()), **HP))
    data = _dataset(12, 9)
    loops.train(DataLoader(data, B), make_train_step(model, state.optimizer),
                state, 0, 0, False, device="cpu",
                profile_dir=str(tmp_path / "trace"), profile_steps=1)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    timer = profiling.StepTimer()
    for _ in range(2):
        timer.start()
        timer.stop({"loss": torch.ones(())})
    assert len(timer.times) == 2 and timer.mean == sum(timer.times) / 2
    step = make_sample_step(model, 20, "autoencoding")
    loader = DataLoader(data, 5, drop_last=False)
    samples, gts, labels = loops.predict(
        loader, step, torch.Generator().manual_seed(2), str(tmp_path / "out"),
        device="cpu")
    assert samples.shape == (12, 3, 20) and labels.shape == (12, 20)
    np.testing.assert_array_equal(gts, np.stack([d["cloud"] for d in data]))
    for name, arr in (("all_samples", samples), ("all_gts", gts),
                      ("all_labels", labels)):
        np.testing.assert_array_equal(
            np.load(tmp_path / "out" / f"{name}.npy"), arr)
    again, _, _ = loops.reconstruct(loader, step,
                                    torch.Generator().manual_seed(2),
                                    device="cpu", max_batches=2)
    np.testing.assert_array_equal(again, samples[:10])
