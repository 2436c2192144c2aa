"""Data-parallel single-view reconstruction training in the port on the
CPU: two gloo ranks, spawned as tests/test_torch_port_distributed.py
spawns them (a file:// rendezvous in the test's tmp_path, joined within
120 s), each with its half of a global batch of 4 (4 x 32 x 32 images,
K=2, 2 flows of f=8, g=16: tests/test_torch_port_svr.py's model under
the real ResNet-18 widths).

  * two SVR train steps on two ranks against the JAX package's
    single-device SVR step on the whole batch (its mesh semantics are the
    global batch's), from the same numpy weights and posterior noise, the
    second step from the JAX state after the first (as
    tests/test_torch_port_svr.py steps); the ResNet's BatchNorms take
    their statistics over the global batch, as the JAX TorchBatchNorm
    does under a sharded batch;
  * after the first step, the ResNet's running statistics against the
    port's one-process step on the whole batch (torch's fused
    batch_norm there), and the ranks' parameters and statistics equal
    bit for bit after each step;
  * cli/train_svr with --distributed -g 2 --device cpu for one epoch (a
    subprocess, started when the first test starts and run beside it).

Tolerances: against JAX those of tests/test_torch_port_distributed.py:
metrics rtol 1e-4 (atol 1e-4, as tests/test_torch_port_svr.py holds the
SVR metrics), running statistics atol 1e-4, parameters atol 5e-4, and
tests/test_torch_port_svr.py's allowance for the rounding-level sign
flips of AMSGrad's first normalised step and the loss-invariant walkers.
The ResNet's running statistics against one process within 1e-5 of each
tensor's largest entry: E[x^2] - E[x]^2 summed over two ranks against
torch's fused statistics, blended at momentum 0.9 (a running mean near 0
differs by 4e-5 of itself, 1.4e-7).
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from go_with_the_flows_tpu_torch.data.synthetic import (
    write_synthetic_images_h5,
    write_synthetic_meshes_h5,
)
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureSVRModel
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.parallel import dist
from go_with_the_flows_tpu_torch.train.checkpoints import _ckpt_dir
from go_with_the_flows_tpu_torch.train.step import make_train_step
from go_with_the_flows_tpu_torch.utils.config import write_config
from go_with_the_flows_tpu_torch.utils.flax_import import state_dict_from_flax
from test_torch_port_distributed import JOIN_SECONDS, WORLD, _shard, _spawn

STEPS = 2

# the JAX side (and tests/test_torch_port_svr.py, which imports it) is
# imported in the test's process only, not in the spawned ranks


def _inputs():
    """The seeded weights, clouds, images and posterior noise of the
    comparison, as numpy (the JAX side's and, through the port's names,
    the ranks')."""
    import jax
    import jax.numpy as jnp

    from go_with_the_flows_tpu.models.mixture import (
        FlowMixtureSVRModel as JFlowMixtureSVRModel,
    )
    from test_torch_port_svr import (B, CONFIG, _dataset, _nhwc,
                                     _running_stats, _stack)

    rng = np.random.RandomState(0)
    batch = _dataset(B, 1)
    g_in, p_in = _stack(batch, "cloud"), _stack(batch, "eval_cloud")
    images = _stack(batch, "image")
    eps = rng.randn(B, CONFIG["g_latent_space_size"]).astype(np.float32)
    jm = JFlowMixtureSVRModel(**CONFIG, scan_couplings=False)
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda g, p, im: jm.init({"params": key, "sample": key}, g,
                                         p, images=im, mode="training"))(
        jnp.asarray(g_in), jnp.asarray(p_in), _nhwc(images))
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": _running_stats(v["batch_stats"], rng),
    }
    return jm, variables, {"g_in": g_in, "p_in": p_in, "images": images,
                           "eps": eps}


def _jax_steps(jm, variables, data, monkeypatch):
    """STEPS JAX single-device SVR train steps on the whole batch, the
    posterior noise `eps`: per step (metrics, *_record(state))."""
    import jax
    import jax.numpy as jnp

    import go_with_the_flows_tpu.models.mixture as jmix
    from go_with_the_flows_tpu.optim import make_optimizer as j_make_optimizer
    from go_with_the_flows_tpu.train.state import TrainState as JTrainState
    from go_with_the_flows_tpu.train.step import (
        make_train_step as j_make_train,
    )
    from test_torch_port_svr import HP, _nhwc, _record

    eps = jnp.asarray(data["eps"])
    monkeypatch.setattr(jmix, "_reparameterize", lambda rng, mu, logvar:
                        mu + jnp.exp(0.5 * logvar) * eps[:mu.shape[0]])
    opt = j_make_optimizer(**HP)
    step = j_make_train(jm, opt, svr=True, fused_decoder=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=opt.init(params))
    out = []
    for _ in range(STEPS):
        state, metrics = step(state, jnp.asarray(data["g_in"]),
                              jnp.asarray(data["p_in"]),
                              jax.random.PRNGKey(0),
                              images=_nhwc(data["images"]), warmup=False)
        out.append(({k: float(x) for k, x in metrics.items()},)
                   + _record(state))
    return out


def _load_state(model, opt, record):
    """A recorded JAX state (tests/test_torch_port_svr.py's _record) into
    the port's model and AMSGrad moments."""
    sd, *moments = record
    model.load_state_dict(sd, strict=True)
    names = [n for n, _ in model.named_parameters()]
    for attr, tree in zip(("exp_avg", "exp_avg_sq", "max_exp_avg_sq"),
                          moments):
        getattr(opt, attr).copy_(torch.cat([tree[n].reshape(-1)
                                            for n in names]))


def _svr_rank(rank, out_dir, config, hp, start, data, jax_states):
    """Rank `rank`'s SVR train steps on its half of the batch: the first
    from `start`, each later one from the JAX state before it (waiting
    for the JAX steps, which the test's process computes meanwhile)."""
    model = FlowMixtureSVRModel(**config)
    model.load_state_dict(start, strict=True)
    opt = make_optimizer(list(model.parameters()), **hp)
    step = make_train_step(model, opt, svr=True)
    t = {k: torch.from_numpy(_shard(data[k], rank))
         for k in ("g_in", "p_in", "images", "eps")}
    out = []
    for i in range(STEPS):
        if i:
            while not os.path.exists(jax_states):
                time.sleep(0.2)
            records = torch.load(jax_states, weights_only=False)
            _load_state(model, opt, records[i - 1][1:])
        before = dict(dist.counts)
        metrics = step(t["g_in"], t["p_in"], posterior_eps=t["eps"],
                       images=t["images"])
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": {k: v.clone()
                              for k, v in model.state_dict().items()},
                    "all_reduce": dist.counts["all_reduce"]
                    - before["all_reduce"]})
    torch.save(out, os.path.join(out_dir, f"svr_{rank}.pt"))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """train_svr --distributed -g 2 --device cpu for one epoch, started in
    the background when the module's first test asks for it: (process,
    directory, start time)."""
    from test_torch_port_cli import SVR_CONFIG

    tmp = tmp_path_factory.mktemp("dist_svr_cli")
    write_synthetic_meshes_h5(str(tmp / "svr_meshes.h5"), n_shapes=2,
                              parts=("train", "test"))
    write_synthetic_images_h5(str(tmp / "images.h5"), n_shapes=2,
                              parts=("train", "test"), hw=20)
    write_config(dict(SVR_CONFIG, path2data=str(tmp),
                      path2save=str(tmp / "results")),
                 str(tmp / "svr.yaml"))
    cmd = [sys.executable, "-m", "go_with_the_flows_tpu_torch.cli.train_svr",
           str(tmp / "svr.yaml"), "dsvr", "1", "0.001",
           "--weights_type", "learned_weights", "--warmup_epoch", "1",
           "--jobid", "t3", "--distributed", "-n", "1", "-g", "2",
           "--coordinator", f"file://{tmp}/rendezvous_cli",
           "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    yield proc, tmp, time.monotonic()
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def test_two_ranks_match_jax_svr_step(tmp_path, monkeypatch, cli_run):
    from test_torch_port_svr import CONFIG, HP, _check_state

    jm, variables, data = _inputs()
    start = state_dict_from_flax(variables, CONFIG)
    jax_states = str(tmp_path / "jax_states.pt")
    join = _spawn(tmp_path, _svr_rank, str(tmp_path), CONFIG, HP, start,
                  data, jax_states)
    want = _jax_steps(jm, variables, data, monkeypatch)
    torch.save(want, jax_states + ".tmp")
    os.replace(jax_states + ".tmp", jax_states)
    join()
    got = [torch.load(tmp_path / f"svr_{r}.pt", weights_only=False)
           for r in range(WORLD)]

    # the ranks agree bit for bit, and with the JAX package's steps
    port = FlowMixtureSVRModel(**CONFIG)
    n_params = sum(p.numel() for p in port.parameters())
    for t in range(STEPS):
        a, b = got[0][t], got[1][t]
        assert a["metrics"] == b["metrics"]
        assert all(torch.equal(a["state"][k], b["state"][k])
                   for k in a["state"])
        for k, v in want[t][0].items():
            np.testing.assert_allclose(a["metrics"][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {t} {k}")
        port.load_state_dict(a["state"])
        flips = _check_state(port, want[t][1:], t + 1)
        assert flips <= 1e-3 * n_params, flips
    # the ResNet's 20 BatchNorms and fc_bn exchange their sums, forward
    # and backward, beside the rest of the step's all_reduces
    bns = sum(1 for name, _ in port.img_encoder.named_buffers()
              if name.endswith("running_mean"))
    assert bns == 21
    assert got[0][0]["all_reduce"] >= 2 * bns

    # against the port's one-process step on the whole batch: the
    # ResNet's running statistics after the first step
    one = FlowMixtureSVRModel(**CONFIG)
    one.load_state_dict(start, strict=True)
    step = make_train_step(one, make_optimizer(list(one.parameters()), **HP),
                           svr=True)
    metrics = step(*(torch.from_numpy(data[k]) for k in ("g_in", "p_in")),
                   posterior_eps=torch.from_numpy(data["eps"]),
                   images=torch.from_numpy(data["images"]))
    for k, v in metrics.items():
        np.testing.assert_allclose(got[0][0]["metrics"][k], float(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for name, value in one.img_encoder.named_buffers():
        diff = (got[0][0]["state"][f"img_encoder.{name}"] - value).abs()
        assert diff.max() <= 1e-5 * value.abs().max(), (name,
                                                       float(diff.max()))


def test_train_svr_distributed_cli(cli_run):
    """train_svr --distributed -g 2 --device cpu: two spawned ranks train
    one epoch of 3 global batches of 16 views (8 a rank); rank 0 writes
    the checkpoint and prints."""
    proc, tmp, started = cli_run
    try:
        out, _ = proc.communicate(
            timeout=max(JOIN_SECONDS - (time.monotonic() - started), 1.0))
    except subprocess.TimeoutExpired:
        pytest.fail(f"train_svr --distributed was not done within "
                    f"{JOIN_SECONDS} s")
    assert proc.returncode == 0, out[-4000:]
    exp = str(tmp / "results" / "dsvr_t3")
    saved = torch.load(os.path.join(_ckpt_dir(exp, "dsvr.ckpt"),
                                    "checkpoint.pt"), weights_only=True)
    assert saved["epoch"] == 1 and saved["step"] == 3
    assert all(torch.isfinite(v).all() for v in saved["model_state"].values())
    assert out.count("epoch 0: train") == 1, out[-4000:]
    assert out.count("Size of training data") == 1, out[-4000:]
