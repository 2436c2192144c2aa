"""Data-parallel training in the port (parallel/dist.py and what uses it)
on the CPU: two gloo ranks, spawned with a file:// rendezvous in the
test's tmp_path (so that parallel test workers never meet on a port),
each spawn joined within 120 s or the test fails. At a small width (2
components, 2 flows of f=8, N=16, a global batch of 8 clouds, 4 a rank):

  * BatchNorm on two ranks against the whole batch in one process:
    outputs, input gradients and running statistics;
  * film_ab_train and the plain versions of kernels 7 and 8 on two
    ranks against the whole batch in one process;
  * two train steps on two ranks against the JAX package's
    single-device step on the whole batch (its mesh semantics are the
    global batch's), from the same numpy weights and noise, and a third
    step whose noise each rank draws from the shared generator against
    the port's own step on the whole batch; the ranks' parameters equal
    bit for bit;
  * place_batch_uneven, trim and gather_global on an uneven tail, and
    the errors of place_batch and gather_global on uneven shapes;
  * pairwise_EMD_CD_F1 with its rows split over the ranks against one
    process; the sample step's noise, drawn for the global batch (the
    ranks' clouds differ), and evaluate over the ranks' shards in
    autoencoding and generating modes, equal on both ranks;
  * checkpoints: rank 0 writes, checkpoint_exists and restore give every
    rank rank 0's file (rank 1's logging_path stays empty); a rank-0
    failure in save and in restore fails both ranks;
  * cli/train_ae with --distributed -g 2 --device cpu for one epoch (a
    subprocess, started when the first test starts and run beside it);
  * the group an all_reduce runs in: the gloo group for a CPU tensor
    (the default group may be NCCL, which takes no CPU tensor), the
    default group for a device tensor.

Tolerances. Two ranks add their partial sums in another order than one
process: BatchNorm, the decode and the gathers within 1e-5 (relative to
the largest entry where the values spread widely), the statistics rtol
1e-5. Against JAX, those of tests/test_torch_port_train_step.py, for the
same reasons: metrics rtol 1e-4, running statistics atol 1e-4,
parameters atol 5e-4 (AMSGrad's normalised step moves a parameter whose
gradient is rounding noise by up to lr), the two loss-invariant walkers
to their +-lr walk. The flat gradient before the first update, against
the port's one-process step, within 1e-4 of its largest entry; the
pairwise matrices equal.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from go_with_the_flows_tpu_torch.data.synthetic import (
    write_synthetic_meshes_h5,
)
from go_with_the_flows_tpu_torch.eval.evaluating import evaluate
from go_with_the_flows_tpu_torch.metrics.evaluation import pairwise_EMD_CD_F1
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
    _KERNEL_KEYS,
    film_ab_train,
    pack_point_decoder_train,
    train_decode_bwd_plain,
    train_decode_fwd_plain,
)
from go_with_the_flows_tpu_torch.ops.layers import BatchNorm
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.parallel import dist
from go_with_the_flows_tpu_torch.train.checkpoints import (
    _ckpt_dir,
    checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
)
from go_with_the_flows_tpu_torch.train.state import create_train_state
from go_with_the_flows_tpu_torch.train.step import (
    make_sample_step,
    make_train_step,
)
from go_with_the_flows_tpu_torch.utils.config import write_config

JOIN_SECONDS = 120
WORLD = 2
B, N, G = 8, 16, 12
CONFIG = dict(
    n_components=2, params_reduce_mode="none",
    weights_type="learned_weights", g_latent_space_size=G,
    g_prior_n_flows=2, g_prior_n_features=8, g_posterior_n_layers=1,
    p_latent_space_size=3, p_prior_n_layers=1, p_decoder_n_flows=2,
    p_decoder_n_features=8, p_decoder_base_type="free",
    p_decoder_base_var=-3.9551, pc_enc_init_n_features=8,
    pc_enc_n_features=(8, 16),
)
HP = dict(epoch_length=4, cycle_length=2, min_lr=1e-3, max_lr=2e-3,
          beta1=0.9, min_beta2=0.99, max_beta2=0.999, wd=1e-4)


# --------------------------------------------------------------------- #
# spawning                                                              #
# --------------------------------------------------------------------- #

def _entry(rank, init, fn, args):
    torch.set_num_threads(1)
    dist.distributed_init("gloo", init, WORLD, rank, timeout=60)
    try:
        fn(rank, *args)
    finally:
        dist.shutdown()


def _spawn(tmp_path, fn, *args):
    """Start fn(rank, *args) on each of WORLD spawned ranks; returns
    join(), which fails the test if a rank raised or the ranks were not
    done within JOIN_SECONDS of the start."""
    init = f"file://{tmp_path}/rendezvous_{fn.__name__}"
    ctx = mp.start_processes(_entry, args=(init, fn, args), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS

    def join():
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{fn.__name__}: the ranks were not done "
                            f"within {JOIN_SECONDS} s")

    return join


def _shard(x, rank, dim=0):
    """Rank `rank`'s rows of a tensor or an array, along `dim`."""
    per = x.shape[dim] // WORLD
    part = x[(slice(None),) * dim + (slice(rank * per, (rank + 1) * per),)]
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# --------------------------------------------------------------------- #
# the ranks' work                                                       #
# --------------------------------------------------------------------- #

def _inputs():
    """Inputs of the BatchNorm and decode checks, the same in every
    process: point features (2, B, 5, N), latents (B, 6), a small decoder
    and its FiLM latents, a state (2, B, 3, N) and cotangents."""
    gen = torch.Generator().manual_seed(3)
    x_pts = 0.7 * torch.randn(2, B, 5, N, generator=gen) + 0.3
    x_lat = torch.randn(B, 6, generator=gen)
    model = FlowMixtureModel(**CONFIG, generator=gen)
    with torch.no_grad():
        for q in model.pc_decoder.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
    packed = {k: v.detach().contiguous() for k, v in
              pack_point_decoder_train(model.pc_decoder).items()}
    g = torch.randn(B, G, generator=gen)
    p = 0.5 * torch.randn(2, B, 3, N, generator=gen)
    cot = [torch.randn(t.shape, generator=gen) for t in (x_pts, x_lat, p, p)]
    return x_pts, x_lat, packed, g, p, cot


def _batch_norms(x_pts, x_lat, cot_pts, cot_lat):
    """Two train-mode BatchNorms (points, stacked (2,); latents): outputs,
    input gradients and running statistics."""
    out = {}
    for name, bn, x, cot in (("pts", BatchNorm(5, stack=(2,)), x_pts,
                              cot_pts),
                             ("lat", BatchNorm(6), x_lat, cot_lat)):
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, bn.weight.numel())
                            .reshape(bn.weight.shape))
        x = x.clone().requires_grad_()
        y = bn(x)
        (y * cot).sum().backward()
        out[name] = (y.detach(), x.grad, bn.running_mean.clone(),
                     bn.running_var.clone())
    return out


def _decode(packed, g, p, dp0, dlv):
    """film_ab_train and kernels 7 and 8's plain versions: over the
    global batch inside a process group, over p's batch outside one."""
    ab, film_stats = film_ab_train(packed, g)
    ab = ab.detach().contiguous()
    p0, lv, xsave, stats = train_decode_fwd_plain(packed, ab, p)
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv)
    return {"ab": ab, "film": film_stats, "p0": p0, "lv": lv,
            "stats": stats, "dp": dp, "grads": grads, "dab": dab}


def _train_port(model, steps, eps=None, generator=None):
    """The port's train steps; per step the metrics and the state dict,
    and the flat gradient of the first."""
    opt = make_optimizer(list(model.parameters()), **HP)
    step = make_train_step(model, opt)
    out, grad = [], None
    for g_in, p_in, warmup in steps:
        m = step(g_in, p_in, generator, warmup=warmup, posterior_eps=eps)
        if grad is None:
            grad = opt.flat_grad.clone()
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out, grad


def _core_rank(rank, out_dir, data):
    x_pts, x_lat, packed, g, p, cot = _inputs()
    res = {"bn": _batch_norms(_shard(x_pts, rank, 1), _shard(x_lat, rank),
                              _shard(cot[0], rank, 1), _shard(cot[1], rank))}
    res["decode"] = _decode(packed, _shard(g, rank), _shard(p, rank, 1),
                            _shard(cot[2], rank, 1), _shard(cot[3], rank, 1))

    # train steps: two from JAX's weights and noise, a third with noise
    # drawn from the shared generator
    model = FlowMixtureModel(**CONFIG)
    model.load_state_dict(data["state_dict"])
    g_in, p_in = (_shard(torch.from_numpy(data[k]), rank)
                  for k in ("g_in", "p_in"))
    eps = _shard(torch.from_numpy(data["eps"]), rank)
    res["steps"], res["grad"] = _train_port(
        model, [(g_in, p_in, False)] * 2, eps=eps)
    gen = torch.Generator().manual_seed(11)
    res["steps"] += _train_port(model, [(g_in, p_in, False)],
                                generator=gen)[0]

    # placement and gathers on an uneven tail: 3 rows on rank 0, 2 on 1
    rows = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    mine = rows[:3] if rank == 0 else rows[3:]
    host, trim = dist.place_batch_uneven({"x": mine})
    res["padded"] = host["x"].shape[0]
    res["gathered"] = trim(dist.gather_global(host["x"]))
    res["batch"] = dist.gather_batch({"x": mine[:2]})["x"]
    res["placed"] = dist.place_batch({"x": rows[:4]})["x"].numpy()
    errors = []
    try:
        dist.place_batch({"x": rows})
    except ValueError as e:
        errors.append(str(e))
    try:
        dist.gather_global(mine)
    except ValueError as e:
        errors.append(str(e))
    res["errors"] = errors

    res["pairwise"] = pairwise_EMD_CD_F1(
        data["samples"], data["refs"], 10, emd_option=True, f1_option=True,
        device="cpu")

    # sampling: each rank's rows of draws for the global batch; evaluate
    # over the ranks' shards of two batches
    clouds = {"cloud": data["g_in"], "eval_cloud": data["p_in"]}
    generated = make_sample_step(model, N, mode="generating")(
        torch.from_numpy(_shard(data["g_in"], rank)),
        torch.Generator().manual_seed(2))
    res["generated"] = [dist.gather_global(t) for t in generated[:2]]
    batches = [{k: _shard(v[i:i + B // 2], rank) for k, v in clouds.items()}
               for i in (0, B // 2)]
    res["evaluate"] = [evaluate(
        batches, make_sample_step(model, N, mode=mode),
        torch.Generator().manual_seed(3), "cpu", util_mode=mode, cd=True,
        f1=True) for mode in ("autoencoding", "generating")]

    # checkpoints: rank 1's logging_path stays empty
    path = os.path.join(out_dir, f"logs_rank{rank}")
    state = create_train_state(model, make_optimizer(
        list(model.parameters()), **HP), seed=5)
    state.step = 7
    save_checkpoint(path, "m.pkl", state, 3, 1)
    fresh = FlowMixtureModel(**CONFIG,
                             generator=torch.Generator().manual_seed(9))
    restored = create_train_state(fresh, make_optimizer(
        list(fresh.parameters()), **HP), seed=6)
    restored, epoch, it = restore_checkpoint(path, "m.pkl", restored)
    res["ckpt"] = {
        "exists": checkpoint_exists(path, "m.pkl"),
        "missing": checkpoint_exists(path, "other.pkl"),
        "on_disk": os.path.isdir(path),
        "meta": (epoch, it, restored.step),
        "same": all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), fresh.state_dict().values())),
        "generator": torch.equal(restored.generator.get_state(),
                                 state.generator.get_state()),
    }
    failures = []
    for what in ("restore", "save"):
        try:
            if what == "restore":
                restore_checkpoint(path, "absent.pkl", restored)
            else:  # rank 0's logging_path is a file
                bad = os.path.join(out_dir, f"file_rank{rank}")
                open(bad, "w").close()
                save_checkpoint(bad, "m.pkl", state, 0, 0)
        except Exception as e:  # noqa: BLE001  (recorded for the test)
            failures.append((what, type(e).__name__))
    res["failures"] = failures
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"core_{rank}.pt"))


# --------------------------------------------------------------------- #
# the tests                                                             #
# --------------------------------------------------------------------- #

def _jax_init():
    """The JAX model (its init jitted) and numpy weights, statistics,
    clouds and noise, as tests/test_torch_port_train_step.py makes
    them; and what the ranks get of them."""
    import functools

    import jax

    from go_with_the_flows_tpu.models.mixture import (
        FlowMixtureModel as JFlowMixtureModel,
    )
    from go_with_the_flows_tpu_torch.utils.flax_import import (
        state_dict_from_flax,
    )

    rng = np.random.RandomState(0)
    g_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    p_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    eps = rng.randn(B, G).astype(np.float32)
    jm = JFlowMixtureModel(**CONFIG, scan_couplings=False)
    key = jax.random.PRNGKey(1)
    v = jax.jit(functools.partial(jm.init, mode="training"))(
        {"params": key, "sample": key}, g_in, p_in)
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": jax.tree.map(
            lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"]),
    }
    data = {"g_in": g_in, "p_in": p_in, "eps": eps,
            "state_dict": state_dict_from_flax(variables, CONFIG)}
    return jm, variables, data


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """train_ae --distributed -g 2 --device cpu for one epoch, started in
    the background as soon as the module's first test asks for it (its
    ranks run while that test computes its JAX reference): (process,
    directory, start time)."""
    from test_torch_port_cli import TINY_CONFIG

    tmp = tmp_path_factory.mktemp("dist_cli")
    write_synthetic_meshes_h5(str(tmp / "meshes.h5"), n_shapes=8)
    write_config(dict(TINY_CONFIG, path2data=str(tmp),
                      path2save=str(tmp / "results")),
                 str(tmp / "config.yaml"))
    cmd = [sys.executable, "-m", "go_with_the_flows_tpu_torch.cli.train_ae",
           str(tmp / "config.yaml"), "dp", "1", "0.001",
           "--weights_type", "learned_weights", "--warmup_epoch", "1",
           "--jobid", "t2", "--distributed", "-n", "1", "-g", "2",
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


def test_two_ranks_match_one_process(tmp_path, monkeypatch, cli_run):
    from test_torch_port_train_step import HP as STEP_HP
    from test_torch_port_train_step import _jax_steps
    assert STEP_HP == HP  # _jax_steps's optimizer

    jm, variables, data = _jax_init()
    rng = np.random.RandomState(4)
    data["samples"] = rng.rand(5, N, 3).astype(np.float32)
    data["refs"] = rng.rand(4, N, 3).astype(np.float32)
    join = _spawn(tmp_path, _core_rank, str(tmp_path), data)
    # the JAX package's two steps on the whole batch while the ranks run
    want = _jax_steps(jm, variables, data["g_in"], data["p_in"],
                      data["eps"], [False, False], monkeypatch, CONFIG)
    join()
    got = [torch.load(tmp_path / f"core_{r}.pt", weights_only=False)
           for r in range(WORLD)]

    # BatchNorm against the whole batch in one process
    x_pts, x_lat, packed, g, p, cot = _inputs()
    whole = _batch_norms(x_pts, x_lat, cot[0], cot[1])
    for name, dim in (("pts", 1), ("lat", 0)):
        y, dx, rm, rv = whole[name]
        parts = [r["bn"][name] for r in got]
        assert _rel(torch.cat([q[0] for q in parts], dim), y) < 1e-5, name
        assert _rel(torch.cat([q[1] for q in parts], dim), dx) < 1e-5, name
        for q in parts:
            np.testing.assert_allclose(q[2], rm, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(q[3], rv, rtol=1e-5, atol=1e-6)

    # film_ab_train and kernels 7 and 8's plain versions with the exchange
    ref = _decode(packed, g, p, cot[2], cot[3])
    dec = [r["decode"] for r in got]
    for key, dim in (("ab", 1), ("p0", 1), ("lv", 1), ("dp", 1), ("dab", 1)):
        assert _rel(torch.cat([d[key] for d in dec], dim), ref[key]) < 1e-5, \
            key
    for d in dec:
        for a, b in zip(d["film"], ref["film"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(d["stats"], ref["stats"], rtol=1e-5,
                                   atol=1e-6)
    for k in _KERNEL_KEYS:
        assert _rel(dec[0]["grads"][k] + dec[1]["grads"][k],
                    ref["grads"][k]) < 1e-5, k

    # train steps: the ranks agree bit for bit, and with JAX and the port
    for (m0, sd0), (m1, sd1) in zip(got[0]["steps"], got[1]["steps"]):
        assert m0 == m1
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    from test_torch_port_train_step import WALKERS
    model = FlowMixtureModel(**CONFIG)
    buffers = {name for name, _ in model.named_buffers()}
    for t, (want_metrics, want_sd) in enumerate(want):
        metrics, sd = got[0]["steps"][t]
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-4,
                                       err_msg=f"step {t} {k}")
        walk = 2 * 1.5 * (t + 1) * HP["max_lr"]
        for name, value in sd.items():
            diff = np.abs(value.numpy() - want_sd[name].numpy()).max()
            bound = (walk if name in WALKERS
                     else 1e-4 if name in buffers else 5e-4)
            assert diff <= bound, (t, name, diff, bound)
    # against the port's one-process steps: the reduced gradient, and the
    # third step's generator-drawn noise
    model.load_state_dict(data["state_dict"])
    g_in, p_in = torch.from_numpy(data["g_in"]), torch.from_numpy(
        data["p_in"])
    one, grad = _train_port(model, [(g_in, p_in, False)] * 2,
                            eps=torch.from_numpy(data["eps"]))
    one += _train_port(model, [(g_in, p_in, False)],
                       generator=torch.Generator().manual_seed(11))[0]
    assert _rel(got[0]["grad"], grad) < 1e-4
    for t in range(3):
        for k, v in one[t][0].items():
            np.testing.assert_allclose(got[0]["steps"][t][0][k], v,
                                       rtol=1e-5, err_msg=f"step {t} {k}")

    # placement and gathers
    rows = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    for r, res in enumerate(got):
        assert res["padded"] == 3
        np.testing.assert_array_equal(res["gathered"], rows)
        np.testing.assert_array_equal(res["batch"],
                                      np.concatenate([rows[:2], rows[3:5]]))
        np.testing.assert_array_equal(res["placed"], rows[2 * r:2 * r + 2])
        assert len(res["errors"]) == 2
        assert "not divisible" in res["errors"][0]
        assert "different shapes" in res["errors"][1]

    # sampling and evaluate: the ranks' clouds draw different noise, and
    # every rank ends with the same gathered numbers
    samples, labels = got[0]["generated"]
    half = B // 2
    assert samples.shape == (B, 3, N)
    assert not np.allclose(samples[:half], samples[half:])
    assert labels.min() >= 1 and labels.max() <= CONFIG["n_components"]
    for a, b in zip(got[0]["generated"], got[1]["generated"]):
        np.testing.assert_array_equal(a, b)
    assert got[0]["evaluate"] == got[1]["evaluate"]
    assert all(np.isfinite(v) for r in got[0]["evaluate"] for v in r.values())

    # pairwise matrices with their rows split over the ranks
    want_pw = pairwise_EMD_CD_F1(data["samples"], data["refs"], 10,
                                 emd_option=True, f1_option=True,
                                 device="cpu")
    for res in got:
        for a, b in zip(res["pairwise"], want_pw):
            np.testing.assert_array_equal(a, b)

    # checkpoints: rank 0's file on every rank, rank 1's path empty, and
    # rank 0's failures fail both ranks
    for r, res in enumerate(got):
        ck = res["ckpt"]
        assert ck["exists"] and not ck["missing"]
        assert ck["meta"] == (3, 1, 7)
        assert ck["same"] and ck["generator"]
        assert ck["on_disk"] == (r == 0)
        assert [w for w, _ in res["failures"]] == ["restore", "save"]
    assert got[0]["failures"][0][1] == "FileNotFoundError"
    assert got[1]["failures"] == [("restore", "RuntimeError"),
                                  ("save", "RuntimeError")]


def test_train_ae_distributed_cli(cli_run):
    """train_ae --distributed -g 2 --device cpu: two spawned ranks train
    one epoch of 2 global batches of 4 clouds and validate; rank 0
    writes the checkpoints and prints."""
    proc, tmp, started = cli_run
    try:
        out, _ = proc.communicate(
            timeout=max(JOIN_SECONDS - (time.monotonic() - started), 1.0))
    except subprocess.TimeoutExpired:
        pytest.fail(f"train_ae --distributed was not done within "
                    f"{JOIN_SECONDS} s")
    assert proc.returncode == 0, out[-4000:]
    exp = str(tmp / "results" / "dp_t2")
    saved = torch.load(os.path.join(_ckpt_dir(exp, "dp.ckpt"),
                                    "checkpoint.pt"), weights_only=True)
    assert saved["epoch"] == 1 and saved["step"] == 2
    assert all(torch.isfinite(v).all() for v in saved["model_state"].values())
    assert os.path.isfile(os.path.join(_ckpt_dir(exp, "best_model_dp.ckpt"),
                                       "checkpoint.pt"))
    assert out.count("epoch 0: train") == 1, out[-4000:]


@pytest.mark.parametrize("device,cpu_group", [("cpu", True), ("meta", False)])
def test_all_reduce_group(monkeypatch, device, cpu_group):
    """An all_reduce of a CPU tensor (evaluate_val's count-weighted sums)
    goes to the gloo group that distributed_init makes beside an NCCL
    default group; one of a device tensor (a meta tensor stands in for a
    CUDA one here) to the default group."""
    gloo = object()
    seen = []
    monkeypatch.setattr(dist, "_cpu_group", gloo)
    monkeypatch.setattr(dist, "active", lambda: True)
    monkeypatch.setattr(dist, "world_size", lambda: 2)
    monkeypatch.setattr(dist.tdist, "all_reduce",
                        lambda t, group=None: seen.append(group))
    t = torch.ones(3, dtype=torch.float64, device=device)
    dist.all_reduce_mean(t)
    dist.sum_over_ranks(t)
    assert seen == [gloo if cpu_group else None] * 2
