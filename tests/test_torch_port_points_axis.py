"""The points axis of the port's rank grid (parallel/dist.py; the JAX
package's `make_mesh(points_parallelism=...)` and
`shard_batch(shard_points=True)`) on the CPU: gloo ranks as (data,
points) grids, spawned with a file:// rendezvous in the test's tmp_path
as tests/test_torch_port_distributed.py spawns them: 2 ranks as a (1, 2)
grid, each holding the whole batch's clouds and half of every cloud's
points, and 4 ranks as a (2, 2) grid, each half the clouds and half of
their points, the two grids spawned together. At that file's small
width (2 components, 2 flows of f=8, a batch of 8 clouds of 16 points):

  * two train steps on the module path against the JAX package's
    single-device step on the whole batch, from the same numpy weights
    and noise, and a third whose noise the ranks draw from the shared
    generator (each data row its rows of one draw for the whole batch)
    against the port's own step in one process; every rank's model equal
    bit for bit; the flat gradient before the first update against the
    port's one-process step;
  * the PointNet's max-pool over the points axis with ties inside a
    rank and across the ranks: its value and its gradient (the
    cotangent summed over the ranks and split evenly between the ties,
    as torch.amax splits it) against torch.amax on the whole cloud;
  * the refusals, with the axis named: the fused decoder (True and
    "plain") as JAX's step refuses it, the eval and sample steps,
    gather_global of a cloud whose points are split (a per-cloud array
    gathers over the data axis: the data rows' noise back whole);
    place_batch of points that do not divide; and, without a spawn, a
    world that does not divide into the grid.

Tolerances: those of tests/test_torch_port_distributed.py against JAX
(metrics rtol 1e-4, running statistics atol 1e-4, parameters atol 5e-4,
the two loss-invariant walkers to their +-lr walk); the gradient within
1e-4 of its largest entry and the drawn-noise step's metrics rtol 1e-5
against one process; the max-pool within 1e-6 (its value bit-equal).
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.parallel import dist
from go_with_the_flows_tpu_torch.train.step import (
    FUSED_POINTS_ERROR,
    make_eval_step,
    make_sample_step,
    make_train_step,
)
from test_torch_port_distributed import (
    CONFIG,
    HP,
    JOIN_SECONDS,
    N,
    _jax_init,
    _rel,
    _train_port,
)

GRIDS = ((1, 2), (2, 2))  # (data, points)


def _entry(rank, init, world, points, fn, args):
    torch.set_num_threads(1)
    dist.distributed_init("gloo", init, world, rank, timeout=60,
                          points_parallelism=points)
    try:
        fn(rank, *args)
    finally:
        dist.shutdown()


def _spawn(tmp_path, grid, fn, *args):
    """fn(rank, *args) on the ranks of a (data, points) grid, spawned;
    returns join(), which fails the test if a rank raised or the ranks
    were not done within JOIN_SECONDS."""
    world = grid[0] * grid[1]
    init = f"file://{tmp_path}/rendezvous_{fn.__name__}_{world}"
    ctx = mp.start_processes(_entry, args=(init, world, grid[1], fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS

    def join():
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{fn.__name__}: the ranks were not done "
                            f"within {JOIN_SECONDS} s")

    return join


def _tied_cloud_features():
    """(3, 4, N) features whose max over the last axis ties inside one
    half of the points, across the two halves, or is unique."""
    x = torch.randn(3, 4, N, generator=torch.Generator().manual_seed(5))
    x[0, 0, 2] = x[0, 0, 5] = 9.0          # a tie inside the first half
    x[0, 1, 3] = x[0, 1, N - 1] = 8.0      # a tie across the halves
    x[1, 2, [1, 4, N // 2, N // 2 + 3]] = 7.0  # two in each half
    return x


def _refusals(model, clouds):
    """The message of each refusal on a grid that splits points."""
    out = {}
    for name, fused in (("fused", "plain"), ("fused_true", True)):
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        try:
            make_train_step(model, opt, fused_decoder=fused)(
                clouds["cloud"], clouds["eval_cloud"],
                torch.Generator().manual_seed(0))
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    for name, build in (
            ("eval", lambda: make_eval_step(model)(
                clouds["cloud"], clouds["eval_cloud"],
                torch.Generator().manual_seed(0))),
            ("sample", lambda: make_sample_step(model, N)(
                clouds["cloud"], torch.Generator().manual_seed(0))),
            ("gather_split", lambda: dist.gather_global(clouds["cloud"])),
            ("place_odd", lambda: dist.place_batch(
                {"cloud": np.zeros((2, 3, 5), np.float32)},
                shard_points=True))):
        try:
            build()
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _rows(x, d, D):
    per = x.shape[0] // D
    return x[d * per:(d + 1) * per]


def _points_rank(rank, out_dir, data):
    D, P = dist.data_size(), dist.points_size()
    d, p = dist.data_rank(), dist.points_rank()
    res = {"grid": (D, P, d, p)}
    placed = dist.place_batch({"cloud": data["g_in"],
                               "eval_cloud": data["p_in"]},
                              shard_points=True)
    res["placed"] = {k: v.numpy() for k, v in placed.items()}
    eps = torch.from_numpy(_rows(data["eps"], d, D))

    model = FlowMixtureModel(**CONFIG)
    model.load_state_dict(data["state_dict"])
    res["steps"], res["grad"] = _train_port(
        model, [(placed["cloud"], placed["eval_cloud"], False)] * 2,
        eps=eps)
    res["steps"] += _train_port(
        model, [(placed["cloud"], placed["eval_cloud"], False)],
        generator=torch.Generator().manual_seed(11))[0]

    # the max-pool over the points axis, with ties
    x = _tied_cloud_features()
    cols = N // P
    mine = x[..., p * cols:(p + 1) * cols].clone().requires_grad_()
    cot = torch.randn(3, 4, generator=torch.Generator().manual_seed(6))
    m = dist.max_over_points(mine, 2)
    (m * cot).sum().backward()
    res["max"] = (m.detach(), mine.grad)

    # a per-cloud array gathers over the data axis; the refusals
    res["gather_ok"] = dist.gather_global(eps)
    res["refusals"] = _refusals(model, placed)
    torch.save(res, f"{out_dir}/points_{D}x{P}_{rank}.pt")


def test_points_grid_matches_one_process(tmp_path, monkeypatch):
    from test_torch_port_train_step import WALKERS, _jax_steps

    jm, variables, data = _jax_init()
    joins = [_spawn(tmp_path, grid, _points_rank, str(tmp_path), data)
             for grid in GRIDS]
    want = _jax_steps(jm, variables, data["g_in"], data["p_in"],
                      data["eps"], [False, False], monkeypatch, CONFIG)
    for join in joins:
        join()
    # the JAX-side and one-process references, then each grid against them
    model = FlowMixtureModel(**CONFIG)
    model.load_state_dict(data["state_dict"])
    g_in, p_in = (torch.from_numpy(data[k]) for k in ("g_in", "p_in"))
    one, grad = _train_port(model, [(g_in, p_in, False)] * 2,
                            eps=torch.from_numpy(data["eps"]))
    one += _train_port(model, [(g_in, p_in, False)],
                       generator=torch.Generator().manual_seed(11))[0]
    x = _tied_cloud_features().requires_grad_()
    cot = torch.randn(3, 4, generator=torch.Generator().manual_seed(6))
    m = x.amax(dim=2)
    (m * cot).sum().backward()
    for D, P in GRIDS:
        got = [torch.load(tmp_path / f"points_{D}x{P}_{r}.pt",
                          weights_only=False) for r in range(D * P)]
        _check_grid(D, P, got, data, want, one, grad, x, m, cot)


def _check_grid(D, P, got, data, want, one, grad, x, m, cot):
    from test_torch_port_train_step import WALKERS

    cols = N // P
    for r, res in enumerate(got):
        d, p = divmod(r, P)
        assert res["grid"] == (D, P, d, p)
        for k, full in (("cloud", data["g_in"]),
                        ("eval_cloud", data["p_in"])):
            np.testing.assert_array_equal(
                res["placed"][k],
                _rows(full, d, D)[:, :, p * cols:(p + 1) * cols])

    # every rank agrees bit for bit, and with JAX on the whole batch
    for res in got[1:]:
        for (m0, sd0), (m1, sd1) in zip(got[0]["steps"], res["steps"]):
            assert m0 == m1
            assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
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

    # against the port's one-process steps
    assert _rel(got[0]["grad"], grad) < 1e-4
    for t in range(3):
        for k, v in one[t][0].items():
            np.testing.assert_allclose(got[0]["steps"][t][0][k], v,
                                       rtol=1e-5, err_msg=f"step {t} {k}")

    # the max-pool and its ties against torch.amax on the whole cloud
    for res in got:
        assert torch.equal(res["max"][0], m.detach())
    # each rank's (m * cot).sum() is one copy of the loss, as each points
    # rank's loss is its data shard's (the optimizer averages the ranks'
    # gradients over the world): a data row's ranks' gradients are P x
    # torch.amax's
    for d in range(D):
        grads = torch.cat([res["max"][1] for res in got[d * P:(d + 1) * P]],
                          dim=2)
        torch.testing.assert_close(grads, P * x.grad, rtol=0, atol=1e-6)
    assert x.grad[0, 0, 2] == x.grad[0, 0, 5] == cot[0, 0] / 2
    assert x.grad[0, 1, 3] == x.grad[0, 1, N - 1] == cot[0, 1] / 2
    assert (x.grad[1, 2, [1, 4, N // 2, N // 2 + 3]] == cot[1, 2] / 4).all()

    for res in got:
        np.testing.assert_array_equal(res["gather_ok"], data["eps"])
        ref = res["refusals"]
        assert set(ref) == {"fused", "fused_true", "eval", "sample",
                            "gather_split", "place_odd"}, ref
        assert ref["fused"] == ref["fused_true"] == (
            "NotImplementedError", FUSED_POINTS_ERROR)
        for name in ("eval", "sample"):
            assert ref[name][0] == "NotImplementedError"
            assert "'points' axis has 2 ranks" in ref[name][1]
        assert ref["gather_split"][0] == "ValueError"
        assert "'points' axis" in ref["gather_split"][1]
        assert "5 points not divisible by the 2 ranks of the points " \
               "axis" in ref["place_odd"][1]


def test_points_grid_must_divide_the_world(tmp_path):
    """As make_mesh refuses it, before any rendezvous."""
    with pytest.raises(ValueError, match="3 devices not divisible by "
                                         "points=2"):
        dist.distributed_init("gloo", f"file://{tmp_path}/never", 3, 0,
                              timeout=5, points_parallelism=2)
    assert not dist.active() and dist.points_size() == 1


def test_points_size_one_changes_no_collective(monkeypatch):
    """points_parallelism=1 (the default): the data axis is the world,
    its reductions run in the world's groups, and a points reduction is
    no collective at all."""
    seen = []
    monkeypatch.setattr(dist, "world_size", lambda: 2)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    monkeypatch.setattr(dist.tdist, "all_reduce",
                        lambda t, group=None: seen.append(group))
    assert (dist.data_size(), dist.data_rank(), dist.points_size(),
            dist.points_rank()) == (2, 1, 1, 0)
    t = torch.ones(3)
    before = dict(dist.counts)
    assert dist.sum_over_ranks(t, "points") is t
    x = torch.randn(2, 3, 5)
    assert torch.equal(dist.max_over_points(x, 2), x.amax(dim=2))
    assert dist.counts == before and not seen
    dist.sum_over_ranks(t, "data")
    dist.sum_over_ranks(t)
    assert seen == [dist._cpu_group] * 2
    assert dist.counts["all_reduce"] == before["all_reduce"] + 2
