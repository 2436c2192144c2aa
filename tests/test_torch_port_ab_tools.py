"""The port's two training A/B tools against the JAX package's, on the
CPU: tools/train_convergence_ab.py and tools/svr_quality_ab.py.

  * (a) their model, seeds and optimizer recipe against the JAX tools'
    sources, read through `ast` (importing the JAX tools would put the
    repository on sys.path and load jax for nothing): the flagship's
    keys against bench.py's FLAGSHIP, the SVR model's keyword arguments,
    the optimizer's, the RandomState, PRNGKey and warmup constants, the
    evaluation's mode, batch and F1 threshold, the flags' defaults;
  * (b) their synthetic batches equal to the JAX tools' `make_batch`
    (nested in each tool's main, taken from its source) for the same
    seed, the SVR images after the layout change ((B, 4, H, W) here,
    (B, H, W, 4) there);
  * (c) each `run` at a tiny width on the CPU (2 flows of f=8, a few
    steps): the JAX output's keys, every loss and metric finite, the
    curve's steps; the card asked for by default.

Tolerance: none; the batches are equal bit for bit.
"""

import ast
import math
import os

import numpy as np
import pytest
import torch

from go_with_the_flows_tpu_torch.tools import (svr_quality_ab,
                                               train_convergence_ab)
from go_with_the_flows_tpu_torch.utils.config import FLAGSHIP_AIRPLANE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(FLAGSHIP_AIRPLANE, n_components=2, g_latent_space_size=12,
            g_prior_n_flows=2, g_prior_n_features=12, p_decoder_n_flows=2,
            p_decoder_n_features=8, pc_enc_init_n_features=8,
            pc_enc_n_features=(8, 16), params_reduce_mode="none")


def _tree(name):
    with open(os.path.join(ROOT, name)) as f:
        return ast.parse(f.read())


def _main(tree):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _calls(node, name):
    """The calls in `node` to a function or method called `name`, in
    source order."""
    calls = [c for c in ast.walk(node) if isinstance(c, ast.Call) and (
        getattr(c.func, "id", None) == name
        or getattr(c.func, "attr", None) == name)]
    return sorted(calls, key=lambda c: (c.lineno, c.col_offset))


def _literal_keywords(call, skip=()):
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg not in skip}


def _defaults(main):
    """{flag: default} of the tool's add_argument calls."""
    return {ast.literal_eval(c.args[0]).lstrip("-"):
            ast.literal_eval(next(k.value for k in c.keywords
                                  if k.arg == "default"))
            for c in _calls(main, "add_argument")}


def _int_args(main, name):
    return [ast.literal_eval(c.args[0]) for c in _calls(main, name)]


def _nested(main, name, scope):
    """A function nested in the tool's main, compiled in `scope`."""
    node = next(n for n in main.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[node], type_ignores=[]), "<jax tool>",
                 "exec"), scope)
    return scope[name]


# ------------------------------------------------------------------ #
# (a) model, seeds and optimizer                                       #
# ------------------------------------------------------------------ #

def test_convergence_recipe_is_the_jax_tools():
    main = _main(_tree(os.path.join("tools", "train_convergence_ab.py")))
    bench = _tree("bench.py")
    flagship = next(n.value for n in bench.body if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == "FLAGSHIP")
    n_points = next(n.value for n in bench.body if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == "N")
    # bench.py leaves p_decoder_base_var at the JAX model's default
    assert dict(_literal_keywords(flagship), p_decoder_base_var=-3.9551) \
        == FLAGSHIP_AIRPLANE
    assert ast.literal_eval(n_points) == train_convergence_ab.N_POINTS
    (opt,) = _calls(main, "make_optimizer")
    assert _literal_keywords(opt, skip=("epoch_length",)) == \
        train_convergence_ab.OPTIMIZER
    assert ast.unparse(next(k.value for k in opt.keywords
                            if k.arg == "epoch_length")) == "args.steps"
    assert _int_args(main, "RandomState") == [0]
    assert _int_args(main, "PRNGKey") == [0, 1]  # init, posterior noise
    warmup = [k.value for c in _calls(main, "step") for k in c.keywords
              if k.arg == "warmup"]
    assert [ast.unparse(w) for w in warmup] == [
        f"i < {train_convergence_ab.WARMUP_STEPS}"]
    centers = next(n.value for n in main.body if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "centers")
    np.testing.assert_array_equal(
        np.array(ast.literal_eval(centers.args[0])),
        train_convergence_ab.CENTERS)
    assert _defaults(main) == {
        "steps": 300, "b": 64, "log_every": 50,
        "variants": ",".join(train_convergence_ab.VARIANTS)}


def test_svr_recipe_is_the_jax_tools():
    main = _main(_tree(os.path.join("tools", "svr_quality_ab.py")))
    (model,) = _calls(main, "FlowMixtureSVRModel")
    assert _literal_keywords(model) == svr_quality_ab.MODEL
    (opt,) = _calls(main, "make_optimizer")
    assert _literal_keywords(opt, skip=("epoch_length",)) == \
        svr_quality_ab.OPTIMIZER
    # the first batch (init only), the evaluation set, the stream
    assert _int_args(main, "RandomState") == [
        0, svr_quality_ab.EVAL_SEED, svr_quality_ab.STREAM_SEED]
    # init, the posterior noise, the reconstruction
    assert _int_args(main, "PRNGKey") == [
        0, svr_quality_ab.NOISE_SEED, svr_quality_ab.RECON_SEED]
    warmup = [k.value for c in _calls(main, "step") for k in c.keywords
              if k.arg == "warmup"]
    assert [ast.unparse(w) for w in warmup] == [
        f"i < {svr_quality_ab.WARMUP_STEPS}"]
    scopes = [ast.unparse(c.args[0])
              for c in _calls(main, "matmul_precision_scope")]
    assert scopes == ["mode", repr(svr_quality_ab.EVAL_MODE)]
    (tab,) = _calls(main, "EMD_CD_F1")
    assert _literal_keywords(tab) == dict(
        batch_size=svr_quality_ab.EVAL_BATCH, cd_option=True,
        emd_option=True, f1_option=True,
        f1_threshold=svr_quality_ab.F1_THRESHOLD)
    (rec,) = _calls(main, "make_sample_step")
    assert _literal_keywords(rec) == {"mode": "reconstruction", "svr": True}
    assert _defaults(main) == {"steps": 400, "b": 16, "n": 512, "hw": 137,
                               "modes": "highest,fast", "eval_s": 64}


# ------------------------------------------------------------------ #
# (b) the synthetic batches                                            #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("b,n", [(3, 50), (2, 2048)])
def test_convergence_stream_is_the_jax_tools(b, n):
    main = _main(_tree(os.path.join("tools", "train_convergence_ab.py")))
    scope = {"np": np, "rng": np.random.RandomState(0), "B": b, "N": n,
             "centers": train_convergence_ab.CENTERS}
    make_batch = _nested(main, "make_batch", scope)
    got = list(train_convergence_ab.stream(4, b, n))
    assert len(got) == 4
    for batch in got:
        want = make_batch()
        assert batch.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(batch, want)


@pytest.mark.parametrize("seed,b,n,hw", [(0, 3, 40, 17), (123, 2, 512, 137),
                                         (1, 4, 64, 24)])
def test_svr_batches_are_the_jax_tools(seed, b, n, hw):
    main = _main(_tree(os.path.join("tools", "svr_quality_ab.py")))
    make_batch = _nested(main, "make_batch", {"np": np, "N": n, "HW": hw})
    want_rng, got_rng = (np.random.RandomState(seed) for _ in range(2))
    for _ in range(2):  # the stream's second batch too
        want_c, want_i = make_batch(want_rng, b)
        got_c, got_i = svr_quality_ab.make_batch(got_rng, b, n, hw)
        np.testing.assert_array_equal(got_c, want_c)
        assert got_i.shape == (b, 4, hw, hw) and got_i.dtype == np.float32
        np.testing.assert_array_equal(got_i.transpose(0, 2, 3, 1), want_i)
        assert got_i[:, :3].sum() > 0


# ------------------------------------------------------------------ #
# (c) the tools at a tiny size                                         #
# ------------------------------------------------------------------ #

def _json_keys(main):
    """The keys of the dict the JAX convergence tool prints a variant."""
    (dump,) = [c for c in _calls(main, "dumps")
               if isinstance(c.args[0], ast.Dict)]
    return {ast.literal_eval(k) for k in dump.args[0].keys}


def _svr_result_keys(main):
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Subscript)
                and getattr(n.targets[0].value, "id", None) == "results")
    return {ast.literal_eval(k) for k in node.value.keys}


@pytest.fixture
def one_thread():
    """One intra-op thread for the tiny runs: beside the other test
    workers, torch's threads contend for the cores and a run that takes
    seconds alone takes minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_convergence_run_tiny(capsys, one_thread):
    """Three variants, 4 steps of 3 clouds of 32 points, logged at steps
    1, 2 and 4: the JAX lines' keys, each printed, finite losses."""
    main = _main(_tree(os.path.join("tools", "train_convergence_ab.py")))
    lines = train_convergence_ab.run(steps=4, b=3, log_every=2,
                                     device="cpu", model_kwargs=TINY,
                                     n_points=32)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 3
    assert [line["variant"] for line in lines] == list(
        train_convergence_ab.VARIANTS)
    for line in lines:
        assert set(line) == _json_keys(main)
        assert line["steps"] == 4 and line["wall_s"] >= 0
        assert [s for s, _ in line["losses"]] == [1, 2, 4]
        assert all(math.isfinite(v) for _, v in line["losses"])
    # the modules at 'highest' and the plain kernels at 'high' follow
    # nearly the same path from the same start
    first = [line["losses"][0][1] for line in lines]
    assert abs(first[0] - first[1]) <= 1e-2 * abs(first[0])


def test_svr_run_tiny(one_thread):
    """Two modes, 3 steps of 2 clouds of 32 points and 16 x 16 images,
    4 reconstructions scored: the JAX result's keys, finite values."""
    main = _main(_tree(os.path.join("tools", "svr_quality_ab.py")))
    small = dict(svr_quality_ab.MODEL, g_latent_space_size=12,
                 g_prior_n_flows=2, g_prior_n_features=12,
                 p_decoder_n_flows=2, p_decoder_n_features=8,
                 pc_enc_init_n_features=8, pc_enc_n_features=(8, 16))
    results = svr_quality_ab.run(steps=3, b=2, n=32, hw=16,
                                 modes=("highest", "fast"), eval_s=4,
                                 device="cpu", model_kwargs=small)
    assert list(results) == ["highest", "fast"]
    for res in results.values():
        assert set(res) == _svr_result_keys(main)
        assert [s for s, _ in res["loss_curve"]] == [1, 2, 3]
        assert res["final_loss"] == res["loss_curve"][-1][1]
        for key in ("final_loss", "recon_CD_x1e4", "recon_EMD_x1e2",
                    "recon_F1"):
            assert math.isfinite(res[key]), key
        assert 0.0 <= res["recon_F1"] <= 100.0  # in %, as JAX's
    assert results["highest"]["loss_curve"] != results["fast"]["loss_curve"]


@pytest.mark.parametrize("tool", ["convergence", "svr"])
def test_tools_ask_for_the_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        if tool == "convergence":
            train_convergence_ab.main(["--steps", "1"])
        else:
            svr_quality_ab.main(["--steps", "1"])
