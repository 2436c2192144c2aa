"""The port's measuring tools against the JAX package's, on the CPU:
tools/protocol_bench.py (its line's keys and its CD metrics against the
JAX tool run as a subprocess with the same flags, within 1e-5 relative)
and tools/train_breakdown.py (the JAX tool's model, and at a tiny size
its lines' keys, the JAX line's plus the parts' `_device_ms`, every value
finite); both ask for the card by default and raise without one."""

import ast
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from go_with_the_flows_tpu_torch.tools import protocol_bench, train_breakdown
from go_with_the_flows_tpu_torch.utils.config import (FLAGSHIP_AIRPLANE,
                                                      model_config_kwargs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of the JAX tools' lines (tools/protocol_bench.py:95-109,
# tools/train_breakdown.py:137-149)
PROTOCOL_KEYS = {"s", "r", "n", "backend", "device_kind", "cd_matrix_sec",
                 "emd_matrix_sec", "protocol_sec", "warm_rep_sec",
                 "protocol_min_10rep", "mmd_cd", "nna_cd"}
BREAKDOWN_KEYS = {"mode", "B", "fwd_ms", "grad_ms", "evalfwd_ms", "step_ms",
                  "clouds_per_sec"}

TINY = dict(FLAGSHIP_AIRPLANE, n_components=2, g_latent_space_size=12,
            g_prior_n_flows=2, g_prior_n_features=12, p_decoder_n_flows=2,
            p_decoder_n_features=8, pc_enc_init_n_features=8,
            pc_enc_n_features=(8, 16), params_reduce_mode="none")


def test_protocol_bench_against_the_jax_tool():
    """s = r = 4 clouds of 32 points with EMD: the JAX line's keys and the
    card's power limit beside them; mmd_cd and nna_cd within 1e-5
    relative of the JAX tool's; every time positive."""
    got = protocol_bench.run(4, 4, 32, emd=True, device="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "protocol_bench.py"),
         "--s", "4", "--r", "4", "--n", "32"],
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(want) == PROTOCOL_KEYS
    assert set(got) == PROTOCOL_KEYS | {"power_limit"}
    assert (got["s"], got["r"], got["n"]) == (4, 4, 32)
    assert got["backend"] == "cpu" and got["power_limit"] is None
    for key in ("mmd_cd", "nna_cd"):
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=0), key
    for key in ("cd_matrix_sec", "emd_matrix_sec", "protocol_sec",
                "warm_rep_sec", "protocol_min_10rep"):
        assert got[key] > 0 and math.isfinite(got[key]), key


def test_protocol_bench_matrices_and_no_emd():
    """`matrices` receives the clouds and the timed matrices; --no-emd
    leaves the EMD time null; the CLI prints the line."""
    matrices = {}
    line = protocol_bench.main(["--s", "3", "--r", "2", "--n", "16",
                                "--no-emd", "--device", "cpu"])
    assert line["emd_matrix_sec"] is None
    protocol_bench.run(3, 2, 16, emd=True, device="cpu", matrices=matrices)
    gen, ref = protocol_bench.clouds(3, 2, 16)
    assert (matrices["gen"] == gen).all() and (matrices["ref"] == ref).all()
    assert matrices["cd"].shape == matrices["emd"].shape == (3, 2)
    assert (matrices["emd"] > 0).all()


def _jax_tool_model():
    """FLAGSHIP_CONFIG and N of tools/tpu_drift_audit.py, from its
    source (importing it would put the reference's path on sys.path)."""
    path = os.path.join(REPO, "tools", "tpu_drift_audit.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body if isinstance(n, ast.Assign) and any(
        getattr(t, "id", None) == "FLAGSHIP_CONFIG"
        or isinstance(t, ast.Tuple) for t in n.targets)]
    scope = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"),
         scope)
    return scope["FLAGSHIP_CONFIG"], scope["N"]


def test_train_breakdown_model_is_the_jax_tools():
    config, n = _jax_tool_model()
    assert train_breakdown.FLAGSHIP_CONFIG == config
    assert train_breakdown.N == n == 2048
    assert model_config_kwargs(train_breakdown.FLAGSHIP_CONFIG) == \
        FLAGSHIP_AIRPLANE


def test_train_breakdown_tiny_on_the_cpu(capsys):
    """2 flows of f=8, N=32, B=2, one call a part, in all three modes:
    one printed line a mode with the JAX line's keys and the four
    `_device_ms`, every value finite and every time positive."""
    lines = train_breakdown.run(b=(2,), modes=("highest", "high", "fast"),
                                iters=1, device="cpu", model_kwargs=TINY,
                                n_points=32)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [(x["mode"], x["B"]) for x in lines] == [
        ("highest", 2), ("high", 2), ("fast", 2)]
    device_keys = {f"{p}_device_ms" for p in train_breakdown.PARTS}
    for line in lines:
        assert set(line) == BREAKDOWN_KEYS | device_keys
        for key, value in line.items():
            if key != "mode":
                assert math.isfinite(value) and value > 0, key


@pytest.mark.parametrize("tool", ["protocol_bench", "train_breakdown"])
def test_tools_ask_for_the_card(monkeypatch, tool):
    """Without a card the default device raises, never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        if tool == "protocol_bench":
            protocol_bench.run(2, 2, 8)
        else:
            train_breakdown.run(b=(2,), modes=("highest",), iters=1,
                                model_kwargs=TINY, n_points=8)
