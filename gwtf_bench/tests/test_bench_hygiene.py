"""What the benchmark's process may load, and runs that must print no
result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from gwtf_bench import run

ROOT = run.ROOT
BENCH = run.BENCH_DIR


def _sources(*parts):
    base = os.path.join(BENCH, *parts)
    for dirpath, _, files in os.walk(base):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _python(code, env=None, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_sources_import_no_jax():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert not name.split(".")[0].startswith("go_with_the_flows"), \
                (path, name)
    out = _python("import sys, gwtf_bench.reference.train as t; "
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    assert not any(m.startswith("go_with_the_flows")
                   for m in json.loads(out.stdout.replace("'", '"')))


def test_a_run_loads_no_jax():
    """The harness, every reader and the port's modules the kinds load:
    no top-level name of jax, jaxlib, flax or the JAX package (compared
    whole: the port's name begins with the JAX package's)."""
    code = (
        "import gwtf_bench.run as r, gwtf_bench.calibrate, "
        "gwtf_bench.kinds.train\n"
        "s = r.Spec()\n"
        "[r.reader(m['name']) for m in s.raw['end_to_end'] + "
        "s.raw['per_layer']]\n"
        "import go_with_the_flows_tpu_torch.models.mixture, "
        "go_with_the_flows_tpu_torch.optim, "
        "go_with_the_flows_tpu_torch.train.loops, "
        "go_with_the_flows_tpu_torch.train.step, "
        "go_with_the_flows_tpu_torch.train.state, "
        "go_with_the_flows_tpu_torch.utils.config, "
        "go_with_the_flows_tpu_torch.ops.kernels.build\n"
        "print(r.forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_compares_whole_top_level_names():
    out = _python("import sys, types, gwtf_bench.run as r\n"
                  "sys.modules['go_with_the_flows_tpu_torch_x'] = "
                  "types.ModuleType('x')\n"
                  "print(r.forbidden_modules())\n"
                  "sys.modules['go_with_the_flows_tpu.models'] = "
                  "types.ModuleType('y')\n"
                  "print(r.forbidden_modules())")
    assert out.stdout.split("\n")[:2] == ["[]", "['go_with_the_flows_tpu']"]


def _no_result(proc):
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines()
                if line.startswith("{")]


def _bench_cmd():
    raw = run.Spec().raw
    return raw["command"][1:] + ["--workload", raw["workloads"][0]["name"],
                                 "--seed", "3000000000", "--seconds", "1",
                                 "--trace", "0"]


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_RUN="x")
    proc = subprocess.run([sys.executable, *_bench_cmd()], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    _no_result(proc)


def test_a_run_with_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gwtf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, *_bench_cmd()], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    _no_result(proc)


@pytest.mark.parametrize("argv", [["--workload", "no.such.cell", "--seed",
                                   "1", "--seconds", "1"]])
def test_an_unknown_cell_prints_no_result(argv):
    proc = subprocess.run([sys.executable, "-m", "gwtf_bench.run", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    _no_result(proc)
