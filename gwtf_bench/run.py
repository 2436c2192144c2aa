"""Run one cell of the benchmark once:

    python3 -m gwtf_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Everything a cell needs is found by the names in BENCHMARK.json:
its configuration (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`, whose `kind` names its code in `kinds/`), the
limits of its output check (`limits/<cell>.json`) and one reader per
metric (`metrics/<metric>.py`). With --trace 0 the line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, breakdown with --trace 1, and last the numbers
compared with their limits, which are also the last lines of standard
error). Without a card, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "go_with_the_flows_tpu")


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json")):
        with open(path) as f:
            self.raw = json.load(f)
        self.configs = {c["name"]: c for c in self.raw["configs"]}
        self.workloads = {w["name"]: w for w in self.raw["workloads"]}

    def cell(self, name: str) -> Dict:
        if name not in self.workloads:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(self.workloads)}")
        return self.workloads[name]

    def config(self, cell: Dict) -> Dict:
        with open(os.path.join(ROOT, self.configs[cell["config"]]["file"])) \
                as f:
            return json.load(f)

    @staticmethod
    def traffic(cell: Dict) -> Dict:
        with open(os.path.join(BENCH_DIR, "traffic",
                               f"{cell['traffic']}.json")) as f:
            return json.load(f)

    @staticmethod
    def limits(cell: Dict) -> Dict:
        with open(os.path.join(BENCH_DIR, "limits",
                               f"{cell['name']}.json")) as f:
            return json.load(f)

    def metrics(self, cell: Dict, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or with `trace` its per-layer
        ones: each metric whose `workloads` list the cell, or that has no
        such list."""
        group = self.raw["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    """metrics/<name>.py's `read(ctx)`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gwtf_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind_module(kind: str):
    return importlib.import_module(f"gwtf_bench.kinds.{kind}")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own CUDA library builds into its package's `_build/`)."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", hooks: Optional[Dict] = None,
             config: Optional[Dict] = None,
             t_start: float = T_START) -> Dict:
    """One run of cell `name`: the result's line as a dict. `config`
    replaces the configuration's file and `hooks` reach into the kind's run
    (tests run a small configuration on the CPU and plant faults)."""
    cell = spec.cell(name)
    cfg = spec.config(cell) if config is None else config
    traffic = spec.traffic(cell)
    ctx = kind_module(traffic["kind"]).run(
        cell=cell, cfg=cfg, traffic=traffic, limits=spec.limits(cell),
        seed=seed, seconds=seconds, trace=trace, device=device,
        hooks=hooks or {}, t_start=t_start)
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": ctx["device_kind"], "count": 1,
           "memory_peak_bytes": ctx["memory_peak_bytes"]}
    out = {"correct": ctx["correct"], "attempted": ctx["attempted"],
           "failed": ctx["failed"], "metrics": metrics, "device": dev}
    if trace and ctx.get("trace"):
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["wall_s"]
        out["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                            "idle_gaps": ctx["trace"]["idle_gaps"]}
    out["build_s"] = ctx["build_s"]  # the kernel library's compile, if any
    out["checks"] = ctx["checks"]
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    cache_dirs()
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s), this "
              f"machine has {have}: no result", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    result["device"]["power_limit"] = power_limit()
    found = forbidden_modules()
    if found:
        print(f"the process holds {found} once the window has closed: the "
              "benchmark measures the PyTorch port alone; no result",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
