"""The readings the output check's limits are set from, for a training
cell, in one process and with no window:

    python3 -m gwtf_bench.calibrate --workload <cell> --seeds S1 S2 ...
        [--control-seeds C1 C2 ...] [--fault-seeds F1 F2 ...]

For each seed the program's checked steps against the float32 reference
(the lower readings); for each control seed the reference itself in TF32,
the nearest precision below the configuration's float32, put in the
program's place; for each fault seed the program with half of each batch
left out. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import faults
from .kinds.train import Program, gaps, reference_batches
from .reference.train import follow
from .run import Spec, cache_dirs


def readings(spec: Spec, name: str, seed: int, control: bool, fault: bool,
             device: str = "cuda", config=None):
    cell = spec.cell(name)
    cfg = spec.config(cell) if config is None else config
    traffic = spec.traffic(cell)
    steps = traffic["checked_steps"]
    prog = Program(cfg, traffic, seed, device, {})
    mine = prog.checked(steps)
    prog.free()
    dev = torch.device(device)
    batches = reference_batches(prog.pool, steps, seed,
                                cfg["g_latent_space_size"], prog.svr, dev)
    ref = follow(prog.weights0, batches, cfg, prog.epoch_length)
    out = {"seed": seed, "program": gaps(mine, ref, True)}
    if control:
        tf32 = follow(prog.weights0, batches, cfg, prog.epoch_length,
                      full_fp32=False)
        out["control_tf32"] = gaps(tf32, ref, True)
    if fault:
        bad = Program(cfg, traffic, seed, device,
                      {"step": faults.half_batch})
        out["fault_half_batch"] = gaps(bad.checked(steps), ref, True)
        bad.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cache_dirs()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA device")
    spec = Spec()
    for seed in dict.fromkeys(args.seeds + args.control_seeds
                              + args.fault_seeds):
        t0 = time.perf_counter()
        out = readings(spec, args.workload, seed,
                       seed in args.control_seeds, seed in args.fault_seeds)
        out["seconds"] = time.perf_counter() - t0
        out["workload"] = args.workload
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
