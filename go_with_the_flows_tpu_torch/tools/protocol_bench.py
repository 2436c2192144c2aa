"""Protocol-scale generative-eval benchmark (the port of the JAX
package's tools/protocol_bench.py, with its flags, its clouds and its
line):

    python -m go_with_the_flows_tpu_torch.tools.protocol_bench \\
        [--s 405] [--r 405] [--n 2048] [--no-emd] [--device cuda]

Times the whole airplane-protocol metric computation, the rs, rr and ss
pairwise matrices behind MMD / COV / 1-NNA (the reference's
evaluation_metrics.py:232-309; the airplane test split is 405 clouds of
2048 points, scripts/run_evaluate_gen.sh), through the port's
metrics/evaluation.py on the card: kernel 3 (`pairwise_cd_stats`) for
CD and F1 and kernel 4 (`pairwise_emd`) for EMD. The clouds are
RandomState(0) normal draws times 0.2, generated first, then the
reference. After a warm-up on a 2 x 3 corner it times the CD matrix, the
EMD matrix, a cold protocol (rs + rr + ss with CD, F1 and, unless
--no-emd, EMD, then the host's reductions) and a warm one that reuses
the rr matrices through `ref_cache`, as evaluate_ae's 10 reps do. Each
time is the host's clock between two synchronizes of the device.

Prints one JSON line: s, r, n, backend ("cuda" or "cpu"), device_kind
(the card's name), power_limit (nvidia-smi's, or null), cd_matrix_sec,
emd_matrix_sec (null with --no-emd), protocol_sec, warm_rep_sec,
protocol_min_10rep (one cold and nine warm reps, in minutes), mmd_cd and
nna_cd (the cold protocol's lgan_mmd-CD and 1-NN-CD-acc).
`run` takes the sizes and the device, so that a test can call it small
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..metrics.evaluation import compute_all_metrics, pairwise_EMD_CD_F1

BATCH_SIZE = 60  # the JAX tool's; the port's pair grid does not read it


def clouds(s: int, r: int, n: int):
    """(generated, reference) clouds (S, N, 3) and (R, N, 3), float32."""
    rng = np.random.RandomState(0)
    gen = (rng.randn(s, n, 3) * 0.2).astype(np.float32)
    ref = (rng.randn(r, n, 3) * 0.2).astype(np.float32)
    return gen, ref


def power_limit() -> Optional[str]:
    """The first card's power limit as nvidia-smi gives it ("700.00 W"),
    or None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device: torch.device):
    """(seconds, result) of fn() on the host's clock, between two
    synchronizes of the device."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def run(s: int = 405, r: int = 405, n: int = 2048, emd: bool = True,
        batch_size: int = BATCH_SIZE, device="cuda",
        matrices: Optional[Dict] = None) -> Dict:
    """The benchmark's line as a dict (the module's docstring lists its
    keys). `matrices`, when given a dict, receives the clouds ("gen",
    "ref") and the timed CD and EMD matrices ("cd", "emd"), so that a
    caller can hold them against other versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    gen, ref = clouds(s, r, n)
    opts = dict(batch_size=batch_size, f1_option=True, device=device)
    # warm the kernels on a small matrix
    pairwise_EMD_CD_F1(gen[:2], ref[:3], emd_option=emd, **opts)

    cd_matrix_sec, cd = _seconds(
        lambda: pairwise_EMD_CD_F1(gen, ref, emd_option=False, **opts),
        device)
    emd_matrix_sec, emd_m = None, None
    if emd:
        emd_matrix_sec, emd_m = _seconds(
            lambda: pairwise_EMD_CD_F1(gen, ref, emd_option=True, **opts),
            device)
    if matrices is not None:
        matrices.update(gen=gen, ref=ref, cd=cd[0],
                        emd=None if emd_m is None else emd_m[1])

    # the whole protocol: rs + rr + ss with CD (+ EMD) + F1, then the host's
    # MMD / COV / 1-NNA reductions; the first rep computes rr, the next
    # reuse it through ref_cache
    ref_cache: Dict = {}

    def protocol():
        return compute_all_metrics(gen, ref, cd_option=True, emd_option=emd,
                                   ref_cache=ref_cache, **opts)

    protocol_sec, res = _seconds(protocol, device)
    warm_rep_sec, _ = _seconds(protocol, device)
    if device.type == "cuda":
        kind, limit = torch.cuda.get_device_name(device), power_limit()
    else:
        kind, limit = "cpu", None
    return {
        "s": s, "r": r, "n": n,
        "backend": device.type,
        "device_kind": kind,
        "power_limit": limit,
        "cd_matrix_sec": cd_matrix_sec,
        "emd_matrix_sec": emd_matrix_sec,
        "protocol_sec": protocol_sec,
        "warm_rep_sec": warm_rep_sec,
        "protocol_min_10rep": (protocol_sec + 9 * warm_rep_sec) / 60.0,
        "mmd_cd": float(res["lgan_mmd-CD"]),
        "nna_cd": float(res["1-NN-CD-acc"]),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--s", type=int, default=405)
    ap.add_argument("--r", type=int, default=405)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--no-emd", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = run(args.s, args.r, args.n, emd=not args.no_emd,
               device=args.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
