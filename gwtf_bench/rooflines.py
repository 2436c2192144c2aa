"""A kernel's share of its roofline, from the profiled slice: the least
time its call's work can take at the published peaks (`kernels/<kernel>.py`
counts the work from shapes) over the device time of its CUDA kernels
(`kernels/<kernel>.json` names them) a call."""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Optional

from .peaks import bound_ms
from .trace import kernel_device_ms
from .work import decoder_shape

KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")


def kernel_roofline(ctx: Dict, kernel: str) -> Optional[float]:
    traced = ctx.get("trace")
    if not traced:
        return None
    with open(os.path.join(KERNELS, f"{kernel}.json")) as f:
        info = json.load(f)
    ms = kernel_device_ms(traced["kernel_ms"], info["cuda_kernels"])
    calls = traced["steps"] * info["calls_per_step"]
    if ms <= 0.0 or calls <= 0:
        return None
    cfg = ctx["cfg"]
    C, f = decoder_shape(cfg)
    work = importlib.import_module(f"gwtf_bench.kernels.{kernel}").work(
        cfg["n_components"], ctx["batch"], cfg["cloud_size"], C, f)
    return 100.0 * bound_ms(**work)[0] / (ms / calls)
