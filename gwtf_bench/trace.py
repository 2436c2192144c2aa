"""A profiled slice of the program's work, read from `torch.profiler`'s
events in memory (nothing is written to disk): the device's busy time,
the device time of each CUDA kernel by name, and the idle gaps between
device operations, each named by the host operation running then."""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _merged(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_slice(fn: Callable[[], None], sync: Callable[[], None]) -> Dict:
    """Run fn() under the profiler, the device synchronised on both ends.
    Returns wall_s (the slice on the host's clock), busy_s (the union of
    the device operations' intervals), kernel_ms {name: device ms},
    device_ops and idle_gaps ([name, seconds], the ten largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernel_ms: Dict[str, float] = defaultdict(float)
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            kernel_ms[e.key] += e.self_device_time_total / 1e3
    dev = _device_events(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    merged = _merged(spans)
    busy = sum(e - s for s, e in merged) / 1e6
    if not merged:  # no timeline: the kernels' summed time
        busy = sum(kernel_ms.values()) / 1e3
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    # the longest gaps between device operations, each named by the
    # innermost host operation that spans its middle
    between = sorted(((start - end, 0.5 * (start + end)) for (_, end), (
        start, _) in zip(merged, merged[1:])), reverse=True)[:200]
    gaps: Dict[str, float] = defaultdict(float)
    for length, mid in between:
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = "host idle"
        if inside.size:
            name = host[inside[np.argmin(ends[inside] - starts[inside])]].name
        gaps[_short(name)] += length / 1e6
    ops: Dict[str, float] = defaultdict(float)
    for k, v in kernel_ms.items():
        ops[_short(k)] += v / 1e3
    return {
        "wall_s": wall,
        "busy_s": busy,
        "kernel_ms": dict(kernel_ms),
        "device_ops": _top(ops),
        "idle_gaps": _top(gaps),
    }


def _short(name: str) -> str:
    """A CUDA kernel's or host operation's name without its return type,
    its namespace's `(anonymous namespace)` and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.sub(r"\(.*$", "", name).strip()[:96]


def _top(seconds: Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(seconds.items(),
                                      key=lambda kv: -kv[1])[:n]]


def kernel_device_ms(kernel_ms: Dict[str, float], names) -> float:
    """The summed device ms of the CUDA kernels whose name is one of
    `names` (templated or not)."""
    pattern = re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, names)))
    return sum(v for k, v in kernel_ms.items() if pattern.search(k))
