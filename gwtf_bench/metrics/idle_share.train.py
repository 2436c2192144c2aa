"""The share of the window in which the device had nothing to do:
100 (1 - busy a step x steps / window), the device's busy time a step
from the profiled slice (the profiler slows the host, not the device)
and the steps and length from the traced run's unprofiled window."""


def read(ctx):
    traced = ctx.get("trace")
    if not traced or traced["busy_s"] <= 0.0 or not ctx.get("steps"):
        return None
    busy = traced["busy_s"] / traced["steps"] * ctx["steps"]
    return 100.0 * (1.0 - busy / ctx["window_s"])
