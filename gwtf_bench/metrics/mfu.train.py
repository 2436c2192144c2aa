"""The window's needed training FLOP (`work.train_flop_per_cloud` times
the clouds trained) a second, as a share of the H100's FP32 peak; the
window is the traced run's unprofiled one."""

from gwtf_bench.peaks import FP32_FLOPS
from gwtf_bench.work import train_flop_per_cloud


def read(ctx):
    if not ctx.get("steps") or not ctx.get("trace"):
        return None
    flop = train_flop_per_cloud(ctx["cfg"], ctx["svr"]) * ctx["clouds"]
    return 100.0 * flop / ctx["window_s"] / FP32_FLOPS
