"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates) and the least time a call can take at them."""

from __future__ import annotations

# FP32 outside the tensor cores; the special-function units (exp, rsqrt:
# 16 a clock per SM against 128 FP32 lanes, so 1/16 of the FP32 rate);
# the tensor cores' dense bf16 rate; HBM3
FP32_FLOPS = 67e12
SFU_OPS = FP32_FLOPS / 16
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
# an exp or a root can also run on the FP32 pipe as a polynomial: a range
# reduction (3 adds) and a degree-5 polynomial (5 FMAs), 13 FLOP
SFU_AS_FLOP = 13


def bound_ms(flop: float = 0.0, sfu: float = 0.0, nbytes: float = 0.0,
             peak: float = FP32_FLOPS):
    """(milliseconds, "operations" or "bytes"): the larger of the
    operations' time and the bytes' time at the HBM rate. The operations'
    time is `flop` at `peak`, the special-function operations split
    between their units and the FP32 pipe so that both finish soonest."""
    ops_s = max(flop / peak,
                min(sfu / SFU_OPS, (flop + SFU_AS_FLOP * sfu)
                    / (FP32_FLOPS + SFU_AS_FLOP * SFU_OPS)))
    bytes_s = nbytes / HBM_BYTES
    if ops_s >= bytes_s:
        return 1e3 * ops_s, "operations"
    return 1e3 * bytes_s, "bytes"
