"""Kernel 8's (the decoder's backward) share of its roofline."""

from gwtf_bench.rooflines import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "train_decode_bwd")
