"""Kernel 7's (the decoder's train-mode inverse) share of its roofline."""

from gwtf_bench.rooflines import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "train_decode_fwd")
