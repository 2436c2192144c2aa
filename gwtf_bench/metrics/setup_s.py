"""Seconds from the process's start to the window: imports, the kernel
library (built only on a checkout's first run), weights, the input pool,
the checked and warm-up steps."""


def read(ctx):
    return ctx["setup_s"]
