"""Model matmul precision (counterpart of go_with_the_flows_tpu/ops/precision.py).

Three modes, as the JAX package's knob, each a way to form the model's
products of fp32 operands:

  * 'highest': fp32 products (the library default);
  * 'high': three bf16 partial products accumulated in fp32,
    hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b), where hi(x) is x rounded to
    bf16 and lo(x) the rounded residual x - hi(x) (the TPU kernels'
    `_mxdot`);
  * 'fast' (alias 'default'): one product of the operands rounded to
    bf16, accumulated in fp32.

A product of two bf16 values is exact in fp32, so `mxdot` below forms
those products with fp32 matmuls on rounded operands: the TPU's
arithmetic up to the order of the fp32 sums. None of the modes is TF32
(its 10-bit mantissa is coarser than the 'high' split): PyTorch's three
switches that decide whether fp32 products keep their digits (cuDNN
convolutions default to TF32) stay at fp32 in every mode.

The mode covers the model's own products (ops/layers.SharedDot and
Linear, the ResNet's convolutions and fc), kernel 1, the eval decode
(ops/kernels/point_decode.py), and kernels 7 and 8, the train-mode
decode and its backward (ops/kernels/train_decode.py). The metric ops
stay fp32 in every mode, and so do film_alpha_beta, film_ab_train and
the FiLM affines. A step reads the mode when it is built and keeps it
(train/step.py), as a JAX step keeps the mode it was traced with.

Gradients keep the mode: `mxdot`'s backward forms dA = dY B^T and
dB = A^T dY as products of the same mode, from the cotangent and the
operands each rounded (or split) anew, JAX's transpose of a dot_general
with its `precision` carried along; a gradient's result is never
rounded. Training runs in every mode.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

_MODES = ("highest", "high", "fast", "default")

_mode = "highest"


def _fp32_switches() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def set_matmul_precision(mode: str) -> None:
    """Set the model matmul precision: 'highest' | 'high' | 'fast' (or
    'default', which is 'fast')."""
    global _mode
    if mode not in _MODES:
        raise ValueError(
            f"matmul_precision must be one of {sorted(_MODES)}, got {mode!r}")
    _fp32_switches()
    _mode = "fast" if mode == "default" else mode


def get_matmul_precision() -> str:
    """The current mode ('default' reads as 'fast'); raises if one of
    PyTorch's fp32 switches was moved away from fp32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("PyTorch's fp32 matmul switches were changed "
                           "away from 'highest'")
    return _mode


@contextlib.contextmanager
def matmul_precision_scope(mode: str) -> Iterator[None]:
    """The mode `mode` for the body; the previous one back on exit."""
    prev = _mode
    set_matmul_precision(mode)
    try:
        yield
    finally:
        set_matmul_precision(prev)


def resolve(mode: Optional[str]) -> str:
    """`mode` by its canonical name, the current mode for None."""
    if mode is None:
        return get_matmul_precision()
    if mode not in _MODES:
        raise ValueError(
            f"matmul_precision must be one of {sorted(_MODES)}, got {mode!r}")
    return "fast" if mode == "default" else mode


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to the nearest bf16 (ties to even), back in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_split(x: torch.Tensor):
    """(hi, lo): hi = bf16_round(x), lo = bf16_round(x - hi)."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def _product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fast":
        return torch.matmul(bf16_round(a), bf16_round(b))
    a_hi, a_lo = bf16_split(a)
    b_hi, b_lo = bf16_split(b)
    return (torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_lo, b_hi))


class _ModeDot(torch.autograd.Function):
    """a @ b at 'high' or 'fast', each gradient a product of the same
    mode: dA = mxdot(dY, B^T), dB = mxdot(A^T, dY), summed over the
    dimensions the product broadcast."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return _product(a, b, mode)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = mxdot(dy, b.transpose(-1, -2), ctx.mode).sum_to_size(
                a.shape)
        if ctx.needs_input_grad[1]:
            db = mxdot(a.transpose(-1, -2), dy, ctx.mode).sum_to_size(
                b.shape)
        return da, db, None


def mxdot(a: torch.Tensor, b: torch.Tensor,
          mode: Optional[str] = None) -> torch.Tensor:
    """torch.matmul(a, b) of operands of at least two dimensions in a
    precision mode (the current one for None); the counterpart of the TPU
    kernels' `_mxdot`. Its gradients are products of the same mode (at
    'highest' torch.matmul's own)."""
    mode = resolve(mode)
    if mode == "highest":
        return torch.matmul(a, b)
    return _ModeDot.apply(a, b, mode)


set_matmul_precision("highest")
