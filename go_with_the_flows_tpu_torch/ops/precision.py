"""Model matmul precision (counterpart of go_with_the_flows_tpu/ops/precision.py).

The port runs in fp32 at 'highest', the JAX package's library default.
PyTorch has three switches that decide whether fp32 products keep their
digits, and cuDNN convolutions default to TF32; all three are set here.
The JAX package's 'high' and 'fast' modes wait for an end-metric A/B on the
card, so they raise.
"""

from __future__ import annotations

import torch

_MODES = ("highest",)


def set_matmul_precision(mode: str) -> None:
    """Apply a precision mode to PyTorch's global matmul switches."""
    if mode not in _MODES:
        raise ValueError(
            f"matmul precision {mode!r} is not available in the port; "
            f"supported: {list(_MODES)}"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def get_matmul_precision() -> str:
    """'highest' when the three switches are in their fp32 setting."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("PyTorch's fp32 matmul switches were changed "
                           "away from 'highest'")
    return "highest"


set_matmul_precision("highest")
