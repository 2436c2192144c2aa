"""Host-side data handling (counterpart of go_with_the_flows_tpu/data).
The port keeps its own copies: it imports nothing of the JAX package."""

from .loader import DataLoader

__all__ = ["DataLoader"]
