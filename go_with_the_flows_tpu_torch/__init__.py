"""go_with_the_flows_tpu_torch — the PyTorch + CUDA port of
`go_with_the_flows_tpu`, for one NVIDIA H100.

The layout mirrors the JAX package so that every module has a counterpart
there: `ops/` (layers, precision, plain Chamfer), `ops/kernels/` (the
hand-written CUDA kernels that replace `ops/pallas/`, with their plain
PyTorch versions), `models/`, `metrics/`, `eval/`, `train/step.py` and
`utils/`. Kernel sources live in `csrc/` and are built at first use into
`_build/`.

The port imports torch and never jax. It runs in fp32 at the JAX
package's library default precision, 'highest' (`ops/precision.py`).
"""

__version__ = "0.1.0"
