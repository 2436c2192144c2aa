"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc`, all of them at once,
and the objects are linked into one shared library with a plain C
interface, `_build/libgwtf_torch_kernels.so`, which is loaded with
ctypes. The build runs at first use and again whenever a source is
newer than the library (as `go_with_the_flows_tpu/data/native.py` does
for the sampler). Nothing prebuilt is kept in the repository.

Every C entry point returns its `cudaGetLastError()` after the launch;
`check` turns a non-zero code into a RuntimeError. A machine without
`nvcc` cannot build the kernels: that is an error, never a fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libgwtf_torch_kernels.so")
PTXAS_LOG = os.path.join(BUILD_DIR, "ptxas.log")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# name -> argtypes; every entry returns int (a cudaError_t)
_SIGNATURES = {
    # p, weights, film, out, lv, K, B, C, N, f, inverse, stream
    "gwtf_point_decode": [_P] * 5 + [_I] * 6 + [_P],
    # a, b, dist_a, idx_a, dist_b, idx_b, col_d, col_i, B, N, M, stream
    "gwtf_nn_distance": [_P] * 8 + [_I] * 3 + [_P],
    # samples, refs, cdl, cdr, prec, rec, S, R, N, M, thr, stream
    "gwtf_pairwise_cd_stats": [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P],
    # a, b, cost, ratio_l, ratio_r, B, N, M, multi_l, multi_r, stream
    "gwtf_emd_cost": [_P] * 5 + [_I] * 3 + [ctypes.c_float] * 2 + [_P],
    # a, b, ratio_l, ratio_r, da, db, col, B, N, M, stream
    "gwtf_emd_backward": [_P] * 7 + [_I] * 3 + [_P],
    # samples, refs, cost, R, N, M, multi_l, multi_r, pair0, pairs, stream
    "gwtf_pairwise_emd": [_P] * 3 + [_I] * 3 + [ctypes.c_float] * 2
    + [_I] * 2 + [_P],
    # p, w0, s0, b0, w1, w2, b2, ab, p0, lv, xsave, stats, work,
    # K, B, C, N, f, stream
    "gwtf_train_decode_fwd": [_P] * 13 + [_I] * 5 + [_P],
    # xsave, stats, w0, s0, b0, w1, w2, b2, ab, dp0, dlv, dp, dw0, ds0,
    # db0, dw1, dw2, db2, dab, work, K, B, C, N, f, stream
    "gwtf_train_decode_bwd": [_P] * 20 + [_I] * 5 + [_P],
    # the SPMD form's stages: stage, c, n, the single entry's pointers,
    # sums_in, sums_out, K, B, C, N, f, stream
    "gwtf_train_decode_fwd_stage": [_I, _I, _D] + [_P] * 15 + [_I] * 5
    + [_P],
    "gwtf_train_decode_bwd_stage": [_I, _I, _D] + [_P] * 22 + [_I] * 5
    + [_P],
}
# entry points that return something else than a cudaError_t
_OTHER_SIGNATURES = {
    # which (0 forward, 1 backward, 2 SPMD backward), K, B, C, N, f ->
    # floats of scratch
    "gwtf_train_decode_workspace": ([_I] * 6, ctypes.c_longlong),
    # N -> row chunks of one launch (a scratch is needed above 1)
    "gwtf_nn_distance_chunks": ([_I], _I),
    "gwtf_emd_backward_chunks": ([_I], _I),
    "gwtf_error_string": ([_I], ctypes.c_char_p),
}

_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def is_stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build(force: bool = False) -> float:
    """Compile the library if it is missing or stale; returns the seconds
    spent compiling (0.0 when it was up to date). Raises on failure."""
    if not force and not is_stale():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in sources() if s.endswith(".cu")]
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
            for src in cu]
    tmp = f"{LIB_PATH}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, p, log in zip(cu, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    with open(PTXAS_LOG, "w") as f:
        f.write("".join(logs))
    os.replace(tmp, LIB_PATH)  # atomic: concurrent builders never see half
    return seconds


def load(path: str, names=None) -> ctypes.CDLL:
    """The library at `path` with the argument and return types of its C
    entry points: `names` (default: all of them; a library built from one
    source holds a few)."""
    lib = ctypes.CDLL(path)
    table = {name: (argtypes, ctypes.c_int)
             for name, argtypes in _SIGNATURES.items()}
    table.update(_OTHER_SIGNATURES)
    for name in table if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = table[name]
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        _lib = load(LIB_PATH)
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.gwtf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current stream on `device`, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_tensors(tensors, device) -> None:
    """Raise unless every tensor is contiguous float32 on `device`."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}: all "
                             "inputs of a kernel must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous float32, "
                             f"got {t.dtype}, contiguous={t.is_contiguous()}")
