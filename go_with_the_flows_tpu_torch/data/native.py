"""ctypes bindings for the native C++ surface sampler (`csrc/sampler.cpp`,
the port's copy of the JAX package's sampler; counterpart of
go_with_the_flows_tpu/data/native.py).

The library is built with g++ and the JAX package's flags at first use
into `_build/libgwtf_sampler-<key>.so` beside the CUDA library. The key
hashes the source, the flags and what `-march=native` means to this g++
on this CPU, so a checkout carried to another host builds its own
library instead of loading one made for a different CPU. A failed build
raises: the port has no
fallback (the JAX package drops to numpy there). Meshes of 64 faces or
fewer take the numpy path in `cloud_sampling.sample_cloud` by a fixed
rule, not as a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "sampler.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _gxx(*args: str) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SRC}: {e}") from e


def lib_path() -> str:
    """The library's path for this source, these flags and this host:
    `g++ -march=native -Q --help=target` lists the target options that
    `-march=native` turns on here, which is what the machine code
    depends on."""
    target = _gxx("-march=native", "-Q", "--help=target")
    if target.returncode != 0:
        raise RuntimeError(f"g++ could not name this CPU's target "
                           f"({target.returncode}):\n{target.stderr}")
    key = hashlib.sha256()
    with open(SRC, "rb") as f:
        key.update(f.read())
    key.update(" ".join(GXX_FLAGS).encode())
    key.update(target.stdout.encode())
    return os.path.join(BUILD_DIR,
                        f"libgwtf_sampler-{key.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sampler unless this host's library is there; returns
    its path. Raises RuntimeError when g++ fails or is missing."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    out = _gxx(*GXX_FLAGS, "-o", tmp, SRC, "-pthread")
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC} ({out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or none
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded sampler library, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.gwtf_sample_cloud.argtypes = [
                f32p, ctypes.c_int64, u32p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64, f32p]
            lib.gwtf_sample_cloud.restype = None
            lib.gwtf_sample_batch.argtypes = [
                f32p, i64p, u32p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_int, f32p]
            lib.gwtf_sample_batch.restype = None
            _lib = lib
        return _lib


def sampler_threads() -> int:
    """The cores this process may run on (its CPU affinity)."""
    return len(os.sched_getaffinity(0))


def _check_mesh(vertices: np.ndarray, faces: np.ndarray) -> None:
    if vertices.ndim != 2 or vertices.shape[1] != 3 \
            or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"vertices {vertices.shape} and faces {faces.shape}"
                         " must be (V, 3) and (F, 3)")
    if len(faces) == 0:
        raise ValueError("a mesh without faces has no surface to sample")
    if faces.size and int(faces.max()) >= len(vertices):
        raise ValueError(f"a face indexes vertex {int(faces.max())} of "
                         f"{len(vertices)}")


def sample_cloud_native(vertices: np.ndarray, faces: np.ndarray,
                        n_samples: int, seed: int) -> np.ndarray:
    """(3, n_samples) float32 surface samples of one mesh."""
    lib = get_lib()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.uint32)
    _check_mesh(vertices, faces)
    out = np.empty((3, n_samples), np.float32)
    lib.gwtf_sample_cloud(vertices, len(vertices), faces, len(faces),
                          n_samples, np.uint64(seed & 0xFFFFFFFFFFFFFFFF),
                          out)
    return out


def sample_batch_native(vertices: np.ndarray, v_bounds: np.ndarray,
                        faces: np.ndarray, f_bounds: np.ndarray,
                        n_samples: int, seed: int) -> np.ndarray:
    """(batch, 3, n_samples) surface samples of a ragged batch of meshes
    (vertices and faces concatenated, `*_bounds` their prefix sums; each
    mesh's face indices are local to its own vertices), on one thread a
    core this process may run on, at most one a mesh. Each mesh draws
    from its own seed, so the thread count does not change the bits."""
    lib = get_lib()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.uint32)
    v_bounds = np.ascontiguousarray(v_bounds, np.int64)
    f_bounds = np.ascontiguousarray(f_bounds, np.int64)
    batch = len(v_bounds) - 1
    if len(f_bounds) != batch + 1 or v_bounds[-1] != len(vertices) \
            or f_bounds[-1] != len(faces):
        raise ValueError("bounds do not match the concatenated meshes")
    for b in range(batch):
        _check_mesh(vertices[v_bounds[b]:v_bounds[b + 1]],
                    faces[f_bounds[b]:f_bounds[b + 1]])
    n_threads = max(1, min(batch, sampler_threads()))
    out = np.empty((batch, 3, n_samples), np.float32)
    lib.gwtf_sample_batch(vertices, v_bounds, faces, f_bounds, batch,
                          n_samples, np.uint64(seed & 0xFFFFFFFFFFFFFFFF),
                          n_threads, out)
    return out
