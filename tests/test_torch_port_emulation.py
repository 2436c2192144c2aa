"""The CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) itself: that a
missing __syncthreads shows, which the emulated kernel tests rely on,
and that a barrier only some threads reach ends the process with a
message instead of hanging it.

A small CUDA source, rewritten and built by g++ as the kernels' tests
build theirs, stages one value a thread through shared memory (the
dynamic kind, which the emulation fills with NaN, and the static kind,
which keeps what the last block wrote) and reads the next thread's.
With its barrier it must give the rotation exactly, two launches
bit-equal. Without it, the dynamic kind must read the NaN fill, and
both kinds must give two launches that differ: the emulation runs a
block's threads in an order drawn anew for every block, so a fixed
order, or one drawn once for every launch alike, fails here."""

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_port_point_decode_emulated import HERE, _emulated_source

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void rotate_dynamic(const float* in, float* out) {
  extern __shared__ float4 smem[];
  const int t = threadIdx.x, n = blockDim.x, base = blockIdx.x * n;
  smem[t].x = in[base + t];
#ifndef NO_BARRIER
  __syncthreads();
#endif
  out[base + t] = smem[(t + 1) % n].x;
}

__global__ void rotate_static(const float* in, float* out) {
  __shared__ float s[256];
  const int t = threadIdx.x, n = blockDim.x, base = blockIdx.x * n;
  s[t] = in[base + t];
#ifndef NO_BARRIER
  __syncthreads();
#endif
  out[base + t] = s[(t + 1) % n];
}

__global__ void partial_barrier(float* out) {
  if (threadIdx.x < 16) __syncthreads();
  out[threadIdx.x] = 1.f;
}

extern "C" int rotate(const float* in, float* out, int blocks, int threads,
                      int dynamic) {
  if (dynamic)
    rotate_dynamic<<<blocks, threads, threads * sizeof(float4), 0>>>(in, out);
  else
    rotate_static<<<blocks, threads, 0, 0>>>(in, out);
  return (int)cudaGetLastError();
}

extern "C" int partial(float* out, int threads) {
  partial_barrier<<<1, threads, 0, 0>>>(out);
  return (int)cudaGetLastError();
}
"""

BLOCKS, THREADS = 4, 256


def _build(out, barrier: bool) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    name = "staged" if barrier else "unstaged"
    cpp = out / f"{name}.cpp"
    cpp.write_text(_emulated_source(SOURCE))
    so = out / f"lib{name}.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-o", str(so), str(cpp)]
                           + ([] if barrier else ["-DNO_BARRIER"]),
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    return str(so)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulation")
    return {barrier: _build(out, barrier) for barrier in (True, False)}


def _rotate(path, x, dynamic):
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rotate.argtypes = [P, P, I, I, I]
    out = np.full_like(x, 7.0)
    assert lib.rotate(x.ctypes.data, out.ctypes.data, BLOCKS, THREADS,
                      int(dynamic)) == 0
    return out


def _inputs():
    return np.random.RandomState(0).standard_normal(
        BLOCKS * THREADS).astype(np.float32)


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_emulation_barrier_stages_shared_memory(libs, dynamic):
    """With its barrier: each thread reads the next one's value, exactly,
    and two launches are bit-equal."""
    x = _inputs()
    want = np.roll(x.reshape(BLOCKS, THREADS), -1, axis=1).ravel()
    first = _rotate(libs[True], x, dynamic)
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(_rotate(libs[True], x, dynamic), first)


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_emulation_missing_barrier_shows(libs, dynamic):
    """Without its barrier: the rotation is wrong, two launches after the
    first (so that the static kind starts from the same leftovers) differ,
    and the dynamic kind reads the NaN fill."""
    x = _inputs()
    want = np.roll(x.reshape(BLOCKS, THREADS), -1, axis=1).ravel()
    _rotate(libs[False], x, dynamic)
    second = _rotate(libs[False], x, dynamic)
    third = _rotate(libs[False], x, dynamic)
    for got in (second, third):
        assert not np.array_equal(got, want, equal_nan=True)
    assert not np.array_equal(second, third, equal_nan=True)
    if dynamic:
        assert np.isnan(second).any() and np.isnan(third).any()


def test_emulation_partial_barrier_aborts(libs):
    """A __syncthreads that 16 of 64 threads reach ends the process with
    the emulation's deadlock message, within seconds, instead of hanging."""
    run = subprocess.run(
        [sys.executable, "-c",
         "import ctypes, sys\n"
         "lib = ctypes.CDLL(sys.argv[1])\n"
         "out = (ctypes.c_float * 64)()\n"
         "lib.partial(out, 64)\n"
         "print('returned')\n",
         libs[True]],
        capture_output=True, text=True, timeout=60)
    assert run.returncode != 0
    assert "returned" not in run.stdout
    assert "block (0, 0, 0) deadlocked: 16 of its 64 threads" in run.stderr
