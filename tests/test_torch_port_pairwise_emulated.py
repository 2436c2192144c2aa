"""The pairwise Chamfer kernel's CUDA source (kernel 3,
go_with_the_flows_tpu_torch/csrc/pairwise_cd.cu) built by g++ against a
CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU
through its C entry point, against the plain PyTorch version: the
single pass's row and column minima, the warps' column exchange, ragged
ends masked by index, several column tiles and row chunks, without a
card.

Every minimum must equal the plain version's bit for bit, so precision
and recall are held equal. On coordinates that are multiples of 1/64
every distance and every sum of minima is exact in float32 in any order,
so there cdl and cdr are held equal too, which a single wrong minimum
would break; on random coordinates they are held at rtol 1e-5 (the sums
run in another order)."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
    pairwise_cd_stats_plain,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                      "csrc", "pairwise_cd.cu")


def _emulated_source(text: str) -> str:
    """The CUDA source with its launch and dynamic shared memory in the
    emulation's terms."""
    text = text.replace("#include <cuda_runtime.h>",
                        '#include "cuda_cpu_emulation.h"')
    text = text.replace("extern __shared__ float4 smem[];",
                        "float4* smem = reinterpret_cast<float4*>(emu_dyn);")

    def launch(m):
        grid, block, smem, stream = [a.strip() for a in m.group(2).split(",")]
        return (f"emu_launch(emu_dim({grid}), emu_dim({block}), {smem}, "
                f"{stream}, [&] {{ {m.group(1)}({m.group(3)}); }});")

    text = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", launch, text, flags=re.S)
    if "<<<" in text or "extern __shared__" in text:
        raise AssertionError("a construct the emulation does not rewrite")
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    out = tmp_path_factory.mktemp("emulated")
    cpp = out / "pairwise_cd.cpp"
    with open(SOURCE) as f:
        cpp.write_text(_emulated_source(f.read()))
    so = out / "libpairwise_cd.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-o", str(so), str(cpp), "-lpthread"],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gwtf_pairwise_cd_stats.argtypes = [P] * 6 + [I] * 4 + [
        ctypes.c_float, P]
    lib.gwtf_pairwise_cd_stats.restype = ctypes.c_int
    return lib


def _stats(lib, s, r, thr):
    S, N, R, M = s.shape[0], s.shape[1], r.shape[0], r.shape[1]
    outs = [torch.full((S, R), float("nan")) for _ in range(4)]
    assert lib.gwtf_pairwise_cd_stats(
        s.data_ptr(), r.data_ptr(), *(o.data_ptr() for o in outs), S, R, N,
        M, thr, None) == 0
    return outs


def _clouds(S, R, N, M, seed, grid):
    gen = torch.Generator().manual_seed(seed)
    s = 0.3 * torch.randn(S, N, 3, generator=gen)
    r = 0.3 * torch.randn(R, M, 3, generator=gen)
    if grid:  # multiples of 1/64 in [-0.25, 0.25]: exact distances and sums
        s, r = ((64 * t).round().clamp(-16, 16) / 64 for t in (s, r))
    return s, r


# (S, R, N, M): ragged N != M, neither a multiple of the 32-column group;
# the same transposed; 2,100 rows (two chunks of 2,048 a block) against
# 1,100 columns (two tiles of 1,024, the second ending in a partial group)
CASES = [(3, 5, 50, 77), (2, 3, 77, 50), (1, 2, 2100, 1100)]


@pytest.mark.parametrize("S,R,N,M", CASES)
@pytest.mark.parametrize("grid", [False, True])
def test_emulated_pairwise_cd_stats(lib, S, R, N, M, grid):
    s, r = _clouds(S, R, N, M, N + M, grid)
    for thr in (1e-3, 1e-2):
        got = _stats(lib, s, r, thr)
        want = pairwise_cd_stats_plain(s, r, thr)
        for a, b in zip(got[:2], want[:2]):
            if grid:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[3], want[3])
        for a, b in zip(got, _stats(lib, s, r, thr)):
            assert torch.equal(a, b)
