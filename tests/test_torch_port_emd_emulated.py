"""The EMD kernels' CUDA source (kernels 4, 5 and 6,
go_with_the_flows_tpu_torch/csrc/emd.cu) built by g++ against a CPU
stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU through
its C entry points, against the plain PyTorch versions: the passes'
indexing, the fused row pass's order of updates, ragged ends, unequal
capacities, chunks of rows and the block's fixed-order sum, without a
card. The emulation runs every CUDA thread of a block in turn on one
CPU thread, so the clouds are small. Tolerances are the card tests' (tests/test_torch_port_cuda.py):
the CPU's exp2f and rsqrt differ from the card's special-function units,
not the algorithm."""

import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.ops.chamfer import pairwise_sqdists
from go_with_the_flows_tpu_torch.ops.emd import N_LEVELS, _capacities, levels
from go_with_the_flows_tpu_torch.ops.kernels import build
from go_with_the_flows_tpu_torch.ops.kernels.emd import (
    emd_backward_f64,
    emd_backward_plain,
    emd_cost_plain,
)
from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
    pairwise_emd_plain,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                      "csrc", "emd.cu")


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
    cpp = out / "emd.cpp"
    with open(SOURCE) as f:
        cpp.write_text(_emulated_source(f.read()))
    so = out / "libemd.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-o", str(so), str(cpp), "-lpthread"],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    return build.load(str(so), ("gwtf_emd_cost", "gwtf_pairwise_emd",
                                "gwtf_emd_backward",
                                "gwtf_emd_backward_chunks"))


def _cost(lib, a, b, save_ratios=False):
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    cost = torch.full((B,), float("nan"))
    rl = torch.full((B, N_LEVELS, N), float("nan")) if save_ratios else None
    rr = torch.full((B, N_LEVELS, M), float("nan")) if save_ratios else None
    assert lib.gwtf_emd_cost(
        a.data_ptr(), b.data_ptr(), cost.data_ptr(),
        rl.data_ptr() if save_ratios else None,
        rr.data_ptr() if save_ratios else None, B, N, M,
        *_capacities(N, M), None) == 0
    return (cost, rl, rr) if save_ratios else cost


def _grid(lib, s, r):
    """The (S, R) grid in two launches, so that the second starts at a
    pair offset."""
    S, N, R, M = s.shape[0], s.shape[1], r.shape[0], r.shape[1]
    cost = torch.full((S, R), float("nan"))
    half = S * R // 2
    for p0, pairs in ((0, half), (half, S * R - half)):
        assert lib.gwtf_pairwise_emd(
            s.data_ptr(), r.data_ptr(), cost.data_ptr(), R, N, M,
            *_capacities(N, M), p0, pairs, None) == 0
    return cost


def _backward(lib, a, b, rl, rr):
    """Kernel 6's (da, db), the outputs and the chunks' scratch filled
    with NaN first."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    chunks = lib.gwtf_emd_backward_chunks(N)
    da = torch.full_like(a, float("nan"))
    db = torch.full_like(b, float("nan"))
    col = torch.full((B, chunks, M, 3), float("nan"))
    assert lib.gwtf_emd_backward(a.data_ptr(), b.data_ptr(), rl.data_ptr(),
                                 rr.data_ptr(), da.data_ptr(), db.data_ptr(),
                                 col.data_ptr(), B, N, M, None) == 0
    return da, db


def _match(d, rl, rr):
    """sum_l exp(level_l d) ratioL_l ratioR_l, (B, N, M)."""
    return sum(torch.exp(level * d) * rl[:, k, :, None] * rr[:, k, None, :]
               for k, level in enumerate(levels()))


# (S, R, N, M): ragged ends; unequal capacities (multiL = 2); 4,500 rows
# in two chunks of the row pass over 1,024 threads, multiR = 500
CASES = [(5, 7, 50, 77), (5, 7, 40, 100), (1, 2, 4500, 9)]


@pytest.mark.parametrize("S,R,N,M", CASES)
def test_emulated_emd_forward(lib, S, R, N, M):
    """Kernels 4 and 5: the grid equals the paired cost bit for bit, and
    two launches give equal bits; the cost with residuals saved equals the
    cost without; the cost rtol 1e-4, the grid rtol 2e-4 and atol 1e-5
    against the plain versions; the residuals through the match they
    define against the plain version's."""
    gen = torch.Generator().manual_seed(N + M)
    s = 0.3 * torch.randn(S, N, 3, generator=gen)
    r = 0.3 * torch.randn(R, M, 3, generator=gen)
    a = s[:, None].expand(S, R, N, 3).reshape(S * R, N, 3).contiguous()
    b = r[None].expand(S, R, M, 3).reshape(S * R, M, 3).contiguous()
    grid = _grid(lib, s, r)
    cost = _cost(lib, a, b)
    cost_r, rl, rr = _cost(lib, a, b, True)
    assert torch.equal(grid.reshape(-1), cost)
    assert torch.equal(_grid(lib, s, r), grid)
    assert torch.equal(cost_r, cost)
    want, want_rl, want_rr = emd_cost_plain(a, b, True)
    torch.testing.assert_close(cost, want, rtol=1e-4, atol=0)
    torch.testing.assert_close(grid, pairwise_emd_plain(s, r), rtol=2e-4,
                               atol=1e-5)
    # the residuals, each level's ratios, are chaotic where a point's
    # remaining capacity is a difference of nearly equal sums, so they are
    # held through the match they define: its cost is the kernel's cost
    # (rtol 1e-4) and it lies within 1e-3 of the plain match's largest
    # entry (the plain version's own ratios give the plain match)
    d = pairwise_sqdists(a, b)
    match = _match(d, rl, rr)
    root = torch.sqrt(torch.clamp(d, min=1e-12))
    torch.testing.assert_close((match * root).sum(dim=(1, 2)), cost,
                               rtol=1e-4, atol=0)
    want_match = _match(d, want_rl, want_rr)
    assert (match - want_match).abs().max() <= 1e-3 * want_match.abs().max()


def test_emulated_emd_backward_chunks(lib):
    """Kernel 6's block takes 256 rows: one chunk up to 256, then one
    more each 256 (the last backward case spans two)."""
    assert [lib.gwtf_emd_backward_chunks(n) for n in (1, 256, 257, 300)] \
        == [1, 1, 2, 2]


# and 300 rows (two row chunks of 256, the second partial) against 290
# columns (two tiles of 256, the second ending in a partial group of 8)
@pytest.mark.parametrize("S,R,N,M", CASES[:2] + [(2, 1, 300, 290)])
def test_emulated_emd_backward(lib, S, R, N, M):
    """Kernel 6 on the emulated forward's residuals: rtol 1e-4, atol
    1e-5 against the plain backward; two launches give the same bits."""
    gen = torch.Generator().manual_seed(N * M)
    a = 0.3 * torch.randn(S, N, 3, generator=gen)
    b = 0.3 * torch.randn(S, M, 3, generator=gen)
    _, rl, rr = _cost(lib, a, b, True)
    da, db = _backward(lib, a, b, rl, rr)
    want_da, want_db = emd_backward_plain(a, b, rl, rr)
    torch.testing.assert_close(da, want_da, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(db, want_db, rtol=1e-4, atol=1e-5)
    again = _backward(lib, a, b, rl, rr)
    assert torch.equal(again[0], da) and torch.equal(again[1], db)


@pytest.mark.parametrize("S,R,N,M", CASES[:2])
def test_emulated_emd_forward_and_backward_match(lib, S, R, N, M):
    """The forward and kernel 6 form E as 2^fl(c_l D) of the FMA
    distance, the plain versions as exp(level_l D) of the step-rounded
    one. On the emulated forward's residuals, the gradients of the two
    forms' matches (float64) agree at the backward's tolerance, and kernel
    6 agrees with both; the plain versions' form in float64 agrees with
    the plain backward."""
    gen = torch.Generator().manual_seed(N * M + 1)
    a = 0.3 * torch.randn(S, N, 3, generator=gen)
    b = 0.3 * torch.randn(S, M, 3, generator=gen)
    _, rl, rr = _cost(lib, a, b, True)
    da, db = _backward(lib, a, b, rl, rr)
    fwd = emd_backward_f64(a, b, rl, rr, "forward")
    bwd = emd_backward_f64(a, b, rl, rr, "backward")
    plain = emd_backward_plain(a, b, rl, rr)
    for got, f, w, p in zip((da, db), fwd, bwd, plain):
        torch.testing.assert_close(f, w, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.double(), f, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.double(), w, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(w.float(), p, rtol=1e-4, atol=1e-5)
