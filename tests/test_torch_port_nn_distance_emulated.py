"""The nearest-neighbour kernel's CUDA source (kernel 2,
go_with_the_flows_tpu_torch/csrc/nn_distance.cu) built by g++ against a
CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU
through its C entry points, against the plain PyTorch version: the single
pass's row and column minima, the warps' exchange of (distance, row)
pairs, ragged ends masked by index, several column tiles, and row chunks
folded by the second launch, without a card.

The kernel rounds each distance step by step as the plain version does,
so every minimum is held equal to the plain version's bit for bit. The
indices are held equal to `torch.argmin`'s first index, ties included:
on clouds with repeated points and coordinates on a 1/8 grid, both a
row's and a column's minimum are often reached more than once, and the
kernel must keep the first column of a row and the lowest row of a
column. Two launches give the same bits."""

import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.ops.chamfer import pairwise_sqdists
from go_with_the_flows_tpu_torch.ops.kernels import build
from go_with_the_flows_tpu_torch.ops.kernels.chamfer import nn_distance_plain

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                      "csrc", "nn_distance.cu")


def _emulated_source(text: str) -> str:
    """The CUDA source with its launches in the emulation's terms."""
    text = text.replace("#include <cuda_runtime.h>",
                        '#include "cuda_cpu_emulation.h"')
    text = text.replace("cudaGetErrorString(static_cast<cudaError_t>(code))",
                        '"emulated"')

    def launch(m):
        grid, block, smem, stream = [a.strip() for a in m.group(2).split(",")]
        return (f"emu_launch(emu_dim({grid}), emu_dim({block}), {smem}, "
                f"{stream}, [&] {{ {m.group(1)}({m.group(3)}); }});")

    text = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", launch, text,
                  flags=re.S)
    if "<<<" in text:
        raise AssertionError("a construct the emulation does not rewrite")
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    out = tmp_path_factory.mktemp("emulated")
    cpp = out / "nn_distance.cpp"
    with open(SOURCE) as f:
        cpp.write_text(_emulated_source(f.read()))
    so = out / "libnn_distance.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-o", str(so), str(cpp), "-lpthread"],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    return build.load(str(so), ("gwtf_nn_distance",
                                "gwtf_nn_distance_chunks"))


def _nn(lib, a, b, with_idx):
    """The kernel's outputs as nn_distance gives them (int32 indices), the
    outputs and the scratch filled with NaN / -1 first."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    chunks = lib.gwtf_nn_distance_chunks(N)
    dist_a = torch.full((B, N), float("nan"))
    dist_b = torch.full((B, M), float("nan"))
    col_d = torch.full((B, chunks, M), float("nan"))
    idx = [torch.full((B, n), -1, dtype=torch.int32) for n in (N, M)]
    col_i = torch.full((B, chunks, M), -1, dtype=torch.int32)

    def ptr(t):
        return t.data_ptr() if with_idx else None

    assert lib.gwtf_nn_distance(
        a.data_ptr(), b.data_ptr(), dist_a.data_ptr(), ptr(idx[0]),
        dist_b.data_ptr(), ptr(idx[1]), col_d.data_ptr(), ptr(col_i), B, N,
        M, None) == 0
    if with_idx:
        return dist_a, idx[0], dist_b, idx[1]
    return dist_a, dist_b


def _clouds(B, N, M, seed, ties):
    gen = torch.Generator().manual_seed(seed)
    a = 0.3 * torch.randn(B, N, 3, generator=gen)
    b = 0.3 * torch.randn(B, M, 3, generator=gen)
    if ties:
        # coordinates on a 1/8 grid in [-0.5, 0.5] (exact distances, many
        # equal), and points of each cloud repeated in it, so that a row
        # meets its minimum at several columns and a column at several
        # rows, the rows of one tie in different lanes, warps and chunks
        a, b = ((8 * t).round().clamp(-4, 4) / 8 for t in (a, b))
        a[:, N // 2:] = a[:, :N - N // 2].flip(1)
        b[:, M // 3:2 * (M // 3)] = b[:, :M // 3]
    return a.contiguous(), b.contiguous()


def test_emulated_nn_distance_chunks(lib):
    """A block takes 512 rows: one chunk up to 512, then one more each
    512 (the cases below span one chunk and several)."""
    assert [lib.gwtf_nn_distance_chunks(n) for n in (1, 512, 513, 1100)] \
        == [1, 1, 2, 3]


# (B, N, M): ragged N != M, neither a multiple of the 32-column group, in
# one row chunk; the same transposed; 1,100 rows (three chunks of 512, the
# last partial); 1,100 columns (two tiles of 1,024, the second ending in a
# partial group)
CASES = [(3, 50, 77), (2, 77, 50), (2, 1100, 77), (1, 40, 1100)]


@pytest.mark.parametrize("B,N,M", CASES)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_idx", [True, False])
def test_emulated_nn_distance(lib, B, N, M, ties, with_idx):
    a, b = _clouds(B, N, M, N + 3 * M, ties)
    got = _nn(lib, a, b, with_idx)
    dist_a, idx_a, dist_b, idx_b = nn_distance_plain(a, b)
    assert torch.equal(got[0], dist_a)
    assert torch.equal(got[-2 if with_idx else 1], dist_b)
    if with_idx:
        # the first argmin of each row and of each column, ties included
        d = pairwise_sqdists(a, b)
        first_a = (d == dist_a[:, :, None]).int().argmax(dim=2)
        first_b = (d == dist_b[:, None, :]).int().argmax(dim=1)
        assert torch.equal(got[1].long(), first_a)
        assert torch.equal(got[3].long(), first_b)
        assert torch.equal(idx_a, first_a) and torch.equal(idx_b, first_b)
        if ties:
            # the case has ties to resolve, in both directions
            assert ((d == dist_a[:, :, None]).sum(2) > 1).any()
            assert ((d == dist_b[:, None, :]).sum(1) > 1).any()
    for x, y in zip(got, _nn(lib, a, b, with_idx)):
        assert torch.equal(x, y)
