"""The eval decode kernel's CUDA source (kernel 1,
go_with_the_flows_tpu_torch/csrc/point_decode.cu) built by g++ against a
CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU
through its C entry point, against the plain PyTorch version: the kernel
layout of the weights and FiLM rows, the double-buffered staging of each
coupling (the cp.async copies land at once here), the coupling order of
both directions, and the register tile of several points a thread with a
partial last tile, without a card. Widths f=8 (no padding), f=37 (the
flagship's, padded to 40) and f=45 (padded to 48, the other register
tile). Tolerance atol 1e-4, as the card tests'
(tests/test_torch_port_cuda.py): the CPU's float rounding differs from
the GPU's, not the algorithm. Two launches must give equal bits."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    film_alpha_beta,
    kernel_film,
    point_decode_plain,
)
from go_with_the_flows_tpu_torch.ops.layers import BatchNorm

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                      "csrc", "point_decode.cu")


def _emulated_source(text: str) -> str:
    """The CUDA source with its launch, pipeline and dynamic shared memory
    in the emulation's terms."""
    text = text.replace("#include <cuda_runtime.h>",
                        '#include "cuda_cpu_emulation.h"')
    text = text.replace("#include <cuda_pipeline.h>\n", "")
    text = text.replace("extern __shared__ float4 smem[];",
                        "float4* smem = reinterpret_cast<float4*>(emu_dyn);")

    def launch(m):
        grid, block, smem, stream = [a.strip() for a in m.group(2).split(",")]
        return (f"emu_launch(emu_dim({grid}), emu_dim({block}), {smem}, "
                f"{stream}, [&] {{ {m.group(1)}({m.group(3)}); }});")

    text = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", launch, text,
                  flags=re.S)
    if "<<<" in text or "extern __shared__" in text or "<cuda_" in text:
        raise AssertionError("a construct the emulation does not rewrite")
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    out = tmp_path_factory.mktemp("emulated")
    cpp = out / "point_decode.cpp"
    with open(SOURCE) as f:
        cpp.write_text(_emulated_source(f.read()))
    so = out / "libpoint_decode.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-o", str(so), str(cpp), "-lpthread"],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gwtf_point_decode.argtypes = [P] * 5 + [I] * 6 + [P]
    lib.gwtf_point_decode.restype = ctypes.c_int
    return lib


def _inputs(f, B, N, seed, K=2):
    """A K-component decoder packed for the kernel (weights and BatchNorm
    statistics moved off their init), FiLM affines for a random latent and
    a state p (K, B, 3, N)."""
    gen = torch.Generator().manual_seed(seed)
    model = FlowMixtureModel(n_components=K, g_latent_space_size=12,
                             g_prior_n_flows=1, p_decoder_n_flows=2,
                             p_decoder_n_features=f,
                             params_reduce_mode="none", generator=gen)
    with torch.no_grad():
        for q in model.pc_decoder.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
        for m in model.pc_decoder.modules():
            if isinstance(m, BatchNorm):
                shape = m.running_mean.shape
                m.running_mean.copy_(0.3 * torch.randn(shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(shape, generator=gen))
    packed = model.eval().pack_decoder()
    ab = film_alpha_beta(packed, torch.randn(B, 12, generator=gen))
    p = 0.3 * torch.randn(K, B, 3, N, generator=gen)
    return packed, ab, p


# Blocks of 512 points: 128 threads x 4 points at f <= 40, 256 x 2 above.
# N = 818 at f = 8 and 37: the second block's threads have their first
# two points live, their third in 50 threads, their fourth in none;
# N = 50: one block whose first points are partial; f = 45 (padded to
# 48, 2 points a thread) at N = 600: the second block's first points
# live in 88 threads, its second points in none
@pytest.mark.parametrize("f,N", [(8, 818), (37, 818), (37, 50), (45, 600)])
@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_point_decode(lib, f, N, inverse):
    packed, ab, p = _inputs(f, 2, N, f + N)
    K, B = p.shape[:2]
    C = packed["w1"].shape[1]
    film = kernel_film(ab)

    def run():
        out = torch.full_like(p, float("nan"))
        lv = torch.full_like(p, float("nan"))
        assert lib.gwtf_point_decode(
            p.data_ptr(), packed["kernel"].data_ptr(), film.data_ptr(),
            out.data_ptr(), lv.data_ptr(), K, B, C, N, f, int(inverse),
            None) == 0
        return out, lv

    got = run()
    want = point_decode_plain(packed, ab, p, inverse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for a, b in zip(got, run()):
        assert torch.equal(a, b)
