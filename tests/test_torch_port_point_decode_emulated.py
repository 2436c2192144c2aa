"""The eval decode kernel's CUDA source (kernel 1,
go_with_the_flows_tpu_torch/csrc/point_decode.cu) built by g++ against a
CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU
through its C entry point, against the plain PyTorch version: the kernel
layout of the weights and FiLM rows, the double-buffered staging of each
coupling (the cp.async copies land at once here), the coupling order of
both directions, and the register tile of several points a thread with a
partial last tile, without a card. Widths f=8 (no padding), f=37 (the
flagship's, padded to 40), f=33 (the SVR configuration's, padded to 40)
and f=45 (padded to 48, the other register tile), at 'highest' here; the
same cases in the other matmul precision modes (ops/precision.py), each
against the plain version of its mode, are in
tests/test_torch_port_point_decode_modes_emulated.py, which builds its
own library from the helpers here (`build_emulated`, `check_decode`), so
that the two files run on two workers of the suite.
Bounds as the card test's (tests/test_torch_port_cuda.py) and
chip_smoke.py's: the CPU's float rounding differs from the GPU's, not
the algorithm. atol 1e-4 at 'highest', 1e-5 at 'high' and 5e-3 at
'fast', where a sum that lands on the other side of a bf16 rounding in
the other order moves that value by a bf16 step, so no more than 2e-3 of
the elements may be off by more than 1e-4. Away from 'highest' the mode
must be in force: the kernel's effect of its mode (its output less its
'highest' output) within 0.5 ('high') or 0.05 ('fast') of the plain
version's, in rms over the effect's rms (measured here at most 0.114
and 7e-5), and at 'fast' the largest gap to plain 'fast' 10x below that
to plain 'highest'. (At 'high' a largest gap is no such test: two sum
orders can round lo(h) a bf16 step apart, as far as 'high' is from
'highest' at those few points.) Two launches must give equal bits."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    KERNEL_MODES,
    film_alpha_beta,
    kernel_film,
    kernel_layout,
    point_decode_plain,
)
from go_with_the_flows_tpu_torch.ops.layers import BatchNorm
from go_with_the_flows_tpu_torch.ops.precision import matmul_precision_scope

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


def build_emulated(source_text: str, out) -> ctypes.CDLL:
    """`source_text` (point_decode.cu or a copy of it) rewritten for the
    emulation and built by g++ into `out`, beside csrc's headers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    cpp = out / "point_decode.cpp"
    cpp.write_text(_emulated_source(source_text))
    so = out / "libpoint_decode.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-I", os.path.dirname(SOURCE), "-o",
                            str(so), str(cpp), "-lpthread"],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gwtf_point_decode.argtypes = [P] * 5 + [I] * 7 + [P]
    lib.gwtf_point_decode.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    with open(SOURCE) as f:
        return build_emulated(f.read(), tmp_path_factory.mktemp("emulated"))


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


def check_decode(lib, f, N, inverse, mode, B=2):
    """The emulated kernel in `mode` against the plain version of that
    mode, within the module's bounds; two launches bit-equal; away from
    'highest' the mode in force."""
    packed, ab, p = _inputs(f, B, N, f + N)
    K = p.shape[0]
    C = packed["w1"].shape[1]
    film = kernel_film(ab)

    def run(m):
        weights = kernel_layout(packed, m)
        out = torch.full_like(p, float("nan"))
        lv = torch.full_like(p, float("nan"))
        assert lib.gwtf_point_decode(
            p.data_ptr(), weights.data_ptr(), film.data_ptr(),
            out.data_ptr(), lv.data_ptr(), K, B, C, N, f, int(inverse),
            KERNEL_MODES[m], None) == 0
        return out, lv

    def plain(m):
        with matmul_precision_scope(m):
            return point_decode_plain(packed, ab, p, inverse)

    got, want = run(mode), plain(mode)
    atol = {"highest": 1e-4, "high": 1e-5, "fast": 5e-3}[mode]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
    for a, b in zip(got, run(mode)):
        assert torch.equal(a, b)
    if mode == "highest":
        return
    for a, b, ah, bh in zip(got, want, run("highest"), plain("highest")):
        effect = b - bh
        gap = (a - ah - effect).square().mean() / effect.square().mean()
        assert gap.sqrt().item() <= {"high": 0.5, "fast": 0.05}[mode]
        if mode == "fast":
            assert ((a - b).abs() > 1e-4).float().mean().item() <= 2e-3
            assert 10 * (a - b).abs().max() <= (a - bh).abs().max()


# 'highest' takes blocks of 512 points: 128 threads x 4 points at f <= 40,
# 256 x 2 above. N = 818 at f = 8 and 37: the second block's threads have
# their first two points live, their third in 50 threads, their fourth in
# none; N = 50: one block whose first points are partial; f = 45 (padded
# to 48, 2 points a thread) at N = 600: the second block's first points
# live in 88 threads, its second points in none
SHAPES = [(8, 818), (37, 818), (37, 50), (45, 600), (33, 1250)]


@pytest.mark.parametrize("f,N", SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["highest"])
def test_emulated_point_decode(lib, f, N, inverse, mode):
    check_decode(lib, f, N, inverse, mode)
