"""The train-decode kernels' CUDA source (kernels 7 and 8,
go_with_the_flows_tpu_torch/csrc/train_decode.cu) built by g++ against a
CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU
through its C entry points, against the plain PyTorch versions: the
kernels' indexing, padding, ragged segments, partial-row layout and
reductions, without a card. The emulation runs one std::thread per CUDA
thread, so the shapes are small: f=5 (padded to 8) with a ragged second
512-point segment, f=13 (padded to 16) with B=1; the forward also at
f=8 (the narrowest width, no padding) over three segments ragged in
every tile size (B=3: 9 partial rows a component), and at f=45 (padded
to 48, above the flagship's 40). The forward runs twice and must give
equal bits. Tolerances are the card tests'
(tests/test_torch_port_cuda.py): the CPU's float rounding differs from
the GPU's, not the algorithm."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
    _KERNEL_KEYS,
    film_ab_train,
    pack_point_decoder_train,
    train_decode_bwd_plain,
    train_decode_fwd_plain,
)
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                      "csrc", "train_decode.cu")


def _emulated_source(text: str) -> str:
    """The CUDA source with its launches and dynamic shared memory in the
    emulation's terms."""
    text = text.replace("#include <cuda_runtime.h>",
                        '#include "cuda_cpu_emulation.h"')
    text = text.replace("extern __shared__ __align__(16) float sm[];",
                        "float* sm = emu_dyn;")

    def launch(m):
        grid, block, smem, stream = [a.strip() for a in m.group(2).split(",")]
        return (f"emu_launch(emu_dim({grid}), emu_dim({block}), {smem}, "
                f"{stream}, [&] {{ {m.group(1)}({m.group(3)}); }});")

    text = re.sub(r"([\w:]+(?:<FP>)?)<<<(.*?)>>>\((.*?)\);", launch, text,
                  flags=re.S)
    if "<<<" in text:
        raise AssertionError("a launch the emulation does not rewrite")
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    out = tmp_path_factory.mktemp("emulated")
    cpp = out / "train_decode.cpp"
    with open(SOURCE) as f:
        cpp.write_text(_emulated_source(f.read()))
    so = out / "libtrain_decode.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-I", HERE, "-o", str(so), str(cpp), "-lpthread"],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated source:\n"
                           f"{built.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gwtf_train_decode_fwd.argtypes = [P] * 13 + [I] * 5 + [P]
    lib.gwtf_train_decode_bwd.argtypes = [P] * 20 + [I] * 5 + [P]
    for fn in (lib.gwtf_train_decode_fwd, lib.gwtf_train_decode_bwd):
        fn.restype = ctypes.c_int
    lib.gwtf_train_decode_workspace.argtypes = [I] * 6
    lib.gwtf_train_decode_workspace.restype = ctypes.c_longlong
    return lib


def _inputs(f, B, N, seed, K=2):
    """A K-component decoder's packed arrays (weights moved off their
    init), FiLM affines for a random latent and a state p (K, B, 3, N), as
    the card tests make them."""
    gen = torch.Generator().manual_seed(seed)
    model = FlowMixtureModel(n_components=K, g_latent_space_size=12,
                             g_prior_n_flows=1, p_decoder_n_flows=1,
                             p_decoder_n_features=f,
                             params_reduce_mode="none", generator=gen)
    with torch.no_grad():
        for q in model.pc_decoder.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
    packed = {k: v.detach().contiguous() for k, v in
              pack_point_decoder_train(model.pc_decoder).items()}
    ab, _ = film_ab_train(packed, torch.randn(B, 12, generator=gen))
    p = 0.5 * torch.randn(K, B, 3, N, generator=gen)
    return packed, ab.detach().contiguous(), p


def _rel_err(got, want):
    return ((got - want).abs().max() / (want.abs().max() + 1e-12)).item()


SHAPES = [(5, 2, 600), (13, 1, 130)]
# N = 1100: three 512-point segments (9 partial rows a component, more
# than the reductions' 8 row groups), the last ragged in the 128-point
# tiles of the hidden and update passes; the emulated card's 3 SMs give
# the hidden pass 3 persistent blocks a component, 9 tiles each
FWD_SHAPES = SHAPES + [(8, 3, 1100), (45, 1, 70)]


@pytest.mark.parametrize("f,B,N", FWD_SHAPES)
def test_emulated_train_decode_fwd(lib, f, B, N):
    """Kernel 7: p0, the logvar sum and the saved states atol 1e-4, the
    batch statistics rtol 1e-5 (atol 1e-5 near 0); two launches give
    equal bits."""
    packed, ab, p = _inputs(f, B, N, f)
    K, C = p.shape[0], packed["w1"].shape[1]

    def run():
        got = [torch.empty_like(p), torch.empty_like(p),
               p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
        work = torch.full((lib.gwtf_train_decode_workspace(0, K, B, C, N, f),),
                          float("nan"))
        args = [p] + [packed[k] for k in _KERNEL_KEYS] + [ab] + got + [work]
        assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, None) == 0
        return got

    got = run()
    want = train_decode_fwd_plain(packed, ab, p)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5)
    for a, b in zip(got, run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("f,B,N", SHAPES)
def test_emulated_train_decode_bwd(lib, f, B, N):
    """Kernel 8 (head pass, B1, B2, input pass and the row reductions) on
    the plain forward's residuals: the input cotangent within 1e-3 of its
    largest entry, every packed array's and ab's gradient within 3e-2 of
    its own; two launches give equal bits."""
    packed, ab, p = _inputs(f, B, N, f + 1)
    _, _, xsave, stats = train_decode_fwd_plain(packed, ab, p)
    gen = torch.Generator().manual_seed(f)
    dp0 = torch.randn(p.shape, generator=gen)
    dlv = torch.randn(p.shape, generator=gen)
    K, C = p.shape[0], packed["w1"].shape[1]
    ws = [packed[k] for k in _KERNEL_KEYS]

    def run():
        out = [torch.empty_like(dp0)] + [torch.empty_like(w) for w in ws] + [
            torch.empty_like(ab)]
        work = torch.full((lib.gwtf_train_decode_workspace(1, K, B, C, N, f),),
                          float("nan"))
        args = [xsave, stats] + ws + [ab, dp0, dlv] + out + [work]
        assert lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, None) == 0
        return out

    got = run()
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv)
    assert _rel_err(got[0], dp) < 1e-3
    for k, g in zip(_KERNEL_KEYS, got[1:-1]):
        assert _rel_err(g, grads[k]) < 3e-2, k
    assert _rel_err(got[-1], dab) < 3e-2
    for a, b in zip(got, run()):
        assert torch.equal(a, b)
