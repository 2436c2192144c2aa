"""The train-decode kernels' CUDA source (kernels 7 and 8,
go_with_the_flows_tpu_torch/csrc/train_decode*.cu*) built by g++ against a
CPU stand-in for CUDA (tests/cuda_cpu_emulation.h) and run on the CPU
through its C entry points, against the plain PyTorch versions: the
kernels' indexing, padding, ragged segments, partial-row layout and
reductions, without a card. The emulation runs every CUDA thread of a
block in turn on one CPU thread, so the shapes are small: f=5 (padded to 8) with a ragged second
512-point segment, f=13 (padded to 16) with B=1; the forward also at
f=8 (the narrowest width, no padding) over three segments ragged in
every tile size (B=3: 9 partial rows a component), and at f=45 (padded
to 48, above the flagship's 40); both kernels also at f=33 (the SVR
configuration's width, padded to 40) with a ragged N=1250. The forward runs twice and must give
equal bits. Tolerances are the card tests'
(tests/test_torch_port_cuda.py): the CPU's float rounding differs from
the GPU's, not the algorithm.

The SPMD form (the per-stage entries and the wrapper's host loops,
`_spmd_fwd` and `_spmd_bwd`) runs as two shards of one batch in this
process, in lockstep, their exchange a plain sum of the two shards'
partial sums, against the single entry on the whole batch.

The 'high' and 'fast' cases are in
tests/test_torch_port_train_decode_modes_emulated.py, which builds its
own library with the helpers here (`load_emulated`), so that the suite's
workers run the two files side by side; the entry points take the
precision mode before the stream.

The source is a header of kernels (train_decode.cuh) and four units that
include it (the entry points and one per mode), each compiled by its own
g++, all at once, as build.py runs nvcc."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from go_with_the_flows_tpu_torch.ops.kernels import build
from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
    _KERNEL_KEYS,
    _spmd_bwd,
    _spmd_fwd,
    film_ab_train,
    kernel_weights_train,
    pack_point_decoder_train,
    train_decode_bwd_plain,
    train_decode_fwd_plain,
)
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                    "csrc")
# the kernels (a header, which includes the tensor-core step's) and the
# units that include it: the entry points and each precision mode's
# instantiations
HEADERS = ("train_decode.cuh", "mma_bf16.cuh")
UNITS = ("train_decode.cu", "train_decode_highest.cu", "train_decode_high.cu",
         "train_decode_fast.cu")


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

    text = re.sub(r"([\w:]+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", launch,
                  text, flags=re.S)
    if "<<<" in text:
        raise AssertionError("a launch the emulation does not rewrite")
    return text


def build_emulated(csrc, out):
    """The sources in `csrc` rewritten for the emulation into `out`, each
    unit compiled by its own g++, all at once, and linked into
    out/libtrain_decode.so; returns its path."""
    gxx = shutil.which("g++")
    for name in HEADERS + UNITS:
        with open(os.path.join(csrc, name)) as f:
            text = _emulated_source(f.read())
        (out / (name if name in HEADERS else name[:-3] + ".cpp")).write_text(
            text)
    objs = [out / (name[:-3] + ".o") for name in UNITS]
    procs = [subprocess.Popen([gxx, "-std=c++20", "-O1", "-fPIC", "-c",
                               "-I", HERE, "-I", str(out), "-o", str(obj),
                               str(out / (name[:-3] + ".cpp"))],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(UNITS, objs)]
    logs = [p.communicate()[0] for p in procs]
    so = out / "libtrain_decode.so"
    for name, p, log in zip(UNITS, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed on the emulated {name}:\n"
                               f"{log[-4000:]}")
    linked = subprocess.run([gxx, "-shared", "-o", str(so)]
                            + [str(o) for o in objs] + ["-lpthread"],
                            capture_output=True, text=True)
    if linked.returncode != 0:
        raise RuntimeError(f"linking the emulated units failed:\n"
                           f"{linked.stderr[-4000:]}")
    return so


def load_emulated(tmp_path_factory):
    """The emulated library built into a fresh temporary directory and
    loaded, its C entry points typed (the body of each emulated file's
    `lib` fixture: each file builds its own)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")
    so = build_emulated(CSRC, tmp_path_factory.mktemp("emulated"))
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gwtf_train_decode_fwd.argtypes = [P] * 13 + [I] * 6 + [P]
    lib.gwtf_train_decode_bwd.argtypes = [P] * 20 + [I] * 6 + [P]
    for fn in (lib.gwtf_train_decode_fwd, lib.gwtf_train_decode_bwd):
        fn.restype = ctypes.c_int
    # which, K, B, C, N, f, mode
    lib.gwtf_train_decode_workspace.argtypes = [I] * 7
    lib.gwtf_train_decode_workspace.restype = ctypes.c_longlong
    for name in ("gwtf_train_decode_fwd_stage", "gwtf_train_decode_bwd_stage"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build._SIGNATURES[name], ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return load_emulated(tmp_path_factory)


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


# f = 33 (padded to 40), the SVR configuration's width, at a ragged
# N = 1250: three 512-point segments, the last of 226 points, ragged in
# the 128-point tiles too
SHAPES = [(5, 2, 600), (13, 1, 130), (33, 2, 1250)]
# N = 1100: three 512-point segments (9 partial rows a component, more
# than the reductions' 8 row groups), the last ragged in the 128-point
# tiles of the hidden and update passes; the emulated card's 3 SMs give
# the hidden pass 3 persistent blocks a component, 9 tiles each
FWD_SHAPES = SHAPES + [(8, 3, 1100), (45, 1, 70), (33, 3, 1250)]


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
        work = torch.full(
            (lib.gwtf_train_decode_workspace(0, K, B, C, N, f, 0),),
            float("nan"))
        args = [p] + [packed[k] for k in _KERNEL_KEYS] + [ab] + got + [work]
        assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, 0, None) == 0
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
        work = torch.full(
            (lib.gwtf_train_decode_workspace(1, K, B, C, N, f, 0),),
            float("nan"))
        args = [xsave, stats] + ws + [ab, dp0, dlv] + out + [work]
        assert lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B,
                                         C, N, f, 0, None) == 0
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


def _lockstep(gens):
    """Two SPMD host loops in lockstep, each exchange the sum of both
    shards' partial sums."""
    sums = [next(g) for g in gens]
    while True:
        total = sums[0] + sums[1]
        out = []
        for g in gens:
            try:
                out.append(g.send(total.clone()))
            except StopIteration:
                pass
        if not out:
            return
        assert len(out) == len(gens), "the shards' stages fell out of step"
        sums = out


def _shards(t, dim, B):
    h = B // 2
    return [t.narrow(dim, 0, h).contiguous(),
            t.narrow(dim, h, B - h).contiguous()]


# (f, B, N): f=5 (padded to 8) over a ragged second segment, f=13 (16)
# with shards of 2 clouds
SPMD_SHAPES = [(5, 2, 600), (13, 4, 130)]


@pytest.mark.parametrize("f,B,N", SPMD_SHAPES)
def test_emulated_train_decode_spmd(lib, f, B, N):
    """Kernels 7 and 8 in their SPMD form on two shards of the batch
    against the single entries on the whole batch: p0, the logvar sum and
    the saved states atol 1e-5, the statistics rtol 1e-6 (only the order
    of the sums differs); dp and dab, concatenated over the shards, and
    every weight gradient, summed over the shards, within 1e-5 of their
    largest entry. The bn0 scale and bias gradients, summed over the
    shards, equal the whole batch's: each shard keeps its partial sums
    there, not the global ones its input pass reads (which would count
    them twice in the optimizer's sum over the ranks). Against the plain
    versions with the other tests' tolerances."""
    packed, ab, p = _inputs(f, B, N, f + 2)
    K, C = p.shape[0], packed["w1"].shape[1]
    ws = [packed[k] for k in _KERNEL_KEYS]

    whole = [torch.empty_like(p), torch.empty_like(p),
             p.new_empty(K, C, B, 3, N), p.new_empty(K, C, 4, 2 * f)]
    work = torch.full(
        (lib.gwtf_train_decode_workspace(0, K, B, C, N, f, 0),), float("nan"))
    args = [p] + ws + [ab] + whole + [work]
    assert lib.gwtf_train_decode_fwd(*(t.data_ptr() for t in args), K, B, C,
                                     N, f, 0, None) == 0

    fwd, gens = [], []
    for ps, abs_ in zip(_shards(p, 1, B), _shards(ab, 1, B)):
        b = ps.shape[1]
        out = [torch.empty_like(ps), torch.empty_like(ps),
               p.new_empty(K, C, b, 3, N), p.new_empty(K, C, 4, 2 * f)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(0, K, b, C, N, f, 0),),
            float("nan"))
        fwd.append(out)
        gens.append(_spmd_fwd(lib, [ps] + ws + [abs_] + out + [work],
                              (K, b, C, N, f), B * N, None))
    _lockstep(gens)
    for i, dim in enumerate((1, 1, 2)):
        got = torch.cat([o[i] for o in fwd], dim)
        torch.testing.assert_close(got, whole[i], rtol=0, atol=1e-5)
    for o in fwd:
        torch.testing.assert_close(o[3], whole[3], rtol=1e-6, atol=1e-6)
    plain = train_decode_fwd_plain(packed, ab, p)
    torch.testing.assert_close(torch.cat([o[0] for o in fwd], 1), plain[0],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(fwd[0][3], plain[3], rtol=1e-5, atol=1e-5)

    _, _, xsave, stats = plain
    gen = torch.Generator().manual_seed(f)
    dp0 = torch.randn(p.shape, generator=gen)
    dlv = torch.randn(p.shape, generator=gen)
    want = [torch.empty_like(dp0)] + [torch.empty_like(w) for w in ws] + [
        torch.empty_like(ab)]
    work = torch.full(
        (lib.gwtf_train_decode_workspace(1, K, B, C, N, f, 0),), float("nan"))
    args = [xsave, stats] + ws + [ab, dp0, dlv] + want + [work]
    assert lib.gwtf_train_decode_bwd(*(t.data_ptr() for t in args), K, B, C,
                                     N, f, 0, None) == 0

    bwd, gens = [], []
    for xs, abs_, d0, dl in zip(_shards(xsave, 2, B), _shards(ab, 1, B),
                                _shards(dp0, 1, B), _shards(dlv, 1, B)):
        b = d0.shape[1]
        out = [torch.empty_like(d0)] + [torch.full_like(w, float("nan"))
                                        for w in ws] + [torch.empty_like(abs_)]
        work = torch.full(
            (lib.gwtf_train_decode_workspace(2, K, b, C, N, f, 0),),
            float("nan"))
        bwd.append(out)
        gens.append(_spmd_bwd(lib, [xs, stats] + ws + [abs_, d0, dl] + out
                              + [work], (K, b, C, N, f), B * N, None))
    _lockstep(gens)
    assert _rel_err(torch.cat([o[0] for o in bwd], 1), want[0]) < 1e-5
    for i, k in enumerate(_KERNEL_KEYS, 1):
        assert _rel_err(bwd[0][i] + bwd[1][i], want[i]) < 1e-5, k
    assert _rel_err(torch.cat([o[-1] for o in bwd], 1), want[-1]) < 1e-5
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv)
    assert _rel_err(torch.cat([o[0] for o in bwd], 1), dp) < 1e-3
    for i, k in enumerate(_KERNEL_KEYS, 1):
        assert _rel_err(bwd[0][i] + bwd[1][i], grads[k]) < 3e-2, k
