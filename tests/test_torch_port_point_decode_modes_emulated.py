"""Kernel 1 at 'high' and 'fast' from its CUDA source
(go_with_the_flows_tpu_torch/csrc/point_decode.cu), built by g++ against
the CPU stand-in for CUDA and run on the CPU (the build and the checks of
tests/test_torch_port_point_decode_emulated.py, which holds the
'highest' cases; this file builds its own library, so that the two files
run on two workers of the suite).

At these modes the kernel takes a thread a point and runs its three
products as warp mma.sync bf16 steps on register fragments
(csrc/mma_bf16.cuh `frag_mma`), each product's accumulators turned into
the next one's A fragments. The emulation hands a warp's fragment
registers round by a barrier of the warp and forms each lane's
accumulators from them in the PTX layout, so these cases check the
fragments' layout, the padding of the depth to 16 (the m16n8k8 step where
FP is not a multiple of 16: FP 8, 24, 40, 56), both 16-row halves on one
W1 B fragment (FP <= 40) and a half at a time above (FP 48-64), the
shuffles that hand a group's rows their x, the lane that keeps each
point's y, and the kernel layout of the weights as bf16 pairs
(`kernel_weights`), against the plain versions of the modes with the
'highest' file's bounds; a copy of the source that reads W1's lo plane as
its hi plane, or that takes the accumulators in a wrong layout, fails
them."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    kernel_weights,
    layout_words,
    padded_width,
    pair_stride,
)
from go_with_the_flows_tpu_torch.ops.precision import bf16_round, bf16_split
from test_torch_port_point_decode_emulated import (
    SHAPES,
    SOURCE,
    _inputs,
    build_emulated,
    check_decode,
)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    with open(SOURCE) as f:
        return build_emulated(f.read(), tmp_path_factory.mktemp("modes"))


# the 'highest' file's cases, here in the other two modes: a block of 256
# points (8 warps of 32 rows), so N = 818 leaves the fourth block's
# second warp 18 live rows and its last 6 warps dead, N = 50 the only
# block's the same; f = 45 (FP 48) takes a 16-row half at a time
@pytest.mark.parametrize("f,N", SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["high", "fast"])
def test_emulated_point_decode(lib, f, N, inverse, mode):
    check_decode(lib, f, N, inverse, mode)


# the other instantiations' paths: FP 24 (the last k-step an m16n8k8 one,
# both halves on a B fragment), FP 56 (the same padding, a half at a
# time), FP 64 (the widest, a half at a time, no padding depth)
@pytest.mark.parametrize("f,N,inverse", [(20, 300, False), (50, 200, True),
                                         (64, 100, False)])
@pytest.mark.parametrize("mode", ["high", "fast"])
def test_emulated_point_decode_widths(lib, f, N, inverse, mode):
    check_decode(lib, f, N, inverse, mode)


# exact replacements in the source, and the mode whose checks they fail
MUTANTS = {
    # W1's lo plane read as its hi plane: hi hi + hi hi + lo hi at 'high'
    "w1_lo_as_hi": ("high", [
        ("b1.l[0] = HIGH ? su[L::kW1 + L::kW1Lo + wi] : 0u;",
         "b1.l[0] = HIGH ? su[L::kW1 + wi] : 0u;"),
        ("b1.l[1] = HIGH && !half ? su[L::kW1 + L::kW1Lo + wi + 4] : 0u;",
         "b1.l[1] = HIGH && !half ? su[L::kW1 + wi + 4] : 0u;")]),
    # the W1 product's accumulators in a wrong layout: element 1 (row g,
    # column 2 t + 1) and element 2 (row g + 8, column 2 t) swapped
    "c_layout": ("fast", [
        ("fmaxf(ab.z * c[1] + ab.w, 0.f)", "fmaxf(ab.z * c[2] + ab.w, 0.f)"),
        ("fmaxf(ab.x * c[2] + ab.y, 0.f)", "fmaxf(ab.x * c[1] + ab.y, 0.f)")]),
}


@pytest.mark.parametrize("name", list(MUTANTS))
def test_emulated_point_decode_mutant(tmp_path, name):
    mode, patch = MUTANTS[name]
    with open(SOURCE) as f:
        text = f.read()
    for old, new in patch:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    mutant = build_emulated(text, tmp_path)
    with pytest.raises(AssertionError):
        check_decode(mutant, 37, 50, False, mode)


def _unpair(words: torch.Tensor) -> torch.Tensor:
    """int32 words of bf16 pairs (..., m) as their values (..., 2 m), the
    lower half first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([(w & 0xFFFF) << 16, w & 0xFFFF0000], -1)
    halves = halves - ((halves >> 31) << 32)
    return halves.to(torch.int32).view(torch.float32).flatten(-2)


@pytest.mark.parametrize("f", [8, 37])
@pytest.mark.parametrize("mode", ["high", "fast"])
def test_kernel_weights_pairs(f, mode):
    """kernel_weights at 'fast' and 'high': csrc/point_decode.cu's
    TcLayout, each pair word the bf16 bits of the rounded ('fast') or hi
    and lo ('high') weights at its depths, the padding zeros, the biases
    fp32."""
    packed, _, _ = _inputs(f, 2, 8, f)
    words = kernel_weights(packed, mode).view(torch.int32)
    K, C = packed["w1"].shape[:2]
    FP, WS = padded_width(f), pair_stride(padded_width(f))
    assert tuple(words.shape) == (K, C, layout_words(f, mode))
    if mode == "fast":
        parts = [[bf16_round(packed[k]) for k in ("w1", "w0", "w2")]]
    else:
        split = [bf16_split(packed[k]) for k in ("w1", "w0", "w2")]
        parts = [[s[0] for s in split], [s[1] for s in split]]
    # each product's planes (hi, then at 'high' lo) and its padding
    pads = [(0, 2 * WS - f, 0, FP - f), (0, 1, 0, FP - f),
            (0, 2 * WS - f, 0, 1)]
    shapes = [(2, FP, WS), (2, FP, 2), (2, 4, WS)]
    at = 0
    for i, (pad, shape) in enumerate(zip(pads, shapes)):
        for plane in parts:
            n = int(np.prod(shape))
            got = _unpair(words[..., at:at + n].reshape(K, C, *shape))
            assert torch.equal(got, F.pad(plane[i], pad)), (mode, i)
            at += n
    b0 = words[..., at:at + 2 * FP].view(torch.float32)
    assert torch.equal(b0, F.pad(packed["b0"], (0, FP - f)).flatten(-2))
    b2 = words[..., at + 2 * FP:].view(torch.float32)
    assert torch.equal(b2, F.pad(packed["b2"], (0, 1)).flatten(-2))
