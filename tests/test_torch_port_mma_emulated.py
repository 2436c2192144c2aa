"""The tensor-core product step of kernels 7 and 8's 'high' and 'fast' passes
(go_with_the_flows_tpu_torch/csrc/mma_bf16.cuh: mma.sync m16n8k16, bf16
operands, fp32 accumulators) built by g++ against the CPU stand-in for
CUDA (tests/cuda_cpu_emulation.h) and run on the CPU, the lanes of one
warp taking turns on one CPU thread.

A small kernel around the step (below) forms C = A B^T of an M x FP and
an N x FP operand, staged as fp32 words the way the kernels stage them
(bf16-rounded values at 'fast', a value's bf16 hi and lo parts packed in
one word at 'high'), one 16 x 8 tile of C at a time over the depth's
16-wide steps, and stores each lane's accumulators where the step's
documented C layout puts them. It is held against torch products of the
same bf16 operands in float64 (one at 'fast'; hi hi + hi lo + lo hi at
'high'), at the padded depths 8, 24 and 40 (the last step half padding)
and with M = 24 rows (the last 16-row tile half padding). Words past the
depth and rows past M are NaN: a step that read one would return NaN.
A copy of the header whose accumulator elements take a wrong (row,
column) must fail the same comparison.

The same step on operands staged as bf16 pairs (a row of hi pairs and,
at 'high', a plane of lo pairs: kernel 7's forward at 'high' and 'fast')
is held the same way.

Without a card the step computes each lane's accumulator elements from
the tiles in fp32 FMAs; only the card checks the fragments and the
instruction (chip_smoke.py phases 1 and 2)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "go_with_the_flows_tpu_torch",
                    "csrc")
HEADER = "mma_bf16.cuh"

# the C layout of an accumulator element, as the header's CPU branch has it
LAYOUT = "const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);"

KERNEL = r"""
#include "cuda_cpu_emulation.h"
#include "mma_bf16.cuh"

// C (M x N, row stride N) = A (M x FP words, row stride as) times B (N x
// FP words, row stride bs) transposed, one warp: tile (mt, nt) over the
// depth steps, each lane's accumulators stored by the step's C layout
template <int FP, bool HIGH>
void product(const float* a, int as, const float* b, int bs, float* c,
             int M, int N) {
  constexpr int KS = (FP + 15) / 16;
  constexpr bool KH = FP % 16 != 0;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int MT = (M + 15) / 16;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < N / 8; ++nt) {
      const bool mh = M % 16 != 0 && mt == MT - 1;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < KS; ++ks) {
        const bool kh = KH && ks == KS - 1;
        const float* ap = a + 16 * mt * as + 16 * ks;
        const MmaA fa = kh ? (mh ? mma_load_a<HIGH, true, true>(ap, as)
                                 : mma_load_a<HIGH, true>(ap, as))
                           : (mh ? mma_load_a<HIGH, false, true>(ap, as)
                                 : mma_load_a<HIGH>(ap, as));
        const float* bp = b + 8 * nt * bs + 16 * ks;
        const MmaB fb = kh ? mma_load_b<HIGH, true>(bp, bs)
                           : mma_load_b<HIGH>(bp, bs);
        mma_step<HIGH>(acc, fa, fb);
      }
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1),
                  col = 8 * nt + 2 * t + (e & 1);
        if (row < M) c[row * N + col] = acc[e];
      }
    }
}

// the same product from bf16 pairs (mma_load_a_pairs, mma_load_b_pairs):
// rows of `as` (`bs`) words, lo planes `alo` (`blo`) words on; M a
// multiple of 16
template <int FP, bool HIGH>
void product_pairs(const unsigned* a, int as, int alo, const unsigned* b,
                   int bs, int blo, float* c, int M, int N) {
  constexpr int KS = (FP + 15) / 16;
  constexpr bool KH = FP % 16 != 0;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int mt = 0; mt < M / 16; ++mt)
    for (int nt = 0; nt < N / 8; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < KS; ++ks) {
        const bool kh = KH && ks == KS - 1;
        const unsigned* ap = a + 16 * mt * as + 8 * ks;
        const unsigned* bp = b + 8 * nt * bs + 8 * ks;
        const MmaA fa = kh ? mma_load_a_pairs<HIGH, true>(ap, as, alo)
                           : mma_load_a_pairs<HIGH>(ap, as, alo);
        const MmaB fb = kh ? mma_load_b_pairs<HIGH, true>(bp, bs, blo)
                           : mma_load_b_pairs<HIGH>(bp, bs, blo);
        mma_step<HIGH>(acc, fa, fb);
      }
      for (int e = 0; e < 4; ++e)
        c[(16 * mt + g + 8 * (e >> 1)) * N + 8 * nt + 2 * t + (e & 1)] =
            acc[e];
    }
}

extern "C" int mma_product_pairs(const unsigned* a, int as, int alo,
                                 const unsigned* b, int bs, int blo,
                                 float* c, int M, int N, int FP, int high) {
  emu_launch(dim3(1), dim3(32), 0, nullptr, [&] {
#define PAIRS(D)                                                        \
  if (FP == D) {                                                        \
    if (high)                                                           \
      product_pairs<D, true>(a, as, alo, b, bs, blo, c, M, N);          \
    else                                                                \
      product_pairs<D, false>(a, as, alo, b, bs, blo, c, M, N);         \
  }
    PAIRS(8) PAIRS(24) PAIRS(40)
#undef PAIRS
  });
  return FP == 8 || FP == 24 || FP == 40 ? 0 : 1;
}

template <int FP>
int run(const float* a, int as, const float* b, int bs, float* c, int M,
        int N, int high) {
  emu_launch(dim3(1), dim3(32), 0, nullptr, [&] {
    if (high)
      product<FP, true>(a, as, b, bs, c, M, N);
    else
      product<FP, false>(a, as, b, bs, c, M, N);
  });
  return 0;
}

extern "C" int mma_product(const float* a, int as, const float* b, int bs,
                           float* c, int M, int N, int FP, int high) {
  switch (FP) {
    case 8: return run<8>(a, as, b, bs, c, M, N, high);
    case 24: return run<24>(a, as, b, bs, c, M, N, high);
    case 40: return run<40>(a, as, b, bs, c, M, N, high);
    default: return 1;
  }
}
"""


def build(header_dir, out):
    """The test kernel against the header in `header_dir`, by g++, into
    out/libmma.so."""
    gxx = shutil.which("g++")
    src = out / "mma_test.cpp"
    src.write_text(KERNEL)
    so = out / "libmma.so"
    done = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                           "-I", HERE, "-I", str(header_dir), "-o", str(so),
                           str(src), "-lpthread"],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on the MMA test kernel:\n"
                           f"{done.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mma_product.argtypes = [P, I, P, I, P, I, I, I, I]
    lib.mma_product.restype = I
    lib.mma_product_pairs.argtypes = [P, I, I, P, I, I, P, I, I, I, I]
    lib.mma_product_pairs.restype = I
    return lib


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source against the emulation")


@pytest.fixture(scope="module")
def lib(gxx, tmp_path_factory):
    return build(CSRC, tmp_path_factory.mktemp("mma"))


def _bf16(x):
    """x rounded to bf16 (ties to even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _operand(x, high):
    """The words a kernel stages for x, and x's (hi, lo) parts: at 'fast'
    the rounded values (lo zero), at 'high' hi = bf16(x) and lo = bf16(x -
    hi) packed, hi's bits in the upper half."""
    hi = _bf16(x)
    if not high:
        return hi, hi, torch.zeros_like(hi)
    lo = _bf16(x - hi)
    bits = hi.view(torch.int32) | ((lo.view(torch.int32) >> 16) & 0xFFFF)
    return bits.view(torch.float32), hi, lo


def _staged(words, depth, rows):
    """words (r x depth) in an array of `rows` rows of depth + 8 words, NaN
    past the depth and past r; (array, row stride)."""
    out = torch.full((rows, depth + 8), float("nan"))
    out[:words.shape[0], :depth] = words
    return out.contiguous(), depth + 8


def _product(lib, depth, M, N, high, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((M, depth)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((N, depth)).astype(np.float32))
    wa, ah, al = _operand(a, high)
    wb, bh, bl = _operand(b, high)
    sa, a_s = _staged(wa, depth, (M + 15) // 16 * 16)
    sb, b_s = _staged(wb, depth, N)
    c = torch.full((M, N), float("nan"))
    assert lib.mma_product(sa.data_ptr(), a_s, sb.data_ptr(), b_s,
                           c.data_ptr(), M, N, depth, int(high)) == 0
    ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
    want = ah @ bh.T
    if high:
        want = want + ah @ bl.T + al @ bh.T
    return c, want


@pytest.mark.parametrize("high", [False, True], ids=["fast", "high"])
@pytest.mark.parametrize("depth", [8, 24, 40])
def test_mma_step_emulated(lib, depth, high):
    """C = A B^T of 32 x depth and 16 x depth operands, and of 24 x depth
    ones (the last 16-row tile half padding), against float64 products of
    the same bf16 parts: within 1e-6 of C's largest entry (fp32 sums of at
    most 40 exact bf16 products, or 120 at 'high'), no NaN from a padded
    word."""
    for M, N in ((32, 16), (24, 40)):
        got, want = _product(lib, depth, M, N, high, seed=depth + M)
        assert not torch.isnan(got).any()
        err = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert err < 1e-6, (M, N, err)


def test_mma_step_layout_mutant(gxx, tmp_path):
    """A copy of the header whose accumulator elements take the wrong
    (row, column), element i at row g + 8 (i & 1) and column 2t + i / 2,
    fails the comparison of test_mma_step_emulated."""
    text = open(os.path.join(CSRC, HEADER)).read()
    assert text.count(LAYOUT) == 1
    (tmp_path / HEADER).write_text(text.replace(
        LAYOUT, "const int r = g + 8 * (i & 1), n = 2 * t + (i >> 1);"))
    mutant = build(tmp_path, tmp_path)
    for high in (False, True):
        got, want = _product(mutant, 24, 32, 16, high, seed=5)
        err = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert err > 1e-2, err


def _pairs(parts, depth):
    """bf16 values (r x depth) as rows of bf16 pairs, depth 2j in word j's
    lower half, each row depth / 2 + 4 words, the padding words NaN in
    both halves; (int32 array, row stride)."""
    bits = (parts.view(torch.int32) >> 16) & 0xFFFF
    words = bits[:, 0::2] | (bits[:, 1::2] << 16)
    out = torch.full((parts.shape[0], depth // 2 + 4), -1, dtype=torch.int32)
    out[:, :depth // 2] = words
    return out, depth // 2 + 4


@pytest.mark.parametrize("high", [False, True], ids=["fast", "high"])
@pytest.mark.parametrize("depth", [8, 24, 40])
def test_mma_step_pairs_emulated(lib, depth, high):
    """The step on operands staged as bf16 pairs (`mma_load_a_pairs`,
    `mma_load_b_pairs`: a row of hi pairs, at 'high' a plane of lo pairs
    after it, as kernel 7's forward passes stage a and W1): C = A B^T of
    32 x depth and 16 x depth operands and of 16 x depth and 40 x depth
    ones against float64 products of the same bf16 parts, within 1e-6 of
    C's largest entry; the padding pairs past the depth are NaN and must
    not be read."""
    for M, N in ((32, 16), (16, 40)):
        rng = np.random.default_rng(depth + M + 100)
        a = torch.from_numpy(rng.standard_normal((M, depth)).astype(
            np.float32))
        b = torch.from_numpy(rng.standard_normal((N, depth)).astype(
            np.float32))
        _, ah, al = _operand(a, high)
        _, bh, bl = _operand(b, high)
        (pa, a_s), (pal, _) = _pairs(ah, depth), _pairs(al, depth)
        (pb, b_s), (pbl, _) = _pairs(bh, depth), _pairs(bl, depth)
        sa = torch.cat([pa, pal]).contiguous()   # lo plane M rows on
        sb = torch.cat([pb, pbl]).contiguous()
        c = torch.full((M, N), float("nan"))
        assert lib.mma_product_pairs(sa.data_ptr(), a_s, M * a_s,
                                     sb.data_ptr(), b_s, N * b_s,
                                     c.data_ptr(), M, N, depth,
                                     int(high)) == 0
        ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
        want = ah @ bh.T
        if high:
            want = want + ah @ bl.T + al @ bh.T
        assert not torch.isnan(c).any()
        err = ((c.double() - want).abs().max() / want.abs().max()).item()
        assert err < 1e-6, (M, N, err)
