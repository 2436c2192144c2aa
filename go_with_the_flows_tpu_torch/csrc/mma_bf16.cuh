// One warp's tensor-core product step, mma.sync m16n8k16 with bf16
// operands and fp32 accumulators, on operands that sit in shared memory as
// fp32 words: a bf16-rounded value (its low half zeros), or at 'high' a
// value's two bf16 parts packed in one word (train_decode.cuh's
// pack_split: hi's bits in the upper half, lo's in the lower). Included
// after <cuda_runtime.h> by train_decode.cuh (kernels 7 and 8) and
// point_decode.cu (kernel 1), which share the precision modes' MODE
// numbers, bf16 rounding and the bf16 pair layout of W1 below.
//
// A is 16 x 16 (rows r, depth k), element (r, k) at a[r * as + k]; B is
// 16 x 8 (depth k, columns n), element (k, n) at b[n * bs + k]: both with
// the depth consecutive, so that a fragment register, two neighbouring
// depths, comes from two words by one byte permutation (prmt) each for
// the hi parts and the lo parts. The fragments and the accumulator follow
// the PTX ISA's m16n8k16 layout: lane = 4 g + t holds A's (g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..), B's (2t..2t+1, g) and
// (2t + 8.., g), and c = C's (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
//
// mma_step<HIGH>(c, A, B) adds A B to c: one product of the hi parts, or
// at 'high' (HIGH) three into the same accumulators, hi hi + hi lo + lo
// hi, which is train_kernel.py's `_mxdot` at precision 'high' (the lo lo
// term left out). KHALF marks a step whose depths 8-15 are padding and
// MHALF a tile whose rows 8-15 are: they are zeros, and no word of them is
// read. WIDE reads a register's two words as one 8-byte load: the tile's
// address must be 8-byte aligned and its stride even.
//
// Operands may also sit as bf16 pairs, two neighbouring depths in one
// 32-bit word (the lower depth in the lower half, as cvt.rn.bf16x2.f32
// and the fragments have them): a row of hi pairs and, at 'high', a plane
// of lo pairs `lo` words on. mma_load_a_pairs and mma_load_b_pairs read a
// fragment register as one word, with no byte permutation: half the bytes
// of the fp32 words at 'fast'. Kernel 7's forward passes stage a and W1
// so (warp_product_pairs).
//
// Register fragments (FragA, FragB; frag_mma): operands that a warp forms
// in its registers in the layout above, never in shared memory, such as
// kernel 1's, whose products feed one another's A fragments from their
// accumulators (C's n-tiles 2 ks and 2 ks + 1 are A's k-step ks). KHALF
// there is the m16n8k8 instruction: registers 2 and 3 of A and 1 of B are
// not read.
//
// Without a card (the CPU emulation of tests/cuda_cpu_emulation.h) a
// fragment is the tile's address, and mma_step forms each of the lane's
// four accumulator elements from the tiles, in the same C layout, with
// fp32 FMAs on the bf16 values: no shuffle and no barrier. The emulation
// checks the tiling, the padding, the epilogues' indexing and the WIDE
// tiles' alignment; only the card checks the fragments and the
// instruction itself. A register fragment there is the lane's words: the
// warp's lanes exchange them (emu_warp_exchange, a barrier of the warp)
// and each lane forms its accumulator elements from the fragments' PTX
// layout, so that the layout of what a kernel puts in its registers is
// checked too.

#pragma once

namespace {

constexpr int kHighest = 0, kHigh = 1, kFast = 2;  // MODE (ops/precision.py)

// v rounded to the nearest bf16 (ties to even), as an fp32 value: one
// cvt on the card; bitwise where there is no card (the CPU emulation)
__device__ __forceinline__ float bf16_round(float v) {
#ifdef __CUDA_ARCH__
  unsigned short r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(v));
  return __uint_as_float(static_cast<unsigned>(r) << 16);
#else
  const unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;  // NaN
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
#endif
}


#ifdef __CUDA_ARCH__
struct MmaA {
  unsigned h[4], l[4];  // hi and lo bf16 pairs
};
struct MmaB {
  unsigned h[2], l[2];
};

// words p[0], p[1] (one 8-byte load at WIDE) as two bf16 pairs: their hi
// parts (p[0]'s in the low half) and their lo parts
template <bool WIDE>
__device__ __forceinline__ void mma_pairs(const float* p, unsigned& hi,
                                          unsigned& lo) {
  unsigned x, y;
  if constexpr (WIDE) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x = __float_as_uint(v.x);
    y = __float_as_uint(v.y);
  } else {
    x = __float_as_uint(p[0]);
    y = __float_as_uint(p[1]);
  }
  hi = __byte_perm(x, y, 0x7632);
  lo = __byte_perm(x, y, 0x5410);
}

template <bool HIGH, bool KHALF = false, bool MHALF = false,
          bool WIDE = false>
__device__ __forceinline__ MmaA mma_load_a(const float* a, int as) {
  const int lane = threadIdx.x & 31;
  const float* r0 = a + (lane >> 2) * as + 2 * (lane & 3);
  const float* r8 = r0 + 8 * as;
  const float* at[4] = {r0, r8, r0 + 8, r8 + 8};
  MmaA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.h[i] = f.l[i] = 0u;
    if (!((KHALF && i >= 2) || (MHALF && (i & 1))))
      mma_pairs<WIDE>(at[i], f.h[i], f.l[i]);
  }
  return f;
}

template <bool HIGH, bool KHALF = false, bool WIDE = false>
__device__ __forceinline__ MmaB mma_load_b(const float* b, int bs) {
  const int lane = threadIdx.x & 31;
  const float* c0 = b + (lane >> 2) * bs + 2 * (lane & 3);
  MmaB f;
  f.h[1] = f.l[1] = 0u;
  mma_pairs<WIDE>(c0, f.h[0], f.l[0]);
  if (!KHALF) mma_pairs<WIDE>(c0 + 8, f.h[1], f.l[1]);
  return f;
}

// bf16 pairs (above): A's rows of `as` words, B's columns of `bs` words,
// a pointing at the step's first pair (depth 16 ks: word 8 ks of the row)
template <bool HIGH, bool KHALF = false>
__device__ __forceinline__ MmaA mma_load_a_pairs(const unsigned* a, int as,
                                                 int lo) {
  const int lane = threadIdx.x & 31;
  const unsigned* r0 = a + (lane >> 2) * as + (lane & 3);
  const unsigned* at[4] = {r0, r0 + 8 * as, r0 + 4, r0 + 8 * as + 4};
  MmaA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool pad = KHALF && i >= 2;
    f.h[i] = pad ? 0u : *at[i];
    f.l[i] = pad || !HIGH ? 0u : at[i][lo];
  }
  return f;
}

template <bool HIGH, bool KHALF = false>
__device__ __forceinline__ MmaB mma_load_b_pairs(const unsigned* b, int bs,
                                                 int lo) {
  const int lane = threadIdx.x & 31;
  const unsigned* c0 = b + (lane >> 2) * bs + (lane & 3);
  MmaB f;
  f.h[0] = c0[0];
  f.h[1] = KHALF ? 0u : c0[4];
  f.l[0] = HIGH ? c0[lo] : 0u;
  f.l[1] = HIGH && !KHALF ? c0[lo + 4] : 0u;
  return f;
}

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool HIGH>
__device__ __forceinline__ void mma_step(float c[4], const MmaA& a,
                                         const MmaB& b) {
  mma_bf16(c, a.h, b.h);
  if constexpr (HIGH) {
    mma_bf16(c, a.h, b.l);
    mma_bf16(c, a.l, b.h);
  }
}

// the m16n8k8 step (KHALF): A's registers 0 and 1, B's register 0
__device__ __forceinline__ void mma_bf16_k8(float c[4], const unsigned a[4],
                                            const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

using FragA = MmaA;
using FragB = MmaB;

// c += A B of register fragments, three products at 'high' as mma_step
template <bool HIGH, bool KHALF = false>
__device__ __forceinline__ void frag_mma(float c[4], const FragA& a,
                                         const FragB& b) {
  if constexpr (KHALF) {
    mma_bf16_k8(c, a.h, b.h);
    if constexpr (HIGH) {
      mma_bf16_k8(c, a.h, b.l);
      mma_bf16_k8(c, a.l, b.h);
    }
  } else {
    mma_step<HIGH>(c, a, b);
  }
}
#else
// `bad`: a WIDE tile whose pairs are not 8-byte aligned (its address or
// its stride), which makes the step's accumulators NaN. `lo` >= 0: a tile
// of bf16 pairs (p a row's first pair, s its stride in words), its lo
// plane `lo` words on; -1: fp32 words
struct MmaA {
  const float* p;
  int s;
  bool khalf, mhalf, bad;
  int lo;
};
struct MmaB {
  const float* p;
  int s;
  bool khalf, bad;
  int lo;
};

__device__ __forceinline__ bool mma_misaligned(const float* p, int s) {
  return (reinterpret_cast<unsigned long long>(p) & 7) || (s & 1);
}

template <bool HIGH, bool KHALF = false, bool MHALF = false,
          bool WIDE = false>
__device__ __forceinline__ MmaA mma_load_a(const float* a, int as) {
  return MmaA{a, as, KHALF, MHALF, WIDE && mma_misaligned(a, as), -1};
}

template <bool HIGH, bool KHALF = false, bool WIDE = false>
__device__ __forceinline__ MmaB mma_load_b(const float* b, int bs) {
  return MmaB{b, bs, KHALF, WIDE && mma_misaligned(b, bs), -1};
}

template <bool HIGH, bool KHALF = false>
__device__ __forceinline__ MmaA mma_load_a_pairs(const unsigned* a, int as,
                                                 int lo) {
  return MmaA{reinterpret_cast<const float*>(a), as, KHALF, false, false,
              HIGH ? lo : 0};
}

template <bool HIGH, bool KHALF = false>
__device__ __forceinline__ MmaB mma_load_b_pairs(const unsigned* b, int bs,
                                                 int lo) {
  return MmaB{reinterpret_cast<const float*>(b), bs, KHALF, false,
              HIGH ? lo : 0};
}

// a word's hi part (HI), or its lo part, as an fp32 value
template <bool HI>
__device__ __forceinline__ float mma_part(float w) {
  const unsigned u = __float_as_uint(w);
  return __uint_as_float(HI ? u & 0xffff0000u : u << 16);
}

// c + the sum over k < depth of A's part (AH) of a[k] times B's of b[k]
template <bool AH, bool BH>
__device__ __forceinline__ float mma_dot(const float* a, const float* b,
                                         int depth, float c) {
  for (int k = 0; k < depth; ++k)
    c = fmaf(mma_part<AH>(a[k]), mma_part<BH>(b[k]), c);
  return c;
}

// depth k's part (HI) of a row of bf16 pairs (its lo plane `lo` words on)
template <bool HI>
__device__ __forceinline__ float mma_pair_part(const float* row, int lo,
                                               int k) {
  const unsigned w = __float_as_uint(row[(HI ? 0 : lo) + k / 2]);
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

// mma_dot of a row of A and a column of B, each fp32 words or bf16 pairs
template <bool AH, bool BH>
__device__ __forceinline__ float mma_dot_any(const MmaA& a, const float* ar,
                                             const MmaB& b, const float* bn,
                                             int depth, float c) {
  if (a.lo < 0 && b.lo < 0) return mma_dot<AH, BH>(ar, bn, depth, c);
  for (int k = 0; k < depth; ++k) {
    const float x = a.lo < 0 ? mma_part<AH>(ar[k])
                             : mma_pair_part<AH>(ar, a.lo, k);
    const float y = b.lo < 0 ? mma_part<BH>(bn[k])
                             : mma_pair_part<BH>(bn, b.lo, k);
    c = fmaf(x, y, c);
  }
  return c;
}

template <bool HIGH>
__device__ __forceinline__ void mma_step(float c[4], const MmaA& a,
                                         const MmaB& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int depth = a.khalf || b.khalf ? 8 : 16;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    if (a.bad || b.bad) c[i] = __uint_as_float(0x7fc00000u);
    if (a.mhalf && r >= 8) continue;
    const float* ar = a.p + r * a.s;
    const float* bn = b.p + n * b.s;
    // the products in the card's order: hi hi, then at 'high' hi lo and
    // lo hi
    c[i] = mma_dot_any<true, true>(a, ar, b, bn, depth, c[i]);
    if constexpr (HIGH) {
      c[i] = mma_dot_any<true, false>(a, ar, b, bn, depth, c[i]);
      c[i] = mma_dot_any<false, true>(a, ar, b, bn, depth, c[i]);
    }
  }
}

struct FragA {
  unsigned h[4], l[4];
};
struct FragB {
  unsigned h[2], l[2];
};

// element k (0 or 1) of a bf16 pair, as an fp32 value
__device__ __forceinline__ float mma_pair_elem(unsigned w, int k) {
  return __uint_as_float(k ? w & 0xffff0000u : w << 16);
}

// c += A B of the warp's register fragments: the lanes hand in their
// words (A's hi and lo pairs, then B's), and each lane forms its four
// accumulator elements from them in the PTX layout, in the card's order
template <bool HIGH, bool KHALF = false>
__device__ __forceinline__ void frag_mma(float c[4], const FragA& a,
                                         const FragB& b) {
#ifdef GWTF_CPU_EMULATION  // tests/cuda_cpu_emulation.h; not nvcc's host pass
  const unsigned mine[12] = {a.h[0], a.h[1], a.h[2], a.h[3],
                             a.l[0], a.l[1], a.l[2], a.l[3],
                             b.h[0], b.h[1], b.l[0], b.l[1]};
  const unsigned* w = emu_warp_exchange(mine, 12);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int depth = KHALF ? 8 : 16;
  // A's (r, k) and B's (k, n), their hi or lo part (kEmuWords words a lane)
  auto A = [&](bool hi, int r, int k) {
    const int from = (r & 7) * 4 + ((k & 7) >> 1);
    return mma_pair_elem(w[from * kEmuWords + (hi ? 0 : 4) + (r >> 3) +
                           2 * (k >> 3)],
                         k & 1);
  };
  auto Bv = [&](bool hi, int k, int n) {
    const int from = n * 4 + ((k & 7) >> 1);
    return mma_pair_elem(w[from * kEmuWords + (hi ? 8 : 10) + (k >> 3)],
                         k & 1);
  };
  for (int i = 0; i < 4; ++i) {
    // C's (r, n) in the lane's element i (the C layout above)
    const int r = (i & 2 ? 8 : 0) + g, n = (i & 1) + 2 * t;
    for (int k = 0; k < depth; ++k)
      c[i] = fmaf(A(true, r, k), Bv(true, k, n), c[i]);
    if constexpr (HIGH) {
      for (int k = 0; k < depth; ++k)
        c[i] = fmaf(A(true, r, k), Bv(false, k, n), c[i]);
      for (int k = 0; k < depth; ++k)
        c[i] = fmaf(A(false, r, k), Bv(true, k, n), c[i]);
    }
  }
#endif
}
#endif

// Kernels 1 and 7 at 'high' and 'fast' take their W1 products' operands
// as bf16 pairs (above), half the shared-memory bytes of fp32 words at
// 'fast' and no byte permutations: W1 (stage_w1_pairs; kernel 1's layout,
// ops/kernels/point_decode.py) as rows of
// w1_pair_stride words a feature o, [h][o][j] = depths 2j, 2j + 1, FP / 2
// padded to 4 mod 8 so that a B fragment's 32 words fall in 32 banks, its
// lo plane at 'high' w1_pair_words / 2 words on; a as a row of hi pairs
// and at 'high' one of lo pairs (train_decode.cuh's hidden_h2).
template <int FP>
__host__ __device__ constexpr int w1_pair_stride() {
  return (FP / 2) % 8 == 4 ? FP / 2 : FP / 2 + 4;
}
template <int FP, int MODE>
__host__ __device__ constexpr int w1_pair_words() {
  return (MODE == kHigh ? 2 : 1) * 2 * FP * w1_pair_stride<FP>();
}

// the bf16 pair of two values that are bf16 already (held as fp32): v's
// bits in the lower half, w's in the upper
__device__ __forceinline__ unsigned bf16_bits_pair(float v, float w) {
  return (__float_as_uint(v) >> 16) | (__float_as_uint(w) & 0xffff0000u);
}

// v and w rounded to bf16 (ties to even) as a pair, v in the lower half:
// one cvt on the card
__device__ __forceinline__ unsigned bf16x2_round(float v, float w) {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(w), "f"(v));
  return r;
#else
  return bf16_bits_pair(bf16_round(v), bf16_round(w));
#endif
}

// W1 of coupling kc as bf16 pairs (above), zero padded, by a block of T
// threads; w1 the rounded W1, at 'high' its hi parts followed by its lo
// parts `lo` floats on
template <int FP, int MODE, int T>
__device__ void stage_w1_pairs(unsigned* s, const float* w1, long long kc,
                               int f, long long lo) {
  constexpr int WS = w1_pair_stride<FP>(), PLANE = 2 * FP * WS;
  const float* g = w1 + kc * 2 * f * f;
  for (int idx = threadIdx.x; idx < PLANE; idx += T) {
    const int h = idx / (FP * WS), o = (idx / WS) % FP, i = 2 * (idx % WS);
    const float* row = g + (h * f + o) * f;
    const bool on0 = o < f && i < f, on1 = o < f && i + 1 < f;
    s[idx] = bf16_bits_pair(on0 ? row[i] : 0.f, on1 ? row[i + 1] : 0.f);
    if constexpr (MODE == kHigh)
      s[PLANE + idx] = bf16_bits_pair(on0 ? row[lo + i] : 0.f,
                                      on1 ? row[lo + i + 1] : 0.f);
  }
}

// 'high' and 'fast', kernel 7: the warp's 32 rows of a (bf16 pairs from
// word 0 of each row, at 'high' the lo pairs from word FP / 2) times head
// h's W1 (w: its pairs, its lo plane wl words on) on the tensor cores:
// h2 = W1 a, each 16 x 8 accumulator tile handed to ep(m, nt, c): rows
// 16 m + g and 16 m + g + 8 (g = lane / 4) and columns 8 nt + 2 t and 8
// nt + 2 t + 1 (t = lane % 4), c in the C layout above. A B fragment
// serves both 16-row halves up to FP = 40; above, the two halves'
// accumulators spilled beside the passes' own registers. Depths past FP
// are padding.
template <int FP, int MODE, class Ep>
__device__ __forceinline__ void warp_product_pairs(const float* rows,
                                                   int rs,
                                                   const unsigned* w, int wl,
                                                   Ep&& ep) {
  constexpr int KS = (FP + 15) / 16, NT = FP / 8, WS = w1_pair_stride<FP>();
  constexpr bool KH = FP % 16 != 0, HIGH = MODE == kHigh;
  constexpr int MB = FP > 40 ? 1 : 2;  // halves a B fragment serves
  const unsigned* ar = reinterpret_cast<const unsigned*>(rows);
  __syncwarp();  // the rows' a are written
#pragma unroll
  for (int m0 = 0; m0 < 2; m0 += MB) {
    float c[MB][NT][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mb][nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bool pad = KH && ks == KS - 1;
      MmaA a[MB];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const unsigned* ap = ar + 16 * (m0 + mb) * rs + 8 * ks;
        a[mb] = pad ? mma_load_a_pairs<HIGH, true>(ap, rs, FP / 2)
                    : mma_load_a_pairs<HIGH>(ap, rs, FP / 2);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned* bp = w + 8 * nt * WS + 8 * ks;
        const MmaB b = pad ? mma_load_b_pairs<HIGH, true>(bp, WS, wl)
                           : mma_load_b_pairs<HIGH>(bp, WS, wl);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) mma_step<HIGH>(c[mb][nt], a[mb], b);
      }
    }
    __syncwarp();  // the halves' a are read before their h2 lands
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ep(m0 + mb, nt, c[mb][nt]);
  }
  __syncwarp();
}

}  // namespace
