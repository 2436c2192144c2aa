// Eval-mode decode of the K-component point coupling chain, in the three
// matmul precision modes of ops/precision.py (MODE below).
//
// Replaces: go_with_the_flows_tpu/ops/pallas/coupling_kernel.py
// `_decode_kernel` (the pallas_call in `_fused_point_decode_impl`, public
// `fused_point_decode`). Host-side packing and the math are described in
// go_with_the_flows_tpu_torch/ops/kernels/point_decode.py.
//
// What bounds it on an H100: FP32 compute at 'highest', the tensor cores
// at 'high' and 'fast'. A point costs about 3.2k multiply-adds per
// coupling, almost all in the two f x f W1 products (f = 37 at the
// flagship), while it reads 12 B and writes 24 B for the whole chain of
// C = 33 couplings. What bounds this kernel is issue: at 'highest' the
// FMAs and the shared-memory loads that feed them the weights; at the
// other modes the CUDA-core work around the products.
//
// What the design does about it, in every mode:
//   * device memory sees the points once: their x[3] and logvar sums stay
//     in registers through all C couplings; one block per (component k,
//     cloud b, tile of 512 points at 'highest', 256 at the other modes);
//   * the weights come in a kernel layout of their mode (`kernel_weights`
//     in the wrapper, made once with the packing): per component and
//     coupling one contiguous block, already padded to FP (f rounded up to
//     a multiple of 8, zeros), so staging is plain 16-byte copies;
//   * staging runs ahead: while coupling c runs, coupling c+1's weights
//     and the cloud's FiLM rows are copied into the other of two shared
//     buffers with cp.async (the L2 latency hidden), and a coupling costs
//     one barrier;
//   * the two heads run separately (no block-diagonal 2f x 2f W1 as on
//     the TPU, whose zeros would cost work here).
//
// 'highest' (MODE 0; decode_highest), fp32 FMAs on the CUDA cores (TF32
// keeps about three digits):
//   * the register tile: each thread carries P points, so every weight
//     loaded from shared memory feeds P points: a 16-byte load of a W1 row
//     feeds 4 P FMAs, and the per-row records (w0 and b0 in one float4, w2
//     in one, the FiLM alpha and beta in one float2) cost one load each
//     for all of a thread's points. P is 4 where h0 of 4 points fits the
//     registers without a spill (FP <= 40, the flagship's width), else 2;
//   * only h0 (f floats a point) lives per thread: h1 is made one row at
//     a time and folded straight into the 3-wide y; the row loop runs to
//     the real f.
//
// 'high' (MODE 1) and 'fast' (MODE 2; decode_tc): all three products are
// warp mma.sync bf16 steps on register fragments (mma_bf16.cuh's
// frag_mma), a thread a point and each warp on its own 32 points, and
// nothing between them leaves the registers:
//   * h0 = ReLU(W0 x + b0): x's rows as A fragments (depths 0-2, an m16n8k8
//     step; the lanes of a group take their rows' x by shuffles) times W0;
//     its accumulators, b0 added and ReLU'd, are the A fragments of the W1
//     product (C's n-tiles 2 ks and 2 ks + 1 are A's k-step ks);
//   * h1 = ReLU(alpha (W1 h0) + beta) the same way from the W1 product's
//     accumulators into the A fragments of the W2 product, whose B repeats
//     W2's rows across the 8 columns (rows 0, 1, 0, 1, ... and 2, a zero
//     row, 2, ...), so that every lane of a group ends with y of the
//     group's 4 rows, and lane 4 g + t carries the row whose y it keeps
//     (tc_row): no shuffle and no shared memory for y;
//   * one B fragment of W1 serves both 16-row halves of the warp up to FP
//     = 40, above it a half at a time; at 'high' the two heads run in a
//     loop; so no instantiation spills (256 threads a block: at f = 37
//     80 registers at 'fast', three blocks an SM, 127 at 'high', two).
//
// The three products in each precision mode (the TPU kernel's `_mxdot`),
// accumulated in fp32:
//   * 'highest': fp32 operands;
//   * 'fast': both operands rounded to bf16 (ties to even). The weights
//     come rounded in their layout; x is rounded for the W0 product only
//     (the affine update stays fp32), h0 and h1 as they are made, as the
//     TPU kernel stores them in bf16; one mma a step;
//   * 'high': hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b), hi the bf16
//     rounding and lo the rounded residual, three mma a step into one
//     accumulator. The layout holds the weights' hi pairs and then their
//     lo pairs, split once on the host; x, h0 and h1 are split as they are
//     made.
// The biases, the FiLM affine, the softsign, exp and sqrt and the affine
// update stay fp32 in every mode.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockPoints = 512;  // points a block
constexpr int kNarrowPoints = 4;   // points a thread at FP <= kNarrowFP
constexpr int kWidePoints = 2;     // points a thread above it
constexpr int kNarrowFP = 40;
constexpr float kEps = 1e-6f;
// 'high' and 'fast': a thread a point, kTcPoints a block (two or three
// blocks an SM: 8 warps each); a W1 B fragment serves both 16-row halves
// of a warp up to kBothHalvesFP, above it a half at a time, so that no
// instantiation spills (chosen on the card, PERF.md §6)
constexpr int kTcPoints = 256;
constexpr int kBothHalvesFP = 40;

// 'highest'
__host__ __device__ constexpr int points_a_thread(int FP) {
  return FP <= kNarrowFP ? kNarrowPoints : kWidePoints;
}
__host__ __device__ constexpr int threads_a_block(int FP) {
  return kBlockPoints / points_a_thread(FP);
}
__host__ __device__ constexpr int block_points(int FP) {
  return threads_a_block(FP) * points_a_thread(FP);
}
// every mode's __launch_bounds__
__host__ __device__ constexpr int kernel_threads(int FP, int MODE) {
  return MODE == kHighest ? threads_a_block(FP) : kTcPoints;
}

// 'highest': one coupling's weights in the kernel layout, floats a
// (component, coupling): W1 [2][FP][FP]; {w0x, w0y, w0z, b0} [2][FP];
// {w2x, w2y, w2z, 0} [2][FP]; {b2x, b2y, b2z, 0} [2]. Then one cloud's
// FiLM rows, {alpha, beta} [2][FP]. Each is a multiple of 4 floats.
template <int FP>
struct Layout {
  static constexpr int kW1 = 0;
  static constexpr int kW0 = kW1 + 2 * FP * FP;
  static constexpr int kW2 = kW0 + 8 * FP;
  static constexpr int kB2 = kW2 + 8 * FP;
  static constexpr int kWeights = kB2 + 8;
  static constexpr int kFilm = 4 * FP;
  static constexpr int kBuffer = kWeights + kFilm;
};

// 'high' and 'fast': one coupling's weights in 32-bit words a (component,
// coupling), the products' operands as bf16 pairs (mma_bf16.cuh: depths
// 2 i and 2 i + 1 of a row in word i, the lower depth in the lower half),
// each plane at 'high' followed by its lo plane:
//   W1 [2][FP][WS]: head h's row o (an output feature), its FP depths;
//   W0 [2][FP][2]: row o's (w0x, w0y) and (w0z, 0);
//   W2 [2][4][WS]: W2's rows 0-2 and a row of zeros, FP depths each;
// then fp32: b0 [2][FP], b2 [2][4] (b2x, b2y, b2z, 0). WS = w1_pair_stride:
// FP / 2 padded to 4 mod 8, so that a B fragment's words fall in distinct
// banks. Then one cloud's FiLM rows as at 'highest'. Every part is a
// multiple of 4 words (ops/kernels/point_decode.py:kernel_weights).
template <int FP, int MODE>
struct TcLayout {
  static constexpr int WS = w1_pair_stride<FP>();
  static constexpr int kPlanes = MODE == kHigh ? 2 : 1;
  static constexpr int kW1Lo = 2 * FP * WS;  // a plane's words
  static constexpr int kW0Lo = 4 * FP;
  static constexpr int kW2Lo = 8 * WS;
  static constexpr int kW1 = 0;
  static constexpr int kW0 = kW1 + kPlanes * kW1Lo;
  static constexpr int kW2 = kW0 + kPlanes * kW0Lo;
  static constexpr int kB0 = kW2 + kPlanes * kW2Lo;
  static constexpr int kB2 = kB0 + 2 * FP;
  static constexpr int kWeights = kB2 + 8;
  static constexpr int kFilm = 4 * FP;
  static constexpr int kBuffer = kWeights + kFilm;
};

// Issue this thread's 16-byte copies of one coupling's weights (kWeights
// floats) and FiLM rows (kFilm) into a shared buffer, as one pipeline
// stage, T threads a block.
template <int kWeights, int kFilm, int T>
__device__ __forceinline__ void prefetch(float* buf, const float* w,
                                         const float* film) {
  constexpr int kW4 = kWeights / 4;
  constexpr int kAll4 = (kWeights + kFilm) / 4;
  for (int i = threadIdx.x; i < kAll4; i += T) {
    const float* src = i < kW4 ? w + 4 * i : film + 4 * (i - kW4);
    __pipeline_memcpy_async(buf + 4 * i, src, 16);
  }
  __pipeline_commit();
}

template <int FP, bool INVERSE>
__device__ __forceinline__ void decode_highest(
    const float* __restrict__ p, const float* __restrict__ w,
    const float* __restrict__ film, float* __restrict__ out,
    float* __restrict__ lv_out, int B, int C, int N, int f) {
  using L = Layout<FP>;
  constexpr int kPoints = points_a_thread(FP);
  constexpr int kThreads = threads_a_block(FP);
  extern __shared__ float4 smem[];
  float* buffers = reinterpret_cast<float*>(smem);
  const int k = blockIdx.z, b = blockIdx.y;
  const int n0 = blockIdx.x * block_points(FP) + threadIdx.x;
  const long long cloud = ((long long)k * B + b) * 3 * N;
  const float* wk = w + (long long)k * C * L::kWeights;
  const float* fkb = film + ((long long)k * B + b) * C * L::kFilm;

  float x[kPoints][3], lv[kPoints][3];
#pragma unroll
  for (int u = 0; u < kPoints; ++u) {
    const int n = n0 + u * kThreads;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x[u][j] = n < N ? p[cloud + (long long)j * N + n] : 0.f;
      lv[u][j] = 0.f;
    }
  }

  const int first = INVERSE ? C - 1 : 0;
  prefetch<L::kWeights, L::kFilm, kThreads>(
      buffers, wk + (long long)first * L::kWeights,
      fkb + (long long)first * L::kFilm);
  for (int i = 0; i < C; ++i) {
    // this coupling's copies have landed, and every thread is done with
    // the previous coupling, whose buffer the next prefetch reuses
    __pipeline_wait_prior(0);
    __syncthreads();
    if (i + 1 < C) {
      const int next = INVERSE ? C - 2 - i : i + 1;
      prefetch<L::kWeights, L::kFilm, kThreads>(
          buffers + ((i + 1) & 1) * L::kBuffer,
          wk + (long long)next * L::kWeights,
          fkb + (long long)next * L::kFilm);
    }
    const float* s = buffers + (i & 1) * L::kBuffer;
    const float4* w0s = reinterpret_cast<const float4*>(s + L::kW0);
    const float4* w2s = reinterpret_cast<const float4*>(s + L::kW2);
    const float4* b2s = reinterpret_cast<const float4*>(s + L::kB2);
    const float2* film_s = reinterpret_cast<const float2*>(s + L::kWeights);

    float y[2][kPoints][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float h0[kPoints][FP];
#pragma unroll
      for (int o = 0; o < FP; ++o) {
        const float4 r = w0s[h * FP + o];
#pragma unroll
        for (int u = 0; u < kPoints; ++u)
          h0[u][o] = fmaxf(
              r.x * x[u][0] + r.y * x[u][1] + r.z * x[u][2] + r.w, 0.f);
      }
      float acc[kPoints][3] = {};
      for (int o = 0; o < f; ++o) {
        const float4* row =
            reinterpret_cast<const float4*>(s + L::kW1 + (h * FP + o) * FP);
        float dot[kPoints] = {};
#pragma unroll
        for (int q = 0; q < FP / 4; ++q) {
          const float4 wq = row[q];
#pragma unroll
          for (int u = 0; u < kPoints; ++u) {
            dot[u] = fmaf(wq.x, h0[u][4 * q + 0], dot[u]);
            dot[u] = fmaf(wq.y, h0[u][4 * q + 1], dot[u]);
            dot[u] = fmaf(wq.z, h0[u][4 * q + 2], dot[u]);
            dot[u] = fmaf(wq.w, h0[u][4 * q + 3], dot[u]);
          }
        }
        const float2 ab = film_s[h * FP + o];
        const float4 w2 = w2s[h * FP + o];
#pragma unroll
        for (int u = 0; u < kPoints; ++u) {
          const float v = fmaxf(ab.x * dot[u] + ab.y, 0.f);
          acc[u][0] = fmaf(w2.x, v, acc[u][0]);
          acc[u][1] = fmaf(w2.y, v, acc[u][1]);
          acc[u][2] = fmaf(w2.z, v, acc[u][2]);
        }
      }
      const float4 b2 = b2s[h];
#pragma unroll
      for (int u = 0; u < kPoints; ++u) {
        y[h][u][0] = acc[u][0] + b2.x;
        y[h][u][1] = acc[u][1] + b2.y;
        y[h][u][2] = acc[u][2] + b2.z;
      }
    }
    // kept channels have y = 0: logvar 0, scale sqrt(1 + eps), as the
    // reference's full-width coupling
#pragma unroll
    for (int u = 0; u < kPoints; ++u) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float logvar = y[0][u][j] / (1.f + fabsf(y[0][u][j]));
        const float scale = sqrtf(kEps + expf(logvar));
        x[u][j] = INVERSE ? (x[u][j] - y[1][u][j]) / scale
                          : scale * x[u][j] + y[1][u][j];
        lv[u][j] += logvar;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPoints; ++u) {
    const int n = n0 + u * kThreads;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        out[cloud + (long long)j * N + n] = x[u][j];
        lv_out[cloud + (long long)j * N + n] = lv[u][j];
      }
    }
  }
}

// The row of its warp's 32 that lane 4 g + t carries: row g + 8 (t % 2) +
// 16 (t / 2), the one of its group's four rows (g, g + 8, g + 16, g + 24)
// whose y it keeps after the W2 product
__device__ __forceinline__ int tc_row(int lane) {
  return (lane >> 2) + 8 * (lane & 1) + 16 * ((lane >> 1) & 1);
}

// v0 and v1 as a fragment register of MODE's products: rounded to a bf16
// pair, at 'high' the hi pair in h and the pair of the rounded residuals
// v - hi in l (v0 in the lower halves)
template <int MODE>
__device__ __forceinline__ void frag_pair(float v0, float v1, unsigned& h,
                                          unsigned& l) {
  h = bf16x2_round(v0, v1);
  if constexpr (MODE == kHigh)
    l = bf16x2_round(v0 - __uint_as_float(h << 16),
                     v1 - __uint_as_float(h & 0xffff0000u));
  else
    l = 0u;
}

// a k-step of a product: m16n8k8 where its depths 8-15 are padding
// (half, known when the k-step loop unrolls), else m16n8k16
template <bool HIGH>
__device__ __forceinline__ void step_mma(float c[4], const FragA& a,
                                         const FragB& b, bool half) {
  if (half)
    frag_mma<HIGH, true>(c, a, b);
  else
    frag_mma<HIGH>(c, a, b);
}

// Head h of one coupling for MB of the calling warp's 16-row halves at
// 'high' and 'fast' (the header's design), from the coupling's stage s:
// ax the halves' W0 A fragments; yp and yq the halves' W2 accumulators
// (tile P's columns are W2's rows 0, 1, 0, 1, ..., tile Q's rows 2, 3
// (zeros), 2, 3, ...). Every lane of the warp calls it.
template <int FP, int MODE, int MB>
__device__ __forceinline__ void halves_tc(const float* s, const FragA* ax,
                                          int h, float (&yp)[MB][4],
                                          float (&yq)[MB][4]) {
  using L = TcLayout<FP, MODE>;
  constexpr bool HIGH = MODE == kHigh;
  constexpr int NT = FP / 8, KS = (FP + 15) / 16, WS = L::WS;
  constexpr bool KH = FP % 16 != 0;  // the last k-step's depths 8-15 pad
  const unsigned* su = reinterpret_cast<const unsigned*>(s);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c1[MB][NT][4] = {};
  // h0 a k-step at a time, and W1 h0 on it
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    FragA a[MB] = {};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int nt = 2 * ks + q;
      if (nt >= NT) continue;  // KH: the step's upper depths stay zeros
      // W0's B fragment: column g of the tile (row 8 nt + g of W0),
      // depths 2 t and 2 t + 1, which only lanes t = 0, 1 hold
      const int wi = (h * FP + 8 * nt + g) * 2 + t;
      FragB b0;
      b0.h[0] = t < 2 ? su[L::kW0 + wi] : 0u;
      b0.l[0] = HIGH && t < 2 ? su[L::kW0 + L::kW0Lo + wi] : 0u;
      b0.h[1] = b0.l[1] = 0u;
      const float2 bias = *reinterpret_cast<const float2*>(
          s + L::kB0 + h * FP + 8 * nt + 2 * t);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f};
        frag_mma<HIGH, true>(c0, ax[mb], b0);
        frag_pair<MODE>(fmaxf(c0[0] + bias.x, 0.f),
                        fmaxf(c0[1] + bias.y, 0.f), a[mb].h[2 * q],
                        a[mb].l[2 * q]);
        frag_pair<MODE>(fmaxf(c0[2] + bias.x, 0.f),
                        fmaxf(c0[3] + bias.y, 0.f), a[mb].h[2 * q + 1],
                        a[mb].l[2 * q + 1]);
      }
    }
    const bool half = KH && ks == KS - 1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int wi = (h * FP + 8 * nt + g) * WS + 8 * ks + t;
      FragB b1;
      b1.h[0] = su[L::kW1 + wi];
      b1.h[1] = half ? 0u : su[L::kW1 + wi + 4];
      b1.l[0] = HIGH ? su[L::kW1 + L::kW1Lo + wi] : 0u;
      b1.l[1] = HIGH && !half ? su[L::kW1 + L::kW1Lo + wi + 4] : 0u;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        step_mma<HIGH>(c1[mb][nt], a[mb], b1, half);
    }
  }
  // the tail: h1 = ReLU(alpha h + beta) a k-step at a time, and W2 h1
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    FragA a[MB] = {};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int nt = 2 * ks + q;
      if (nt >= NT) continue;
      // {alpha, beta} of columns 8 nt + 2 t and 8 nt + 2 t + 1
      const float4 ab = *reinterpret_cast<const float4*>(
          s + L::kWeights + 2 * (h * FP + 8 * nt + 2 * t));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const float* c = c1[mb][nt];
        frag_pair<MODE>(fmaxf(ab.x * c[0] + ab.y, 0.f),
                        fmaxf(ab.z * c[1] + ab.w, 0.f), a[mb].h[2 * q],
                        a[mb].l[2 * q]);
        frag_pair<MODE>(fmaxf(ab.x * c[2] + ab.y, 0.f),
                        fmaxf(ab.z * c[3] + ab.w, 0.f), a[mb].h[2 * q + 1],
                        a[mb].l[2 * q + 1]);
      }
    }
    const bool half = KH && ks == KS - 1;
    FragB bp, bq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      FragB& b = e ? bq : bp;
      const int row = e ? 2 + (g & 1) : g & 1;
      const int wi = (h * 4 + row) * WS + 8 * ks + t;
      b.h[0] = su[L::kW2 + wi];
      b.h[1] = half ? 0u : su[L::kW2 + wi + 4];
      b.l[0] = HIGH ? su[L::kW2 + L::kW2Lo + wi] : 0u;
      b.l[1] = HIGH && !half ? su[L::kW2 + L::kW2Lo + wi + 4] : 0u;
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      step_mma<HIGH>(yp[mb], a[mb], bp, half);
      step_mma<HIGH>(yq[mb], a[mb], bq, half);
    }
  }
}

// Head h of one coupling for the calling warp's 32 points: y, the lane's
// own row's (tc_row: half t / 2, row 8 (t % 2) of that half), b2 added.
// Both halves at once, or a half at a time in a loop (kBothHalvesFP).
template <int FP, int MODE>
__device__ __forceinline__ void head_tc(const float* s, const FragA (&ax)[2],
                                        int h, float y[3]) {
  const int t = threadIdx.x & 3, r = t & 1;
  if constexpr (FP <= kBothHalvesFP) {
    float yp[2][4] = {}, yq[2][4] = {};
    halves_tc<FP, MODE, 2>(s, ax, h, yp, yq);
    const int m = t >> 1;
    y[0] = m ? (r ? yp[1][2] : yp[1][0]) : (r ? yp[0][2] : yp[0][0]);
    y[1] = m ? (r ? yp[1][3] : yp[1][1]) : (r ? yp[0][3] : yp[0][1]);
    y[2] = m ? (r ? yq[1][2] : yq[1][0]) : (r ? yq[0][2] : yq[0][0]);
  } else {
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      const FragA axm = m ? ax[1] : ax[0];
      float yp[1][4] = {}, yq[1][4] = {};
      halves_tc<FP, MODE, 1>(s, &axm, h, yp, yq);
      if (t >> 1 == m) {
        y[0] = r ? yp[0][2] : yp[0][0];
        y[1] = r ? yp[0][3] : yp[0][1];
        y[2] = r ? yq[0][2] : yq[0][0];
      }
    }
  }
  const float* b2 = s + TcLayout<FP, MODE>::kB2 + 4 * h;
#pragma unroll
  for (int j = 0; j < 3; ++j) y[j] += b2[j];
}

template <int FP, bool INVERSE, int MODE>
__device__ __forceinline__ void decode_tc(const float* __restrict__ p,
                                          const float* __restrict__ w,
                                          const float* __restrict__ film,
                                          float* __restrict__ out,
                                          float* __restrict__ lv_out, int B,
                                          int C, int N) {
  using L = TcLayout<FP, MODE>;
  extern __shared__ float4 smem[];
  float* buffers = reinterpret_cast<float*>(smem);
  const int k = blockIdx.z, b = blockIdx.y;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int n = blockIdx.x * kTcPoints + (threadIdx.x & ~31) +
                tc_row(lane);
  const bool live = n < N;
  const long long cloud = ((long long)k * B + b) * 3 * N;
  const float* wk = w + (long long)k * C * L::kWeights;
  const float* fkb = film + ((long long)k * B + b) * C * L::kFilm;

  // a dead point (n >= N) carries zeros through the chain and writes
  // nothing; the rows of a product never mix
  float x[3], lv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    x[j] = live ? p[cloud + (long long)j * N + n] : 0.f;
    lv[j] = 0.f;
  }

  const int first = INVERSE ? C - 1 : 0;
  prefetch<L::kWeights, L::kFilm, kTcPoints>(
      buffers, wk + (long long)first * L::kWeights,
      fkb + (long long)first * L::kFilm);
  for (int i = 0; i < C; ++i) {
    __pipeline_wait_prior(0);
    __syncthreads();
    if (i + 1 < C) {
      const int next = INVERSE ? C - 2 - i : i + 1;
      prefetch<L::kWeights, L::kFilm, kTcPoints>(
          buffers + ((i + 1) & 1) * L::kBuffer,
          wk + (long long)next * L::kWeights,
          fkb + (long long)next * L::kFilm);
    }
    const float* s = buffers + (i & 1) * L::kBuffer;

    // x of the group's rows (row g + 8 r + 16 m is lane 4 g + 2 m + r's)
    // as the W0 product's A fragments: depths 0 and 1 (x, y) in lane t =
    // 0, depth 2 (z) in lane 1, zeros in lanes 2 and 3 and at depths 8-15
    FragA ax[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          v[j] = __shfl_sync(0xffffffffu, x[j], (lane & ~3) | (2 * m + r));
        unsigned hi, lo;
        frag_pair<MODE>(t == 0 ? v[0] : v[2], t == 0 ? v[1] : 0.f, hi, lo);
        ax[m].h[r] = t < 2 ? hi : 0u;
        ax[m].l[r] = t < 2 ? lo : 0u;
        ax[m].h[r + 2] = ax[m].l[r + 2] = 0u;
      }
    }
    // y of the logvar head, then of the mu head: at 'high' in a loop, one
    // copy of a head's code (unrolled, it spilled at FP 32 and 40)
    float ylv[3] = {0.f, 0.f, 0.f}, ymu[3] = {0.f, 0.f, 0.f};
    if constexpr (MODE == kHigh) {
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        float y[3];
        head_tc<FP, MODE>(s, ax, h, y);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          ylv[j] = h ? ylv[j] : y[j];
          ymu[j] = h ? y[j] : ymu[j];
        }
      }
    } else {
      head_tc<FP, MODE>(s, ax, 0, ylv);
      head_tc<FP, MODE>(s, ax, 1, ymu);
    }
    // kept channels have y = 0: logvar 0, scale sqrt(1 + eps), as the
    // reference's full-width coupling
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float logvar = ylv[j] / (1.f + fabsf(ylv[j]));
      const float scale = sqrtf(kEps + expf(logvar));
      x[j] = INVERSE ? (x[j] - ymu[j]) / scale : scale * x[j] + ymu[j];
      lv[j] += logvar;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[cloud + (long long)j * N + n] = x[j];
      lv_out[cloud + (long long)j * N + n] = lv[j];
    }
  }
}

template <int FP, bool INVERSE, int MODE>
__global__ void __launch_bounds__(kernel_threads(FP, MODE))
point_decode_kernel(const float* __restrict__ p, const float* __restrict__ w,
                    const float* __restrict__ film, float* __restrict__ out,
                    float* __restrict__ lv_out, int B, int C, int N, int f) {
  if constexpr (MODE != kHighest)
    decode_tc<FP, INVERSE, MODE>(p, w, film, out, lv_out, B, C, N);
  else
    decode_highest<FP, INVERSE>(p, w, film, out, lv_out, B, C, N, f);
}

template <int FP, bool INVERSE, int MODE>
cudaError_t launch_dir(int K, cudaStream_t stream, const float* p,
                       const float* w, const float* film, float* out,
                       float* lv, int B, int C, int N, int f) {
  constexpr int buffer = MODE == kHighest ? Layout<FP>::kBuffer
                                          : TcLayout<FP, MODE>::kBuffer;
  constexpr int smem = 2 * buffer * sizeof(float);
  constexpr int points = MODE == kHighest ? block_points(FP) : kTcPoints;
  constexpr int threads = kernel_threads(FP, MODE);
  const cudaError_t err = cudaFuncSetAttribute(
      point_decode_kernel<FP, INVERSE, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + points - 1) / points, B, K);
  point_decode_kernel<FP, INVERSE, MODE><<<grid, threads, smem, stream>>>(
      p, w, film, out, lv, B, C, N, f);
  return cudaGetLastError();
}

template <int FP, int MODE>
cudaError_t launch_mode(bool inverse, int K, cudaStream_t stream,
                        const float* p, const float* w, const float* film,
                        float* out, float* lv, int B, int C, int N, int f) {
  return inverse ? launch_dir<FP, true, MODE>(K, stream, p, w, film, out, lv,
                                              B, C, N, f)
                 : launch_dir<FP, false, MODE>(K, stream, p, w, film, out,
                                               lv, B, C, N, f);
}

template <int FP>
cudaError_t launch(int mode, bool inverse, int K, cudaStream_t stream,
                   const float* p, const float* w, const float* film,
                   float* out, float* lv, int B, int C, int N, int f) {
  switch (mode) {
    case kHighest:
      return launch_mode<FP, kHighest>(inverse, K, stream, p, w, film, out,
                                       lv, B, C, N, f);
    case kHigh:
      return launch_mode<FP, kHigh>(inverse, K, stream, p, w, film, out, lv,
                                    B, C, N, f);
    case kFast:
      return launch_mode<FP, kFast>(inverse, K, stream, p, w, film, out, lv,
                                    B, C, N, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// p (K, B, 3, N); w (K, C, weight words) and film (K, B, C, 4 FP) in the
// kernel layout of the mode above, FP = f rounded up to a multiple of 8;
// mode 0 'highest', 1 'high' (w's pairs with their lo planes), 2 'fast'.
extern "C" int gwtf_point_decode(const float* p, const float* w,
                                 const float* film, float* out, float* lv,
                                 int K, int B, int C, int N, int f,
                                 int inverse, int mode, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool inv = inverse != 0;
  cudaError_t err;
  switch ((f + 7) / 8 * 8) {
    case 8: err = launch<8>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 16: err = launch<16>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 24: err = launch<24>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 32: err = launch<32>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 40: err = launch<40>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 48: err = launch<48>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 56: err = launch<56>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    case 64: err = launch<64>(mode, inv, K, stream, p, w, film, out, lv, B, C, N, f); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
