// Eval-mode decode of the K-component point coupling chain, in the three
// matmul precision modes of ops/precision.py (MODE below).
//
// Replaces: go_with_the_flows_tpu/ops/pallas/coupling_kernel.py
// `_decode_kernel` (the pallas_call in `_fused_point_decode_impl`, public
// `fused_point_decode`). Host-side packing and the math are described in
// go_with_the_flows_tpu_torch/ops/kernels/point_decode.py.
//
// What bounds it on an H100: FP32 compute. A point costs about 3.2k
// multiply-adds per coupling, almost all in the two f x f W1 products
// (f = 37 at the flagship), while it reads 12 B and writes 24 B for the
// whole chain of C = 33 couplings. What bounds this kernel is issue: the
// FMAs, and the shared-memory loads that feed them the weights.
//
// What the design does about it:
//   * each thread carries P points through all C couplings in registers
//     (x[3] and the logvar sum each), so device memory sees the points
//     once; one block per (component k, cloud b, tile of kBlockPoints
//     points);
//   * the register tile: every weight loaded from shared memory feeds P
//     points, so a 16-byte load of a W1 row feeds 4 P FMAs, and the
//     per-row records (w0 and b0 in one float4, w2 in one, the FiLM alpha
//     and beta in one float2) cost one load each for all of a thread's
//     points. P is 4 where h0 of 4 points fits the registers without a
//     spill (FP <= 40, the flagship's width), else 2 (half at 'high');
//   * the weights come in the kernel layout (`kernel_weights` in the
//     wrapper, made once with the packing): per component and coupling
//     one contiguous block, already padded to FP, so staging is plain
//     16-byte copies with no index arithmetic;
//   * staging runs ahead: while coupling c runs, coupling c+1's weights
//     and the cloud's FiLM rows are copied into the other of two shared
//     buffers with cp.async (the L2 latency hidden), and a coupling costs
//     one barrier;
//   * the two heads run separately (no block-diagonal 2f x 2f W1 as on
//     the TPU, whose zeros would cost FMAs here);
//   * only h0 (f floats a point) lives per thread: h1 is made one row at
//     a time and folded straight into the 3-wide y. f is padded to FP, a
//     multiple of 8, with zeros, so the inner loop unrolls at compile time
//     and h0 stays in registers; the row loop runs to the real f.
//
// The three products (W0 x, W1 h0, W2 h1) in each precision mode (the
// TPU kernel's `_mxdot`), accumulated in fp32 by FMAs:
//   * 'highest' (MODE 0): fp32 operands;
//   * 'fast' (MODE 2): both operands rounded to bf16 (ties to even). The
//     weights come rounded in their layout; x is rounded for the W0
//     product only (the affine update stays fp32), h0 and h1 as they are
//     made, as the TPU kernel stores them in bf16;
//   * 'high' (MODE 1): hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b), hi the
//     bf16 rounding and lo the rounded residual. The layout holds the
//     weights' hi parts and then their lo parts, split once on the host.
//     Per point, x, h0 and h1 are split as they are made, and the first
//     two terms are one FMA of hi(w) by hi(b) + lo(b), which is exact in
//     fp32: two FMAs a term instead of three. h0 takes two registers an
//     element (hi + lo and hi), so a thread carries half the points.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockPoints = 512;  // points a block
constexpr int kNarrowPoints = 4;   // points a thread at FP <= kNarrowFP
constexpr int kWidePoints = 2;     // points a thread above it
constexpr int kNarrowFP = 40;
constexpr float kEps = 1e-6f;
constexpr int kHighest = 0, kHigh = 1, kFast = 2;  // MODE

__host__ __device__ constexpr int points_a_thread(int FP, int MODE) {
  return MODE == kHigh && (FP <= kNarrowFP ? kNarrowPoints : kWidePoints) > 1
             ? (FP <= kNarrowFP ? kNarrowPoints : kWidePoints) / 2
             : (FP <= kNarrowFP ? kNarrowPoints : kWidePoints);
}
__host__ __device__ constexpr int threads_a_block(int FP) {
  return kBlockPoints / points_a_thread(FP, kHighest);
}
__host__ __device__ constexpr int block_points(int FP, int MODE) {
  return threads_a_block(FP) * points_a_thread(FP, MODE);
}

// One coupling's weights in the kernel layout, floats a (component,
// coupling): W1 [2][FP][FP]; {w0x, w0y, w0z, b0} [2][FP]; {w2x, w2y, w2z,
// 0} [2][FP]; {b2x, b2y, b2z, 0} [2]; at 'high' these kLo floats hold the
// hi parts (and the biases), and the lo parts follow in the same layout.
// Then one cloud's FiLM rows, {alpha, beta} [2][FP]. Each is a multiple of
// 4 floats.
template <int FP, int MODE>
struct Layout {
  static constexpr int kW1 = 0;
  static constexpr int kW0 = kW1 + 2 * FP * FP;
  static constexpr int kW2 = kW0 + 8 * FP;
  static constexpr int kB2 = kW2 + 8 * FP;
  static constexpr int kLo = kB2 + 8;
  static constexpr int kWeights = kLo * (MODE == kHigh ? 2 : 1);
  static constexpr int kFilm = 4 * FP;
  static constexpr int kBuffer = kWeights + kFilm;
};

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

// 'high': hi = bf16(v) and sum = hi + bf16(v - hi), exact in fp32
__device__ __forceinline__ void bf16_split(float v, float& sum, float& hi) {
  hi = bf16_round(v);
  sum = hi + bf16_round(v - hi);
}

// Issue this thread's 16-byte copies of one coupling's weights and FiLM
// rows into a shared buffer, as one pipeline stage.
template <int FP, int MODE>
__device__ __forceinline__ void prefetch(float* buf, const float* w,
                                         const float* film) {
  constexpr int kW4 = Layout<FP, MODE>::kWeights / 4;
  constexpr int kAll4 = Layout<FP, MODE>::kBuffer / 4;
  for (int i = threadIdx.x; i < kAll4; i += threads_a_block(FP)) {
    const float* src = i < kW4 ? w + 4 * i : film + 4 * (i - kW4);
    __pipeline_memcpy_async(buf + 4 * i, src, 16);
  }
  __pipeline_commit();
}

template <int FP, bool INVERSE, int MODE>
__global__ void __launch_bounds__(threads_a_block(FP))
point_decode_kernel(const float* __restrict__ p, const float* __restrict__ w,
                    const float* __restrict__ film, float* __restrict__ out,
                    float* __restrict__ lv_out, int B, int C, int N, int f) {
  using L = Layout<FP, MODE>;
  constexpr int kPoints = points_a_thread(FP, MODE);
  constexpr int kThreads = threads_a_block(FP);
  extern __shared__ float4 smem[];
  float* buffers = reinterpret_cast<float*>(smem);
  const int k = blockIdx.z, b = blockIdx.y;
  const int n0 = blockIdx.x * block_points(FP, MODE) + threadIdx.x;
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
  prefetch<FP, MODE>(buffers, wk + (long long)first * L::kWeights,
                     fkb + (long long)first * L::kFilm);
  for (int i = 0; i < C; ++i) {
    // this coupling's copies have landed, and every thread is done with
    // the previous coupling, whose buffer the next prefetch reuses
    __pipeline_wait_prior(0);
    __syncthreads();
    if (i + 1 < C) {
      const int next = INVERSE ? C - 2 - i : i + 1;
      prefetch<FP, MODE>(buffers + ((i + 1) & 1) * L::kBuffer,
                         wk + (long long)next * L::kWeights,
                         fkb + (long long)next * L::kFilm);
    }
    const float* s = buffers + (i & 1) * L::kBuffer;
    const float4* w0s = reinterpret_cast<const float4*>(s + L::kW0);
    const float4* w2s = reinterpret_cast<const float4*>(s + L::kW2);
    const float4* b2s = reinterpret_cast<const float4*>(s + L::kB2);
    const float2* film_s = reinterpret_cast<const float2*>(s + L::kWeights);
    // 'high': the weights' lo parts, kLo floats on
    const float4* w0l = reinterpret_cast<const float4*>(s + L::kLo + L::kW0);
    const float4* w2l = reinterpret_cast<const float4*>(s + L::kLo + L::kW2);

    // the W0 product's operand besides 'highest' (which reads x): bf16(x)
    // at 'fast'; at 'high' hi(x) + lo(x) in xs, hi(x) in xh
    float xs[kPoints][3], xh[kPoints][3];
    if constexpr (MODE != kHighest) {
#pragma unroll
      for (int u = 0; u < kPoints; ++u) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if constexpr (MODE == kFast)
            xs[u][j] = bf16_round(x[u][j]);
          else
            bf16_split(x[u][j], xs[u][j], xh[u][j]);
        }
      }
    }

    float y[2][kPoints][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // h0 at 'highest', bf16(h0) at 'fast', hi(h0) + lo(h0) at 'high'
      // (with hi(h0) in h0h)
      float h0[kPoints][FP];
      float h0h[kPoints][MODE == kHigh ? FP : 1];
#pragma unroll
      for (int o = 0; o < FP; ++o) {
        const float4 r = w0s[h * FP + o];
        if constexpr (MODE == kHighest) {
#pragma unroll
          for (int u = 0; u < kPoints; ++u)
            h0[u][o] = fmaxf(
                r.x * x[u][0] + r.y * x[u][1] + r.z * x[u][2] + r.w, 0.f);
        } else if constexpr (MODE == kFast) {
#pragma unroll
          for (int u = 0; u < kPoints; ++u)
            h0[u][o] = bf16_round(fmaxf(
                r.x * xs[u][0] + r.y * xs[u][1] + r.z * xs[u][2] + r.w,
                0.f));
        } else {
          const float4 rl = w0l[h * FP + o];
#pragma unroll
          for (int u = 0; u < kPoints; ++u)
            bf16_split(
                fmaxf(r.x * xs[u][0] + r.y * xs[u][1] + r.z * xs[u][2] +
                          rl.x * xh[u][0] + rl.y * xh[u][1] +
                          rl.z * xh[u][2] + r.w,
                      0.f),
                h0[u][o], h0h[u][o]);
        }
      }
      float acc[kPoints][3] = {};
      for (int o = 0; o < f; ++o) {
        const float4* row =
            reinterpret_cast<const float4*>(s + L::kW1 + (h * FP + o) * FP);
        const float4* row_lo = reinterpret_cast<const float4*>(
            s + L::kLo + L::kW1 + (h * FP + o) * FP);
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
          if constexpr (MODE == kHigh) {
            const float4 wl = row_lo[q];
#pragma unroll
            for (int u = 0; u < kPoints; ++u) {
              dot[u] = fmaf(wl.x, h0h[u][4 * q + 0], dot[u]);
              dot[u] = fmaf(wl.y, h0h[u][4 * q + 1], dot[u]);
              dot[u] = fmaf(wl.z, h0h[u][4 * q + 2], dot[u]);
              dot[u] = fmaf(wl.w, h0h[u][4 * q + 3], dot[u]);
            }
          }
        }
        const float2 ab = film_s[h * FP + o];
        const float4 w2 = w2s[h * FP + o];
        if constexpr (MODE == kHigh) {
          const float4 w2lo = w2l[h * FP + o];
#pragma unroll
          for (int u = 0; u < kPoints; ++u) {
            float vs, vh;
            bf16_split(fmaxf(ab.x * dot[u] + ab.y, 0.f), vs, vh);
            acc[u][0] = fmaf(w2lo.x, vh, fmaf(w2.x, vs, acc[u][0]));
            acc[u][1] = fmaf(w2lo.y, vh, fmaf(w2.y, vs, acc[u][1]));
            acc[u][2] = fmaf(w2lo.z, vh, fmaf(w2.z, vs, acc[u][2]));
          }
        } else {
#pragma unroll
          for (int u = 0; u < kPoints; ++u) {
            float v = fmaxf(ab.x * dot[u] + ab.y, 0.f);
            if constexpr (MODE == kFast) v = bf16_round(v);
            acc[u][0] = fmaf(w2.x, v, acc[u][0]);
            acc[u][1] = fmaf(w2.y, v, acc[u][1]);
            acc[u][2] = fmaf(w2.z, v, acc[u][2]);
          }
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

template <int FP, bool INVERSE, int MODE>
cudaError_t launch_dir(int K, cudaStream_t stream, const float* p,
                       const float* w, const float* film, float* out,
                       float* lv, int B, int C, int N, int f) {
  constexpr int smem = 2 * Layout<FP, MODE>::kBuffer * sizeof(float);
  constexpr int points = block_points(FP, MODE);
  const cudaError_t err = cudaFuncSetAttribute(
      point_decode_kernel<FP, INVERSE, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + points - 1) / points, B, K);
  point_decode_kernel<FP, INVERSE, MODE><<<grid, threads_a_block(FP), smem,
                                           stream>>>(p, w, film, out, lv, B,
                                                     C, N, f);
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

// p (K, B, 3, N); w (K, C, weight floats) and film (K, B, C, 4 FP) in the
// kernel layout above, FP = f rounded up to a multiple of 8; mode 0
// 'highest', 1 'high' (w holds the hi and the lo layouts), 2 'fast' (w
// rounded to bf16).
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
