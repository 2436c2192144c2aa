// Eval-mode decode of the K-component point coupling chain, fp32.
//
// Replaces: go_with_the_flows_tpu/ops/pallas/coupling_kernel.py
// `_decode_kernel` (the pallas_call in `_fused_point_decode_impl`, public
// `fused_point_decode`). Host-side packing and the math are described in
// go_with_the_flows_tpu_torch/ops/kernels/point_decode.py.
//
// What bounds it on an H100: FP32 compute. A point costs about 3.2k
// multiply-adds per coupling, almost all in the two f x f W1 products
// (f = 37 at the flagship), while it reads 12 B and writes 24 B for the
// whole chain of C = 33 couplings.
//
// What the design does about it:
//   * one thread per point; one block per (component k, cloud b, tile of
//     kThreads points). x[3] and the logvar sum live in registers across
//     all C couplings, so device memory sees the points once;
//   * per coupling the block stages that coupling's folded weights and
//     the cloud's FiLM alpha/beta rows in shared memory (about 13 KB at
//     f = 37), so each weight is read from L2 once per block, and every
//     warp reads them as broadcasts;
//   * the two heads run separately (no block-diagonal 2f x 2f W1 as on
//     the TPU, whose zeros would cost FMAs here);
//   * only h0 (f floats) lives per thread: h1 is made one row at a time
//     and folded straight into the 3-wide y. f is padded to FP, a
//     multiple of 8, in shared memory (zeros), so the inner loop unrolls
//     at compile time and h0 stays in registers; the row loop runs to
//     the real f.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-6f;

template <int FP>
struct __align__(16) CouplingSmem {
  float w1[2][FP][FP];  // first: rows stay 16-byte aligned for float4 reads
  float w0[2][FP][3];
  float b0[2][FP];
  float w2[2][3][FP];
  float alpha[2][FP];
  float beta[2][FP];
  float b2[2][3];
};

template <int FP>
__device__ void stage_coupling(CouplingSmem<FP>& s, const float* __restrict__ w0,
                               const float* __restrict__ b0,
                               const float* __restrict__ w1,
                               const float* __restrict__ w2,
                               const float* __restrict__ b2,
                               const float* __restrict__ ab, int f,
                               long long kc, long long kbc) {
  const int tid = threadIdx.x;
  const float* gw0 = w0 + kc * 2 * f * 3;
  const float* gb0 = b0 + kc * 2 * f;
  const float* gw1 = w1 + kc * 2 * f * f;
  const float* gw2 = w2 + kc * 2 * 3 * f;
  const float* gb2 = b2 + kc * 2 * 3;
  const float* gab = ab + kbc * 2 * 2 * f;
  for (int i = tid; i < 2 * FP * FP; i += kThreads) {
    const int h = i / (FP * FP), o = (i / FP) % FP, j = i % FP;
    (&s.w1[0][0][0])[i] = (o < f && j < f) ? gw1[(h * f + o) * f + j] : 0.f;
  }
  for (int i = tid; i < 2 * FP * 3; i += kThreads) {
    const int h = i / (FP * 3), o = (i / 3) % FP, j = i % 3;
    (&s.w0[0][0][0])[i] = o < f ? gw0[(h * f + o) * 3 + j] : 0.f;
  }
  for (int i = tid; i < 2 * 3 * FP; i += kThreads) {
    const int h = i / (3 * FP), j = (i / FP) % 3, o = i % FP;
    (&s.w2[0][0][0])[i] = o < f ? gw2[(h * 3 + j) * f + o] : 0.f;
  }
  for (int i = tid; i < 2 * FP; i += kThreads) {
    const int h = i / FP, o = i % FP;
    const bool live = o < f;
    (&s.b0[0][0])[i] = live ? gb0[h * f + o] : 0.f;
    (&s.alpha[0][0])[i] = live ? gab[h * f + o] : 0.f;
    (&s.beta[0][0])[i] = live ? gab[2 * f + h * f + o] : 0.f;
  }
  if (tid < 6) (&s.b2[0][0])[tid] = gb2[tid];
}

template <int FP, bool INVERSE>
__global__ void __launch_bounds__(kThreads)
point_decode_kernel(const float* __restrict__ p, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ ab, float* __restrict__ out,
                    float* __restrict__ lv_out, int B, int C, int N, int f) {
  __shared__ CouplingSmem<FP> s;
  const int k = blockIdx.z, b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const long long cloud = ((long long)k * B + b) * 3 * N;

  float x[3] = {0.f, 0.f, 0.f};
  float lv[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) x[j] = p[cloud + (long long)j * N + n];
  }

  for (int i = 0; i < C; ++i) {
    const int c = INVERSE ? C - 1 - i : i;
    __syncthreads();  // every thread is done with the previous coupling
    stage_coupling<FP>(s, w0, b0, w1, w2, b2, ab, f, (long long)k * C + c,
                       ((long long)k * B + b) * C + c);
    __syncthreads();
    if (!live) continue;

    float y[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float h0[FP];
#pragma unroll
      for (int o = 0; o < FP; ++o) {
        const float t = s.w0[h][o][0] * x[0] + s.w0[h][o][1] * x[1] +
                        s.w0[h][o][2] * x[2] + s.b0[h][o];
        h0[o] = fmaxf(t, 0.f);
      }
      float y0 = 0.f, y1 = 0.f, y2 = 0.f;
      for (int o = 0; o < f; ++o) {
        const float4* row = reinterpret_cast<const float4*>(s.w1[h][o]);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < FP / 4; ++q) {
          const float4 w = row[q];
          acc = fmaf(w.x, h0[4 * q + 0], acc);
          acc = fmaf(w.y, h0[4 * q + 1], acc);
          acc = fmaf(w.z, h0[4 * q + 2], acc);
          acc = fmaf(w.w, h0[4 * q + 3], acc);
        }
        const float v = fmaxf(s.alpha[h][o] * acc + s.beta[h][o], 0.f);
        y0 = fmaf(s.w2[h][0][o], v, y0);
        y1 = fmaf(s.w2[h][1][o], v, y1);
        y2 = fmaf(s.w2[h][2][o], v, y2);
      }
      y[h][0] = y0 + s.b2[h][0];
      y[h][1] = y1 + s.b2[h][1];
      y[h][2] = y2 + s.b2[h][2];
    }
    // kept channels have y = 0: logvar 0, scale sqrt(1 + eps), as the
    // reference's full-width coupling
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float logvar = y[0][j] / (1.f + fabsf(y[0][j]));  // softsign
      const float scale = sqrtf(kEps + expf(logvar));
      x[j] = INVERSE ? (x[j] - y[1][j]) / scale : scale * x[j] + y[1][j];
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

template <int FP>
void launch(bool inverse, dim3 grid, cudaStream_t stream, const float* p,
            const float* w0, const float* b0, const float* w1, const float* w2,
            const float* b2, const float* ab, float* out, float* lv, int B,
            int C, int N, int f) {
  if (inverse)
    point_decode_kernel<FP, true><<<grid, kThreads, 0, stream>>>(
        p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f);
  else
    point_decode_kernel<FP, false><<<grid, kThreads, 0, stream>>>(
        p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f);
}

}  // namespace

extern "C" int gwtf_point_decode(const float* p, const float* w0,
                                 const float* b0, const float* w1,
                                 const float* w2, const float* b2,
                                 const float* ab, float* out, float* lv, int K,
                                 int B, int C, int N, int f, int inverse,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((N + kThreads - 1) / kThreads, B, K);
  const bool inv = inverse != 0;
  const int fp = (f + 7) / 8 * 8;
  switch (fp) {
    case 8: launch<8>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 16: launch<16>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 24: launch<24>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 32: launch<32>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 40: launch<40>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 48: launch<48>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 56: launch<56>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    case 64: launch<64>(inv, grid, stream, p, w0, b0, w1, w2, b2, ab, out, lv, B, C, N, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
