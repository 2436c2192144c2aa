// Auction EMD (9-level soft assignment) in fp32: the paired cost with its
// optional residuals, its backward, and the cost over an (S, R) grid.
//
// Replaces (go_with_the_flows_tpu/ops/pallas/):
//   emd_kernel.py:275       `_emd_kernel` of `emd_cost_pallas`  -> emd_cost_kernel
//   emd_kernel.py:375       `_emd_bwd_kernel` (`_emd_backward`)  -> emd_backward_kernel
//   pairwise_kernel.py:187  `_emd_kernel` under the (S, R) grid of
//                           `pairwise_emd_pallas`                -> pairwise_emd_kernel
//
// For a pair a (N points), b (M points), D_ij = |a_i - b_j|^2 and
// E_ij = exp(level * D_ij), each of the 9 levels -4^7 .. -4^-1 runs
//   sweep 1 (rows):    ratioL_i = remainL_i / (1e-9 + sum_j E_ij remainR_j)
//   sweep 2 (columns): sumr_j = remainR_j * sum_i E_ij ratioL_i
//                      ratioR_j = min(remainR_j / (sumr_j + 1e-9), 1) remainR_j
//                      remainR_j = max(0, remainR_j - sumr_j)
//   sweep 3 (rows):    cost += ratioL_i * sum_j E_ij ratioR_j sqrt(max(D_ij, 1e-12))
//                      remainL_i = max(0, remainL_i - ratioL_i sum_j E_ij ratioR_j)
// and the backward, with the match rebuilt from the per-level ratios,
//   coeff_ij = sum_l E^l_ij ratioL_l,i ratioR_l,j * rsqrt(D_ij)  (0 if D_ij <= 1e-12)
//   da_i = sum_j coeff_ij (a_i - b_j),   db_j = sum_i coeff_ij (b_j - a_i).
//
// What bounds the forward on an H100: instruction issue and the
// special-function units (16 results a clock per SM against 128 FP32
// lanes). Every pass recomputes its distances: the TPU kernel caches D,
// sqrt D and E as (P, P) matrices in 110 MB of VMEM, but one 16 MB matrix
// per pair fits neither an SM's 227 KB nor, at 430 MB of traffic per pair,
// device memory. So the forward does 36 special-function operations per
// point pair (27 exps, 9 roots) and as few FP32 instructions around them
// as it can. The whole pair lives in shared memory. One block per pair,
// so a batch of 64 pairs fills only 64 of the 132 SMs: splitting a pair's
// columns over a thread-block cluster is left for later, as are tensor
// cores (the sums are matrix-vector products with an exp inside, which
// wgmma cannot take).
//
// What the forward's design does about it:
//   * 19 passes over the N x M point pairs, not 27: sweep 3 of level l and
//     sweep 1 of level l + 1 are one row pass. Both are row sums over the
//     same columns; sweep 1 of l + 1 reads remainR as sweep 2 of l left it
//     and row i's remainL, which sweep 3 finishes at the row's end. So one
//     loop over j forms each distance once and accumulates level l's two
//     sums and level l + 1's together, and the row's end updates remainL,
//     then writes level l + 1's ratioL. The sums are the same sums in the
//     same order as in three separate sweeps. The passes: sweep 1 of level
//     0, 9 column passes, 8 fused row passes, the last level's sweep 3.
//   * A lean element: the distance as 3 subtractions and fmaf(dx, dx,
//     fmaf(dy, dy, dz dz)); E = 2^(c_l D) on MUFU.EX2 alone, where
//     c_l = level_l log2(e) is rounded once (-4^7 times log2(e) rounded to
//     fp32 is exact, as is each later factor 0.25), so every level's
//     exponent has the same relative error; sqrt D as D rsqrt(D) on
//     MUFU.RSQ, D clamped at 1e-12 as before (expf costs about 7 FP32
//     instructions around its MUFU.EX2). The ftz forms need no subnormal
//     handling: a root's argument is never subnormal, and an E below
//     2^-126 becomes 0, which moves no sum that the 1e-9 guards see (at
//     most 1.2e-38 * 1e9 per term).
//   * A thread owns 4 rows (or columns) at once, so one broadcast
//     shared-memory load of the other cloud's point and one of its two
//     auction values feed 4 elements; the block has the fewest whole warps
//     that give every thread 4 items (512 threads at 2048 points), and
//     larger clouds loop over chunks of 4 x 1024. Ragged ends are masked,
//     never padded.
//   * Shared memory holds both clouds as float4 and each point's two
//     auction values as a float2 (remain, ratio): 24 (N + M) bytes, 96 KB
//     at N = M = 2048, 120 KB at 2500, asked for with cudaFuncSetAttribute
//     on every launch.
//   * Column-owning threads cannot form row sums without atomics, so the
//     column pass stays apart, behind a barrier on each side.
//   * Rounding is explicit (__fmul_rn / __fadd_rn / __fmaf_rn, IEEE
//     division, no fast math) and the cost is summed per thread in a fixed
//     order, then by a block tree: no atomics, so a pair's cost is the same
//     on every run, and the grid kernel, which runs the same device
//     function, equals the paired kernel bit for bit.
//   * The backward holds a's and b's points and ONE side's 9 levels of
//     residuals in shared memory (16 (N + M) + 36 max(N, M) bytes: 136 KB
//     at 2048, 166 KB at 2500), the other side's 9 in registers, so each
//     point pair costs one distance, one rsqrt and 9 expf per pass (a row
//     pass for da, a column pass for db). It keeps its own distance and
//     expf (`sq_dist`, `weight`).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLevels = 9;
constexpr float kFirstLevel = -16384.f;  // -4^7
// the forward's first level times log2(e): exact, 4^7 being a power of 2
constexpr float kFirstLevel2 = kFirstLevel * 1.44269504088896341f;
constexpr int kRows = 4;  // rows (or columns) a forward thread owns at once

// The fewest whole warps that give every thread `per_thread` items of the
// larger cloud, at most 1024 (larger clouds loop over chunks).
int block_threads(int N, int M, int per_thread) {
  const int n = N > M ? N : M;
  const int t = ((n + per_thread - 1) / per_thread + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// The backward's block: one to three items per thread, as the largest
// cloud needs.
int backward_threads(int N, int M) {
  const int n = N > M ? N : M;
  int r = (n + kMaxThreads - 1) / kMaxThreads;
  if (r > 3) r = 3;
  return block_threads(N, M, r);
}

__device__ __forceinline__ float sq_dist(float4 p, float4 q) {
  const float dx = __fsub_rn(p.x, q.x), dy = __fsub_rn(p.y, q.y),
              dz = __fsub_rn(p.z, q.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float weight(float level, float d) {
  return expf(__fmul_rn(level, d));
}

// The forward's distance: 3 subtractions, a product and 2 FMAs.
__device__ __forceinline__ float sq_dist_fma(float4 p, float4 q) {
  const float dx = __fsub_rn(p.x, q.x), dy = __fsub_rn(p.y, q.y),
              dz = __fsub_rn(p.z, q.z);
  return __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, __fmul_rn(dz, dz)));
}

// The forward's E = 2^(c d) for c = level log2(e): MUFU.EX2 alone, a
// result below 2^-126 flushed to 0. The argument carries two roundings
// (c's and the product's), exp(level d) with an exact level d none: up
// to 2^-23 |c d| apart, 1e-5 of E where E nears 2^-126, 2e-6 where
// level d is -16. Kernel 6 rebuilds the match with `weight`;
// emd_backward_f64 in ops/kernels/emd.py holds the two forms' gradients
// against each other.
__device__ __forceinline__ float weight2(float c, float d) {
  const float x = __fmul_rn(c, d);
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// sqrt(max(d, 1e-12)) as x rsqrt(x): MUFU.RSQ and a product.
__device__ __forceinline__ float clamped_sqrt(float d) {
  const float x = fmaxf(d, 1e-12f);
#ifdef __CUDA_ARCH__
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmul_rn(x, r);
#else
  return __fmul_rn(x, rsqrtf(x));
#endif
}

__device__ void load_cloud(const float* __restrict__ x, int n, float4* s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = make_float4(x[3LL * i], x[3LL * i + 1], x[3LL * i + 2], 0.f);
}

// A row pass. lv holds each row's (remainL, ratioL), rv each column's
// (remainR, ratioR). With kCost it is sweep 3 of the level with exponent
// factor c: that level's cost into `partial`, and remainL. With kNext it
// is sweep 1 of the level with factor cn, after sweep 3 if both: its
// ratioL, into lv and out_rl (when not null).
template <bool kCost, bool kNext>
__device__ float row_pass(const float4* pa, int N, const float4* pb, int M,
                          float2* lv, const float2* rv, float c, float cn,
                          float* out_rl, float partial) {
  const int T = blockDim.x;
  for (int base = 0; base < N; base += kRows * T) {
    if (base + (int)threadIdx.x >= N) break;
    float4 p[kRows];
    float rs[kRows], cs[kRows], s[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      p[u] = pa[min(base + u * T + (int)threadIdx.x, N - 1)];
      rs[u] = cs[u] = s[u] = 0.f;
    }
    for (int j = 0; j < M; ++j) {
      const float4 q = pb[j];
      const float2 r = rv[j];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float d = sq_dist_fma(p[u], q);
        if (kCost) {
          const float w = __fmul_rn(weight2(c, d), r.y);
          rs[u] = __fadd_rn(rs[u], w);
          cs[u] = __fmaf_rn(w, clamped_sqrt(d), cs[u]);
        }
        if (kNext) s[u] = __fmaf_rn(weight2(cn, d), r.x, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = base + u * T + threadIdx.x;
      if (i < N) {
        float2 v = lv[i];
        if (kCost) {
          partial = __fmaf_rn(v.y, cs[u], partial);
          v.x = fmaxf(0.f, __fsub_rn(v.x, __fmul_rn(v.y, rs[u])));
        }
        if (kNext) {
          v.y = v.x / __fadd_rn(1e-9f, s[u]);
          if (out_rl) out_rl[i] = v.y;
        }
        lv[i] = v;
      }
    }
  }
  return partial;
}

// Sweep 2, columns: ratioR and remainR of the level with factor c.
__device__ void column_pass(const float4* pa, int N, const float2* lv,
                            const float4* pb, int M, float2* rv, float c,
                            float* out_rr) {
  const int T = blockDim.x;
  for (int base = 0; base < M; base += kRows * T) {
    if (base + (int)threadIdx.x >= M) break;
    float4 q[kRows];
    float s[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      q[u] = pb[min(base + u * T + (int)threadIdx.x, M - 1)];
      s[u] = 0.f;
    }
    for (int i = 0; i < N; ++i) {
      const float4 p = pa[i];
      const float rl = lv[i].y;
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        s[u] = __fmaf_rn(weight2(c, sq_dist_fma(p, q[u])), rl, s[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = base + u * T + threadIdx.x;
      if (j < M) {
        float2 v = rv[j];
        const float sumr = __fmul_rn(v.x, s[u]);
        v.y = __fmul_rn(fminf(v.x / __fadd_rn(sumr, 1e-9f), 1.f), v.x);
        v.x = fmaxf(0.f, __fsub_rn(v.x, sumr));
        rv[j] = v;
        if (out_rr) out_rr[j] = v.y;
      }
    }
  }
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)blockDim.x / 32; ++w)
      total = __fadd_rn(total, scratch[w]);
  }
  return total;
}

// The cost of one pair (valid in thread 0). out_rl (9, N) and out_rr
// (9, M) receive the per-level ratios when they are not null.
__device__ float emd_pair(const float* __restrict__ a,
                          const float* __restrict__ b, int N, int M,
                          float multi_l, float multi_r, float* out_rl,
                          float* out_rr) {
  extern __shared__ float4 smem[];
  __shared__ float scratch[kMaxThreads / 32];
  float4* pa = smem;
  float4* pb = pa + N;
  float2* lv = reinterpret_cast<float2*>(pb + M);  // (remainL, ratioL)
  float2* rv = lv + N;                             // (remainR, ratioR)

  load_cloud(a, N, pa);
  load_cloud(b, M, pb);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    lv[i] = make_float2(multi_l, 0.f);
  for (int j = threadIdx.x; j < M; j += blockDim.x)
    rv[j] = make_float2(multi_r, 0.f);
  __syncthreads();

  float c = kFirstLevel2;
  float partial = row_pass<false, true>(pa, N, pb, M, lv, rv, c, c, out_rl,
                                        0.f);
  __syncthreads();
  for (int l = 0; l < kLevels; ++l) {
    column_pass(pa, N, lv, pb, M, rv, c,
                out_rr ? out_rr + (long long)l * M : nullptr);
    __syncthreads();
    const float cn = __fmul_rn(c, 0.25f);  // exact: a power of 4
    if (l + 1 < kLevels) {
      partial = row_pass<true, true>(
          pa, N, pb, M, lv, rv, c, cn,
          out_rl ? out_rl + (long long)(l + 1) * N : nullptr, partial);
      __syncthreads();
    } else {
      partial = row_pass<true, false>(pa, N, pb, M, lv, rv, c, cn, nullptr,
                                      partial);
    }
    c = cn;
  }
  return block_sum(partial, scratch);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
emd_cost_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ cost, float* __restrict__ rl,
                float* __restrict__ rr, int N, int M, float multi_l,
                float multi_r) {
  const long long pair = blockIdx.x;
  const float c = emd_pair(a + pair * N * 3, b + pair * M * 3, N, M, multi_l,
                           multi_r, rl ? rl + pair * kLevels * N : nullptr,
                           rr ? rr + pair * kLevels * M : nullptr);
  if (threadIdx.x == 0) cost[pair] = c;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
pairwise_emd_kernel(const float* __restrict__ samples,
                    const float* __restrict__ refs, float* __restrict__ cost,
                    int n_refs, int N, int M, float multi_l, float multi_r,
                    int pair0) {
  const long long pair = (long long)pair0 + blockIdx.x;
  const long long i = pair / n_refs, j = pair % n_refs;
  const float c = emd_pair(samples + i * N * 3, refs + j * M * 3, N, M,
                           multi_l, multi_r, nullptr, nullptr);
  if (threadIdx.x == 0) cost[pair] = c;
}

// sum_l E^l_ij ratioL_l,i ratioR_l,j, as ((e * ratioL) * ratioR) summed
// over l in order; `rl` and `rr` are the 9 values with their strides.
__device__ __forceinline__ float match_entry(float d, const float* rl,
                                             int rl_stride, const float* rr,
                                             int rr_stride) {
  float m = 0.f;
  float level = kFirstLevel;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    m = __fadd_rn(m, __fmul_rn(__fmul_rn(weight(level, d), rl[l * rl_stride]),
                               rr[l * rr_stride]));
    level = __fmul_rn(level, 0.25f);
  }
  return m;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
emd_backward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ rl,
                    const float* __restrict__ rr, float* __restrict__ da,
                    float* __restrict__ db, int N, int M) {
  extern __shared__ float4 smem[];
  float4* pa = smem;
  float4* pb = pa + N;
  float* res = reinterpret_cast<float*>(pb + M);  // 9 levels of one side
  const long long pair = blockIdx.x;
  a += pair * N * 3;
  b += pair * M * 3;
  rl += pair * kLevels * N;
  rr += pair * kLevels * M;
  da += pair * N * 3;
  db += pair * M * 3;
  const int T = blockDim.x;

  load_cloud(a, N, pa);
  load_cloud(b, M, pb);
  for (int k = threadIdx.x; k < kLevels * M; k += T) res[k] = rr[k];
  __syncthreads();

  // rows: ratioL of row i in registers, ratioR of every column shared
  for (int i = threadIdx.x; i < N; i += T) {
    const float4 p = pa[i];
    float w[kLevels];
#pragma unroll
    for (int l = 0; l < kLevels; ++l) w[l] = rl[(long long)l * N + i];
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int j = 0; j < M; ++j) {
      const float4 q = pb[j];
      const float d = sq_dist(p, q);
      if (d > 1e-12f) {
        const float c =
            __fmul_rn(match_entry(d, w, 1, res + j, M), rsqrtf(d));
        gx = __fmaf_rn(c, __fsub_rn(p.x, q.x), gx);
        gy = __fmaf_rn(c, __fsub_rn(p.y, q.y), gy);
        gz = __fmaf_rn(c, __fsub_rn(p.z, q.z), gz);
      }
    }
    da[3LL * i] = gx;
    da[3LL * i + 1] = gy;
    da[3LL * i + 2] = gz;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kLevels * N; k += T) res[k] = rl[k];
  __syncthreads();

  // columns: ratioR of column j in registers, ratioL of every row shared
  for (int j = threadIdx.x; j < M; j += T) {
    const float4 q = pb[j];
    float w[kLevels];
#pragma unroll
    for (int l = 0; l < kLevels; ++l) w[l] = rr[(long long)l * M + j];
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int i = 0; i < N; ++i) {
      const float4 p = pa[i];
      const float d = sq_dist(p, q);
      if (d > 1e-12f) {
        const float c =
            __fmul_rn(match_entry(d, res + i, N, w, 1), rsqrtf(d));
        gx = __fmaf_rn(c, __fsub_rn(q.x, p.x), gx);
        gy = __fmaf_rn(c, __fsub_rn(q.y, p.y), gy);
        gz = __fmaf_rn(c, __fsub_rn(q.z, p.z), gz);
      }
    }
    db[3LL * j] = gx;
    db[3LL * j + 1] = gy;
    db[3LL * j + 2] = gz;
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, unsigned int grid, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

size_t forward_smem(int N, int M) { return 24 * static_cast<size_t>(N + M); }

}  // namespace

// a (B, N, 3), b (B, M, 3) -> cost (B); ratio_l (B, 9, N) and ratio_r
// (B, 9, M) too when they are not null.
extern "C" int gwtf_emd_cost(const float* a, const float* b, float* cost,
                             float* ratio_l, float* ratio_r, int B, int N,
                             int M, float multi_l, float multi_r,
                             void* stream_ptr) {
  return launch(emd_cost_kernel, static_cast<unsigned int>(B),
                block_threads(N, M, kRows), forward_smem(N, M),
                static_cast<cudaStream_t>(stream_ptr), a, b, cost, ratio_l,
                ratio_r, N, M, multi_l, multi_r);
}

// samples (S, N, 3), refs (R, M, 3) -> cost (S, R), pairs
// [pair0, pair0 + pairs) of the row-major grid.
extern "C" int gwtf_pairwise_emd(const float* samples, const float* refs,
                                 float* cost, int n_refs, int N, int M,
                                 float multi_l, float multi_r, int pair0,
                                 int pairs, void* stream_ptr) {
  return launch(pairwise_emd_kernel, static_cast<unsigned int>(pairs),
                block_threads(N, M, kRows), forward_smem(N, M),
                static_cast<cudaStream_t>(stream_ptr), samples, refs, cost,
                n_refs, N, M, multi_l, multi_r, pair0);
}

// a (B, N, 3), b (B, M, 3), ratio_l (B, 9, N), ratio_r (B, 9, M) ->
// da (B, N, 3), db (B, M, 3): the gradient of the summed cost.
extern "C" int gwtf_emd_backward(const float* a, const float* b,
                                 const float* ratio_l, const float* ratio_r,
                                 float* da, float* db, int B, int N, int M,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = 16 * static_cast<size_t>(N + M) +
                      4 * static_cast<size_t>(kLevels) * (N > M ? N : M);
  return launch(emd_backward_kernel, static_cast<unsigned int>(B),
                backward_threads(N, M), smem, stream, a, b, ratio_l, ratio_r,
                da, db, N, M);
}
