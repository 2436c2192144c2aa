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
// What bounds it on an H100: the FP32 and SFU pipes. The forward makes 27
// sweeps over the N x M point pairs, each a distance, an accurate expf
// (about 8 FP32 instructions around one MUFU.EX2) and an FMA or two;
// 2048 x 2048 is about 1.1 G expf and 2 G other FP32 instructions per
// pair. The whole pair lives in shared memory; no device memory traffic
// to speak of. One block per pair, so a batch of 64 pairs fills only 64 of
// the 132 SMs: splitting a pair's columns over a thread-block cluster is
// left for later, as are tensor cores (the sums are matrix-vector
// products with an exp inside, which wgmma cannot take).
//
// What the design does about it:
//   * The TPU kernel caches three (P, P) matrices (D, sqrt D, E) in
//     110 MB of VMEM; a block here has 227 KB, so every sweep recomputes
//     its distances. Only the clouds (as float4, 16 (N + M) bytes) and the
//     four auction vectors (8 (N + M) bytes) stay in shared memory: 96 KB
//     at N = M = 2048, 120 KB at 2500, asked for with
//     cudaFuncSetAttribute on every launch.
//   * Sweeps 2 and 3 stay apart (the TPU merges them through its E
//     cache): column-owning threads cannot form row sums without atomics.
//   * A thread owns R rows (or columns) at once, so one broadcast
//     shared-memory load of the other cloud's point feeds R distance
//     evaluations; R and the block width follow from max(N, M), so every
//     thread has work. Ragged ends are masked, never padded.
//   * Arithmetic is rounded step by step (__fmul_rn / __fadd_rn /
//     __fmaf_rn, expf, sqrtf, IEEE division, no fast math), and the
//     temperature is carried as -4^7 times 0.25 per level, exact in fp32:
//     an error of 1e-6 in it would move exp(level * D) by about 1 %.
//   * The cost is summed per thread in a fixed order, then by a block
//     tree: no atomics, so a pair's cost is the same on every run, and the
//     grid kernel, which runs the same device function, equals the paired
//     kernel bit for bit.
//   * The backward holds a's and b's points and ONE side's 9 levels of
//     residuals in shared memory (16 (N + M) + 36 max(N, M) bytes: 136 KB
//     at 2048, 166 KB at 2500), the other side's 9 in registers, so each
//     point pair costs one distance, one rsqrt and 9 expf per pass (a row
//     pass for da, a column pass for db).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLevels = 9;
constexpr float kFirstLevel = -16384.f;  // -4^7

struct Shape {
  int rows_per_thread;  // R
  int threads;
};

// R = ceil(max(N, M) / 1024), at most 3 (larger clouds loop over chunks),
// and the fewest whole warps that give every thread R items.
Shape launch_shape(int N, int M) {
  const int n = N > M ? N : M;
  int r = (n + kMaxThreads - 1) / kMaxThreads;
  if (r > 3) r = 3;
  int t = ((n + r - 1) / r + 31) / 32 * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return {r, t};
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

__device__ void load_cloud(const float* __restrict__ x, int n, float4* s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = make_float4(x[3LL * i], x[3LL * i + 1], x[3LL * i + 2], 0.f);
}

// Sweep 1, rows: ratioL.
template <int R>
__device__ void sweep_ratio_l(const float4* pa, int N, const float4* pb,
                              int M, const float* remain_r,
                              const float* remain_l, float level,
                              float* ratio_l, float* out_rl) {
  const int T = blockDim.x;
  for (int base = 0; base < N; base += R * T) {
    if (base + (int)threadIdx.x >= N) break;
    float4 p[R];
    float s[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      p[u] = pa[min(base + u * T + (int)threadIdx.x, N - 1)];
      s[u] = 0.f;
    }
    for (int j = 0; j < M; ++j) {
      const float4 q = pb[j];
      const float r = remain_r[j];
#pragma unroll
      for (int u = 0; u < R; ++u)
        s[u] = __fmaf_rn(weight(level, sq_dist(p[u], q)), r, s[u]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = base + u * T + threadIdx.x;
      if (i < N) {
        const float rl = remain_l[i] / __fadd_rn(1e-9f, s[u]);
        ratio_l[i] = rl;
        if (out_rl) out_rl[i] = rl;
      }
    }
  }
}

// Sweep 2, columns: ratioR and remainR.
template <int R>
__device__ void sweep_ratio_r(const float4* pa, int N, const float* ratio_l,
                              const float4* pb, int M, float level,
                              float* remain_r, float* ratio_r,
                              float* out_rr) {
  const int T = blockDim.x;
  for (int base = 0; base < M; base += R * T) {
    if (base + (int)threadIdx.x >= M) break;
    float4 q[R];
    float s[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      q[u] = pb[min(base + u * T + (int)threadIdx.x, M - 1)];
      s[u] = 0.f;
    }
    for (int i = 0; i < N; ++i) {
      const float4 p = pa[i];
      const float rl = ratio_l[i];
#pragma unroll
      for (int u = 0; u < R; ++u)
        s[u] = __fmaf_rn(weight(level, sq_dist(p, q[u])), rl, s[u]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int j = base + u * T + threadIdx.x;
      if (j < M) {
        const float r = remain_r[j];
        const float sumr = __fmul_rn(r, s[u]);
        const float rr =
            __fmul_rn(fminf(r / __fadd_rn(sumr, 1e-9f), 1.f), r);
        ratio_r[j] = rr;
        remain_r[j] = fmaxf(0.f, __fsub_rn(r, sumr));
        if (out_rr) out_rr[j] = rr;
      }
    }
  }
}

// Sweep 3, rows: this level's cost into `partial`, and remainL.
template <int R>
__device__ float sweep_cost(const float4* pa, int N, const float* ratio_l,
                            const float4* pb, int M, const float* ratio_r,
                            float level, float* remain_l, float partial) {
  const int T = blockDim.x;
  for (int base = 0; base < N; base += R * T) {
    if (base + (int)threadIdx.x >= N) break;
    float4 p[R];
    float rs[R], cs[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      p[u] = pa[min(base + u * T + (int)threadIdx.x, N - 1)];
      rs[u] = 0.f;
      cs[u] = 0.f;
    }
    for (int j = 0; j < M; ++j) {
      const float4 q = pb[j];
      const float rr = ratio_r[j];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const float d = sq_dist(p[u], q);
        const float w = __fmul_rn(weight(level, d), rr);
        rs[u] = __fadd_rn(rs[u], w);
        cs[u] = __fmaf_rn(w, sqrtf(fmaxf(d, 1e-12f)), cs[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = base + u * T + threadIdx.x;
      if (i < N) {
        const float rl = ratio_l[i];
        partial = __fmaf_rn(rl, cs[u], partial);
        remain_l[i] = fmaxf(0.f, __fsub_rn(remain_l[i], __fmul_rn(rl, rs[u])));
      }
    }
  }
  return partial;
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
template <int R>
__device__ float emd_pair(const float* __restrict__ a,
                          const float* __restrict__ b, int N, int M,
                          float multi_l, float multi_r, float* out_rl,
                          float* out_rr) {
  extern __shared__ float4 smem[];
  __shared__ float scratch[kMaxThreads / 32];
  float4* pa = smem;
  float4* pb = pa + N;
  float* remain_l = reinterpret_cast<float*>(pb + M);
  float* ratio_l = remain_l + N;
  float* remain_r = ratio_l + N;
  float* ratio_r = remain_r + M;

  load_cloud(a, N, pa);
  load_cloud(b, M, pb);
  for (int i = threadIdx.x; i < N; i += blockDim.x) remain_l[i] = multi_l;
  for (int j = threadIdx.x; j < M; j += blockDim.x) remain_r[j] = multi_r;
  __syncthreads();

  float partial = 0.f;
  float level = kFirstLevel;
  for (int l = 0; l < kLevels; ++l) {
    sweep_ratio_l<R>(pa, N, pb, M, remain_r, remain_l, level, ratio_l,
                     out_rl ? out_rl + (long long)l * N : nullptr);
    __syncthreads();
    sweep_ratio_r<R>(pa, N, ratio_l, pb, M, level, remain_r, ratio_r,
                     out_rr ? out_rr + (long long)l * M : nullptr);
    __syncthreads();
    // sweep 3 reads ratioR (complete) and its own rows' ratioL / remainL;
    // the next sweep 1 writes only its own rows, so no barrier is needed
    // before it
    partial = sweep_cost<R>(pa, N, ratio_l, pb, M, ratio_r, level, remain_l,
                            partial);
    level = __fmul_rn(level, 0.25f);  // exact: a power of 4
  }
  return block_sum(partial, scratch);
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
emd_cost_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ cost, float* __restrict__ rl,
                float* __restrict__ rr, int N, int M, float multi_l,
                float multi_r) {
  const long long pair = blockIdx.x;
  const float c = emd_pair<R>(a + pair * N * 3, b + pair * M * 3, N, M,
                              multi_l, multi_r,
                              rl ? rl + pair * kLevels * N : nullptr,
                              rr ? rr + pair * kLevels * M : nullptr);
  if (threadIdx.x == 0) cost[pair] = c;
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
pairwise_emd_kernel(const float* __restrict__ samples,
                    const float* __restrict__ refs, float* __restrict__ cost,
                    int n_refs, int N, int M, float multi_l, float multi_r,
                    int pair0) {
  const long long pair = (long long)pair0 + blockIdx.x;
  const long long i = pair / n_refs, j = pair % n_refs;
  const float c = emd_pair<R>(samples + i * N * 3, refs + j * M * 3, N, M,
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
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Shape sh = launch_shape(N, M);
  const size_t smem = forward_smem(N, M);
  const unsigned int grid = static_cast<unsigned int>(B);
  switch (sh.rows_per_thread) {
    case 1:
      return launch(emd_cost_kernel<1>, grid, sh.threads, smem, stream, a, b,
                    cost, ratio_l, ratio_r, N, M, multi_l, multi_r);
    case 2:
      return launch(emd_cost_kernel<2>, grid, sh.threads, smem, stream, a, b,
                    cost, ratio_l, ratio_r, N, M, multi_l, multi_r);
    default:
      return launch(emd_cost_kernel<3>, grid, sh.threads, smem, stream, a, b,
                    cost, ratio_l, ratio_r, N, M, multi_l, multi_r);
  }
}

// samples (S, N, 3), refs (R, M, 3) -> cost (S, R), pairs
// [pair0, pair0 + pairs) of the row-major grid.
extern "C" int gwtf_pairwise_emd(const float* samples, const float* refs,
                                 float* cost, int n_refs, int N, int M,
                                 float multi_l, float multi_r, int pair0,
                                 int pairs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Shape sh = launch_shape(N, M);
  const size_t smem = forward_smem(N, M);
  const unsigned int grid = static_cast<unsigned int>(pairs);
  switch (sh.rows_per_thread) {
    case 1:
      return launch(pairwise_emd_kernel<1>, grid, sh.threads, smem, stream,
                    samples, refs, cost, n_refs, N, M, multi_l, multi_r,
                    pair0);
    case 2:
      return launch(pairwise_emd_kernel<2>, grid, sh.threads, smem, stream,
                    samples, refs, cost, n_refs, N, M, multi_l, multi_r,
                    pair0);
    default:
      return launch(pairwise_emd_kernel<3>, grid, sh.threads, smem, stream,
                    samples, refs, cost, n_refs, N, M, multi_l, multi_r,
                    pair0);
  }
}

// a (B, N, 3), b (B, M, 3), ratio_l (B, 9, N), ratio_r (B, 9, M) ->
// da (B, N, 3), db (B, M, 3): the gradient of the summed cost.
extern "C" int gwtf_emd_backward(const float* a, const float* b,
                                 const float* ratio_l, const float* ratio_r,
                                 float* da, float* db, int B, int N, int M,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Shape sh = launch_shape(N, M);
  const size_t smem = 16 * static_cast<size_t>(N + M) +
                      4 * static_cast<size_t>(kLevels) * (N > M ? N : M);
  return launch(emd_backward_kernel, static_cast<unsigned int>(B), sh.threads,
                smem, stream, a, b, ratio_l, ratio_r, da, db, N, M);
}
