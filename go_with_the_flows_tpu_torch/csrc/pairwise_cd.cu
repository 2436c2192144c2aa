// Pairwise Chamfer statistics over an (S, R) grid of cloud pairs, fp32.
//
// Replaces: go_with_the_flows_tpu/ops/pallas/pairwise_kernel.py
// `_cd_stats_kernel` (the pallas_call in `pairwise_cd_stats_pallas`), which
// feeds MMD, COV and 1-NNA over CD and F1.
//
// For pair (i, j), with a = samples[i] (N points) and b = refs[j] (M):
//   row mins  rmin[n] = min_m |a_n - b_m|^2,  col mins  cmin[m] = min_n ...
//   cdl  = sum(rmin) / N          recall    = 100 * #(rmin < thr) / N
//   cdr  = sum(cmin) / M          precision = 100 * #(cmin < thr) / M
// exactly the masks and denominators of the TPU kernel.
//
// What bounds it on an H100: FP32 compute, 2 * N * M distance evaluations
// of about 9 flops per pair of clouds (75 Mflop at N = M = 2048); a pair
// reads only 48 KB of points, which L2 serves after the first touch.
//
// What the design does about it:
//   * one block per pair; each writes its own four scalars, so no
//     reduction crosses blocks;
//   * two passes, rows then columns. In a pass each thread owns kQPT
//     query points in registers and the other cloud streams through
//     shared memory as float4 tiles, so one broadcast 16-byte load feeds
//     kQPT distance evaluations;
//   * ragged ends are masked by index, never padded;
//   * distances are rounded step by step as in nn_distance.cu, so every
//     minimum equals the plain PyTorch version's; only the order of the
//     final sums differs;
//   * the block reduces its per-thread sums and counts with warp shuffles.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQPT = 8;  // query points per thread per chunk
constexpr int kTile = 1024;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float4 r) {
  const float dx = __fsub_rn(ax, r.x), dy = __fsub_rn(ay, r.y),
              dz = __fsub_rn(az, r.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// One pass: for every point of q (nq points), its min squared distance to
// the points of r (nr); returns this thread's partial (sum of mins,
// count of mins < thr).
__device__ void min_pass(const float* __restrict__ q, int nq,
                         const float* __restrict__ r, int nr, float thr,
                         float4* tile, float& sum, float& count) {
  for (int q0 = 0; q0 < nq; q0 += kThreads * kQPT) {
    float px[kQPT], py[kQPT], pz[kQPT], best[kQPT];
#pragma unroll
    for (int u = 0; u < kQPT; ++u) {
      const int n = q0 + u * kThreads + threadIdx.x;
      const bool live = n < nq;
      px[u] = live ? q[3LL * n] : 0.f;
      py[u] = live ? q[3LL * n + 1] : 0.f;
      pz[u] = live ? q[3LL * n + 2] : 0.f;
      best[u] = INFINITY;
    }
    for (int t0 = 0; t0 < nr; t0 += kTile) {
      __syncthreads();
      for (int j = threadIdx.x; j < kTile && t0 + j < nr; j += kThreads) {
        const float* pt = r + 3LL * (t0 + j);
        tile[j] = make_float4(pt[0], pt[1], pt[2], 0.f);
      }
      __syncthreads();
      const int cnt = min(kTile, nr - t0);
      for (int j = 0; j < cnt; ++j) {
        const float4 pt = tile[j];
#pragma unroll
        for (int u = 0; u < kQPT; ++u)
          best[u] = fminf(best[u], sq_dist(px[u], py[u], pz[u], pt));
      }
    }
#pragma unroll
    for (int u = 0; u < kQPT; ++u) {
      if (q0 + u * kThreads + threadIdx.x < nq) {
        sum += best[u];
        count += best[u] < thr ? 1.f : 0.f;
      }
    }
  }
}

__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  }
  return total;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
cd_stats_kernel(const float* __restrict__ samples,
                const float* __restrict__ refs, float* __restrict__ cdl,
                float* __restrict__ cdr, float* __restrict__ prec,
                float* __restrict__ rec, int R, int N, int M, float thr) {
  __shared__ float4 tile[kTile];
  __shared__ float scratch[kThreads / 32];
  const long long pair = blockIdx.x;
  const long long i = pair / R, j = pair % R;
  const float* a = samples + i * N * 3;
  const float* b = refs + j * M * 3;

  float row_sum = 0.f, row_cnt = 0.f, col_sum = 0.f, col_cnt = 0.f;
  min_pass(a, N, b, M, thr, tile, row_sum, row_cnt);
  min_pass(b, M, a, N, thr, tile, col_sum, col_cnt);
  row_sum = block_sum(row_sum, scratch);
  row_cnt = block_sum(row_cnt, scratch);
  col_sum = block_sum(col_sum, scratch);
  col_cnt = block_sum(col_cnt, scratch);
  if (threadIdx.x == 0) {
    cdl[pair] = row_sum / (float)N;
    rec[pair] = 100.f * row_cnt / (float)N;
    cdr[pair] = col_sum / (float)M;
    prec[pair] = 100.f * col_cnt / (float)M;
  }
}

}  // namespace

// samples (S, N, 3), refs (R, M, 3) -> cdl, cdr, precision, recall (S, R).
extern "C" int gwtf_pairwise_cd_stats(const float* samples, const float* refs,
                                      float* cdl, float* cdr, float* prec,
                                      float* rec, int S, int R, int N, int M,
                                      float thr, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned int pairs = static_cast<unsigned int>(S) * R;
  cd_stats_kernel<<<pairs, kThreads, 0, stream>>>(samples, refs, cdl, cdr,
                                                  prec, rec, R, N, M, thr);
  return static_cast<int>(cudaGetLastError());
}
