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
// What bounds it on an H100: FP32 issue. The function needs each of the
// N * M distances once (8 flops: 3 differences, 3 squares, 2 sums) and
// two minima of it, 10 instructions a point pair (42 M a pair of clouds
// at N = M = 2048); a pair reads only 48 KB of points, which L2 serves
// after the first touch.
//
// What the design does about it:
//   * one block per pair; each writes its own four scalars, so no
//     reduction crosses blocks;
//   * one pass, as the TPU kernel's: each distance feeds both its row
//     minimum and its column minimum. A thread holds kRows sample points
//     (rows) and their running minima in registers; the reference points
//     (columns) stream through shared memory as float4 tiles, so one
//     broadcast 16-byte load feeds kRows distances;
//   * for a group of kCols columns each thread also keeps the minimum over
//     its own rows, in registers. At the end of the group a warp reduces
//     them by a halving exchange (31 shuffles: lane l ends with column l's
//     warp minimum), and warp 0 takes the minimum over the warps from a
//     double-buffered shared array (one barrier a group) into the column
//     minima, kept in shared memory for all M columns;
//   * rows beyond kThreads * kRows come in further chunks, each folding
//     its column minima into the shared ones;
//   * ragged ends are masked by index: a row or column past the end is a
//     copy of the last real one, which leaves every minimum as it is, and
//     only real rows and columns are summed and counted;
//   * distances are rounded step by step as in nn_distance.cu, so every
//     minimum equals the plain PyTorch version's bit for bit; only the
//     order of the final sums differs;
//   * the block reduces its per-thread sums and counts with warp shuffles.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;    // sample points (rows) a thread
constexpr int kCols = 32;   // columns of one group, one a lane
constexpr int kTile = 1024; // columns staged in shared memory at once

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float4 r) {
  const float dx = __fsub_rn(ax, r.x), dy = __fsub_rn(ay, r.y),
              dz = __fsub_rn(az, r.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// One step of the exchange below: a lane keeps O of its 2 O column minima,
// the half named by bit O of the lane, and takes the other lane's minima
// of the same columns.
template <int O>
__device__ __forceinline__ void exchange(float (&v)[kCols], bool upper) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, O));
  }
}

// Minima of kCols = 32 values over a warp's lanes: on return v[0] of lane
// l holds the warp's minimum of column l.
__device__ __forceinline__ float warp_column_min(float (&v)[kCols]) {
  const int lane = threadIdx.x % 32;
  exchange<16>(v, lane & 16);
  exchange<8>(v, lane & 8);
  exchange<4>(v, lane & 4);
  exchange<2>(v, lane & 2);
  exchange<1>(v, lane & 1);
  return v[0];
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
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;  // valid in thread 0
}

// dynamic shared memory: the column tile, the warps' group minima (two
// buffers), the block sums' scratch, the column minima
constexpr size_t smem_bytes(int M) {
  return kTile * sizeof(float4) + (2 * kWarps * kCols + kWarps) * sizeof(float)
         + M * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
cd_stats_kernel(const float* __restrict__ samples,
                const float* __restrict__ refs, float* __restrict__ cdl,
                float* __restrict__ cdr, float* __restrict__ prec,
                float* __restrict__ rec, int R, int N, int M, float thr) {
  extern __shared__ float4 smem[];
  float4* tile = smem;
  float* group_min = reinterpret_cast<float*>(smem + kTile);
  float* scratch = group_min + 2 * kWarps * kCols;
  float* col_min = scratch + kWarps;
  const long long pair = blockIdx.x;
  const long long i = pair / R, j = pair % R;
  const float* a = samples + i * N * 3;
  const float* b = refs + j * M * 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float row_sum = 0.f, row_cnt = 0.f;
  int group = 0;
  for (int r0 = 0; r0 < N; r0 += kThreads * kRows) {
    float px[kRows], py[kRows], pz[kRows], best[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long n = min(r0 + u * kThreads + (int)threadIdx.x, N - 1);
      px[u] = a[3 * n];
      py[u] = a[3 * n + 1];
      pz[u] = a[3 * n + 2];
      best[u] = INFINITY;
    }
    for (int t0 = 0; t0 < M; t0 += kTile) {
      const int width = (min(kTile, M - t0) + kCols - 1) / kCols * kCols;
      __syncthreads();  // the previous tile is no longer read
      for (int c = threadIdx.x; c < width; c += kThreads) {
        const long long m = min(t0 + c, M - 1);
        tile[c] = make_float4(b[3 * m], b[3 * m + 1], b[3 * m + 2], 0.f);
      }
      __syncthreads();
      for (int c0 = 0; c0 < width; c0 += kCols, ++group) {
        float cmin[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 q = tile[c0 + c];
          float d[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            d[u] = sq_dist(px[u], py[u], pz[u], q);
            best[u] = fminf(best[u], d[u]);
          }
#pragma unroll
          for (int s = 1; s < kRows; s *= 2) {
#pragma unroll
            for (int u = 0; u + s < kRows; u += 2 * s)
              d[u] = fminf(d[u], d[u + s]);
          }
          cmin[c] = d[0];
        }
        float* slot = group_min + (group & 1) * kWarps * kCols;
        slot[warp * kCols + lane] = warp_column_min(cmin);
        // the group's minima are written; a write to this buffer comes two
        // groups later, after warp 0 has passed the next barrier
        __syncthreads();
        const int col = t0 + c0 + lane;
        if (warp == 0 && col < M) {
          float v = slot[lane];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) v = fminf(v, slot[w * kCols + lane]);
          col_min[col] = r0 == 0 ? v : fminf(col_min[col], v);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (r0 + u * kThreads + (int)threadIdx.x < N) {
        row_sum += best[u];
        row_cnt += best[u] < thr ? 1.f : 0.f;
      }
    }
  }
  __syncthreads();  // every column minimum is final
  float col_sum = 0.f, col_cnt = 0.f;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    col_sum += col_min[m];
    col_cnt += col_min[m] < thr ? 1.f : 0.f;
  }
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
  // the column minima live in shared memory beside the tile, within the
  // 227 KB a block can use: at most 53,496 reference points
  if (smem_bytes(M) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(M));
  const cudaError_t err = cudaFuncSetAttribute(
      cd_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cd_stats_kernel<<<pairs, kThreads, smem, stream>>>(samples, refs, cdl, cdr,
                                                     prec, rec, R, N, M, thr);
  return static_cast<int>(cudaGetLastError());
}
