// Bidirectional nearest-neighbour squared distances (Chamfer), fp32.
//
// Replaces: go_with_the_flows_tpu/ops/pallas/chamfer_kernel.py `_nn_kernel`
// (the pallas_call in `nn_distance_pallas`, used by `chamfer_pallas`).
// Design prior: the reference's nndistance.cu; the single pass is kernel
// 3's (pairwise_cd.cu).
//
// What bounds it on an H100: FP32 issue. The function needs each of the
// N * M distances once (8 flops: 3 differences, 3 squares, 2 sums) and
// its two minima, the row's and the column's, as the TPU kernel takes
// both from one distance tile (chamfer_kernel.py:83-98); the clouds are
// 24 KB each at 2048 points, which L2 serves after the first touch.
//
// What the design does about it:
//   * one pass for both directions: each distance feeds its row's running
//     minimum and its column's. A thread holds kRows points of a (rows)
//     and their minima in registers; the points of b (columns) stream
//     through shared memory as float4 tiles, so one broadcast 16-byte
//     load feeds kRows distances;
//   * grid (row chunks, B): a block takes kChunk = kThreads * kRows rows
//     of one pair against all M columns, so a batch of 64 pairs of 2048
//     points makes 256 blocks and fills the card;
//   * for a group of kCols columns each thread also keeps the minimum over
//     its own rows in registers. At the group's end a warp reduces them by
//     a halving exchange (31 shuffles: lane l ends with column l's warp
//     minimum), and warp 0 folds the warps, from a double-buffered shared
//     array (one barrier a group), into the block's column minima;
//   * a block writes its column minima straight to dist_b when one chunk
//     holds all N rows, else to a scratch (B, chunks, M) that a second
//     launch folds in chunk order: no atomics, the same bits every run;
//   * ties: rows visit the columns in order with a strict `<`, so a row
//     keeps its first column, as argmin does. A column keeps its lowest
//     row: a thread's rows are in index order, but the lanes, the warps
//     and the chunks interleave, so the exchange and the warp fold compare
//     (distance, row) pairs, and the chunk fold, over chunks in row order,
//     a strict `<`;
//   * ragged ends are masked by index: a row or column past the end is a
//     copy of the last real one (its index too), which changes no minimum
//     and no first index, and only real rows and columns are written;
//   * d = (dx*dx + dy*dy) + dz*dz is rounded step by step (no FMA
//     contraction), the same sum as the plain PyTorch version, so every
//     minimum equals it bit for bit and indices differ only at exact ties
//     (none, by the rules above);
//   * WITH_IDX = false does no index work at all, as `with_idx=False`
//     does on the TPU: the metric path.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;     // rows (points of a) a thread
constexpr int kChunk = kThreads * kRows;  // rows a block
constexpr int kCols = 32;    // columns of one group, one a lane
constexpr int kTile = 1024;  // columns staged in shared memory at once

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float4 r) {
  const float dx = __fsub_rn(ax, r.x), dy = __fsub_rn(ay, r.y),
              dz = __fsub_rn(az, r.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (d, i) comes before (e, j): the smaller distance, on a tie the lower row.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// One step of the exchange below: a lane keeps O of its 2 O column minima,
// the half named by bit O of the lane, and takes the other lane's minima
// of the same columns (with their rows when WITH_IDX).
template <int O, bool WITH_IDX>
__device__ __forceinline__ void exchange(float (&v)[kCols], int (&k)[kCols],
                                         bool upper) {
#pragma unroll
  for (int c = 0; c < O; ++c) {
    const float send = upper ? v[c] : v[c + O];
    const float keep = upper ? v[c + O] : v[c];
    const float got = __shfl_xor_sync(0xffffffffu, send, O);
    if (WITH_IDX) {
      const int ksend = upper ? k[c] : k[c + O];
      const int kkeep = upper ? k[c + O] : k[c];
      const int kgot = __shfl_xor_sync(0xffffffffu, ksend, O);
      const bool take = before(got, kgot, keep, kkeep);
      v[c] = take ? got : keep;
      k[c] = take ? kgot : kkeep;
    } else {
      v[c] = fminf(keep, got);
    }
  }
}

// Minima of kCols = 32 columns over a warp's lanes: on return v[0] (and
// k[0]) of lane l hold the warp's minimum of column l (and its row).
template <bool WITH_IDX>
__device__ __forceinline__ void warp_column_min(float (&v)[kCols],
                                                int (&k)[kCols]) {
  const int lane = threadIdx.x % 32;
  exchange<16, WITH_IDX>(v, k, lane & 16);
  exchange<8, WITH_IDX>(v, k, lane & 8);
  exchange<4, WITH_IDX>(v, k, lane & 4);
  exchange<2, WITH_IDX>(v, k, lane & 2);
  exchange<1, WITH_IDX>(v, k, lane & 1);
}

// a (B, N, 3) rows against b (B, M, 3) columns: the rows' minima (and
// first columns) into dist_a (idx_a), this chunk's column minima (and
// lowest rows) into col_d (col_i) at (pair, chunk), (B, chunks, M).
template <bool WITH_IDX>
__global__ void __launch_bounds__(kThreads)
nn_distance_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ dist_a, int* __restrict__ idx_a,
                   float* __restrict__ col_d, int* __restrict__ col_i, int N,
                   int M) {
  __shared__ float4 tile[kTile];
  __shared__ float group_d[2][kWarps][kCols];
  __shared__ int group_i[2][kWarps][kCols];
  const long long pair = blockIdx.y;
  const int chunk = blockIdx.x;
  const int r0 = chunk * kChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  a += pair * N * 3;
  b += pair * M * 3;
  col_d += (pair * gridDim.x + chunk) * M;
  if (WITH_IDX) col_i += (pair * gridDim.x + chunk) * M;

  float px[kRows], py[kRows], pz[kRows], best[kRows];
  int row[kRows], best_j[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    row[u] = min(r0 + u * kThreads + (int)threadIdx.x, N - 1);
    px[u] = a[3LL * row[u]];
    py[u] = a[3LL * row[u] + 1];
    pz[u] = a[3LL * row[u] + 2];
    best[u] = INFINITY;
    best_j[u] = 0;
  }
  int group = 0;
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
      int crow[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 q = tile[c0 + c];
        float d[kRows];
        int k[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          d[u] = sq_dist(px[u], py[u], pz[u], q);
          if (WITH_IDX) {
            k[u] = row[u];
            if (d[u] < best[u]) {
              best[u] = d[u];
              best_j[u] = t0 + c0 + c;
            }
          } else {
            best[u] = fminf(best[u], d[u]);
          }
        }
        // the thread's rows are in index order: on a tie keep the left
#pragma unroll
        for (int s = 1; s < kRows; s *= 2) {
#pragma unroll
          for (int u = 0; u + s < kRows; u += 2 * s) {
            if (WITH_IDX) {
              if (d[u + s] < d[u]) {
                d[u] = d[u + s];
                k[u] = k[u + s];
              }
            } else {
              d[u] = fminf(d[u], d[u + s]);
            }
          }
        }
        cmin[c] = d[0];
        crow[c] = WITH_IDX ? k[0] : 0;
      }
      warp_column_min<WITH_IDX>(cmin, crow);
      const int slot = group & 1;
      group_d[slot][warp][lane] = cmin[0];
      if (WITH_IDX) group_i[slot][warp][lane] = crow[0];
      // the group's minima are written; a write to this buffer comes two
      // groups later, after warp 0 has passed the next barrier
      __syncthreads();
      const int col = t0 + c0 + lane;
      if (warp == 0 && col < M) {
        float v = group_d[slot][0][lane];
        int k = WITH_IDX ? group_i[slot][0][lane] : 0;
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const float e = group_d[slot][w][lane];
          if (WITH_IDX) {
            const int j = group_i[slot][w][lane];
            if (before(e, j, v, k)) {
              v = e;
              k = j;
            }
          } else {
            v = fminf(v, e);
          }
        }
        col_d[col] = v;
        if (WITH_IDX) col_i[col] = k;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int n = r0 + u * kThreads + threadIdx.x;
    if (n < N) {
      dist_a[pair * N + n] = best[u];
      if (WITH_IDX) idx_a[pair * N + n] = best_j[u];
    }
  }
}

// The chunks' column minima (B, chunks, M), folded in chunk order into
// dist_b (B, M) (and idx_b). A chunk's rows all come after the previous
// chunk's, so a strict `<` keeps the lowest row of a tie.
template <bool WITH_IDX>
__global__ void nn_combine_kernel(const float* __restrict__ col_d,
                                  const int* __restrict__ col_i,
                                  float* __restrict__ dist_b,
                                  int* __restrict__ idx_b, int chunks, int M,
                                  long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long pair = t / M, col = t % M;
  const long long at = pair * chunks * M + col;
  float v = col_d[at];
  int k = WITH_IDX ? col_i[at] : 0;
  for (int c = 1; c < chunks; ++c) {
    const float e = col_d[at + (long long)c * M];
    if (e < v) {
      v = e;
      if (WITH_IDX) k = col_i[at + (long long)c * M];
    }
  }
  dist_b[t] = v;
  if (WITH_IDX) idx_b[t] = k;
}

template <bool WITH_IDX>
void launch(const float* a, const float* b, float* dist_a, int* idx_a,
            float* dist_b, int* idx_b, float* col_d, int* col_i, int B,
            int N, int M, cudaStream_t stream) {
  const int chunks = (N + kChunk - 1) / kChunk;
  const dim3 grid(chunks, B);
  if (chunks == 1) {
    nn_distance_kernel<WITH_IDX><<<grid, kThreads, 0, stream>>>(
        a, b, dist_a, idx_a, dist_b, idx_b, N, M);
    return;
  }
  nn_distance_kernel<WITH_IDX><<<grid, kThreads, 0, stream>>>(
      a, b, dist_a, idx_a, col_d, col_i, N, M);
  const long long total = (long long)B * M;
  const unsigned int blocks = static_cast<unsigned int>((total + 255) / 256);
  nn_combine_kernel<WITH_IDX><<<blocks, 256, 0, stream>>>(
      col_d, col_i, dist_b, idx_b, chunks, M, total);
}

}  // namespace

// Row chunks of a launch over N rows: when more than one, the caller
// gives a scratch of (B, chunks, M) floats (and ints with the indices).
extern "C" int gwtf_nn_distance_chunks(int N) {
  return (N + kChunk - 1) / kChunk;
}

// a (B, N, 3), b (B, M, 3) -> dist_a (B, N), dist_b (B, M) and, when the
// index pointers are not null, idx_a (B, N), idx_b (B, M); col_d (and
// col_i with the indices) is the scratch, unused with one row chunk.
extern "C" int gwtf_nn_distance(const float* a, const float* b, float* dist_a,
                                int* idx_a, float* dist_b, int* idx_b,
                                float* col_d, int* col_i, int B, int N, int M,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (idx_a != nullptr)
    launch<true>(a, b, dist_a, idx_a, dist_b, idx_b, col_d, col_i, B, N, M,
                 stream);
  else
    launch<false>(a, b, dist_a, nullptr, dist_b, nullptr, col_d, nullptr, B,
                  N, M, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gwtf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
