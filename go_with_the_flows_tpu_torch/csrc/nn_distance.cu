// Bidirectional nearest-neighbour squared distances (Chamfer), fp32.
//
// Replaces: go_with_the_flows_tpu/ops/pallas/chamfer_kernel.py `_nn_kernel`
// (the pallas_call in `nn_distance_pallas`, used by `chamfer_pallas`).
// Design prior: the reference's nndistance.cu.
//
// What bounds it on an H100: FP32 compute, about 9 flops per pair of
// points (three differences, three squares, two adds, one compare); the
// clouds themselves are 24 KB each at 2048 points.
//
// What the design does about it:
//   * one launch per direction; one thread per query point, one block per
//     (tile of kThreads queries, cloud b). The query point, its running
//     minimum and its argmin stay in registers;
//   * the other cloud streams through shared memory in tiles of kTile
//     points stored as float4, so each pair costs one broadcast 16-byte
//     shared load and the arithmetic;
//   * the ragged last tile is masked by its count, no sentinel padding;
//   * strict `<` keeps the first index on ties, as argmin does;
//   * d = (dx*dx + dy*dy) + dz*dz is rounded step by step (no FMA
//     contraction), the same sum as the plain PyTorch version, so the
//     minima agree to the bit and the indices agree exactly;
//   * WITH_IDX = false drops the index stores, as `with_idx=False` does on
//     the TPU.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float4 r) {
  const float dx = __fsub_rn(ax, r.x), dy = __fsub_rn(ay, r.y),
              dz = __fsub_rn(az, r.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <bool WITH_IDX>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q, const float* __restrict__ r,
          float* __restrict__ dist, int* __restrict__ idx, int nq, int nr) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < nq;
  const float* qb = q + (long long)b * nq * 3;
  const float* rb = r + (long long)b * nr * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = qb[3 * i];
    qy = qb[3 * i + 1];
    qz = qb[3 * i + 2];
  }
  float best = INFINITY;
  int best_j = 0;
  for (int t0 = 0; t0 < nr; t0 += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile && t0 + j < nr; j += kThreads) {
      const float* pt = rb + 3LL * (t0 + j);
      tile[j] = make_float4(pt[0], pt[1], pt[2], 0.f);
    }
    __syncthreads();
    const int count = min(kTile, nr - t0);
    if (count == kTile) {
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float d = sq_dist(qx, qy, qz, tile[j]);
        if (d < best) {
          best = d;
          best_j = t0 + j;
        }
      }
    } else {
      for (int j = 0; j < count; ++j) {
        const float d = sq_dist(qx, qy, qz, tile[j]);
        if (d < best) {
          best = d;
          best_j = t0 + j;
        }
      }
    }
  }
  if (live) {
    dist[(long long)b * nq + i] = best;
    if (WITH_IDX) idx[(long long)b * nq + i] = best_j;
  }
}

void launch_direction(const float* q, const float* r, float* dist, int* idx,
                      int B, int nq, int nr, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, B);
  if (idx != nullptr)
    nn_kernel<true><<<grid, kThreads, 0, stream>>>(q, r, dist, idx, nq, nr);
  else
    nn_kernel<false><<<grid, kThreads, 0, stream>>>(q, r, dist, nullptr, nq,
                                                    nr);
}

}  // namespace

// a (B, N, 3), b (B, M, 3) -> dist_a (B, N), dist_b (B, M) and, when the
// index pointers are not null, idx_a (B, N), idx_b (B, M).
extern "C" int gwtf_nn_distance(const float* a, const float* b, float* dist_a,
                                int* idx_a, float* dist_b, int* idx_b, int B,
                                int N, int M, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  launch_direction(a, b, dist_a, idx_a, B, N, M, stream);
  launch_direction(b, a, dist_b, idx_b, B, M, N, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gwtf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
