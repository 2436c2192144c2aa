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
//
// The backward (kernel 6) needs, per point pair, D, its rsqrt and 9 E,
// 10 special-function operations, and about 45 FP32 instructions: the
// special-function units bound it. What its design does about it:
//   * one pass, as the TPU kernel's (emd_kernel.py:330-350): each point
//     pair forms its coefficient c_ij once and feeds both row i's da and
//     column j's db, in the difference form c_ij (a_i - b_j) (the JAX
//     kernel's a_i sum_j c_ij - sum_j c_ij b_j cancels);
//   * the forward's forms (sq_norm_fma, weight2 with c_l = kFirstLevel2
//     0.25^l), so both kernels build the same E, and the root on
//     rsqrt.approx.ftz, the coefficient selected to 0 where D <= 1e-12;
//   * a register tile: a thread owns kBwdRows rows, each with its point
//     and 9 ratioL in registers; the columns stream through shared memory
//     in tiles of kBwdTile, a column's point and 9 ratioR as 3 float4s, so
//     one column's 3 broadcast loads feed kBwdRows x 9 products. Two rows
//     a thread and 128 threads a block (1.5 loads and 1.7 shuffles a
//     pair) ran 4 % faster than 4 rows and 64 threads: the units, not
//     issue, bound it, and more warps feed them better. Shared memory is
//     24 KB whatever N and M;
//   * column sums without atomics: a thread sums its rows into a column
//     partial, a warp exchange reduces 8 columns' partials at once, the
//     block adds its warps in order; the rows of a pair are split over
//     row chunks of kBwdChunk (grid pairs x chunks: 512 blocks at B = 64
//     and 2048 points, the whole card), each chunk writes its column sums
//     to a scratch and a second launch adds them in chunk order. da is
//     whole in its block, whose rows see every column. Every sum runs in
//     a fixed order: two launches give the same bits;
//   * ragged ends are masked by weight: a row or column past the end has
//     ratios 0, so its coefficients are 0, and only real ones are written.

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

// The squared norm of kernels 4-6's differences: a product and 2 FMAs.
__device__ __forceinline__ float sq_norm_fma(float dx, float dy, float dz) {
  return __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, __fmul_rn(dz, dz)));
}

// The distance of kernels 4-6: 3 subtractions and sq_norm_fma.
__device__ __forceinline__ float sq_dist_fma(float4 p, float4 q) {
  return sq_norm_fma(__fsub_rn(p.x, q.x), __fsub_rn(p.y, q.y),
                     __fsub_rn(p.z, q.z));
}

// The forward's E = 2^(c d) for c = level log2(e): MUFU.EX2 alone, a
// result below 2^-126 flushed to 0. The argument carries two roundings
// (c's and the product's), exp(level d) with an exact level d none: up
// to 2^-23 |c d| apart, 1e-5 of E where E nears 2^-126, 2e-6 where
// level d is -16. Kernel 6 rebuilds the match in the same form; the
// plain versions use exp(level d) of the step-rounded distance, and
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

// 1 / sqrt(x) on MUFU.RSQ alone, for a normal x > 0.
__device__ __forceinline__ float approx_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return rsqrtf(x);
#endif
}

// sqrt(max(d, 1e-12)) as x rsqrt(x): MUFU.RSQ and a product.
__device__ __forceinline__ float clamped_sqrt(float d) {
  const float x = fmaxf(d, 1e-12f);
  return __fmul_rn(x, approx_rsqrt(x));
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

// The backward's layout: a block takes kBwdChunk rows of one pair, a
// thread kBwdRows of them (its points and ratios in registers); the
// columns come through shared memory in tiles of kBwdTile, in groups of
// kBwdCols whose column sums a warp exchange reduces.
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRows = 2;
constexpr int kBwdChunk = kBwdThreads * kBwdRows;
constexpr int kBwdTile = 256;
constexpr int kBwdCols = 8;  // the exchange below ends with 4 lanes a column
static_assert(kBwdTile % kBwdCols == 0, "a tile is whole groups");

// One halving step of the column sums' exchange: a lane keeps O of its
// 2 O columns (3 sums each), the half named by lane bit `bit`, and adds
// the other lane's sums of the same columns.
template <int O>
__device__ __forceinline__ void halve(float (&v)[3 * kBwdCols], int bit) {
  const bool upper = (threadIdx.x & bit) != 0;
#pragma unroll
  for (int i = 0; i < 3 * O; ++i) {
    const float send = upper ? v[i] : v[i + 3 * O];
    const float keep = upper ? v[i + 3 * O] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, bit));
  }
}

// The sums over a warp's lanes of 8 columns' 3 components: on return
// v[0..2] of lane l hold column l / 4's (its 4 lanes alike: the last two
// steps add both ways, and a sum does not depend on its operands' order).
__device__ __forceinline__ void warp_column_sums(float (&v)[3 * kBwdCols]) {
  halve<4>(v, 16);
  halve<2>(v, 8);
  halve<1>(v, 4);
#pragma unroll
  for (int bit = 2; bit > 0; bit >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], bit));
  }
}

// Kernel 6's one pass. Each point pair forms D, its 9 levels' E and the
// coefficient c_ij = (sum_l E_l ratioL_l,i ratioR_l,j) rsqrt(D) once
// (0 where D <= 1e-12); c_ij (a_i - b_j) adds into row i's da, kept in
// registers, and into the thread's partial of column j, which the warp,
// then the block (warps in order), reduce. The block writes its chunk's
// column sums, negated, to col (B, chunks, M, 3) at (pair, chunk): db
// itself when one chunk holds all N rows.
__global__ void __launch_bounds__(kBwdThreads)
emd_backward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ rl,
                    const float* __restrict__ rr, float* __restrict__ da,
                    float* __restrict__ col, int N, int M) {
  // a column: (x, y, z, ratioR_0), ratioR_1..4, ratioR_5..8
  __shared__ float4 tile[kBwdTile][3];
  __shared__ float sums[kBwdWarps][kBwdTile][3];
  const long long pair = blockIdx.x;
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  a += pair * N * 3;
  b += pair * M * 3;
  rl += pair * kLevels * N;
  rr += pair * kLevels * M;
  da += pair * N * 3;
  col += (pair * gridDim.y + chunk) * M * 3;

  float px[kBwdRows], py[kBwdRows], pz[kBwdRows], w[kBwdRows][kLevels];
  float gx[kBwdRows], gy[kBwdRows], gz[kBwdRows];
#pragma unroll
  for (int u = 0; u < kBwdRows; ++u) {
    const int n = chunk * kBwdChunk + u * kBwdThreads + threadIdx.x;
    const long long i = min(n, N - 1);
    px[u] = a[3 * i];
    py[u] = a[3 * i + 1];
    pz[u] = a[3 * i + 2];
    // a row past the end weighs nothing
#pragma unroll
    for (int l = 0; l < kLevels; ++l)
      w[u][l] = n < N ? rl[l * (long long)N + i] : 0.f;
    gx[u] = gy[u] = gz[u] = 0.f;
  }
  for (int t0 = 0; t0 < M; t0 += kBwdTile) {
    const int width =
        (min(kBwdTile, M - t0) + kBwdCols - 1) / kBwdCols * kBwdCols;
    __syncthreads();  // the previous tile and its sums are no longer read
    for (int c = threadIdx.x; c < width; c += kBwdThreads) {
      const int j = t0 + c;
      const long long at = min(j, M - 1);
      float r[kLevels];  // a column past the end weighs nothing
#pragma unroll
      for (int l = 0; l < kLevels; ++l)
        r[l] = j < M ? rr[l * (long long)M + at] : 0.f;
      tile[c][0] = make_float4(b[3 * at], b[3 * at + 1], b[3 * at + 2], r[0]);
      tile[c][1] = make_float4(r[1], r[2], r[3], r[4]);
      tile[c][2] = make_float4(r[5], r[6], r[7], r[8]);
    }
    __syncthreads();
    for (int c0 = 0; c0 < width; c0 += kBwdCols) {
      float s[3 * kBwdCols];
#pragma unroll
      for (int c = 0; c < kBwdCols; ++c) {
        const float4 q = tile[c0 + c][0], r1 = tile[c0 + c][1],
                     r5 = tile[c0 + c][2];
        const float r[kLevels] = {q.w,  r1.x, r1.y, r1.z, r1.w,
                                  r5.x, r5.y, r5.z, r5.w};
        float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
        for (int u = 0; u < kBwdRows; ++u) {
          const float dx = __fsub_rn(px[u], q.x), dy = __fsub_rn(py[u], q.y),
                      dz = __fsub_rn(pz[u], q.z);
          const float d = sq_norm_fma(dx, dy, dz);
          float m = 0.f, cl = kFirstLevel2;
#pragma unroll
          for (int l = 0; l < kLevels; ++l) {
            m = __fmaf_rn(__fmul_rn(weight2(cl, d), w[u][l]), r[l], m);
            cl *= 0.25f;  // exact: a power of 4
          }
          const float coef = d > 1e-12f ? __fmul_rn(m, approx_rsqrt(d)) : 0.f;
          gx[u] = __fmaf_rn(coef, dx, gx[u]);
          gy[u] = __fmaf_rn(coef, dy, gy[u]);
          gz[u] = __fmaf_rn(coef, dz, gz[u]);
          sx = __fmaf_rn(coef, dx, sx);
          sy = __fmaf_rn(coef, dy, sy);
          sz = __fmaf_rn(coef, dz, sz);
        }
        s[3 * c] = sx;
        s[3 * c + 1] = sy;
        s[3 * c + 2] = sz;
      }
      warp_column_sums(s);
      if (lane % 4 == 0) {
        float* out = sums[warp][c0 + lane / 4];
        out[0] = s[0];
        out[1] = s[1];
        out[2] = s[2];
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 3 * width; k += kBwdThreads) {
      const int c = k / 3, comp = k % 3;
      if (t0 + c < M) {
        float v = sums[0][c][comp];
#pragma unroll
        for (int x = 1; x < kBwdWarps; ++x) v = __fadd_rn(v, sums[x][c][comp]);
        col[3LL * t0 + k] = -v;  // db_j = sum_i c_ij (b_j - a_i)
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kBwdRows; ++u) {
    const long long n = chunk * kBwdChunk + u * kBwdThreads + threadIdx.x;
    if (n < N) {
      da[3 * n] = gx[u];
      da[3 * n + 1] = gy[u];
      da[3 * n + 2] = gz[u];
    }
  }
}

// db (B, M, 3) as the sum of the chunks' column sums, col (B, chunks, M,
// 3), in chunk order.
__global__ void emd_backward_sum_kernel(const float* __restrict__ col,
                                        float* __restrict__ db, int chunks,
                                        int M, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long per = 3LL * M, pair = t / per, k = t % per;
  const float* p = col + pair * chunks * per + k;
  float v = p[0];
  for (int c = 1; c < chunks; ++c) v = __fadd_rn(v, p[c * per]);
  db[t] = v;
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

// Row chunks of kernel 6 over N rows: when more than one, the caller
// gives a scratch col of (B, chunks, M, 3) floats.
extern "C" int gwtf_emd_backward_chunks(int N) {
  return (N + kBwdChunk - 1) / kBwdChunk;
}

// a (B, N, 3), b (B, M, 3), ratio_l (B, 9, N), ratio_r (B, 9, M) ->
// da (B, N, 3), db (B, M, 3): the gradient of the summed cost. col is the
// scratch, unused with one row chunk.
extern "C" int gwtf_emd_backward(const float* a, const float* b,
                                 const float* ratio_l, const float* ratio_r,
                                 float* da, float* db, float* col, int B,
                                 int N, int M, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int chunks = (N + kBwdChunk - 1) / kBwdChunk;
  const dim3 grid(B, chunks);
  emd_backward_kernel<<<grid, kBwdThreads, 0, stream>>>(
      a, b, ratio_l, ratio_r, da, chunks == 1 ? db : col, N, M);
  if (chunks > 1) {
    const long long total = 3LL * B * M;
    const unsigned int blocks = static_cast<unsigned int>((total + 255) / 256);
    emd_backward_sum_kernel<<<blocks, 256, 0, stream>>>(col, db, chunks, M,
                                                         total);
  }
  return static_cast<int>(cudaGetLastError());
}
