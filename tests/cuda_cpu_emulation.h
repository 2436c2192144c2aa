// A CPU stand-in for the few CUDA constructs the sources of csrc/ use, so
// that g++ can build them and their kernels can run on the CPU in the
// tests (tests/test_torch_port_*_emulated.py). Each CUDA thread
// of a block is a std::thread; the blocks of a launch run one after
// another; a barrier stands for __syncthreads and __syncwarp, and
// shuffles exchange through a per-block array between two barriers; a
// warp's register fragments (csrc/mma_bf16.cuh's frag_mma) through a
// per-warp array and a barrier of the warp. It checks the kernels'
// indexing and control flow, not their speed or the GPU's rounding.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define GWTF_CPU_EMULATION 1

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static  // one block at a time: static is per block
#define __align__(n)
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a small card: 3 SMs of 2 blocks, so that a persistent grid's blocks
// each take several tiles in the tests
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  memcpy(d, s, n);
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* d, int v, size_t n, cudaStream_t) {
  memset(d, v, n);
  return cudaSuccess;
}
// <cuda_pipeline.h>: a cp.async copy lands at once, so a stage is
// complete when it is committed
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) {
  memcpy(d, s, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline unsigned __float_as_uint(float v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float v;
  memcpy(&v, &u, sizeof v);
  return v;
}
// x86-64 without -mfma rounds each float operation once, as these do
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
constexpr int kEmuWords = 16;  // words a thread hands in to a warp exchange
struct EmuBlock {
  std::barrier<>* bar;
  std::vector<float> lanes;  // one slot per thread, for the shuffles
  std::vector<float> dyn;    // the block's dynamic shared memory
  // a barrier for each warp, and two rounds of kEmuWords words a thread
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned> words;
};
inline thread_local EmuBlock* emu_block;
inline thread_local float* emu_dyn;
inline thread_local int emu_round;  // which of the two rounds of words

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
// the warp's barrier waits on the whole block: every thread of the block
// must reach it, as for a shuffle
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->bar->arrive_and_wait();
}
// Thread t's v as thread `from` (of the same block) gave it: every
// thread of the block must reach the call. The value travels as its bits,
// so a float or an int comes back unchanged.
template <class T>
inline T emu_shuffle(T v, int from) {
  static_assert(sizeof(T) == sizeof(float), "a shuffle moves 32 bits");
  const int t = threadIdx.x;
  std::memcpy(&emu_block->lanes[t], &v, sizeof v);
  emu_block->bar->arrive_and_wait();
  T r;
  std::memcpy(&r, &emu_block->lanes[from], sizeof r);
  emu_block->bar->arrive_and_wait();
  return r;
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  const int t = threadIdx.x;
  return emu_shuffle(v, (t & ~31) | ((t & 31) ^ m));
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  const int t = threadIdx.x;
  return emu_shuffle(v, (t & ~31) | (src & 31));
}

template <class T>
inline T __shfl_down_sync(unsigned, T v, int d) {
  const int t = threadIdx.x;
  const T r = emu_shuffle(v, (t & 31) + d < 32 ? t + d : t);
  return r;
}

// Thread t hands in n <= kEmuWords words; once every thread of its warp
// has, returns the warp's 32 rows of kEmuWords words (lane i's from row
// i). Every thread of the warp must reach the call. Two rounds of words
// take turns, so that one barrier an exchange suffices: a thread writes a
// round again only after the whole warp has passed the next barrier, that
// is, has read the round.
inline const unsigned* emu_warp_exchange(const unsigned* mine, int n) {
  const int t = threadIdx.x;
  unsigned* round = emu_block->words.data() +
                    (size_t)emu_round * blockDim.x * kEmuWords;
  std::memcpy(round + (size_t)t * kEmuWords, mine, n * sizeof(unsigned));
  emu_block->warps[t / 32]->arrive_and_wait();
  emu_round ^= 1;
  return round + (size_t)(t & ~31) * kEmuWords;
}

inline dim3 emu_dim(int x) { return dim3(x); }
inline dim3 emu_dim(dim3 d) { return d; }

// kernel<<<grid, block, smem, stream>>>(args) becomes
// emu_launch(grid, block, smem, stream, [&] { kernel(args); })
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  gridDim = grid;
  blockDim = block;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(block.x);
        // shared memory starts as NaN, so a read before a write shows
        EmuBlock blk{&bar, std::vector<float>(block.x),
                     std::vector<float>(smem / sizeof(float) + 4, NAN), {},
                     std::vector<unsigned>(2 * block.x * kEmuWords)};
        for (unsigned w0 = 0; w0 < block.x; w0 += 32)
          blk.warps.emplace_back(
              new std::barrier<>(std::min(32u, block.x - w0)));
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            emu_block = &blk;
            emu_dyn = blk.dyn.data();
            emu_round = 0;
            f();
          });
        for (auto& th : threads) th.join();
      }
}
