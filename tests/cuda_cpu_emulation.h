// A CPU stand-in for the few CUDA constructs csrc/train_decode.cu uses, so
// that g++ can build that source and its kernels can run on the CPU in the
// tests (tests/test_torch_port_train_decode_emulated.py). Each CUDA thread
// of a block is a std::thread; the blocks of a launch run one after
// another; a barrier stands for __syncthreads, and shuffles exchange
// through a per-block array between two barriers. It checks the kernels'
// indexing and control flow, not their speed or the GPU's rounding.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
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
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  memcpy(d, s, n);
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* d, int v, size_t n, cudaStream_t) {
  memset(d, v, n);
  return cudaSuccess;
}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct EmuBlock {
  std::barrier<>* bar;
  std::vector<float> lanes;  // one slot per thread, for the shuffles
  std::vector<float> dyn;    // the block's dynamic shared memory
};
inline thread_local EmuBlock* emu_block;
inline thread_local float* emu_dyn;

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  const int t = threadIdx.x;
  emu_block->lanes[t] = v;
  emu_block->bar->arrive_and_wait();
  const float r = emu_block->lanes[(t & ~31) | ((t & 31) ^ m)];
  emu_block->bar->arrive_and_wait();
  return r;
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
                     std::vector<float>(smem / sizeof(float) + 4, NAN)};
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            emu_block = &blk;
            emu_dyn = blk.dyn.data();
            f();
          });
        for (auto& th : threads) th.join();
      }
}
