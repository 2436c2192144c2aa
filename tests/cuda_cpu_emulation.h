// A CPU stand-in for the few CUDA constructs the sources of csrc/ use, so
// that g++ can build them and their kernels can run on the CPU in the
// tests (tests/test_torch_port_*_emulated.py). Each CUDA thread of a
// block is a cooperative user-space thread (a fiber, on its own stack)
// and the block's fibers take turns on the calling OS thread; the
// blocks of a launch run one after another. A fiber runs until it
// reaches a barrier: __syncthreads and __syncwarp wait on the block's,
// shuffles exchange through a per-block array between two of them, and
// a warp's register fragments (csrc/mma_bf16.cuh's frag_mma) through a
// per-warp array and a barrier of the warp. Between barriers the fibers
// run in an order drawn anew for every block of every launch, so that a
// missing barrier changes the result from one launch to the next; a
// block whose fibers all wait on barriers that cannot complete aborts
// with a message. It checks the kernels' indexing and control flow, not
// their speed or the GPU's rounding.
#pragma once
#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
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

// A fiber's saved context, and the switch from one to another: the
// callee-saved registers pushed on the old stack and its stack pointer
// saved, then the new stack's popped. No system call: ucontext's
// swapcontext, which saves and restores the signal mask at every
// switch, made the emulated tests about twice as slow.
#if !defined(__x86_64__)
#error "the emulation's context switch is written for x86-64"
#endif
struct EmuContext {
  void* sp;
};
extern "C" void emu_switch(void** save_sp, void* sp);
asm(R"(
  .pushsection .text
  .weak emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
  .popsection
)");
inline void emu_swap(EmuContext* from, EmuContext* to) {
  emu_switch(&from->sp, to->sp);
}
// a context that enters entry() on the stack [base, base + size): six
// zero registers for emu_switch to pop, then entry as its return address,
// placed so that entry starts as a called function does (rsp = 8 mod 16)
inline void emu_make(EmuContext* c, char* base, size_t size,
                     void (*entry)()) {
  auto* top = reinterpret_cast<void**>(
      (reinterpret_cast<uintptr_t>(base + size) & ~uintptr_t(15)) - 8);
  *--top = reinterpret_cast<void*>(entry);
  for (int i = 0; i < 6; ++i) *--top = nullptr;
  c->sp = top;
}

// A barrier of `count` fibers: the last to arrive starts a new generation,
// which releases the others
struct EmuBarrier {
  unsigned count = 0, arrived = 0, generation = 0;
};
struct EmuFiber {
  EmuContext ctx;
  int round = 0;  // which of the two rounds of warp-exchange words
  const EmuBarrier* wait = nullptr;
  unsigned gen = 0;  // the generation of `wait` it arrived in
  bool done = false;
};
struct EmuBlock {
  EmuBarrier bar;
  std::vector<float> lanes;  // one slot per thread, for the shuffles
  std::vector<float> dyn;    // the block's dynamic shared memory
  // a barrier for each warp, and two rounds of kEmuWords words a thread
  std::vector<EmuBarrier> warps;
  std::vector<unsigned> words;
};
inline thread_local EmuBlock* emu_block;
inline thread_local float* emu_dyn;
inline thread_local EmuFiber* emu_fiber;      // the fiber that runs
inline thread_local EmuContext* emu_sched;    // the block's scheduler
inline thread_local void (*emu_body)(void*);  // the kernel of the launch
inline thread_local void* emu_body_arg;

// Arrive at b and hand the OS thread back to the scheduler, which resumes
// this fiber once b's generation has moved on.
inline void emu_wait(EmuBarrier& b) {
  EmuFiber* me = emu_fiber;
  me->wait = &b;
  me->gen = b.generation;
  if (++b.arrived == b.count) {
    b.arrived = 0;
    ++b.generation;
  }
  emu_swap(&me->ctx, emu_sched);
}

inline void __syncthreads() { emu_wait(emu_block->bar); }
// the warp's barrier waits on the whole block: every thread of the block
// must reach it, as for a shuffle
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wait(emu_block->bar); }
// Thread t's v as thread `from` (of the same block) gave it: every
// thread of the block must reach the call. The value travels as its bits,
// so a float or an int comes back unchanged.
template <class T>
inline T emu_shuffle(T v, int from) {
  static_assert(sizeof(T) == sizeof(float), "a shuffle moves 32 bits");
  const int t = threadIdx.x;
  std::memcpy(&emu_block->lanes[t], &v, sizeof v);
  emu_wait(emu_block->bar);
  T r;
  std::memcpy(&r, &emu_block->lanes[from], sizeof r);
  emu_wait(emu_block->bar);
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
                    (size_t)emu_fiber->round * blockDim.x * kEmuWords;
  std::memcpy(round + (size_t)t * kEmuWords, mine, n * sizeof(unsigned));
  emu_wait(emu_block->warps[t / 32]);
  emu_fiber->round ^= 1;
  return round + (size_t)(t & ~31) * kEmuWords;
}

inline dim3 emu_dim(int x) { return dim3(x); }
inline dim3 emu_dim(dim3 d) { return d; }

// The fibers' stacks, kept by the OS thread from one launch to the next:
// reserved address space, touched only as deep as a kernel goes, below
// each a page that faults on an overflow
constexpr size_t kEmuStack = size_t(1) << 20;
inline char* emu_stack(unsigned i) {
  static thread_local std::vector<char*> stacks;
  while (stacks.size() <= i) {
    const size_t page = 4096;
    void* p = mmap(nullptr, kEmuStack + page, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      std::fprintf(stderr, "emulation: no room for a fiber's stack\n");
      std::abort();
    }
    mprotect(p, page, PROT_NONE);
    stacks.push_back(static_cast<char*>(p) + page);
  }
  return stacks[i];
}

// a fiber's whole life: the kernel, then back to the scheduler for good
inline void emu_fiber_main() {
  emu_body(emu_body_arg);
  emu_fiber->done = true;
  emu_swap(&emu_fiber->ctx, emu_sched);
}

// Every block's order of fibers is a permutation drawn from a count of
// the blocks run so far in the process
inline std::atomic<unsigned> emu_blocks_run{0};

// kernel<<<grid, block, smem, stream>>>(args) becomes
// emu_launch(grid, block, smem, stream, [&] { kernel(args); })
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x;
  std::vector<EmuFiber> fibers(n);
  std::vector<unsigned> order(n);
  EmuContext sched;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        // shared memory starts as NaN, so a read before a write shows
        EmuBlock blk{{n}, std::vector<float>(n),
                     std::vector<float>(smem / sizeof(float) + 4, NAN), {},
                     std::vector<unsigned>(2 * n * kEmuWords)};
        for (unsigned w0 = 0; w0 < n; w0 += 32)
          blk.warps.push_back({std::min(32u, n - w0)});
        blockIdx = dim3(bx, by, bz);
        emu_block = &blk;
        emu_dyn = blk.dyn.data();
        emu_sched = &sched;
        emu_body = [](void* g) { (*static_cast<F*>(g))(); };
        emu_body_arg = &f;
        for (unsigned t = 0; t < n; ++t) {
          EmuFiber& fb = fibers[t];
          fb.round = 0;
          fb.wait = nullptr;
          fb.done = false;
          emu_make(&fb.ctx, emu_stack(t), kEmuStack, emu_fiber_main);
          order[t] = t;
        }
        std::shuffle(order.begin(), order.end(),
                     std::minstd_rand(1 + emu_blocks_run++));
        for (unsigned live = n; live;) {
          bool ran = false;
          for (unsigned t : order) {
            EmuFiber& fb = fibers[t];
            if (fb.done || (fb.wait && fb.wait->generation == fb.gen))
              continue;
            fb.wait = nullptr;
            threadIdx = dim3(t);
            emu_fiber = &fb;
            emu_swap(&sched, &fb.ctx);
            ran = true;
            live -= fb.done;
          }
          if (!ran) {
            std::fprintf(stderr,
                         "emulation: block (%u, %u, %u) deadlocked: %u of "
                         "its %u threads wait on barriers that the others "
                         "never reach\n",
                         bx, by, bz, live, n);
            std::abort();
          }
        }
      }
}
