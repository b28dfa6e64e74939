// CPU emulation of the CUDA features lme_transfer2d.cu and lme_transfer3d.cu
// use: one std::thread per CUDA thread, std::barrier for __syncthreads and
// warp reductions.
//
// It serves those two sources and no other.  The tests rewrite a source
// with regexes (a launch <<<...>>> whose arguments hold no '>', one
// `extern __shared__` array), and every stand-in here copies one feature
// faithfully.  When a source comes to use a feature this header cannot copy
// faithfully (shuffles, cp.async, wgmma, ...), drop its emulated test rather
// than grow this header.
#pragma once
#include <math.h>
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>
#include <algorithm>
#include <cstring>
#include <memory>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __ldg(const float* p) { return *p; }
inline float2 __ldg(const float2* p) { return *p; }
inline int __float2int_ru(float x) { return (int)ceilf(x); }
inline int __float2int_rd(float x) { return (int)floorf(x); }
using std::max;
using std::min;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::barrier<>*> warp_bar;
  std::vector<int> warp_val;
  float* shared;
};
inline EmuBlock* g_blk;  // one block runs at a time
inline void __syncthreads() { g_blk->bar->arrive_and_wait(); }
inline int __reduce_add_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_blk->warp_val[threadIdx.x] = v;
  g_blk->warp_bar[w]->arrive_and_wait();
  int s = 0;
  for (int i = 0; i < 32; ++i) s += g_blk->warp_val[w * 32 + i];
  g_blk->warp_bar[w]->arrive_and_wait();
  (void)l;
  return s;
}
#define EMU_SHARED(type, name) type* name = (type*)g_blk->shared
template <class K, class... A>
void emu_launch(K k, dim3 grid, dim3 block, int smem, cudaStream_t, A... args) {
  for (unsigned b = 0; b < grid.x; ++b) {
    std::barrier<> bar(block.x);
    EmuBlock blk;
    blk.bar = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> wb;
    for (unsigned w = 0; w < block.x / 32; ++w) wb.emplace_back(new std::barrier<>(32));
    for (auto& x : wb) blk.warp_bar.push_back(x.get());
    blk.warp_val.assign(block.x, 0);
    std::vector<float> sh(smem / 4 + 1, 12345.f);  // garbage until zeroed
    blk.shared = sh.data();
    g_blk = &blk;
    std::vector<std::thread> th;
    for (unsigned t = 0; t < block.x; ++t)
      th.emplace_back([=] { threadIdx = dim3(t); blockIdx = dim3(b); k(args...); });
    for (auto& x : th) x.join();
  }
}
