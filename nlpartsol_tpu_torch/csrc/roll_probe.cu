// Row-wise sums of circular rolls, and a multiply-add twin: probes of what a
// lane roll costs on NVIDIA Hopper (sm_90a).
//
//   roll_sum  out[r, j] = sum_k a[r, (j - s_k) mod L], summed in k order: the
//             counterpart of the TPU lane-roll probes scripts/probe_roll.py
//             (pltpu.roll of an (8, 3456) f32 array, 10 shifts checked and
//             160 timed) and the roll+add leg of scripts/probe_roll2.py.
//   mul_sum   out[r, j] = sum_{s < n} a[r, j] * (1 + s): the mul+add leg of
//             scripts/probe_roll2.py.
//
// A TPU rolls a whole vector register across its 128 lanes.  Here a row is
// staged once in shared memory and each thread reads it at (j - s) mod L: a
// roll is an indexed shared-memory load, and a shift that is not a multiple
// of 32 costs no more than one that is (consecutive threads read
// consecutive words, so no bank conflicts either way).  What bounds both
// kernels: at these shapes (at most 40 x 3456 f32, 0.55 MB) nothing but the
// launch; the bytes and adds take well under a microsecond on an H100.
//
// Every add and multiply is explicitly rounded (__fadd_rn, __fmul_rn), so
// both kernels equal their plain PyTorch versions exactly.

#include <cuda_runtime.h>

#define MAX_SHIFTS 256
#define BLOCK 256

struct Shifts {  // 4 + 4 * 256 bytes, by value in the parameter space
  int n;
  int s[MAX_SHIFTS];  // normalised to [0, L)
};

__global__ void __launch_bounds__(BLOCK)
roll_sum_kernel(const float* __restrict__ a, float* __restrict__ out, int L, const Shifts sh) {
  extern __shared__ float row[];
  const size_t base = (size_t)blockIdx.x * L;
  for (int j = threadIdx.x; j < L; j += BLOCK) row[j] = a[base + j];
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += BLOCK) {
    float acc = 0.f;
    for (int k = 0; k < sh.n; ++k) {
      int i = j - sh.s[k];
      i += i < 0 ? L : 0;
      acc = __fadd_rn(acc, row[i]);
    }
    out[base + j] = acc;
  }
}

__global__ void __launch_bounds__(BLOCK)
mul_sum_kernel(const float* __restrict__ a, float* __restrict__ out, int L, int n_ops) {
  const size_t base = (size_t)blockIdx.x * L;
  for (int j = threadIdx.x; j < L; j += BLOCK) {
    const float x = a[base + j];
    float acc = 0.f;
    for (int s = 0; s < n_ops; ++s) acc = __fadd_rn(acc, __fmul_rn(x, (float)(1 + s)));
    out[base + j] = acc;
  }
}

// Both return a cudaError_t as int (0 = success; 1 = cudaErrorInvalidValue
// also for arguments refused here).  ``shifts`` is a HOST array.  Launch on
// ``stream``; never synchronise.
extern "C" int roll_sum(const void* a, void* out, int R, int L, const int* shifts, int n_shifts,
                        void* stream) {
  if (R < 1 || L < 1 || n_shifts < 1 || n_shifts > MAX_SHIFTS) return 1;
  if ((size_t)L * sizeof(float) > 48 * 1024) return 1;  // default shared-memory limit
  Shifts sh;
  sh.n = n_shifts;
  for (int k = 0; k < n_shifts; ++k) sh.s[k] = ((shifts[k] % L) + L) % L;
  roll_sum_kernel<<<R, BLOCK, L * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)a, (float*)out, L, sh);
  return (int)cudaGetLastError();
}

extern "C" int mul_sum(const void* a, void* out, int R, int L, int n_ops, void* stream) {
  if (R < 1 || L < 1 || n_ops < 1) return 1;
  mul_sum_kernel<<<R, BLOCK, 0, (cudaStream_t)stream>>>((const float*)a, (float*)out, L, n_ops);
  return (int)cudaGetLastError();
}
