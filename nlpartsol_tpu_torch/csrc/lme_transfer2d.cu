// Fused 2D LME particle<->grid transfer kernels for NVIDIA Hopper (sm_90a).
//
//   lme_scatter2d  LME basis (optional lambda-Newton) + P2G: replaces the TPU
//                  kernel nlpartsol_tpu/ops/pallas_transfer.py::fused_scatter
//                  (body _make_scatter_kernel).
//   lme_gather2d   LME basis at fixed lambda + G2P: replaces
//                  nlpartsol_tpu/ops/pallas_transfer.py::fused_gather
//                  (body _make_gather_kernel).
//
// Design.  One thread per slot.  Slot arrays are channel-leading (ch, C, nc)
// with slot = rank*nc + cell and the cell index fastest along box axis 1, so
// the threads of a warp read neighbouring addresses and, for one window
// offset, touch neighbouring nodes.  No per-edge tensor ever reaches device
// memory: the basis is recomputed in registers for every sweep over the
// window (recompute over store keeps the register count flat in the window
// size).  The window is the static, radius-culled offset list of the slot's
// cell; it is passed by value and so lives in the constant bank, where a
// warp-uniform read is a broadcast.  The cell comes from the slot index,
// never from the position: with a drift margin the particle may sit in a
// neighbouring cell, and the radius mask r^2 <= R^2 alone keeps the basis
// exact.
//
// What bounds them.  The function needs little: each slot channel and each
// node once (11-19 MB at 405,600 slots) and 0.25-0.45 GFLOP (window test once
// per slot and offset, f/exp/moments once per evaluation of the basis), a few
// microseconds either way on an H100, operations slightly ahead of bytes.
// These kernels take 13-26 times that, and spend it on operations: recompute
// over store means the window test and f/exp run again in each of the three
// sweeps (max, moments, emit), about 60% of the tested offsets lie outside
// the support radius, and the scatter ends in one f32 atomic add into L2 per
// edge and channel.  This first version does nothing about the atomics (no
// shared-memory tile accumulation, no vector atomics); it keeps the sweeps
// few: a converged Newton iteration's moments are reused for the basis, so a
// warm-started slot makes 2 sweeps for lambda and 1 to emit.
//
// Mask arithmetic (node position, r^2) uses explicitly rounded operations
// (__fmul_rn, __fadd_rn, __fsub_rn) so that it is bit-identical to the plain
// PyTorch version and the two agree on every borderline edge (equal nnz).

#include <cuda_runtime.h>

#define MAX_PAIRS 192
#define MAX_CN 8
#define NEG_BIG (-1e30f)
#define BLOCK 128

struct Window {
  int n;
  signed char o0[MAX_PAIRS];
  signed char o1[MAX_PAIRS];
};

struct Geom {
  int Ns, nc, c1;          // slots, cells, cells along box axis 1
  int b0, b1;              // box cell origin (grid frame)
  int n1;                  // nodes along grid axis 1
  int lo0, hi0, lo1, hi1;  // inclusive valid node-index bounds
  float h, beta, r2max, org0, org1;
};

struct Slot {
  float x0, x1;    // particle position
  int i0, i1;      // node multi-index of the slot cell's lower corner
  float lam0, lam1;
};

struct Moments {
  float fmax, S0, S10, S11, S200, S201, S211;
};

// One window edge: relative position, r^2, flat node id; true if the node is
// valid and inside the support radius.
__device__ __forceinline__ bool edge(const Geom& g, const Slot& s, int o0, int o1,
                                     float& r0, float& r1, float& r2, int& node) {
  const int i0 = s.i0 + o0, i1 = s.i1 + o1;
  r0 = __fsub_rn(s.x0, __fadd_rn(__fmul_rn((float)i0, g.h), g.org0));
  r1 = __fsub_rn(s.x1, __fadd_rn(__fmul_rn((float)i1, g.h), g.org1));
  r2 = __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1));
  node = i0 * g.n1 + i1;
  return (i0 >= g.lo0) & (i0 <= g.hi0) & (i1 >= g.lo1) & (i1 <= g.hi1) & (r2 <= g.r2max);
}

__device__ __forceinline__ float fval(const Geom& g, const Slot& s, float r0, float r1, float r2) {
  return -g.beta * r2 + s.lam0 * r0 + s.lam1 * r1;
}

// Two sweeps: max of f over the valid edges, then the e-weighted moments
// S0 = sum e, S1 = sum e*l, S2 = sum e*l(x)l with e = exp(f - fmax).
// Returns the number of valid edges.
template <bool NEED_MOMENTS>
__device__ __forceinline__ int sweep_moments(const Geom& g, const Window& w, const Slot& s,
                                             Moments& m) {
  float fmax = NEG_BIG;
  int cnt = 0;
  for (int k = 0; k < w.n; ++k) {
    float r0, r1, r2; int node;
    if (edge(g, s, w.o0[k], w.o1[k], r0, r1, r2, node)) {
      fmax = fmaxf(fmax, fval(g, s, r0, r1, r2));
      ++cnt;
    }
  }
  float S0 = 0.f, S10 = 0.f, S11 = 0.f, S200 = 0.f, S201 = 0.f, S211 = 0.f;
  for (int k = 0; k < w.n; ++k) {
    float r0, r1, r2; int node;
    if (edge(g, s, w.o0[k], w.o1[k], r0, r1, r2, node)) {
      const float e = expf(fval(g, s, r0, r1, r2) - fmax);
      S0 += e;
      if (NEED_MOMENTS) {
        S10 += e * r0;
        S11 += e * r1;
        S200 += e * r0 * r0;
        S201 += e * r0 * r1;
        S211 += e * r1 * r1;
      }
    }
  }
  m.fmax = fmax; m.S0 = S0; m.S10 = S10; m.S11 = S11;
  m.S200 = S200; m.S201 = S201; m.S211 = S211;
  return cnt;
}

// r = S1/Z, J = S2/Z - r(x)r and the damped closed-form symmetric inverse
// of J (the damping replaces an abort on a near-singular Hessian).
__device__ __forceinline__ void r_and_Jinv(const Moments& m, float& r0, float& r1,
                                           float& i00, float& i01, float& i11) {
  const float Zs = fmaxf(m.S0, 1e-30f);
  r0 = m.S10 / Zs;
  r1 = m.S11 / Zs;
  float j00 = m.S200 / Zs - r0 * r0;
  const float j01 = m.S201 / Zs - r0 * r1;
  float j11 = m.S211 / Zs - r1 * r1;
  const float eps = 1e-10f * fmaxf(j00 + j11, 1e-30f);
  j00 += eps;
  j11 += eps;
  float det = j00 * j11 - j01 * j01;
  det = fabsf(det) > 1e-30f ? det : 1e-30f;
  const float inv = 1.0f / det;
  i00 = j11 * inv;
  i01 = -j01 * inv;
  i11 = j00 * inv;
}

__device__ __forceinline__ bool load_slot(const Geom& g, int s, const float* __restrict__ x,
                                          const float* __restrict__ lam,
                                          const float* __restrict__ act, Slot& sl) {
  sl.lam0 = lam[s];
  sl.lam1 = lam[g.Ns + s];
  if (!(act[s] > 0.5f)) return false;
  const int cell = s % g.nc;
  sl.i0 = g.b0 + cell / g.c1;
  sl.i1 = g.b1 + cell % g.c1;
  sl.x0 = x[s];
  sl.x1 = x[g.Ns + s];
  return true;
}

struct ScatterIO {
  const float* x;      // (2, Ns)
  const float* lam;    // (2, Ns) warm start
  const float* act;    // (1, Ns) 0/1
  const float* fN;     // (cN, Ns) N-weighted channels
  const float* G;      // (4, Ns) row-major 2x2, or null
  float* nodes;        // (n_nodes, cout), zero-initialised
  float* lam_out;      // (2, Ns)
  int* cnt;            // [valid edges, Newton iterations], zero-initialised
  int cN, cout, has_G, gnorm, max_iter;
  float tol2;
};

template <bool SOLVE, bool NEED_DN>
__global__ void __launch_bounds__(BLOCK)
lme_scatter2d_kernel(const Geom g, const Window w, const ScatterIO io) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  int n_edges = 0, n_iter = 0;
  if (s < g.Ns) {
    Slot sl;
    const bool active = load_slot(g, s, io.x, io.lam, io.act, sl);
    if (active) {
      Moments m;
      bool fresh = false;  // m holds the moments at the current lambda
      if (SOLVE) {
        for (int it = 0; it < io.max_iter; ++it) {
          n_edges = sweep_moments<true>(g, w, sl, m);
          ++n_iter;
          float r0, r1, i00, i01, i11;
          r_and_Jinv(m, r0, r1, i00, i01, i11);
          const float rn2 = m.S0 > 0.f ? r0 * r0 + r1 * r1 : 0.f;
          if (rn2 <= io.tol2) { fresh = true; break; }
          sl.lam0 -= i00 * r0 + i01 * r1;
          sl.lam1 -= i01 * r0 + i11 * r1;
        }
      }
      if (!fresh) n_edges = sweep_moments<NEED_DN>(g, w, sl, m);

      const float Zs = fmaxf(m.S0, 1e-30f);
      float rb0 = 0.f, rb1 = 0.f, i00 = 0.f, i01 = 0.f, i11 = 0.f;
      if (NEED_DN) r_and_Jinv(m, rb0, rb1, i00, i01, i11);

      float fv[MAX_CN];
#pragma unroll
      for (int c = 0; c < MAX_CN; ++c) fv[c] = c < io.cN ? io.fN[c * g.Ns + s] : 0.f;
      float g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f, sg = 0.f;
      if (NEED_DN) {
        if (io.has_G) {
          g00 = io.G[s]; g01 = io.G[g.Ns + s];
          g10 = io.G[2 * g.Ns + s]; g11 = io.G[3 * g.Ns + s];
        }
        if (io.gnorm) sg = io.fN[(io.cN - 1) * g.Ns + s];
      }

      for (int k = 0; k < w.n; ++k) {
        float r0, r1, r2; int node;
        if (!edge(g, sl, w.o0[k], w.o1[k], r0, r1, r2, node)) continue;
        const float N = expf(fval(g, sl, r0, r1, r2) - m.fmax) / Zs;
        float* out = io.nodes + (size_t)node * io.cout;
#pragma unroll
        for (int c = 0; c < MAX_CN; ++c)
          if (c < io.cN) atomicAdd(out + c, N * fv[c]);
        if (NEED_DN) {
          const float a0 = r0 - rb0, a1 = r1 - rb1;
          const float dn0 = -N * (i00 * a0 + i01 * a1);
          const float dn1 = -N * (i01 * a0 + i11 * a1);
          if (io.has_G) {
            atomicAdd(out + io.cN, g00 * dn0 + g01 * dn1);
            atomicAdd(out + io.cN + 1, g10 * dn0 + g11 * dn1);
          }
          if (io.gnorm) atomicAdd(out + io.cout - 1, sg * (dn0 * dn0 + dn1 * dn1));
        }
      }
    }
    // an inactive slot passes its lambda through unchanged
    io.lam_out[s] = sl.lam0;
    io.lam_out[g.Ns + s] = sl.lam1;
  }
  // one integer atomic per warp and counter
  n_edges = __reduce_add_sync(0xffffffffu, n_edges);
  n_iter = __reduce_add_sync(0xffffffffu, n_iter);
  if ((threadIdx.x & 31) == 0) {
    if (n_edges) atomicAdd(io.cnt, n_edges);
    if (n_iter) atomicAdd(io.cnt + 1, n_iter);
  }
}

struct GatherIO {
  const float* x;      // (2, Ns)
  const float* lam;    // (2, Ns) converged
  const float* act;    // (1, Ns)
  const float* gN;     // (n_nodes, cN) or null
  const float* gg;     // (n_nodes, 2) or null
  float* outN;         // (Ns, cN)
  float* outG;         // (Ns, 2, 2): outG[s,i,j] = sum_A gg[A,i] dN_A/dx_j
  int cN;
};

template <bool HAS_N, bool HAS_GRAD>
__global__ void __launch_bounds__(BLOCK)
lme_gather2d_kernel(const Geom g, const Window w, const GatherIO io) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= g.Ns) return;
  float acc[MAX_CN];
#pragma unroll
  for (int c = 0; c < MAX_CN; ++c) acc[c] = 0.f;
  float G00 = 0.f, G01 = 0.f, G10 = 0.f, G11 = 0.f;
  Slot sl;
  if (load_slot(g, s, io.x, io.lam, io.act, sl)) {
    Moments m;
    sweep_moments<HAS_GRAD>(g, w, sl, m);
    const float Zs = fmaxf(m.S0, 1e-30f);
    float rb0 = 0.f, rb1 = 0.f, i00 = 0.f, i01 = 0.f, i11 = 0.f;
    if (HAS_GRAD) r_and_Jinv(m, rb0, rb1, i00, i01, i11);
    for (int k = 0; k < w.n; ++k) {
      float r0, r1, r2; int node;
      if (!edge(g, sl, w.o0[k], w.o1[k], r0, r1, r2, node)) continue;
      const float N = expf(fval(g, sl, r0, r1, r2) - m.fmax) / Zs;
      if (HAS_N) {
        const float* f = io.gN + (size_t)node * io.cN;
#pragma unroll
        for (int c = 0; c < MAX_CN; ++c)
          if (c < io.cN) acc[c] += N * __ldg(f + c);
      }
      if (HAS_GRAD) {
        const float a0 = r0 - rb0, a1 = r1 - rb1;
        const float dn0 = -N * (i00 * a0 + i01 * a1);
        const float dn1 = -N * (i01 * a0 + i11 * a1);
        const float2 u = __ldg(reinterpret_cast<const float2*>(io.gg) + node);
        G00 += u.x * dn0; G01 += u.x * dn1;
        G10 += u.y * dn0; G11 += u.y * dn1;
      }
    }
  }
  // inactive slots write zeros
  if (HAS_N) {
#pragma unroll
    for (int c = 0; c < MAX_CN; ++c)
      if (c < io.cN) io.outN[(size_t)s * io.cN + c] = acc[c];
  }
  if (HAS_GRAD) reinterpret_cast<float4*>(io.outG)[s] = make_float4(G00, G01, G10, G11);
}

static int fill_window(Window& w, const int* offs, int n_offs) {
  if (n_offs < 1 || n_offs > MAX_PAIRS) return 1;
  w.n = n_offs;
  for (int k = 0; k < n_offs; ++k) {
    const int a = offs[2 * k], b = offs[2 * k + 1];
    if (a < -127 || a > 127 || b < -127 || b > 127) return 1;
    w.o0[k] = (signed char)a;
    w.o1[k] = (signed char)b;
  }
  return 0;
}

static Geom make_geom(int Ns, int nc, int c1, int b0, int b1, int n1, int lo0, int hi0,
                      int lo1, int hi1, float h, float beta, float r2max, float org0,
                      float org1) {
  Geom g;
  g.Ns = Ns; g.nc = nc; g.c1 = c1; g.b0 = b0; g.b1 = b1; g.n1 = n1;
  g.lo0 = lo0; g.hi0 = hi0; g.lo1 = lo1; g.hi1 = hi1;
  g.h = h; g.beta = beta; g.r2max = r2max; g.org0 = org0; g.org1 = org1;
  return g;
}

// Both entry points return a cudaError_t as int (0 = success; 1 =
// cudaErrorInvalidValue also for arguments refused here).  ``offs`` is a HOST
// array of n_offs (o0, o1) pairs.  Launches on ``stream``; never synchronises.
extern "C" int lme_scatter2d(
    const void* x, const void* lam, const void* act, const void* fN, const void* G,
    void* nodes, void* lam_out, void* cnt,
    int Ns, int nc, int c1, int b0, int b1, int n1, int lo0, int hi0, int lo1, int hi1,
    float h, float beta, float r2max, float org0, float org1,
    const int* offs, int n_offs,
    int cN, int has_G, int gnorm, int solve, int max_iter, float tol2, void* stream) {
  Window w;
  if (fill_window(w, offs, n_offs)) return 1;
  if (cN < 1 || cN > MAX_CN || Ns < 1) return 1;
  const Geom g = make_geom(Ns, nc, c1, b0, b1, n1, lo0, hi0, lo1, hi1, h, beta, r2max, org0, org1);
  ScatterIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.fN = (const float*)fN; io.G = (const float*)G;
  io.nodes = (float*)nodes; io.lam_out = (float*)lam_out; io.cnt = (int*)cnt;
  io.cN = cN; io.has_G = has_G; io.gnorm = gnorm;
  io.cout = cN + (has_G ? 2 : 0) + (gnorm ? 1 : 0);
  io.max_iter = max_iter; io.tol2 = tol2;
  const dim3 grid((Ns + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  const bool need_dn = has_G || gnorm;
  if (solve && need_dn) lme_scatter2d_kernel<true, true><<<grid, block, 0, st>>>(g, w, io);
  else if (solve) lme_scatter2d_kernel<true, false><<<grid, block, 0, st>>>(g, w, io);
  else if (need_dn) lme_scatter2d_kernel<false, true><<<grid, block, 0, st>>>(g, w, io);
  else lme_scatter2d_kernel<false, false><<<grid, block, 0, st>>>(g, w, io);
  return (int)cudaGetLastError();
}

extern "C" int lme_gather2d(
    const void* x, const void* lam, const void* act, const void* gN, const void* gg,
    void* outN, void* outG,
    int Ns, int nc, int c1, int b0, int b1, int n1, int lo0, int hi0, int lo1, int hi1,
    float h, float beta, float r2max, float org0, float org1,
    const int* offs, int n_offs, int cN, void* stream) {
  Window w;
  if (fill_window(w, offs, n_offs)) return 1;
  const bool has_n = gN != nullptr, has_grad = gg != nullptr;
  if ((!has_n && !has_grad) || (has_n && (cN < 1 || cN > MAX_CN)) || Ns < 1) return 1;
  const Geom g = make_geom(Ns, nc, c1, b0, b1, n1, lo0, hi0, lo1, hi1, h, beta, r2max, org0, org1);
  GatherIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.gN = (const float*)gN; io.gg = (const float*)gg;
  io.outN = (float*)outN; io.outG = (float*)outG; io.cN = has_n ? cN : 0;
  const dim3 grid((Ns + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  if (has_n && has_grad) lme_gather2d_kernel<true, true><<<grid, block, 0, st>>>(g, w, io);
  else if (has_n) lme_gather2d_kernel<true, false><<<grid, block, 0, st>>>(g, w, io);
  else lme_gather2d_kernel<false, true><<<grid, block, 0, st>>>(g, w, io);
  return (int)cudaGetLastError();
}
