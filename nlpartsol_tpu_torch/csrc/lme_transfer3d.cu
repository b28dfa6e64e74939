// Fused 3D LME particle<->grid transfer kernels for NVIDIA Hopper (sm_90a).
//
//   lme_scatter3d  LME basis (optional lambda-Newton, 3x3) + P2G: replaces
//                  the TPU kernels of nlpartsol_tpu/ops/pallas_transfer3d.py
//                  fused_scatter3 (rows layout, body _make_scatter_kernel3)
//                  and _scatter_pallas3m (merged-lane layout, body
//                  _make_scatter_kernel3m).
//   lme_gather3d   LME basis at fixed lambda + G2P: replaces fused_gather3
//                  (body _make_gather_kernel3) and _gather_pallas3m (body
//                  _make_gather_kernel3m) of the same file.
//
// The two TPU layouts of each direction are two arrangements of slots over
// vector lanes, chosen by the size of the TPU's vector memory; they compute
// the same function.  On this card one thread per slot serves both.
//
// Design (as lme_transfer2d.cu).  Slot arrays are channel-leading (ch, C, nc)
// with slot = rank*nc + cell and the cell index fastest along box axis 2, so
// the threads of a warp read neighbouring addresses and, for one window
// offset, touch neighbouring nodes.  No per-edge tensor reaches device
// memory: the basis is recomputed in registers in each sweep over the
// window.  The window is the static, radius-culled offset list of the slot's
// cell (160 offsets at margin 0, 432 at margin 1, gamma = 3), passed by value
// as int8 triples, so it lives in the constant bank and a warp-uniform read
// is a broadcast.  The cell comes from the slot index, never from the
// position: with a drift margin the particle may sit in a neighbouring cell,
// and the radius mask r^2 <= R^2 alone keeps the basis exact.
//
// What bounds them.  The function needs each slot channel and node once and,
// per active slot, the window test once per offset and f/exp/moments once
// per evaluation of the basis: 0.4-1.0 GFLOP and 18-28 MB a call at 281,216
// slots, 6-15 microseconds on an H100, operations ahead of bytes.  These
// kernels take 14-28 times that and spend it on operations, because
// recompute over store repeats the window test and f/exp in each of the
// three sweeps (max, moments, emit) and about 45 % of the tested offsets
// lie outside the support radius; the scatter ends in
// one f32 atomic add into L2 per edge and channel.  A converged Newton
// iteration's moments are reused for the basis.  Nothing is done yet about
// atomic contention or the repeated sweeps (shared-memory tiles are later
// work).
//
// Mask arithmetic (node position, r, r^2, summed axis by axis) uses
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fsub_rn) so that it
// is bit-identical to the plain PyTorch version and the two agree on every
// borderline edge (equal nnz).

#include <cuda_runtime.h>

#define MAX_TRIPS 512
#define MAX_CN 8
#define NEG_BIG (-1e30f)
#define BLOCK 128

struct Window {  // 4 + 3 * 512 bytes: well inside the 4 KB parameter space
  int n;
  signed char o0[MAX_TRIPS];
  signed char o1[MAX_TRIPS];
  signed char o2[MAX_TRIPS];
};

struct Geom {
  int Ns, nc, c1, c2;               // slots, cells, cells along box axes 1, 2
  int b0, b1, b2;                   // box cell origin (grid frame)
  int n1, n2;                       // nodes along grid axes 1, 2
  int lo0, hi0, lo1, hi1, lo2, hi2; // inclusive valid node-index bounds
  float h, beta, r2max, org0, org1, org2;
};

struct Slot {
  float x0, x1, x2;  // particle position
  int i0, i1, i2;    // node multi-index of the slot cell's lower corner
  float lam0, lam1, lam2;
};

struct Moments {  // S2 holds the symmetric second moment: 00 01 02 11 12 22
  float fmax, S0, S1[3], S2[6];
};

// One window edge: relative position, flat node id; true if the node is
// valid and inside the support radius.
__device__ __forceinline__ bool edge(const Geom& g, const Slot& s, int o0, int o1, int o2,
                                     float& r0, float& r1, float& r2, float& sq, int& node) {
  const int i0 = s.i0 + o0, i1 = s.i1 + o1, i2 = s.i2 + o2;
  r0 = __fsub_rn(s.x0, __fadd_rn(__fmul_rn((float)i0, g.h), g.org0));
  r1 = __fsub_rn(s.x1, __fadd_rn(__fmul_rn((float)i1, g.h), g.org1));
  r2 = __fsub_rn(s.x2, __fadd_rn(__fmul_rn((float)i2, g.h), g.org2));
  sq = __fadd_rn(__fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)), __fmul_rn(r2, r2));
  node = (i0 * g.n1 + i1) * g.n2 + i2;
  return (i0 >= g.lo0) & (i0 <= g.hi0) & (i1 >= g.lo1) & (i1 <= g.hi1) &
         (i2 >= g.lo2) & (i2 <= g.hi2) & (sq <= g.r2max);
}

__device__ __forceinline__ float fval(const Geom& g, const Slot& s, float r0, float r1,
                                      float r2, float sq) {
  return -g.beta * sq + s.lam0 * r0 + s.lam1 * r1 + s.lam2 * r2;
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
    float r0, r1, r2, sq; int node;
    if (edge(g, s, w.o0[k], w.o1[k], w.o2[k], r0, r1, r2, sq, node)) {
      fmax = fmaxf(fmax, fval(g, s, r0, r1, r2, sq));
      ++cnt;
    }
  }
  float S0 = 0.f, S1[3] = {0.f, 0.f, 0.f}, S2[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < w.n; ++k) {
    float r0, r1, r2, sq; int node;
    if (edge(g, s, w.o0[k], w.o1[k], w.o2[k], r0, r1, r2, sq, node)) {
      const float e = expf(fval(g, s, r0, r1, r2, sq) - fmax);
      S0 += e;
      if (NEED_MOMENTS) {
        const float e0 = e * r0, e1 = e * r1, e2 = e * r2;
        S1[0] += e0; S1[1] += e1; S1[2] += e2;
        S2[0] += e0 * r0; S2[1] += e0 * r1; S2[2] += e0 * r2;
        S2[3] += e1 * r1; S2[4] += e1 * r2; S2[5] += e2 * r2;
      }
    }
  }
  m.fmax = fmax; m.S0 = S0;
#pragma unroll
  for (int i = 0; i < 3; ++i) m.S1[i] = S1[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) m.S2[i] = S2[i];
  return cnt;
}

// r = S1/Z, J = S2/Z - r(x)r and the damped closed-form symmetric inverse of
// J (pallas_transfer3d.py::_inv3_damped: eps = 1e-10 tr J on the diagonal,
// |det| clamped at 1e-30; the damping replaces an abort on a near-singular
// Hessian).  inv holds the 6 unique entries 00 01 02 11 12 22.
__device__ __forceinline__ void r_and_Jinv(const Moments& m, float r[3], float inv[6]) {
  const float Zs = fmaxf(m.S0, 1e-30f);
  r[0] = m.S1[0] / Zs; r[1] = m.S1[1] / Zs; r[2] = m.S1[2] / Zs;
  float j00 = m.S2[0] / Zs - r[0] * r[0];
  const float j01 = m.S2[1] / Zs - r[0] * r[1];
  const float j02 = m.S2[2] / Zs - r[0] * r[2];
  float j11 = m.S2[3] / Zs - r[1] * r[1];
  const float j12 = m.S2[4] / Zs - r[1] * r[2];
  float j22 = m.S2[5] / Zs - r[2] * r[2];
  const float eps = 1e-10f * fmaxf(j00 + j11 + j22, 1e-30f);
  j00 += eps; j11 += eps; j22 += eps;
  const float a00 = j11 * j22 - j12 * j12;
  const float a01 = -(j01 * j22 - j02 * j12);
  const float a02 = j01 * j12 - j02 * j11;
  const float a11 = j00 * j22 - j02 * j02;
  const float a12 = -(j00 * j12 - j01 * j02);
  const float a22 = j00 * j11 - j01 * j01;
  float det = j00 * a00 + j01 * a01 + j02 * a02;
  det = fabsf(det) > 1e-30f ? det : 1e-30f;
  const float id = 1.0f / det;
  inv[0] = a00 * id; inv[1] = a01 * id; inv[2] = a02 * id;
  inv[3] = a11 * id; inv[4] = a12 * id; inv[5] = a22 * id;
}

// dN = -N J^-1 (l - r) for one edge.
__device__ __forceinline__ void grad_n(float N, float r0, float r1, float r2, const float rb[3],
                                       const float inv[6], float& d0, float& d1, float& d2) {
  const float a0 = r0 - rb[0], a1 = r1 - rb[1], a2 = r2 - rb[2];
  d0 = -N * (inv[0] * a0 + inv[1] * a1 + inv[2] * a2);
  d1 = -N * (inv[1] * a0 + inv[3] * a1 + inv[4] * a2);
  d2 = -N * (inv[2] * a0 + inv[4] * a1 + inv[5] * a2);
}

__device__ __forceinline__ bool load_slot(const Geom& g, int s, const float* __restrict__ x,
                                          const float* __restrict__ lam,
                                          const float* __restrict__ act, Slot& sl) {
  sl.lam0 = lam[s];
  sl.lam1 = lam[g.Ns + s];
  sl.lam2 = lam[2 * g.Ns + s];
  if (!(act[s] > 0.5f)) return false;
  const int cell = s % g.nc;
  const int row = cell / g.c2;  // c0-major, then c1
  sl.i0 = g.b0 + row / g.c1;
  sl.i1 = g.b1 + row % g.c1;
  sl.i2 = g.b2 + cell % g.c2;
  sl.x0 = x[s];
  sl.x1 = x[g.Ns + s];
  sl.x2 = x[2 * g.Ns + s];
  return true;
}

struct ScatterIO {
  const float* x;      // (3, Ns)
  const float* lam;    // (3, Ns) warm start
  const float* act;    // (1, Ns) 0/1
  const float* fN;     // (cN, Ns) N-weighted channels
  const float* G;      // (9, Ns) row-major 3x3, or null
  float* nodes;        // (n_nodes, cout), zero-initialised
  float* lam_out;      // (3, Ns)
  int* cnt;            // [valid edges, Newton iterations], zero-initialised
  int cN, cout, has_G, gnorm, max_iter;
  float tol2;
};

template <bool SOLVE, bool NEED_DN>
__global__ void __launch_bounds__(BLOCK)
lme_scatter3d_kernel(const Geom g, const Window w, const ScatterIO io) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  int n_edges = 0, n_iter = 0;
  if (s < g.Ns) {
    Slot sl;
    const bool active = load_slot(g, s, io.x, io.lam, io.act, sl);
    if (active) {
      Moments m;
      bool fresh = false;  // m holds the moments at the current lambda
      if (SOLVE) {
        // pallas_transfer3d.py::_lambda_newton3; a converged slot stops
        // alone (its lambda would be frozen on the TPU, so values agree)
        for (int it = 0; it < io.max_iter; ++it) {
          n_edges = sweep_moments<true>(g, w, sl, m);
          ++n_iter;
          float r[3], inv[6];
          r_and_Jinv(m, r, inv);
          const float rn2 = m.S0 > 0.f ? r[0] * r[0] + r[1] * r[1] + r[2] * r[2] : 0.f;
          if (rn2 <= io.tol2) { fresh = true; break; }
          sl.lam0 -= inv[0] * r[0] + inv[1] * r[1] + inv[2] * r[2];
          sl.lam1 -= inv[1] * r[0] + inv[3] * r[1] + inv[4] * r[2];
          sl.lam2 -= inv[2] * r[0] + inv[4] * r[1] + inv[5] * r[2];
        }
      }
      if (!fresh) n_edges = sweep_moments<NEED_DN>(g, w, sl, m);

      const float Zs = fmaxf(m.S0, 1e-30f);
      float rb[3] = {0.f, 0.f, 0.f}, inv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (NEED_DN) r_and_Jinv(m, rb, inv);

      float fv[MAX_CN];
#pragma unroll
      for (int c = 0; c < MAX_CN; ++c) fv[c] = c < io.cN ? io.fN[c * g.Ns + s] : 0.f;
      float G[9], sg = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) G[i] = 0.f;
      if (NEED_DN) {
        if (io.has_G) {
#pragma unroll
          for (int i = 0; i < 9; ++i) G[i] = io.G[i * g.Ns + s];
        }
        if (io.gnorm) sg = io.fN[(io.cN - 1) * g.Ns + s];
      }

      for (int k = 0; k < w.n; ++k) {
        float r0, r1, r2, sq; int node;
        if (!edge(g, sl, w.o0[k], w.o1[k], w.o2[k], r0, r1, r2, sq, node)) continue;
        const float N = expf(fval(g, sl, r0, r1, r2, sq) - m.fmax) / Zs;
        float* out = io.nodes + (size_t)node * io.cout;
#pragma unroll
        for (int c = 0; c < MAX_CN; ++c)
          if (c < io.cN) atomicAdd(out + c, N * fv[c]);
        if (NEED_DN) {
          float d0, d1, d2;
          grad_n(N, r0, r1, r2, rb, inv, d0, d1, d2);
          if (io.has_G) {
            atomicAdd(out + io.cN, G[0] * d0 + G[1] * d1 + G[2] * d2);
            atomicAdd(out + io.cN + 1, G[3] * d0 + G[4] * d1 + G[5] * d2);
            atomicAdd(out + io.cN + 2, G[6] * d0 + G[7] * d1 + G[8] * d2);
          }
          if (io.gnorm) atomicAdd(out + io.cout - 1, sg * (d0 * d0 + d1 * d1 + d2 * d2));
        }
      }
    }
    // an inactive slot passes its lambda through unchanged
    io.lam_out[s] = sl.lam0;
    io.lam_out[g.Ns + s] = sl.lam1;
    io.lam_out[2 * g.Ns + s] = sl.lam2;
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
  const float* x;      // (3, Ns)
  const float* lam;    // (3, Ns) converged
  const float* act;    // (1, Ns)
  const float* gN;     // (n_nodes, cN) or null
  const float* gg;     // (n_nodes, 3) or null
  float* outN;         // (Ns, cN)
  float* outG;         // (Ns, 3, 3): outG[s,i,j] = sum_A gg[A,i] dN_A/dx_j
  int cN;
};

template <bool HAS_N, bool HAS_GRAD>
__global__ void __launch_bounds__(BLOCK)
lme_gather3d_kernel(const Geom g, const Window w, const GatherIO io) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= g.Ns) return;
  float acc[MAX_CN];
#pragma unroll
  for (int c = 0; c < MAX_CN; ++c) acc[c] = 0.f;
  float Gs[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) Gs[i] = 0.f;
  Slot sl;
  if (load_slot(g, s, io.x, io.lam, io.act, sl)) {
    Moments m;
    sweep_moments<HAS_GRAD>(g, w, sl, m);
    const float Zs = fmaxf(m.S0, 1e-30f);
    float rb[3] = {0.f, 0.f, 0.f}, inv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (HAS_GRAD) r_and_Jinv(m, rb, inv);
    for (int k = 0; k < w.n; ++k) {
      float r0, r1, r2, sq; int node;
      if (!edge(g, sl, w.o0[k], w.o1[k], w.o2[k], r0, r1, r2, sq, node)) continue;
      const float N = expf(fval(g, sl, r0, r1, r2, sq) - m.fmax) / Zs;
      if (HAS_N) {
        const float* f = io.gN + (size_t)node * io.cN;
#pragma unroll
        for (int c = 0; c < MAX_CN; ++c)
          if (c < io.cN) acc[c] += N * __ldg(f + c);
      }
      if (HAS_GRAD) {
        float d0, d1, d2;
        grad_n(N, r0, r1, r2, rb, inv, d0, d1, d2);
        // a 12-byte row: three scalar loads, no vector load
        const float* u = io.gg + (size_t)node * 3;
        const float u0 = __ldg(u), u1 = __ldg(u + 1), u2 = __ldg(u + 2);
        Gs[0] += u0 * d0; Gs[1] += u0 * d1; Gs[2] += u0 * d2;
        Gs[3] += u1 * d0; Gs[4] += u1 * d1; Gs[5] += u1 * d2;
        Gs[6] += u2 * d0; Gs[7] += u2 * d1; Gs[8] += u2 * d2;
      }
    }
  }
  // inactive slots write zeros
  if (HAS_N) {
#pragma unroll
    for (int c = 0; c < MAX_CN; ++c)
      if (c < io.cN) io.outN[(size_t)s * io.cN + c] = acc[c];
  }
  if (HAS_GRAD) {
    float* o = io.outG + (size_t)s * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) o[i] = Gs[i];
  }
}

static int fill_window(Window& w, const int* offs, int n_offs) {
  if (n_offs < 1 || n_offs > MAX_TRIPS) return 1;
  w.n = n_offs;
  for (int k = 0; k < n_offs; ++k) {
    const int a = offs[3 * k], b = offs[3 * k + 1], c = offs[3 * k + 2];
    if (a < -127 || a > 127 || b < -127 || b > 127 || c < -127 || c > 127) return 1;
    w.o0[k] = (signed char)a;
    w.o1[k] = (signed char)b;
    w.o2[k] = (signed char)c;
  }
  return 0;
}

static Geom make_geom(int Ns, int nc, int c1, int c2, int b0, int b1, int b2, int n1, int n2,
                      int lo0, int hi0, int lo1, int hi1, int lo2, int hi2, float h,
                      float beta, float r2max, float org0, float org1, float org2) {
  Geom g;
  g.Ns = Ns; g.nc = nc; g.c1 = c1; g.c2 = c2;
  g.b0 = b0; g.b1 = b1; g.b2 = b2; g.n1 = n1; g.n2 = n2;
  g.lo0 = lo0; g.hi0 = hi0; g.lo1 = lo1; g.hi1 = hi1; g.lo2 = lo2; g.hi2 = hi2;
  g.h = h; g.beta = beta; g.r2max = r2max; g.org0 = org0; g.org1 = org1; g.org2 = org2;
  return g;
}

// Both entry points return a cudaError_t as int (0 = success; 1 =
// cudaErrorInvalidValue also for arguments refused here).  ``offs`` is a HOST
// array of n_offs (o0, o1, o2) triples.  Launches on ``stream``; never
// synchronises.
extern "C" int lme_scatter3d(
    const void* x, const void* lam, const void* act, const void* fN, const void* G,
    void* nodes, void* lam_out, void* cnt,
    int Ns, int nc, int c1, int c2, int b0, int b1, int b2, int n1, int n2,
    int lo0, int hi0, int lo1, int hi1, int lo2, int hi2,
    float h, float beta, float r2max, float org0, float org1, float org2,
    const int* offs, int n_offs,
    int cN, int has_G, int gnorm, int solve, int max_iter, float tol2, void* stream) {
  Window w;
  if (fill_window(w, offs, n_offs)) return 1;
  if (cN < 1 || cN > MAX_CN || Ns < 1) return 1;
  const Geom g = make_geom(Ns, nc, c1, c2, b0, b1, b2, n1, n2, lo0, hi0, lo1, hi1, lo2, hi2,
                           h, beta, r2max, org0, org1, org2);
  ScatterIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.fN = (const float*)fN; io.G = (const float*)G;
  io.nodes = (float*)nodes; io.lam_out = (float*)lam_out; io.cnt = (int*)cnt;
  io.cN = cN; io.has_G = has_G; io.gnorm = gnorm;
  io.cout = cN + (has_G ? 3 : 0) + (gnorm ? 1 : 0);
  io.max_iter = max_iter; io.tol2 = tol2;
  const dim3 grid((Ns + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  const bool need_dn = has_G || gnorm;
  if (solve && need_dn) lme_scatter3d_kernel<true, true><<<grid, block, 0, st>>>(g, w, io);
  else if (solve) lme_scatter3d_kernel<true, false><<<grid, block, 0, st>>>(g, w, io);
  else if (need_dn) lme_scatter3d_kernel<false, true><<<grid, block, 0, st>>>(g, w, io);
  else lme_scatter3d_kernel<false, false><<<grid, block, 0, st>>>(g, w, io);
  return (int)cudaGetLastError();
}

extern "C" int lme_gather3d(
    const void* x, const void* lam, const void* act, const void* gN, const void* gg,
    void* outN, void* outG,
    int Ns, int nc, int c1, int c2, int b0, int b1, int b2, int n1, int n2,
    int lo0, int hi0, int lo1, int hi1, int lo2, int hi2,
    float h, float beta, float r2max, float org0, float org1, float org2,
    const int* offs, int n_offs, int cN, void* stream) {
  Window w;
  if (fill_window(w, offs, n_offs)) return 1;
  const bool has_n = gN != nullptr, has_grad = gg != nullptr;
  if ((!has_n && !has_grad) || (has_n && (cN < 1 || cN > MAX_CN)) || Ns < 1) return 1;
  const Geom g = make_geom(Ns, nc, c1, c2, b0, b1, b2, n1, n2, lo0, hi0, lo1, hi1, lo2, hi2,
                           h, beta, r2max, org0, org1, org2);
  GatherIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.gN = (const float*)gN; io.gg = (const float*)gg;
  io.outN = (float*)outN; io.outG = (float*)outG; io.cN = has_n ? cN : 0;
  const dim3 grid((Ns + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  if (has_n && has_grad) lme_gather3d_kernel<true, true><<<grid, block, 0, st>>>(g, w, io);
  else if (has_n) lme_gather3d_kernel<true, false><<<grid, block, 0, st>>>(g, w, io);
  else lme_gather3d_kernel<false, true><<<grid, block, 0, st>>>(g, w, io);
  return (int)cudaGetLastError();
}
