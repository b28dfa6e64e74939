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
// Data.  Slot arrays are channel-leading (ch, C, nc) with slot = rank*nc +
// cell and the cell index fastest along box axis 2.  No per-edge tensor
// reaches device memory: the basis is recomputed in registers in each sweep
// over the window.  The window is the static, radius-culled offset list of
// the slot's cell (160 offsets in 32 rows at margin 0, 432 in 60 at margin
// 1, gamma = 3), passed by value as rows (o0, o1, o2 range) of int8, so a
// warp-uniform read is a broadcast from the constant bank; the wrapper
// orders the rows nearest-first.  The cell comes from the slot index, never
// from the position: with a drift margin the particle may sit in a
// neighbouring cell, and the radius mask r^2 <= R^2 alone keeps the basis
// exact.
//
// What bounds them.  The function needs each slot channel and node once and,
// per active slot, the window test once per offset and f/exp/moments once
// per evaluation of the basis: 0.4-1.0 GFLOP and 18-28 MB a call at 281,216
// slots, 6-15 microseconds on an H100, operations ahead of bytes.  Measured
// on the earlier design of these kernels (one thread per slot, three sweeps,
// a global f32 atomic per edge and channel), the global atomics took a third
// to a half of a scatter and the repeated sweeps the rest; node reads and
// the gather's row stores took almost nothing.  This design:
//
//   * One sweep per evaluation.  A running max of f, with S0, S1, S2 (and
//     the gather's sums) rescaled by 2^(old - new) when it rises: a Newton
//     iteration is one sweep, the scatter's emit one more; the gather is one
//     sweep in all, because at fixed lambda grad N_A = -N_A J^-1 (l_A - rbar)
//     lets it sum e*g_A and e*g_A (x) l_A beside the moments and apply J^-1
//     and rbar = S1/Z once per slot at the end.  f is taken in base 2 so
//     that exp is exp2.
//   * Cheaper sweeps.  A row of the window is skipped when its axis 0/1 part
//     of r^2 alone exceeds R^2, and its o2 range is cut to the nodes near x2
//     that can lie inside the radius (with a node of slack): only offsets the
//     exact test rejects are skipped, and most of those (45 % of the window
//     at 96^3) are.
//   * Node sums in shared memory.  A scatter block walks a 3D tile of box
//     cells (all capacity ranks) and adds each edge into the tile's node
//     footprint in shared memory; after a barrier it flushes each non-zero
//     footprint entry with one global atomic, a few per cell and channel
//     instead of one per edge and channel (88 an active slot).  A float
//     atomic add on shared memory is a CAS loop on this card
//     (ATOMS.CAST.SPIN); packing two channels into one 64-bit CAS measured
//     slower.  The plan (tile, footprint = tile + the window's offset span, dynamic
//     shared bytes) comes from fused_transfer.py::tile_plan; ragged edge
//     tiles are masked.
//
// What is left: the shared-memory CAS loops (a third of a scatter), the window
// test of the rows and ranges that remain, and an exp2 per valid edge per
// sweep.
//
// Mask arithmetic (node position, r, r^2, summed axis by axis) uses
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fsub_rn) so that it
// is bit-identical to the plain PyTorch version and the two agree on every
// borderline edge (equal nnz).

#include <cuda_runtime.h>

#define MAX_TRIPS 512
#define MAX_CN 12
#define NEG_BIG (-1e30f)
#define LOG2E 1.4426950408889634f
#define BLOCK 128

// The window as rows: offsets (o0, o1, o2) for o2 in [lo2, hi2].  4 + 4 * 512
// bytes, well inside the 4 KB parameter space; read warp-uniformly, so from
// the constant bank as broadcasts.
struct Window {
  int n;
  signed char o0[MAX_TRIPS];
  signed char o1[MAX_TRIPS];
  signed char lo2[MAX_TRIPS];
  signed char hi2[MAX_TRIPS];
};

struct Geom {
  int Ns, nc, c0, c1, c2;           // slots, cells, cells along box axes 0, 1, 2
  int b0, b1, b2;                   // box cell origin (grid frame)
  int n1, n2;                       // nodes along grid axes 1, 2
  int lo0, hi0, lo1, hi1, lo2, hi2; // inclusive valid node-index bounds
  float h, inv_h, beta, r2max, org0, org1, org2;
};

// The scatter's cell tiles: t cells per axis, q tiles along box axes 1 and 2,
// f footprint nodes per axis, m the window's lowest offset per axis (the
// footprint of the tile at box cell a starts at node b + a + m).
struct Tiles {
  int t0, t1, t2, q1, q2, f0, f1, f2, m0, m1, m2;
};

struct Slot {
  float x0, x1, x2;  // particle position
  int i0, i1, i2;    // node multi-index of the slot cell's lower corner
  float lam0, lam1, lam2;
};

struct Moments {  // S2 holds the symmetric second moment: 00 01 02 11 12 22
  float fmax, S0, S1[3], S2[6];
};

// Calls body(r0, r1, r2, sq, i0, i1, i2) for each valid edge of the slot:
// window node (i0, i1, i2) inside the valid bounds and the support radius,
// r = x - x_node and sq = |r|^2.  The mask arithmetic (node position, r,
// and sq summed axis by axis) is that of the plain version, bit for bit.  A
// row is skipped when its axis 0/1 part alone exceeds R^2 (sq >= that part),
// and its o2 range is cut to the nodes within sqrt(R^2 - part) of x2 plus a
// node of slack either side: everything skipped is an offset the exact test
// sq <= R^2 rejects, by a margin of about h^2.
template <class Body>
__device__ __forceinline__ void for_each_edge(const Geom& g, const Window& w, const Slot& s,
                                              Body&& body) {
  const float u2 = (s.x2 - g.org2) * g.inv_h;  // x2 in node units
  for (int k = 0; k < w.n; ++k) {
    const int i0 = s.i0 + w.o0[k], i1 = s.i1 + w.o1[k];
    if ((i0 < g.lo0) | (i0 > g.hi0) | (i1 < g.lo1) | (i1 > g.hi1)) continue;
    const float r0 = __fsub_rn(s.x0, __fadd_rn(__fmul_rn((float)i0, g.h), g.org0));
    const float r1 = __fsub_rn(s.x1, __fadd_rn(__fmul_rn((float)i1, g.h), g.org1));
    const float p = __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1));
    if (p > g.r2max) continue;
    const float d = sqrtf(g.r2max - p) * g.inv_h;
    const int a = max(max(s.i2 + w.lo2[k], g.lo2), __float2int_ru(u2 - d) - 1);
    const int b = min(min(s.i2 + w.hi2[k], g.hi2), __float2int_rd(u2 + d) + 1);
    for (int i2 = a; i2 <= b; ++i2) {
      const float r2 = __fsub_rn(s.x2, __fadd_rn(__fmul_rn((float)i2, g.h), g.org2));
      const float sq = __fadd_rn(p, __fmul_rn(r2, r2));
      if (sq <= g.r2max) body(r0, r1, r2, sq, i0, i1, i2);
    }
  }
}

// f = -beta r^2 + lambda.r in base-2 units (f * log2 e), so that exp is exp2.
__device__ __forceinline__ float fval2(const Geom& g, const Slot& s, float r0, float r1,
                                       float r2, float sq) {
  return (-g.beta * sq + s.lam0 * r0 + s.lam1 * r1 + s.lam2 * r2) * LOG2E;
}

// e = 2^(f - fmax) against a running max: when f rises above it, the N sums
// in ``acc`` are rescaled to the new max first.
template <int N>
__device__ __forceinline__ float running_exp2(float f, float& fmax, float* acc) {
  if (f > fmax) {
    const float sc = exp2f(fmax - f);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= sc;
    fmax = f;
  }
  return exp2f(f - fmax);
}

// One sweep: the e-weighted moments S0 = sum e, S1 = sum e*l,
// S2 = sum e*l(x)l with e = exp(f - max f) over the valid edges.  Returns
// the number of valid edges.
template <bool NEED_MOMENTS>
__device__ __forceinline__ int sweep_moments(const Geom& g, const Window& w, const Slot& s,
                                             Moments& m) {
  float fmax = NEG_BIG;
  float S[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // S0, S1[3], S2[6]
  int cnt = 0;
  for_each_edge(g, w, s, [&](float r0, float r1, float r2, float sq, int, int, int) {
    ++cnt;
    const float e = running_exp2<NEED_MOMENTS ? 10 : 1>(fval2(g, s, r0, r1, r2, sq), fmax, S);
    S[0] += e;
    if (NEED_MOMENTS) {
      const float e0 = e * r0, e1 = e * r1, e2 = e * r2;
      S[1] += e0; S[2] += e1; S[3] += e2;
      S[4] += e0 * r0; S[5] += e0 * r1; S[6] += e0 * r2;
      S[7] += e1 * r1; S[8] += e1 * r2; S[9] += e2 * r2;
    }
  });
  m.fmax = fmax; m.S0 = S[0];
#pragma unroll
  for (int i = 0; i < 3; ++i) m.S1[i] = S[1 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) m.S2[i] = S[4 + i];
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

// Slot s of box cell (c0, c1, c2): its lambda, and if it is active its
// position and cell corner.
__device__ __forceinline__ bool load_slot(const Geom& g, int s, int c0, int c1, int c2,
                                          const float* __restrict__ x,
                                          const float* __restrict__ lam,
                                          const float* __restrict__ act, Slot& sl) {
  sl.lam0 = lam[s];
  sl.lam1 = lam[g.Ns + s];
  sl.lam2 = lam[2 * g.Ns + s];
  if (!(act[s] > 0.5f)) return false;
  sl.i0 = g.b0 + c0;
  sl.i1 = g.b1 + c1;
  sl.i2 = g.b2 + c2;
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

// One block per cell tile.  Shared memory: the tile's footprint sums,
// channel-major (cout, f0*f1*f2).  CNB, fixed at compile time, bounds the N
// channels (1, 4, 8 or 12; io.cN <= CNB): their values live in registers, so
// a bound as wide as the widest call would cost every narrow call registers.
template <bool SOLVE, bool NEED_DN, int CNB>
__global__ void __launch_bounds__(BLOCK)
lme_scatter3d_kernel(const Geom g, const Window w, const Tiles t, const ScatterIO io) {
  extern __shared__ float acc[];
  const int F = t.f0 * t.f1 * t.f2;
  for (int i = threadIdx.x; i < F * io.cout; i += BLOCK) acc[i] = 0.f;
  // the tile's first box cell
  const int a0 = blockIdx.x / (t.q1 * t.q2) * t.t0;
  const int a1 = blockIdx.x / t.q2 % t.q1 * t.t1;
  const int a2 = blockIdx.x % t.q2 * t.t2;
  __syncthreads();

  // the footprint's first node (grid frame)
  const int n0 = g.b0 + a0 + t.m0, n1 = g.b1 + a1 + t.m1, n2 = g.b2 + a2 + t.m2;
  const int tc = t.t0 * t.t1 * t.t2;
  const int C = g.Ns / g.nc;
  int n_edges = 0, n_iter = 0;
  for (int k = threadIdx.x; k < C * tc; k += BLOCK) {
    const int rank = k / tc, lc = k % tc;
    const int l0 = lc / (t.t1 * t.t2), l1 = lc / t.t2 % t.t1, l2 = lc % t.t2;
    const int c0 = a0 + l0, c1 = a1 + l1, c2 = a2 + l2;
    if (c0 >= g.c0 || c1 >= g.c1 || c2 >= g.c2) continue;  // ragged edge tile
    const int s = rank * g.nc + (c0 * g.c1 + c1) * g.c2 + c2;
    Slot sl;
    if (load_slot(g, s, c0, c1, c2, io.x, io.lam, io.act, sl)) {
      Moments m;
      bool fresh = false;  // m holds the moments at the current lambda
      int ne = 0;          // the slot's valid edges
      if (SOLVE) {
        // pallas_transfer3d.py::_lambda_newton3; a converged slot stops
        // alone (its lambda would be frozen on the TPU, so values agree)
        for (int it = 0; it < io.max_iter; ++it) {
          ne = sweep_moments<true>(g, w, sl, m);
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
      if (!fresh) ne = sweep_moments<NEED_DN>(g, w, sl, m);
      n_edges += ne;

      const float iz = 1.0f / fmaxf(m.S0, 1e-30f);
      float rb[3] = {0.f, 0.f, 0.f}, inv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (NEED_DN) r_and_Jinv(m, rb, inv);

      float fv[CNB];
#pragma unroll
      for (int c = 0; c < CNB; ++c) fv[c] = c < io.cN ? io.fN[c * g.Ns + s] : 0.f;
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

      // node (i0, i1, i2) sits at ((i0 - n0)*f1 + i1 - n1)*f2 + i2 - n2 in the
      // footprint
      const int shift = (n0 * t.f1 + n1) * t.f2 + n2;
      for_each_edge(g, w, sl, [&](float r0, float r1, float r2, float sq, int i0, int i1,
                                  int i2) {
        const float N = exp2f(fval2(g, sl, r0, r1, r2, sq) - m.fmax) * iz;
        float* out = acc + ((i0 * t.f1 + i1) * t.f2 + i2 - shift);
#pragma unroll
        for (int c = 0; c < CNB; ++c)
          if (c < io.cN && fv[c] != 0.f) atomicAdd(out + c * F, N * fv[c]);
        if (NEED_DN) {
          float d0, d1, d2;
          grad_n(N, r0, r1, r2, rb, inv, d0, d1, d2);
          if (io.has_G) {
            atomicAdd(out + io.cN * F, G[0] * d0 + G[1] * d1 + G[2] * d2);
            atomicAdd(out + (io.cN + 1) * F, G[3] * d0 + G[4] * d1 + G[5] * d2);
            atomicAdd(out + (io.cN + 2) * F, G[6] * d0 + G[7] * d1 + G[8] * d2);
          }
          if (io.gnorm)
            atomicAdd(out + (io.cout - 1) * F, sg * (d0 * d0 + d1 * d1 + d2 * d2));
        }
      });
    }
    // an inactive slot passes its lambda through unchanged
    io.lam_out[s] = sl.lam0;
    io.lam_out[g.Ns + s] = sl.lam1;
    io.lam_out[2 * g.Ns + s] = sl.lam2;
  }
  __syncthreads();

  // flush: one global atomic per non-zero footprint entry, consecutive
  // threads on neighbouring addresses of a node row (node-major, cout wide)
  for (int i = threadIdx.x; i < F * io.cout; i += BLOCK) {
    const int c = i % io.cout, fl = i / io.cout;
    const float v = acc[c * F + fl];
    if (v == 0.f) continue;  // untouched, or outside the valid nodes
    const int j0 = n0 + fl / (t.f1 * t.f2), j1 = n1 + fl / t.f2 % t.f1, j2 = n2 + fl % t.f2;
    atomicAdd(io.nodes + ((size_t)(j0 * g.n1 + j1) * g.n2 + j2) * io.cout + c, v);
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
  int cN, same;        // same: gN is gg (cN = 3), its rows are read once
};

// One sweep at fixed lambda.  With e = exp(f - max f) and l = x_p - x_A:
//   S0 = sum e, S1 = sum e*l, S2 = sum e*l(x)l, q_c = sum e*gN_A,c,
//   p_i = sum e*gg_A,i, M_ik = sum e*gg_A,i*l_k;
// then N-gather q/Z and, with rbar = S1/Z and J^-1 from S2,
//   outG_ij = -(1/Z) sum_k (M_ik - p_i*rbar_k) J^-1_kj,
// which is sum_A gg_A,i dN_A/dx_j with dN_A = -N_A J^-1 (l_A - rbar).
// CN: the N-gather's channel count when it is fixed at compile time (3, the
// explicit step's gathers; 9, the implicit step's last), else 0 and io.cN.
// Loads of a row whose length is known only at run time would each wait
// behind a branch, so the runtime count loads MAX_CN channels (clamped to
// the row) before any add.
template <bool HAS_N, bool HAS_GRAD, int CN>
__global__ void __launch_bounds__(BLOCK)
lme_gather3d_kernel(const Geom g, const Window w, const GatherIO io) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= g.Ns) return;
  // running sums, all rescaled together: S0, S1[3], S2[6], p[3], M[9] (with
  // the gradient), q[QN].  QN is 8 for a compile-time count up to 8: with 3
  // sums the 3-channel N-gather of the explicit step measured 8 % slower on
  // the H100 than with 8 (registers 40 against 44).
  constexpr int NG = HAS_GRAD ? 22 : 1, QN = CN > 8 ? CN : (CN ? 8 : MAX_CN);
  float acc[NG + QN];
#pragma unroll
  for (int i = 0; i < NG + QN; ++i) acc[i] = 0.f;
  float* q = acc + NG;
  Slot sl;
  const int cell = s % g.nc;
  const bool active = load_slot(g, s, cell / (g.c1 * g.c2), cell / g.c2 % g.c1, cell % g.c2,
                                io.x, io.lam, io.act, sl);
  if (active) {
    float fmax = NEG_BIG;
    for_each_edge(g, w, sl, [&](float r0, float r1, float r2, float sq, int i0, int i1,
                                int i2) {
      const size_t node = (size_t)(i0 * g.n1 + i1) * g.n2 + i2;
      const float e = running_exp2<NG + QN>(fval2(g, sl, r0, r1, r2, sq), fmax, acc);
      acc[0] += e;
      if (HAS_GRAD) {
        const float e0 = e * r0, e1 = e * r1, e2 = e * r2;
        acc[1] += e0; acc[2] += e1; acc[3] += e2;
        acc[4] += e0 * r0; acc[5] += e0 * r1; acc[6] += e0 * r2;
        acc[7] += e1 * r1; acc[8] += e1 * r2; acc[9] += e2 * r2;
        // a 12-byte row: three scalar loads, no vector load
        const float* u = io.gg + node * 3;
        const float eu[3] = {e * __ldg(u), e * __ldg(u + 1), e * __ldg(u + 2)};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          acc[10 + i] += eu[i];
          acc[13 + 3 * i] += eu[i] * r0;
          acc[14 + 3 * i] += eu[i] * r1;
          acc[15 + 3 * i] += eu[i] * r2;
        }
      }
      if (HAS_N && !(HAS_GRAD && io.same)) {
        const int cn = CN ? CN : io.cN;
        const float* f_ = io.gN + node * cn;
        constexpr int LN = CN ? CN : MAX_CN;  // loads of a row
        float v[LN];
#pragma unroll
        for (int c = 0; c < LN; ++c) v[c] = __ldg(f_ + min(c, cn - 1));
#pragma unroll
        for (int c = 0; c < LN; ++c)
          if (c < cn) q[c] += e * v[c];
      }
    });
    if (HAS_GRAD && io.same) {
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = acc[10 + c];
    }
  }
  // an inactive slot writes zeros: every sum is 0, and so is every product
  // with 1/max(Z, 1e-30)
  const float iz = 1.0f / fmaxf(acc[0], 1e-30f);
  if (HAS_N) {
#pragma unroll
    for (int c = 0; c < QN; ++c)
      if (c < io.cN) io.outN[(size_t)s * io.cN + c] = q[c] * iz;
  }
  if (HAS_GRAD) {
    Moments m;
    m.S0 = acc[0];
#pragma unroll
    for (int i = 0; i < 3; ++i) m.S1[i] = acc[1 + i];
#pragma unroll
    for (int i = 0; i < 6; ++i) m.S2[i] = acc[4 + i];
    float rb[3], inv[6];
    r_and_Jinv(m, rb, inv);
    const float J[9] = {inv[0], inv[1], inv[2], inv[1], inv[3], inv[4], inv[2], inv[4], inv[5]};
    float* o = io.outG + (size_t)s * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a[3] = {acc[13 + 3 * i] - acc[10 + i] * rb[0],
                          acc[14 + 3 * i] - acc[10 + i] * rb[1],
                          acc[15 + 3 * i] - acc[10 + i] * rb[2]};
#pragma unroll
      for (int j = 0; j < 3; ++j)
        o[3 * i + j] = -iz * (a[0] * J[j] + a[1] * J[3 + j] + a[2] * J[6 + j]);
    }
  }
}

// The window's n_offs (o0, o1, o2) triples as rows: a run of triples with
// the same (o0, o1) and o2 rising by one is one row, in the order given.
static int fill_window(Window& w, const int* offs, int n_offs) {
  if (n_offs < 1 || n_offs > MAX_TRIPS) return 1;
  w.n = 0;
  for (int k = 0; k < n_offs; ++k) {
    const int a = offs[3 * k], b = offs[3 * k + 1], c = offs[3 * k + 2];
    if (a < -127 || a > 127 || b < -127 || b > 127 || c < -127 || c > 127) return 1;
    const int r = w.n - 1;
    if (r >= 0 && w.o0[r] == a && w.o1[r] == b && w.hi2[r] + 1 == c) {
      w.hi2[r] = (signed char)c;
      continue;
    }
    w.o0[w.n] = (signed char)a;
    w.o1[w.n] = (signed char)b;
    w.lo2[w.n] = w.hi2[w.n] = (signed char)c;
    ++w.n;
  }
  return 0;
}

static int make_geom(Geom& g, int Ns, int nc, int c1, int c2, int b0, int b1, int b2, int n1,
                     int n2, int lo0, int hi0, int lo1, int hi1, int lo2, int hi2, float h,
                     float beta, float r2max, float org0, float org1, float org2) {
  if (Ns < 1 || nc < 1 || c1 < 1 || c2 < 1 || Ns % nc || nc % (c1 * c2)) return 1;
  g.Ns = Ns; g.nc = nc; g.c0 = nc / (c1 * c2); g.c1 = c1; g.c2 = c2;
  g.b0 = b0; g.b1 = b1; g.b2 = b2; g.n1 = n1; g.n2 = n2;
  g.lo0 = lo0; g.hi0 = hi0; g.lo1 = lo1; g.hi1 = hi1; g.lo2 = lo2; g.hi2 = hi2;
  g.h = h; g.inv_h = 1.0f / h; g.beta = beta; g.r2max = r2max; g.org0 = org0; g.org1 = org1; g.org2 = org2;
  return 0;
}

// Both entry points return a cudaError_t as int (0 = success; 1 =
// cudaErrorInvalidValue also for arguments refused here).  ``offs`` is a HOST
// array of n_offs (o0, o1, o2) triples; ``plan`` (scatter) a HOST array of
// the tile plan: tile cells t0 t1 t2, footprint nodes f0 f1 f2, lowest
// window offset m0 m1 m2 per axis.  Launches on ``stream``; never
// synchronises.
template <bool SOLVE, bool NEED_DN, int CNB>
static int launch_scatter(const Geom& g, const Window& w, const Tiles& t, const ScatterIO& io,
                          int blocks, int smem, cudaStream_t st) {
  auto kernel = lme_scatter3d_kernel<SOLVE, NEED_DN, CNB>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, BLOCK, smem, st>>>(g, w, t, io);
  return (int)cudaGetLastError();
}

// The instantiation of a call: SOLVE and NEED_DN from its options, the
// channel bound CNB from its cN.
template <int CNB>
static int launch_scatter_b(bool solve, bool need_dn, const Geom& g, const Window& w,
                            const Tiles& t, const ScatterIO& io, int blocks, int smem,
                            cudaStream_t st) {
  if (solve && need_dn) return launch_scatter<true, true, CNB>(g, w, t, io, blocks, smem, st);
  if (solve) return launch_scatter<true, false, CNB>(g, w, t, io, blocks, smem, st);
  if (need_dn) return launch_scatter<false, true, CNB>(g, w, t, io, blocks, smem, st);
  return launch_scatter<false, false, CNB>(g, w, t, io, blocks, smem, st);
}

static int launch_scatter_cn(int cN, bool solve, bool need_dn, const Geom& g, const Window& w,
                             const Tiles& t, const ScatterIO& io, int blocks, int smem,
                             cudaStream_t st) {
  if (cN == 1) return launch_scatter_b<1>(solve, need_dn, g, w, t, io, blocks, smem, st);
  if (cN <= 4) return launch_scatter_b<4>(solve, need_dn, g, w, t, io, blocks, smem, st);
  if (cN <= 8) return launch_scatter_b<8>(solve, need_dn, g, w, t, io, blocks, smem, st);
  return launch_scatter_b<12>(solve, need_dn, g, w, t, io, blocks, smem, st);
}

extern "C" int lme_scatter3d(
    const void* x, const void* lam, const void* act, const void* fN, const void* G,
    void* nodes, void* lam_out, void* cnt,
    int Ns, int nc, int c1, int c2, int b0, int b1, int b2, int n1, int n2,
    int lo0, int hi0, int lo1, int hi1, int lo2, int hi2,
    float h, float beta, float r2max, float org0, float org1, float org2,
    const int* offs, int n_offs, const int* plan,
    int cN, int has_G, int gnorm, int solve, int max_iter, float tol2, void* stream) {
  Window w;
  Geom g;
  if (fill_window(w, offs, n_offs)) return 1;
  if (cN < 1 || cN > MAX_CN) return 1;
  if (make_geom(g, Ns, nc, c1, c2, b0, b1, b2, n1, n2, lo0, hi0, lo1, hi1, lo2, hi2, h, beta,
                r2max, org0, org1, org2))
    return 1;
  Tiles t;
  t.t0 = plan[0]; t.t1 = plan[1]; t.t2 = plan[2];
  t.f0 = plan[3]; t.f1 = plan[4]; t.f2 = plan[5];
  t.m0 = plan[6]; t.m1 = plan[7]; t.m2 = plan[8];
  if (t.t0 < 1 || t.t1 < 1 || t.t2 < 1) return 1;
  t.q1 = (g.c1 + t.t1 - 1) / t.t1;
  t.q2 = (g.c2 + t.t2 - 1) / t.t2;
  const int q0 = (g.c0 + t.t0 - 1) / t.t0;
  // every window node of every tile cell must fall inside the footprint
  for (int k = 0; k < w.n; ++k) {
    if (w.o0[k] < t.m0 || w.o0[k] + t.t0 > t.m0 + t.f0 || w.o1[k] < t.m1 ||
        w.o1[k] + t.t1 > t.m1 + t.f1 || w.lo2[k] < t.m2 || w.hi2[k] + t.t2 > t.m2 + t.f2)
      return 1;
  }
  ScatterIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.fN = (const float*)fN; io.G = (const float*)G;
  io.nodes = (float*)nodes; io.lam_out = (float*)lam_out; io.cnt = (int*)cnt;
  io.cN = cN; io.has_G = has_G; io.gnorm = gnorm;
  io.cout = cN + (has_G ? 3 : 0) + (gnorm ? 1 : 0);
  io.max_iter = max_iter; io.tol2 = tol2;
  // fused_transfer.py::tile_plan keeps this within a block's 227 KB
  const long long smem = 4LL * t.f0 * t.f1 * t.f2 * io.cout;
  const int blocks = q0 * t.q1 * t.q2;
  return launch_scatter_cn(cN, solve, has_G || gnorm, g, w, t, io, blocks, (int)smem,
                           (cudaStream_t)stream);
}

extern "C" int lme_gather3d(
    const void* x, const void* lam, const void* act, const void* gN, const void* gg,
    void* outN, void* outG,
    int Ns, int nc, int c1, int c2, int b0, int b1, int b2, int n1, int n2,
    int lo0, int hi0, int lo1, int hi1, int lo2, int hi2,
    float h, float beta, float r2max, float org0, float org1, float org2,
    const int* offs, int n_offs, int cN, void* stream) {
  Window w;
  Geom g;
  if (fill_window(w, offs, n_offs)) return 1;
  const bool has_n = gN != nullptr, has_grad = gg != nullptr;
  if ((!has_n && !has_grad) || (has_n && (cN < 1 || cN > MAX_CN))) return 1;
  if (make_geom(g, Ns, nc, c1, c2, b0, b1, b2, n1, n2, lo0, hi0, lo1, hi1, lo2, hi2, h, beta,
                r2max, org0, org1, org2))
    return 1;
  GatherIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.gN = (const float*)gN; io.gg = (const float*)gg;
  io.outN = (float*)outN; io.outG = (float*)outG; io.cN = has_n ? cN : 0;
  io.same = has_n && has_grad && gN == gg && cN == 3;
  const dim3 grid((Ns + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  if (has_n && has_grad && cN == 3)
    lme_gather3d_kernel<true, true, 3><<<grid, block, 0, st>>>(g, w, io);
  else if (has_n && has_grad)
    lme_gather3d_kernel<true, true, 0><<<grid, block, 0, st>>>(g, w, io);
  else if (has_n && cN == 3)
    lme_gather3d_kernel<true, false, 3><<<grid, block, 0, st>>>(g, w, io);
  else if (has_n && cN == 9)
    lme_gather3d_kernel<true, false, 9><<<grid, block, 0, st>>>(g, w, io);
  else if (has_n)
    lme_gather3d_kernel<true, false, 0><<<grid, block, 0, st>>>(g, w, io);
  else
    lme_gather3d_kernel<false, true, 0><<<grid, block, 0, st>>>(g, w, io);
  return (int)cudaGetLastError();
}
