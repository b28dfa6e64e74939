// Fused 2D LME particle<->grid transfer kernels for NVIDIA Hopper (sm_90a).
//
//   lme_scatter2d  LME basis (optional lambda-Newton) + P2G: replaces the TPU
//                  kernel nlpartsol_tpu/ops/pallas_transfer.py::fused_scatter
//                  (body _make_scatter_kernel).
//   lme_gather2d   LME basis at fixed lambda + G2P: replaces
//                  nlpartsol_tpu/ops/pallas_transfer.py::fused_gather
//                  (body _make_gather_kernel).
//
// Data.  Slot arrays are channel-leading (ch, C, nc) with slot = rank*nc +
// cell and the cell index fastest along box axis 1.  No per-edge tensor
// reaches device memory: the basis is recomputed in registers in each sweep
// over the window.  The window is the static, radius-culled offset list of
// the slot's cell (32 offsets in 6 rows at margin 0, 60 in 8 at margin 1,
// gamma = 3), passed by value as rows (o0, o1 range) of int8, so a
// warp-uniform read is a broadcast from the constant bank; the wrapper
// orders the rows nearest-first.  The cell comes from the slot index, never
// from the position: with a drift margin the particle may sit in a
// neighbouring cell, and the radius mask r^2 <= R^2 alone keeps the basis
// exact.
//
// What bounds them.  The function needs each slot channel and node once and,
// per active slot, the window test once per offset and f/exp/moments once
// per evaluation of the basis: 0.25-0.45 GFLOP and 11-19 MB a call at
// 405,600 slots, a few microseconds on an H100, operations slightly ahead
// of bytes.  The first design of these kernels (one thread a slot, three
// sweeps over the whole window per evaluation, a global f32 atomic per edge
// and channel) took 13-26 times that.  This one is the design of
// lme_transfer3d.cu, where it was measured first:
//
//   * One sweep per evaluation.  A running max of f, with the sums rescaled
//     by 2^(old - new) when it rises: a Newton iteration is one sweep, the
//     scatter's emit one more; the gather is one sweep in all, because at
//     fixed lambda grad N_A = -N_A J^-1 (l_A - rbar) lets it sum e*g_A and
//     e*g_A (x) l_A beside the moments and apply J^-1 and rbar = S1/Z once
//     per slot at the end.  f is taken in base 2 so that exp is exp2.
//   * Cheaper sweeps.  A row (o0 fixed) is skipped when r0^2 alone exceeds
//     R^2, and its o1 range is cut to the nodes within sqrt(R^2 - r0^2) of
//     x1, widened by a bound on the rounding of that arithmetic: only
//     offsets the exact test rejects are skipped (about 24 of the 60
//     offsets of the margin-1 window are valid edges).
//   * Node sums on chip.  A scatter block walks a tile of box cells (4x8,
//     all capacity ranks, fused_transfer.py::tile_plan) and adds each edge
//     into the tile's node footprint in shared memory (tile + the window's
//     offset span) with shared float atomics; after a barrier it flushes
//     each non-zero footprint entry with one global atomic, a few per cell
//     and channel instead of one per edge and channel.  Zero channel values
//     are skipped (the step's second scatter carries an all-zero channel).
//     Measured on the H100 at the 2D main path's shapes: a copy of the
//     footprint per warp, added to with plain loads and stores while the
//     warp's 32 lanes (32 distinct cells) stepped through the emit sweep's
//     offsets together, was 6 % faster on the solve call and 8 % slower on
//     the G call, no faster a step; 4x8 tiles beat 8x16 by 1.3-1.5x (more
//     blocks in flight, fewer slots a thread in series).
//
// What is left: the sweeps themselves (a solve call sweeps about twice, as
// the G call does: once for the moments and once to emit), the window test
// of the rows and ranges that remain, and an exp2 per valid edge per sweep.
//
// Mask arithmetic (node position, r, r^2 summed axis by axis) uses
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fsub_rn) so that it
// is bit-identical to the plain PyTorch version and the two agree on every
// borderline edge (equal nnz).

#include <cuda_runtime.h>

#define MAX_PAIRS 192
#define MAX_CN 12
#define NEG_BIG (-1e30f)
#define LOG2E 1.4426950408889634f
#define BLOCK 128

// The window as rows: offsets (o0, o1) for o1 in [lo1, hi1].  Read
// warp-uniformly, so from the constant bank as broadcasts.
struct Window {
  int n;
  signed char o0[MAX_PAIRS];
  signed char lo1[MAX_PAIRS];
  signed char hi1[MAX_PAIRS];
};

struct Geom {
  int Ns, nc, c0, c1;      // slots, cells, cells along box axes 0 and 1
  int b0, b1;              // box cell origin (grid frame)
  int n1;                  // nodes along grid axis 1
  int lo0, hi0, lo1, hi1;  // inclusive valid node-index bounds
  float h, inv_h, beta, r2max, org0, org1;
};

// The scatter's cell tiles: t cells per axis, q1 tiles along box axis 1, f
// footprint nodes per axis, m the window's lowest offset per axis (the
// footprint of the tile at box cell a starts at node b + a + m).
struct Tiles {
  int t0, t1, q1, f0, f1, m0, m1;
};

struct Slot {
  float x0, x1;  // particle position
  int i0, i1;    // node multi-index of the slot cell's lower corner
  float lam0, lam1;
};

struct Moments {  // S2 holds the symmetric second moment: 00 01 11
  float fmax, S0, S1[2], S2[3];
};

// Calls body(r0, r1, sq, i0, i1) for each valid edge of the slot: window
// node (i0, i1) inside the valid bounds and the support radius, r = x -
// x_node and sq = |r|^2.  The mask arithmetic (node position, r, and sq
// summed axis by axis) is that of the plain version, bit for bit.  A row is
// skipped when p = r0^2 alone exceeds R^2, and its i1 range is cut to the
// nodes within sqrt(R^2 - p) of x1 plus a margin ``tol`` (in nodes) that
// bounds the rounding of u1, the root and r1 (a few float ulps of |x1| +
// |org1| in node units, plus a quarter node): everything skipped is an
// offset the exact test sq <= R^2 rejects.
template <class Body>
__device__ __forceinline__ void for_each_edge(const Geom& g, const Window& w, const Slot& s,
                                              Body&& body) {
  const float u1 = (s.x1 - g.org1) * g.inv_h;  // x1 in node units
  const float tol = 0.25f + 1e-6f * (fabsf(s.x1) + fabsf(g.org1)) * g.inv_h;
  for (int k = 0; k < w.n; ++k) {
    const int i0 = s.i0 + w.o0[k];
    if ((i0 < g.lo0) | (i0 > g.hi0)) continue;
    const float r0 = __fsub_rn(s.x0, __fadd_rn(__fmul_rn((float)i0, g.h), g.org0));
    const float p = __fmul_rn(r0, r0);
    if (p > g.r2max) continue;
    const float d = sqrtf(g.r2max - p) * g.inv_h + tol;
    const int a = max(max(s.i1 + w.lo1[k], g.lo1), __float2int_ru(u1 - d));
    const int b = min(min(s.i1 + w.hi1[k], g.hi1), __float2int_rd(u1 + d));
    for (int i1 = a; i1 <= b; ++i1) {
      const float r1 = __fsub_rn(s.x1, __fadd_rn(__fmul_rn((float)i1, g.h), g.org1));
      const float sq = __fadd_rn(p, __fmul_rn(r1, r1));
      if (sq <= g.r2max) body(r0, r1, sq, i0, i1);
    }
  }
}

// f = -beta r^2 + lambda.r in base-2 units (f * log2 e), so that exp is exp2.
__device__ __forceinline__ float fval2(const Geom& g, const Slot& s, float r0, float r1,
                                       float sq) {
  return (-g.beta * sq + s.lam0 * r0 + s.lam1 * r1) * LOG2E;
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
  float S[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // S0, S1[2], S2[3]
  int cnt = 0;
  for_each_edge(g, w, s, [&](float r0, float r1, float sq, int, int) {
    ++cnt;
    const float e = running_exp2<NEED_MOMENTS ? 6 : 1>(fval2(g, s, r0, r1, sq), fmax, S);
    S[0] += e;
    if (NEED_MOMENTS) {
      const float e0 = e * r0, e1 = e * r1;
      S[1] += e0; S[2] += e1;
      S[3] += e0 * r0; S[4] += e0 * r1; S[5] += e1 * r1;
    }
  });
  m.fmax = fmax; m.S0 = S[0];
  m.S1[0] = S[1]; m.S1[1] = S[2];
  m.S2[0] = S[3]; m.S2[1] = S[4]; m.S2[2] = S[5];
  return cnt;
}

// r = S1/Z, J = S2/Z - r(x)r and the damped closed-form symmetric inverse
// of J (pallas_transfer.py: eps = 1e-10 tr J on the diagonal, |det| clamped
// at 1e-30; the damping replaces an abort on a near-singular Hessian).
// inv holds the 3 unique entries 00 01 11.
__device__ __forceinline__ void r_and_Jinv(const Moments& m, float r[2], float inv[3]) {
  const float Zs = fmaxf(m.S0, 1e-30f);
  r[0] = m.S1[0] / Zs;
  r[1] = m.S1[1] / Zs;
  float j00 = m.S2[0] / Zs - r[0] * r[0];
  const float j01 = m.S2[1] / Zs - r[0] * r[1];
  float j11 = m.S2[2] / Zs - r[1] * r[1];
  const float eps = 1e-10f * fmaxf(j00 + j11, 1e-30f);
  j00 += eps;
  j11 += eps;
  float det = j00 * j11 - j01 * j01;
  det = fabsf(det) > 1e-30f ? det : 1e-30f;
  const float id = 1.0f / det;
  inv[0] = j11 * id;
  inv[1] = -j01 * id;
  inv[2] = j00 * id;
}

// Slot s of box cell (c0, c1): its lambda, and if it is active its position
// and cell corner.
__device__ __forceinline__ bool load_slot(const Geom& g, int s, int c0, int c1,
                                          const float* __restrict__ x,
                                          const float* __restrict__ lam,
                                          const float* __restrict__ act, Slot& sl) {
  sl.lam0 = lam[s];
  sl.lam1 = lam[g.Ns + s];
  if (!(act[s] > 0.5f)) return false;
  sl.i0 = g.b0 + c0;
  sl.i1 = g.b1 + c1;
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

// One block per cell tile.  Shared memory: the tile's footprint sums,
// channel-major (cout, f0*f1).  CNB, fixed at compile time, bounds the N
// channels (1, 4, 8 or 12; io.cN <= CNB): their values live in registers, so
// a bound as wide as the widest call would cost every narrow call registers.
template <bool SOLVE, bool NEED_DN, int CNB>
__global__ void __launch_bounds__(BLOCK)
lme_scatter2d_kernel(const Geom g, const Window w, const Tiles t, const ScatterIO io) {
  extern __shared__ float acc[];
  const int F = t.f0 * t.f1;
  for (int i = threadIdx.x; i < F * io.cout; i += BLOCK) acc[i] = 0.f;
  // the tile's first box cell, and its footprint's first node (grid frame)
  const int a0 = blockIdx.x / t.q1 * t.t0, a1 = blockIdx.x % t.q1 * t.t1;
  const int n0 = g.b0 + a0 + t.m0, n1 = g.b1 + a1 + t.m1;
  __syncthreads();

  const int tc = t.t0 * t.t1;
  const int C = g.Ns / g.nc;
  int n_edges = 0, n_iter = 0;
  for (int k = threadIdx.x; k < C * tc; k += BLOCK) {
    const int rank = k / tc, lc = k % tc;
    const int c0 = a0 + lc / t.t1, c1 = a1 + lc % t.t1;
    if (c0 >= g.c0 || c1 >= g.c1) continue;  // ragged edge tile
    const int s = rank * g.nc + c0 * g.c1 + c1;
    Slot sl;
    if (load_slot(g, s, c0, c1, io.x, io.lam, io.act, sl)) {
      Moments m;
      bool fresh = false;  // m holds the moments at the current lambda
      int ne = 0;          // the slot's valid edges
      if (SOLVE) {
        // pallas_transfer.py::_lambda_newton; a converged slot stops alone
        // (its lambda would be frozen on the TPU, so values agree)
        for (int it = 0; it < io.max_iter; ++it) {
          ne = sweep_moments<true>(g, w, sl, m);
          ++n_iter;
          float r[2], inv[3];
          r_and_Jinv(m, r, inv);
          const float rn2 = m.S0 > 0.f ? r[0] * r[0] + r[1] * r[1] : 0.f;
          if (rn2 <= io.tol2) { fresh = true; break; }
          sl.lam0 -= inv[0] * r[0] + inv[1] * r[1];
          sl.lam1 -= inv[1] * r[0] + inv[2] * r[1];
        }
      }
      if (!fresh) ne = sweep_moments<NEED_DN>(g, w, sl, m);
      n_edges += ne;

      const float iz = 1.0f / fmaxf(m.S0, 1e-30f);
      float rb[2] = {0.f, 0.f}, inv[3] = {0.f, 0.f, 0.f};
      if (NEED_DN) r_and_Jinv(m, rb, inv);
      float fv[CNB];
#pragma unroll
      for (int c = 0; c < CNB; ++c) fv[c] = c < io.cN ? io.fN[c * g.Ns + s] : 0.f;
      float G[4] = {0.f, 0.f, 0.f, 0.f}, sg = 0.f;
      if (NEED_DN) {
        if (io.has_G) {
#pragma unroll
          for (int i = 0; i < 4; ++i) G[i] = io.G[i * g.Ns + s];
        }
        if (io.gnorm) sg = io.fN[(io.cN - 1) * g.Ns + s];
      }

      // node (i0, i1) sits at (i0 - n0) * f1 + i1 - n1 in the footprint
      const int shift = n0 * t.f1 + n1;
      for_each_edge(g, w, sl, [&](float r0, float r1, float sq, int i0, int i1) {
        const float N = exp2f(fval2(g, sl, r0, r1, sq) - m.fmax) * iz;
        float* out = acc + (i0 * t.f1 + i1 - shift);
#pragma unroll
        for (int c = 0; c < CNB; ++c)
          if (c < io.cN && fv[c] != 0.f) atomicAdd(out + c * F, N * fv[c]);
        if (NEED_DN) {
          // dN = -N J^-1 (l - rbar)
          const float u0 = r0 - rb[0], u1 = r1 - rb[1];
          const float d0 = -N * (inv[0] * u0 + inv[1] * u1);
          const float d1 = -N * (inv[1] * u0 + inv[2] * u1);
          if (io.has_G) {
            atomicAdd(out + io.cN * F, G[0] * d0 + G[1] * d1);
            atomicAdd(out + (io.cN + 1) * F, G[2] * d0 + G[3] * d1);
          }
          if (io.gnorm) atomicAdd(out + (io.cout - 1) * F, sg * (d0 * d0 + d1 * d1));
        }
      });
    }
    // an inactive slot passes its lambda through unchanged
    io.lam_out[s] = sl.lam0;
    io.lam_out[g.Ns + s] = sl.lam1;
  }
  __syncthreads();

  // flush: one global atomic per non-zero footprint entry, consecutive
  // threads on neighbouring addresses of a node row (node-major, cout wide)
  for (int i = threadIdx.x; i < F * io.cout; i += BLOCK) {
    const int c = i % io.cout, fl = i / io.cout;
    const float v = acc[c * F + fl];
    if (v == 0.f) continue;  // untouched, or outside the valid nodes
    const int j0 = n0 + fl / t.f1, j1 = n1 + fl % t.f1;
    atomicAdd(io.nodes + (size_t)(j0 * g.n1 + j1) * io.cout + c, v);
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
  int same;            // gN is gg (cN = 2): its rows are read once
};

// One sweep at fixed lambda.  With e = exp(f - max f) and l = x_p - x_A:
//   S0 = sum e, S1 = sum e*l, S2 = sum e*l(x)l, q_c = sum e*gN_A,c,
//   p_i = sum e*gg_A,i, M_ik = sum e*gg_A,i*l_k;
// then N-gather q/Z and, with rbar = S1/Z and J^-1 from S2,
//   outG_ij = -(1/Z) sum_k (M_ik - p_i*rbar_k) J^-1_kj,
// which is sum_A gg_A,i dN_A/dx_j with dN_A = -N_A J^-1 (l_A - rbar).
// CN, the N-gather's channel count, is fixed at compile time (1-12): a row
// whose length is known only at run time would make each load wait behind
// a branch.
template <bool HAS_N, bool HAS_GRAD, int CN>
__global__ void __launch_bounds__(BLOCK)
lme_gather2d_kernel(const Geom g, const Window w, const GatherIO io) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= g.Ns) return;
  // running sums, all rescaled together: S0, S1[2], S2[3], p[2], M[4] (with
  // the gradient), q[CN]
  constexpr int NG = HAS_GRAD ? 12 : 1;
  float acc[NG + CN];
#pragma unroll
  for (int i = 0; i < NG + CN; ++i) acc[i] = 0.f;
  float* q = acc + NG;
  Slot sl;
  const int cell = s % g.nc;
  if (load_slot(g, s, cell / g.c1, cell % g.c1, io.x, io.lam, io.act, sl)) {
    float fmax = NEG_BIG;
    for_each_edge(g, w, sl, [&](float r0, float r1, float sq, int i0, int i1) {
      const int node = i0 * g.n1 + i1;
      const float e = running_exp2<NG + CN>(fval2(g, sl, r0, r1, sq), fmax, acc);
      acc[0] += e;
      if (HAS_GRAD) {
        const float e0 = e * r0, e1 = e * r1;
        acc[1] += e0; acc[2] += e1;
        acc[3] += e0 * r0; acc[4] += e0 * r1; acc[5] += e1 * r1;
        const float2 u = __ldg(reinterpret_cast<const float2*>(io.gg) + node);
        const float eu0 = e * u.x, eu1 = e * u.y;
        acc[6] += eu0; acc[7] += eu1;
        acc[8] += eu0 * r0; acc[9] += eu0 * r1;
        acc[10] += eu1 * r0; acc[11] += eu1 * r1;
      }
      if (HAS_N && !(HAS_GRAD && io.same)) {
        const float* f_ = io.gN + (size_t)node * CN;
        float v[CN > 0 ? CN : 1];
#pragma unroll
        for (int c = 0; c < CN; ++c) v[c] = __ldg(f_ + c);
#pragma unroll
        for (int c = 0; c < CN; ++c) q[c] += e * v[c];
      }
    });
    if (HAS_GRAD && io.same) {
#pragma unroll
      for (int c = 0; c < CN && c < 2; ++c) q[c] = acc[6 + c];
    }
  }
  // an inactive slot writes zeros: every sum is 0, and so is every product
  // with 1/max(Z, 1e-30)
  const float iz = 1.0f / fmaxf(acc[0], 1e-30f);
  if (HAS_N) {
#pragma unroll
    for (int c = 0; c < CN; ++c) io.outN[(size_t)s * CN + c] = q[c] * iz;
  }
  if (HAS_GRAD) {
    Moments m;
    m.S0 = acc[0];
    m.S1[0] = acc[1]; m.S1[1] = acc[2];
    m.S2[0] = acc[3]; m.S2[1] = acc[4]; m.S2[2] = acc[5];
    float rb[2], inv[3];
    r_and_Jinv(m, rb, inv);
    const float b00 = acc[8] - acc[6] * rb[0], b01 = acc[9] - acc[6] * rb[1];
    const float b10 = acc[10] - acc[7] * rb[0], b11 = acc[11] - acc[7] * rb[1];
    reinterpret_cast<float4*>(io.outG)[s] = make_float4(
        -iz * (b00 * inv[0] + b01 * inv[1]), -iz * (b00 * inv[1] + b01 * inv[2]),
        -iz * (b10 * inv[0] + b11 * inv[1]), -iz * (b10 * inv[1] + b11 * inv[2]));
  }
}

// The window's n_offs (o0, o1) pairs as rows: a run of pairs with the same
// o0 and o1 rising by one is one row, in the order given.
static int fill_window(Window& w, const int* offs, int n_offs) {
  if (n_offs < 1 || n_offs > MAX_PAIRS) return 1;
  w.n = 0;
  for (int k = 0; k < n_offs; ++k) {
    const int a = offs[2 * k], b = offs[2 * k + 1];
    if (a < -127 || a > 127 || b < -127 || b > 127) return 1;
    const int r = w.n - 1;
    if (r >= 0 && w.o0[r] == a && w.hi1[r] + 1 == b) {
      w.hi1[r] = (signed char)b;
      continue;
    }
    w.o0[w.n] = (signed char)a;
    w.lo1[w.n] = w.hi1[w.n] = (signed char)b;
    ++w.n;
  }
  return 0;
}

static int make_geom(Geom& g, int Ns, int nc, int c1, int b0, int b1, int n1, int lo0, int hi0,
                     int lo1, int hi1, float h, float beta, float r2max, float org0,
                     float org1) {
  if (Ns < 1 || nc < 1 || c1 < 1 || Ns % nc || nc % c1) return 1;
  g.Ns = Ns; g.nc = nc; g.c0 = nc / c1; g.c1 = c1; g.b0 = b0; g.b1 = b1; g.n1 = n1;
  g.lo0 = lo0; g.hi0 = hi0; g.lo1 = lo1; g.hi1 = hi1;
  g.h = h; g.inv_h = 1.0f / h; g.beta = beta; g.r2max = r2max; g.org0 = org0; g.org1 = org1;
  return 0;
}

// Both entry points return a cudaError_t as int (0 = success; 1 =
// cudaErrorInvalidValue also for arguments refused here).  ``offs`` is a HOST
// array of n_offs (o0, o1) pairs; ``plan`` (scatter) a HOST array of the
// tile plan: tile cells t0 t1, footprint nodes f0 f1, lowest window offset
// m0 m1 per axis.  Launches on ``stream``; never synchronises.
template <bool SOLVE, bool NEED_DN, int CNB>
static int launch_scatter(const Geom& g, const Window& w, const Tiles& t, const ScatterIO& io,
                          int blocks, int smem, cudaStream_t st) {
  auto kernel = lme_scatter2d_kernel<SOLVE, NEED_DN, CNB>;
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

extern "C" int lme_scatter2d(
    const void* x, const void* lam, const void* act, const void* fN, const void* G,
    void* nodes, void* lam_out, void* cnt,
    int Ns, int nc, int c1, int b0, int b1, int n1, int lo0, int hi0, int lo1, int hi1,
    float h, float beta, float r2max, float org0, float org1,
    const int* offs, int n_offs, const int* plan,
    int cN, int has_G, int gnorm, int solve, int max_iter, float tol2, void* stream) {
  Window w;
  Geom g;
  if (fill_window(w, offs, n_offs)) return 1;
  if (cN < 1 || cN > MAX_CN) return 1;
  if (make_geom(g, Ns, nc, c1, b0, b1, n1, lo0, hi0, lo1, hi1, h, beta, r2max, org0, org1))
    return 1;
  Tiles t;
  t.t0 = plan[0]; t.t1 = plan[1];
  t.f0 = plan[2]; t.f1 = plan[3];
  t.m0 = plan[4]; t.m1 = plan[5];
  if (t.t0 < 1 || t.t1 < 1) return 1;
  t.q1 = (g.c1 + t.t1 - 1) / t.t1;
  const int q0 = (g.c0 + t.t0 - 1) / t.t0;
  // every window node of every tile cell must fall inside the footprint
  for (int k = 0; k < w.n; ++k) {
    if (w.o0[k] < t.m0 || w.o0[k] + t.t0 > t.m0 + t.f0 || w.lo1[k] < t.m1 ||
        w.hi1[k] + t.t1 > t.m1 + t.f1)
      return 1;
  }
  ScatterIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.fN = (const float*)fN; io.G = (const float*)G;
  io.nodes = (float*)nodes; io.lam_out = (float*)lam_out; io.cnt = (int*)cnt;
  io.cN = cN; io.has_G = has_G; io.gnorm = gnorm;
  io.cout = cN + (has_G ? 2 : 0) + (gnorm ? 1 : 0);
  io.max_iter = max_iter; io.tol2 = tol2;
  // fused_transfer.py::tile_plan keeps this within a block's 227 KB
  const long long smem = 4LL * t.f0 * t.f1 * io.cout;
  const int blocks = q0 * t.q1;
  return launch_scatter_cn(cN, solve, has_G || gnorm, g, w, t, io, blocks, (int)smem,
                           (cudaStream_t)stream);
}

template <bool HAS_N, bool HAS_GRAD, int CN>
static void launch_gather(const Geom& g, const Window& w, const GatherIO& io, cudaStream_t st) {
  lme_gather2d_kernel<HAS_N, HAS_GRAD, CN><<<(g.Ns + BLOCK - 1) / BLOCK, BLOCK, 0, st>>>(g, w, io);
}

template <bool HAS_GRAD>
static void launch_gather_n(int cN, const Geom& g, const Window& w, const GatherIO& io,
                            cudaStream_t st) {
  switch (cN) {
    case 1: launch_gather<true, HAS_GRAD, 1>(g, w, io, st); break;
    case 2: launch_gather<true, HAS_GRAD, 2>(g, w, io, st); break;
    case 3: launch_gather<true, HAS_GRAD, 3>(g, w, io, st); break;
    case 4: launch_gather<true, HAS_GRAD, 4>(g, w, io, st); break;
    case 5: launch_gather<true, HAS_GRAD, 5>(g, w, io, st); break;
    case 6: launch_gather<true, HAS_GRAD, 6>(g, w, io, st); break;
    case 7: launch_gather<true, HAS_GRAD, 7>(g, w, io, st); break;
    case 8: launch_gather<true, HAS_GRAD, 8>(g, w, io, st); break;
    case 9: launch_gather<true, HAS_GRAD, 9>(g, w, io, st); break;
    case 10: launch_gather<true, HAS_GRAD, 10>(g, w, io, st); break;
    case 11: launch_gather<true, HAS_GRAD, 11>(g, w, io, st); break;
    default: launch_gather<true, HAS_GRAD, 12>(g, w, io, st); break;
  }
}

extern "C" int lme_gather2d(
    const void* x, const void* lam, const void* act, const void* gN, const void* gg,
    void* outN, void* outG,
    int Ns, int nc, int c1, int b0, int b1, int n1, int lo0, int hi0, int lo1, int hi1,
    float h, float beta, float r2max, float org0, float org1,
    const int* offs, int n_offs, int cN, void* stream) {
  Window w;
  Geom g;
  if (fill_window(w, offs, n_offs)) return 1;
  const bool has_n = gN != nullptr, has_grad = gg != nullptr;
  if ((!has_n && !has_grad) || (has_n && (cN < 1 || cN > MAX_CN))) return 1;
  if (make_geom(g, Ns, nc, c1, b0, b1, n1, lo0, hi0, lo1, hi1, h, beta, r2max, org0, org1))
    return 1;
  GatherIO io;
  io.x = (const float*)x; io.lam = (const float*)lam; io.act = (const float*)act;
  io.gN = (const float*)gN; io.gg = (const float*)gg;
  io.outN = (float*)outN; io.outG = (float*)outG;
  io.same = has_n && has_grad && gN == gg && cN == 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_n && has_grad) launch_gather_n<true>(cN, g, w, io, st);
  else if (has_n) launch_gather_n<false>(cN, g, w, io, st);
  else launch_gather<false, true, 0>(g, w, io, st);
  return (int)cudaGetLastError();
}
