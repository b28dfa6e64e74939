"""Batched small-tensor algebra on arrays of shape ``(..., d, d)``.

Counterpart of ``nlpartsol_tpu/ops/tensor.py``: closed-form determinant,
adjugate and inverse for d in {2, 3}, the invariants, the symmetric eigen
solvers (closed form in 2D, cyclic Jacobi in 3D: no LAPACK or cuSOLVER call)
and the cancellation-free small-strain primitives.  The reference unrolls
its small matrix products into channel arithmetic to keep them off the TPU's
matrix unit; here they are a broadcast multiply and a sum, to keep them off
the BLAS library's batched GEMM (see :func:`bmm`).
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

Tensor = torch.Tensor


def trace(a: Tensor) -> Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def det(a: Tensor) -> Tensor:
    """Determinant of (..., d, d), closed form for d=2,3."""
    d = a.shape[-1]
    if d == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    if d == 3:
        return (
            a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
        )
    raise ValueError(f"det: unsupported dim {d}")


def adj(a: Tensor) -> Tensor:
    """Adjugate (transpose of cofactor matrix): inv(a) = adj(a)/det(a)."""
    d = a.shape[-1]
    if d == 2:
        row0 = torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1)
        row1 = torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    if d == 3:

        def cof(i1, i2, j1, j2):
            return a[..., i1, j1] * a[..., i2, j2] - a[..., i1, j2] * a[..., i2, j1]

        rows = [
            torch.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], dim=-1),
            torch.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], dim=-1),
            torch.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], dim=-1),
        ]
        return torch.stack(rows, dim=-2)
    raise ValueError(f"adj: unsupported dim {d}")


def inv(a: Tensor) -> Tensor:
    return adj(a) / det(a)[..., None, None]


def inv_transpose(a: Tensor) -> Tensor:
    """a^{-T}: the push-forward operator for shape-function gradients."""
    return inv(a).transpose(-1, -2)


def identity_like(a: Tensor) -> Tensor:
    d = a.shape[-1]
    return torch.eye(d, dtype=a.dtype, device=a.device).expand(a.shape)


def I1(a: Tensor) -> Tensor:
    return trace(a)


def I2(a: Tensor) -> Tensor:
    t = trace(a)
    return 0.5 * (t * t - trace(bmm(a, a)))


def I3(a: Tensor) -> Tensor:
    return det(a)


def sym(a: Tensor) -> Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def dev(a: Tensor) -> Tensor:
    d = a.shape[-1]
    return a - (trace(a) / d)[..., None, None] * torch.eye(d, dtype=a.dtype, device=a.device)


def norm_fro(a: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))


# ---------------------------------------------------------------------------
# Symmetric eigendecomposition, closed-form 2x2 / Jacobi 3x3.  Not
# torch.linalg.eigh: that is LAPACK on the CPU and cuSOLVER on the card, two
# other algorithms than the reference's, and it reads back an error status.
# ---------------------------------------------------------------------------


def _sym_eig2(a: Tensor):
    a00, a01, a11 = a[..., 0, 0], 0.5 * (a[..., 0, 1] + a[..., 1, 0]), a[..., 1, 1]
    tr_half = 0.5 * (a00 + a11)
    diff_half = 0.5 * (a00 - a11)
    rad = torch.sqrt(diff_half * diff_half + a01 * a01)
    w0 = tr_half - rad
    w1 = tr_half + rad
    # eigenvector of w1: (a01, w1 − a00); on a diagonal tensor the axis of
    # the larger entry
    one, zero = torch.ones_like(a00), torch.zeros_like(a00)
    diag = a01 == 0.0
    first = a00 >= a11
    v1x = torch.where(diag, torch.where(first, one, zero), a01)
    v1y = torch.where(diag, torch.where(first, zero, one), w1 - a00)
    n1 = torch.sqrt(v1x * v1x + v1y * v1y)
    v1x, v1y = v1x / n1, v1y / n1
    v0x, v0y = -v1y, v1x  # v0 orthogonal to v1
    w = torch.stack([w0, w1], dim=-1)
    v = torch.stack(
        [torch.stack([v0x, v1x], dim=-1), torch.stack([v0y, v1y], dim=-1)], dim=-2
    )
    return w, v


def _jacobi_rotation(A: Tensor, p: int, q: int) -> Tensor:
    """The rotation G that zeroes A[p, q] in Gᵀ·A·G (stable angle)."""
    apq, app, aqq = A[..., p, q], A[..., p, p], A[..., q, q]
    one = torch.ones_like(apq)
    off = apq == 0.0
    tau = (aqq - app) / (2.0 * torch.where(off, one, apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, one, t)
    t = torch.where(off, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    entries = {(p, p): c, (q, q): c, (p, q): s, (q, p): -s}
    zero = torch.zeros_like(c)
    rows = [
        torch.stack([entries.get((i, j), one if i == j else zero) for j in range(3)], dim=-1)
        for i in range(3)
    ]
    return torch.stack(rows, dim=-2)


def _sym_eig3_jacobi(a: Tensor, sweeps: int = 8):
    """Cyclic Jacobi for symmetric 3x3 (a fixed number of sweeps, no data-
    dependent control flow).  Returns eigenvalues ascending and the matrix of
    column eigenvectors; equal eigenvalues keep their order (stable sort)."""
    A = sym(a)
    V = identity_like(A)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            G = _jacobi_rotation(A, p, q)
            A = bmm(G.transpose(-1, -2), bmm(A, G))
            V = bmm(V, G)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1, stable=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def sym_eig(a: Tensor):
    """Eigendecomposition of a symmetric (..., d, d) tensor.

    Returns ``(w, V)`` with eigenvalues ascending and eigenvectors as columns
    of V, i.e. ``a ≈ V @ diag(w) @ V.T``.
    """
    d = a.shape[-1]
    if d == 2:
        return _sym_eig2(a)
    if d == 3:
        return _sym_eig3_jacobi(a)
    raise ValueError(f"sym_eig: unsupported dim {d}")


def sym_from_eig(w: Tensor, V: Tensor) -> Tensor:
    """Rebuild a symmetric tensor from eigenvalues/eigenvectors."""
    return bmm_t(V * w[..., None, :], V)


def sym_func(a: Tensor, fn) -> Tensor:
    """Apply a scalar function to a symmetric tensor through its spectrum
    (e.g. ``sym_func(b_e, torch.log)`` for Hencky strain)."""
    w, V = sym_eig(a)
    return sym_from_eig(fn(w), V)


# ---------------------------------------------------------------------------
# Isotropic tensor functions with an exact forward-mode tangent.
#
# Forward mode through sym_eig is wrong where the spectrum is degenerate or
# the tensor diagonal: the 2D radius sqrt(diff² + a01²) has a 0·∞ tangent
# at coincident eigenvalues, and on a diagonal tensor both solvers pick
# their eigenvectors by ``where`` on constants, whose tangent is zero, so
# the shear part of the tangent is lost.  :func:`isotropic_map` never
# differentiates the eigenvectors.  For T = Σ_i t_i n_i⊗n_i with
# t = h(λ), in the primal eigenbasis (Â = Vᵀ·A·V):
#   dT̂_ii = Σ_j ∂h_i/∂λ_j · dÂ_jj            (forward mode through h)
#   dT̂_ij = (t_i − t_j)/(λ_i − λ_j) · dÂ_ij   (i ≠ j)
# and where λ_i = λ_j the divided difference takes its limit
# ∂h_i/∂λ_i − ∂h_i/∂λ_j, the derivative of h_i − h_j along (e_i − e_j)/2.
# ---------------------------------------------------------------------------

_PAIRS = {2: ((0, 1),), 3: ((0, 1), (0, 2), (1, 2))}


def tangent_of(x):
    """The forward-mode tangent of ``x`` (None outside a dual level, or
    for a tensor that carries none)."""
    return fwAD.unpack_dual(x).tangent


# The principal Jacobians of the last dual call of each map (by its key):
# a Newton-Krylov solve takes every J·v of a Newton iteration at the same
# iterate, so all but the first reuse them.  Held as plain tensors beside
# the eigenvalues and arguments they were taken at; used only where those
# are equal (a NaN never is: such inputs are taken afresh each time).
_JACOBIANS: dict = {}


def clear_jacobian_cache() -> None:
    _JACOBIANS.clear()


def map_key(fn):
    """A cache key of a principal map: its code and the plain values (a
    yield kind, iteration counts, tolerances) its closure holds."""
    cells = tuple(c.cell_contents for c in fn.__closure__ or ())
    return (fn.__code__,) + tuple(v for v in cells
                                  if v is None or isinstance(v, (bool, int, float, str)))


def isotropic_map(a: Tensor, fn, *args, key=None):
    """Isotropic tensor functions of the symmetric (..., d, d) tensor ``a``.

    ``fn(w, *args)`` maps the eigenvalues w (…, d), ascending, to ``(vals,
    extra)``: ``vals`` a tuple of principal arrays (…, m ≥ d) whose first d
    entries are the principal values of an output tensor, ``extra`` a tuple
    of other outputs.  Returns ``(tensors, vals, extra)`` with tensors[k] =
    Σ_i vals[k][..., i] n_i⊗n_i.

    Without a tangent on ``a`` this is sym_eig, fn and sym_from_eig, nothing
    more.  With one, the eigenpairs are those of a's primal, and the
    Jacobian of fn's outputs with respect to w comes from one run of fn on a
    stack of d copies of w along a new leading axis, copy k with the
    tangent e_k (or from the last such run, where w and ``args`` are equal
    to its).  The outputs get the tangents of the section comment above,
    with dλ_i = n_i·dA·n_i and the limit of a divided difference
    ½(J_ii − J_ij − J_ji + J_jj).  fn must broadcast ``args`` (history,
    parameters) against that leading axis; they must carry no tangent, and
    fn gets them with a zero one.  ``key`` names fn in the cache (default
    :func:`map_key`): two maps under one key must differ in ``args``."""
    d = a.shape[-1]
    a0, da = fwAD.unpack_dual(a)
    if da is None:
        w, V = sym_eig(a)
        vals, extra = fn(w, *args)
        return tuple(sym_from_eig(v[..., :d], V) for v in vals), vals, extra

    w, V = sym_eig(a0)
    dah = bmm(V.transpose(-1, -2), bmm(da, V))  # Vᵀ·dA·V
    dw = torch.diagonal(dah, dim1=-2, dim2=-1)
    vals_p, vals_J, extra_p, extra_J = _principal_jacobians(
        fn, w, args, map_key(fn) if key is None else key)

    def tangent(J):  # Σ_k J[..., k]·dλ_k, for a per-row or a (…, m) output
        return (J * (dw if J.dim() == dw.dim() else dw[..., None, :])).sum(-1)

    # eigenvalues closer than rel of their size, or whose divided difference
    # would lose more than rel·|∂t/∂λ| to cancellation (eps·|t|/gap), take
    # the limit, which is off by O(gap) on the scale the map varies over
    rel = float(torch.finfo(w.dtype).eps) ** 0.5
    tensors, vals = [], []
    for v_p, J in zip(vals_p, vals_J):
        dv = tangent(J)
        t = v_p[..., :d]
        M = torch.diag_embed(dv[..., :d])
        for i, j in _PAIRS[d]:
            gap = w[..., i] - w[..., j]
            slope = torch.maximum(J[..., i, i].abs(), J[..., j, j].abs())
            apart = ((gap.abs() > rel * torch.maximum(w[..., i].abs(), w[..., j].abs()))
                     & (gap.abs() * slope > rel * torch.maximum(t[..., i].abs(), t[..., j].abs())))
            divided = (t[..., i] - t[..., j]) / torch.where(apart, gap, torch.ones_like(gap))
            limit = 0.5 * (J[..., i, i] - J[..., i, j] - J[..., j, i] + J[..., j, j])
            c = torch.where(apart, divided, limit) * dah[..., i, j]
            M = M + c[..., None, None] * _sym_unit(d, i, j, M)
        tensors.append(fwAD.make_dual(sym_from_eig(t, V), bmm_t(bmm(V, M), V)))
        vals.append(fwAD.make_dual(v_p, dv))
    extra = tuple(e if J is None else fwAD.make_dual(e, tangent(J))
                  for e, J in zip(extra_p, extra_J))
    return tuple(tensors), tuple(vals), extra


def _principal_jacobians(fn, w, args, key):
    """fn's primal outputs at (w, args) and their Jacobians with respect to
    w, (…, m, d) (None for an output without a tangent), from the cache or
    from one run of fn on d copies of w."""
    hit = _JACOBIANS.get(key)
    if hit is not None and _same(hit[0], (w,) + args):
        return hit[1]
    d = w.shape[-1]
    dirs = torch.eye(d, dtype=w.dtype, device=w.device)[:, None, :].expand(d, *w.shape)
    w_all = fwAD.make_dual(w.expand(d, *w.shape).contiguous(), dirs.contiguous())
    vals_all, extra_all = fn(w_all, *(_zero_tangent(x) for x in args))

    def split(v):
        v_p, v_t = fwAD.unpack_dual(v)
        J = None if v_t is None else torch.movedim(v_t, 0, -1)
        return v_p[0], J

    vals = [split(v) for v in vals_all]
    extra = [split(e) for e in extra_all]
    out = ([v for v, _ in vals], [J for _, J in vals], [e for e, _ in extra],
           [J for _, J in extra])
    _JACOBIANS[key] = (tuple(x.clone() if isinstance(x, Tensor) else x for x in (w,) + args),
                       out)
    return out


def _same(held, now):
    """Whether ``now`` equals ``held``, argument by argument (one host
    read)."""
    if len(held) != len(now):
        return False
    checks = []
    for x, y in zip(held, now):
        if not isinstance(x, Tensor) or not isinstance(y, Tensor):
            if isinstance(x, Tensor) or isinstance(y, Tensor) or x != y:
                return False
        elif x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
            return False
        else:
            checks.append((x == y).all())
    return not checks or bool(torch.stack(checks).all())


def _zero_tangent(x):
    """A float tensor with a zero tangent.  On the host, forward mode takes
    a slow path for an op between a dual and a plain tensor (its efficient
    zero tangent): 0.31 ms against 0.008 ms between two duals, for a
    (100, 3) product with torch 2.13 on a CPU core."""
    if not isinstance(x, Tensor) or not x.is_floating_point():
        return x
    if tangent_of(x) is not None:
        raise ValueError("isotropic_map: an argument of fn carries a forward-mode tangent")
    return fwAD.make_dual(x, torch.zeros_like(x))


def _sym_unit(d, i, j, like):
    """e_i⊗e_j + e_j⊗e_i as a (d, d) tensor."""
    u = torch.zeros((d, d), dtype=like.dtype, device=like.device)
    u[i, j] = u[j, i] = 1.0
    return u


# ---------------------------------------------------------------------------
# Cancellation-free small-strain primitives.
#
# In float32 quantities like det(F)−1, b−I and ln(J) lose all significance
# when F ≈ I.  Everything downstream therefore works with the displacement
# gradient A = F − I and these exact identities:
#   det(I+A) − 1 = I1(A) + I2(A) + I3(A)
#   (I+A)(I+A)ᵀ − I = A + Aᵀ + AAᵀ,  (I+A)ᵀ(I+A) − I = A + Aᵀ + AᵀA
#   x − log1p(x) = x²/2 − x³/3 + …   (series for small x)
# ---------------------------------------------------------------------------


def det_minus_one(a_disp: Tensor) -> Tensor:
    """det(I + A) − 1 computed without cancellation; A = F − I."""
    d = a_disp.shape[-1]
    if d == 2:
        return trace(a_disp) + det(a_disp)
    t = trace(a_disp)
    i2 = 0.5 * (t * t - trace(bmm(a_disp, a_disp)))
    return t + i2 + det(a_disp)


def bmi_from_disp_grad(a_disp: Tensor) -> Tensor:
    """b − I = A + Aᵀ + AAᵀ (left Cauchy-Green minus identity)."""
    return a_disp + a_disp.transpose(-1, -2) + bmm_t(a_disp, a_disp)


def cmi_from_disp_grad(a_disp: Tensor) -> Tensor:
    """C − I = A + Aᵀ + AᵀA (right Cauchy-Green minus identity)."""
    a_t = a_disp.transpose(-1, -2)
    return a_disp + a_t + bmm(a_t, a_disp)


def sub_log1p(x: Tensor) -> Tensor:
    """x − log1p(x), accurate for small x (≈ x²/2 − x³/3 + x⁴/4)."""
    small = torch.abs(x) < 1e-2
    x_safe = torch.where(small, torch.zeros_like(x), x)
    series = x * x * (0.5 + x * (-1.0 / 3.0 + x * (0.25 - 0.2 * x)))
    return torch.where(small, series, x_safe - torch.log1p(x_safe))


def bmm(a: Tensor, b: Tensor) -> Tensor:
    """Batched small-matrix product a @ b as one broadcast multiply and one
    sum over the contracted index.

    Not ``a @ b``: on (Ns, 2, 2) operands that dispatches to a batched GEMM
    of the BLAS library, whose 32×32 tiles are wasted on 2×2 matrices — on
    an H100 the five such products of an explicit step took 3.8 ms of a
    5.7 ms step at Ns = 405,600 (``chip_smoke.py --phases main_path,profile``).
    """
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def bmm_t(a: Tensor, b: Tensor) -> Tensor:
    """a @ bᵀ (see bmm)."""
    return (a[..., :, None, :] * b[..., None, :, :]).sum(-1)


def bmv(a: Tensor, v: Tensor) -> Tensor:
    """Batched matrix·vector (see bmm)."""
    return (a * v[..., None, :]).sum(-1)
