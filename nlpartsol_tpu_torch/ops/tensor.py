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
