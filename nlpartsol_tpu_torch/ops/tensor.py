"""Batched small-tensor algebra on arrays of shape ``(..., d, d)``.

Counterpart of ``nlpartsol_tpu/ops/tensor.py``: closed-form determinant,
adjugate and inverse for d in {2, 3}, and the cancellation-free small-strain
primitives.  The reference unrolls its small matrix products into channel
arithmetic to keep them off the TPU's matrix unit; here they are a broadcast
multiply and a sum, to keep them off the BLAS library's batched GEMM (see
:func:`bmm`).  The symmetric eigen solvers come with the models that need
them.
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


# ---------------------------------------------------------------------------
# Cancellation-free small-strain primitives.
#
# In float32 quantities like det(F)−1, b−I and ln(J) lose all significance
# when F ≈ I.  Everything downstream therefore works with the displacement
# gradient A = F − I and these exact identities:
#   det(I+A) − 1 = I1(A) + I2(A) + I3(A)
#   (I+A)(I+A)ᵀ − I = A + Aᵀ + AAᵀ
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
