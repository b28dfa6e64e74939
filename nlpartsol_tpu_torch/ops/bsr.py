"""Banded block-sparse (BSR) tangent: assembly, SpMV, block-Jacobi.

Counterpart of ``nlpartsol_tpu/ops/bsr.py``, the replacement of the
reference's assembled PETSc AIJ tangent.  On the structured background grid
the stencil "node pairs sharing a particle" is banded by construction: a
particle in cell c touches nodes c + off_i for the static window offsets
off_i, so every nonzero block sits at a column offset rel = off_j − off_i
drawn from a static set of R relative offsets.  The matrix is a dense band

    band[node, r, :, :]   (n_nodes, R, d, d)

and assembly and SpMV are static-slice dense operations: no sparsity
pattern, no scatter.  Per-particle blocks come from the exact consistent
tangent by forward-mode AD of the internal-force integrand
(``formulations/implicit.py::edge_force_jacobian``):

    H[p, A, i, l, m] = ∂ f_{A,i} / ∂ (∇du)_{l,m}
    K_{AB}[i, l]     = Σ_m H[p, A, i, l, m] · ∇N_B[m]

Plain tensor code on either device; the implicit step's ``block-jacobi``
preconditioner (windowed engine) and ``implicit.assemble_tangent`` use it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import Grid, Record
from . import tensor as tn
from .windowed import ActiveBox, _node_slices

Tensor = torch.Tensor


def relative_offsets(offsets: np.ndarray):
    """Static set of pairwise offset differences off_j − off_i.

    Returns (rels (R, d) int array, pair_index (K, K) int array with
    pair_index[i, j] = r such that rels[r] = off_j − off_i)."""
    offsets = np.asarray(offsets)
    K = offsets.shape[0]
    diffs = offsets[None, :, :] - offsets[:, None, :]  # (K, K, d) j − i
    rels, inverse = np.unique(diffs.reshape(K * K, -1), axis=0, return_inverse=True)
    return rels.astype(np.int64), inverse.reshape(K, K)


@dataclasses.dataclass(frozen=True)
class BandedBSR(Record):
    """Banded block matrix over grid nodes: A[n, n + rel_r] = band[n, r]."""

    band: Tensor  # (n_nodes, R, d, d)
    rels: tuple  # ((dr per axis), ...), R of them
    grid_dims: tuple

    @property
    def dim(self) -> int:
        return len(self.grid_dims)

    @property
    def d(self) -> int:
        return self.band.shape[-1]


def _shift_slices(grid_dims, rel):
    """Row/column node slices such that row + rel = col, both in-grid."""
    rs, cs = [], []
    for ax, r in enumerate(rel):
        n = grid_dims[ax]
        a0, a1 = max(0, -int(r)), min(n, n - int(r))
        if a1 <= a0:
            return None
        rs.append(slice(a0, a1))
        cs.append(slice(a0 + int(r), a1 + int(r)))
    return tuple(rs), tuple(cs)


def assemble(
    H: Tensor,  # (Ns, K, d, d, d)  ∂f_{A,i}/∂grad_{lm} per edge
    dN: Tensor,  # (Ns, K, d) reference-config shape gradients
    mask: Tensor,  # (Ns, K) valid edges
    box: ActiveBox,
    grid: Grid,
    offsets: np.ndarray,
) -> BandedBSR:
    """Assemble the banded tangent from per-particle edge jacobians: for every
    static window pair (i, j) the block Σ_m H[:, i, :, :, m]·dN[:, j, m],
    summed over the capacity axis, is added by static slices into band slot
    r = index(off_j − off_i)."""
    rels, pair_index = relative_offsets(offsets)
    K = offsets.shape[0]
    d = dN.shape[-1]
    band = torch.zeros(tuple(grid.dims) + (rels.shape[0], d, d), dtype=H.dtype,
                       device=H.device)
    m2 = mask[:, :, None, None]
    dN_m = torch.where(mask[..., None], dN, torch.zeros_like(dN))
    for i in range(K):
        Bi = torch.einsum("silm,sjm->sjil", H[:, i], dN_m)  # (Ns, K, d, d)
        Bi = torch.where(m2[:, i:i + 1] & m2, Bi, torch.zeros_like(Bi))
        per_cell = Bi.reshape((box.capacity,) + tuple(box.cdims) + (K, d, d)).sum(dim=0)
        sl = _node_slices(box, grid.dims, offsets[i])
        if sl is None:
            continue
        cs, ns = sl
        for j in range(K):
            band[ns + (int(pair_index[i, j]),)] += per_cell[cs + (j,)]
    return BandedBSR(
        band=band.reshape(grid.n_nodes, rels.shape[0], d, d),
        rels=tuple(tuple(int(v) for v in r) for r in rels),
        grid_dims=tuple(grid.dims),
    )


def matvec(A: BandedBSR, x: Tensor) -> Tensor:
    """y[A] = Σ_r band[A, r] · x[A + rel_r]: R static shifted dense
    contractions."""
    xg = x.reshape(tuple(A.grid_dims) + (A.d,))
    bg = A.band.reshape(tuple(A.grid_dims) + A.band.shape[1:])
    y = torch.zeros_like(xg)
    for r, rel in enumerate(A.rels):
        sl = _shift_slices(A.grid_dims, rel)
        if sl is None:
            continue
        rs, cs = sl
        y[rs] += tn.bmv(bg[rs + (r,)], xg[cs])
    return y.reshape(x.shape)


def apply_dof_masks(A: BandedBSR, free: Tensor) -> BandedBSR:
    """Zero rows and columns of constrained dofs and put a unit diagonal
    there (the ``MatZeroRowsColumnsIS`` equivalent)."""
    d = A.d
    fg = free.reshape(tuple(A.grid_dims) + (d,)).to(A.band.dtype)
    bg = A.band.reshape(tuple(A.grid_dims) + A.band.shape[1:])
    out = torch.zeros_like(bg)
    eye = torch.eye(d, dtype=A.band.dtype, device=A.band.device)
    for r, rel in enumerate(A.rels):
        sl = _shift_slices(A.grid_dims, rel)
        if sl is None:
            continue
        rs, cs = sl
        blk = bg[rs + (r,)] * fg[rs][..., :, None] * fg[cs][..., None, :]
        if all(v == 0 for v in rel):
            blk = blk + eye * (1.0 - fg[rs])[..., :, None]
        out[rs + (r,)] = blk
    return A.replace(band=out.reshape(A.band.shape))


def add_diagonal(A: BandedBSR, shift: Tensor) -> BandedBSR:
    """A + diag(shift ⊗ I_d), e.g. the α₁·M inertial diagonal."""
    eye = torch.eye(A.d, dtype=A.band.dtype, device=A.band.device)
    r0 = A.rels.index((0,) * len(A.grid_dims))
    band = A.band.clone()
    band[:, r0] += shift[:, None, None] * eye
    return A.replace(band=band)


def to_dense(A: BandedBSR) -> Tensor:
    """Dense (n·d, n·d) matrix — a test oracle only."""
    dims = np.asarray(A.grid_dims)
    n, d = int(np.prod(dims)), A.d
    dense = torch.zeros((n, d, n, d), dtype=A.band.dtype, device=A.band.device)
    node_idx = np.indices(A.grid_dims).reshape(len(A.grid_dims), -1).T
    strides = np.concatenate([np.cumprod(dims[::-1])[-2::-1], [1]]).astype(np.int64)
    flat = node_idx @ strides
    for r, rel in enumerate(A.rels):
        col_idx = node_idx + np.asarray(rel)
        ok = np.all((col_idx >= 0) & (col_idx < dims), axis=1)
        rows = torch.as_tensor(flat[ok], device=A.band.device)
        cols = torch.as_tensor(col_idx[ok] @ strides, device=A.band.device)
        dense[rows, :, cols, :] += A.band[rows, r]
    return dense.reshape(n * d, n * d)


def block_jacobi_inverse(
    diag_blocks: Tensor,  # (n_nodes, d, d)
    free: Optional[Tensor] = None,  # (n_nodes, d) free-dof mask
    shift: Optional[Tensor] = None,  # (n_nodes,) added to the diagonal
) -> Tensor:
    """Per-node closed-form inverse of the symmetrised, regularised,
    dof-masked diagonal blocks (the block upgrade of PCJACOBI)."""
    d = diag_blocks.shape[-1]
    eye = torch.eye(d, dtype=diag_blocks.dtype, device=diag_blocks.device)
    D = 0.5 * (diag_blocks + diag_blocks.transpose(-1, -2))
    if shift is not None:
        D = D + shift[:, None, None] * eye
    if free is not None:
        f = free.to(D.dtype)
        D = D * f[:, :, None] * f[:, None, :]
        D = D + eye * (1.0 - f)[:, :, None] * eye
    # Levenberg-style floor so near-singular blocks stay invertible
    tr = tn.trace(D) / d
    eps = 1e-12 * torch.clamp(torch.abs(tr), min=1.0)[:, None, None]
    return tn.inv(D + eps * eye)
