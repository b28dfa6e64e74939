"""Unstructured FEM background meshes: T3/Q4/T4/H8 isoparametric elements,
and meshfree LME over the mesh's node cloud.

Counterpart of ``nlpartsol_tpu/shapefun/femesh.py`` (the reference's
element modules, nl-partsol src/Nodes/{T3,Q4,T4,H8}.c):
reference-space N and dN/dξ, the inverse isoparametric map (closed form for
simplices, a fixed 6-iteration Newton for Q4/H8), the in/out test, and the
per-step particle→element search.

* **Point location is a uniform bin grid.**  The host binds each element,
  by its bounding box, to the Cartesian bins it covers; each bin keeps a
  padded candidate list in ascending element order.  A step inverts the map
  for all (Np, Emax) candidates at once and keeps the *first* containing
  one, as the JAX package does, so an edge point lands in the same element.
* **Meshfree LME** takes its candidates from a second bin grid over the
  nodes, of edge the support radius (:func:`with_node_bins`): the 3^d bins
  around a particle's bin hold every node within reach.
* The result keeps the contract of the structured shape functions
  (``node_ids``/``N``/``dN``/``mask``), so every step runs on a mesh through
  the scatter engine (``ops/transfer.py::ScatterEngine``); ``found`` flags
  the particles no element holds, which the steps count as lost.

The host build (:func:`build_femesh`, :func:`with_node_bins`) is numpy
without a Python loop over elements or bins; its tables equal the JAX
package's, bin contents and order included.  ``evaluate_lme_binned`` and
the 'binned' transfer are on the do-not-port list (ROADMAP.md queue 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import config
from ..ops import tensor as tn
from ..types import Grid, Record
from . import lme as lme_mod

Tensor = torch.Tensor

# nodes per element / natural-coordinate family per kind
NEN = {"T3": 3, "Q4": 4, "T4": 4, "H8": 8}
SIMPLEX = {"T3": True, "T4": True, "Q4": False, "H8": False}

# GiD corner numbering in natural coords for the tensor-product elements
# (Q4: counter-clockwise from (-1,-1), Q4.c:112; H8: bottom face then top)
_Q4_SIGNS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
_H8_SIGNS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
    np.float64,
)


@dataclasses.dataclass(frozen=True)
class FEMesh(Record):
    """Unstructured background mesh (takes the place of :class:`Grid` for
    non-Cartesian domains; reference ``Mesh``, Types.h:560-640).  The fields
    are the JAX package's, in its order."""

    kind: str  # T3 / Q4 / T4 / H8
    nodes: Tensor = None  # (Nn, d) node coords
    conn: Tensor = None  # (Ne, nen) int32 element connectivity
    # point-location bin grid (static geometry, built on the host)
    bin_origin: tuple = None
    bin_spacing: float = None
    bin_dims: tuple = None
    bin_elems: Tensor = None  # (Nbins, Emax) int32, -1 padded
    # Courant length: the smallest corner-pair edge (reference min_DeltaX,
    # T3.c:452)
    spacing: float = None
    # nodal spacing for LME β = γ/h̄² (the mean corner-pair edge)
    h_avg: float = None
    # boundary conditions (the contract of Grid)
    dirichlet_mask: Optional[Tensor] = None  # (Nn, d) bool
    dirichlet_value: Optional[Tensor] = None  # (Nn, d)
    active: Optional[Tensor] = None
    # node-cloud bin grid of meshfree LME supports (:func:`with_node_bins`)
    nbin_origin: tuple = None
    nbin_spacing: float = None
    nbin_dims: tuple = None
    nbin_nodes: Optional[Tensor] = None  # (Nbins, Bmax) int32, -1 padded
    # flat (bin·Bmax + slot) position of each node in nbin_nodes
    nbin_slot_of: Optional[Tensor] = None  # (Nn,) int32

    @property
    def dim(self) -> int:
        return len(self.bin_origin)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elems(self) -> int:
        return self.conn.shape[0]

    @property
    def nen(self) -> int:
        return NEN[self.kind]


def _strides(dims) -> list:
    """C-order strides of a grid of ``dims``."""
    out, s = [], 1
    for n in reversed(dims):
        out.append(s)
        s *= n
    return list(reversed(out))


def _flat_bin(x: Tensor, origin, spacing, dims) -> Tensor:
    """(Np, d) int32 bin multi-index (clamped into the grid) and its flat
    C-order index; a true division by the spacing, as in the JAX package."""
    org = torch.tensor(origin, dtype=x.dtype, device=x.device)
    hi = torch.tensor([n - 1 for n in dims], dtype=torch.int32, device=x.device)
    b = torch.floor((x - org) / spacing).to(torch.int32)
    b = torch.minimum(torch.clamp(b, min=0), hi)
    strides = torch.tensor(_strides(dims), dtype=torch.int32, device=x.device)
    return b, torch.sum(b * strides, dim=-1)


# ---------------------------------------------------------------------------
# reference-space shape functions
# ---------------------------------------------------------------------------


def _contract_a(w: Tensor, xe: Tensor) -> Tensor:
    """Σ_a w_a·xe_ai: (..., nen) × (..., nen, d) → (..., d)."""
    return torch.sum(w[..., None] * xe, dim=-2)


def _jacobian(xe: Tensor, dNdxi: Tensor) -> Tensor:
    """dx/dξ: J_ij = Σ_a xe_ai·dN_aj, (..., d, d); broadcast products and a
    sum over the element's nodes (no batched GEMM for 2×2 and 3×3 blocks)."""
    return torch.sum(xe[..., :, :, None] * dNdxi[..., :, None, :], dim=-3)


def shape_ref(kind: str, xi: Tensor):
    """N(ξ) (..., nen) and dN/dξ (..., nen, d) in reference space
    (N__T3__ T3.c:100, dN__T3__ :195; N__Q4__ Q4.c:112; T4.c; H8.c)."""
    dt, dev = xi.dtype, xi.device
    if kind == "T3":
        a, b = xi[..., 0], xi[..., 1]
        N = torch.stack([1.0 - a - b, a, b], dim=-1)
        dN = torch.tensor([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]], dtype=dt, device=dev)
        return N, dN.expand(xi.shape[:-1] + (3, 2))
    if kind == "T4":
        a, b, c = xi[..., 0], xi[..., 1], xi[..., 2]
        N = torch.stack([1.0 - a - b - c, a, b, c], dim=-1)
        dN = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                           [0.0, 0.0, 1.0]], dtype=dt, device=dev)
        return N, dN.expand(xi.shape[:-1] + (4, 3))
    signs = torch.tensor(_Q4_SIGNS if kind == "Q4" else _H8_SIGNS, dtype=dt, device=dev)
    d = signs.shape[1]
    # N_a = Π_j (1 + s_aj ξ_j) / 2^d
    terms = 1.0 + signs * xi[..., None, :]  # (..., nen, d)
    N = torch.prod(terms, dim=-1) / (2.0 ** d)
    # dN_a/dξ_i = s_ai/2^d · Π_{j≠i} (1 + s_aj ξ_j)
    eye = torch.eye(d, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    prod_except = torch.prod(torch.where(eye, one, terms[..., None, :]), dim=-1)
    return N, signs * prod_except / (2.0 ** d)


def x_to_xi(kind: str, xe: Tensor, x: Tensor, newton_iters: int = 6) -> Tensor:
    """Natural ξ (..., d) of the point x in the element of node coords xe
    (..., nen, d): reference ``X_to_Xi``, the affine closed form for
    simplices, else a fixed-count Newton from the element's centre."""
    if SIMPLEX[kind]:
        # x = x0 + J ξ, the columns of J the edge vectors from node 0
        x0 = xe[..., 0, :]
        J = (xe[..., 1:, :] - x0[..., None, :]).transpose(-1, -2)
        return tn.bmv(tn.inv(J), x - x0)
    d = xe.shape[-1]
    xi = torch.zeros(x.shape[:-1] + (d,), dtype=x.dtype, device=x.device)
    for _ in range(newton_iters):
        N, dN = shape_ref(kind, xi)
        r = x - _contract_a(N, xe)
        xi = xi + tn.bmv(tn.inv(_jacobian(xe, dN)), r)
    return xi


def inside(kind: str, xi: Tensor, tol: float = 1e-6) -> Tensor:
    """In/out test in natural coordinates (in_out__T3__, T3.c:285)."""
    if SIMPLEX[kind]:
        return (xi >= -tol).all(dim=-1) & (xi.sum(dim=-1) <= 1.0 + tol)
    return (torch.abs(xi) <= 1.0 + tol).all(dim=-1)


# ---------------------------------------------------------------------------
# point location and evaluation
# ---------------------------------------------------------------------------


def locate(mesh: FEMesh, x: Tensor, tol: float = 1e-6):
    """The element holding each particle: (elem (Np,) int32, -1 where none;
    ξ (Np, d); found (Np,) bool).  One batched pass over the (Np, Emax)
    candidates of each particle's bin; the first containing candidate wins
    (replaces the reference's locality walk, local_search__T3__, T3.c:546)."""
    _, flat = _flat_bin(x, mesh.bin_origin, mesh.bin_spacing, mesh.bin_dims)
    cand = mesh.bin_elems[flat.long()]  # (Np, Emax)
    cvalid = cand >= 0
    candc = torch.clamp(cand, min=0).long()
    xe = mesh.nodes[mesh.conn[candc].long()]  # (Np, Emax, nen, d)
    xi = x_to_xi(mesh.kind, xe, x[:, None, :])  # (Np, Emax, d)
    ok = inside(mesh.kind, xi, tol) & cvalid
    # torch.argmax takes no bool; on ties it returns the first index
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    found = ok.any(dim=1)
    ar = torch.arange(x.shape[0], device=x.device)
    elem = torch.where(found, cand[ar, first], torch.full_like(cand[:, 0], -1))
    return elem, xi[ar, first], found


def evaluate(mesh: FEMesh, x: Tensor) -> dict:
    """Isoparametric N and ∇N = dN/dξ·J⁻¹ at the particles: the dict of
    ``fem.evaluate`` (node_ids (Np, nen) int32, N, dN, mask, lam None) and
    ``found`` (Np,) for the lost-particle count."""
    elem, xi, found = locate(mesh, x)
    econn = mesh.conn[torch.clamp(elem, min=0).long()]  # (Np, nen)
    xe = mesh.nodes[econn.long()]  # (Np, nen, d)
    N, dNdxi = shape_ref(mesh.kind, xi)
    Jinv = tn.inv(_jacobian(xe, dNdxi))
    dN = torch.sum(dNdxi[..., :, :, None] * Jinv[..., None, :, :], dim=-2)
    mask = found[:, None].expand(econn.shape)
    if mesh.active is not None:
        mask = mask & mesh.active[econn.long()]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    N = torch.where(mask, N, zero)
    dN = torch.where(mask[..., None], dN, zero)
    return dict(node_ids=econn, N=N, dN=dN, mask=mask, lam=None, found=found)


def lme_candidates(mesh: FEMesh, x: Tensor):
    """Each particle's padded candidate nodes from the 3^d bins around its
    node bin: (node_ids (Np, K) int32, valid (Np, K)), K = 3^d·Bmax."""
    d = mesh.dim
    b, _ = _flat_bin(x, mesh.nbin_origin, mesh.nbin_spacing, mesh.nbin_dims)
    offs = torch.as_tensor(
        np.stack(np.meshgrid(*([np.arange(-1, 2)] * d), indexing="ij"), -1).reshape(-1, d),
        dtype=torch.int32, device=x.device)  # (3^d, d)
    bd = torch.tensor(mesh.nbin_dims, dtype=torch.int32, device=x.device)
    nb = b[:, None, :] + offs[None, :, :]  # (Np, 3^d, d)
    inb = ((nb >= 0) & (nb < bd)).all(dim=-1)
    nb = torch.minimum(torch.clamp(nb, min=0), bd - 1)
    strides = torch.tensor(_strides(mesh.nbin_dims), dtype=torch.int32, device=x.device)
    ids = mesh.nbin_nodes[torch.sum(nb * strides, dim=-1).long()]  # (Np, 3^d, Bmax)
    valid = inb[..., None] & (ids >= 0)
    K = ids.shape[1] * ids.shape[2]
    return torch.clamp(ids, min=0).reshape(-1, K), valid.reshape(-1, K)


def evaluate_lme(mesh: FEMesh, x: Tensor, lam0: Tensor, params: lme_mod.LMEParams) -> dict:
    """LME over the mesh's node cloud, the reference's flagship
    configuration (GramsShapeFun Type=LME on a GiD mesh; LME.c:700-891):
    β = γ/h̄² with h̄ the mean edge, supports bounded by the support radius
    through the node bins (:func:`with_node_bins` first).  The dict of
    ``lme.evaluate``, over the compacted pattern of :func:`_compact`."""
    if mesh.nbin_nodes is None:
        raise ValueError("call with_node_bins(mesh, support_radius) first")
    beta = lme_mod.beta_of(params, mesh.h_avg)
    r_sup = lme_mod.support_radius(params, mesh.h_avg)
    node_ids, valid = lme_candidates(mesh, x)
    rel = x[:, None, :] - mesh.nodes[node_ids.long()]
    mask = valid & (torch.sum(rel * rel, dim=-1) <= r_sup * r_sup)
    if mesh.active is not None:
        mask = mask & mesh.active[node_ids.long()]
    node_ids, rel, mask = _compact(node_ids, rel, mask)
    N, dN, lam = _lme_from_rel(rel, mask, lam0, beta, params)
    return dict(node_ids=node_ids, N=N, dN=dN, mask=mask, lam=lam)


def _compact(node_ids: Tensor, rel: Tensor, mask: Tensor):
    """Each particle's in-support candidates, in their order, moved to the
    first columns of an (Np, Kc) pattern, Kc the largest support.  Most of
    the 3^d·Bmax padded candidates lie beyond the radius (four fifths in 2D,
    more than nine tenths in 3D, on bench_femesh.py's mesh and a perturbed
    H8 one), and every later array of the step is as wide as the pattern; the node-space sums are the JAX package's, summed
    without the zeros.  Reads Kc back to the host once per evaluation."""
    count = torch.sum(mask, dim=1, dtype=torch.int32)
    kc = max(1, int(count.max()))
    # the target column of each in-support entry; the rest go to column kc
    col = torch.where(mask, torch.cumsum(mask, dim=1, dtype=torch.int32) - 1,
                      torch.full_like(count[:, None], kc)).long()
    n, d = mask.shape[0], rel.shape[-1]
    ids = torch.zeros((n, kc + 1), dtype=node_ids.dtype, device=node_ids.device)
    ids.scatter_(1, col, node_ids)
    out = torch.zeros((n, kc + 1, d), dtype=rel.dtype, device=rel.device)
    out.scatter_(1, col[..., None].expand(-1, -1, d), rel)
    keep = torch.arange(kc, device=mask.device)[None, :] < count[:, None]
    return ids[:, :kc], out[:, :kc], keep


def _lme_from_rel(rel, mask, lam0, beta, params):
    """λ-Newton, then N and ∇N, from a padded (Np, K, d) rel/mask pattern
    (the LME.c:700-891 numerics of shapefun/lme.py)."""
    lam = lme_mod.solve_lambda(rel, mask, lam0, beta, params)
    sq = torch.sum(rel * rel, dim=-1)
    N, dN = lme_mod.basis_from_lambda(rel, sq, mask, lam, beta)
    zero = torch.zeros((), dtype=rel.dtype, device=rel.device)
    return torch.where(mask, N, zero), torch.where(mask[..., None], dN, zero), lam


# ---------------------------------------------------------------------------
# host-side build
# ---------------------------------------------------------------------------


def _bin_table(flat: np.ndarray, items: np.ndarray, nbins: int) -> np.ndarray:
    """(nbins, max count) int32 table, -1 padded: row b holds the ``items``
    whose ``flat`` bin is b, in their order in ``items``."""
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=nbins)
    starts = np.concatenate([[0], np.cumsum(counts)])
    fs = flat[order]
    table = np.full((nbins, max(1, int(counts.max(initial=0)))), -1, np.int32)
    table[fs, np.arange(len(fs)) - starts[fs]] = items[order]
    return table


def build_femesh(coords, conn, kind: str, dirichlet_mask=None, dirichlet_value=None,
                 bin_target: float = 1.5, device="cuda") -> FEMesh:
    """A FEMesh and its point-location bin grid, built on the host (numpy)
    and placed on ``device``.  ``bin_target``: the bin edge over the mean
    element bounding-box extent."""
    coords = np.asarray(coords, np.float64)
    conn = np.asarray(conn, np.int64)
    d = coords.shape[1]
    xe = coords[conn]  # (Ne, nen, d)
    lo = xe.min(axis=1)
    hi = xe.max(axis=1)
    bin_h = float(np.mean(hi - lo)) * bin_target
    dom_lo = coords.min(axis=0) - 1e-9
    dom_hi = coords.max(axis=0) + 1e-9
    bdims = np.maximum(np.ceil((dom_hi - dom_lo) / bin_h).astype(int), 1)
    # the bin ranges each element's bounding box covers
    lo_b = np.clip(np.floor((lo - dom_lo) / bin_h).astype(int), 0, bdims - 1)
    hi_b = np.clip(np.floor((hi - dom_lo) / bin_h).astype(int), 0, bdims - 1)
    nbins = int(np.prod(bdims))
    strides = np.asarray(_strides(bdims.tolist()))
    # every (element, covered bin) pair, element-major and C-order within an
    # element: a stable sort by bin keeps each bin's elements ascending
    span = hi_b - lo_b + 1
    offs = np.stack(np.meshgrid(*[np.arange(m) for m in span.max(axis=0)], indexing="ij"),
                    -1).reshape(-1, d)  # (M, d)
    cover = (offs[None] < span[:, None]).all(-1)  # (Ne, M)
    elem, which = np.nonzero(cover)
    flat = ((lo_b[elem] + offs[which]) * strides).sum(-1)
    bin_elems = _bin_table(flat, elem, nbins)
    # edge lengths: consecutive corner pairs are enough for a length scale
    edges = np.linalg.norm(xe - np.roll(xe, 1, axis=1), axis=2)  # (Ne, nen)
    dt = config.dtype()
    nn = coords.shape[0]
    if dirichlet_mask is None:
        dirichlet_mask = np.zeros((nn, d), bool)
    if dirichlet_value is None:
        dirichlet_value = np.zeros((nn, d))
    return FEMesh(
        kind=kind,
        nodes=torch.as_tensor(coords, dtype=dt, device=device),
        conn=torch.as_tensor(conn.astype(np.int32), device=device),
        bin_origin=tuple(float(v) for v in dom_lo),
        bin_spacing=float(bin_h),
        bin_dims=tuple(int(v) for v in bdims),
        bin_elems=torch.as_tensor(bin_elems, device=device),
        spacing=float(edges.min()),
        h_avg=float(edges.mean()),
        dirichlet_mask=torch.as_tensor(np.asarray(dirichlet_mask, bool), device=device),
        dirichlet_value=torch.as_tensor(np.asarray(dirichlet_value), dtype=dt, device=device),
    )


def with_node_bins(mesh: FEMesh, radius: float) -> FEMesh:
    """The mesh with a node-cloud bin grid of edge ``radius``, so that the
    3^d bins around a particle's bin hold every node within ``radius`` (the
    replacement of the reference's ring-expanded nodal localities feeding
    ``tributary__LME__``, Read_GramsBox.c:96-103, LME.c:1019-1099).  Host
    numpy; the node coordinates are read in float64 from the device copy,
    as the JAX package reads its own."""
    coords = mesh.nodes.detach().cpu().numpy().astype(np.float64)
    lo = coords.min(axis=0) - 1e-9
    hi = coords.max(axis=0) + 1e-9
    bdims = np.maximum(np.ceil((hi - lo) / radius).astype(int), 1)
    nbins = int(np.prod(bdims))
    idx = np.clip(((coords - lo) / radius).astype(int), 0, bdims - 1)
    flat = (idx * np.asarray(_strides(bdims.tolist()))).sum(axis=1)
    table = _bin_table(flat, np.arange(coords.shape[0]), nbins)
    slot_of = np.zeros(coords.shape[0], np.int32)
    pos = np.nonzero(table.reshape(-1) >= 0)[0]
    slot_of[table.reshape(-1)[pos]] = pos
    dev = mesh.nodes.device
    return mesh.replace(
        nbin_origin=tuple(float(v) for v in lo),
        nbin_spacing=float(radius),
        nbin_dims=tuple(int(v) for v in bdims),
        nbin_nodes=torch.as_tensor(table, device=dev),
        nbin_slot_of=torch.as_tensor(slot_of, device=dev),
    )


def bin_grid(mesh: FEMesh) -> Grid:
    """A :class:`Grid` over the node-bin grid (bins as cells)."""
    if mesh.nbin_nodes is None:
        raise ValueError("call with_node_bins(mesh, support_radius) first")
    return Grid(dims=mesh.nbin_dims, spacing=mesh.nbin_spacing, origin=mesh.nbin_origin)


def bin_box(mesh: FEMesh, capacity: int):
    """The ActiveBox covering the node-bin grid exactly."""
    from ..ops.windowed import ActiveBox

    if mesh.nbin_nodes is None:
        raise ValueError("call with_node_bins(mesh, support_radius) first")
    return ActiveBox(offset=(0,) * mesh.dim, cdims=tuple(mesh.nbin_dims), capacity=capacity)


def from_gid(mesh, device="cuda", **kw) -> FEMesh:
    """FEMesh from an ``io.gid_mesh.GidMesh`` (reference GramsBox Type=GID,
    Read_GramsBox.c:54-150; GiD node ids map 1:1)."""
    return build_femesh(mesh.coords, mesh.connectivity, mesh.elem_type, device=device, **kw)
