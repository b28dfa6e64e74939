"""Shared problems of the tests/test_torch_femesh*.py files: unstructured
meshes built in numpy, handed to the JAX package and — through
``convert.femesh_from_numpy`` — to the port, both on the CPU."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.shapefun import femesh as jfem
from nlpartsol_tpu.shapefun import lme as jlme
from nlpartsol_tpu.types import make_particles as jmake

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.shapefun import lme as tlme

from _torch_port import to_torch_materials, to_torch_particles
from test_femesh import C, E_, RHO, _tri_bar

V_BAR = 0.01  # test_femesh.py's bar amplitude


def to_torch_mesh(mj):
    """The port's FEMesh with every field of the JAX package's."""
    fields = {}
    for f in dataclasses.fields(mj):
        v = getattr(mj, f.name)
        fields[f.name] = v if v is None or isinstance(v, (str, tuple, float)) else np.asarray(v)
    return convert.femesh_from_numpy(fields, device="cpu")


def structured_mesh(n, dim, kind, perturb=0.0, seed=0):
    """``n``^dim cells of the unit square/cube as Q4/H8 elements, or split
    into T3 (2 a cell) / T4 (6 a cell, the Kuhn split along the main
    diagonal); interior nodes moved by up to ``perturb``·h.  Returns (node
    coords (Nn, d) float64, connectivity, node ids (n+1,)*dim)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, n + 1)
    coords = np.stack([g.ravel() for g in np.meshgrid(*([xs] * dim), indexing="ij")], -1)
    interior = ((coords > 1e-9) & (coords < 1.0 - 1e-9)).all(-1)
    coords[interior] += rng.uniform(-perturb, perturb, coords[interior].shape) / n
    ids = np.arange((n + 1) ** dim).reshape((n + 1,) * dim)
    if dim == 2:
        i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        a, b, c, d = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
        quads = np.stack([a, b, c, d], -1).reshape(-1, 4)
        if kind == "Q4":
            return coords, quads, ids
        return coords, np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]]), ids
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    corner = [ids[i + a, j + b, k + c] for c in (0, 1) for (a, b) in ((0, 0), (1, 0), (1, 1), (0, 1))]
    hexes = np.stack(corner, -1).reshape(-1, 8)  # GiD order: bottom face, then top
    if kind == "H8":
        return coords, hexes, ids
    # the six tets around the 0-6 diagonal, each positively oriented
    kuhn = [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]]
    return coords, np.concatenate([hexes[:, t] for t in kuhn]), ids


def points_in(coords, conn, per_elem, seed):
    """``per_elem`` random points in each element (Dirichlet weights over
    its corners) and the JAX package's particles there, mass ρ·V."""
    rng = np.random.default_rng(seed)
    xe = coords[conn]
    w = rng.dirichlet(np.ones(conn.shape[1]), size=(conn.shape[0], per_elem))
    return np.einsum("epa,eai->epi", w, xe).reshape(-1, coords.shape[1]).astype(np.float32)


def bar_problem(shapefun="fem", V=V_BAR, **mesh_kw):
    """test_femesh.py's bar (``_unstructured_bar_problem``: the 24×3 T3
    mesh, ends fixed in x, y held; 3 particles a triangle; Neo-Hookean E 1e7,
    ν 0, ρ 1000) at the velocity V·sin(πx/L), for both packages.  Returns
    (JAX mesh, particles, materials), the port's three, the positions and
    the LME params (``shapefun='lme'`` attaches the node bins)."""
    L = 1.0
    coords, tris, ids = _tri_bar(nx=24, ny=3, L=L, H=0.15)
    dmask = np.zeros((len(coords), 2), bool)
    dmask[ids[0, :], 0] = True
    dmask[ids[-1, :], 0] = True
    dmask[:, 1] = True
    mj = jfem.build_femesh(coords, tris, "T3", dirichlet_mask=dmask, **mesh_kw)
    lj, lt = jlme.LMEParams(gamma=3.0), tlme.LMEParams(gamma=3.0)
    if shapefun == "lme":
        mj = jfem.with_node_bins(mj, jlme.support_radius(lj, mj.h_avg))
    xe = coords[tris]
    bary = np.array([[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    pts = np.einsum("ba,eai->ebi", bary, xe).reshape(-1, 2)
    e1, e2 = xe[:, 1] - xe[:, 0], xe[:, 2] - xe[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    vol = np.repeat(area / 3.0, 3)
    vx = V * np.sin(np.pi * pts[:, 0] / L)
    pj = jmake(pts.astype(np.float32), mass=(RHO * vol).astype(np.float32),
               vol0=vol.astype(np.float32))
    pj = pj.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1), jnp.float32))
    matj = jM.material_table([jM.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)])
    return (mj, pj, matj), (to_torch_mesh(mj), to_torch_particles(pj),
                            to_torch_materials(matj)), pts, (lj, lt)


def quarter_period_error(dis_x, pts, L=1.0):
    """The bar's displacement error at a quarter period over its amplitude
    (test_femesh.py's oracle)."""
    omega = np.pi * C / L
    u_ref = (V_BAR / omega) * np.sin(np.pi * pts[:, 0] / L)
    return float(np.abs(dis_x - u_ref).max() / (V_BAR / omega))


def node_space(sf, n_nodes, grad=False):
    """Each particle's N (or ∇N, (Np, Nn, d)) row scattered into a dense
    (Np, Nn) array over the nodes: comparable whichever element or candidate
    slot holds an edge."""
    ids = np.asarray(sf["node_ids"]).astype(np.int64)
    mask = np.asarray(sf["mask"])
    vals = np.asarray(sf["dN" if grad else "N"], np.float64)
    out = np.zeros((ids.shape[0], n_nodes) + vals.shape[2:])
    rows = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
    np.add.at(out, (rows[mask], ids[mask]), vals[mask])
    return out


def np_sf(sf):
    """A port shape-function dict as numpy."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in sf.items()}


def rel_dx_dv(pt, pj, h):
    """bench.py's parity numbers between the port's particles and the JAX
    package's, by pid over active particles: the largest position difference
    over h and velocity difference over the largest speed."""
    from _torch_port import by_pid

    got, ref = by_pid(pt, ("x", "v")), by_pid(pj, ("x", "v"))
    rel_dx = float(np.abs(got["x"] - ref["x"]).max()) / h
    rel_dv = float(np.abs(got["v"] - ref["v"]).max()) / max(float(np.abs(ref["v"]).max()), 1e-12)
    return rel_dx, rel_dv


def static_fields(cfg):
    """The static fields of a JAX-package config, for ``convert``."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def t3_of_grid(gj):
    """A JAX FEMesh of T3 triangles (two a cell) over the nodes of a 2D JAX
    Grid, in its node order, with its Dirichlet mask and values."""
    nodes = np.asarray(gj.node_coords(), np.float64)
    ids = np.arange(gj.n_nodes).reshape(gj.dims)
    i, j = np.meshgrid(np.arange(gj.dims[0] - 1), np.arange(gj.dims[1] - 1), indexing="ij")
    a, b, c, d = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
    quads = np.stack([a, b, c, d], -1).reshape(-1, 4)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return jfem.build_femesh(nodes, tris, "T3", dirichlet_mask=np.asarray(gj.dirichlet_mask),
                             dirichlet_value=np.asarray(gj.dirichlet_value))
