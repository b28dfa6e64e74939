"""GiD ASCII mesh (.msh) reader.

Counterpart of ``nlpartsol_tpu/io/gid_mesh.py`` (numpy only).  Reference:
NL-PartSol's src/Nodes/Read-GID-Mesh.c:49 — parses
  MESH dimension <d> ElemType <Triangle|Quadrilateral|Tetrahedra|Hexahedra> Nnode <n>
  Coordinates
    <id> <x> <y> [<z>]
  End Coordinates
  Elements
    <id> <n1> … <nN>
  End Elements

Returns host-side numpy arrays (coords are 0-indexed; GiD files are
1-indexed).  Used both for the background grid (GramsBox Type=GID) and as a
particle source mesh (GPxElement seeding, Generate-One-Phase-Analysis.c:137).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

ELEM_TYPES = {
    ("Triangle", 3): "T3",
    ("Quadrilateral", 4): "Q4",
    ("Tetrahedra", 4): "T4",
    ("Hexahedra", 8): "H8",
    ("Linear", 2): "L2",
}


class GidMesh(NamedTuple):
    dimension: int
    elem_type: str  # T3 / Q4 / T4 / H8 / L2
    coords: np.ndarray  # (n_nodes, d)
    connectivity: np.ndarray  # (n_elems, nodes_per_elem), 0-indexed

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.connectivity.shape[0]


def read_gid_mesh(path: str) -> GidMesh:
    """Parse a GiD .msh: with the C++ parser (io/native.py) where ``g++``
    can build it — ~100x faster on large meshes — else with the Python loop
    below (``tests/test_torch_io.py`` holds the two equal).  A parse that
    fails raises; neither parser falls back to the other."""
    from . import native

    if not native.available():
        return _read_gid_mesh_py(path)
    dim, elem_name, coords, conn = native.read_gid_mesh_native(path)
    key = (elem_name, conn.shape[1])
    if key not in ELEM_TYPES:
        raise ValueError(f"{path}: unsupported element {elem_name} Nnode {conn.shape[1]}")
    return GidMesh(dimension=dim, elem_type=ELEM_TYPES[key], coords=coords, connectivity=conn)


def _read_gid_mesh_py(path: str) -> GidMesh:
    dimension = None
    elem_name = None
    nnode = None
    coords = {}
    elems = []
    mode = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            low = [t.lower() for t in toks]
            if low[0] == "mesh":
                # parse 'MESH dimension d ElemType T Nnode n' robustly
                for i, t in enumerate(low):
                    if t == "dimension":
                        dimension = int(toks[i + 1])
                    elif t == "elemtype":
                        elem_name = toks[i + 1]
                    elif t == "nnode":
                        nnode = int(toks[i + 1])
                continue
            if low[0] == "coordinates":
                mode = "coords"
                continue
            if low[0] == "elements":
                mode = "elems"
                continue
            if low[0] == "end":
                mode = None
                continue
            if mode == "coords":
                nid = int(toks[0])
                coords[nid] = [float(v) for v in toks[1 : 1 + dimension]]
            elif mode == "elems":
                elems.append([int(v) for v in toks[1 : 1 + nnode]])

    if dimension is None or elem_name is None or nnode is None:
        raise ValueError(f"{path}: missing MESH header")
    key = (elem_name, nnode)
    if key not in ELEM_TYPES:
        raise ValueError(f"{path}: unsupported element {elem_name} Nnode {nnode}")

    n_nodes = max(coords) if coords else 0
    xyz = np.zeros((n_nodes, dimension))
    for nid, c in coords.items():
        xyz[nid - 1] = c
    conn = np.asarray(elems, np.int64) - 1
    return GidMesh(
        dimension=dimension, elem_type=ELEM_TYPES[key], coords=xyz, connectivity=conn
    )


_CENTROID_SEEDS = {
    # GPxElement seeding positions in the reference are per element type
    # (initial_position__Particles__, Particles-Tools.c:8 + element modules
    # element_to_particles__T3__ etc.); centroid + symmetric sub-points.
    1: lambda v: v.mean(axis=0, keepdims=True),
}


def seed_particles(mesh: GidMesh, gp_per_elem: int = 1):
    """Seed particle positions + volumes from a particle-source mesh
    (the reference's GPxElement flow).  gp_per_elem=1 places centroids;
    4 (2D) / 8 (3D) splits each element by midpoint subdivision of its
    bounding simplex/box approximated by corner-weighted points.

    Returns (positions (Np, d), volumes (Np,)).
    """
    coords = mesh.coords
    conn = mesh.connectivity
    verts = coords[conn]  # (ne, nn, d)
    vol = element_volumes(mesh)
    if gp_per_elem == 1:
        pos = verts.mean(axis=1)
        return pos, vol
    # natural-coordinate seeding tables — EXACTLY the reference's
    # element_to_particles__{T3,Q4,T4,H8}__ tables (T3.c / Q4.c:508-536 /
    # T4.c / H8.c), so particle ids and positions match a reference run
    # one-to-one (round-3 fix: the previous centroid-corner blend put
    # particles at ±0.5 where the reference uses Gauss points ±1/sqrt(3))
    g = 1.0 / np.sqrt(3.0)
    a, b = 0.138196601125010, 0.585410196624968
    tables = {
        ("Q4", 4): ([[g, g], [g, -g], [-g, g], [-g, -g]], "quad"),
        ("T3", 3): ([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]], "tri"),
        ("T3", 4): (
            [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3], [1 / 3, 1 / 3]],
            "tri",
        ),
        ("T4", 4): ([[a, a, a], [b, a, a], [a, b, a], [a, a, b]], "tet"),
        ("H8", 8): (
            [[-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5],
             [-0.5, 0.5, 0.5], [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5],
             [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5]],
            "hex",
        ),
    }
    key = (mesh.elem_type, gp_per_elem)
    if key not in tables:
        raise ValueError(
            f"gp_per_elem={gp_per_elem} unsupported for {mesh.elem_type}"
        )
    xi, kind = tables[key]
    xi = np.asarray(xi)
    if kind == "quad":
        s, t = xi[:, 0], xi[:, 1]
        N = 0.25 * np.stack(
            [(1 - s) * (1 - t), (1 + s) * (1 - t), (1 + s) * (1 + t),
             (1 - s) * (1 + t)], axis=1,
        )
    elif kind == "tri":
        N = np.stack([1 - xi[:, 0] - xi[:, 1], xi[:, 0], xi[:, 1]], axis=1)
    elif kind == "tet":
        N = np.stack(
            [1 - xi.sum(axis=1), xi[:, 0], xi[:, 1], xi[:, 2]], axis=1
        )
    else:  # hex
        s, t, u = xi[:, 0], xi[:, 1], xi[:, 2]
        N = 0.125 * np.stack(
            [(1 - s) * (1 - t) * (1 - u), (1 + s) * (1 - t) * (1 - u),
             (1 + s) * (1 + t) * (1 - u), (1 - s) * (1 + t) * (1 - u),
             (1 - s) * (1 - t) * (1 + u), (1 + s) * (1 - t) * (1 + u),
             (1 + s) * (1 + t) * (1 + u), (1 - s) * (1 + t) * (1 + u)],
            axis=1,
        )
    pts = np.einsum("gk,ekd->egd", N, verts)  # (ne, gp, d), elem-major
    pos = pts.reshape(-1, coords.shape[1])
    return pos, np.repeat(vol / gp_per_elem, gp_per_elem)


def element_volumes(mesh: GidMesh) -> np.ndarray:
    """Element areas/volumes (volume__T3__ etc. equivalents)."""
    v = mesh.coords[mesh.connectivity]
    t = mesh.elem_type
    if t == "T3":
        a = v[:, 1] - v[:, 0]
        b = v[:, 2] - v[:, 0]
        return 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    if t == "Q4":
        # shoelace over the quad
        x, y = v[..., 0], v[..., 1]
        s = 0.0
        for i in range(4):
            j = (i + 1) % 4
            s = s + x[:, i] * y[:, j] - x[:, j] * y[:, i]
        return 0.5 * np.abs(s)
    if t == "T4":
        a = v[:, 1] - v[:, 0]
        b = v[:, 2] - v[:, 0]
        c = v[:, 3] - v[:, 0]
        return np.abs(np.einsum("ei,ei->e", a, np.cross(b, c))) / 6.0
    if t == "H8":
        # decompose into 6 tets on the standard hex corner ordering
        tets = [
            (0, 1, 3, 4),
            (1, 2, 3, 4),
            (2, 3, 7, 4),
            (1, 5, 2, 4),
            (2, 5, 6, 4),
            (2, 6, 7, 4),
        ]
        tot = np.zeros(v.shape[0])
        for i0, i1, i2, i3 in tets:
            a = v[:, i1] - v[:, i0]
            b = v[:, i2] - v[:, i0]
            c = v[:, i3] - v[:, i0]
            tot += np.abs(np.einsum("ei,ei->e", a, np.cross(b, c))) / 6.0
        return tot
    raise ValueError(f"element_volumes: unsupported {t}")


def structured_grid_from_mesh(mesh: GidMesh, tol: float = 1e-9):
    """Detect a structured Cartesian layout in a GiD node cloud and return
    (dims, spacing, origin) for types.Grid — the TPU-native background for
    regular Q4/H8 meshes.  Raises if the mesh is not a uniform grid."""
    d = mesh.dimension
    axes = []
    for ax in range(d):
        vals = np.unique(np.round(mesh.coords[:, ax] / tol) * tol)
        if len(vals) > 1:
            steps = np.diff(vals)
            if not np.allclose(steps, steps[0], rtol=1e-6):
                raise ValueError("mesh is not uniformly spaced")
        axes.append(vals)
    spacings = [a[1] - a[0] for a in axes if len(a) > 1]
    if not spacings or not np.allclose(spacings, spacings[0], rtol=1e-6):
        raise ValueError("mesh is not isotropic-uniform")
    dims = tuple(len(a) for a in axes)
    if int(np.prod(dims)) != mesh.n_nodes:
        raise ValueError("node cloud is not a full tensor grid")
    origin = tuple(float(a[0]) for a in axes)
    return dims, float(spacings[0]), origin

