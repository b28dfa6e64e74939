"""The port's unstructured meshes (shapefun/femesh.py) against the JAX
package's: the isoparametric element identities of
tests/test_femesh.py::test_isoparametric_identities, the host build (bin
tables equal, bin order included: ``locate`` keeps the first containing
candidate), ``locate``/``evaluate`` on the T3 bar with a particle outside
the mesh, and the native mesh topology bindings on test_native.py's
meshes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.io import gid_mesh as jgid
from nlpartsol_tpu.io import native as jnative
from nlpartsol_tpu.shapefun import femesh as jfem
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch.formulations import common as tcommon
from nlpartsol_tpu_torch.io import native as tnative
from nlpartsol_tpu_torch.shapefun import femesh as tfem

from _torch_femesh import node_space, np_sf, structured_mesh, to_torch_mesh
from _torch_port import cheap_jax_compiles  # noqa: F401
from test_femesh import _distorted_element, _tri_bar
from test_io import write_gid_quad_mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["T3", "Q4", "T4", "H8"])
def test_isoparametric_identities_match_jax(kind):
    """ξ, the in/out test and N, dN/dξ equal the JAX package's to 1e-6 on
    its distorted element (seed 3, 32 points); partition of unity, the round
    trip and linear completeness hold to 1e-5, the JAX test's limits."""
    rng = np.random.default_rng(3)
    xe = _distorted_element(kind, rng).astype(np.float32)
    d = xe.shape[1]
    x = (rng.dirichlet(np.ones(xe.shape[0]), size=32) @ xe).astype(np.float32)
    xi_j = np.asarray(jfem.x_to_xi(kind, jnp.asarray(xe)[None], jnp.asarray(x)))
    xi = tfem.x_to_xi(kind, torch.as_tensor(xe)[None], torch.as_tensor(x))
    np.testing.assert_allclose(xi.numpy(), xi_j, rtol=0, atol=1e-6)
    assert bool(tfem.inside(kind, xi, tol=1e-4).all())
    np.testing.assert_array_equal(tfem.inside(kind, xi).numpy(),
                                  np.asarray(jfem.inside(kind, jnp.asarray(xi_j))))
    N, dNdxi = tfem.shape_ref(kind, xi)
    N_j, dNdxi_j = jfem.shape_ref(kind, jnp.asarray(xi.numpy()))
    np.testing.assert_allclose(N.numpy(), np.asarray(N_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dNdxi.numpy(), np.asarray(dNdxi_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(N.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose((N @ torch.as_tensor(xe)).numpy(), x, atol=1e-5)
    xe64, dN64 = xe.astype(np.float64), dNdxi.numpy().astype(np.float64)
    J = np.einsum("ai,paj->pij", xe64, dN64)
    dN = np.einsum("paj,pji->pai", dN64, np.linalg.inv(J))
    np.testing.assert_allclose(np.einsum("pai,aj->pij", dN, xe64),
                               np.broadcast_to(np.eye(d), (32, d, d)), atol=1e-5)
    np.testing.assert_allclose(dN.sum(1), 0.0, atol=1e-5)


def _perturbed_h8():
    coords, hexes, _ = structured_mesh(4, 3, "H8", perturb=0.2, seed=0)
    return coords, hexes, "H8"


@pytest.mark.parametrize("mesh", ["t3_bar", "h8"])
def test_build_and_node_bins_match_jax(mesh):
    """build_femesh and with_node_bins (vectorised here, loops in the JAX
    package): the bin grids, each bin's elements and nodes in the same order,
    spacing and h_avg equal."""
    if mesh == "t3_bar":
        coords, conn, _ = _tri_bar(24, 3)
        kind = "T3"
    else:
        coords, conn, kind = _perturbed_h8()
    mj = jfem.build_femesh(coords, conn, kind)
    mt = tfem.build_femesh(coords, conn, kind, device="cpu")
    R = jlme.support_radius(jlme.LMEParams(gamma=3.0), mj.h_avg)
    mj, mt = jfem.with_node_bins(mj, R), tfem.with_node_bins(mt, R)
    for name in ("kind", "bin_origin", "bin_spacing", "bin_dims", "spacing", "h_avg",
                 "nbin_origin", "nbin_spacing", "nbin_dims"):
        assert getattr(mt, name) == getattr(mj, name), name
    for name in ("nodes", "conn", "bin_elems", "dirichlet_mask", "dirichlet_value",
                 "nbin_nodes", "nbin_slot_of"):
        a, b = np.asarray(getattr(mj, name)), getattr(mt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert mt.dim == mj.dim and mt.n_nodes == mj.n_nodes and mt.n_elems == mj.n_elems
    assert mt.nen == mj.nen and (mj.bin_elems >= 0).sum() > mj.n_elems
    grid_j, grid_t = jfem.bin_grid(mj), tfem.bin_grid(mt)
    assert (grid_t.dims, grid_t.spacing, grid_t.origin) == (grid_j.dims, grid_j.spacing,
                                                           grid_j.origin)
    box_j, box_t = jfem.bin_box(mj, 4), tfem.bin_box(mt, 4)
    assert (box_t.offset, box_t.cdims, box_t.capacity) == (box_j.offset, box_j.cdims, 4)
    # the carried-across mesh is the built one
    carried = to_torch_mesh(mj)
    assert carried.bin_dims == mt.bin_dims and torch.equal(carried.bin_elems, mt.bin_elems)


def test_locate_and_evaluate_on_the_t3_bar_match_jax():
    """locate/evaluate on test_femesh.py's bar (200 barycentric samples,
    seed 7, and one point far outside): ``found`` equal, the located element
    holds the point, N and ∇N equal in node space; the outside particle has
    an all-false mask and ``found_lost`` counts it."""
    coords, tris, _ = _tri_bar()
    mj = jfem.build_femesh(coords, tris, "T3")
    mt = to_torch_mesh(mj)
    rng = np.random.default_rng(7)
    e = rng.integers(0, len(tris), 200)
    w = rng.dirichlet(np.ones(3), size=200)
    pts = np.concatenate([np.einsum("pa,pai->pi", w, coords[tris[e]]),
                          [[10.0, 10.0]]]).astype(np.float32)
    elem, xi, found = tfem.locate(mt, torch.as_tensor(pts))
    _, _, found_j = jfem.locate(mj, jnp.asarray(pts))
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    assert bool(found[:-1].all()) and not bool(found[-1]) and int(elem[-1]) == -1
    N, _ = tfem.shape_ref("T3", xi[:-1])
    xr = (N[..., None] * mt.nodes[mt.conn[elem[:-1].long()].long()]).sum(1)
    np.testing.assert_allclose(xr.numpy(), pts[:-1], atol=1e-5)
    sf = np_sf(tfem.evaluate(mt, torch.as_tensor(pts)))
    sf_j = jfem.evaluate(mj, jnp.asarray(pts))
    np.testing.assert_array_equal(sf["found"], np.asarray(sf_j["found"]))
    assert not sf["mask"][-1].any()
    np.testing.assert_allclose(node_space(sf, mt.n_nodes), node_space(sf_j, mt.n_nodes),
                               rtol=0, atol=1e-6)
    g, g_j = node_space(sf, mt.n_nodes, True), node_space(sf_j, mt.n_nodes, True)
    np.testing.assert_allclose(g, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())
    act = torch.ones(len(pts), dtype=torch.bool)
    assert int(tcommon.found_lost({"found": torch.as_tensor(sf["found"])}, act)) == 1


@pytest.fixture(scope="module")
def have_native():
    if not tnative.available():
        pytest.skip("native library unavailable (g++ missing?)")


def test_native_topology_matches_jax(tmp_path, have_native):
    """mesh_topology and ring_localities on test_native.py's quad meshes
    (6×4 at h 0.5, 8×8 at h 1, rings 2): every array of the Topology, min_dx
    and the ring CSR equal the JAX package's bindings'."""
    for name, (nx, ny, h) in {"a": (6, 4, 0.5), "b": (8, 8, 1.0)}.items():
        write_gid_quad_mesh(tmp_path / f"{name}.msh", nx, ny, h)
        m = jgid.read_gid_mesh(str(tmp_path / f"{name}.msh"))
        top_j = jnative.mesh_topology(m.coords, m.connectivity, m.dimension)
        top = tnative.mesh_topology(m.coords, m.connectivity, m.dimension)
        for field in top_j._fields:
            np.testing.assert_array_equal(getattr(top, field), getattr(top_j, field),
                                          err_msg=field)
        assert top.min_dx == pytest.approx(h)
        for got, ref in zip(tnative.ring_localities(top, rings=2),
                            jnative.ring_localities(top_j, rings=2)):
            np.testing.assert_array_equal(got, ref)
