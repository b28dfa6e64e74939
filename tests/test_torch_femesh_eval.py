"""``femesh.evaluate`` (isoparametric) and ``femesh.evaluate_lme`` (meshfree
LME over the node cloud) of the port against the JAX package's, on the T3
bar of tests/test_femesh.py, a perturbed Q4 mesh and perturbed 3D H8 and T4
meshes, a few hundred particles each: ``found`` equal, N and ∇N compared in
node space (a point on a shared edge may sit in either element, and a
candidate node in any slot), λ by particle.

The JAX package's ``locate`` fails on Q4 and H8 meshes: its Newton
``lax.scan`` starts ξ at the shape of ``x[:, None, :]`` and returns it at
the candidates' (Np, Emax, d) (a reference defect, ROADMAP.md queue 3).
The Q4/H8 cases check that it still fails, then compare against it with
``x`` broadcast to the candidates' shape before its ``x_to_xi``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.shapefun import femesh as jfem
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch.shapefun import femesh as tfem
from nlpartsol_tpu_torch.shapefun import lme as tlme

from _torch_femesh import node_space, np_sf, points_in, structured_mesh, to_torch_mesh
from _torch_port import LAM_ATOL, cheap_jax_compiles  # noqa: F401
from test_femesh import _tri_bar

torch.set_num_threads(1)


def _x_broadcast(x_to_xi):
    """The JAX package's ``x_to_xi`` with ``x`` broadcast to the element
    batch's shape (its scan carry then keeps one shape)."""
    def fixed(kind, xe, x, newton_iters=6):
        return x_to_xi(kind, xe, jnp.broadcast_to(x, xe.shape[:-2] + x.shape[-1:]),
                       newton_iters)
    return fixed


def _mesh(kind):
    if kind == "T3":
        coords, conn, _ = _tri_bar(24, 3)
        return coords, conn, 2
    n, dim = {"Q4": (6, 2), "H8": (3, 3), "T4": (3, 3)}[kind]
    coords, conn, _ = structured_mesh(n, dim, kind, perturb=0.2, seed=1)
    return coords, conn, {"Q4": 6, "H8": 8, "T4": 2}[kind]


@pytest.mark.parametrize("kind,shapefun", [("T3", "lme"), ("Q4", "fem"), ("Q4", "lme"),
                                           ("H8", "fem"), ("H8", "lme"), ("T4", "fem"),
                                           ("T4", "lme")])
def test_evaluate_matches_jax_in_node_space(kind, shapefun, monkeypatch):
    """FEM N within 1e-6; LME N within the port's LME tolerance
    (tests/test_torch_lme.py: rtol 2e-5, atol 1e-6), λ within rtol 1e-3
    (beside LAM_ATOL/h̄); ∇N within 1e-4 of its largest magnitude; nnz
    equal."""
    coords, conn, per_elem = _mesh(kind)
    mj = jfem.build_femesh(coords, conn, kind)
    lj, lt = jlme.LMEParams(gamma=3.0), tlme.LMEParams(gamma=3.0)
    if shapefun == "lme":
        mj = jfem.with_node_bins(mj, jlme.support_radius(lj, mj.h_avg))
    mt = to_torch_mesh(mj)
    x = points_in(coords, conn, per_elem, seed=2)
    assert 150 <= len(x) <= 600
    lam0 = np.zeros_like(x)
    if shapefun == "fem":
        if kind in ("Q4", "H8"):
            with pytest.raises(TypeError, match="scan body function carry"):
                jfem.evaluate(mj, jnp.asarray(x))
            monkeypatch.setattr(jfem, "x_to_xi", _x_broadcast(jfem.x_to_xi))
        sf_j = jfem.evaluate(mj, jnp.asarray(x))
        sf = np_sf(tfem.evaluate(mt, torch.as_tensor(x)))
        np.testing.assert_array_equal(sf["found"], np.asarray(sf_j["found"]))
        assert sf["found"].all() and sf["node_ids"].dtype == np.int32
    else:
        sf_j = jfem.evaluate_lme(mj, jnp.asarray(x), jnp.asarray(lam0), lj)
        sf = np_sf(tfem.evaluate_lme(mt, torch.as_tensor(x), torch.as_tensor(lam0), lt))
        # the port keeps the in-support candidates only (femesh._compact)
        assert sf["node_ids"].shape[1] < np.asarray(sf_j["node_ids"]).shape[1]
        assert sf["node_ids"].shape[1] == int(np.asarray(sf_j["mask"]).sum(1).max())
        lam_j = np.asarray(sf_j["lam"])
        np.testing.assert_allclose(sf["lam"], lam_j, rtol=1e-3, atol=LAM_ATOL / mj.h_avg)
    assert int(sf["mask"].sum()) == int(np.asarray(sf_j["mask"]).sum())
    N, N_j = node_space(sf, mt.n_nodes), node_space(sf_j, mt.n_nodes)
    np.testing.assert_allclose(N, N_j, rtol=0 if shapefun == "fem" else 2e-5, atol=1e-6)
    np.testing.assert_allclose(N.sum(-1), 1.0, atol=1e-4)
    g, g_j = node_space(sf, mt.n_nodes, True), node_space(sf_j, mt.n_nodes, True)
    np.testing.assert_allclose(g, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())
