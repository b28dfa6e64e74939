"""Saint-Venant-Kirchhoff and the scatter engine of the port against the JAX
package on the same numpy inputs: ``hyperelastic.saint_venant_kirchhoff``,
``tensor.cmi_from_disp_grad`` and the dispatch of kind 2 in 2D and 3D
(rtol 1e-6 in float32, 1e-12 in float64, each with an absolute floor of
that size times the largest magnitude); ``transfer.ScatterEngine``'s p2g,
g2p and edge_gather over FEM shape functions on a small grid; and
``make_engine``'s routing of the transfer names."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.models import dispatch as jcon, hyperelastic as jhyper, materials as jM
from nlpartsol_tpu.ops import tensor as jtn
from nlpartsol_tpu.ops import transfer as jtransfer
from nlpartsol_tpu.shapefun import fem as jfem
from nlpartsol_tpu.types import Grid as JGrid

from nlpartsol_tpu_torch.formulations import common
from nlpartsol_tpu_torch.formulations.dem import DEMConfig
from nlpartsol_tpu_torch.models import dispatch as tcon, hyperelastic as thyper
from nlpartsol_tpu_torch.ops import tensor as ttn
from nlpartsol_tpu_torch.ops import transfer as ttransfer
from nlpartsol_tpu_torch.shapefun import fem as tfem

from _torch_port import cheap_jax_compiles, to_torch_grid, to_torch_materials  # noqa: F401

torch.set_num_threads(1)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_saint_venant_kirchhoff_matches_jax(dim, dtype):
    """τ, τ_zz and W of the model, C − I, and the constitutive dispatch of a
    table with SVK beside Neo-Hookean, at small and finite strains."""
    tol = 1e-6 if dtype == "float32" else 1e-12
    rng = np.random.default_rng(dim)
    n = 48
    scale = np.repeat([1e-4, 1e-2, 0.2], n // 3)[:, None, None]
    F = (np.eye(dim) + scale * rng.standard_normal((n, dim, dim))).astype(dtype)
    E = rng.uniform(1e6, 1e7, n).astype(dtype)
    nu = rng.uniform(0.0, 0.45, n).astype(dtype)
    mat_id = (np.arange(n) % 2).astype(np.int32)
    rows = [jM.material(kind="Saint-Venant-Kirchhoff", E=2e6, nu=0.3),
            jM.material(kind="Neo-Hookean-Wriggers", E=5e6, nu=0.2)]
    with jax.enable_x64(dtype == "float64"):
        mj = jM.material_table(rows)
        mj = mj.replace(E=mj.E.astype(dtype), nu=mj.nu.astype(dtype))
        ref = jhyper.saint_venant_kirchhoff(jnp.asarray(F), jnp.asarray(E), jnp.asarray(nu))
        ref_c = jtn.cmi_from_disp_grad(jnp.asarray(F) - jnp.eye(dim, dtype=dtype))
        z1, z2 = np.zeros(n, dtype), np.zeros((n, dim, dim), dtype)
        state = dict(bemi=z2, bemi_zz=z1, eps=z1, kappa=z1, back_stress=z2)
        ref_d = jcon.stress_integration(
            F_n1=jnp.asarray(F), DF=jnp.asarray(F), dFdt_n1=jnp.asarray(z2),
            mat_id=jnp.asarray(mat_id), mats=mj,
            kinds=(jM.SAINT_VENANT_KIRCHHOFF, jM.NEO_HOOKEAN),
            **{k: jnp.asarray(v) for k, v in state.items()})
        ref_d = [np.asarray(a) for a in (ref_d.tau, ref_d.tau_zz, ref_d.W)]
        mt = to_torch_materials(mj)
    got = thyper.saint_venant_kirchhoff(*(torch.as_tensor(a) for a in (F, E, nu)))
    for g, r in zip(got, ref):
        assert g.dtype == (torch.float64 if dtype == "float64" else torch.float32)
        _close(g.numpy(), r, tol)
    _close(ttn.cmi_from_disp_grad(torch.as_tensor(F) - torch.eye(dim, dtype=got[0].dtype)),
           ref_c, tol)
    got_d = tcon.stress_integration(
        F_n1=torch.as_tensor(F), DF=torch.as_tensor(F), dFdt_n1=torch.as_tensor(z2),
        mat_id=torch.as_tensor(mat_id), mats=mt, kinds=(2, 3),
        **{k: torch.as_tensor(v) for k, v in state.items()})
    for g, r in zip((got_d.tau, got_d.tau_zz, got_d.W), ref_d):
        _close(g.numpy(), r, tol)


@pytest.mark.parametrize("dim", [2, 3])
def test_scatter_engine_matches_jax(dim):
    """FEM shape functions of random particles on a small grid (some of
    them outside it), then the engines' p2g of per-edge scalars and vectors,
    g2p of node scalars and vectors, and edge_gather: node ids and every
    output equal to rounding."""
    rng = np.random.default_rng(10 + dim)
    n_side, n = 6, 40
    h = 1.0 / (n_side - 1)
    gj = JGrid(dims=(n_side,) * dim, spacing=h, origin=(0.0,) * dim)
    x = rng.uniform(-0.05, 1.05, (n, dim)).astype(np.float32)
    sj = jfem.evaluate(gj, jnp.asarray(x))
    tg = to_torch_grid(gj)
    st = tfem.evaluate(tg, torch.as_tensor(x))
    np.testing.assert_array_equal(st["node_ids"].numpy(), np.asarray(sj["node_ids"]))
    ej = jtransfer.ScatterEngine(gj, sj["node_ids"], sj["mask"])
    cfg = DEMConfig(dt=1.0, shapefun="fem", transfer="scatter")
    et = common.make_engine(cfg, tg, st, tfem.offsets_for(dim), st["mask"])
    assert isinstance(et, ttransfer.ScatterEngine)
    K = st["N"].shape[1]
    vals1 = rng.standard_normal((n, K)).astype(np.float32)
    vals3 = rng.standard_normal((n, K, 3)).astype(np.float32)
    f1 = rng.standard_normal(tg.n_nodes).astype(np.float32)
    f3 = rng.standard_normal((tg.n_nodes, 3)).astype(np.float32)
    cases = [("p2g scalar", et.p2g(torch.as_tensor(vals1)), ej.p2g(jnp.asarray(vals1))),
             ("p2g vector", et.p2g(torch.as_tensor(vals3)), ej.p2g(jnp.asarray(vals3))),
             ("g2p scalar", et.g2p(st["N"], torch.as_tensor(f1)), ej.g2p(sj["N"], jnp.asarray(f1))),
             ("g2p vector", et.g2p(st["N"], torch.as_tensor(f3)), ej.g2p(sj["N"], jnp.asarray(f3))),
             ("edge_gather", et.edge_gather(torch.as_tensor(f3)), ej.edge_gather(jnp.asarray(f3)))]
    for name, got, ref in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_make_engine_routes_the_transfer_names():
    """'scatter' builds the ScatterEngine (no box needed), 'windowed' needs a
    box, 'binned' raises naming the do-not-port list, 'fused' is the steps'
    own dispatch and never reaches make_engine."""
    gj = JGrid(dims=(4, 4), spacing=1.0 / 3, origin=(0.0, 0.0))
    tg = to_torch_grid(gj)
    st = tfem.evaluate(tg, torch.full((3, 2), 0.5))
    offs = tfem.offsets_for(2)
    cfg = DEMConfig(dt=1.0, shapefun="fem")
    assert cfg.transfer == "scatter"
    assert isinstance(common.make_engine(cfg, tg, st, offs, st["mask"]), ttransfer.ScatterEngine)
    with pytest.raises(ValueError, match="active_box"):
        common.make_engine(cfg.replace(transfer="windowed"), tg, st, offs, st["mask"])
    with pytest.raises(NotImplementedError, match="do-not-port list, ROADMAP.md queue 2"):
        common.make_engine(cfg.replace(transfer="binned"), tg, st, offs, st["mask"])
    with pytest.raises(ValueError, match="no fused transfer path"):
        common.make_engine(cfg.replace(transfer="fused"), tg, st, offs, st["mask"])
