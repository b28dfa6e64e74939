"""The 3D slice as a whole: the port's explicit step on the windowed and on
the fused engine against the JAX package's, by pid at STEP_TOL (the
tolerances the JAX package holds between its own engines), the 3D local
re-bin, the 3D bar-vibration oracle of tests/test_3d.py, and 3D records
through convert.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex
from nlpartsol_tpu.ops import windowed as jwin

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.models import materials as tM
from nlpartsol_tpu_torch.ops import fused_transfer as ft, windowed as twin
from nlpartsol_tpu_torch.shapefun import lme as tlme
from nlpartsol_tpu_torch.types import Grid, make_particles

from _torch_port import (assert_tracks, by_pid, cheap_jax_compiles,  # noqa: F401
                         explicit_configs, fields_to_numpy, neo_hookean_tables, problem3)

torch.set_num_threads(1)


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_four_explicit_steps_3d_match_jax(transfer):
    """The problem of tests/test_pallas_transfer3d.py's explicit-step test:
    80 particles on a 9³ grid, Neo-Hookean, per-step local re-bin."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem3(seed=7, n_side=9, n_particles=80,
                                                  speed=0.02)
    mj, mt = neo_hookean_tables()
    cfg_j, cfg_t = explicit_configs(gj, bj, lj, 0.2, transfer=transfer)
    assert cfg_t.transfer == {"pallas": "fused", "windowed": "windowed"}[transfer]
    body = np.asarray([0.0, 0.0, -9.81], np.float32)
    step_j = jax.jit(lambda q: jex.explicit_step(q, gj, mj, cfg_j, jnp.asarray(body)))
    ft.reset_launch_counts()
    for _ in range(4):
        pj, dj = step_j(pj)
        tp, dt_ = tex.explicit_step(tp, tg, mt, cfg_t, torch.as_tensor(body))
    assert int(dt_["nnz"]) == int(dj["nnz"]) > 0
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    assert_tracks(tp, pj)
    for key in ("kinetic_energy", "strain_energy"):
        np.testing.assert_allclose(float(dt_[key]), float(dj[key]), rtol=1e-4)
    # on CPU tensors the fused step runs the kernels' plain versions
    assert sum(ft.launch_counts.values()) == 0


def test_local_rebin_3d_matches_jax():
    """One firing of the 26-neighbour compaction after particles drifted up
    to 1.3 cells: the same slot order, and the same particles lost (those
    that moved more than one cell)."""
    (gj, bj, pj, _), (tg, tb, tp, _) = problem3(seed=5, n_side=8, n_particles=60)
    rng = np.random.default_rng(6)
    x = np.asarray(pj.x) + (1.3 * gj.spacing * (2 * rng.random((pj.count, 3)) - 1)).astype(
        np.float32)
    qj, lost_j = jax.jit(lambda q: jwin.local_rebin(q, gj, bj))(pj.replace(x=jnp.asarray(x)))
    qt, lost_t = twin.local_rebin(tp.replace(x=torch.as_tensor(x)), tg, tb)
    assert int(lost_t) == int(lost_j) > 0
    np.testing.assert_array_equal(qt.active.numpy(), np.asarray(qj.active))
    act = qt.active.numpy()
    np.testing.assert_array_equal(qt.pid.numpy()[act], np.asarray(qj.pid)[act])
    np.testing.assert_array_equal(qt.x.numpy()[act], np.asarray(qj.x)[act])
    # every kept particle sits in its slot's cell
    cells = torch.as_tensor(twin.slot_cells(tb))
    assert torch.equal(tg.cell_of(qt.x)[qt.active], cells[qt.active])


def test_bar_vibration_3d_lme_on_the_fused_engine():
    """tests/test_3d.py's oracle: an elastic bar, 8 cells long, ends fixed
    along its axis, lateral motion fixed, started in its first mode; after a
    quarter period the displacement is the analytic one within 0.15 of the
    amplitude (the tolerance tests/test_3d.py gives LME)."""
    E, rho, nx, ppc = 1e7, 1000.0, 8, 2
    L, h = 1.0, 1.0 / nx
    dims = (nx + 1, 3, 3)
    ids = np.arange(np.prod(dims)).reshape(dims)
    dmask = np.zeros((ids.size, 3), bool)
    dmask[ids[0].ravel(), 0] = dmask[ids[-1].ravel(), 0] = True
    dmask[:, 1:] = True
    grid = Grid(dims=dims, spacing=h, origin=(0.0, 0.0, 0.0),
                dirichlet_mask=torch.as_tensor(dmask),
                dirichlet_value=torch.zeros((ids.size, 3)))
    ii, jj, kk, a, b, c = np.meshgrid(np.arange(nx), np.arange(2), np.arange(2),
                                      *[np.arange(ppc)] * 3, indexing="ij")
    x = np.stack([(ii + (a + 0.5) / ppc) * h, (jj + (b + 0.5) / ppc) * h,
                  (kk + (c + 0.5) / ppc) * h], -1).reshape(-1, 3).astype(np.float32)
    vol = (h / ppc) ** 3
    cel = np.sqrt(E / rho)
    V, omega = 0.01, np.pi * cel / L
    v = np.zeros_like(x)
    v[:, 0] = V * np.sin(np.pi * x[:, 0] / L)
    p = make_particles(x, mass=np.full(len(x), rho * vol, np.float32),
                       vol0=np.full(len(x), vol, np.float32), v=v, device="cpu")
    mats = tM.material_table([tM.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.0, rho0=rho)],
                             device="cpu")
    dt = 0.25 * h / cel
    cfg = tex.ExplicitConfig(dt=dt, lme_params=tlme.LMEParams(gamma=3.0), kinds=(tM.NEO_HOOKEAN,),
                             transfer="fused", active_box=twin.full_box(grid, ppc ** 3))
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    p, diag = tex.run(p, grid, mats, cfg, n_quarter)
    assert int(diag["lost"].sum()) == 0 and int(p.active.sum()) == len(x)
    act = p.active
    dis = p.dis[act][:, 0].numpy()
    xs = p.x[act][:, 0].numpy() - dis
    u_ref = (V / omega) * np.sin(np.pi * xs / L)
    err = np.abs(dis - u_ref).max() / (V / omega)
    assert err < 0.15, f"3D LME bar error {err:.3f}"


def test_convert_round_trip_3d():
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem3(seed=0)
    src = fields_to_numpy(pj)
    back = convert.particles_to_numpy(tp)
    for name, ref in src.items():
        assert back[name].dtype == ref.dtype and back[name].shape == ref.shape, name
        np.testing.assert_array_equal(back[name], ref, err_msg=name)
    assert tp.F.shape == (tp.count, 3, 3) and tp.lme_lambda.shape == (tp.count, 3)
    g3 = convert.grid_from_numpy(gj.dims, gj.spacing, gj.origin, valid_lo=np.asarray([1, 2, 3]),
                                 valid_hi=np.int32(5), device="cpu")
    assert g3.valid_bounds() == ((1, 2, 3), (5, 7, 7)) and g3.dim == 3
    cfg_j = jex.ExplicitConfig(dt=1e-4, lme_params=lj, active_box=bj, transfer="pallas")
    cfg_t = convert.config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    assert cfg_t == tex.ExplicitConfig(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused")
    assert cfg_t.active_box.dim == 3 and by_pid(tp)["F"].shape[1:] == (3, 3)
