"""The port's structured FEM shape functions (shapefun/fem.py) against the
JAX package's ``fem.evaluate`` in 2D and 3D, and the elastic-bar oracles of
tests/test_explicit.py::test_bar_vibration and
tests/test_implicit.py::test_implicit_bar_vibration through the port:
explicit FEM on the windowed engine, explicit LME on both engines, implicit
FEM on the windowed engine, each with a box over the whole grid."""

import numpy as np
import pytest
import torch

from nlpartsol_tpu.shapefun import fem as jfem
from nlpartsol_tpu.types import Grid as JGrid

from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.formulations import implicit as tim
from nlpartsol_tpu_torch.formulations.courant import courant_dt
from nlpartsol_tpu_torch.ops import windowed as twin
from nlpartsol_tpu_torch.shapefun import fem as tfem
from nlpartsol_tpu_torch.shapefun import lme as tlme

from _torch_port import (cheap_jax_compiles, to_torch_grid, to_torch_materials,  # noqa: F401
                         to_torch_particles)
from test_explicit import C, bar_setup

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [2, 3])
def test_fem_basis_matches_jax(dim):
    """N, ∇N, the mask and the node ids of random particles, particles on
    nodes and particles outside the grid (rtol 1e-6)."""
    rng = np.random.default_rng(40 + dim)
    n_side, h = 6, 0.2
    gj = JGrid(dims=(n_side,) * dim, spacing=h, origin=(0.1,) * dim)
    ext = (n_side - 1) * h
    inside = 0.1 + ext * rng.random((60, dim))
    on_nodes = 0.1 + h * rng.integers(0, n_side, (12, dim))
    outside = 0.1 + ext * (rng.random((8, dim)) * 1.6 - 0.3)
    x = np.concatenate([inside, on_nodes, outside]).astype(np.float32)
    ref = jfem.evaluate(gj, x)
    got = tfem.evaluate(to_torch_grid(gj), torch.as_tensor(x))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    np.testing.assert_array_equal(got["node_ids"].numpy(), np.asarray(ref["node_ids"]))
    assert got["lam"] is None and ref["lam"] is None
    for key in ("N", "dN"):
        want = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-6,
                                   atol=1e-7 * np.abs(want).max(), err_msg=key)
    # partition of unity inside the grid
    in_grid = np.all((x >= 0.1) & (x <= 0.1 + ext), axis=1)
    np.testing.assert_allclose(got["N"].numpy()[in_grid].sum(1), 1.0, rtol=1e-6)


def _bar(shapefun):
    """tests/test_explicit.py's bar (20×2 cells, 2×2 particles a cell,
    fixed ends, no transverse motion) with v = V sin(πx/L), for the port
    on the CPU, and a box over the whole grid."""
    gj, pj, mj, L, h = bar_setup(shapefun)
    V = 0.01
    x0 = np.asarray(pj.x)
    v = np.stack([V * np.sin(np.pi * x0[:, 0] / L), np.zeros(len(x0))], -1)
    tp = to_torch_particles(pj).replace(v=torch.as_tensor(v, dtype=torch.float32))
    tg = to_torch_grid(gj)
    return tg, tp, to_torch_materials(mj), L, h, V, twin.full_box(tg, capacity=4)


def _quarter_period_error(p0, p1, L, V):
    """Largest error of u_x after a quarter period against (V/ω) sin(πx/L),
    over the amplitude, matched by pid."""
    omega = np.pi * C / L
    act = p1.active.numpy()
    dis = np.zeros(p0.count)
    dis[p1.pid.numpy()[act]] = p1.dis.numpy()[act, 0]
    u_ref = (V / omega) * np.sin(np.pi * p0.x.numpy()[:, 0] / L)
    return np.abs(dis - u_ref).max() / (V / omega)


@pytest.mark.parametrize("shapefun,transfer", [("fem", "windowed"), ("lme", "windowed"),
                                               ("lme", "fused")])
def test_explicit_bar_vibration(shapefun, transfer):
    """Quarter-period displacement within 0.08 of the amplitude and energy
    drift within 5 % (the JAX package's limits)."""
    tg, tp, tm, L, h, V, box = _bar(shapefun)
    dt = courant_dt(0.25, h, C)
    cfg = tex.ExplicitConfig(dt=dt, shapefun=shapefun, lme_params=tlme.LMEParams(gamma=3.0),
                             kinds=(3,), transfer=transfer, active_box=box)
    n_quarter = int(round((np.pi / 2 / (np.pi * C / L)) / dt))
    p1, hist = tex.run(tp, tg, tm, cfg, n_quarter)
    assert int(hist["lost"].sum()) == 0
    err = _quarter_period_error(tp, p1, L, V)
    assert err < 0.08, f"quarter-period displacement error {err:.3f}"
    ke0 = 0.5 * float(torch.sum(tp.mass * torch.sum(tp.v ** 2, -1)))
    etot = float(hist["kinetic_energy"][-1] + hist["strain_energy"][-1])
    assert abs(etot - ke0) / ke0 < 0.05, f"energy drift {(etot - ke0) / ke0:.3f}"


def test_implicit_fem_bar_vibration():
    """tests/test_implicit.py::test_implicit_bar_vibration: Newmark-β at 4×
    the explicit step, quarter-period error within 0.12, at most 20 Newton
    iterations a step."""
    tg, tp, tm, L, h, V, box = _bar("fem")
    dt = courant_dt(1.0, h, C)
    cfg = tim.ImplicitConfig(dt=dt, shapefun="fem", kinds=(3,), transfer="windowed",
                             active_box=box)
    n_quarter = int(round((np.pi / 2 / (np.pi * C / L)) / dt))
    p1, diags = tim.run(tp, tg, tm, cfg, n_quarter)
    err = _quarter_period_error(tp, p1, L, V)
    assert err < 0.12, f"quarter-period displacement error {err:.3f}"
    assert int(diags["newton_iters"].max()) <= 20
    with pytest.raises(ValueError, match="LME only"):
        tim.implicit_step(tp, tg, tm, cfg.replace(transfer="fused"), torch.zeros(2))
