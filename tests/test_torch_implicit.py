"""The implicit Newmark-β slice in 2D: the port's implicit step on the
windowed and on the fused engine against the JAX package's, from the same
numpy state, compared by pid over active particles at the tolerances of
tests/test_pallas_transfer.py::test_implicit_step_pallas_matches_windowed
(x rtol 1e-4 atol 1e-6; v, F rtol 1e-3 atol 1e-5) with equal nnz and Newton
iterations; a quasi-static step with a Dirichlet bottom and tractions
(reactions compared); the kernels' linear wrappers under forward-mode AD; the
port's J·v against a central difference of its own residual in float64; and
the options that wait.  The JAX side is jitted, each program compiled
once."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import implicit as jim
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme
from nlpartsol_tpu.types import Grid as JGrid, Particles as JParticles, make_particles as jmake

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex

from nlpartsol_tpu_torch.formulations import implicit as tim
from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.ops import solvers
from nlpartsol_tpu_torch.shapefun import lme as tlme

from _torch_port import (by_pid, cheap_jax_compiles, implicit_configs,  # noqa: F401
                         neo_hookean_tables, problem, to_torch_box, to_torch_grid,
                         to_torch_particles, with_fields)

torch.set_num_threads(1)

TOL = dict(x=dict(rtol=1e-4, atol=1e-6), v=dict(rtol=1e-3, atol=1e-5),
           F=dict(rtol=1e-3, atol=1e-5))
BODY = np.asarray([0.0, -9.81], np.float32)


def _problem():
    """tests/test_pallas_transfer.py's implicit problem: 180 particles on a
    14² grid, random velocities, vol0 = h²/4."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=9, n_side=14, n_particles=180)
    rng = np.random.default_rng(10)
    pj, tp = with_fields(pj, tp, v=(0.02 * rng.standard_normal((pj.count, 2))).astype(np.float32),
                         vol0=np.full(pj.count, gj.spacing ** 2 / 4, np.float32))
    return (gj, bj, pj, lj), (tg, tb, tp, lt)


def _assert_step_matches(tp, pj, dt_, dj):
    assert int(dt_["nnz"]) == int(dj["nnz"])
    assert dt_["newton_iters"] == int(dj["newton_iters"])
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    got, ref = by_pid(tp), by_pid(pj)
    for name, tol in TOL.items():
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_two_implicit_steps_match_jax(transfer):
    (gj, bj, pj, lj), (tg, tb, tp, lt) = _problem()
    mj, mt = neo_hookean_tables()
    cfg_j, cfg_t = implicit_configs(gj, bj, lj, transfer=transfer, cg_maxiter=100)
    assert cfg_t.transfer == {"pallas": "fused", "windowed": "windowed"}[transfer]
    step_j = jax.jit(jim.implicit_step, static_argnums=(3,))
    cg = []
    for _ in range(2):
        pj, dj = step_j(pj, gj, mj, cfg_j, jnp.asarray(BODY))
        tp, dt_ = tim.implicit_step(tp, tg, mt, cfg_t, torch.as_tensor(BODY))
        _assert_step_matches(tp, pj, dt_, dj)
        cg.append((dt_["cg_iters"], int(dj["cg_iters"])))
    # CG totals are reported, not gated: sums in another order may move
    # them by an iteration; here they agree
    assert all(a == b for a, b in cg), cg


def _lattice_column():
    """A block of 8×9 cells at 2×2 particles a cell (ρ = 1000) on the 14²
    grid, its lowest three node rows fixed."""
    n, ppc = 14, 2
    h = 1.0 / (n - 1)
    gj = JGrid(dims=(n, n), spacing=h, origin=(0.0, 0.0))
    i, j, a, b = np.meshgrid(np.arange(3, 11), np.arange(2, 11), np.arange(ppc), np.arange(ppc),
                             indexing="ij")
    x = np.stack([(i + (a + 0.5) / ppc) * h, (j + (b + 0.5) / ppc) * h], -1).reshape(-1, 2)
    vol = (h / ppc) ** 2
    pj = jmake(x.astype(np.float32), mass=np.full(len(x), 1000.0 * vol, np.float32),
               vol0=np.full(len(x), vol, np.float32))
    bj = jwin.ActiveBox(offset=(1, 1), cdims=(12, 12), capacity=6)
    fixed = np.zeros((gj.n_nodes, 2), bool)
    fixed.reshape(n, n, 2)[:, :3, :] = True
    gj = gj.replace(dirichlet_mask=jnp.asarray(fixed),
                    dirichlet_value=jnp.zeros((gj.n_nodes, 2), jnp.float32))
    tg, tb = to_torch_grid(gj), to_torch_box(bj)
    tp = tex.to_slot_layout(to_torch_particles(pj), tg, tb)
    pj = JParticles(**{k: jnp.asarray(v) for k, v in convert.particles_to_numpy(tp).items()})
    return (gj, bj, pj, jlme.LMEParams(gamma=3.0)), (tg, tb, tp, tlme.LMEParams(gamma=3.0)), fixed


def test_quasi_static_dirichlet_traction_step_matches_jax():
    """Fused against 'pallas': a quasi-static step of a block under gravity
    with its lowest node rows fixed and random tractions (the first
    scatter's channels are then mass, momenta, traction, stiffness, and the
    step bins by sorting); reactions on the fixed dofs compared.  Nodes
    under 1e-3 of mass are left out of the solve (``mass_tol``): without
    inertia the LME tails give them almost no stiffness, and CG stalls on
    them in float32 in both packages."""
    (gj, bj, pj, lj), (tg, tb, tp, lt), fixed = _lattice_column()
    mj, mt = neo_hookean_tables()
    rng = np.random.default_rng(11)
    trac = (1e3 * rng.standard_normal((pj.count, 2))).astype(np.float32)
    area = np.full(pj.count, gj.spacing / 2, np.float32)
    cfg_j, cfg_t = implicit_configs(gj, bj, lj, transfer="pallas", quasi_static=True,
                                    cg_maxiter=100, mass_tol=1e-3)
    pj, dj = jax.jit(jim.implicit_step, static_argnums=(3,))(
        pj, gj, mj, cfg_j, jnp.asarray(BODY), jnp.asarray(trac), jnp.asarray(area))
    tp, dt_ = tim.implicit_step(tp, tg, mt, cfg_t, torch.as_tensor(BODY),
                                traction=torch.as_tensor(trac),
                                traction_area=torch.as_tensor(area))
    _assert_step_matches(tp, pj, dt_, dj)
    ref = np.asarray(dj["reactions"])
    assert np.abs(ref).max() > 1.0 and not ref[~fixed].any()
    np.testing.assert_allclose(dt_["reactions"].numpy(), ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())


def test_kernel_wrappers_jvp_is_the_function_of_the_tangent():
    """GatherGrad, GatherN and ScatterG (the plain versions on CPU tensors):
    under the port's forward mode (dual tensors, ``solvers.jvp``) the primal
    is f(x) and the tangent f(t), with
    positions, λ and act fixed."""
    (_, _, _, _), (tg, tb, tp, lt) = _problem()
    C, nc = tb.capacity, tb.n_cells
    x_t, lam_t, act_t = (ft.to_channel_leading(a, C, nc)
                         for a in (tp.x, tp.lme_lambda, tp.active.float()))
    _, lam_t, _ = ft.fused_scatter(tg, tb, lt, x_t, lam_t, act_t,
                                   ft.to_channel_leading(tp.mass, C, nc))
    geo = (tg, tb, lt, x_t, lam_t, act_t, 0)
    rng = np.random.default_rng(12)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    cases = [(ft.GatherGrad, rand(tg.n_nodes, 2), rand(tg.n_nodes, 2)),
             (ft.GatherN, rand(tg.n_nodes, 6), rand(tg.n_nodes, 6)),
             (ft.ScatterG, rand(tp.count, 2, 2), rand(tp.count, 2, 2))]
    for fn, x, t in cases:
        out, tan = solvers.jvp(lambda v: torch.sin(fn.apply(v, geo)), x, t)
        f_x, f_t = fn.apply(x, geo), fn.apply(t, geo)
        assert float(f_t.abs().max()) > 0.0, fn.__name__
        torch.testing.assert_close(out, torch.sin(f_x), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(tan, torch.cos(f_x) * f_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("transfer", ["windowed", "fused"])
def test_jv_matches_central_difference_float64(transfer, monkeypatch):
    """The J·v the Newton-CG solve uses (forward mode through the stress,
    the kinematics and the transfers) against (R(x + sv) − R(x − sv))/2s of
    the port's own residual, in float64, at a nonzero iterate."""
    (_, _, _, _), (tg, tb, tp, lt) = _problem()
    _, mt = neo_hookean_tables()
    tp = tp.map_tensors(lambda a: a.double() if a.is_floating_point() else a)
    mt = mt.map_tensors(lambda a: a.double() if a.is_floating_point() else a)
    cfg = tim.ImplicitConfig(dt=0.5 * tg.spacing / np.sqrt(1e3), lme_params=lt,
                             active_box=tb, transfer=transfer, newton_maxiter=0)
    seen = {}
    real = solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen["residual"] = residual
        return real(residual, x0, **kw)

    monkeypatch.setattr(solvers, "newton_krylov", spy)
    tim.implicit_step(tp, tg, mt, cfg, torch.as_tensor(BODY, dtype=torch.float64))
    R = seen["residual"]
    rng = np.random.default_rng(13)
    x = torch.as_tensor(1e-3 * tg.spacing * rng.standard_normal((tg.n_nodes, 2)))
    v = torch.as_tensor(tg.spacing * rng.standard_normal((tg.n_nodes, 2)))
    Jv = solvers.jvp(R, x, v)[1]
    s = 1e-5
    fd = (R(x + s * v) - R(x - s * v)) / (2 * s)
    assert float(Jv.abs().max()) > 0.0
    torch.testing.assert_close(Jv, fd, rtol=1e-6, atol=1e-6 * float(fd.abs().max()))


def test_options_that_wait_raise():
    (_, _, _, _), (tg, tb, tp, lt) = _problem()
    _, mt = neo_hookean_tables()
    body = torch.as_tensor(BODY)
    base = tim.ImplicitConfig(dt=1e-3, lme_params=lt, active_box=tb)
    # sharding (item 15) runs now: tests/test_torch_not_ported.py::
    # test_sharding_options_run[implicit]
    waiting = [("queue 2", dict(transfer="binned"))]
    for item, kw in waiting:
        with pytest.raises(NotImplementedError, match=item):
            tim.implicit_step(tp, tg, mt, base.replace(**kw), body)
    with pytest.raises(ValueError, match="jacobi"):
        tim.implicit_step(tp, tg, mt, base.replace(precond="block-jacobi"), body)
