"""The implicit Newmark-β and quasi-static steps with the return mappings
and Hencky: their J·v is forward mode through the plastic models, with the
spectral tangent of ops/tensor.py::isotropic_map.

* One 2D windowed step from a general prestrained state with strips of
  Hencky, von Mises, Drucker-Prager and Matsuoka-Nakai in a Neo-Hookean
  frame against the JAX package's step, by pid: rel_dx < 1e-3, rel_dv <
  1e-2 (chip_smoke.py's parity gates), equal Newton iterations, per kind the
  eps and kappa gaps within EPS_GAP of their largest magnitude.
* The strips but Matsuoka-Nakai's in 3D on the scatter engine against the
  port's windowed engine, at the same limits (the JAX package's 3D J·v through its Jacobi
  sweeps is not finite on these states, ROADMAP.md queue 3).
* tests/test_implicit.py's bar from rest with Hencky and with von Mises
  below yield: every step converged, the quarter-period error < 0.12 (the
  JAX package's step stalls on this bar: its J·v is NaN at rest).
* tests/test_implicit.py's and tests/test_3d.py's quasi-static gravity
  columns against ρg(H − y) (15 % in the bulk), with Neo-Hookean as the JAX
  tests run them and with Drucker-Prager below yield (a diagonal-strain
  case)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import implicit as jim
from nlpartsol_tpu.models import materials as jM

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex, implicit as tim
from nlpartsol_tpu_torch.formulations.courant import courant_dt
from nlpartsol_tpu_torch.models import materials as tM
from nlpartsol_tpu_torch.types import make_particles

from _torch_port import (by_pid, cheap_jax_compiles, implicit_configs, problem,  # noqa: F401
                         problem3, to_torch_materials, with_fields)
from test_explicit import C, E_, RHO
from test_torch_fem import _bar, _quarter_period_error

torch.set_num_threads(1)

BODY = np.asarray([0.0, -9.81], np.float32)
EPS_GAP = 1e-3
SOLID = dict(E=1e6, nu=0.3, rho0=1000.0)
STRIPS = [dict(kind="Neo-Hookean-Wriggers", **SOLID), dict(kind="Hencky", **SOLID),
          dict(kind="Von-Mises", kappa0=300.0, hardening_modulus=1e4, theta_voce=1.0, **SOLID),
          dict(kind="Drucker-Prager", kappa0=100.0, friction_angle=30.0, dilatancy_angle=10.0,
               exponent_ortiz=2.0, plastic_strain_0=0.01, **SOLID),
          dict(kind="Matsuoka-Nakai", a1_borja=5.0, a3_borja=0.0, alpha_borja=0.162, **SOLID)]


def _prestrained(x, dim, seed):
    """Strip ids along x inside the middle of the block (the frame: row 0,
    Neo-Hookean), and a general state: F, b_e − I with the frictional strip
    confined, eps and kappa on the hardening laws, random velocities."""
    rng = np.random.default_rng(seed)
    n = len(x)
    strip = np.clip(((x[:, 0] - 0.15) / 0.7 * 5).astype(int), 0, 4)
    inner = np.all((x[:, 1:] > 0.25) & (x[:, 1:] < 0.75), axis=1)
    mat_id = np.where(inner, strip, 0).astype(np.int32)
    fr = mat_id == 4
    vol = np.where(fr, -2e-3, 0.0)
    e = 1e-3 * rng.standard_normal((n, dim, dim))
    e = 0.5 * (e + np.swapaxes(e, 1, 2))
    eps = np.where(fr, 1e-3 * rng.uniform(0.5, 1.5, n), rng.uniform(0.0, 0.01, n))
    return dict(
        mat_id=mat_id,
        F=(np.eye(dim) + 2e-3 * rng.standard_normal((n, dim, dim))).astype(np.float32),
        bemi=np.expm1(2.0 * (e + vol[:, None, None] * np.eye(dim))).astype(np.float32),
        bemi_zz=(np.expm1(2.0 * vol) * (dim == 2)).astype(np.float32),
        eps=eps.astype(np.float32),
        kappa=np.where(mat_id == 3, 100.0 * np.sqrt(1.0 + eps / 0.01), 5.0 * eps
                       ).astype(np.float32),
        v=(0.02 * rng.standard_normal((n, dim))).astype(np.float32))


def _gaps(got, ref, mat_id):
    """Per strip: the eps and kappa gaps over their largest magnitudes."""
    out = {}
    for k in range(1, len(STRIPS)):
        sel = mat_id == k
        if not sel.any():
            continue
        out[STRIPS[k]["kind"]] = max(
            float(np.abs(got[f][sel] - ref[f][sel]).max()
                  / max(float(np.abs(ref[f][sel]).max()), 1e-30)) for f in ("eps", "kappa"))
    return out


def _check_step(got, ref, h, mat_id):
    rel_dx = float(np.abs(got["x"] - ref["x"]).max()) / h
    rel_dv = float(np.abs(got["v"] - ref["v"]).max()) / float(np.abs(ref["v"]).max())
    gaps = _gaps(got, ref, mat_id)
    assert rel_dx < 1e-3 and rel_dv < 1e-2, (rel_dx, rel_dv)
    assert max(gaps.values()) < EPS_GAP, gaps


def test_2d_step_with_return_mappings_matches_jax():
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=9, n_side=14, n_particles=180)
    fields = _prestrained(np.asarray(pj.x), 2, seed=12)
    fields["vol0"] = np.full(pj.count, gj.spacing ** 2 / 4, np.float32)
    pj, tp = with_fields(pj, tp, **fields)
    mj = jM.material_table([jM.material(**r) for r in STRIPS])
    kinds = tuple(sorted({int(k) for k in np.asarray(mj.kind)}))
    cfg_j, cfg_t = implicit_configs(gj, bj, lj, transfer="windowed", cg_maxiter=100)
    cfg_j, cfg_t = cfg_j.replace(kinds=kinds), cfg_t.replace(kinds=kinds)
    pj1, dj = jax.jit(jim.implicit_step, static_argnums=(3,))(pj, gj, mj, cfg_j,
                                                              jnp.asarray(BODY))
    tp1, dt_ = tim.implicit_step(tp, tg, to_torch_materials(mj), cfg_t, torch.as_tensor(BODY))
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert dt_["newton_iters"] == int(dj["newton_iters"])
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    names = ("x", "v", "eps", "kappa", "mat_id")
    got, ref = by_pid(tp1, names), by_pid(pj1, names)
    _check_step(got, ref, gj.spacing, ref["mat_id"])
    # each plastic strip yielded somewhere
    eps0 = by_pid(tp, ("eps",))["eps"]
    for k in (2, 3, 4):
        assert (got["eps"][ref["mat_id"] == k] > eps0[ref["mat_id"] == k]).any(), k


def test_3d_scatter_step_with_return_mappings_matches_windowed():
    """Without the Matsuoka-Nakai strip (its particles Neo-Hookean): its
    forward mode takes most of a step's CPU time, and
    test_torch_tangent.py holds its 3D J·v."""
    (_, _, _, _), (tg, tb, tp, lt) = problem3(seed=3, n_side=6, n_particles=60)
    fields = _prestrained(tp.x.numpy(), 3, seed=13)
    fields["mat_id"] = np.where(fields["mat_id"] == 4, 0, fields["mat_id"]).astype(np.int32)
    fields["vol0"] = np.full(tp.count, tg.spacing ** 3 / 8, np.float32)
    tp = tp.replace(**{k: torch.as_tensor(v) for k, v in fields.items()})
    mt = tM.material_table([tM.material(**r) for r in STRIPS[:4]], device="cpu")
    cfg = tim.ImplicitConfig(dt=0.5 * tg.spacing / np.sqrt(1e6 / 1e3), lme_params=lt,
                             kinds=tuple(sorted({int(k) for k in mt.kind})), active_box=tb,
                             cg_maxiter=100, transfer="scatter")
    body = torch.tensor([0.0, 0.0, -9.81])
    ps, ds = tim.implicit_step(tp, tg, mt, cfg, body)
    pw, dw = tim.implicit_step(tp, tg, mt, cfg.replace(transfer="windowed"), body)
    assert bool(ds["converged"]) and bool(dw["converged"])
    assert ds["newton_iters"] == dw["newton_iters"]
    assert int(ds["lost"]) == int(dw["lost"]) == 0
    names = ("x", "v", "eps", "kappa", "mat_id")
    got, ref = by_pid(ps, names), by_pid(pw, names)
    _check_step(got, ref, tg.spacing, ref["mat_id"])
    assert all(torch.isfinite(getattr(ps, f)).all() for f in ("stress", "bemi", "F"))


@pytest.mark.parametrize("kind", [dict(kind="Hencky"),
                                  dict(kind="Von-Mises", kappa0=1e4, hardening_modulus=1e5)])
def test_implicit_bar_from_rest(kind):
    """tests/test_implicit.py::test_implicit_bar_vibration with the bar's
    material replaced (E 1e7, ν 0, ρ 1e3; von Mises' σy 1e4 Pa is above the
    bar's stresses of about 1e3 Pa): Newmark-β at 4× the explicit step,
    every step converged, quarter-period error within 0.12."""
    tg, tp, _, L, h, V, box = _bar("fem")
    mt = tM.material_table([tM.material(E=E_, nu=0.0, rho0=RHO, **kind)], device="cpu")
    dt = courant_dt(1.0, h, C)
    cfg = tim.ImplicitConfig(dt=dt, shapefun="fem", kinds=(int(mt.kind[0]),),
                             transfer="windowed", active_box=box)
    n_quarter = int(round((np.pi / 2 / (np.pi * C / L)) / dt))
    p = tex.to_slot_layout(tp, tg, box)
    for _ in range(n_quarter):
        p, dg = tim.implicit_step(p, tg, mt, cfg, torch.zeros(2))
        assert bool(dg["converged"]) and dg["newton_iters"] <= 20
    err = _quarter_period_error(tp, p, L, V)
    assert err < 0.12, f"quarter-period displacement error {err:.3f}"
    assert float(p.eps.abs().max()) == 0.0  # below yield


def _column(dim):
    """tests/test_implicit.py's column (2×10 cells, h 0.1) in 2D and
    tests/test_3d.py's (2×2×8 cells, h 0.125) in 3D: 2 particles a cell
    side, bottom fixed vertically, lateral motion fixed everywhere."""
    cells = (2, 10) if dim == 2 else (2, 2, 8)
    h = 0.1 if dim == 2 else 0.125
    dims = tuple(c + 1 for c in cells)
    n_nodes = int(np.prod(dims))
    ids = np.arange(n_nodes).reshape(dims)
    mask = np.zeros((n_nodes, dim), bool)
    mask[ids[..., 0].ravel(), dim - 1] = True
    mask[:, :dim - 1] = True
    grid = convert.grid_from_numpy(dims, h, (0.0,) * dim, dirichlet_mask=mask,
                                   dirichlet_value=np.zeros((n_nodes, dim), np.float32),
                                   device="cpu")
    axes = [np.arange(c) for c in cells] + [np.arange(2)] * dim
    g = np.meshgrid(*axes, indexing="ij")
    x = np.stack([(g[a] + (g[dim + a] + 0.5) / 2) * h for a in range(dim)], -1)
    x = x.reshape(-1, dim).astype(np.float32)
    vol = (h / 2) ** dim
    p = make_particles(x, mass=np.full(len(x), RHO * vol, np.float32),
                       vol0=np.full(len(x), vol, np.float32), device="cpu")
    return grid, p, cells[-1] * h


@pytest.mark.parametrize("dim,kind", [
    (2, dict(kind="Neo-Hookean-Wriggers")),
    (2, dict(kind="Drucker-Prager", kappa0=1e6, friction_angle=30.0, dilatancy_angle=10.0,
             exponent_ortiz=2.0, plastic_strain_0=0.01)),
    (3, dict(kind="Neo-Hookean-Wriggers"))])
def test_quasi_static_gravity_column(dim, kind):
    """tests/test_implicit.py:78 and tests/test_3d.py:91 through the port
    (FEM, scatter engine): one quasi-static step under gravity, converged,
    σ_vv within 15 % of ρg(H − y) in the bulk; Drucker-Prager's κ0 1e6 Pa
    keeps it below yield (eps unchanged)."""
    grid, p, H = _column(dim)
    mt = tM.material_table([tM.material(E=E_, nu=0.0, rho0=RHO, **kind)], device="cpu")
    p = p.replace(kappa=torch.full_like(p.kappa, float(mt.kappa0[0])))  # Drucker-Prager at κ0
    cfg = tim.ImplicitConfig(dt=1.0, shapefun="fem", kinds=(int(mt.kind[0]),),
                             quasi_static=True, transfer="scatter")
    g = 9.81
    body = torch.zeros(dim)
    body[-1] = -g
    p1, diag = tim.implicit_step(p, grid, mt, cfg, body)
    assert bool(diag["converged"])
    y = p1.x[:, -1].numpy()
    s = p1.stress[:, -1, -1].numpy()
    bulk = (y > 0.15) & (y < 0.85)
    err = np.abs(s[bulk] + RHO * g * (H - y[bulk])).max() / (RHO * g * H)
    assert err < 0.15, f"lithostatic stress error {err:.3f}"
    assert float(p1.eps.abs().max()) == 0.0


def test_cached_principal_jacobians_are_the_fresh_ones():
    """A J·v at an iterate where the principal Jacobians are held (all but
    the first of a Newton iteration's) equals one computed afresh, for each
    of two kinds that share a principal map and its arguments (the Borja
    family: the yield kind tells them apart), in float64."""
    from nlpartsol_tpu_torch.models import borja as tborja
    from nlpartsol_tpu_torch.ops import solvers, tensor as ttn

    rng = np.random.default_rng(21)
    n = 16
    f64 = torch.float64
    e = 1e-3 * rng.standard_normal((n, 2, 2))
    bemi = torch.as_tensor(np.expm1(2.0 * (0.5 * (e + e.transpose(0, 2, 1)) - 2e-3 * np.eye(2))))
    hist = (bemi, torch.full((n,), float(np.expm1(-4e-3)), dtype=f64),
            torch.ones(n, dtype=f64), torch.full((n,), 4.5, dtype=f64))
    par = {k: torch.full((n,), v, dtype=f64) for k, v in dict(
        E=1e6, nu=0.3, m=0.2, phi=0.0, a1=10.0, a2=0.0, a3=0.8, alpha=0.162, pa=-1e5).items()}
    X0 = torch.as_tensor(1e-3 * rng.standard_normal((n, 2, 2)))
    V = [torch.as_tensor(rng.standard_normal((n, 2, 2))) for _ in range(2)]

    def jv(kind, v):
        def f(X):
            b, bzz, eps, kap = hist
            out = tborja.borja_frictional(b, bzz, torch.eye(2, dtype=f64) + X, eps, kap,
                                          yield_kind=kind, **par)
            return torch.cat([out.tau.reshape(n, -1), out.bemi.reshape(n, -1)], 1)
        return solvers.jvp(f, X0, v)[1]

    fresh = {}
    for kind in ("matsuoka-nakai", "lade-duncan"):
        for i, v in enumerate(V):
            ttn.clear_jacobian_cache()
            fresh[kind, i] = jv(kind, v)
    ttn.clear_jacobian_cache()
    for kind in ("matsuoka-nakai", "lade-duncan", "matsuoka-nakai"):
        for i, v in enumerate(V):
            torch.testing.assert_close(jv(kind, v), fresh[kind, i], rtol=1e-12, atol=0.0)
    assert not torch.allclose(fresh["matsuoka-nakai", 0], fresh["lade-duncan", 0])
