"""The port's Hencky, Mooney-Rivlin, linear elastic, Newtonian and Bingham
models and its constitutive dispatch over every kind, against the JAX
package on the same numpy inputs, and the JAX package's own oracles of these
models (tests/test_constitutive.py) run through the port.

Tolerances: float64 rtol 1e-10, float32 rtol 2e-5, each with an absolute
floor of that size times the largest magnitude; the oracles keep the JAX
tests' limits."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.models import borja as jborja, fluid as jfluid
from nlpartsol_tpu.models import hyperelastic as jhyper, materials as jM

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.models import borja as tborja, dispatch as tcon, fluid as tfluid
from nlpartsol_tpu_torch.models import hyperelastic as thyper

from _torch_port import cheap_jax_compiles, fields_to_numpy  # noqa: F401

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "float64": 1e-10}


def _close(got, ref, tol, err_msg):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30), err_msg=err_msg)


def _F(rng, n, dim, dtype):
    scale = np.repeat([1e-5, 1e-3, 0.05, 0.2], n // 4)[:, None, None]
    return (np.eye(dim) + scale * rng.standard_normal((n, dim, dim))).astype(dtype)


@pytest.mark.parametrize("dim", [2, 3])
def test_hyperelastic_and_fluid_models_match_jax(dim):
    """In 2D float32 and float64 (the JAX side jitted), in 3D float64 (eager:
    Hencky's unrolled Jacobi sweeps compile for longer than they run)."""
    n = 64
    rng = np.random.default_rng(dim)
    for dtype in ("float32", "float64") if dim == 2 else ("float64",):
        F = _F(rng, n, dim, dtype)
        dFdt = (rng.standard_normal((n, dim, dim)) * 10.0 ** rng.uniform(-3, 1, n)[:, None, None]
                ).astype(dtype)
        p = {k: rng.uniform(lo, hi, n).astype(dtype) for k, (lo, hi) in dict(
            E=(1e6, 1e7), nu=(0.1, 0.45), mu1=(1e5, 1e6), mu2=(1e4, 1e5), p0=(0.0, 1e3),
            mu=(1e-3, 1.0), n=(1.0, 7.0), K=(1e5, 2.2e6), tau_y=(0.0, 10.0),
            m_pap=(10.0, 100.0)).items()}
        fluid = dict(p0=p["p0"], n=p["n"], K=p["K"])
        calls = {
            "hencky": lambda m, a: m.hencky(a["F"], a["E"], a["nu"]),
            "mooney_rivlin": lambda m, a: m.mooney_rivlin(a["F"], a["E"], a["nu"], a["mu1"],
                                                          a["mu2"]),
            "linear_elastic": lambda m, a: m.linear_elastic(a["F"], a["E"], a["nu"]),
            "newtonian_fluid": lambda m, a: m.newtonian_fluid(
                a["F"], a["dFdt"], mu=a["mu"], **{k: a[k] for k in fluid}),
            "bingham_fluid": lambda m, a: m.bingham_fluid(
                a["F"], a["dFdt"], mu0=a["mu"], tau_y=a["tau_y"], m_pap=a["m_pap"],
                **{k: a[k] for k in fluid}),
        }
        arrays = dict(p, F=F, dFdt=dFdt)
        def reference(ja):
            return ({name: call(jfluid if "fluid" in name else jhyper, ja)
                     for name, call in calls.items()},
                    jfluid.spatial_velocity_gradient(ja["dFdt"], ja["F"]))

        with jax.enable_x64(dtype == "float64"):
            refs, L_ref = (jax.jit(reference) if dim == 2 else reference)(
                {k: jnp.asarray(v) for k, v in arrays.items()})
            refs = {k: [np.asarray(r) for r in v] for k, v in refs.items()}
            L_ref = np.asarray(L_ref)
        ta = {k: torch.as_tensor(v) for k, v in arrays.items()}
        for name, call in calls.items():
            got = call(tfluid if "fluid" in name else thyper, ta)
            for g, r, what in zip(got, refs[name], ("tau", "tau_zz", "W")):
                assert g.dtype == ta["F"].dtype
                _close(g, r, TOL[dtype], f"{name} {what} {dim}D {dtype}")
        _close(tfluid.spatial_velocity_gradient(ta["dFdt"], ta["F"]), L_ref, TOL[dtype], "L")


def test_hencky_small_strain_limit():
    """tests/test_constitutive.py:53: for infinitesimal strains Hencky ≈
    linear elasticity (float32, rtol 5e-2, atol 2.0)."""
    rng = np.random.default_rng(2)
    F = torch.as_tensor((np.eye(3) + 1e-4 * rng.standard_normal((16, 3, 3))).astype(np.float32))
    E, nu = torch.tensor(1e7), torch.tensor(0.3)
    tau_h, _, _ = thyper.hencky(F, E, nu)
    tau_l, _, _ = thyper.linear_elastic(F, E, nu)
    np.testing.assert_allclose(tau_h.numpy(), tau_l.numpy(), rtol=5e-2, atol=2.0)


def test_mooney_rivlin_stress_is_energy_consistent():
    """tests/test_constitutive.py:242, by torch autograd: τ = (∂W/∂F)·Fᵀ,
    zero stress and energy at rest, plane strain equal to 3D with F_zz = 1."""
    f64 = torch.float64
    rng = np.random.default_rng(5)
    args = tuple(torch.tensor(v, dtype=f64) for v in (1e6, 0.3, 4e5, 1e5))
    F = torch.tensor(np.eye(3) + 0.1 * rng.standard_normal((4, 3, 3)), requires_grad=True)
    tau, tau_zz, W = thyper.mooney_rivlin(F, *args)
    (dWdF,) = torch.autograd.grad(W.sum(), F)
    tau_ad = torch.einsum("pij,pkj->pik", dWdF, F.detach())
    np.testing.assert_allclose(tau.detach().numpy(), tau_ad.numpy(), rtol=2e-5, atol=1.0)
    tau0, tzz0, W0 = thyper.mooney_rivlin(torch.eye(3, dtype=f64)[None], *args)
    np.testing.assert_allclose(tau0.numpy(), 0.0, atol=1e-9)
    np.testing.assert_allclose(W0.numpy(), 0.0, atol=1e-12)
    assert abs(float(tzz0[0])) < 1e-9
    F2 = F.detach()[:, :2, :2].clone()
    F2[:, 0, 1] = 0.0
    F3 = torch.zeros((4, 3, 3), dtype=f64)
    F3[:, :2, :2] = F2
    F3[:, 2, 2] = 1.0
    t2, tzz2, W2 = thyper.mooney_rivlin(F2, *args)
    t3, _, W3 = thyper.mooney_rivlin(F3, *args)
    np.testing.assert_allclose(t2.numpy(), t3[:, :2, :2].numpy(), rtol=1e-5, atol=1.0)
    np.testing.assert_allclose(tzz2.numpy(), t3[:, 2, 2].numpy(), rtol=1e-5, atol=1.0)
    np.testing.assert_allclose(W2.numpy(), W3.numpy(), rtol=1e-5, atol=1.0)


def test_bingham_reduces_to_newtonian_and_mld_to_lade_duncan():
    """tests/test_constitutive.py:286: Bingham at τ_y = 0 is the Newtonian
    fluid in 3D, and in simple shear at m·γ̇ ≫ 1 τ_xy → μ0·γ̇ + τ_y;
    :316: Modified-Lade-Duncan at m = 0 is Lade-Duncan."""
    f64 = torch.float64

    def t(v):
        return torch.tensor(v, dtype=f64)

    rng = np.random.default_rng(6)
    F = t(np.eye(3) + 0.05 * rng.standard_normal((3, 3, 3)))
    dFdt = t(0.5 * rng.standard_normal((3, 3, 3)))
    common = dict(p0=t(10.0), n=t(7.0), K=t(2e5))
    tb, tbz, _ = tfluid.bingham_fluid(F, dFdt, mu0=t(0.3), tau_y=t(0.0), m_pap=t(100.0), **common)
    tn_, tnz, _ = tfluid.newtonian_fluid(F, dFdt, mu=t(0.3), **common)
    np.testing.assert_allclose(tb.numpy(), tn_.numpy(), rtol=1e-12)
    np.testing.assert_allclose(tbz.numpy(), tnz.numpy(), rtol=1e-12)
    dF1 = torch.zeros((1, 3, 3), dtype=f64)
    dF1[0, 0, 1] = 2.0
    tb, _, _ = tfluid.bingham_fluid(torch.eye(3, dtype=f64)[None], dF1, mu0=t(0.3), tau_y=t(5.0),
                                    m_pap=t(50.0), p0=t(0.0), n=t(7.0), K=t(0.0))
    assert float(tb[0, 0, 1]) == pytest.approx(0.3 * 2.0 + 5.0, rel=1e-6)

    bemi = t(np.diag(np.expm1(2.0 * np.array([-0.004, -0.0015, -0.001])))[None])
    kw = dict(E=t(1e8), nu=t(0.3), phi=t(30.0), a1=t(20000.0), a2=t(0.0), a3=t(2000.0),
              alpha=t(1.0), m=t(0.0))
    args = (bemi, t([0.0]), torch.eye(3, dtype=f64)[None], t([0.0]), t([0.0]))
    out_mld = tborja.borja_frictional(*args, yield_kind="modified-lade-duncan", pa=t(-100.0), **kw)
    out_ld = tborja.borja_frictional(*args, yield_kind="lade-duncan", **kw)
    assert float(out_mld.eps[0]) > 0  # plastic
    np.testing.assert_allclose(out_mld.tau.numpy(), out_ld.tau.numpy(), rtol=1e-5, atol=10.0)
    np.testing.assert_allclose(float(out_mld.kappa[0]), float(out_ld.kappa[0]), rtol=1e-5,
                               atol=1e-4)


ROWS = [
    dict(kind="Solid-Rigid"),
    dict(kind="Linear-Elastic", E=2e6, nu=0.25),
    dict(kind="Saint-Venant-Kirchhoff", E=3e6, nu=0.3),
    dict(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3),
    dict(kind="Hencky", E=5e6, nu=0.35),
    dict(kind="Newtonian-Fluid-Compressible", viscosity=0.5, compressibility=2e6,
         n_macdonald=7.0, reference_pressure=100.0),
    dict(kind="Von-Mises", E=1e7, nu=0.3, kappa0=2e4, hardening_modulus=1e5, theta_voce=0.6,
         K0_voce=1e3, Kinf_voce=2e4, delta_voce=10.0),
    dict(kind="Drucker-Prager", E=1e7, nu=0.3, kappa0=1e3, friction_angle=30.0,
         dilatancy_angle=10.0, exponent_ortiz=2.0, plastic_strain_0=0.01, J2_degradated=6e3),
    dict(kind="Matsuoka-Nakai", E=1e6, nu=0.3, a1_borja=10.0, a3_borja=0.8, alpha_borja=0.162),
    dict(kind="Lade-Duncan", E=1e6, nu=0.3, a1_borja=10.0, a3_borja=0.8, alpha_borja=0.162),
    dict(kind="Modified-Lade-Duncan", E=1e6, nu=0.3, a1_borja=10.0, a3_borja=0.8,
         alpha_borja=0.162, m_frictional=0.2, atmospheric_pressure=-1e5),
    dict(kind="Bingham-Fluid", kappa0=5.0, viscosity=0.3, fluidity_param=50.0,
         compressibility=2e5, n_macdonald=7.0),
    dict(kind="Mooney-Rivlin", E=1e6, nu=0.3, mu1_mr=2e5, mu2_mr=1.8e5),
]


# the Borja function's arguments and the table's columns that carry them
BORJA_PARAMS = dict(pa="atmospheric_pressure", E="E", nu="nu", m="m_frictional",
                    phi="phi_frictional", a1="a1_borja", a2="a2_borja", a3="a3_borja",
                    alpha="alpha_borja")


@pytest.mark.parametrize("dim", [2, 3])
def test_dispatch_of_every_kind_at_any_particle_count(dim):
    """Every kind in one table at a particle count that is not 3, in
    float64: each kind's rows of the blended result equal the port's model
    function on those rows (held against the JAX functions above and in
    test_torch_plasticity.py), and in 2D the Modified-Lade-Duncan rows equal
    the JAX Borja function called with the row's scalar parameters (the JAX
    dispatch cannot run that kind here: its ddG_ddT broadcasts the
    per-particle m on the wrong axis).  The table and every state field
    cross over through convert.py; an unknown code raises ValueError."""
    from nlpartsol_tpu_torch.models import druckerprager as tdp, vonmises as tvm

    n = 130
    rng = np.random.default_rng(40 + dim)
    mat_id = (np.arange(n) % len(ROWS)).astype(np.int32)
    F = np.eye(dim) + 2e-3 * rng.standard_normal((n, dim, dim))
    DF = np.eye(dim) + 1e-3 * rng.standard_normal((n, dim, dim))
    e = 1e-3 * rng.standard_normal((n, dim, dim))
    # the frictional rows confined, the others near zero pressure
    frictional = (mat_id >= 8) & (mat_id <= 10)
    vol = np.where(frictional, -2e-3, rng.uniform(-3e-4, 3e-4, n))
    e[frictional] *= 2.0
    bemi = np.expm1(2.0 * (0.5 * (e + np.swapaxes(e, -1, -2)) + vol[:, None, None] * np.eye(dim)))
    lam0 = rng.uniform(0.5, 1.5, n)
    eps = np.where(mat_id >= 8, lam0, rng.uniform(0.0, 0.01, n))
    # hardening variables on their laws: Ortiz (Drucker-Prager), κ̂_φ (Borja)
    state = dict(bemi=bemi, bemi_zz=np.expm1(2.0 * vol) * (dim == 2), eps=eps,
                 kappa=np.where(mat_id == 7, 1e3 * np.sqrt(1.0 + eps / 0.01),
                                10.0 * lam0 * np.exp(-0.8 * lam0)),
                 back_stress=1e2 * rng.standard_normal((n, 3)))
    dFdt = 0.3 * rng.standard_normal((n, dim, dim))
    table = {k: (v if k == "kind" else v.astype(np.float64)) for k, v in fields_to_numpy(
        jM.material_table([jM.material(**r) for r in ROWS])).items()}
    mt = convert.materials_from_numpy(table, device="cpu")
    assert vars(mt).keys() == table.keys() and mt.E.dtype == torch.float64
    t = {k: torch.as_tensor(v) for k, v in dict(state, F_n1=F, DF=DF, dFdt_n1=dFdt).items()}
    mid = torch.as_tensor(mat_id)
    got = tcon.stress_integration(mat_id=mid, mats=mt, kinds=mt.kinds_present(), **t)
    for key in got._fields:
        assert bool(torch.isfinite(getattr(got, key).double()).all()), key

    def g(name):
        return getattr(mt, name)[mid.long()]

    st = (t["bemi"], t["bemi_zz"], t["DF"], t["eps"])
    own = {
        1: thyper.linear_elastic(t["F_n1"], g("E"), g("nu")),
        2: thyper.saint_venant_kirchhoff(t["F_n1"], g("E"), g("nu")),
        3: thyper.neo_hookean(t["F_n1"], g("E"), g("nu")),
        4: thyper.hencky(t["F_n1"], g("E"), g("nu")),
        5: tfluid.newtonian_fluid(t["F_n1"], t["dFdt_n1"], p0=g("reference_pressure"),
                                  mu=g("viscosity"), n=g("n_macdonald"), K=g("compressibility")),
        6: tvm.von_mises(*st, t["back_stress"], E=g("E"), nu=g("nu"), sigma_y=g("kappa0"),
                         H=g("hardening_modulus"), theta=g("theta_voce"), K0=g("K0_voce"),
                         Kinf=g("Kinf_voce"), delta=g("delta_voce")),
        7: tdp.drucker_prager(*st, t["kappa"], E=g("E"), nu=g("nu"), kappa0=g("kappa0"),
                              friction_angle=g("friction_angle"),
                              dilatancy_angle=g("dilatancy_angle"),
                              exponent_ortiz=g("exponent_ortiz"),
                              plastic_strain_0=g("plastic_strain_0"),
                              J2_degradated=g("J2_degradated")),
        11: tfluid.bingham_fluid(t["F_n1"], t["dFdt_n1"], p0=g("reference_pressure"),
                                 mu0=g("viscosity"), tau_y=g("kappa0"), m_pap=g("fluidity_param"),
                                 n=g("n_macdonald"), K=g("compressibility")),
        12: thyper.mooney_rivlin(t["F_n1"], g("E"), g("nu"), g("mu1_mr"), g("mu2_mr")),
    }
    for code, kind in ((8, "matsuoka-nakai"), (9, "lade-duncan"), (10, "modified-lade-duncan")):
        own[code] = tborja.borja_frictional(
            *st, t["kappa"], yield_kind=kind, pa=g("atmospheric_pressure"), E=g("E"), nu=g("nu"),
            m=g("m_frictional"), phi=g("phi_frictional"), a1=g("a1_borja"), a2=g("a2_borja"),
            a3=g("a3_borja"), alpha=g("alpha_borja"))
    for code, out in own.items():
        sel = mid == code
        names = out._fields if hasattr(out, "_fields") else ("tau", "tau_zz", "W")
        for name, val in zip(names, out):
            assert torch.equal(getattr(got, name)[sel], val[sel]), (code, name)
    assert float(got.tau[mid == 0].abs().max()) == 0.0  # rigid
    plastic = got.eps.numpy() > state["eps"]
    for code in (6, 7, 8, 9, 10):
        assert plastic[mat_id == code].any() or code in (8, 9) and dim == 2, code
    assert plastic[(mat_id >= 8) & (mat_id <= 10)].mean() > 0.2  # the frictional rows yield

    with pytest.raises(ValueError, match="unknown material kind"):
        tcon.stress_integration(mat_id=mid, mats=mt, kinds=(99,), **t)
    if dim == 3:
        return  # the 3D trial spectrum is held in test_torch_spectral.py
    mld = mat_id == 10
    with jax.enable_x64(True):
        row = {k: jnp.float64(table[name][10]) for k, name in BORJA_PARAMS.items()}
        r_mld = jax.jit(lambda *a: jborja.borja_frictional(
            *a, yield_kind="modified-lade-duncan", c0=0.0, psi=0.0, **row))(
            *(jnp.asarray(v[mld]) for v in (bemi, state["bemi_zz"], DF, state["eps"],
                                            state["kappa"])))
    # compared where the Newton has settled in its 30 iterations (60 give
    # the same result), as in test_torch_plasticity.py
    longer = tborja.borja_frictional(
        *(v[torch.as_tensor(mld)] for v in (*st, t["kappa"])), yield_kind="modified-lade-duncan",
        n_iter=60, **{k: torch.tensor(float(table[name][10]), dtype=torch.float64)
                      for k, name in BORJA_PARAMS.items()})
    tau_mld = got.tau[torch.as_tensor(mld)]
    settled = ((longer.tau - tau_mld).abs().amax((1, 2)) <= 1e-9 * tau_mld.abs().max()).numpy()
    assert settled.mean() > 0.75, settled.mean()
    for name in ("tau", "tau_zz", "bemi", "bemi_zz", "eps", "kappa", "W"):
        _close(getattr(got, name)[torch.as_tensor(mld)].numpy()[settled],
               np.asarray(getattr(r_mld, name))[settled], 1e-6,
               f"Modified-Lade-Duncan {name} {dim}D")
