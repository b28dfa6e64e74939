"""The port's return mappings (von Mises, Drucker-Prager, and the Borja
frictional family: Matsuoka-Nakai, Lade-Duncan, Modified-Lade-Duncan)
against the JAX package's on the same numpy inputs, and against the
reference binary's constitutive harnesses (tests/golden/*.csv) in float64
through the port alone.

States cover the elastic, plastic and (Drucker-Prager, frictional) apex
branches.  float64 against float64: rtol 1e-9 with an absolute floor of 1e-9
times the largest magnitude (von Mises, Drucker-Prager), 1e-6 for the
frictional family, whose 5x5 Newton solves (LAPACK in the JAX function, the
port's own elimination) differ in their last digits, over the rows whose
Newton has settled within its 30 iterations (more than 95 %; the rest are
tensile states whose iterates go on moving in both packages).  In float32
the frictional family's return mapping scatters in both packages (its
residual norm weighs a strain row against a stress-sized yield row:
tests/torch_models_probe.py borja-f32), so float32 is held on the card,
against the CPU's float32, by ``chip_smoke.py``'s ``models_fn`` phase.  The
JAX side is jitted in 2D and eager in 3D
(its unrolled Jacobi sweeps compile for longer than they run).  Goldens: the tolerances of
tests/test_reference_golden.py."""

import csv
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.models import borja as jborja, druckerprager as jdp, vonmises as jvm

from nlpartsol_tpu_torch.models import borja as tborja, druckerprager as tdp, vonmises as tvm

from _torch_port import cheap_jax_compiles  # noqa: F401

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _states(dim, n, seed, vol_lo=-0.01, vol_hi=0.005, strain=(1e-7, 1e-2)):
    """Random trial states: b_e − I with a deviatoric part over five decades
    and a volumetric part in [vol_lo, vol_hi] (tension gives apex states),
    an increment ΔF; the first rows at rest."""
    rng = np.random.default_rng(seed)
    eye = np.eye(dim)
    s = 10.0 ** rng.uniform(*np.log10(strain), n)[:, None, None]
    e = s * rng.standard_normal((n, dim, dim))
    e = 0.5 * (e + np.swapaxes(e, -1, -2))
    vol = rng.uniform(vol_lo, vol_hi, n)
    bemi = np.expm1(2.0 * (e + vol[:, None, None] * eye))
    bemi_zz = np.expm1(2.0 * (vol + (dim == 2) * e[:, 0, 0]))
    DF = eye + 0.1 * s * rng.standard_normal((n, dim, dim))
    bemi[:4], bemi_zz[:4], DF[:4] = 0.0, 0.0, eye
    return bemi, bemi_zz, DF


def _close(got, ref, tol, err_msg):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30), err_msg=err_msg)


def _run_both(jfn, tfn, args, params, dtype, tparams=None):
    # eager in 3D: the unrolled Jacobi sweeps compile for longer than they run
    run = jax.jit(jfn) if args[0].shape[-1] == 2 else jfn
    with jax.enable_x64(dtype == "float64"):
        ref = run(*(jnp.asarray(a, dtype) for a in args),
                  **{k: jnp.asarray(v, dtype) for k, v in params.items()})
        ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    tparams = params if tparams is None else tparams
    got = tfn(*(torch.as_tensor(np.asarray(a, dtype)) for a in args),
              **{k: torch.as_tensor(np.asarray(v, dtype)) for k, v in tparams.items()})
    return got._asdict(), ref


def _jax_dp(*args, **kw):
    # the JAX function's cohesion is carried by kappa0 and unused
    return jdp.drucker_prager(*args, cohesion=0.0, **kw)


@pytest.mark.parametrize("dim", [2, 3])
def test_von_mises_and_drucker_prager_match_jax(dim):
    n = 600
    trial = _states(dim, n, seed=dim)
    trial_dp = _states(dim, n, seed=dim, vol_lo=-2e-3, vol_hi=2e-3)
    rng = np.random.default_rng(10 + dim)
    vm_state = (rng.uniform(0.0, 0.01, n), 1e3 * rng.standard_normal((n, 3)))
    vm_par = dict(E=np.full(n, 1e7), nu=np.full(n, 0.3), sigma_y=rng.uniform(1e3, 1e5, n),
                  H=np.full(n, 1e5), theta=np.full(n, 0.5), K0=np.full(n, 1e3),
                  Kinf=np.full(n, 2e4), delta=np.full(n, 10.0))
    # the hardening variable on its law κ(ε) = κ0·(1 + ε/ε0)^{1/m}
    dp_eps, kappa0 = rng.uniform(0.0, 0.01, n), rng.uniform(1e2, 1e4, n)
    dp_state = (dp_eps, kappa0 * np.sqrt(1.0 + dp_eps / 0.01))
    dp_par = dict(E=np.full(n, 1e7), nu=np.full(n, 0.3), kappa0=kappa0,
                  friction_angle=np.full(n, 30.0), dilatancy_angle=np.full(n, 10.0),
                  exponent_ortiz=np.full(n, 2.0), plastic_strain_0=np.full(n, 0.01),
                  J2_degradated=np.full(n, 2e3))
    for dtype, tol in (("float64", 1e-9),):
        for jfn, tfn, state, par in ((jvm.von_mises, tvm.von_mises, trial + vm_state, vm_par),
                                     (_jax_dp, tdp.drucker_prager, trial_dp + dp_state, dp_par)):
            got, ref = _run_both(jfn, tfn, state, par, dtype)
            # both branches (a tensile row returned to the apex keeps its eps)
            pl = ref["eps"] > state[3]
            assert 0.05 < pl.mean() < 0.95, (tfn.__name__, pl.mean())
            for key, r in ref.items():
                if key == "C_ep":
                    continue  # the tangent feeds no port step yet
                if key == "failed":
                    assert np.array_equal(got[key].numpy(), r) and r.any() and not r.all()
                    continue
                _close(got[key], r, tol, f"{tfn.__name__} {key} {dim}D {dtype}")
    # Drucker-Prager's apex branch was taken: a row returned to the apex
    # keeps no deviator
    got, _ = _run_both(_jax_dp, tdp.drucker_prager, trial_dp + dp_state, dp_par, "float64")
    tau = got["tau"].numpy()
    iso = np.abs(tau - np.trace(tau, axis1=1, axis2=2)[:, None, None] / dim * np.eye(dim))
    assert (iso.max(axis=(1, 2)) < 1e-9 * np.abs(tau).max()).sum() > 8


@pytest.mark.parametrize("kind", ["matsuoka-nakai", "lade-duncan", "modified-lade-duncan"])
def test_frictional_models_match_jax(kind):
    """Confined (compressive) and tensile states.  The JAX
    function is called per material with scalar parameters (as
    tests/test_reference_golden.py calls it); the port gets per-particle
    parameter arrays, as the dispatch passes them, at a particle count that
    is not 3 — where the JAX function's Modified-Lade-Duncan fails."""
    n = 500
    scalars = dict(E=1e6, nu=0.3, m=0.2, phi=0.0, a1=10.0, a2=0.0, a3=0.8, alpha=0.162)
    per_particle = {k: np.full(n, v) for k, v in scalars.items()}
    # in 2D: the 3D return mapping differs from the 2D one in the trial
    # spectrum alone, held in 3D by test_torch_spectral.py (and on the card,
    # against the CPU, by chip_smoke.py's models_fn and models3d phases)
    for dim in (2,):
        bemi, bemi_zz, DF = _states(dim, n, seed=30 + dim, vol_lo=-2e-3, vol_hi=5e-4,
                                    strain=(1e-6, 2e-3))
        lam0 = np.random.default_rng(dim).uniform(0.5, 1.5, n)
        args = (bemi, bemi_zz, DF, lam0, 10.0 * lam0 * np.exp(-0.8 * lam0))
        def jfn(*a, **k):
            return jborja.borja_frictional(*a, yield_kind=kind, pa=-1e5, c0=0.0, psi=0.0, **k)

        def tfn(*a, **k):
            return tborja.borja_frictional(*a, yield_kind=kind, pa=-1e5, **k)

        got, ref = _run_both(jfn, tfn, args, scalars, "float64", tparams=per_particle)
        pl = ref["eps"] > lam0
        assert 0.1 < pl.mean() < 0.9, pl.mean()
        # rows whose Newton has not converged in the 30 iterations (tensile
        # states) go on moving with more: compared only where 60 iterations
        # give the same result
        longer = tfn(*(torch.as_tensor(a) for a in args), n_iter=60,
                     **{k: torch.as_tensor(v) for k, v in per_particle.items()})
        settled = (longer.tau - got["tau"]).abs().amax((1, 2)).numpy() <= 1e-9 * np.abs(
            ref["tau"]).max()
        assert settled.mean() > 0.95, settled.mean()
        for key, r in ref.items():
            if key != "C_ep":
                _close(got[key].numpy()[settled], r[settled], 1e-6,
                       f"{kind} {key} {dim}D float64")
        if kind == "modified-lade-duncan" and dim == 2:
            # the JAX function with per-particle parameters at n ≠ 3: m of
            # shape (n,) against an (n, 3) array in ddG_ddT
            with pytest.raises((ValueError, TypeError)):
                jax.jit(jfn)(*(jnp.asarray(a, jnp.float32) for a in args),
                             **{k: jnp.asarray(v, jnp.float32) for k, v in per_particle.items()})


def _read(name):
    with open(os.path.join(GOLD, name)) as f:
        rows = list(csv.DictReader(f))
    return {k: np.array([float(r[k]) for r in rows]) for k in rows[0]}


def _nominal(tau2, F_yy):
    """The harnesses store P = τ·F^{-T} in-plane (diag F here)."""
    P = tau2.copy()
    P[..., 0, 1] /= F_yy
    P[..., 1, 1] /= F_yy
    return P


def test_von_mises_and_drucker_prager_goldens_through_the_port():
    """tests/golden/vonmises_uniaxial.csv and druckerprager_uniaxial.csv,
    step by step as tests/test_reference_golden.py drives the JAX models,
    with ``ref_vol_compat`` (the reference's K·tr(E)/3 trial term)."""
    f64 = torch.float64

    def t(v):
        return torch.tensor(v, dtype=f64)

    g = _read("vonmises_uniaxial.csv")
    dF = t(np.diag([1.0, 0.9999]))
    bemi, bemi_zz, eps = torch.zeros(2, 2, dtype=f64), t(0.0), t(0.0)
    back = torch.zeros(3, dtype=f64)
    kw = {k: t(v) for k, v in dict(E=10.0e3, nu=0.2, sigma_y=10.0, H=0.0, theta=0.0, K0=0.0,
                                   Kinf=0.0, delta=0.0).items()}
    F_yy = 1.0
    for i in range(1, len(g["step"])):
        out = tvm.von_mises(bemi, bemi_zz, dF, eps, back, n_iter=40, tol=1e-14,
                            ref_vol_compat=True, **kw)
        bemi, bemi_zz, eps, back = out.bemi, out.bemi_zz, out.eps, out.back_stress
        F_yy *= 0.9999
        P = _nominal(out.tau.numpy()[None], F_yy)[0]
        np.testing.assert_allclose([P[0, 0], P[1, 1], float(out.tau_zz)],
                                   [g["s_xx"][i], g["s_yy"][i], g["s_zz"][i]], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(eps), g["eps"][i], rtol=1e-8, atol=1e-12)
    assert g["eps"][-1] > 0

    g = _read("druckerprager_uniaxial.csv")
    kappa0, H, m = 40.0, 0.1, 1.0
    dF = t(np.diag([1.0, 0.999]))
    bemi, bemi_zz, eps, kap = torch.zeros(2, 2, dtype=f64), t(0.0), t(0.0), t(kappa0)
    kw = {k: t(v) for k, v in dict(E=10.0e3, nu=0.2, kappa0=kappa0, friction_angle=39.0,
                                   dilatancy_angle=6.0, exponent_ortiz=m,
                                   plastic_strain_0=kappa0 / (m * H), J2_degradated=5.0,
                                   p_ref=-20.0).items()}
    F_yy = 1.0
    for i in range(1, len(g["step"])):
        out = tdp.drucker_prager(bemi, bemi_zz, dF, eps, kap, n_iter=40, tol=1e-14,
                                 ref_vol_compat=True, **kw)
        bemi, bemi_zz, eps, kap = out.bemi, out.bemi_zz, out.eps, out.kappa
        F_yy *= 0.999
        P = _nominal(out.tau.numpy()[None], F_yy)[0]
        np.testing.assert_allclose([P[0, 0], P[1, 1], float(out.tau_zz)],
                                   [g["s_xx"][i], g["s_yy"][i], g["s_zz"][i]], rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(float(eps), g["eps"][i], rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(float(kap), g["kappa"][i], rtol=1e-6, atol=1e-8)
    assert g["eps"][-1] > 0


@pytest.mark.parametrize("golden,kind,E,conf,extra", [
    ("matsuoka_triaxial.csv", "matsuoka-nakai", 10.0e3, -20.0,
     dict(m=0.0, a1=10.0, a2=0.0, a3=0.8, alpha=0.162)),
    ("modified_lade_duncan_triaxial.csv", "modified-lade-duncan", 100.0e3, -200.0,
     dict(m=0.2, a1=20000.0, a2=0.005, a3=35.0, alpha=0.5, pa=-100.0)),
])
def test_frictional_goldens_through_the_port(golden, kind, E, conf, extra):
    """The harnesses drive a principal trial stress [conf, s2 + E·Δε, conf]
    from the previous step's s2 and internal variables
    (tests/test_reference_golden.py:146-226).  The steps run at once, each
    from the reference's own previous row (every 10th of Matsuoka-Nakai's
    20,000 steps, ten times the JAX test's checkpoints; all 2,100 of
    Modified-Lade-Duncan's): each must give its next row, at the JAX test's
    tolerances."""
    g = _read(golden)
    prev = np.arange(len(g["step"]) - 1)[:: 10 if kind == "matsuoka-nakai" else 1]
    nxt = prev + 1
    nu, de = 0.2, -0.00001
    f64 = torch.float64
    CC = (1.0 / E) * np.eye(3) + (-nu / E) * (np.ones((3, 3)) - np.eye(3))
    T_tr = np.stack([np.full(len(prev), conf), g["s2"][prev] + E * de, np.full(len(prev), conf)], 1)
    T_tr[prev == 0, 1] = conf + E * de  # the first step starts from the confinement
    Eh = T_tr @ CC.T
    n = len(T_tr)
    bemi = np.zeros((n, 2, 2))
    bemi[:, 0, 0], bemi[:, 1, 1] = np.expm1(2.0 * Eh[:, 0]), np.expm1(2.0 * Eh[:, 1])
    pa = extra.pop("pa", 0.0)
    par = {k: torch.full((n,), v, dtype=f64) for k, v in dict(E=E, nu=nu, phi=0.0, **extra).items()}
    out = tborja.borja_frictional(
        torch.tensor(bemi), torch.tensor(np.expm1(2.0 * Eh[:, 2])),
        torch.eye(2, dtype=f64).expand(n, 2, 2), torch.tensor(g["eps"][prev]),
        torch.tensor(g["kappa"][prev]), yield_kind=kind, pa=pa, n_iter=60, tol=1e-12, **par)
    s = np.stack([out.tau[:, 0, 0].numpy(), out.tau[:, 1, 1].numpy(), out.tau_zz.numpy()], 1)
    np.testing.assert_allclose(s, np.stack([g["s1"][nxt], g["s2"][nxt], g["s3"][nxt]], 1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.eps.numpy(), g["eps"][nxt], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(out.kappa.numpy(), g["kappa"][nxt], rtol=1e-5, atol=1e-7)
    assert (out.eps.numpy() > g["eps"][prev]).mean() > 0.5  # the path is plastic
