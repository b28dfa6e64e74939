"""Nonlocal fracture in the port against the JAX package: the Beps sums on
the slot layout (2D and 3D, against the JAX function and a brute force),
eigenerosion and eigensoftening on tests/test_fracture.py's inputs (damage
exactly equal, strain_f rtol 1e-5), the explicit step with eigenerosion on
the windowed engine and on the fused engine's plain versions, the implicit
staggered step on both engines with equal Newton counts, and the stress
scaled by (1 − damage) on the explicit step without a driver.  Steps are
compared by pid over active particles at the f32 engine tolerances
(rel_dx < 1e-3, rel_dv < 1e-2)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex, implicit as jim
from nlpartsol_tpu.models import fracture as jfr, materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.types import Grid as JGrid, make_particles as jmake

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex, implicit as tim
from nlpartsol_tpu_torch.models import fracture as tfr

from _torch_port import (by_pid, cheap_jax_compiles, explicit_configs,  # noqa: F401
                         problem, to_torch_box, to_torch_grid, to_torch_materials,
                         to_torch_particles, with_fields)

torch.set_num_threads(1)

E_, RHO = 1e6, 1e3
F32 = dict(dx=1e-3, dv=1e-2)  # bench.py:251, the JAX package's engine gate


def _rel_gaps(tp, pj, h):
    got, ref = by_pid(tp, names=("x", "v")), by_pid(pj, names=("x", "v"))
    rel_dx = np.abs(got["x"] - ref["x"]).max() / h
    rel_dv = np.abs(got["v"] - ref["v"]).max() / max(np.abs(ref["v"]).max(), 1e-12)
    return rel_dx, rel_dv


def _fracture_tables(**frac):
    """Two materials (Neo-Hookean E 1e6 and 2e6) with per-material Beps radii
    (Ceps 1.5 and 1.2: the reach comes from the larger)."""
    rows = [jM.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.3, rho0=RHO, Ceps=1.5, **frac),
            jM.material(kind="Neo-Hookean-Wriggers", E=2 * E_, nu=0.3, rho0=RHO, Ceps=1.2,
                        **frac)]
    mj = jM.material_table(rows)
    return mj, to_torch_materials(mj)


def _stretched_band(pj, tp, half_width=0.08):
    """tests/test_fracture.py's pre-stretched central band (F_xx = 1.3), and
    material 1 on the upper half."""
    x = np.asarray(pj.x)
    band = np.abs(x[:, 0] - 0.5) < half_width
    F = np.tile(np.eye(2, dtype=np.float32), (len(x), 1, 1))
    F[:, 0, 0] = np.where(band, 1.3, 1.0)
    F[~np.asarray(pj.active)] = 0.0  # idle slots hold F = 0, as after a re-bin
    mat = (x[:, 1] > 0.5).astype(np.int32)
    return with_fields(pj, tp, F=F, J=F[:, 0, 0] * F[:, 1, 1], mat_id=mat)


def test_beps_sums_match_jax_and_bruteforce():
    """2D (reach 2, radius 1.5 cells) and 3D (reach 1, radius 0.9 cells):
    per-particle radii, the port's sums against the JAX function's and a
    float64 brute force, rtol 1e-5."""
    cases = [problem(seed=3, n_side=12, n_particles=300)[0]]
    from _torch_port import problem3
    cases.append(problem3(seed=4, n_side=8, n_particles=90)[0])
    for (gj, bj, pj, _), reach, cells in zip(cases, (2, 1), (1.5, 0.9)):
        rng = np.random.default_rng(5)
        n, h = pj.count, gj.spacing
        act = np.asarray(pj.active)
        vals = np.where(act, rng.uniform(1.0, 2.0, n), 0.0).astype(np.float32)
        radius = (h * cells * rng.uniform(0.7, 1.0, n)).astype(np.float32)
        ref = jfr._neighbor_pair_sums(gj, bj, pj.x, pj.active, {"v": jnp.asarray(vals)},
                                      radius=jnp.asarray(radius), reach=reach)["v"]
        got = tfr._neighbor_pair_sums(to_torch_grid(gj), to_torch_box(bj),
                                      torch.as_tensor(np.array(pj.x)), torch.as_tensor(act),
                                      {"v": torch.as_tensor(vals)},
                                      radius=torch.as_tensor(radius), reach=reach)["v"]
        np.testing.assert_allclose(got.numpy()[act], np.asarray(ref)[act], rtol=1e-5)
        xs = np.asarray(pj.x).astype(np.float64)
        brute = np.array([vals[(np.linalg.norm(xs - xs[i], axis=1) <= radius[i]) & act].sum()
                          for i in np.where(act)[0]])
        np.testing.assert_allclose(got.numpy()[act], brute, rtol=1e-5)
        assert brute.max() > 2 * vals.max(), "no neighbour reached"


def test_eigenerosion_and_eigensoftening_match_jax():
    """tests/test_fracture.py's inputs through both packages' drivers:
    damage exactly equal, strain_f rtol 1e-5 (both phases of softening)."""
    grid = JGrid(dims=(9, 9), spacing=1.0, origin=(0.0, 0.0))
    box = jwin.full_box(grid, capacity=4)
    rng = np.random.default_rng(0)
    x = rng.uniform(1.1, 6.9, (40, 2)).astype(np.float32)
    pj = jex.to_slot_layout(jmake(x, mass=np.ones(40), vol0=np.ones(40)), grid, box)
    tg, tb, tp = to_torch_grid(grid), to_torch_box(box), to_torch_particles(pj)
    n, xs = pj.count, np.asarray(pj.x)

    def both(fn_j, fn_t, **arrays):
        out_j = fn_j(grid, box, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                 for k, v in arrays.items()})
        out_t = fn_t(tg, tb, **{k: torch.as_tensor(np.array(v)) if isinstance(v, np.ndarray) else v
                              for k, v in arrays.items()})
        act = np.asarray(pj.active)
        np.testing.assert_array_equal(out_t.damage.numpy()[act], np.asarray(out_j.damage)[act])
        np.testing.assert_allclose(out_t.strain_f.numpy()[act], np.asarray(out_j.strain_f)[act],
                                   rtol=1e-5)
        return out_t

    W = np.where(np.linalg.norm(xs - 4.0, axis=1) < 1.5, 100.0, 0.0).astype(np.float32)
    eye = np.eye(2, dtype=np.float32)
    ero = both(jfr.eigenerosion, tfr.eigenerosion, x=xs, active=np.asarray(pj.active),
               damage_n=np.zeros(n, np.float32), W=W, J_n1=np.ones(n, np.float32),
               vol0=np.asarray(pj.vol0), stress=np.tile(10.0 * eye, (n, 1, 1)),
               stress_zz=np.zeros(n, np.float32), Ceps=np.ones(n, np.float32),
               Gf=np.full(n, 50.0, np.float32), reach=1)
    assert ero.damage.max() == 1.0 and ero.damage.min() == 0.0
    kw = dict(x=xs, active=np.asarray(pj.active), mass=np.asarray(pj.mass),
              stress=np.tile(100.0 * eye, (n, 1, 1)), stress_zz=np.zeros(n, np.float32),
              ft=np.full(n, 50.0, np.float32), heps=np.ones(n, np.float32),
              wcrit=np.ones(n, np.float32), Ceps=np.ones(n, np.float32), reach=1)
    F1 = np.tile(np.diag([1.2, 1.0]).astype(np.float32), (n, 1, 1))
    F1[~np.asarray(pj.active)] = 0.0  # idle slots: F = 0 must not poison a sum
    s1 = both(jfr.eigensoftening, tfr.eigensoftening, damage_n=np.zeros(n, np.float32),
              strain_f_n=np.zeros(n, np.float32), F_n1=F1, **kw)
    assert s1.strain_f.max() > 0 and s1.damage.max() == 0
    F2 = np.tile(np.diag([1.4, 1.0]).astype(np.float32), (n, 1, 1))
    s2 = both(jfr.eigensoftening, tfr.eigensoftening, damage_n=s1.damage.numpy(),
              strain_f_n=s1.strain_f.numpy(), F_n1=F2, **kw)
    assert s2.damage.max() > 0


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_explicit_eigenerosion_matches_jax(transfer):
    """Three steps of a pre-stretched band with eigenerosion (two materials,
    reach 2): the eroded set equal to the JAX step's, the band eroded and
    the far field intact, x and v within the f32 gate."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=7, n_side=14, n_particles=200,
                                                 speed=0.05)
    mj, mt = _fracture_tables(Gf=600.0)
    pj, tp = _stretched_band(pj, tp)
    cfg_j, cfg_t = explicit_configs(gj, bj, lj, 0.1, transfer=transfer,
                                    damage="eigenerosion", beps_reach=2)
    assert cfg_t.damage == "eigenerosion" and cfg_t.beps_reach == 2
    step_j = jax.jit(lambda q: jex.explicit_step(q, gj, mj, cfg_j, jnp.zeros(2)))
    for _ in range(3):
        pj, _ = step_j(pj)
        tp, _ = tex.explicit_step(tp, tg, mt, cfg_t, torch.zeros(2))
    got, ref = by_pid(tp, names=("x", "damage")), by_pid(pj, names=("x", "damage"))
    np.testing.assert_array_equal(got["damage"], ref["damage"])
    band = np.abs(ref["x"][:, 0] - 0.5) < 0.06
    far = np.abs(ref["x"][:, 0] - 0.5) > 0.08 + 2 * 1.5 * gj.spacing
    assert far.sum() > 10 and ref["damage"][far].max() == 0.0
    assert ref["damage"][band].mean() > 0.5, ref["damage"][band].mean()
    rel_dx, rel_dv = _rel_gaps(tp, pj, gj.spacing)
    assert rel_dx < F32["dx"] and rel_dv < F32["dv"], (rel_dx, rel_dv)
    # the Beps sweep needs each particle in its slot cell: the step refuses
    # fracture without a re-bin every step
    with pytest.raises(ValueError, match="rebin_every = 1"):
        tex.explicit_step(tp, tg, mt, cfg_t.replace(rebin_every=4), torch.zeros(2))


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_implicit_staggered_matches_jax(transfer):
    """tests/test_fracture.py:166's problem (a band pre-stretched to 1.3,
    Gf 1): one implicit step with eigenerosion, equal Newton counts, the
    eroded set equal to the JAX step's, band eroded and far field intact."""
    h = 0.1
    gj = JGrid(dims=(17, 9), spacing=h, origin=(0.0, 0.0))
    bj = jwin.full_box(gj, capacity=4)
    xs = np.stack(np.meshgrid(np.linspace(0.25, 1.35, 12), np.linspace(0.25, 0.55, 4)),
                  -1).reshape(-1, 2).astype(np.float32)
    vol = (h / 2) ** 2
    band = (np.abs(xs[:, 0] - 0.8) < 0.15).astype(np.float32)
    F0 = np.tile(np.eye(2, dtype=np.float32), (len(xs), 1, 1))
    F0[:, 0, 0] = 1.0 + 0.3 * band
    pj = jmake(xs, mass=np.full(len(xs), RHO * vol), vol0=np.full(len(xs), vol))
    pj = pj.replace(F=jnp.asarray(F0), J=jnp.asarray(F0[:, 0, 0] * F0[:, 1, 1]))
    pj = jex.to_slot_layout(pj, gj, bj)
    tg, tp = to_torch_grid(gj), to_torch_particles(pj)
    mj = jM.material_table([jM.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.2, rho0=RHO,
                                        Ceps=1.5, Gf=1.0)])
    mt = to_torch_materials(mj)
    from nlpartsol_tpu.shapefun import lme as jlme

    cfg_j = jim.ImplicitConfig(dt=1e-4, shapefun="lme", lme_params=jlme.LMEParams(gamma=3.0),
                               kinds=(jM.NEO_HOOKEAN,), transfer=transfer, active_box=bj,
                               damage="eigenerosion", beps_reach=2)
    cfg_t = convert.implicit_config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    pj1, dj = jax.jit(lambda q: jim.implicit_step(q, gj, mj, cfg_j, jnp.zeros(2)))(pj)
    tp1, dt_ = tim.implicit_step(tp, tg, mt, cfg_t, torch.zeros(2))
    assert bool(dt_["converged"]) and bool(dj["converged"])
    assert int(dt_["newton_iters"]) == int(dj["newton_iters"])
    got, ref = by_pid(tp1, names=("x", "damage")), by_pid(pj1, names=("x", "damage"))
    np.testing.assert_array_equal(got["damage"], ref["damage"])
    in_band = np.abs(ref["x"][:, 0] - 0.8) < 0.1
    far = np.abs(ref["x"][:, 0] - 0.8) > 0.5
    assert ref["damage"][in_band].min() == 1.0 and ref["damage"][far].max() == 0.0
    rel_dx, rel_dv = _rel_gaps(tp1, pj1, h)
    assert rel_dx < F32["dx"] and rel_dv < F32["dv"], (rel_dx, rel_dv)


@pytest.mark.parametrize("transfer", ["windowed", "pallas"])
def test_damage_scales_stress_without_driver(transfer):
    """Damage 0.5 on every particle and no driver: the explicit step scales
    the stress entering the internal forces by (1 − damage), as the JAX step
    does on both engines (without the scale the port is 1.7e-2 of max |v|
    away after 3 steps)."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=7, n_side=14, n_particles=200,
                                                 speed=0.05)
    from _torch_port import neo_hookean_tables

    mj, mt = neo_hookean_tables()
    pj, tp = with_fields(pj, tp, damage=np.full(pj.count, 0.5, np.float32))
    cfg_j, cfg_t = explicit_configs(gj, bj, lj, 0.1, transfer=transfer)
    step_j = jax.jit(lambda q: jex.explicit_step(q, gj, mj, cfg_j, jnp.zeros(2)))
    for _ in range(3):
        pj, _ = step_j(pj)
        tp, _ = tex.explicit_step(tp, tg, mt, cfg_t, torch.zeros(2))
    rel_dx, rel_dv = _rel_gaps(tp, pj, gj.spacing)
    assert rel_dx < F32["dx"] and rel_dv < F32["dv"], (rel_dx, rel_dv)
