"""The port's halo-sharded drivers (parallel/domain.py) on 4 gloo ranks
against the JAX package's single-device windowed runs of
tests/test_domain.py's problems, by pid, at that file's tolerances: the
explicit step per step and k-periodic, the implicit step (1-D strips and the
2×2 decomposition), the u-pw step and eigenerosion across the seams — each
on the windowed and the fused engine (on the CPU the fused kernels' plain
versions).  The ranks run once for the whole file
(tests/_torch_domain_worker.py); the k-periodic run shares the per-step
run's problem and JAX reference (with 4 shards a slab of 6 cell planes holds
the margin-1 halo)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex, implicit as jim, upw as jupw
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import upw as tupw
from nlpartsol_tpu_torch.parallel import domain

import _torch_domain_worker as worker
from _torch_domain import H, jax_by_pid, jax_run, problem, ranks_by_pid, static_fields
from _torch_port import cheap_jax_compiles, to_torch_box, to_torch_materials  # noqa: F401

torch.set_num_threads(1)

S = 4
LP = jlme.LMEParams(gamma=3.0)
# tests/test_domain.py's tolerances: explicit :172-174, implicit :252-254
EXPLICIT_TOL = dict(x=5e-5, v=5e-4, J=5e-5)
IMPLICIT_TOL = dict(x=1e-4, v=2e-3, J=1e-4)
ENGINES = ("windowed", "fused")


def _explicit_cfg(gj, cel, **kw):
    box = jwin.full_box(gj, capacity=2)
    cfg_j = jex.ExplicitConfig(dt=0.3 * H / cel, shapefun="lme", lme_params=LP,
                               kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box, **kw)
    return cfg_j, convert.config_from_fields(static_fields(cfg_j))


def _jax_explicit(gj, pj, mj, cfg_j, n):
    p = jex.to_slot_layout(pj, gj, cfg_j.active_box)
    body = jnp.zeros((gj.dim,), jnp.float32)
    return jax_run(lambda q: jex.explicit_step(q, gj, mj, cfg_j, body)[0], p, n)


def _case(name, driver, tdec, tp, tg, tm, cfg, steps, **kw):
    return dict(name=name, kind="driver", driver=driver, dec=tdec, p=tp, grid=tg, mats=tm,
                cfg=cfg, steps=steps, body=torch.zeros(tg.dim), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded run of the file, on 4 ranks at once, and the JAX
    references (name → (ranks' outputs by pid, JAX by pid, extra))."""
    cases, refs = [], {}
    cel = np.sqrt(1e4 / 1e3)
    offs = jlme.offsets_for(2, LP)

    # explicit, per-step migration, both engines (test_domain.py:133)
    (gj, pj, mj), (tg, tp, tm) = problem(vx=0.5)
    cfg_j, cfg_t = _explicit_cfg(gj, cel)
    refs["explicit"] = jax_by_pid(_jax_explicit(gj, pj, mj, cfg_j, 40))
    tdec = domain.decompose(tg, to_torch_box(cfg_j.active_box), S, offs)
    refs["owners"] = [q.pid[q.active].numpy() for q in domain.shard_particles(tp, tdec)]
    for eng in ENGINES:
        cases.append(_case(f"explicit_{eng}", "explicit", tdec, tp, tg, tm,
                           cfg_t.replace(transfer=eng), 40))

    # k-periodic migration at margin 1 (test_domain.py:453)
    refs["kperiodic"] = refs["explicit"]
    tdec = domain.decompose(tg, to_torch_box(cfg_j.active_box), S, offs, margin=1)
    cases.append(_case("kperiodic", "explicit", tdec, tp, tg, tm,
                       cfg_t.replace(transfer="fused", rebin_every=4), 40))

    # implicit, 3 steps (test_domain.py:218)
    (gj, pj, mj), (tg, tp, tm) = problem(vx=0.2)
    box = jwin.full_box(gj, capacity=2)
    icfg_j = jim.ImplicitConfig(dt=0.5 * H / cel, shapefun="lme", lme_params=LP,
                                kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box,
                                cg_maxiter=100)
    icfg_t = convert.implicit_config_from_fields(static_fields(icfg_j))
    body = jnp.zeros((2,), jnp.float32)
    iters = []

    def istep(q):
        q, dg = jim.implicit_step(q, gj, mj, icfg_j, body)
        return q, dg["newton_iters"]

    q = jex.to_slot_layout(pj, gj, box)
    fn = jax.jit(istep)
    for _ in range(3):
        q, it = fn(q)
        iters.append(int(it))
    refs["implicit"] = jax_by_pid(q)
    refs["implicit_newton"] = iters
    tdec = domain.decompose(tg, to_torch_box(box), S, offs)
    for eng in ENGINES:
        cases.append(_case(f"implicit_{eng}", "implicit", tdec, tp, tg, tm,
                           icfg_t.replace(transfer=eng), 3))
    # the same steps on the 2×2 decomposition (test_domain.py:561): Krylov
    # dots summed over both shard axes
    tdec2 = domain.decompose2(tg, to_torch_box(box), (2, 2), offs)
    cases.append(_case("implicit_2x2", "implicit", tdec2, tp, tg, tm, icfg_t, 3, shape=(2, 2)))

    # u-pw explicit, 20 steps (test_domain.py:258)
    (gj, pj, _), (tg, tp, _) = problem(vx=0.4)
    mj = jM.material_table([
        jM.material(kind="Neo-Hookean-Wriggers", E=1e4, nu=0.3, rho0=1000.0),
        jM.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0, compressibility=2.2e6)])
    mix_rows = [dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4, permeability=1e-5)]
    mixj = jupw.make_mixture_table(mix_rows)
    pj = jupw.init_mixture_state(pj, mj, mixj)
    tm = to_torch_materials(mj)
    mixt = tupw.make_mixture_table(mix_rows, device="cpu")
    tp = tupw.init_mixture_state(tp, tm, mixt)
    c_mix = np.sqrt((2.2e6 / 0.4) / 1000.0 + cel * cel)
    ucfg_j = jupw.UpwConfig(dt=0.3 * H / c_mix, shapefun="lme", lme_params=LP,
                            kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box)
    ucfg_t = convert.upw_config_from_fields(static_fields(ucfg_j))
    q = jex.to_slot_layout(pj, gj, box)
    q = jax_run(lambda r: jupw.upw_step(r, gj, mj, mixj, ucfg_j, body)[0], q, 20)
    refs["upw"] = jax_by_pid(q, ("x", "pw", "phi_f"))
    tdec = domain.decompose(tg, to_torch_box(box), S, offs)
    for eng in ENGINES:
        cases.append(_case(f"upw_{eng}", "upw", tdec, tp, tg, tm, ucfg_t.replace(transfer=eng),
                           20, mix=mixt))

    # eigenerosion across the seams, 15 steps (test_domain.py:334)
    (gj, pj, mj), (tg, tp, tm) = problem(vx=0.3, Ceps=1.5, Gf=1e-4)
    cfg_j, cfg_t = _explicit_cfg(gj, cel, damage="eigenerosion", beps_reach=2)
    refs["fracture"] = jax_by_pid(_jax_explicit(gj, pj, mj, cfg_j, 15), ("x", "damage"))
    tdec = domain.decompose(tg, to_torch_box(cfg_j.active_box), S, offs)
    for eng in ENGINES:
        cases.append(_case(f"fracture_{eng}", "explicit", tdec, tp, tg, tm,
                           cfg_t.replace(transfer=eng), 15))

    outs = worker.launch(cases, S, str(tmp_path_factory.mktemp("ranks")))
    return outs, refs


def _assert_close(got, ref, tol):
    np.testing.assert_array_equal(got["pid"], ref["pid"])
    for name, atol in tol.items():
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=atol, err_msg=name)


def _diag(outs, case):
    return [o[case]["diag"] for o in outs]


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_explicit_matches_jax(runs, engine):
    outs, refs = runs
    case = f"explicit_{engine}"
    _assert_close(ranks_by_pid(outs, case), refs["explicit"], EXPLICIT_TOL)
    for dg in _diag(outs, case):
        assert int(dg["lost"]) == 0
        assert dg["nnz"].shape == (40,)
    # the diagnostics are global: equal on every rank
    for dg in _diag(outs, case)[1:]:
        torch.testing.assert_close(dg["kinetic_energy"], _diag(outs, case)[0]["kinetic_energy"])
    # migration fired: particles changed owner (test_domain.py:176)
    start = {int(q): r for r, part in enumerate(refs["owners"]) for q in part}
    end = {int(q): r for r, o in enumerate(outs)
           for q in o[case]["p"]["pid"][o[case]["p"]["active"]]}
    assert set(start) == set(end)
    assert any(start[q] != end[q] for q in start)


def test_sharded_explicit_kperiodic_matches_jax(runs):
    outs, refs = runs
    _assert_close(ranks_by_pid(outs, "kperiodic"), refs["kperiodic"], EXPLICIT_TOL)
    assert int(_diag(outs, "kperiodic")[0]["lost"]) == 0
    # a margin-less decomposition is refused for k > 1, and so is a period
    # that does not tile the run
    (gj, _, _), (tg, _, _) = problem()
    box = to_torch_box(jwin.full_box(gj, capacity=2))
    offs = jlme.offsets_for(2, LP)
    _, cfg_t = _explicit_cfg(gj, np.sqrt(10.0))
    cfg_t = cfg_t.replace(transfer="fused", rebin_every=4)
    with pytest.raises(ValueError, match="margin"):
        domain.sharded_explicit_run(domain.decompose(tg, box, S, offs), cfg_t, 40)
    with pytest.raises(ValueError, match="multiple"):
        domain.sharded_explicit_run(domain.decompose(tg, box, S, offs, margin=1), cfg_t, 42)


@pytest.mark.parametrize("case", ["implicit_windowed", "implicit_fused", "implicit_2x2"])
def test_sharded_implicit_matches_jax(runs, case):
    outs, refs = runs
    _assert_close(ranks_by_pid(outs, case), refs["implicit"], IMPLICIT_TOL)
    diags = _diag(outs, case)
    for dg in diags:
        assert int(dg["lost"]) == 0 and bool(dg["converged"].all())
        # every rank took the same branches: equal Newton and CG counts,
        # and the JAX step's Newton counts
        assert dg["newton_iters"].tolist() == refs["implicit_newton"]
        assert dg["cg_iters"].tolist() == diags[0]["cg_iters"].tolist()


def test_sharded_upw_matches_jax(runs):
    outs, refs = runs
    ref = refs["upw"]
    pw_scale = max(1.0, float(np.abs(ref["pw"]).max()))
    for eng in ENGINES:
        case = f"upw_{eng}"
        got = ranks_by_pid(outs, case, ("x", "pw", "phi_f"))
        # test_domain.py:330-332
        _assert_close(got, ref, dict(x=5e-5, pw=2e-4 * pw_scale, phi_f=1e-5))
        assert int(_diag(outs, case)[0]["lost"]) == 0


def test_sharded_fracture_matches_jax(runs):
    outs, refs = runs
    ref = refs["fracture"]
    assert ref["damage"].max() > 0.0, "no erosion fired: the particle halo is untested"
    for eng in ENGINES:
        got = ranks_by_pid(outs, f"fracture_{eng}", ("x", "damage"))
        np.testing.assert_array_equal(got["pid"], ref["pid"])
        np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=5e-5)
        np.testing.assert_array_equal(got["damage"] > 0.5, ref["damage"] > 0.5)
