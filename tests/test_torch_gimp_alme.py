"""uGIMP and aLME in the port against the JAX package: ``gimp.evaluate``
(2D and 3D) and ``alme.evaluate`` with a pulled-back anisotropic β (N rtol
1e-5, ∇N 1e-3 of its scale, as tests/test_gimp_alme.py), ``update_beta``,
and the explicit step with each basis on the scatter and the windowed
engines, by pid at the f32 engine tolerances (rel_dx < 1e-3, rel_dv <
1e-2), with aLME's β pulled back as the JAX step pulls it."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex
from nlpartsol_tpu.shapefun import alme as jalme, gimp as jgimp
from nlpartsol_tpu.types import Grid as JGrid

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.shapefun import alme as talme, gimp as tgimp

from _torch_port import (by_pid, cheap_jax_compiles, neo_hookean_tables,  # noqa: F401
                         problem, to_torch_grid, with_fields)

torch.set_num_threads(1)


def _basis_close(got, ref):
    N, dN = got["N"].numpy(), got["dN"].numpy()
    np.testing.assert_allclose(N, np.asarray(ref["N"]), rtol=1e-5, atol=1e-7)
    scale = np.abs(np.asarray(ref["dN"])).max()
    np.testing.assert_allclose(dN, np.asarray(ref["dN"]), rtol=1e-3, atol=1e-3 * scale)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    np.testing.assert_array_equal(got["node_ids"].numpy(), np.asarray(ref["node_ids"]))


@pytest.mark.parametrize("d", [2, 3])
def test_gimp_evaluate_matches_jax(d):
    """Random positions and per-particle half-widths l_p ≤ h; l_p > h is
    refused by both packages."""
    gj = JGrid(dims=(9,) * d, spacing=0.5, origin=(0.0,) * d)
    rng = np.random.default_rng(d)
    x = rng.uniform(1.0, 3.0, (40, d)).astype(np.float32)
    lp = rng.uniform(0.05, 0.5, 40).astype(np.float32)
    ref = jgimp.evaluate(gj, jnp.asarray(x), jnp.asarray(lp))
    tg = to_torch_grid(gj)
    got = tgimp.evaluate(tg, torch.as_tensor(x), torch.as_tensor(lp))
    _basis_close(got, ref)
    # the piecewise kernel is a partition of unity where l_p ≤ h/2
    assert got["lam"] is None
    np.testing.assert_allclose(got["N"].sum(-1).numpy()[lp <= 0.25], 1.0, atol=1e-5)
    vol0 = rng.uniform(0.1, 0.2, 40).astype(np.float32)
    np.testing.assert_allclose(tgimp.voxel_halfwidth(torch.as_tensor(vol0), d).numpy(),
                               np.asarray(jgimp.voxel_halfwidth(jnp.asarray(vol0), d)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="half-width"):
        jgimp.evaluate(gj, jnp.asarray(x), jnp.asarray(lp * 3))
    with pytest.raises(ValueError, match="half-width"):
        tgimp.check_halfwidth(torch.as_tensor(lp * 3), tg.spacing)


def test_alme_update_beta_and_evaluate_match_jax():
    """β pulled back by a sheared ΔF (``update_beta``, rtol 1e-6), then the
    aLME basis at that β (N, ∇N, λ)."""
    gj = JGrid(dims=(11, 11), spacing=0.5, origin=(0.0, 0.0))
    pj_, pt_ = jalme.ALMEParams(gamma=2.0, max_stretch=1.5), talme.ALMEParams(gamma=2.0,
                                                                              max_stretch=1.5)
    rng = np.random.default_rng(1)
    x = rng.uniform(1.8, 3.2, (24, 2)).astype(np.float32)
    DF = (np.eye(2) + 0.15 * rng.standard_normal((24, 2, 2))).astype(np.float32)
    np.testing.assert_allclose(talme.beta0(pt_, 0.5, 2), jalme.beta0(pj_, 0.5, 2))
    beta_j = jalme.update_beta(jalme.init_lme_beta(24, pj_, 0.5, 2), jnp.asarray(DF))
    beta_t = talme.update_beta(talme.init_lme_beta(24, pt_, 0.5, 2, device="cpu"),
                               torch.as_tensor(DF))
    np.testing.assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=1e-6)
    lam0 = np.zeros((24, 2), np.float32)
    ref = jalme.evaluate(gj, jnp.asarray(x), jnp.asarray(lam0), beta_j, pj_)
    got = talme.evaluate(to_torch_grid(gj), torch.as_tensor(x), torch.as_tensor(lam0),
                         beta_t, pt_)
    _basis_close(got, ref)
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(ref["lam"]), rtol=1e-3,
                               atol=1e-4 / 0.5)
    assert talme.offsets_for(2, pt_).shape == jalme.offsets_for(2, pj_).shape


def _step_pair(shapefun, transfer, alme_params=None):
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=11, n_side=14, n_particles=200,
                                                 speed=0.05)
    mj, mt = neo_hookean_tables()
    if shapefun == "alme":
        beta = np.asarray(jalme.init_lme_beta(pj.count, alme_params, gj.spacing, 2))
        pj, tp = with_fields(pj, tp, lme_beta=beta)
    dt = 0.1 * gj.spacing / np.sqrt(1e6 / 1e3)
    cfg_j = jex.ExplicitConfig(dt=dt, shapefun=shapefun, lme_params=lj, alme_params=alme_params,
                               kinds=(3,), transfer=transfer, active_box=bj)
    cfg_t = convert.config_from_fields(
        {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    assert cfg_t.shapefun == shapefun and cfg_t.transfer == transfer
    body = np.asarray([0.0, -9.81], np.float32)
    step_j = jax.jit(lambda q: jex.explicit_step(q, gj, mj, cfg_j, jnp.asarray(body)))
    for _ in range(3):
        pj, dj = step_j(pj)
        tp, dt_ = tex.explicit_step(tp, tg, mt, cfg_t, torch.as_tensor(body))
    assert int(dt_["nnz"]) == int(dj["nnz"]) > 0
    assert int(dt_["lost"]) == int(dj["lost"]) == 0
    names = ("x", "v", "lme_beta")
    got, ref = by_pid(tp, names=names), by_pid(pj, names=names)
    h = gj.spacing
    assert np.abs(got["x"] - ref["x"]).max() / h < 1e-3
    assert np.abs(got["v"] - ref["v"]).max() / np.abs(ref["v"]).max() < 1e-2
    return got, ref


@pytest.mark.parametrize("transfer", ["scatter", "windowed"])
def test_gimp_explicit_step_matches_jax(transfer):
    _step_pair("gimp", transfer)


@pytest.mark.parametrize("transfer", ["scatter", "windowed"])
def test_alme_explicit_step_matches_jax(transfer):
    """β pulled back by each step's ΔF, as the JAX step pulls it."""
    got, ref = _step_pair("alme", transfer, jalme.ALMEParams(gamma=3.0, max_stretch=1.2))
    np.testing.assert_allclose(got["lme_beta"], ref["lme_beta"], rtol=1e-4)
    b0 = 3.0 / (1.0 / 13) ** 2
    assert np.abs(got["lme_beta"] - b0 * np.eye(2)).max() > 1e-6 * b0, "β never pulled back"
