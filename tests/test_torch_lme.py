"""The port's LME shape functions (shapefun/lme.py, shapefun/window.py)
against the JAX package's on the same numpy inputs, both on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.shapefun import lme as jlme, window as jwindow

from nlpartsol_tpu_torch.shapefun import lme as tlme, window as twindow

from _torch_port import LAM_ATOL, cheap_jax_compiles, problem  # noqa: F401

torch.set_num_threads(1)


def test_lme_evaluate_matches_jax():
    (gj, _, pj, lj), (tg, _, tp, lt) = problem(seed=0, slots=False, origin=(0.3, -0.2))
    sf_j = jax.jit(lambda x, lam: jlme.evaluate(gj, x, lam, lj))(pj.x, pj.lme_lambda)
    sf_t = tlme.evaluate(tg, tp.x, tp.lme_lambda, lt)
    np.testing.assert_array_equal(sf_t["node_ids"].numpy(), np.asarray(sf_j["node_ids"]))
    np.testing.assert_array_equal(sf_t["mask"].numpy(), np.asarray(sf_j["mask"]))
    # N to 2e-5 and ∇N (scaled by h: ∇N ~ 1/h) to 3e-4: the tolerances the
    # JAX package holds between its engines; J⁻¹ amplifies rounding in ∇N
    np.testing.assert_allclose(sf_t["N"].numpy(), np.asarray(sf_j["N"]), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(sf_t["dN"].numpy() * gj.spacing,
                               np.asarray(sf_j["dN"]) * gj.spacing, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(sf_t["lam"].numpy(), np.asarray(sf_j["lam"]),
                               rtol=1e-3, atol=LAM_ATOL / gj.spacing)
    # partition of unity and first-order consistency hold in the port itself
    N, dN = sf_t["N"], sf_t["dN"]
    assert torch.allclose(N.sum(-1), torch.ones(tp.count), atol=1e-5)
    assert float(dN.sum(1).abs().max()) * gj.spacing < 1e-4


@pytest.mark.parametrize("wrapper", ["Newton-Raphson", "Nelder-Mead"])
def test_solve_lambda_matches_jax(wrapper):
    (gj, _, pj, lj), (tg, _, tp, lt) = problem(seed=1, slots=False)
    lj, lt = lj.replace(wrapper=wrapper), lt.replace(wrapper=wrapper)
    offs = jlme.offsets_for(2, lj)
    _, rel, inb = jwindow.window_nodes(gj, pj.x, offs)
    _, rel_t, inb_t = twindow.window_nodes(tg, tp.x, offs)
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel), rtol=0, atol=1e-7)
    r2 = jlme.support_radius(lj, gj.spacing) ** 2
    assert tlme.support_radius(lt, tg.spacing) ** 2 == r2
    mask = np.asarray(inb) & (np.sum(np.asarray(rel) ** 2, -1) <= np.float32(r2))
    beta = jlme.beta_of(lj, gj.spacing)
    lam_j = jax.jit(lambda r, m, l0: jlme.solve_lambda(r, m, l0, beta, lj))(
        rel, jnp.asarray(mask), pj.lme_lambda)
    lam_t = tlme.solve_lambda(rel_t, torch.as_tensor(mask), tp.lme_lambda,
                              tlme.beta_of(lt, tg.spacing), lt)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-3,
                               atol=LAM_ATOL / gj.spacing)
    with pytest.raises(ValueError, match="unknown LME wrapper"):
        tlme.solve_lambda(rel_t, torch.as_tensor(mask), tp.lme_lambda, beta,
                          lt.replace(wrapper="simplex"))


def test_window_nodes_honours_valid_bounds_and_inactive_nodes():
    (gj, _, pj, lj), (tg, _, tp, lt) = problem(seed=2, slots=False)
    offs = jlme.offsets_for(2, lj)
    active = np.ones(gj.n_nodes, bool)
    active[::7] = False
    gj2 = gj.replace(valid_lo=jnp.asarray([1, 2], jnp.int32),
                     valid_hi=jnp.asarray([9, 10], jnp.int32), active=jnp.asarray(active))
    tg2 = tg.replace(valid_lo=(1, 2), valid_hi=(9, 10), active=torch.as_tensor(active))
    _, _, m_j = jwindow.window_nodes(gj2, pj.x, offs)
    _, _, m_t = twindow.window_nodes(tg2, tp.x, offs)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    # a scalar bounds axis 0 only
    _, _, m_j = jwindow.window_nodes(gj.replace(valid_lo=jnp.int32(3), valid_hi=jnp.int32(8)),
                                     pj.x, offs)
    _, _, m_t = twindow.window_nodes(tg.replace(valid_lo=3, valid_hi=8), tp.x, offs)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(tg.node_coords(device="cpu").numpy(),
                               np.asarray(gj.node_coords()), rtol=0, atol=1e-7)
