"""The port's 3D fused transfers (ops/fused_transfer.py, plain versions on CPU
tensors) against the JAX package's 3D fused functions on the same numpy
inputs.  On the CPU the JAX side reaches its XLA fallback (``_scatter_xla3``,
``_gather_xla3``) by itself: the same slot-cell-centred widened window."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.ops import pallas_transfer as pt

from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.shapefun import lme as tlme

from _torch_port import LAM_ATOL, cheap_jax_compiles, problem3  # noqa: F401

torch.set_num_threads(1)

# The tolerances of tests/test_torch_fused_transfer.py: those the JAX package
# holds between its own engines (tests/test_pallas_transfer*.py)
TOL_N = dict(rtol=2e-5, atol=1e-6)     # N-weighted sums
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)  # ∇N-weighted sums: J⁻¹ amplifies rounding
TOL_LAM_RTOL = 1e-3


def assert_close(got, ref, rtol, atol):
    """``atol`` is relative to the field's magnitude."""
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * max(np.abs(ref).max(), 1.0))


def _setup(seed, drift, gamma=5.0, tol_zero=1e-6, n_particles=60):
    """Both sides' problem; particles moved up to ``drift`` cells off their
    slot cell (what a margin-1 window must tolerate between re-binnings)."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem3(
        seed=seed, n_side=8, n_particles=n_particles, gamma=gamma, tol_zero=tol_zero)
    if drift:
        rng = np.random.default_rng(seed + 100)
        dx = (drift * gj.spacing * (2 * rng.random((pj.count, 3)) - 1)).astype(np.float32)
        x = np.asarray(pj.x) + dx
        pj, tp = pj.replace(x=jnp.asarray(x)), tp.replace(x=torch.as_tensor(x))
    C, nc = bj.capacity, bj.n_cells
    jx = (pt.to_channel_leading(pj.x, C, nc), pt.to_channel_leading(pj.lme_lambda, C, nc),
          pt.to_channel_leading(pj.active.astype(jnp.float32), C, nc))
    tx = (ft.to_channel_leading(tp.x, C, nc), ft.to_channel_leading(tp.lme_lambda, C, nc),
          ft.to_channel_leading(tp.active.float(), C, nc))
    return (gj, bj, pj, lj, jx), (tg, tb, tp, lt, tx)


def _bounds(gj, tg):
    # planes 0 and n-1 lie inside the edge particles' support (particles sit
    # 1.4-5.6 cells in, the radius is 1.66 cells); cutting them keeps every
    # particle inside the hull of its remaining nodes
    lo, hi = (1, 1, 1), (gj.dims[0] - 2, gj.dims[1] - 2, gj.dims[2] - 2)
    jkw = dict(valid_lo=jnp.asarray(lo, jnp.int32), valid_hi=jnp.asarray(hi, jnp.int32))
    return jkw, tg.replace(valid_lo=lo, valid_hi=hi)


@pytest.mark.parametrize(
    "margin,has_G,gnorm,bounds,gamma",
    [(0, False, False, False, 5.0), (1, True, True, False, 5.0),
     (0, True, False, True, 5.0), (0, True, False, False, 3.0)],
    ids=["solve-cN4-margin0", "G-gnorm-margin1", "G-margin0-valid_lo_hi", "G-gamma3"],
)
def test_fused_scatter3_matches_jax(margin, has_G, gnorm, bounds, gamma):
    tol_zero = 1e-6 if gamma == 5.0 else 1e-10
    (gj, bj, pj, lj, jx), (tg, tb, tp, lt, tx) = _setup(
        10 + margin + 2 * bounds, 0.9 * margin, gamma, tol_zero,
        n_particles=60 if gamma == 5.0 else 30)
    C, nc = bj.capacity, bj.n_cells
    rng = np.random.default_rng(1)
    vel = rng.standard_normal((pj.count, 3)).astype(np.float32)
    mass = np.asarray(pj.mass)
    chans = np.concatenate([mass[:, None], mass[:, None] * vel], axis=1)  # cN = 4
    G = rng.standard_normal((pj.count, 9)).astype(np.float32)
    jkw = {}
    if bounds:
        jkw, tg = _bounds(gj, tg)

    # one jitted program: op-by-op dispatch would compile every window slice
    j_nodes, j_lam, j_nnz = jax.jit(
        lambda x, lam, act, fN, G_t: pt.fused_scatter(
            gj, bj, lj, x, lam, act, fN, G_t=G_t, solve=True, margin=margin,
            gnorm=gnorm, **jkw)
    )(*jx, pt.to_channel_leading(jnp.asarray(chans), C, nc),
      pt.to_channel_leading(jnp.asarray(G), C, nc) if has_G else None)
    ft.reset_launch_counts()
    t_nodes, t_lam, t_nnz = ft.fused_scatter(
        tg, tb, lt, *tx, ft.to_channel_leading(torch.as_tensor(chans), C, nc),
        G_t=ft.to_channel_leading(torch.as_tensor(G), C, nc) if has_G else None,
        solve=True, margin=margin, gnorm=gnorm)
    # a CPU tensor goes to the plain version: no kernel launch is counted
    assert sum(ft.launch_counts.values()) == 0

    assert int(t_nnz) == int(j_nnz) > 0
    j_nodes, t_nodes = np.asarray(j_nodes), t_nodes.numpy()
    assert t_nodes.shape == j_nodes.shape == (gj.n_nodes, 4 + 3 * has_G + gnorm)
    assert_close(t_nodes[:, :4], j_nodes[:, :4], **TOL_N)
    if has_G or gnorm:
        assert_close(t_nodes[:, 4:], j_nodes[:, 4:], **TOL_GRAD)
    sel = np.asarray(pj.active)
    np.testing.assert_allclose(
        ft.from_channel_leading(t_lam).numpy()[sel],
        np.asarray(pt.from_channel_leading(j_lam))[sel],
        rtol=TOL_LAM_RTOL, atol=LAM_ATOL / gj.spacing)


@pytest.mark.parametrize(
    "margin,with_grad,bounds",
    [(1, True, False), (0, False, False), (0, True, True)],
    ids=["N+grad-margin1", "N-margin0", "N+grad-valid_lo_hi"],
)
def test_fused_gather3_matches_jax(margin, with_grad, bounds):
    (gj, bj, pj, lj, jx), (tg, tb, tp, lt, tx) = _setup(20 + margin + 2 * bounds, 0.9 * margin)
    C, nc = bj.capacity, bj.n_cells
    jkw = {}
    if bounds:
        jkw, tg = _bounds(gj, tg)
    # gathers run at the λ the step's scatter solved: the port's, for both
    _, t_lam, _ = ft.fused_scatter(tg, tb, lt, *tx, ft.to_channel_leading(tp.mass, C, nc),
                                   solve=True, margin=margin)
    j_lam = jnp.asarray(t_lam.numpy())
    field = np.random.default_rng(5).standard_normal((gj.n_nodes, 3)).astype(np.float32)

    j_N, j_grad = jax.jit(
        lambda x, lam, act, f: pt.fused_gather(
            gj, bj, lj, x, lam, act, gN=f, g_grad=f if with_grad else None, margin=margin,
            **jkw)
    )(jx[0], j_lam, jx[2], jnp.asarray(field))
    t_N, t_grad = ft.fused_gather(tg, tb, lt, tx[0], t_lam, tx[2], gN=torch.as_tensor(field),
                                  g_grad=torch.as_tensor(field) if with_grad else None,
                                  margin=margin)
    sel = np.asarray(pj.active)
    assert_close(t_N.numpy()[sel], np.asarray(j_N)[sel], **TOL_N)
    if with_grad:
        assert t_grad.shape == (tb.n_slots, 3, 3)
        assert_close(t_grad.numpy()[sel], np.asarray(j_grad)[sel], **TOL_GRAD)
    else:
        assert t_grad is None and j_grad is None


def test_window_and_wrapper_checks_in_3d():
    """The radius-culled 3D window at γ=3 (tol_zero 1e-10): 160 of 343
    offsets at margin 0 and 432 of 729 at margin 1, as the TPU kernels'
    ``_Geom3.trips``; and the CUDA launch path's 3D argument checks."""
    (gj, bj, _, _, _), (tg, tb, tp, lt, tx) = _setup(3, 0.0)
    params = tlme.LMEParams(gamma=3.0)
    g0, g1 = ft._geom(tg, params, 0), ft._geom(tg, params, 1)
    assert (len(g0.offsets), g0.w, len(g1.offsets), g1.w) == (160, 3, 432, 4)
    assert len(g1.offsets) <= ft.MAX_OFFSETS[3] and len(g1.offs_c) == 3 * 432
    # asymmetric: a particle lies above its slot cell's lower corner
    assert g0.offsets[0] == (-2, -1, -1) and g0.offsets[-1] == (3, 2, 2)
    args = ft._geom_args(g0, tg.replace(valid_lo=(1, 1, 1)), tb)
    # 15 ints, 6 floats, the window and its length
    assert len(args) == 23 and args[:4] == [tb.n_slots, tb.n_cells, *tb.cdims[1:]]
    assert args[9:15] == [1, 7, 1, 7, 1, 7] and args[-1] == 160
    C, nc = tb.capacity, tb.n_cells
    with pytest.raises(ValueError, match="shape"):
        ft._check_slot("G_t", tx[0], 9, C, nc, tx[0].device)
    with pytest.raises(ValueError, match="2D and 3D"):
        ft._geom(tg.replace(dims=(4,), origin=(0.0,)), params, 0)
