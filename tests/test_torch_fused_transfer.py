"""The port's fused transfers (ops/fused_transfer.py, plain versions on CPU
tensors) against the JAX package's on the same numpy inputs.  The JAX side
runs its XLA fallback — the same slot-cell-centred widened window."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.ops import pallas_transfer as pt

from nlpartsol_tpu_torch.ops import fused_transfer as ft

from _torch_port import LAM_ATOL, cheap_jax_compiles, problem  # noqa: F401

torch.set_num_threads(1)

# The tolerances the JAX package holds between its own engines
# (tests/test_pallas_transfer.py): both sides run the same float32 algorithm,
# with sums taken in another order.
TOL_N = dict(rtol=2e-5, atol=1e-6)     # N-weighted sums
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)  # ∇N-weighted sums: J⁻¹ amplifies rounding
# λ ~ 1/h: a Newton stop at ‖r‖ ≤ 1e-6·R leaves it uncertain by J⁻¹r ≈ 2e-5/h
TOL_LAM_RTOL = 1e-3


def assert_close(got, ref, rtol, atol):
    """``atol`` is relative to the field's magnitude (the JAX package's tests
    state it for fields of order one)."""
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * max(np.abs(ref).max(), 1.0))


def _slot_inputs(pj, bj, pt_, tb):
    C, nc = bj.capacity, bj.n_cells
    jx = (pt.to_channel_leading(pj.x, C, nc), pt.to_channel_leading(pj.lme_lambda, C, nc),
          pt.to_channel_leading(pj.active.astype(jnp.float32), C, nc))
    tx = (ft.to_channel_leading(pt_.x, C, nc), ft.to_channel_leading(pt_.lme_lambda, C, nc),
          ft.to_channel_leading(pt_.active.float(), C, nc))
    return jx, tx


def _drift(jax_side, torch_side, seed, cells):
    """Move particles up to ``cells`` cells off their slot cell (what a
    margin-1 window must tolerate between re-binnings)."""
    (gj, bj, pj, lj), (tg, tb, tp, lt) = jax_side, torch_side
    rng = np.random.default_rng(seed)
    dx = (cells * gj.spacing * (2 * rng.random((pj.count, 2)) - 1)).astype(np.float32)
    x = np.asarray(pj.x) + dx
    return (gj, bj, pj.replace(x=jnp.asarray(x)), lj), (tg, tb, tp.replace(x=torch.as_tensor(x)), lt)


@pytest.mark.parametrize(
    "margin,has_G,gnorm,bounds",
    [(1, True, True, False), (0, True, False, True)],
    ids=["margin1-G-gnorm", "margin0-G-valid_lo_hi"],
)
def test_fused_scatter_matches_jax(margin, has_G, gnorm, bounds):
    jax_side, torch_side = problem(seed=3 + margin, n_side=12, n_particles=150)
    if margin:
        jax_side, torch_side = _drift(jax_side, torch_side, 5, 0.9)
    (gj, bj, pj, lj), (tg, tb, tp, lt) = jax_side, torch_side
    C, nc = bj.capacity, bj.n_cells
    rng = np.random.default_rng(1)
    vel = rng.standard_normal((pj.count, 2)).astype(np.float32)
    chans = np.concatenate(
        [np.asarray(pj.mass)[:, None], np.asarray(pj.mass)[:, None] * vel], axis=1)
    G = rng.standard_normal((pj.count, 4)).astype(np.float32)
    jx, tx = _slot_inputs(pj, bj, tp, tb)
    jkw = {}
    if bounds:
        # planes 0 and n-1 lie inside the edge particles' windows
        lo, hi = (1, 1), (gj.dims[0] - 2, gj.dims[1] - 2)
        jkw = dict(valid_lo=jnp.asarray(lo, jnp.int32), valid_hi=jnp.asarray(hi, jnp.int32))
        tg = tg.replace(valid_lo=lo, valid_hi=hi)

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

    assert int(t_nnz) == int(j_nnz)
    j_nodes, t_nodes = np.asarray(j_nodes), t_nodes.numpy()
    assert t_nodes.shape == j_nodes.shape
    assert_close(t_nodes[:, :3], j_nodes[:, :3], **TOL_N)
    if has_G or gnorm:
        assert_close(t_nodes[:, 3:], j_nodes[:, 3:], **TOL_GRAD)
    sel = np.asarray(pj.active)
    np.testing.assert_allclose(
        ft.from_channel_leading(t_lam).numpy()[sel],
        np.asarray(pt.from_channel_leading(j_lam))[sel],
        rtol=TOL_LAM_RTOL, atol=LAM_ATOL / gj.spacing)


@pytest.mark.parametrize(
    "margin,with_grad", [(1, True), (0, False)], ids=["N+grad-margin1", "N-margin0"],
)
def test_fused_gather_matches_jax(margin, with_grad):
    jax_side, torch_side = problem(seed=4, n_side=12, n_particles=150)
    if margin:
        jax_side, torch_side = _drift(jax_side, torch_side, 6, 0.9)
    (gj, bj, pj, lj), (tg, tb, tp, lt) = jax_side, torch_side
    C, nc = bj.capacity, bj.n_cells
    jx, tx = _slot_inputs(pj, bj, tp, tb)
    # gathers run at the λ the step's scatter solved: the port's, for both
    _, t_lam, _ = ft.fused_scatter(tg, tb, lt, *tx, ft.to_channel_leading(tp.mass, C, nc),
                                   solve=True, margin=margin)
    j_lam = jnp.asarray(t_lam.numpy())
    field = np.random.default_rng(5).standard_normal((gj.n_nodes, 2)).astype(np.float32)

    j_N, j_grad = jax.jit(
        lambda x, lam, act, f: pt.fused_gather(
            gj, bj, lj, x, lam, act, gN=f, g_grad=f if with_grad else None, margin=margin)
    )(jx[0], j_lam, jx[2], jnp.asarray(field))
    t_N, t_grad = ft.fused_gather(tg, tb, lt, tx[0], t_lam, tx[2], gN=torch.as_tensor(field),
                                  g_grad=torch.as_tensor(field) if with_grad else None,
                                  margin=margin)
    sel = np.asarray(pj.active)
    assert_close(t_N.numpy()[sel], np.asarray(j_N)[sel], **TOL_N)
    if with_grad:
        assert_close(t_grad.numpy()[sel], np.asarray(j_grad)[sel], **TOL_GRAD)
    else:
        assert t_grad is None and j_grad is None


def test_channel_leading_round_trip():
    a = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(15, 2)
    t = ft.to_channel_leading(a, 3, 5)
    assert t.shape == (2, 3, 5) and t.is_contiguous()
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(pt.to_channel_leading(jnp.asarray(a.numpy()), 3, 5)))
    assert torch.equal(ft.from_channel_leading(t), a)
    assert ft.to_channel_leading(a[:, 0], 3, 5).shape == (1, 3, 5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, (tg, tb, tp, lt) = problem(seed=3, n_side=12, n_particles=150)
    C, nc = tb.capacity, tb.n_cells
    x_t = ft.to_channel_leading(tp.x, C, nc)
    with pytest.raises(ValueError, match="nothing to gather"):
        ft.fused_gather(tg, tb, lt, x_t, x_t, x_t[:1])
    # the CUDA launch path refuses wrong dtypes, shapes and layouts before
    # it touches the device
    with pytest.raises(TypeError, match="float32"):
        ft._check_slot("x_t", x_t.double(), 2, C, nc, x_t.device)
    with pytest.raises(ValueError, match="shape"):
        ft._check_slot("x_t", x_t, 3, C, nc, x_t.device)
    with pytest.raises(ValueError, match="contiguous"):
        ft._check_slot("x_t", x_t.transpose(1, 2).contiguous().transpose(1, 2), 2, C, nc,
                       x_t.device)
    # 2D and 3D grids have kernels (3D: tests/test_torch_fused_transfer3d.py)
    grid1 = tg.replace(dims=(4,), origin=(0.0,))
    with pytest.raises(ValueError, match="2D and 3D"):
        ft._geom(grid1, lt, 0)

