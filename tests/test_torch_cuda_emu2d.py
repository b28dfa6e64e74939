"""The 2D CUDA kernels' own source (csrc/lme_transfer2d.cu), run on the CPU
against the plain versions: compiled by the host C++ compiler with the
emulation header (``tests/_cuda_emu.py``).  That holds the kernels' index
arithmetic (cell tiles, footprints and their flush, the culled window
rows, slot layout) and their algebra (one-sweep moments, the
gather's J⁻¹ applied once) to the plain versions on every test run; speed,
registers and the GPU compiler are the chip's to check (``chip_smoke.py``).
When the source comes to use a CUDA feature the header cannot copy
faithfully, this test goes."""

import numpy as np
import pytest
import torch

from _cuda_emu import emulated_kernels
from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
from nlpartsol_tpu_torch.ops import windowed
from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.shapefun import lme
from nlpartsol_tpu_torch.types import Grid, make_particles

torch.set_num_threads(1)

PARAMS = lme.LMEParams(gamma=3.0)
# chip_smoke.py's tolerances between a kernel and its plain version
TOL_N = dict(rtol=2e-5, atol=1e-6)
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)
TOL_LAM = dict(rtol=1e-3, atol=1e-4)  # atol × 1/h
CDIMS = (13, 21)  # ragged against the 4×8 tile on both axes


@pytest.fixture(scope="module")
def emulated():
    """The kernels' library built for the CPU; the small box keeps the main
    path's 4×8 tile (12 tiles, 6 of them ragged)."""
    with emulated_kernels("lme_transfer2d"):
        yield


def _problem(seed, margin, capacity=2, per_cell=1):
    """Random particles in a 13×21-cell box of a 20×28 grid, binned
    (overflow dropped), moved up to 0.9·margin cells."""
    rng = np.random.default_rng(seed)
    h = 1.0 / 27
    grid = Grid(dims=(20, 28), spacing=h, origin=(0.0, 0.0))
    n = per_cell * CDIMS[0] * CDIMS[1]
    x = (3 + np.array([11.0, 19.0]) * rng.random((n, 2))) * h
    p = make_particles(x.astype(np.float32), mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
                       vol0=np.full(n, h ** 2, np.float32), device="cpu")
    box = windowed.ActiveBox(offset=(2, 2), cdims=CDIMS, capacity=capacity)
    p = to_slot_layout(p, grid, box, allow_lost=True)
    dx = 0.9 * margin * h * (2 * rng.random((p.count, 2)) - 1)
    p = p.replace(x=p.x + torch.as_tensor(dx, dtype=torch.float32))
    C, nc = box.capacity, box.n_cells
    slots = tuple(ft.to_channel_leading(a, C, nc)
                  for a in (p.x, p.lme_lambda, p.active.float()))
    return rng, grid, box, p, slots


def _close(got, ref, rtol, atol, scale=None):
    scale = scale or max(float(ref.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=atol * scale)


def _solved(grid, box, p, x_t, lam_t, act_t, margin):
    """λ as the step's first scatter solves it (the plain version)."""
    dummy = ft.to_channel_leading(p.mass, box.capacity, box.n_cells)
    return ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t, dummy, None, True, margin,
                             False)[1]


@pytest.mark.parametrize(
    "margin,cN,has_G,gnorm,bounds,capacity,solve",
    [(0, 3, False, False, False, 3, True), (1, 8, True, True, False, 2, True),
     (1, 3, True, False, True, 2, True), (1, 1, True, False, False, 2, False)],
    ids=["solve-cN3-margin0-rank2", "solve-cN8-G-gnorm-margin1",
         "solve-cN3-G-margin1-valid_lo_hi", "G-zero-channel-margin1"],
)
def test_emulated_scatter2d_matches_plain(emulated, margin, cN, has_G, gnorm, bounds,
                                          capacity, solve):
    rng, grid, box, p, (x_t, lam_t, act_t) = _problem(50 + cN + bounds, margin, capacity,
                                                      per_cell=2 if capacity == 3 else 1)
    if bounds:
        # planes cut at the box's ends: every particle keeps nodes on both
        # sides after its drift
        grid = grid.replace(valid_lo=(2, 1), valid_hi=(15, 24))
    C, nc = box.capacity, box.n_cells
    if solve:
        vel = rng.standard_normal((p.count, cN - 1)).astype(np.float32)
        fN = ft.to_channel_leading(torch.cat([p.mass[:, None], p.mass[:, None] * torch.as_tensor(
            vel)], 1), C, nc)
    else:
        # the step's second scatter: an all-zero channel beside Σ G·∇N at
        # the solved λ
        lam_t = _solved(grid, box, p, x_t, lam_t, act_t, margin)
        fN = ft.to_channel_leading(torch.zeros_like(p.mass), C, nc)
    G_t = (ft.to_channel_leading(torch.as_tensor(
        rng.standard_normal((p.count, 4)).astype(np.float32)), C, nc) if has_G else None)
    nodes, lam, cnt = ft.scatter_cuda(grid, box, PARAMS, x_t, lam_t, act_t, fN, G_t=G_t,
                                      solve=solve, margin=margin, gnorm=gnorm)
    r_nodes, r_lam, r_nnz = ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t, fN, G_t,
                                              solve, margin, gnorm)
    assert int(cnt[0]) == int(r_nnz) > 0
    if solve:
        assert int(cnt[1]) >= int(p.active.sum())
        _close(nodes[:, :cN], r_nodes[:, :cN], **TOL_N)
    else:
        assert int(cnt[1]) == 0 and not bool(nodes[:, 0].any())
    if capacity == 3:
        assert bool(p.active[2 * nc:].any())  # rank 2 carries particles
    if has_G or gnorm:
        _close(nodes[:, cN:], r_nodes[:, cN:], **TOL_GRAD)
    lam_s, r_lam_s, act = (ft.from_channel_leading(lam), ft.from_channel_leading(r_lam),
                           p.active)
    _close(lam_s[act], r_lam_s[act], TOL_LAM["rtol"], TOL_LAM["atol"], 1.0 / grid.spacing)
    # an idle slot passes its λ through (NaN where the plain solve left it)
    np.testing.assert_array_equal(lam_s[~act].numpy(),
                                  ft.from_channel_leading(lam_t)[~act].numpy())


@pytest.mark.parametrize(
    "margin,with_N,with_grad,same",
    [(1, True, True, True), (0, True, True, False), (0, False, True, False),
     (1, True, False, True)],
    ids=["N+grad-one-field-margin1", "N5+grad-margin0", "grad-margin0", "N-margin1"],
)
def test_emulated_gather2d_matches_plain(emulated, margin, with_N, with_grad, same):
    rng, grid, box, p, (x_t, lam_t, act_t) = _problem(60 + margin, margin)
    # gathers run at the λ the step's scatter solved
    lam_t = _solved(grid, box, p, x_t, lam_t, act_t, margin)
    gg = torch.as_tensor(rng.standard_normal((grid.n_nodes, 2)).astype(np.float32))
    gN = None
    if with_N:
        gN = gg if same else torch.as_tensor(
            rng.standard_normal((grid.n_nodes, 5)).astype(np.float32))
    got = ft.gather_cuda(grid, box, PARAMS, x_t, lam_t, act_t, gN=gN,
                         g_grad=gg if with_grad else None, margin=margin)
    ref = ft._gather_plain(grid, box, PARAMS, x_t, lam_t, act_t, gN,
                           gg if with_grad else None, margin)
    for g_, r_, tol in ((got[0], ref[0], TOL_N), (got[1], ref[1], TOL_GRAD)):
        if r_ is None:
            assert g_ is None
            continue
        _close(g_[p.active], r_[p.active], **tol)
        assert float(g_[~p.active].abs().max()) == 0.0  # idle slots write zeros
