"""The 3D CUDA kernels' own source (csrc/lme_transfer3d.cu), run on the CPU
against the plain versions: compiled by the host C++ compiler with the
emulation header (``tests/_cuda_emu.py``), which holds the kernels' index
arithmetic (cell tiles, footprints, flush, slot layout) and their algebra
(one-sweep moments, the gather's J⁻¹ applied once) to the plain versions on
every test run; speed, registers and the GPU compiler are the chip's to
check (``chip_smoke.py``).  When the source comes to use a CUDA feature the
header cannot copy faithfully, this test goes."""

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


@pytest.fixture(scope="module")
def emulated():
    """The kernels' library built for the CPU (tests/_cuda_emu.py); the
    small box keeps the main paths' 8×4×4 tile."""
    with emulated_kernels("lme_transfer3d"):
        yield


def _problem(seed, margin, capacity=2, per_cell=1):
    """Random particles in an 11³-cell box of a 16³ grid (ragged against the
    8×4×4 tile), binned (overflow dropped), moved up to 0.9·margin cells."""
    rng = np.random.default_rng(seed)
    h = 1.0 / 15
    grid = Grid(dims=(16, 16, 16), spacing=h, origin=(0.0, 0.0, 0.0))
    n = per_cell * 11 ** 3
    x = (3 + 9 * rng.random((n, 3))) * h
    p = make_particles(x.astype(np.float32), mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
                       vol0=np.full(n, h ** 3, np.float32), device="cpu")
    box = windowed.ActiveBox(offset=(2, 2, 2), cdims=(11, 11, 11), capacity=capacity)
    p = to_slot_layout(p, grid, box, allow_lost=True)
    dx = 0.9 * margin * h * (2 * rng.random((p.count, 3)) - 1)
    p = p.replace(x=p.x + torch.as_tensor(dx, dtype=torch.float32))
    C, nc = box.capacity, box.n_cells
    slots = tuple(ft.to_channel_leading(a, C, nc)
                  for a in (p.x, p.lme_lambda, p.active.float()))
    return rng, grid, box, p, slots


def _close(got, ref, rtol, atol, scale=None):
    scale = scale or max(float(ref.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize(
    "margin,cN,has_G,gnorm,bounds,capacity",
    [(0, 4, False, False, False, 3), (1, 8, True, True, False, 2),
     (1, 3, True, False, True, 2)],
    ids=["solve-cN4-margin0-rank2", "solve-cN8-G-gnorm-margin1",
         "solve-cN3-G-margin1-valid_lo_hi"],
)
def test_emulated_scatter3d_matches_plain(emulated, margin, cN, has_G, gnorm, bounds,
                                          capacity):
    rng, grid, box, p, (x_t, lam_t, act_t) = _problem(30 + cN + bounds, margin, capacity,
                                                      per_cell=2 if capacity == 3 else 1)
    if bounds:
        # planes cut at the box's ends: every particle keeps nodes on both
        # sides after its drift
        grid = grid.replace(valid_lo=(2, 1, 2), valid_hi=(13, 14, 13))
    C, nc = box.capacity, box.n_cells
    vel = rng.standard_normal((p.count, cN - 1)).astype(np.float32)
    fN = ft.to_channel_leading(torch.cat([p.mass[:, None], p.mass[:, None] * torch.as_tensor(
        vel)], 1), C, nc)
    G_t = (ft.to_channel_leading(torch.as_tensor(
        rng.standard_normal((p.count, 9)).astype(np.float32)), C, nc) if has_G else None)
    nodes, lam, cnt = ft.scatter_cuda(grid, box, PARAMS, x_t, lam_t, act_t, fN, G_t=G_t,
                                      solve=True, margin=margin, gnorm=gnorm)
    r_nodes, r_lam, r_nnz = ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t, fN, G_t,
                                              True, margin, gnorm)
    assert int(cnt[0]) == int(r_nnz) > 0 and int(cnt[1]) >= int(p.active.sum())
    if capacity == 3:
        assert bool(p.active[nc:].any())  # ranks above 0 carry particles
    _close(nodes[:, :cN], r_nodes[:, :cN], **TOL_N)
    if has_G or gnorm:
        _close(nodes[:, cN:], r_nodes[:, cN:], **TOL_GRAD)
    lam_s, r_lam_s, act = (ft.from_channel_leading(lam), ft.from_channel_leading(r_lam),
                           p.active)
    _close(lam_s[act], r_lam_s[act], TOL_LAM["rtol"], TOL_LAM["atol"], 1.0 / grid.spacing)
    # an idle slot passes its λ through
    assert torch.equal(lam_s[~act], ft.from_channel_leading(lam_t)[~act])


@pytest.mark.parametrize(
    "margin,with_N,with_grad,same",
    [(1, True, True, True), (0, True, True, False), (0, False, True, False),
     (0, True, False, True)],
    ids=["N+grad-one-field-margin1", "N5+grad-margin0", "grad-margin0", "N-margin0"],
)
def test_emulated_gather3d_matches_plain(emulated, margin, with_N, with_grad, same):
    rng, grid, box, p, (x_t, lam_t, act_t) = _problem(40 + margin, margin)
    C, nc = box.capacity, box.n_cells
    # gathers run at the λ the step's scatter solved
    _, lam_t, _ = ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t,
                                    ft.to_channel_leading(p.mass, C, nc), None, True, margin,
                                    False)
    gg = torch.as_tensor(rng.standard_normal((grid.n_nodes, 3)).astype(np.float32))
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
