"""The CUDA sources (csrc/lme_transfer2d.cu, lme_transfer3d.cu) at the
implicit step's channel counts, run on the CPU against the plain versions
(the emulated build of ``tests/_cuda_emu.py``): the first scatter with the
Jacobi diagonal ``gnorm`` at margin 0 (2D: 6 channels, 8 with tractions;
3D: 8, 11 with tractions), the last N-gathers (2D 6, 3D 9 channels, and the
12-channel cap), and a whole 2D fused implicit step through the emulated
kernels, whose launches follow the formula of
``formulations/implicit.py``."""

import numpy as np
import pytest
import torch

from _cuda_emu import emulated_kernels
from test_torch_cuda_emu2d import _problem as _problem2d
from test_torch_cuda_emu3d import _problem as _problem3d
from nlpartsol_tpu_torch.formulations import implicit as tim
from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
from nlpartsol_tpu_torch.models import materials as M
from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.ops import windowed
from nlpartsol_tpu_torch.shapefun import lme
from nlpartsol_tpu_torch.types import Grid, make_particles

torch.set_num_threads(1)

PARAMS = lme.LMEParams(gamma=3.0)
# chip_smoke.py's tolerances between a kernel and its plain version
TOL_N = dict(rtol=2e-5, atol=1e-6)
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)
TOL_LAM = dict(rtol=1e-3, atol=1e-4)  # atol × 1/h
PROBLEMS = {2: _problem2d, 3: _problem3d}


@pytest.fixture(scope="module")
def emulated():
    with emulated_kernels("lme_transfer2d"), emulated_kernels("lme_transfer3d"):
        yield


def _close(got, ref, rtol, atol, scale=None):
    scale = scale or max(float(ref.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("dim,cN", [(2, 6), (2, 8), (3, 8), (3, 11)],
                         ids=["2d-cN6", "2d-cN8-traction", "3d-cN8", "3d-cN11-traction"])
def test_emulated_implicit_first_scatter_matches_plain(emulated, dim, cN):
    """λ solve at margin 0 with cN channels — mass, momenta (and tractions),
    the stiffness scale last — and gnorm, Σ s·|∇N|² weighted by that last
    channel."""
    rng, grid, box, p, (x_t, lam_t, act_t) = PROBLEMS[dim](70 + cN, 0)
    C, nc = box.capacity, box.n_cells
    chans = [p.mass[:, None], p.mass[:, None] * torch.as_tensor(
        rng.standard_normal((p.count, cN - 2)).astype(np.float32)),
        torch.as_tensor(rng.uniform(1e3, 2e3, (p.count, 1)).astype(np.float32))]
    fN = ft.to_channel_leading(torch.cat(chans, 1), C, nc)
    nodes, lam, cnt = ft.scatter_cuda(grid, box, PARAMS, x_t, lam_t, act_t, fN, solve=True,
                                      gnorm=True)
    r_nodes, r_lam, r_nnz = ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t, fN, None,
                                              True, 0, True)
    assert nodes.shape == (grid.n_nodes, cN + 1)
    assert int(cnt[0]) == int(r_nnz) > 0
    _close(nodes[:, :cN], r_nodes[:, :cN], **TOL_N)
    _close(nodes[:, cN:], r_nodes[:, cN:], **TOL_GRAD)
    assert float(nodes[:, cN].min()) >= 0.0 and float(nodes[:, cN].max()) > 0.0
    act = p.active
    _close(ft.from_channel_leading(lam)[act], ft.from_channel_leading(r_lam)[act],
           TOL_LAM["rtol"], TOL_LAM["atol"], 1.0 / grid.spacing)


@pytest.mark.parametrize("dim,cN", [(2, 6), (2, 12), (3, 9)], ids=["2d-N6", "2d-N12", "3d-N9"])
def test_emulated_wide_gather_matches_plain(emulated, dim, cN):
    rng, grid, box, p, (x_t, lam_t, act_t) = PROBLEMS[dim](80 + cN, 0)
    C, nc = box.capacity, box.n_cells
    _, lam_t, _ = ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t,
                                    ft.to_channel_leading(p.mass, C, nc), None, True, 0, False)
    gN = torch.as_tensor(rng.standard_normal((grid.n_nodes, cN)).astype(np.float32))
    got, _ = ft.gather_cuda(grid, box, PARAMS, x_t, lam_t, act_t, gN=gN)
    ref, _ = ft._gather_plain(grid, box, PARAMS, x_t, lam_t, act_t, gN, None, 0)
    _close(got[p.active], ref[p.active], **TOL_N)
    assert float(got[~p.active].abs().max()) == 0.0


def test_emulated_implicit_step_launches_follow_formula(emulated, monkeypatch):
    """A 2D fused implicit step with every transfer through the emulated
    kernels: the same state as the plain versions give, and per step one
    λ-solve scatter with gnorm, 3 + 7n + 2L gradient gathers, 1 + 7n + 2L
    G-scatters and one N-gather."""
    rng = np.random.default_rng(90)
    h = 1.0 / 15
    grid = Grid(dims=(16, 16), spacing=h, origin=(0.0, 0.0))
    x = (4 + 7 * rng.random((150, 2))) * h
    p0 = make_particles(x.astype(np.float32), mass=rng.uniform(0.5, 2.0, 150).astype(np.float32),
                        vol0=np.full(150, h * h / 4, np.float32),
                        v=(0.02 * rng.standard_normal((150, 2))).astype(np.float32), device="cpu")
    box = windowed.ActiveBox(offset=(2, 2), cdims=(11, 11), capacity=10)
    p0 = to_slot_layout(p0, grid, box)
    mats = M.material_table([M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3)],
                            device="cpu")
    cfg = tim.ImplicitConfig(dt=0.5 * h / np.sqrt(1e3), lme_params=PARAMS, active_box=box,
                             cg_maxiter=100)
    body = torch.tensor([0.0, -9.81])
    p_ref, d_ref = tim.implicit_step(p0, grid, mats, cfg, body)

    def scatter(*args, **kw):
        nodes, lam, cnt = ft.scatter_cuda(*args, **kw)
        return nodes, lam, cnt[0]

    monkeypatch.setattr(ft, "fused_scatter", scatter)
    monkeypatch.setattr(ft, "fused_gather", ft.gather_cuda)
    ft.reset_launch_counts()
    p1, d1 = tim.implicit_step(p0, grid, mats, cfg, body)
    n, L = d1["newton_iters"], d1["cg_iters"]
    assert bool(d1["converged"]) and int(d1["lost"]) == 0 and n >= 2
    assert dict(ft.launch_counts) == {
        "lme_scatter2d:solve+gnorm": 1, "lme_gather2d:grad": 3 + 7 * n + 2 * L,
        "lme_scatter2d:G": 1 + 7 * n + 2 * L, "lme_gather2d:N": 1}
    assert n == d_ref["newton_iters"] and int(d1["nnz"]) == int(d_ref["nnz"])
    act = p1.active
    assert torch.equal(act, p_ref.active)
    _close(p1.x[act], p_ref.x[act], rtol=1e-5, atol=1e-7)
    _close(p1.v[act], p_ref.v[act], rtol=1e-3, atol=1e-5)
    _close(p1.F[act], p_ref.F[act], rtol=1e-4, atol=1e-6)
