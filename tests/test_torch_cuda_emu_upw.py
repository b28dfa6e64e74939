"""The u-pw slice's calls of the 2D CUDA source (csrc/lme_transfer2d.cu),
run on the CPU through the emulated build of ``tests/_cuda_emu.py`` against
the plain versions: the new call variants alone (the scatter's λ solve with
7 channels and with 8 and gnorm, ``solve=False`` with gnorm on one channel,
``solve=False`` with G beside a zero channel; the gather of 3 channels with
the gradient of their first 2), two explicit u-pw steps, and an implicit
u-pw residual with its J·v under forward mode, each with its launch
counts (formulas of ``formulations/upw.py``)."""

import numpy as np
import pytest
import torch

from _cuda_emu import emulated_kernels
from test_torch_cuda_emu2d import _problem, _solved
from test_torch_upw import BODY, port_column
from nlpartsol_tpu_torch.formulations import upw as tupw
from nlpartsol_tpu_torch.ops import fused_transfer as ft
from nlpartsol_tpu_torch.ops import solvers, windowed
from nlpartsol_tpu_torch.shapefun import lme

torch.set_num_threads(1)

PARAMS = lme.LMEParams(gamma=3.0)
# chip_smoke.py's tolerances between a kernel and its plain version
TOL_N = dict(rtol=2e-5, atol=1e-6)
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)


@pytest.fixture(scope="module")
def emulated():
    with emulated_kernels("lme_transfer2d"):
        yield


@pytest.fixture
def through_kernels(emulated, monkeypatch):
    """Every transfer of a step goes to the emulated kernels."""

    def scatter(*args, **kw):
        nodes, lam, cnt = ft.scatter_cuda(*args, **kw)
        return nodes, lam, cnt[0]

    monkeypatch.setattr(ft, "fused_scatter", scatter)
    monkeypatch.setattr(ft, "fused_gather", ft.gather_cuda)
    ft.reset_launch_counts()


def _close(got, ref, rtol, atol):
    scale = max(float(ref.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("case", ["solve cN=7", "solve+gnorm cN=8", "gnorm cN=1", "G zero channel"])
def test_emulated_upw_scatter_variants_match_plain(emulated, case):
    rng, grid, box, p, (x_t, lam_t, act_t) = _problem(100 + len(case), 0, capacity=3,
                                                       per_cell=2)
    C, nc = box.capacity, box.n_cells
    solve = case.startswith("solve")
    gnorm = "gnorm" in case
    cN = {"solve cN=7": 7, "solve+gnorm cN=8": 8, "gnorm cN=1": 1, "G zero channel": 1}[case]
    fN = torch.as_tensor(rng.uniform(0.5, 2.0, (p.count, cN)).astype(np.float32))
    if case == "G zero channel":
        fN = torch.zeros_like(fN)
    fN_t = ft.to_channel_leading(fN, C, nc)
    G_t = None
    if case == "G zero channel":
        G = np.zeros((p.count, 2, 2), np.float32)
        G[:, 0, :] = rng.standard_normal((p.count, 2))  # a flow vector in row 0
        G_t = ft.to_channel_leading(torch.as_tensor(G.reshape(-1, 4)), C, nc)
    if not solve:
        lam_t = _solved(grid, box, p, x_t, lam_t, act_t, 0)
    nodes, lam, cnt = ft.scatter_cuda(grid, box, PARAMS, x_t, lam_t, act_t, fN_t, G_t=G_t,
                                      solve=solve, gnorm=gnorm)
    ref, _, r_nnz = ft._scatter_plain(grid, box, PARAMS, x_t, lam_t, act_t, fN_t, G_t, solve, 0,
                                      gnorm)
    assert int(cnt[0]) == int(r_nnz) > 0
    assert nodes.shape == ref.shape == (grid.n_nodes, cN + (2 if G_t is not None else 0)
                                        + (1 if gnorm else 0))
    if case != "G zero channel":
        _close(nodes[:, :cN], ref[:, :cN], **TOL_N)
    else:
        assert float(nodes[:, 0].abs().max()) == 0.0
    if G_t is not None or gnorm:
        _close(nodes[:, cN:], ref[:, cN:], **TOL_GRAD)


def test_emulated_gather_of_mixed_fields_matches_plain(emulated):
    """The N-gather of [u | θ] (3 channels) with the gradient of u, its first
    2 columns (a separate tensor): the kernel's reuse of the N-sums for the
    gradient of the same field must not apply; and the gradient alone of θ
    packed in column 0."""
    rng, grid, box, p, (x_t, lam_t, act_t) = _problem(120, 0, capacity=3, per_cell=2)
    lam_t = _solved(grid, box, p, x_t, lam_t, act_t, 0)
    z = torch.as_tensor(rng.standard_normal((grid.n_nodes, 3)).astype(np.float32))
    u = z[:, :2].contiguous()
    args = (grid, box, PARAMS, x_t, lam_t, act_t)
    got_N, got_G = ft.gather_cuda(*args, gN=z, g_grad=u)
    ref_N, ref_G = ft._gather_plain(*args, z, u, 0)
    _close(got_N[p.active], ref_N[p.active], **TOL_N)
    _close(got_G[p.active], ref_G[p.active], **TOL_GRAD)
    _, ref_wrong = ft._gather_plain(*args, None, z[:, 1:].contiguous(), 0)
    assert float((got_G - ref_wrong).abs().max()) > 1e-3 * float(ref_G.abs().max())
    packed = torch.cat([z[:, 2:], torch.zeros_like(z[:, 2:])], dim=1)
    _, got_p = ft.gather_cuda(*args, g_grad=packed)
    _close(got_p[p.active], ft._gather_plain(*args, None, packed, 0)[1][p.active], **TOL_GRAD)
    assert float(got_p[:, 1, :].abs().max()) == 0.0


def _column_lme():
    tg, tp, tm, tmix, h, H, _ = port_column()
    box = windowed.full_box(tg, capacity=8)
    return tg, tupw.to_slot_layout(tp, tg, box), tm, tmix, h, box


def test_emulated_explicit_upw_steps(through_kernels):
    """Two fused explicit u-pw steps through the emulated kernels against
    the plain versions: 3 scatters and 5 gathers a step."""
    tg, p0, tm, tmix, h, box = _column_lme()
    c_mix = np.sqrt((2.2e9 / 0.4) / 1700.0)
    cfg = tupw.UpwConfig(dt=0.2 * h / c_mix, lme_params=PARAMS, kinds=(3,), transfer="fused",
                         active_box=box)
    body = torch.as_tensor(BODY)
    p = p0
    for _ in range(2):
        p, diag = tupw.upw_step(p, tg, tm, tmix, cfg, body)
    assert dict(ft.launch_counts) == {
        "lme_scatter2d:solve": 2, "lme_scatter2d:G": 4, "lme_gather2d:N+grad": 2,
        "lme_gather2d:grad": 4, "lme_gather2d:N": 4}
    assert int(diag["lost"]) == 0
    ref = p0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft, "fused_scatter", _plain_scatter)
        mp.setattr(ft, "fused_gather", _plain_gather)
        for _ in range(2):
            ref, rdiag = tupw.upw_step(ref, tg, tm, tmix, cfg, body)
    assert int(diag["nnz"]) == int(rdiag["nnz"])
    act = p.active
    assert torch.equal(act, ref.active)
    _close(p.x[act], ref.x[act], rtol=1e-5, atol=1e-7)
    _close(p.v[act], ref.v[act], rtol=1e-3, atol=1e-5)
    _close(p.pw[act], ref.pw[act], rtol=1e-4, atol=1e-5)


def _plain_scatter(grid, box, params, x_t, lam_t, act_t, fN_t, G_t=None, solve=True, margin=0,
                   gnorm=False):
    return ft._scatter_plain(grid, box, params, x_t, lam_t, act_t, fN_t, G_t, solve, margin,
                             gnorm)


def _plain_gather(grid, box, params, x_t, lam_t, act_t, gN=None, g_grad=None, margin=0):
    return ft._gather_plain(grid, box, params, x_t, lam_t, act_t, gN, g_grad, margin)


def _residual_of(tg, p, tm, tmix, cfg):
    seen, real = {}, solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen["R"] = residual
        return real(residual, x0, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solvers, "newton_krylov", spy)
        tupw.upw_newmark_step(p, tg, tm, tmix, cfg.replace(newton_maxiter=0),
                              torch.as_tensor(BODY))
    return seen["R"]


def test_emulated_implicit_residual_and_jv(through_kernels):
    """The fused implicit u-pw residual and its J·v (dual tensors through
    GatherNGrad, GatherGrad, ScatterNG, ScatterG) through the emulated
    kernels against the plain versions, and the launches: a step with no
    Newton iteration makes the two set-up scatters, the fixed gathers, r₀,
    the converged local state and the last N-gather; a residual 2 gathers
    and 2 G-scatters, a J·v twice that."""
    tg, p, tm, tmix, h, box = _column_lme()
    cfg = tupw.UpwImplicitConfig(dt=2e-3, lme_params=PARAMS, kinds=(3,), transfer="fused",
                                 active_box=box)
    R = _residual_of(tg, p, tm, tmix, cfg)
    assert dict(ft.launch_counts) == {
        "lme_scatter2d:solve+gnorm": 1, "lme_scatter2d:gnorm": 1, "lme_gather2d:N+grad": 3,
        "lme_gather2d:grad": 3, "lme_scatter2d:G": 2, "lme_gather2d:N": 1}
    rng = np.random.default_rng(7)
    x = torch.as_tensor((1e-6 * rng.standard_normal((tg.n_nodes, 3))).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((tg.n_nodes, 3)).astype(np.float32))
    ft.reset_launch_counts()
    r = R(x)
    out, jv = solvers.jvp(R, x, v)
    assert dict(ft.launch_counts) == {"lme_gather2d:N+grad": 3, "lme_gather2d:grad": 3,
                                      "lme_scatter2d:G": 6}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft, "fused_scatter", _plain_scatter)
        mp.setattr(ft, "fused_gather", _plain_gather)
        R_ref = _residual_of(tg, p, tm, tmix, cfg)
        r_ref = R_ref(x)
        out_ref, jv_ref = solvers.jvp(R_ref, x, v)
    assert float(jv_ref.abs().max()) > 0.0
    for got, ref in ((r, r_ref), (out, r_ref), (jv, jv_ref)):
        _close(got, ref, rtol=1e-3, atol=1e-4)
