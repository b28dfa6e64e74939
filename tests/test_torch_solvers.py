"""The port's matrix-free solvers (nlpartsol_tpu_torch/ops/solvers.py)
against the JAX package's on the same numpy systems: an SPD system
(preconditioned CG), a nonsymmetric one (BiCGStab, restarted GMRES, dense
LU with a dof mask) and the nonlinear residual of
tests/test_implicit.py::test_newton_krylov_nonlinear (Newton-Krylov with
both forcings and both threshold modes).  Iteration counts are equal, and x
agrees to rtol 1e-5.  The JAX side is jitted, each program compiled once."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.ops import solvers as js

from nlpartsol_tpu_torch.ops import solvers as ts

from _torch_port import cheap_jax_compiles  # noqa: F401

torch.set_num_threads(1)

N = 40
RNG = np.random.default_rng(3)
_R = RNG.standard_normal((N, N)).astype(np.float32)
SPD = (_R @ _R.T / N + np.diag(RNG.uniform(0.5, 4.0, N))).astype(np.float32)
NONSYM = (np.diag(RNG.uniform(2.0, 6.0, N)) + 0.3 * _R).astype(np.float32)
B = RNG.standard_normal(N).astype(np.float32)
MASK = RNG.random(N) > 0.2


def _x_close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("name", ["pcg", "bicgstab", "gmres", "dense_lu"])
def test_linear_solver_matches_jax(name):
    A = SPD if name == "pcg" else NONSYM
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    dj, dt = jnp.asarray(np.diag(A)), torch.as_tensor(np.diag(A).copy())
    if name == "dense_lu":
        mj = jnp.asarray(MASK)
        ref = jax.jit(lambda b: js.dense_lu(lambda v: Aj @ v, b, free_mask=mj))(jnp.asarray(B))
        got = ts.dense_lu(lambda v: At @ v, torch.as_tensor(B), free_mask=torch.as_tensor(MASK))
    else:
        kw = dict(tol=1e-6, maxiter=200) if name != "gmres" else dict(tol=1e-6, restart=8,
                                                                       max_cycles=6)
        ref = jax.jit(lambda b: getattr(js, name)(lambda v: Aj @ v, b, M_inv=lambda r: r / dj,
                                                  **kw))(jnp.asarray(B))
        got = getattr(ts, name)(lambda v: At @ v, torch.as_tensor(B), M_inv=lambda r: r / dt,
                                **kw)
    assert got.iters == int(ref.iters) > 0
    _x_close(got.x, ref.x)
    assert float(got.residual) <= 1e-5 * float(np.linalg.norm(B))


@pytest.mark.parametrize("forcing", ["ew", "fixed"])
@pytest.mark.parametrize("threshold_mode,scale", [("abs1", 1.0), ("rel", 0.05)])
def test_newton_krylov_matches_jax(forcing, threshold_mode, scale):
    """scale·(x³ + x − c) with c = (2, 10) (root (1, 2)), from x₀ = 0; the
    inner solve is CG on the JVP, the loop the line search and stall rules.
    At scale 0.05 ‖R₀‖ < 1, where the two threshold modes differ.  The inner
    tolerance is 1e-5: a CG stop at 1e-7 on this 2×2 system sits on float32
    rounding, where one more CG iteration or one fewer is noise."""
    c = np.asarray([2.0, 10.0], np.float32)
    kw = dict(tol=1e-6, maxiter=30, cg_tol=1e-5, forcing=forcing,
              threshold_mode=threshold_mode)
    ref = jax.jit(lambda x0: js.newton_krylov(
        lambda x: scale * (x ** 3 + x - jnp.asarray(c)), x0, **kw))(jnp.zeros(2, jnp.float32))
    ts.reset_host_syncs()
    got = ts.newton_krylov(lambda x: scale * (x ** 3 + x - torch.as_tensor(c)), torch.zeros(2),
                           **kw)
    assert bool(got.converged) and bool(ref.converged)
    assert got.iters == int(ref.iters) > 1
    assert got.linear_iters == int(ref.linear_iters)
    _x_close(got.x, ref.x)
    np.testing.assert_allclose(got.x.numpy(), [1.0, 2.0], atol=1e-4)
    # one host read per Newton check, one per CG check (n + 1 and L + n)
    assert ts.host_syncs["newton"] == got.iters + 1
    assert ts.host_syncs["krylov"] == got.linear_iters + got.iters
