"""The banded BSR tangent (nlpartsol_tpu_torch/ops/bsr.py) and the
windowed engine's block-Jacobi preconditioner: the banded operations
against the JAX package's on the same numpy band; ``assemble_tangent``'s
SpMV against the port's own matrix-free J·v (float64); and a block-Jacobi
windowed implicit step against the JAX package's (by pid: x rtol 1e-4 atol
1e-6; v, F rtol 1e-3 atol 1e-5; equal nnz and Newton iterations)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.formulations import implicit as jim
from nlpartsol_tpu.ops import bsr as jbsr
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch.formulations import implicit as tim
from nlpartsol_tpu_torch.ops import bsr as tbsr
from nlpartsol_tpu_torch.ops import solvers

from _torch_port import (by_pid, cheap_jax_compiles, implicit_configs,  # noqa: F401
                         neo_hookean_tables, problem, with_fields)

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [2, 3])
def test_banded_operations_match_jax(dim):
    """relative_offsets of the LME γ=3 window, then on a random band: SpMV,
    the dense oracle, dof masks, the inertial diagonal, the block-Jacobi
    inverse."""
    offs = jlme.offsets_for(dim, jlme.LMEParams(gamma=3.0))
    rels, pair = tbsr.relative_offsets(offs)
    rels_j, pair_j = jbsr.relative_offsets(offs)
    np.testing.assert_array_equal(rels, rels_j)
    np.testing.assert_array_equal(pair, pair_j)
    rng = np.random.default_rng(20 + dim)
    dims = (4, 5) if dim == 2 else (3, 4, 3)
    small = np.array(list(np.ndindex(*(2,) * dim)))  # a 2^d window: a short band
    rels, _ = tbsr.relative_offsets(small)
    n = int(np.prod(dims))
    band = rng.standard_normal((n, len(rels), dim, dim)).astype(np.float32)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    free = rng.random((n, dim)) > 0.3
    shift = rng.uniform(1.0, 2.0, n).astype(np.float32)
    rel_t = tuple(tuple(int(v) for v in r) for r in rels)
    At = tbsr.BandedBSR(band=torch.as_tensor(band), rels=rel_t, grid_dims=dims)
    Aj = jbsr.BandedBSR(band=jnp.asarray(band), rels=rel_t, grid_dims=dims)

    def close(got, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    close(tbsr.matvec(At, torch.as_tensor(x)), jbsr.matvec(Aj, jnp.asarray(x)))
    close(tbsr.to_dense(At), jbsr.to_dense(Aj))
    Mt = tbsr.add_diagonal(tbsr.apply_dof_masks(At, torch.as_tensor(free)), torch.as_tensor(shift))
    Mj = jbsr.add_diagonal(jbsr.apply_dof_masks(Aj, jnp.asarray(free)), jnp.asarray(shift))
    close(Mt.band, Mj.band)
    r0 = rel_t.index((0,) * dim)
    close(tbsr.block_jacobi_inverse(Mt.band[:, r0], torch.as_tensor(free), torch.as_tensor(shift)),
          jbsr.block_jacobi_inverse(Mj.band[:, r0], jnp.asarray(free), jnp.asarray(shift)))


def _problem():
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=9, n_side=14, n_particles=180)
    rng = np.random.default_rng(10)
    return with_fields(pj, tp, v=(0.02 * rng.standard_normal((pj.count, 2))).astype(np.float32),
                       a=(5.0 * rng.standard_normal((pj.count, 2))).astype(np.float32),
                       vol0=np.full(pj.count, gj.spacing ** 2 / 4, np.float32)), (gj, bj, lj), (
        tg, tb, lt)


@pytest.mark.parametrize("quasi_static", [False, True])
def test_assembled_tangent_matvec_matches_jv(quasi_static, monkeypatch):
    """J = Σ_p H·∇N (+ α₁M), Dirichlet rows and columns masked, applied by
    the band, equals the Newton-CG's J·v on the free dofs (float64, a
    Dirichlet strip, the first iterate dU = 0)."""
    (_, tp), (_, _, _), (tg, tb, lt) = _problem()
    _, mt = neo_hookean_tables()
    tp = tp.map_tensors(lambda a: a.double() if a.is_floating_point() else a)
    mt = mt.map_tensors(lambda a: a.double() if a.is_floating_point() else a)
    fixed = np.zeros((tg.n_nodes, 2), bool)
    fixed.reshape(14, 14, 2)[:, :4, 1] = True
    tg = tg.replace(dirichlet_mask=torch.as_tensor(fixed),
                    dirichlet_value=torch.zeros((tg.n_nodes, 2), dtype=torch.float64))
    cfg = tim.ImplicitConfig(dt=0.5 * tg.spacing / np.sqrt(1e3), lme_params=lt, active_box=tb,
                             transfer="windowed", quasi_static=quasi_static, newton_maxiter=0)
    A, aux = tim.assemble_tangent(tp, tg, mt, cfg)
    seen = {}
    real = solvers.newton_krylov

    def spy(residual, x0, **kw):
        seen["residual"], seen["x0"] = residual, x0
        return real(residual, x0, **kw)

    monkeypatch.setattr(solvers, "newton_krylov", spy)
    tim.implicit_step(tp, tg, mt, cfg, torch.zeros(2, dtype=torch.float64))
    v = torch.as_tensor(np.random.default_rng(21).standard_normal((tg.n_nodes, 2)))
    Jv = solvers.jvp(seen["residual"], seen["x0"], v)[1]
    free = aux["free"].expand(-1, 2)
    Av = torch.where(free, tbsr.matvec(A, v), torch.zeros_like(v))
    assert float(Jv.abs().max()) > 0.0 and bool((~free).any())
    torch.testing.assert_close(Av, Jv, rtol=1e-8, atol=1e-8 * float(Jv.abs().max()))


def test_block_jacobi_windowed_step_matches_jax():
    (pj, tp), (gj, bj, lj), (tg, tb, lt) = _problem()
    mj, mt = neo_hookean_tables()
    cfg_j, cfg_t = implicit_configs(gj, bj, lj, transfer="windowed", precond="block-jacobi",
                                    cg_maxiter=100)
    body = np.asarray([0.0, -9.81], np.float32)
    pj, dj = jax.jit(jim.implicit_step, static_argnums=(3,))(pj, gj, mj, cfg_j,
                                                             jnp.asarray(body))
    tp, dt_ = tim.implicit_step(tp, tg, mt, cfg_t, torch.as_tensor(body))
    assert int(dt_["nnz"]) == int(dj["nnz"])
    assert dt_["newton_iters"] == int(dj["newton_iters"]) >= 2
    assert bool(dt_["converged"]) and bool(dj["converged"])
    got, ref = by_pid(tp), by_pid(pj)
    for name, tol in dict(x=dict(rtol=1e-4, atol=1e-6), v=dict(rtol=1e-3, atol=1e-5),
                          F=dict(rtol=1e-3, atol=1e-5)).items():
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)
