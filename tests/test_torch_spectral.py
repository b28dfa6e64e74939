"""The port's invariants, symmetric eigen solvers and spectral helpers
(``ops/tensor.py``, ``models/spectral.py``) against the JAX package's on the
same numpy inputs, in float32 and float64, 2D and 3D.  Eigenvectors of a
repeated eigenvalue are not unique, so the rebuilt tensor V·diag(w)·Vᵀ is
compared, never V.  Tolerances: rtol 1e-5 (float32) and 1e-12 (float64),
each with an absolute floor of that size times the largest magnitude."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.models import spectral as jspec
from nlpartsol_tpu.ops import tensor as jtn

from nlpartsol_tpu_torch.models import spectral as tspec
from nlpartsol_tpu_torch.ops import tensor as ttn

from _torch_port import cheap_jax_compiles  # noqa: F401

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}


def _close(got, ref, tol, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=err_msg)


def _symmetric(dim, dtype, seed):
    """Random symmetric tensors over four decades, then the special rows:
    the zero tensor, multiples of the identity (a triple eigenvalue), two
    equal eigenvalues, and a diagonal tensor."""
    rng = np.random.default_rng(seed)
    n = 64
    scale = np.repeat([1e-4, 1e-2, 1.0, 1e2], n // 4)[:, None, None]
    a = rng.standard_normal((n, dim, dim)) * scale
    a = 0.5 * (a + np.swapaxes(a, -1, -2))
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    w2 = np.array([1.0, 1.0, 3.0][:dim])
    a[0] = 0.0
    a[1] = 2.5 * np.eye(dim)
    a[2] = q @ np.diag(w2) @ q.T
    a[3] = np.diag(np.arange(1.0, dim + 1.0))
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_invariants_match_jax(dtype):
    for dim in (2, 3):
        a = (np.eye(dim) + 0.3 * np.random.default_rng(dim).standard_normal((40, dim, dim))
             ).astype(dtype)
        with jax.enable_x64(dtype == "float64"):
            ref = {n: getattr(jtn, n)(jnp.asarray(a))
                   for n in ("I1", "I2", "I3", "sym", "dev", "norm_fro")}
        for name, r in ref.items():
            got = getattr(ttn, name)(torch.as_tensor(a))
            assert got.dtype == torch.as_tensor(a).dtype
            _close(got, r, TOL[dtype], f"{name} {dim}D")
        eye = ttn.identity_like(torch.as_tensor(a))
        assert torch.equal(eye, torch.eye(dim, dtype=eye.dtype).expand(a.shape))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_sym_eig_matches_jax(dim, dtype):
    """Eigenvalues ascending and the rebuilt tensor as the JAX solver gives
    them (closed form in 2D, 8 Jacobi sweeps in 3D), the rebuilt tensor equal
    to the input, and sym_func through the spectrum."""
    a = _symmetric(dim, dtype, 10 + dim)
    spd = a @ a + np.eye(dim, dtype=dtype)
    # eager: the unrolled Jacobi sweeps compile for longer than they run
    with jax.enable_x64(dtype == "float64"):
        w_j, v_j = jtn.sym_eig(jnp.asarray(a))
        rebuilt_j = jtn.sym_from_eig(w_j, v_j)
        log_j = jtn.sym_func(jnp.asarray(spd), jnp.log)
    w, v = ttn.sym_eig(torch.as_tensor(a))
    assert w.dtype == v.dtype == torch.as_tensor(a).dtype
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    tol = TOL[dtype]
    _close(w, w_j, tol, "eigenvalues")
    rebuilt = ttn.sym_from_eig(w, v)
    _close(rebuilt, rebuilt_j, tol, "rebuilt")
    _close(rebuilt, a, 10 * tol, "rebuilt vs input")
    assert float(rebuilt[0].abs().max()) == 0.0  # the zero tensor
    np.testing.assert_allclose(w[1].numpy(), 2.5, rtol=tol)  # the identity multiple
    log_t = ttn.sym_func(torch.as_tensor(spd), torch.log)
    _close(log_t, log_j, 10 * tol, "sym_func log")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spectral_helpers_match_jax(dtype):
    """trial_bemi (with the plane-strain zz channel appended in 2D),
    hencky_from_wm1, wm1_from_hencky and rebuild, at rest and at finite
    strain; in 3D also against numpy's float64 eigensolver."""
    tol = TOL[dtype]
    for dim in (2, 3):
        rng = np.random.default_rng(20 + dim)
        n = 48
        e = rng.standard_normal((n, dim, dim)) * np.repeat([1e-6, 1e-3, 0.1], n // 3)[:, None, None]
        bemi = (0.5 * (e + np.swapaxes(e, -1, -2))).astype(dtype)
        bemi[:4] = 0.0
        bemi_zz = (1e-2 * rng.standard_normal(n)).astype(dtype)
        DF = (np.eye(dim) + 1e-2 * rng.standard_normal((n, dim, dim))).astype(dtype)
        DF[:4] = np.eye(dim)  # rest rows: b_e^tr − I = 0, equal eigenvalues
        if dim == 2:
            def ref(b, bz, df):
                wm1_j, V_j = jspec.trial_bemi(b, bz, df)
                Eh_j = jspec.hencky_from_wm1(wm1_j)
                return wm1_j, Eh_j, jspec.wm1_from_hencky(Eh_j), *jspec.rebuild(Eh_j, V_j)

            with jax.enable_x64(dtype == "float64"):
                wm1_j, Eh_j, back_j, in_j, zz_j = jax.jit(ref)(
                    jnp.asarray(bemi), jnp.asarray(bemi_zz), jnp.asarray(DF))
        else:
            # numpy's float64 eigensolver (the JAX one's unrolled Jacobi
            # sweeps take seconds eagerly, more to compile)
            b, df = bemi.astype(np.float64), DF.astype(np.float64)
            tr = df @ b @ np.swapaxes(df, -1, -2) + df @ np.swapaxes(df, -1, -2) - np.eye(3)
            w, vec = np.linalg.eigh(tr)
            wm1_j, Eh_j = w, 0.5 * np.log1p(w)
            back_j = np.expm1(2.0 * Eh_j)
            in_j, zz_j = (vec * Eh_j[:, None, :]) @ np.swapaxes(vec, -1, -2), Eh_j[:, 2]
        wm1, V = tspec.trial_bemi(*(torch.as_tensor(x) for x in (bemi, bemi_zz, DF)))
        assert wm1.shape == (n, 3)
        _close(wm1, wm1_j, tol, f"trial eigenvalues {dim}D")
        Eh = tspec.hencky_from_wm1(wm1)
        _close(Eh, Eh_j, tol, f"Hencky strains {dim}D")
        _close(tspec.wm1_from_hencky(Eh), back_j, tol, f"inverse map {dim}D")
        inplane, zz = tspec.rebuild(Eh, V)
        _close(inplane, in_j, tol, f"rebuild {dim}D")
        _close(zz, zz_j, tol, f"rebuild zz {dim}D")
        assert float(inplane[:4].abs().max()) == 0.0
