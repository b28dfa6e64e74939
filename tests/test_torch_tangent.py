"""The tangent of the stress update, the one derivative the implicit, u-p,
u-pw and DEM steps take (their J·v is forward mode through
``models.dispatch.stress_integration``), for every material kind in 2D and
3D:

* in float64, the port's J·v against a central difference of its own
  update, within 1e-6 of each row's largest magnitude, at a general state
  with history, at a diagonal state (b_e and ΔF diagonal) and at rest
  (F = I, isotropic b_e), the last two being where forward mode through the
  eigenvectors fails (ROADMAP.md queue 3);
* in float32, the port's J·v and its primal outputs against the JAX
  package's ``jax.jvp`` of its dispatch at the general state;
* the JAX package's own J·v at rest in 2D (non-finite) and at a diagonal
  state (no shear term), so that the queue-3 entry stays true.

The central difference takes steps h and h/2: h = 1e-4 for the smooth
kinds, 1e-8 for the fluids at rest (the Papanastasiou viscosity's slope in
|d| leaves a first-order error there), and for the plastic kinds 1e-6 at the
general state, whose kinks a larger step would straddle, and 1e-5 at the
diagonal and rest states, whose rows are all plastic or all elastic (near a
diagonal tensor the eigenvectors of the perturbed primal carry a rounding
of eps·|A|/|A01| that a smaller step amplifies).  The J·v is held against
the second, beyond its truncation error (estimated as 2/3 of their
difference) and its rounding.  A row where the two differ by more than KINK
(or, for a plastic kind, its one-sided differences by more than ONE_SIDED)
straddles a branch of a return mapping (or, for the Borja family, a Newton
that has not settled) and has no derivative to compare; such rows are
counted and may only occur in a plastic kind's rows away from rest, at most
a quarter of them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.models import dispatch as jcon, materials as jM

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.models import dispatch as tcon
from nlpartsol_tpu_torch.ops import solvers

from _torch_port import cheap_jax_compiles, fields_to_numpy  # noqa: F401
from test_torch_models_more import ROWS

torch.set_num_threads(1)

N = 24  # rows a kind
TOL = 1e-6
# two central differences of a row that disagree by more than this share
# straddle a kink (a branch of a return mapping, a Newton not settled)
KINK = 1e-4
# or whose one-sided differences disagree by more than this (h·f''/f' is
# about 1e-3 on strains of 1e-3; a kink changes the slope by the order of 1)
ONE_SIDED = 5e-2
PLASTIC = (6, 7, 8, 9, 10)  # von Mises, Drucker-Prager, the Borja family
FRICTIONAL = (8, 9, 10)
FLUIDS = (5, 11)
# the state the steps carry (W, the models' energy, is left out: its primal
# carries the cancellations of I1 − 3 and F − I, and at rest its tangent is
# zero, so a difference reads rounding and its own second order)
FIELDS = ("tau", "tau_zz", "bemi", "bemi_zz", "eps", "kappa", "back_stress")
# float32 J·v against the JAX package's at the general state, each row's
# largest difference over the largest magnitude of the field: the largest
# row, and for the Borja family (whose float32 Newton scatters in both
# packages, tests/torch_models_probe.py borja-f32) the median row
F32_TOL = dict(max=2e-3, borja_median=2e-3)


def _table(dtype):
    arrays = {k: (v if k == "kind" else v.astype(dtype)) for k, v in fields_to_numpy(
        jM.material_table([jM.material(**r) for r in ROWS])).items()}
    return arrays


def _fields(dim):
    """The outputs whose tangents are compared: in 3D the zz channels are
    the third principal values, not a field of the state."""
    return tuple(f for f in FIELDS if dim == 2 or not f.endswith("_zz"))


def _inputs(dim, code, state, seed):
    """(arrays, X0, V): one kind's history and fixed kinematics, the
    displacement gradient X0 of the state and a direction V.  The stress
    update is a function of X: ΔF = I + X, F = ΔF·F_n, Ḟ = Ḟ_n + X."""
    rng = np.random.default_rng(seed)
    eye = np.eye(dim)
    vol = -2e-3 if code in FRICTIONAL else 0.0
    lam0 = rng.uniform(0.5, 1.5, N) if state == "general" else np.ones(N)
    eps = lam0 if code in FRICTIONAL else np.zeros(N)
    kappa = (1e3 * np.sqrt(1.0 + eps / 0.01) if code == 7
             else 10.0 * lam0 * np.exp(-0.8 * lam0))  # on the hardening laws
    if state == "general":
        F_n = eye + 2e-3 * rng.standard_normal((N, dim, dim))
        e = 1e-3 * rng.standard_normal((N, dim, dim)) * (2.0 if code in FRICTIONAL else 1.0)
        bemi = np.expm1(2.0 * (0.5 * (e + np.swapaxes(e, -1, -2)) + vol * eye))
        X0 = 1e-3 * rng.standard_normal((N, dim, dim))
        if code not in FRICTIONAL:
            eps = rng.uniform(0.0, 0.01, N)
        back = 1e2 * rng.standard_normal((N, 3))
        dFdt = 0.3 * rng.standard_normal((N, dim, dim))
    else:
        F_n = np.broadcast_to(eye, (N, dim, dim))
        bemi = np.broadcast_to(np.expm1(2.0 * vol) * eye, (N, dim, dim))
        X0 = np.zeros((N, dim, dim))
        if state == "diagonal":
            # the frictional kinds' Newton settles at a smaller plastic flow
            X0[:] = np.diag([1.0, -1.0, 0.0][:dim]) * (1e-3 if code in FRICTIONAL else 1e-2)
        back, dFdt = np.zeros((N, 3)), np.zeros((N, dim, dim))
    arrays = dict(F_n=F_n, dFdt=dFdt, bemi=bemi,
                  bemi_zz=np.full(N, np.expm1(2.0 * vol) * (dim == 2)), eps=eps, kappa=kappa,
                  back_stress=back)
    return ({k: np.ascontiguousarray(v) for k, v in arrays.items()}, X0,
            rng.standard_normal((N, dim, dim)))


def _port_fn(arrays, code, dtype, kinds=None):
    """The port's update as a function of X (``code``: a kind, or per-row
    kinds with ``kinds`` the codes present)."""
    mats = convert.materials_from_numpy(_table(dtype), device="cpu")
    t = {k: torch.as_tensor(v.astype(dtype)) for k, v in arrays.items()}
    dim = t["F_n"].shape[-1]
    eye = torch.eye(dim, dtype=t["F_n"].dtype)
    n = len(t["eps"])
    mid = torch.as_tensor(np.broadcast_to(code, (n,)).astype(np.int32))
    kinds = (code,) if kinds is None else kinds

    def f(X):
        DF = eye + X
        cs = tcon.stress_integration(
            F_n1=DF @ t["F_n"], DF=DF, dFdt_n1=t["dFdt"] + X, bemi=t["bemi"],
            bemi_zz=t["bemi_zz"], eps=t["eps"], kappa=t["kappa"], back_stress=t["back_stress"],
            mat_id=mid, mats=mats, kinds=kinds)
        return torch.cat([getattr(cs, k).reshape(n, -1) for k in _fields(dim)], dim=1)

    return f


def _columns(dim):
    """The column slices of each field in the concatenated output."""
    sizes = dict(tau=dim * dim, bemi=dim * dim, back_stress=3)
    out, at = {}, 0
    for k in _fields(dim):
        out[k] = slice(at, at + sizes.get(k, 1))
        at += sizes.get(k, 1)
    return out


def _row_errors(a, b, dim, primal, noise):
    """Per row, the largest over fields of |a − b| beyond the central
    difference's error (``noise``, by row or column) over the field's row
    scale: its largest magnitude in b's row, floored at 1e-3 of the field's
    largest in b and in the primal output over all rows (an elastic row's
    zero tangent of eps, or of b_e's zz channel, is zero to rounding)."""
    err = np.zeros(N)
    for sl in _columns(dim).values():
        ref = np.abs(b[:, sl])
        floor = 1e-3 * max(ref.max(), np.abs(primal[:, sl]).max(), 1e-300)
        excess = np.maximum(np.abs(a[:, sl] - b[:, sl]) - noise[..., sl], 0.0)
        err = np.maximum(err, excess.max(1) / np.maximum(ref.max(1), floor))
    return err


@pytest.mark.parametrize("state", ["general", "diagonal", "rest"])
@pytest.mark.parametrize("dim", [2, 3])
def test_jv_matches_central_difference_float64(dim, state):
    report = {}
    for code in range(len(ROWS)):
        arrays, X0, V = _inputs(dim, code, state, seed=10 * code + dim)
        f = _port_fn(arrays, code, np.float64)
        X0, V = torch.as_tensor(X0), torch.as_tensor(V)
        primal, jv = solvers.jvp(f, X0, V)
        # the same update (to rounding: a vectorised CPU exp or log may take
        # another path for another array length)
        np.testing.assert_allclose(primal.numpy(), f(X0).numpy(), rtol=1e-12, atol=1e-12)
        if code in PLASTIC:
            h = 1e-6 if state == "general" else 1e-5
        else:
            h = 1e-8 if state == "rest" and code in FLUIDS else 1e-4

        def fd(step):
            """The central difference and its rounding bound, by column."""
            up, down = f(X0 + step * V).numpy(), f(X0 - step * V).numpy()
            bound = 1e-15 * np.maximum(np.abs(up), np.abs(down)).max(0) / step
            return (up - down) / (2.0 * step), bound

        (fd1, noise1), (fd2, noise2) = fd(h), fd(0.5 * h)
        smooth = _row_errors(fd1, fd2, dim, primal.numpy(), noise1 + noise2) <= KINK
        if code in PLASTIC:  # a kink nearer than h/2 leaves the central ones equal
            ahead = ((f(X0 + h * V) - primal) / h).numpy()
            behind = ((primal - f(X0 - h * V)) / h).numpy()
            smooth &= _row_errors(ahead, behind, dim, primal.numpy(), 2.0 * noise1) <= ONE_SIDED
        # fd2's truncation error is about |fd1 − fd2|/3 (it is O(h²))
        err = _row_errors(jv.numpy(), fd2, dim, primal.numpy(),
                          noise2 + 2.0 * np.abs(fd1 - fd2) / 3.0)
        assert np.isfinite(jv.numpy()).all(), (code, state)
        report[code] = (float(err[smooth].max(initial=0.0)), int((~smooth).sum()))
        assert (err[smooth] <= TOL).all(), (code, report[code])
        if state == "rest" or code not in PLASTIC:
            assert smooth.all(), (code, report[code])
        else:
            assert (~smooth).sum() <= N // 4, (code, report[code])


def _jax_fn(arrays, code, kinds=None):
    """The JAX package's update as a function of X, as _port_fn."""
    mats = jM.MaterialTable(**{k: jnp.asarray(v) for k, v in _table(np.float32).items()})
    a = {k: jnp.asarray(v.astype(np.float32)) for k, v in arrays.items()}
    dim = a["F_n"].shape[-1]
    n = len(arrays["eps"])
    mid = jnp.asarray(np.broadcast_to(code, (n,)).astype(np.int32))
    kinds = (code,) if kinds is None else kinds

    def f(X):
        DF = jnp.eye(dim, dtype=jnp.float32) + X
        cs = jcon.stress_integration(
            F_n1=DF @ a["F_n"], DF=DF, dFdt_n1=a["dFdt"] + X, bemi=a["bemi"],
            bemi_zz=a["bemi_zz"], eps=a["eps"], kappa=a["kappa"], back_stress=a["back_stress"],
            mat_id=mid, mats=mats, kinds=kinds)
        return jnp.concatenate([getattr(cs, k).reshape(n, -1) for k in _fields(dim)], axis=1)

    return f


def test_float32_jv_and_update_match_jax_at_a_general_state():
    """Every kind the JAX dispatch runs (Modified-Lade-Duncan needs 3 rows
    there, test_torch_models_more.py), 2D and 3D, in one table: the primal
    outputs to the tolerance of test_torch_models_more.py's dispatch
    (float32: 2e-5 of each field's largest magnitude; the Borja family by
    its median row, as its float32 Newton scatters), and the J·v to
    F32_TOL.  The port's J·v is finite on every row; the JAX package's 3D
    J·v of the spectral kinds is not (its Jacobi sweeps' tangent, ROADMAP.md
    queue 3), and is compared where it is finite."""
    codes = [c for c in range(len(ROWS)) if c != 10]
    spectral = (4,) + PLASTIC
    for dim in (2, 3):
        blocks = [_inputs(dim, c, "general", seed=10 * c + dim) for c in codes]
        arrays = {k: np.concatenate([b[0][k] for b in blocks]) for k in blocks[0][0]}
        X0, V = (np.concatenate([b[i] for b in blocks]).astype(np.float32) for i in (1, 2))
        mid = np.repeat(codes, N)
        jf = _jax_fn(arrays, mid, tuple(codes))
        primal_j, jv_j = (np.asarray(a, np.float64) for a in
                          jax.jvp(jf, (X0,), (V,)))
        primal_t, jv_t = (a.double().numpy() for a in solvers.jvp(
            _port_fn(arrays, mid, np.float32, tuple(codes)), torch.as_tensor(X0),
            torch.as_tensor(V)))
        assert np.isfinite(jv_t).all(), dim
        for i, code in enumerate(codes):
            blk = slice(i * N, (i + 1) * N)
            rows = np.isfinite(jv_j[blk]).all(1)
            assert rows.all() or (dim == 3 and code in spectral), (dim, code)
            for got, ref, tol in ((primal_t[blk], primal_j[blk], 2e-5),
                                  (jv_t[blk][rows], jv_j[blk][rows], F32_TOL["max"])):
                err = np.zeros(len(ref))
                for sl in _columns(dim).values():
                    scale = max(np.abs(ref[:, sl]).max(initial=0.0), 1e-30)
                    err = np.maximum(err, np.abs(got[:, sl] - ref[:, sl]).max(1) / scale)
                if code in FRICTIONAL and len(err):
                    assert np.median(err) <= F32_TOL["borja_median"], (dim, code, err)
                else:
                    assert err.max(initial=0.0) <= tol, (dim, code, err.max(initial=0.0))


def test_jax_tangent_defect_is_kept_out():
    """ROADMAP.md queue 3: the JAX package's forward-mode tangent of the
    spectral kinds is non-finite at rest in 2D (and Bingham's at a zero
    rate), and at a diagonal state below yield it has no shear term where
    a central difference has one; the port's is finite and has it."""
    dim = 2
    for code in (4, 6, 7, 11):  # Hencky, von Mises, Drucker-Prager, Bingham
        arrays, X0, V = _inputs(dim, code, "rest", seed=code)
        _, jv_j = jax.jvp(_jax_fn(arrays, code), (jnp.asarray(X0, jnp.float32),),
                          (jnp.asarray(V, jnp.float32),))
        _, jv_t = solvers.jvp(_port_fn(arrays, code, np.float32),
                              torch.as_tensor(X0, dtype=torch.float32),
                              torch.as_tensor(V, dtype=torch.float32))
        assert not np.isfinite(np.asarray(jv_j)).all(), code
        assert torch.isfinite(jv_t).all(), code
    shear = np.zeros((N, dim, dim))
    shear[:, 0, 1] = shear[:, 1, 0] = 1.0
    for code in (4, 6):  # Hencky, von Mises below yield
        arrays, _, _ = _inputs(dim, code, "rest", seed=code)
        X0 = np.broadcast_to(np.diag([1e-3, -1e-3]), (N, dim, dim)).copy()
        with jax.enable_x64(True):
            _, jv_j = jax.jvp(_jax_fn(arrays, code), (jnp.asarray(X0, jnp.float32),),
                              (jnp.asarray(shear, jnp.float32),))
        _, jv_t = solvers.jvp(_port_fn(arrays, code, np.float64), torch.as_tensor(X0),
                              torch.as_tensor(shear))
        tau01 = _columns(dim)["tau"].start + 1
        assert float(np.abs(np.asarray(jv_j)[:, tau01]).max()) == 0.0, code
        assert float(jv_t[:, tau01].abs().min()) > 1e5, code  # 2G is 3.7e6 and 7.7e6 here
