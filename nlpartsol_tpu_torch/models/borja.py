"""Borja (2003) frictional family: Matsuoka-Nakai / Lade-Duncan /
Modified-Lade-Duncan yield with a monolithic 5x5 Newton return mapping in
principal stress space — batched.

Counterpart of ``nlpartsol_tpu/models/borja.py``:

  trial principal Kirchhoff stress T_tr = AA·E_h^tr − c·cotφ
  yield  MN: F = ∛((9+κ_φ)·I3) − ∛(I1·I2)
         LD: F = ∛((27+κ_φ)·I3) − I1
         MLD: LD with K = 27 + κ_φ·(pa/I1)^m
  hardening κ_φ = a0·Λ·exp(a1·I1)·exp(−a2·Λ), κ_ψ = α·κ_φ
  unknowns z = (T₁,T₂,T₃, κ_φ, Δλ); residual
    R = [CC·(T+c·cotφ) − E_h^tr + Δλ·∂G/∂T ;  κ_φ − κ̂(Λ,I1) ;  F]
  masked fixed-count 5x5 Newton with a fixed backtracking candidate set;
  apex collapse when |tr(T)/3| < 0.1; b_e corrector from E_h(T).

Every per-particle parameter broadcasts on the particle axis (``m[..., None]``
beside a principal-space (..., 3) array), so the models run at any particle
count: the JAX function's Modified-Lade-Duncan ``ddG_ddT`` subtracts an (Np,)
``m`` from an (Np, 3) array, which fails unless Np is 3 (and at Np = 3
broadcasts along the wrong axis).  The 5x5 systems are solved by Gaussian
elimination with partial pivoting written out in tensor code (the pivoting
of LAPACK's getrf, which the JAX function reaches): no LAPACK or cuSOLVER
call, no error status read back to the host.  The implicit steps' tangent
is the forward-mode derivative of this update through
``spectral.trial_update``, the 5x5 Newton, its backtracking and the
elimination included; the JAX function's assembled ``C_ep`` is not
computed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config
from ..ops import tensor as tn
from .materials import lame_parameters
from .spectral import hencky_from_wm1, trial_update, wm1_from_hencky

Tensor = torch.Tensor

TOL_APEX = 0.1


class BorjaOut(NamedTuple):
    tau: Tensor
    tau_zz: Tensor
    bemi: Tensor
    bemi_zz: Tensor
    eps: Tensor  # Λ (total plastic multiplier)
    kappa: Tensor  # κ_φ
    W: Tensor


def _safe(x, eps=1e-8):
    small = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(torch.abs(x) < eps, small, x)


def _invariants(T):
    I1 = torch.sum(T, dim=-1)
    I2 = T[..., 0] * T[..., 1] + T[..., 1] * T[..., 2] + T[..., 0] * T[..., 2]
    I3 = T[..., 0] * T[..., 1] * T[..., 2]
    return I1, I2, I3


def _kappa_hat(a1_, a2_, a3_, Lam, I1):
    """κ̂_φ = a0·Λ·e^{a1·I1}·e^{−a2·Λ}."""
    return a1_ * Lam * torch.exp(a2_ * I1) * torch.exp(-a3_ * Lam)


def _d_kappa_d_I1(a1_, a2_, a3_, Lam, I1):
    return a1_ * a2_ * Lam * torch.exp(a2_ * I1) * torch.exp(-a3_ * Lam)


def _d_kappa_d_lambda(a1_, a2_, a3_, Lam, I1):
    return (1.0 - a3_ * Lam) * a1_ * torch.exp(a2_ * I1) * torch.exp(-a3_ * Lam)


def _cbrt(x):
    """Real cube root (negative for negative x), as ``jnp.cbrt``: the bits
    of sign(x)·|x|^⅓, without the multiply by sign(x), whose forward-mode
    tangent is a zero tensor (an op on one takes a slow path on the
    host)."""
    a = torch.abs(x) ** (1.0 / 3.0)
    return torch.where(x < 0, -a, a)


def _main_hessian(K2, I3, Ts):
    """∂²∛(K₂·I3)/∂T² at fixed K₂, with the principal stresses kept off 0."""
    eye = torch.eye(3, dtype=Ts.dtype, device=Ts.device)
    return (1.0 / 3.0) * _cbrt(K2 * I3)[..., None, None] * (
        1.0 / (3.0 * Ts[..., :, None] * Ts[..., None, :]) - eye / (Ts[..., :, None] ** 2)
    )


class _Principal:
    """Principal stresses T with the quantities every yield function reads
    (I1, I2, I3, T kept off 0, ∛I3), computed once per T; functions of T
    alone are kept in ``cache``.  The arithmetic is the JAX functions', each
    quantity evaluated once instead of once per use."""

    __slots__ = ("T", "I1", "I2", "I3", "Ts", "cbrt_I3", "cache")

    def __init__(self, T):
        self.T = T
        self.I1, self.I2, self.I3 = _invariants(T)
        self.Ts = _safe(T)
        self.cbrt_I3 = _cbrt(self.I3)
        self.cache = {}


def _yield_fns(kind: str, pa=0.0, m=0.0):
    """Returns (F, dF_dT, dF_dkappa, dG_dT, ddG_ddT, ddG_dT_dkpsi), each a
    function of a :class:`_Principal` and κ.

    ``pa``/``m`` (atmospheric pressure / pressure-sensitivity exponent) are
    only used by the modified-lade-duncan branch: K = c0 + κ·(pa/I1)^m."""
    if kind == "matsuoka-nakai":

        def F(P, kap):
            return _cbrt((9.0 + kap) * P.I3) - _cbrt(P.I1 * P.I2)

        def grad_f(P):
            if "grad_f" not in P.cache:
                I1, I2 = P.I1, P.I2
                denom = 3.0 * _cbrt(_safe(I1 * I2)) ** 2
                P.cache["grad_f"] = (I1[..., None] * (I1[..., None] - P.T) + I2[..., None]) / _safe(
                    denom)[..., None]
            return P.cache["grad_f"]

        def dF_dT(P, kap):
            return _cbrt((9.0 + kap) * P.I3)[..., None] / (3.0 * P.Ts) - grad_f(P)

        def dF_dkappa(P, kap):
            return (1.0 / 3.0) * _cbrt(_safe(9.0 + kap)) ** (-2.0) * P.cbrt_I3

        dG_dT = dF_dT

        def ddG_ddT(P, kpsi):
            I1, T = P.I1, P.T
            dg = grad_f(P)
            i1i2 = _safe(I1 * P.I2)
            # dd_g: ∂²∛(I1·I2)
            TA = T[..., :, None]
            TB = T[..., None, :]
            eye = torch.eye(3, dtype=T.dtype, device=T.device)
            dd_g = (
                (_cbrt(i1i2) ** (-2.0) / 3.0)[..., None, None]
                * (3.0 * I1[..., None, None] - TA - TB - I1[..., None, None] * eye)
                - (2.0 / _cbrt(i1i2))[..., None, None] * dg[..., :, None] * dg[..., None, :]
            )
            return _main_hessian(9.0 + kpsi, P.I3, P.Ts) - dd_g

        def ddG_dT_dkpsi(P, kpsi):
            return (P.cbrt_I3[..., None] / (3.0 * P.Ts)) / (
                3.0 * _cbrt(_safe(9.0 + kpsi))[..., None] ** 2
            )

    elif kind == "lade-duncan":

        def F(P, kap):
            return _cbrt((27.0 + kap) * P.I3) - P.I1

        def dF_dT(P, kap):
            return _cbrt((27.0 + kap) * P.I3)[..., None] / (3.0 * P.Ts) - 1.0

        def dF_dkappa(P, kap):
            return (1.0 / 3.0) * _cbrt(_safe(27.0 + kap)) ** (-2.0) * P.cbrt_I3

        dG_dT = dF_dT

        def ddG_ddT(P, kpsi):
            return _main_hessian(27.0 + kpsi, P.I3, P.Ts)

        def ddG_dT_dkpsi(P, kpsi):
            return (P.cbrt_I3[..., None] / (3.0 * P.Ts)) / (
                3.0 * _cbrt(_safe(27.0 + kpsi))[..., None] ** 2
            )

    elif kind == "modified-lade-duncan":
        # K = 27 + κ·(pa/I1)^m; pressure-sensitive Lade-Duncan cone.
        # b = m·κ·(pa/I1)^m·(∛I3/I1) is the I1-derivative correction.

        def pw(P):
            # (pa/I1)^m — both pa and I1 are negative in compression, so
            # the ratio is positive; floor it against stray tensile states
            if "pw" not in P.cache:
                P.cache["pw"] = torch.pow(torch.clamp(pa / _safe(P.I1), min=1e-12), m)
            return P.cache["pw"]

        def F(P, kap):
            return _cbrt((27.0 + kap * pw(P)) * P.I3) - P.I1

        def dF_dT(P, kap):
            I1, I3 = P.I1, P.I3
            K1 = 27.0 + kap * pw(P)
            b1 = m * kap * pw(P) * P.cbrt_I3 / _safe(I1)
            return (
                _cbrt(K1 * I3)[..., None] / (3.0 * P.Ts)
                - (b1 / (3.0 * _cbrt(_safe(K1)) ** 2))[..., None]
                - 1.0
            )

        def dF_dkappa(P, kap):
            K1 = 27.0 + kap * pw(P)
            return P.cbrt_I3 / (3.0 * _cbrt(_safe(K1)) ** 2) * pw(P)

        dG_dT = dF_dT

        def ddG_ddT(P, kpsi):
            I1, I3, Ts = P.I1, P.I3, P.Ts
            K2 = 27.0 + kpsi * pw(P)
            b2 = m * kpsi * pw(P) * P.cbrt_I3 / _safe(I1)
            dK2 = -(m * kpsi / _safe(I1)) * pw(P)  # same for every comp.
            # m on the particle axis beside the (..., 3) principal array
            db2_B = (b2 / _safe(I1))[..., None] * (I1[..., None] / (3.0 * Ts) - m[..., None] - 1.0)
            K2s = _safe(K2)
            second = (
                (P.cbrt_I3[..., None] / Ts + (2.0 * b2 / K2s)[..., None])[..., :, None]
                * dK2[..., None, None]
                / (9.0 * _cbrt(K2s)[..., None, None] ** 2)
            )
            third = db2_B[..., None, :] / (3.0 * _cbrt(K2s)[..., None, None] ** 2)
            return _main_hessian(K2, I3, Ts) + second - third

        def ddG_dT_dkpsi(P, kpsi):
            I1 = P.I1
            K2 = 27.0 + kpsi * pw(P)
            b2 = m * kpsi * pw(P) * P.cbrt_I3 / _safe(I1)
            K2s = _safe(K2)
            return (
                pw(P)[..., None]
                * (
                    P.cbrt_I3[..., None] / (3.0 * P.Ts)
                    + (2.0 * b2 / (3.0 * K2s))[..., None]
                    - (m * P.cbrt_I3 / _safe(I1))[..., None]
                )
                / (3.0 * _cbrt(K2s)[..., None] ** 2)
            )

    else:
        raise ValueError(f"unknown Borja yield kind: {kind}")

    return F, dF_dT, dF_dkappa, dG_dT, ddG_ddT, ddG_dT_dkpsi


def solve_small(A: Tensor, b: Tensor) -> Tensor:
    """x with A·x = b for a batch of small dense systems, (..., n, n) and
    (..., n): Gaussian elimination with partial pivoting (the largest
    magnitude in the column, first on ties), unrolled over n."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)  # (..., n, n+1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        piv = torch.argmax(torch.abs(M[..., k:, k]), dim=-1) + k
        row_k = M[..., k, :]
        row_p = torch.gather(M, -2, piv[..., None, None].expand(*piv.shape, 1, n + 1))
        M = torch.where((rows == piv[..., None])[..., None], row_k[..., None, :], M)
        M = torch.where((rows == k)[:, None], row_p, M)
        factor = M[..., k + 1 :, k] / M[..., k, k][..., None]
        M = torch.cat(
            [M[..., : k + 1, :], M[..., k + 1 :, :] - factor[..., None] * M[..., k : k + 1, :]],
            dim=-2,
        )
    x = [None] * n
    for i in reversed(range(n)):
        s = M[..., i, n]
        for j in range(i + 1, n):
            s = s - M[..., i, j] * x[j]
        x[i] = s / M[..., i, i]
    return torch.stack(x, dim=-1)


def borja_frictional(
    bemi,
    bemi_zz,
    DF,
    eps,
    kappa,
    *,
    yield_kind: str,
    E,
    nu,
    m,
    phi,
    a1,
    a2,
    a3,
    alpha,
    cohesion=0.0,
    pa=0.0,
    n_iter: int = 30,
    tol: float = 1e-10,
) -> BorjaOut:
    """Batched Borja stress update.  ``eps`` carries Λ; ``kappa`` carries
    κ_φ.  The reference's c0 and ψ parameters are hard-coded constants of
    its MN/LD/MLD paths, so they are not arguments here."""
    dt, dev = eps.dtype, eps.device

    lam_e, G_e = lame_parameters(E, nu)
    rad_phi = torch.deg2rad(phi)
    c_cotphi = torch.where(
        rad_phi > 0.0, cohesion / torch.tan(_safe(rad_phi)), torch.zeros_like(rad_phi)
    )

    # elastic stiffness AA / compliance CC in principal space (3x3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    ones3 = torch.ones((3, 3), dtype=dt, device=dev)
    AA = lam_e[..., None, None] * ones3 + 2.0 * G_e[..., None, None] * eye3
    CC = (1.0 / E)[..., None, None] * eye3 + (-nu / E)[..., None, None] * (ones3 - eye3)

    def principal(wm1, AA, CC, c_cotphi, eps, kappa, a1, a2, a3, alpha, pa, m):
        F, dF_dT, dF_dkappa, dG_dT, ddG_ddT, ddG_dT_dkpsi = _yield_fns(yield_kind, pa=pa, m=m)
        Eh_tr = hencky_from_wm1(wm1)  # (..., 3)

        T_tr = tn.bmv(AA, Eh_tr) - c_cotphi[..., None]

        Lam_n = eps
        kap_n = kappa
        P_tr = _Principal(T_tr)
        F0 = F(P_tr, kap_n)
        plastic = F0 > config.TOL_NR
        F0_safe = torch.where(F0 == 0.0, torch.ones_like(F0), F0)

        def residual(P, kap, dlam, Lam, dGdT):
            Eh_k = tn.bmv(CC, P.T + c_cotphi[..., None])
            kap_hat = _kappa_hat(a1, a2, a3, Lam, P.I1)
            r_strain = Eh_k - Eh_tr + dlam[..., None] * dGdT
            R = torch.cat([r_strain, (kap - kap_hat)[..., None], F(P, kap)[..., None]], dim=-1)
            return torch.sqrt(torch.sum(R * R, dim=-1)), R

        nR0, _ = residual(P_tr, kap_n, torch.zeros_like(F0), Lam_n, dG_dT(P_tr, alpha * kap_n))
        nR0_safe = torch.where(nR0 == 0.0, torch.ones_like(nR0), nR0)

        T, kap, dlam = T_tr, kap_n, torch.zeros_like(F0)
        done, apexed = torch.zeros_like(plastic), torch.zeros_like(plastic)
        inf = torch.full((), float("inf"), dtype=dt, device=dev)
        # fixed backtracking candidates, on a leading axis
        deltas = torch.tensor((1.0, 0.5, 0.25, 0.0625), dtype=dt, device=dev)
        deltas = deltas.reshape((4,) + (1,) * F0.ndim)
        for _ in range(n_iter):
            Lam = Lam_n + dlam
            P = _Principal(T)
            kpsi = alpha * kap
            dGdT = dG_dT(P, kpsi)
            nR, R = residual(P, kap, dlam, Lam, dGdT)
            # R's last entry is the yield function F(T, κ_φ)
            converged = (torch.abs(nR / nR0_safe) < tol) | (torch.abs(R[..., 4] / F0_safe) < tol)
            live = plastic & ~done & ~converged & ~apexed

            dk_dI1 = _d_kappa_d_I1(a1, a2, a3, Lam, P.I1)
            dk_dlam = _d_kappa_d_lambda(a1, a2, a3, Lam, P.I1)

            # the (..., 5, 5) tangent, row by row
            lead = dlam.shape
            row_T = torch.cat(
                [
                    CC.expand(*lead, 3, 3) + dlam[..., None, None] * ddG_ddT(P, kpsi),
                    (alpha * dlam)[..., None, None] * ddG_dT_dkpsi(P, kpsi)[..., None],
                    dGdT[..., None],
                ],
                dim=-1,
            )
            one, zero = torch.ones_like(dlam), torch.zeros_like(dlam)
            row_k = torch.stack([-dk_dI1, -dk_dI1, -dk_dI1, one, -dk_dlam], dim=-1)
            # the (4,4) zero regularised for solvability
            row_F = torch.cat(
                [dF_dT(P, kap), torch.stack([dF_dkappa(P, kap), zero + 1e-14], dim=-1)], dim=-1
            )
            Tg = torch.cat([row_T, row_k[..., None, :], row_F[..., None, :]], dim=-2)
            dz = solve_small(Tg, R)

            # fixed backtracking: the candidate steps side by side on a leading
            # axis, the first of the smallest residual norms taken
            T_c = T - deltas[..., None] * dz[..., :3]
            kap_c = kap - deltas * dz[..., 3]
            dlam_c = dlam - deltas * dz[..., 4]
            P_c = _Principal(T_c)
            n_c, _ = residual(P_c, kap_c, dlam_c, Lam_n + dlam_c, dG_dT(P_c, alpha * kap_c))
            n_c = torch.where(Lam_n + dlam_c < 0.0, inf, n_c)  # forbid Λ < 0
            all_neg = torch.all(torch.isinf(n_c), dim=0)
            best = torch.argmin(n_c, dim=0, keepdim=True)
            T_new = torch.gather(T_c, 0, best[..., None].expand(1, *T.shape))[0]
            kap_new = torch.gather(kap_c, 0, best)[0]
            dlam_new = torch.gather(dlam_c, 0, best)[0]

            # apex collapse
            hit_apex = torch.abs(torch.mean(T_new, dim=-1)) < TOL_APEX
            T_new = torch.where(hit_apex[..., None], torch.zeros_like(T_new), T_new)
            kap_new = torch.where(hit_apex, kap_n, kap_new)
            dlam_new = torch.where(hit_apex, zero, dlam_new)

            T = torch.where(live[..., None], T_new, T)
            kap = torch.where(live, kap_new, kap)
            dlam = torch.where(live, dlam_new, dlam)
            done = done | (live & all_neg) | converged
            apexed = apexed | (live & hit_apex)

        T_fin = torch.where(plastic[..., None], T, T_tr)
        kap_fin = torch.where(plastic, kap, kap_n)
        Lam_fin = torch.where(plastic & ~apexed, Lam_n + dlam, Lam_n)

        # outputs: nominal stress adds back c·cotφ
        T_out = T_fin + c_cotphi[..., None]
        Eh_k = tn.bmv(CC, T_out)
        W = 0.5 * torch.sum(T_out * Eh_tr, dim=-1)
        return (wm1_from_hencky(Eh_k), T_out), (Lam_fin, kap_fin, W)

    ((bemi_new, bemi_zz_new), (tau, tau_zz)), (Lam_fin, kap_fin, W) = trial_update(
        bemi, bemi_zz, DF, principal, AA, CC, c_cotphi, eps, kappa, a1, a2, a3, alpha, pa, m)
    return BorjaOut(tau, tau_zz, bemi_new, bemi_zz_new, Lam_fin, kap_fin, W)
