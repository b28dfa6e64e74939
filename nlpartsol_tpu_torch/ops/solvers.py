"""Matrix-free Krylov and Newton solvers.

Counterpart of ``nlpartsol_tpu/ops/solvers.py`` (the reference's
PETSc-KSP/SNES replacement): operators are functions (a matrix-free J·v or
an assembled banded apply), never a matrix layout.

The JAX package runs each loop as a ``lax.while_loop`` on the device.  Here
each loop is a Python loop whose condition is read on the host: one sync per
CG/BiCGStab iteration (and per GMRES cycle) and one per Newton iteration,
each counted in :data:`host_syncs`.  Everything else — step lengths, the
line search's pick, the Eisenstat-Walker forcing, the stall counter — stays
on the device, and the iteration counts follow the JAX semantics exactly:
the condition is checked before each body, with the same thresholds and
guards.

With ``axis_name`` (a ``parallel.collectives.Comm``) the vectors are
grid-partitioned (a rank's halo strip: owned-complete, ghost-zero): every
dot and norm is an all-reduce of the local ones (the JAX ``_make_vdot``), and
every loop decision is taken from all-reduced scalars only, so every rank
takes the same branch and the iteration counts are equal across ranks.
"""

from __future__ import annotations

import collections
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

Tensor = torch.Tensor

#: host reads of a loop condition, by loop: ``host_syncs["krylov"]`` (one per
#: inner-solver check) and ``host_syncs["newton"]`` (one per Newton check).
host_syncs: collections.Counter = collections.Counter()


def reset_host_syncs() -> None:
    host_syncs.clear()


def _holds(cond: Tensor, loop: str) -> bool:
    """Read a device condition on the host (the one sync of a check)."""
    host_syncs[loop] += 1
    return bool(cond)


def jvp(fn: Callable[[Tensor], Tensor], x: Tensor, v: Tensor):
    """(fn(x), J_fn(x)·v) by forward-mode AD with dual tensors
    (``torch.autograd.forward_ad``).  A custom ``autograd.Function`` on the
    path (the kernels' linear wrappers, ops/fused_transfer.py) gets plain
    tensors in its ``jvp``, so it can hand their storage to a kernel."""
    with fwAD.dual_level():
        out = fwAD.unpack_dual(fn(fwAD.make_dual(x, v)))
        tangent = out.tangent
        return out.primal, torch.zeros_like(out.primal) if tangent is None else tangent


class CGResult(NamedTuple):
    x: Tensor
    iters: int
    residual: Tensor  # final ||r||


def _vdot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b)


def _make_gsum(axis_name):
    """Global sums of local partial sums over ``axis_name``'s group (one
    all-reduce for all of them); the identity without a group."""
    if axis_name is None:
        return lambda *parts: parts if len(parts) > 1 else parts[0]
    from ..parallel.collectives import all_sum

    def gsum(*parts):
        out = all_sum(list(parts), axis_name)
        return tuple(out) if len(out) > 1 else out[0]

    return gsum


def _make_vdot(axis_name):
    """Dot product, globally reduced over the group of grid-partitioned
    vectors; ``None``: one process."""
    if axis_name is None:
        return _vdot
    gsum = _make_gsum(axis_name)
    return lambda a, b: gsum(torch.sum(a * b))


def _safe(v: Tensor) -> Tensor:
    return torch.where(v == 0.0, torch.finfo(v.dtype).tiny, v)


def dense_lu(
    A: Callable[[Tensor], Tensor],
    b: Tensor,
    free_mask: Optional[Tensor] = None,
) -> CGResult:
    """Direct dense solve of the matrix-free operator (the reference's LAPACK
    ``dgetrs`` fallback): the operator is materialised column by column, one
    application per basis vector, and LU-solved — O(n²) memory, for small or
    pathological systems.  ``free_mask`` (shape of b): rows/cols outside it
    get an identity diagonal (Dirichlet handling); without it, structurally
    zero rows get one."""
    shape = b.shape
    n = b.numel()
    eye = torch.eye(n, dtype=b.dtype, device=b.device)
    cols = torch.stack([A(eye[i].reshape(shape)).reshape(-1) for i in range(n)], dim=1)
    if free_mask is not None:
        fm = free_mask.reshape(-1).to(b.dtype)
        cols = cols * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
        b = b * free_mask.reshape(shape).to(b.dtype)
    else:
        live = torch.sum(torch.abs(cols), dim=1) > 0.0
        cols = cols + torch.diag((~live).to(b.dtype))
    x = torch.linalg.solve(cols, b.reshape(-1))
    r = b.reshape(-1) - cols @ x
    return CGResult(x=x.reshape(shape), iters=1, residual=torch.sqrt(torch.sum(r * r)))


def pcg(
    A: Callable[[Tensor], Tensor],
    b: Tensor,
    M_inv: Optional[Callable[[Tensor], Tensor]] = None,
    x0: Optional[Tensor] = None,
    tol=1e-7,
    atol: float = 0.0,
    maxiter: int = 100,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Preconditioned conjugate gradients on an SPD operator; relative
    tolerance on ‖r‖ (``tol`` may be a 0-dim device tensor)."""
    _vdot = _make_vdot(axis_name)
    if M_inv is None:
        M_inv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = M_inv(r)
    p = z
    rz = _vdot(r, z)
    bnorm = torch.sqrt(_vdot(b, b))
    threshold = torch.clamp(tol * bnorm, min=atol)
    it = 0
    while it < maxiter and _holds(torch.sqrt(_vdot(r, r)) > threshold, "krylov"):
        Ap = A(p)
        pAp = _vdot(p, Ap)
        alpha = rz / torch.where(pAp == 0.0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _vdot(r, z)
        beta = rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    return CGResult(x=x, iters=it, residual=torch.sqrt(_vdot(r, r)))


def bicgstab(
    A: Callable[[Tensor], Tensor],
    b: Tensor,
    M_inv: Optional[Callable[[Tensor], Tensor]] = None,
    x0: Optional[Tensor] = None,
    tol=1e-7,
    atol: float = 0.0,
    maxiter: int = 200,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Preconditioned BiCGStab for nonsymmetric operators."""
    _vdot = _make_vdot(axis_name)
    if M_inv is None:
        M_inv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    r_hat = r
    bnorm = torch.sqrt(_vdot(b, b))
    threshold = torch.clamp(tol * bnorm, min=atol)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    it = 0
    while it < maxiter and _holds(torch.sqrt(_vdot(r, r)) > threshold, "krylov"):
        rho_new = _vdot(r_hat, r)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p = r + beta * (p - omega * v)
        p_hat = M_inv(p)
        v = A(p_hat)
        alpha = rho_new / _safe(_vdot(r_hat, v))
        s = r - alpha * v
        s_hat = M_inv(s)
        t = A(s_hat)
        omega = _vdot(t, s) / _safe(_vdot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rho = rho_new
        it += 1
    return CGResult(x=x, iters=it, residual=torch.sqrt(_vdot(r, r)))


def gmres(
    A: Callable[[Tensor], Tensor],
    b: Tensor,
    M_inv: Optional[Callable[[Tensor], Tensor]] = None,
    x0: Optional[Tensor] = None,
    tol=1e-7,
    atol: float = 0.0,
    restart: int = 20,
    max_cycles: int = 10,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Restarted GMRES(m) with right preconditioning and Givens rotations.
    Every cycle runs all ``restart`` Arnoldi steps (breakdown columns are
    guarded, not cut short), as the JAX package's fixed-shape loop does;
    the iteration count is cycles × restart."""
    _vdot = _make_vdot(axis_name)
    gsum = _make_gsum(axis_name)
    if M_inv is None:
        M_inv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    shape, n, m = b.shape, b.numel(), restart
    dt, dev = b.dtype, b.device
    threshold = torch.clamp(tol * torch.sqrt(_vdot(b, b)), min=atol)
    rows = torch.arange(m + 1, device=dev)

    def cycle(x):
        r = (b - A(x)).reshape(n)
        beta0 = torch.sqrt(gsum(torch.sum(r * r)))
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / _safe(beta0)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        cs = torch.zeros((m,), dtype=dt, device=dev)
        sn = torch.zeros((m,), dtype=dt, device=dev)
        g = torch.zeros((m + 1,), dtype=dt, device=dev)
        g[0] = beta0
        for j in range(m):
            w = A(M_inv(V[j].reshape(shape))).reshape(n)
            # modified Gram-Schmidt against all m+1 rows (rows > j are zero)
            h = torch.where(rows <= j, gsum(V @ w), torch.zeros((), dtype=dt, device=dev))
            w = w - h @ V
            h_next = torch.sqrt(gsum(torch.sum(w * w)))
            V[j + 1] = w / _safe(h_next)
            col = h.clone()
            col[j + 1] = h_next
            for i in range(j):  # previous Givens rotations
                hi, hi1 = col[i].clone(), col[i + 1].clone()
                col[i] = cs[i] * hi + sn[i] * hi1
                col[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = _safe(torch.sqrt(col[j] ** 2 + col[j + 1] ** 2))
            cj, sj = col[j] / denom, col[j + 1] / denom
            col[j] = cj * col[j] + sj * col[j + 1]
            col[j + 1] = 0.0
            cs[j], sn[j] = cj, sj
            g[j + 1] = -sj * g[j]
            g[j] = cj * g[j]
            H[:, j] = col
        R = H[:m, :]
        y = torch.zeros((m,), dtype=dt, device=dev)
        for i in range(m - 1, -1, -1):  # back-substitution, diagonal guarded
            y[i] = (g[i] - torch.sum(R[i] * y)) / _safe(R[i, i])
        return x + M_inv((y @ V[:m]).reshape(shape))

    def unconverged(x):
        r = b - A(x)
        return _holds(torch.sqrt(_vdot(r, r)) > threshold, "krylov")

    it = 0
    while it < max_cycles and unconverged(x):
        x = cycle(x)
        it += 1
    r = b - A(x)
    return CGResult(x=x, iters=it * m, residual=torch.sqrt(_vdot(r, r)))


class NewtonResult(NamedTuple):
    x: Tensor
    iters: int
    residual_norm: Tensor
    converged: Tensor  # 0-dim bool on the device
    linear_iters: int = 0  # total inner (Krylov) iterations


def newton_krylov(
    residual: Callable[[Tensor], Tensor],
    x0: Tensor,
    M_inv: Optional[Callable[[Tensor], Tensor]] = None,
    tol: float = 1e-5,
    maxiter: int = 20,
    cg_tol: float = 1e-7,
    cg_maxiter: int = 100,
    linear: str = "cg",
    axis_name: Optional[str] = None,
    forcing: str = "ew",
    threshold_mode: str = "abs1",
) -> NewtonResult:
    """Newton's method with matrix-free Jacobian-vector products: J·v is a
    forward-mode derivative of ``residual`` (:func:`jvp`), the exact
    consistent tangent.

    Convergence: ‖R‖ ≤ tol·max(1, ‖R₀‖) (``threshold_mode='abs1'``, the
    reference's SNES rtol semantics) or tol·‖R₀‖ (``'rel'``).  A stall (no
    halving of the best residual in 3 iterations) stops the loop and counts
    as converged when ‖R‖ ≤ 1e-2·‖R₀‖ (the float32 noise floor).

    ``forcing='ew'``: Eisenstat-Walker choice 2, η_k = 0.9·(‖R_k‖/‖R_{k-1}‖)²
    with the η_{k-1}² safeguard, clipped to [cg_tol, 0.5], η₀ = 0.1;
    ``'fixed'``: every inner solve to ``cg_tol``.  Each iteration takes the
    best of the step lengths {1, ½, ¼, 1/16} and evaluates the residual there
    once more."""
    if axis_name is not None and linear == "dense":
        raise ValueError("linear='dense' materialises one process's operator: "
                         "use a Krylov solver on grid-partitioned vectors")
    _vdot = _make_vdot(axis_name)
    gsum = _make_gsum(axis_name)
    r0 = residual(x0)
    r0_norm = torch.sqrt(_vdot(r0, r0))
    if threshold_mode == "rel":
        threshold = tol * r0_norm
    else:
        threshold = tol * torch.clamp(r0_norm, min=1.0)
    eta = torch.tensor(0.1 if forcing == "ew" else cg_tol, dtype=r0.dtype, device=r0.device)
    alpha_list = [1.0, 0.5, 0.25, 0.0625]
    alphas = torch.tensor(alpha_list, dtype=x0.dtype, device=x0.device)
    zero_i = torch.zeros((), dtype=torch.int32, device=r0.device)

    x, r, rnorm, best = x0, r0, r0_norm, r0_norm
    stall = zero_i
    it = lin = 0
    while it < maxiter and _holds((rnorm > threshold) & (stall < 3), "newton"):

        def Jv(v, x=x):
            return jvp(residual, x, v)[1]

        if linear == "dense":
            res_lin = dense_lu(Jv, -r)
        elif linear == "bicgstab":
            res_lin = bicgstab(Jv, -r, M_inv=M_inv, tol=eta, maxiter=cg_maxiter,
                               axis_name=axis_name)
        elif linear == "gmres":
            res_lin = gmres(Jv, -r, M_inv=M_inv, tol=eta, max_cycles=max(1, cg_maxiter // 20),
                            axis_name=axis_name)
        else:
            res_lin = pcg(Jv, -r, M_inv=M_inv, tol=eta, maxiter=cg_maxiter,
                          axis_name=axis_name)
        dx = res_lin.x

        # backtracking line search over a fixed candidate set: the step with
        # the smallest residual, picked on the device
        sq = []
        for a in alpha_list:
            r_a = residual(x + a * dx)
            sq.append(torch.sum(r_a * r_a))
        # the four candidates' squared norms in one global sum
        norms = torch.sqrt(torch.stack(list(gsum(*sq))))
        k = torch.argmin(norms)
        x_new = x + alphas[k] * dx
        r_new = residual(x_new)
        rnorm_new = norms[k]
        improved = rnorm_new < 0.5 * best
        stall = torch.where(improved, zero_i, stall + 1)
        best = torch.minimum(best, rnorm_new)
        if forcing == "ew":
            eta_cand = 0.9 * (rnorm_new / torch.clamp(rnorm, min=1e-30)) ** 2
            guard = 0.9 * eta * eta
            eta_cand = torch.where(guard > 0.1, torch.maximum(eta_cand, guard), eta_cand)
            eta = torch.clamp(eta_cand, cg_tol, 0.5)
        x, r, rnorm = x_new, r_new, rnorm_new
        it += 1
        lin += res_lin.iters
    converged = (rnorm <= threshold) | ((stall >= 3) & (rnorm <= 1e-2 * r0_norm))
    return NewtonResult(x=x, iters=it, residual_norm=rnorm, converged=converged,
                        linear_iters=lin)
