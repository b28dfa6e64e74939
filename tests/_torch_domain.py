"""Shared problems of the port's halo-sharded tests (tests/test_torch_domain*.py):
tests/test_domain.py's advecting bands built once in numpy and handed to the
JAX package and, through ``convert.py``, to the port; the JAX references
run on the CPU on the 'windowed' engine, one jitted step in a Python loop."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.types import Grid as JGrid, make_particles as jmake

from _torch_port import to_torch_grid, to_torch_materials, to_torch_particles

H = 1.0 / 8.0
RHO = 1000.0


def _band(xs, v_of, E=1e4, dims=(25, 9), dirichlet_floor=False, **mat):
    """JAX (grid, particles, materials) and the port's (on the CPU)."""
    x = np.asarray(xs, np.float32)
    d = x.shape[1]
    vol = H ** d
    n = int(np.prod(dims))
    kw = {}
    if dirichlet_floor:
        dm = np.zeros((n, d), bool)
        dm[np.arange(n).reshape(dims)[:, 0], 1] = True
        kw = dict(dirichlet_mask=jnp.asarray(dm), dirichlet_value=jnp.zeros((n, d), jnp.float32))
    gj = JGrid(dims=dims, spacing=H, origin=(0.0,) * d, **kw)
    pj = jmake(x, mass=np.full(len(x), RHO * vol, np.float32),
               vol0=np.full(len(x), vol, np.float32))
    pj = pj.replace(v=jnp.asarray(v_of(x).astype(np.float32)))
    mj = jM.material_table([jM.material(kind="Neo-Hookean-Wriggers", E=E, nu=0.3, rho0=RHO,
                                        **mat)])
    return (gj, pj, mj), (to_torch_grid(gj), to_torch_particles(pj), to_torch_materials(mj))


def problem(n0=25, vx=0.5, E=1e4, **mat):
    """tests/test_domain.py::_problem: a band moving +x across the seams,
    a roller floor."""
    xs = [[(i + 0.5) * H, (j + 0.5) * H] for i in range(2, 10) for j in range(1, 5)]

    def v_of(x):
        return np.stack([np.full(len(x), vx), 0.05 * np.sin(3.0 * x[:, 0])], -1)

    return _band(xs, v_of, E, (n0, 9), dirichlet_floor=True, **mat)


def problem2(vx=0.4, vy=0.35):
    """tests/test_domain.py::_problem2: a band moving diagonally across the
    seams of both axes."""
    xs = [[(i + 0.5) * H, (j + 0.5) * H] for i in range(2, 10) for j in range(2, 7)]

    def v_of(x):
        return np.stack([vx + 0.05 * np.sin(3.0 * x[:, 1]), np.full(len(x), vy)], -1)

    return _band(xs, v_of, 1e4, (25, 17))


def problem3():
    """tests/test_domain.py::test_halo_3d_parity's 17×6×6 band."""
    xs = [[(i + 0.5) * H, (j + 0.5) * H, (k + 0.5) * H]
          for i in range(2, 8) for j in range(1, 4) for k in range(1, 4)]

    def v_of(x):
        return np.stack([np.full(len(x), 0.4), 0.05 * np.sin(3.0 * x[:, 0]),
                         np.zeros(len(x))], -1)

    return _band(xs, v_of, 1e4, (17, 6, 6))


def static_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def jax_run(step, p, n_steps):
    """``n_steps`` of a jitted JAX step from ``p`` (in slot layout)."""
    fn = jax.jit(step)
    for _ in range(n_steps):
        p = fn(p)
    return p


def jax_by_pid(p, names=("x", "v", "J")):
    act = np.asarray(p.active)
    order = np.argsort(np.asarray(p.pid)[act])
    return {n: np.asarray(getattr(p, n))[act][order] for n in ("pid",) + tuple(names)}


def ranks_by_pid(outs, case, names=("x", "v", "J")):
    """The ranks' particles of ``case`` (world frames) by pid."""
    parts = [o[case]["p"] for o in outs if case in o]
    cat = {n: np.concatenate([np.asarray(q[n]) for q in parts])
           for n in ("pid", "active") + tuple(names)}
    act = cat["active"].astype(bool)
    order = np.argsort(cat["pid"][act])
    return {n: cat[n][act][order] for n in ("pid",) + tuple(names)}


def to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
