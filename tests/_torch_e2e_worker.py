"""End-to-end head-to-head worker for the PyTorch port (run by
tests/test_torch_dem_golden.py in a subprocess: float64 must not leak into
the main test process).

Builds a committed reference deck (tests/golden/<deck>/sim.nlp) with the JAX
package's .nlp parser and builder and its ``driver.make_step_config(setup,
transfer="scatter")``, in float64; carries the particles, grid, materials and
step configuration over to the port through ``convert.py`` (float64, on the
CPU); then steps the PORT's ``dem_step`` on its scatter engine with the
reference's average-strain stress rule, and asserts agreement with the
reference binary's trajectory (tests/golden/<deck>/trajectory.csv) with the
checks of tests/_e2e_worker.py unchanged: positions to 1e-8, velocities to
1e-6, midpoint second Piola stress to 1e-6 relative, at steps 0, 5, 10, 15
and 19.
"""

import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nlpartsol_tpu import config

config.set_dtype("float64")

import numpy as np
import torch

from nlpartsol_tpu_torch import config as tconfig

tconfig.set_dtype("float64")


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def port_records(setup, cfg):
    """The deck's particles, grid, materials and DEM configuration as the
    port's records, on the CPU."""
    from nlpartsol_tpu_torch import convert

    g = setup.grid

    def opt(a):
        return None if a is None else np.asarray(a)

    grid = convert.grid_from_numpy(
        g.dims, g.spacing, g.origin, active=opt(g.active), dirichlet_mask=opt(g.dirichlet_mask),
        dirichlet_value=opt(g.dirichlet_value), valid_lo=opt(g.valid_lo),
        valid_hi=opt(g.valid_hi), device="cpu")
    p = convert.particles_from_numpy(_fields(setup.particles), device="cpu")
    mats = convert.materials_from_numpy(_fields(setup.materials), device="cpu")
    tcfg = convert.dem_config_from_fields(
        {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    return p, grid, mats, tcfg


def main():
    from nlpartsol_tpu.driver import make_step_config
    from nlpartsol_tpu.io.builder import build_simulation
    from nlpartsol_tpu.models.materials import SAINT_VENANT_KIRCHHOFF, lame_parameters
    from nlpartsol_tpu_torch.formulations.dem import dem_step

    torch.set_num_threads(1)
    deck_name = sys.argv[1] if len(sys.argv) > 1 else "dem_bar"
    deck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", deck_name)
    setup = build_simulation(os.path.join(deck, "sim.nlp"))
    gold = np.genfromtxt(os.path.join(deck, "trajectory.csv"), delimiter=",", names=True)
    assert setup.solver.scheme == "Discrete-Energy-Momentum"
    d = setup.grid.dim
    cfg = make_step_config(setup, transfer="scatter").replace(stress_mode="average-strain")
    p, grid, mats, tcfg = port_records(setup, cfg)
    assert tcfg.transfer == "scatter" and p.x.dtype == torch.float64
    body = torch.zeros((d,), dtype=torch.float64)
    states = {}
    for k in range(setup.solver.n_steps):
        p, diag = dem_step(p, grid, mats, tcfg, body)
        assert bool(diag["converged"])
        states[k] = (p.x.numpy().copy(), p.v.numpy().copy(), p.F.numpy().copy())

    xcols = ["x", "y", "z"][:d]
    vcols = ["vx", "vy", "vz"][:d]
    # upper-triangle stress components present in the golden CSV
    scols = (
        [("sxx", 0, 0), ("sxy", 0, 1), ("syy", 1, 1)] if d == 2
        else [("sxx", 0, 0), ("sxy", 0, 1), ("sxz", 0, 2),
              ("syy", 1, 1), ("syz", 1, 2), ("szz", 2, 2)]
    )

    # particle correspondence: the reference's ChainPtr stack reverses
    # element connectivity => its per-element Gauss order is a fixed
    # permutation; match by position at the first output state
    g0 = gold[gold["step"] == 0]
    gx0 = np.stack([g0[c] for c in xcols], -1)
    dist = np.linalg.norm(gx0[:, None, :] - states[0][0][None, :, :], axis=-1)
    perm = dist.argmin(axis=1)
    assert len(set(perm)) == len(perm), "particle matching not a bijection"
    assert dist.min(axis=1).max() < 1e-9, "first-state positions do not match"

    lam, G = lame_parameters(
        setup.materials.E[setup.particles.mat_id],
        setup.materials.nu[setup.particles.mat_id],
    )
    lam = np.array(lam)[perm]
    G = np.array(G)[perm]
    eye = np.eye(d)

    # golden step k = state after step k (Particles_k.vtk convention)
    for gs in (0, 5, 10, 15, 19):
        gk = gold[gold["step"] == gs]
        gx = np.stack([gk[c] for c in xcols], -1)
        gv = np.stack([gk[c] for c in vcols], -1)
        x_o, v_o, F1 = states[gs]
        F0 = states[gs - 1][2] if gs > 0 else np.array(setup.particles.F)
        np.testing.assert_allclose(x_o[perm], gx, rtol=0, atol=1e-8)
        np.testing.assert_allclose(v_o[perm], gv, rtol=0, atol=1e-6)
        # golden STRESS = the DEM midpoint average-strain SECOND PIOLA
        # S(C_mid, J_mid); reconstruct from the port's F states
        F1p, F0p = F1[perm], F0[perm]
        C_mid = 0.5 * (
            np.einsum("pki,pkj->pij", F0p, F0p)
            + np.einsum("pki,pkj->pij", F1p, F1p)
        )
        if setup.kinds == (SAINT_VENANT_KIRCHHOFF,):
            # reference DEM SVK rule (trE restored): S = lam*trE*I + G*E
            # at E = (C_mid - I)/2 (Saint-Venant-Kirchhoff.c:107-112)
            E_mid = 0.5 * (C_mid - eye[None])
            trE = np.trace(E_mid, axis1=-2, axis2=-1)
            S = (lam * trE)[:, None, None] * eye[None] + G[:, None, None] * E_mid
        else:
            J_mid = 0.5 * (np.linalg.det(F0p) + np.linalg.det(F1p))
            Cinv = np.linalg.inv(C_mid)
            S = (0.5 * lam * (J_mid**2 - 1))[:, None, None] * Cinv + G[
                :, None, None
            ] * (eye[None] - Cinv)
        scale = max(1.0, np.abs(gk["sxx"]).max())
        for name, i, j in scols:
            np.testing.assert_allclose(
                S[:, i, j], gk[name], rtol=0, atol=1e-6 * scale
            )
    print("TORCH_E2E_PARITY_OK")


if __name__ == "__main__":
    main()
