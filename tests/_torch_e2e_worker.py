"""End-to-end head-to-head worker for the PyTorch port (run by
tests/test_torch_dem_golden.py in a subprocess, and by chip_smoke.py on the
card: float64 must not leak into the calling process).

    python tests/_torch_e2e_worker.py [--device cuda] dem_bar [dem_svk_bar ...]

Builds each committed reference deck (tests/golden/<deck>/sim.nlp) with the
PORT's .nlp parser and builder and its ``driver.make_step_config(setup,
transfer="scatter")``, in float64 on the given device (the CPU by default);
then steps the port's ``dem_step`` on its scatter engine with the
reference's average-strain stress rule, and asserts agreement with the
reference binary's trajectory (tests/golden/<deck>/trajectory.csv) with the
checks of tests/_e2e_worker.py unchanged: positions to 1e-8, velocities to
1e-6, midpoint second Piola stress to 1e-6 relative, at steps 0, 5, 10, 15
and 19.  Imports nothing of JAX.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from nlpartsol_tpu_torch import config as tconfig

tconfig.set_dtype("float64")


def check_deck(deck_name, device):
    from nlpartsol_tpu_torch.driver import make_step_config
    from nlpartsol_tpu_torch.formulations.dem import dem_step
    from nlpartsol_tpu_torch.io.builder import build_simulation
    from nlpartsol_tpu_torch.models.materials import SAINT_VENANT_KIRCHHOFF, lame_parameters

    deck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", deck_name)
    setup = build_simulation(os.path.join(deck, "sim.nlp"), device=device)
    gold = np.genfromtxt(os.path.join(deck, "trajectory.csv"), delimiter=",", names=True)
    assert setup.solver.scheme == "Discrete-Energy-Momentum"
    d = setup.grid.dim
    cfg = make_step_config(setup, transfer="scatter").replace(stress_mode="average-strain")
    p, grid, mats = setup.particles, setup.grid, setup.materials
    assert cfg.transfer == "scatter" and p.x.dtype == torch.float64
    body = torch.zeros((d,), dtype=torch.float64, device=device)
    states = {}
    for k in range(setup.solver.n_steps):
        p, diag = dem_step(p, grid, mats, cfg, body)
        assert bool(diag["converged"])
        states[k] = tuple(t.cpu().numpy().copy() for t in (p.x, p.v, p.F))

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

    mat_id = setup.particles.mat_id.long()
    lam, G = lame_parameters(setup.materials.E[mat_id], setup.materials.nu[mat_id])
    lam = lam.cpu().numpy()[perm]
    G = G.cpu().numpy()[perm]
    eye = np.eye(d)

    # golden step k = state after step k (Particles_k.vtk convention)
    for gs in (0, 5, 10, 15, 19):
        gk = gold[gold["step"] == gs]
        gx = np.stack([gk[c] for c in xcols], -1)
        gv = np.stack([gk[c] for c in vcols], -1)
        x_o, v_o, F1 = states[gs]
        F0 = states[gs - 1][2] if gs > 0 else setup.particles.F.cpu().numpy()
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("decks", nargs="*", default=["dem_bar"])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for deck in args.decks:
        check_deck(deck, args.device)
        print(f"{deck}: the golden trajectory held on {args.device}", flush=True)
    print("TORCH_E2E_PARITY_OK")


if __name__ == "__main__":
    main()
