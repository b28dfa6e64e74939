"""Decks whose materials are plastic, on the implicit schemes: a
Newmark-β-Finite-Strains deck of a Drucker-Prager body and a -upw
Newmark-β deck with a Drucker-Prager soil (chip_smoke.py's route decks: a
body on the floor of a 16² background under gravity, its bottom nodes held)
through ``cli.main``, read back from its backup, against the step's own loop
on the same built particles with the driver's config, by pid (STEP_TOL of
tests/_torch_port.py; pw within 1e-3 of its largest magnitude).  Before this
slice the steps refused these kinds."""

import os

import numpy as np
import torch

import chip_smoke
from nlpartsol_tpu_torch import cli
from nlpartsol_tpu_torch.driver import make_step_config
from nlpartsol_tpu_torch.formulations import implicit as tim, upw as tupw
from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
from nlpartsol_tpu_torch.io.builder import build_simulation
from nlpartsol_tpu_torch.io.checkpoint import load_checkpoint
from nlpartsol_tpu_torch.ops import windowed

from _torch_port import STEP_TOL, by_pid

torch.set_num_threads(1)

STEPS = 1
DRUCKER_PRAGER = ("Model=Drucker-Prager) {\n    E=1e7\n    nu=0.3\n    rho={rho}\n"
                  "    Yield-stress=2e3\n    Friction-angle=30\n    Dilatancy-angle=10\n"
                  "    Hardening-exponent=2\n    Reference-plastic-strain=0.01\n}\n")


def _cli_and_loop(path, flag, step):
    """The deck through the CLI (a backup at the last step) and through
    ``step(p, grid, mats, cfg, body)`` on the same built particles."""
    cwd = os.getcwd()
    os.chdir(os.path.dirname(path))
    try:
        assert cli.main([flag, "-f", "sim.nlp", "--platform", "cpu", "--no-output",
                         "--backup-every", str(STEPS)]) == 0
        p_cli, n, _ = load_checkpoint(os.path.join("out", "backup.npz"), device="cpu")
    finally:
        os.chdir(cwd)
    assert n == STEPS
    setup = build_simulation(path, device="cpu")
    setup.formulation = {"--FORMULATION-U": "u", "--FORMULATION-Upw": "upw"}[flag]
    p = setup.particles
    cfg = make_step_config(setup, transfer="auto",
                           active_box=windowed.default_box(setup.grid, p.x.numpy(),
                                                           p.active.numpy()))
    assert cfg.transfer == "fused"
    p = to_slot_layout(p, setup.grid, cfg.active_box)
    body = torch.as_tensor(setup.gravity[0], dtype=p.x.dtype)
    for _ in range(STEPS):
        p, dg = step(p, setup, cfg, body)
        assert int(dg["lost"]) == 0 and dg["newton_iters"] < cfg.newton_maxiter
    return p_cli, p, setup


def _track(p_cli, p, names):
    got, ref = by_pid(p_cli, names), by_pid(p, names)
    for name in ("x", "v", "F", "stress"):
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **STEP_TOL[name])
    return got, ref


def test_newmark_drucker_prager_deck(tmp_path):
    path = chip_smoke._route_deck(
        str(tmp_path / "dp"), scheme="Newmark-beta-Finite-Strains", cfl=1.0, steps=STEPS,
        materials="Define-Material (idx=0, " + DRUCKER_PRAGER.replace("{rho}", "1000"))
    p_cli, p, setup = _cli_and_loop(
        path, "--FORMULATION-U",
        lambda p, s, cfg, body: tim.implicit_step(p, s.grid, s.materials, cfg, body))
    got, ref = _track(p_cli, p, ("x", "v", "F", "stress", "eps", "kappa"))
    np.testing.assert_allclose(got["eps"], ref["eps"], rtol=1e-4, atol=1e-9)
    assert setup.kinds == (7,) and float(p.kappa[p.active].min()) > 0.0


def test_upw_newmark_deck_with_drucker_prager_soil(tmp_path):
    soil_water = chip_smoke._SOIL_WATER.replace(
        "Model=Neo-Hookean-Wriggers) {\n    E=1e7\n    nu=0.3\n    rho=2700\n}\n",
        DRUCKER_PRAGER.replace("{rho}", "2700"))
    assert "Drucker-Prager" in soil_water
    path = chip_smoke._route_deck(
        str(tmp_path / "upw"), materials=soil_water, analysis="Soil-Water-Coupling-One-Layer",
        scheme="Newmark-beta", cfl=0.5, steps=STEPS, solver_props="    TOL-Newmark-beta=1e-2\n")
    p_cli, p, setup = _cli_and_loop(
        path, "--FORMULATION-Upw",
        lambda p, s, cfg, body: tupw.upw_newmark_step(p, s.grid, s.materials, s.mixtures, cfg,
                                                      body))
    got, ref = _track(p_cli, p, ("x", "v", "F", "stress", "pw"))
    scale = float(np.abs(ref["pw"]).max())
    assert scale > 0.0
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=0, atol=1e-3 * scale)
    assert 7 in setup.kinds
