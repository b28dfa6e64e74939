"""The reference binary's DEM goldens through the PyTorch port: each deck of
tests/golden/ that tests/test_reference_e2e.py runs through the JAX package
is stepped by the port's ``dem_step`` (scatter engine, average-strain
stress, float64, on the CPU) and held to the binary's trajectory with the
same limits — positions 1e-8, velocities 1e-6, midpoint stress 1e-6
relative (tests/_torch_e2e_worker.py).  A subprocess each, so that float64
does not leak into the rest of the suite."""

import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize("deck", ["dem_bar", "dem_svk_bar", "dem_bar3d"])
def test_port_dem_matches_reference_binary(deck):
    """Neo-Hookean ν=0 and Saint-Venant-Kirchhoff ν=0.3 in 2D, and the 3D H8
    bar, each over 20 steps."""
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_e2e_worker.py")
    r = subprocess.run([sys.executable, worker, deck], capture_output=True, text=True,
                       timeout=900, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert "TORCH_E2E_PARITY_OK" in r.stdout
