"""The port's deck builder against the JAX package's: every field of
``SimulationSetup`` equal, array by array, on tests/test_io.py's decks (the
FEM and LME bar, the soil-water column, the hydrostatic and nodal initial
conditions, the Neumann load, the CSV events) and the reference binary's
``dem_bar`` golden deck; and the bar over a non-Cartesian background of
T3 triangles, built as an unstructured FEMesh with FEM and with LME shape
functions."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nlpartsol_tpu.io.builder import build_simulation as jax_build
from nlpartsol_tpu.shapefun.femesh import FEMesh as JFEMesh
from nlpartsol_tpu_torch.io.builder import build_simulation
from nlpartsol_tpu_torch.shapefun.femesh import FEMesh

import _torch_decks as decks
from _torch_port import cheap_jax_compiles  # noqa: F401
from test_io import bar_case, upw_case  # noqa: F401

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _record_equal(rj, rt, what):
    """Every dataclass field of two records equal (arrays exactly, with
    their dtypes)."""
    names = [f.name for f in dataclasses.fields(rj)]
    assert names == [f.name for f in dataclasses.fields(rt)], what
    for name in names:
        a, b = getattr(rj, name), getattr(rt, name)
        if a is None or isinstance(a, (int, float, tuple, str)):
            assert a == b, f"{what}.{name}: {a!r} != {b!r}"
            continue
        a, b = np.asarray(a), _np(b)
        assert a.dtype == b.dtype, f"{what}.{name}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{name}")


def _groups_equal(gj, gt, what):
    assert len(gj) == len(gt), what
    for (ids_j, comp_j, cur_j), (ids_t, comp_t, cur_t) in zip(gj, gt):
        np.testing.assert_array_equal(ids_t, ids_j, err_msg=what)
        assert comp_t == comp_j, what
        np.testing.assert_array_equal(cur_t, cur_j, err_msg=what)


def assert_setups_equal(sj, st):
    assert dataclasses.asdict(sj.solver) == dataclasses.asdict(st.solver)
    # a structured Grid, or an unstructured FEMesh field by field: kind,
    # nodes, connectivity, the element bins, spacing, h_avg, the node bins
    # of an LME deck and the Dirichlet mask and values
    assert isinstance(sj.grid, JFEMesh) == isinstance(st.grid, FEMesh)
    _record_equal(sj.grid, st.grid, "grid")
    _record_equal(sj.particles, st.particles, "particles")
    _record_equal(sj.materials, st.materials, "materials")
    if sj.mixtures is None:
        assert st.mixtures is None
    else:
        _record_equal(sj.mixtures, st.mixtures, "mixtures")
    for name in ("kinds", "shapefun", "shapefun_params", "out_dir", "out_every", "vtk_fields",
                 "formulation", "backup_every", "fracture", "pw_dirichlet"):
        assert getattr(sj, name) == getattr(st, name), name
    if sj.gravity is None:
        assert st.gravity is None
    else:
        np.testing.assert_array_equal(st.gravity, sj.gravity)
    _groups_equal(sj.dirichlet_nodes, st.dirichlet_nodes, "dirichlet_nodes")
    _groups_equal(sj.neumann, st.neumann, "neumann")
    assert len(sj.csv_events) == len(st.csv_events)
    for ej, et in zip(sj.csv_events, st.csv_events):
        assert ej.keys() == et.keys()
        for key in ej:
            np.testing.assert_array_equal(np.asarray(et[key]), np.asarray(ej[key]), err_msg=key)


def _deck(name, bar_case, upw_case, tmp_path):
    if name == "bar_fem":
        return bar_case / "sim.nlp"
    if name == "bar_lme":
        return decks.set_shapefun(bar_case, "LME")
    if name == "upw":
        return upw_case / "sim.nlp"
    if name == "initial_conditions":
        return decks.write_initial_conditions_case(tmp_path / "ic")
    if name == "neumann":
        x0 = _np(build_simulation(str(bar_case / "sim.nlp"), device="cpu").particles.x)
        return decks.add_neumann(bar_case, x0)
    if name == "csv_events":
        return decks.add_csv_events(bar_case)
    return os.path.join(GOLDEN, "dem_bar", "sim.nlp")


@pytest.mark.parametrize("name", ["bar_fem", "bar_lme", "upw", "initial_conditions",
                                  "neumann", "csv_events", "golden_dem_bar"])
def test_builder_matches_jax(name, bar_case, upw_case, tmp_path):  # noqa: F811
    (tmp_path / "ic").mkdir()
    path = str(_deck(name, bar_case, upw_case, tmp_path))
    assert_setups_equal(jax_build(path), build_simulation(path, device="cpu"))


def test_unstructured_background_waits_for_item_13(bar_case):  # noqa: F811
    """The bar over T3 triangles with unevenly spaced node columns (the name
    is from before unstructured meshes were ported): both builders make the
    same FEMesh and setup, with FEM and then with LME (the node bins at the
    support radius of the deck's LME parameters)."""
    path = str(decks.set_triangle_background(bar_case))
    for shapefun in ("FEM", "LME"):
        if shapefun == "LME":
            path = str(decks.set_shapefun(bar_case, "LME"))
        sj, st = jax_build(path), build_simulation(path, device="cpu")
        assert isinstance(st.grid, FEMesh) and st.grid.kind == "T3"
        assert (st.grid.nbin_nodes is not None) == (shapefun == "LME")
        assert_setups_equal(sj, st)
