"""The port's I/O layer against the JAX package's: load curves, the .nlp
parser and the GiD reader give the same values; the port's native (C++)
GiD parser equals its Python one; the VTK and CSV writers write the same
text, byte for byte, for the same particles; a checkpoint written by either
package loads in the other; the GiD grid writer of ``chip_smoke.py``'s
decks writes meshes that read back as the grid they describe."""

import os
import textwrap

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nlpartsol_tpu.io import checkpoint as jck, csv_out as jcsv, gid_mesh as jgid, vtk as jvtk
from nlpartsol_tpu.io import nlp_parser as jparse
from nlpartsol_tpu.types import Grid as JGrid, make_particles as jmake
from nlpartsol_tpu.utils import curves as jcurves
from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.io import checkpoint as tck, csv_out as tcsv, gid_mesh as tgid
from nlpartsol_tpu_torch.io import native as tnative, nlp_parser as tparse, vtk as tvtk
from nlpartsol_tpu_torch.types import Grid
from nlpartsol_tpu_torch.utils import curves as tcurves, profiling

from _torch_port import cheap_jax_compiles, fields_to_numpy  # noqa: F401
from chip_smoke import write_grid_mesh
from test_io import write_gid_quad_mesh

torch.set_num_threads(1)


def test_curves_match_jax(tmp_path):
    n = 12
    for name, args in [("constant", (2.0,)), ("ramp", (1.5,)), ("heaviside", (3.0, 4)),
                       ("delta", (5.0, 3)), ("hat", (2.0, 2, 7)), ("custom", ([1.0, 2.0, 3.0],))]:
        np.testing.assert_array_equal(getattr(tcurves, name)(n, *args),
                                      getattr(jcurves, name)(n, *args), err_msg=name)
    lines = ["# a comment", "DAT_CURVE NUM#12", "CONSTANT_CURVE SCALE#1.5",
             "HEAVISIDE_CURVE SCALE#1 Tc#5", "HAT_CURVE SCALE#2 T0#1 T1#3",
             "DELTA_CURVE SCALE#4 Tc#9", "CUSTOM_CURVE", "0.5", "0.25", "0.125"]
    np.testing.assert_array_equal(tcurves.parse_curve_lines(lines, n),
                                  jcurves.parse_curve_lines(lines, n))
    (tmp_path / "c.txt").write_text("RAMP_CURVE SCALE#3.0\n")
    np.testing.assert_array_equal(tparse.read_curve_file(str(tmp_path / "c.txt"), n),
                                  jparse.read_curve_file(str(tmp_path / "c.txt"), n))
    with pytest.raises(ValueError, match="unknown curve keyword"):
        tcurves.parse_curve_lines(["SINE_CURVE SCALE#1"], n)


def _blocks_equal(bj, bt):
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        assert (a.keyword, a.attrs, a.props, a.statements) == \
            (b.keyword, b.attrs, b.props, b.statements)
        _blocks_equal(a.children, b.children)


def test_nlp_parser_matches_jax(tmp_path):
    text = textwrap.dedent("""
    ! comment
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.5
        Cel=100.0
        N=40
    }
    GramsBox (Type=GID, File=bg.msh) {
        GramsBoundary (File=left.txt) {
            BcDirichlet V.x curve.txt
            BcDirichlet V.y NULL
        }
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e7
        nu=0.0
        rho=1000
    }
    Hydrostatic-condition
    {
        Origin = {0 ; 1.0}
        Direction = {0 ; -1}
    }
    Out-particles-path-csv (i_ini=0; i_step=7; i_end=20) {
        PATH=pids.txt
    }
    generate-gravity-field-constant {
        g.y -9.81
    }
    """)
    _blocks_equal(jparse.parse_nlp_text(text), tparse.parse_nlp_text(text))
    blocks = tparse.parse_nlp_text(text)
    assert tparse.find(blocks, "GramsTime", "NLPS-Solver").props["N"] == 40
    assert [b.keyword for b in tparse.find_all(blocks, "Define-Material")] == ["Define-Material"]
    for s in ("{0 ; 10}", "[5.0,0.0,0.0]", "{1;2;3}"):
        np.testing.assert_array_equal(tparse.parse_vector(s), jparse.parse_vector(s))
    (tmp_path / "ids.txt").write_text("# ids\n3 4\n\n7\n")
    np.testing.assert_array_equal(tparse.read_node_list(str(tmp_path / "ids.txt")),
                                  jparse.read_node_list(str(tmp_path / "ids.txt")))


def test_gid_reader_and_seeding_match_jax(tmp_path):
    """Q4 (test_io.py's writer) and chip_smoke.py's H8 grid: mesh, seeding,
    volumes and the structured-grid detection as the JAX package reads
    them; the written grids read back as the grids they describe."""
    write_gid_quad_mesh(tmp_path / "q.msh", 4, 2, 0.5)
    write_grid_mesh(str(tmp_path / "q2.msh"), (4, 2), 0.5)
    assert (tmp_path / "q.msh").read_text().splitlines()[0] == \
        (tmp_path / "q2.msh").read_text().splitlines()[0]
    write_grid_mesh(str(tmp_path / "h.msh"), (3, 2, 2), 0.25, origin=(1.0, 0.0, 0.5))
    for name, gps in (("q.msh", (1, 4)), ("q2.msh", (4,)), ("h.msh", (1, 8))):
        path = str(tmp_path / name)
        mj, mt = jgid.read_gid_mesh(path), tgid.read_gid_mesh(path)
        assert (mt.dimension, mt.elem_type) == (mj.dimension, mj.elem_type)
        np.testing.assert_array_equal(mt.coords, mj.coords)
        np.testing.assert_array_equal(mt.connectivity, mj.connectivity)
        np.testing.assert_array_equal(tgid.element_volumes(mt), jgid.element_volumes(mj))
        assert tgid.structured_grid_from_mesh(mt) == jgid.structured_grid_from_mesh(mj)
        for gp in gps:
            for a, b in zip(tgid.seed_particles(mt, gp), jgid.seed_particles(mj, gp)):
                np.testing.assert_array_equal(a, b)
    assert tgid.structured_grid_from_mesh(tgid.read_gid_mesh(str(tmp_path / "h.msh"))) == \
        ((4, 3, 3), 0.25, (1.0, 0.0, 0.5))


def test_native_parser_matches_python(tmp_path):
    """The port builds native/nlps_native.cpp with g++ into its own build
    directory; its parse equals the pure-Python reader's, and a file that is
    not a mesh raises instead of falling back."""
    assert tnative.available(), "g++ could not build native/nlps_native.cpp"
    write_gid_quad_mesh(tmp_path / "m.msh", 7, 5, 0.25)
    dim, name, coords, conn = tnative.read_gid_mesh_native(str(tmp_path / "m.msh"))
    py = tgid._read_gid_mesh_py(str(tmp_path / "m.msh"))
    assert (dim, name) == (py.dimension, "Quadrilateral")
    np.testing.assert_array_equal(coords, py.coords)
    np.testing.assert_array_equal(conn, py.connectivity)
    assert tnative.SRC.endswith(os.path.join("native", "nlps_native.cpp"))
    (tmp_path / "bad.msh").write_text("not a mesh\n")
    with pytest.raises(ValueError, match="GiD parse failed"):
        tgid.read_gid_mesh(str(tmp_path / "bad.msh"))


def _random_particles(dim, n=9, seed=0):
    """The same random particles (every field set, a third inactive, pids
    shuffled) for both packages."""
    rng = np.random.default_rng(seed)
    pj = jmake(rng.uniform(0, 1, (n, dim)).astype(np.float32), mass=np.ones(n), vol0=np.ones(n))
    arrays = fields_to_numpy(pj)
    for k, a in arrays.items():
        if a.dtype == np.float32:
            arrays[k] = rng.standard_normal(a.shape).astype(np.float32)
    arrays["pid"] = rng.permutation(n).astype(np.int32)
    arrays["active"] = np.arange(n) % 3 != 1
    pj = pj.replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return pj, convert.particles_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
def test_vtk_and_csv_text_match_jax_byte_for_byte(dim, tmp_path):
    pj, pt = _random_particles(dim, seed=dim)
    for fields in (jvtk._DEFAULT_FIELDS, jvtk.ALL_FIELDS):
        a = jvtk.write_particles_vtk(str(tmp_path / "j.vtk"), pj, fields=fields)
        b = tvtk.write_particles_vtk(str(tmp_path / "t.vtk"), pt, fields=fields)
        assert open(a).read() == open(b).read()
    dims = (4, 3, 2)[:dim]
    react = np.random.default_rng(1).standard_normal((int(np.prod(dims)), dim)).astype(np.float32)
    mass = react[:, 0].copy()
    a = jvtk.write_grid_vtk(str(tmp_path / "jg.vtk"), JGrid(dims=dims, spacing=0.5,
                            origin=(0.0,) * dim), {"REACTIONS": react, "mass": mass})
    b = tvtk.write_grid_vtk(str(tmp_path / "tg.vtk"), Grid(dims=dims, spacing=0.5,
                            origin=(0.0,) * dim), {"REACTIONS": torch.as_tensor(react),
                                                   "mass": torch.as_tensor(mass)})
    assert open(a).read() == open(b).read()
    props = {"Out-Vel": "true", "Out-Von-Mises": "true", "Out-Acc": "false", "DIR": "out"}
    assert tvtk.fields_from_outputs(props) == jvtk.fields_from_outputs(props)

    rj, rt = jcsv.PathRecorder([0, 2, 5], ("x", "v", "stress", "eps")), \
        tcsv.PathRecorder([0, 2, 5], ("x", "v", "stress", "eps"))
    nj, nt = jcsv.NodeRecorder([1, 3]), tcsv.NodeRecorder([1, 3])
    for t in (0.0, 0.25):
        rj.record(t, pj)
        rt.record(t, pt)
        nj.record(t, react[[1, 3]])
        nt.record(t, torch.as_tensor(react[[1, 3]]))
    for j, t, name in ((rj, rt, "p"), (nj, nt, "n")):
        a = j.write(str(tmp_path / f"j{name}.csv"), dim=dim)
        b = t.write(str(tmp_path / f"t{name}.csv"), dim=dim)
        assert open(a).read() == open(b).read()


def test_checkpoints_cross_packages(tmp_path):
    pj, pt = _random_particles(2, seed=5)
    jck.save_checkpoint(str(tmp_path / "j.npz"), pj, step=42, extra={"rng": np.arange(3)})
    tck.save_checkpoint(str(tmp_path / "t.npz"), pt, step=43)
    p_from_jax, step, extra = tck.load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    assert step == 42
    np.testing.assert_array_equal(extra["rng"], np.arange(3))
    p_from_port, step2, _ = jck.load_checkpoint(str(tmp_path / "t.npz"))
    assert step2 == 43
    ref = fields_to_numpy(pj)
    for name, arr in convert.particles_to_numpy(p_from_jax).items():
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)
        assert arr.dtype == ref[name].dtype, name
    for name, arr in fields_to_numpy(p_from_port).items():
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)


def test_profiling_stage_timer_and_trace(tmp_path):
    st = profiling.StageTimer()
    for _ in range(2):
        with st("a", sync=torch.zeros(1)):
            pass
    assert st.summary()["a"]["calls"] == 2 and "a" in st.report()
    assert profiling.throughput(10, 2, 0.5)["nnz_per_s"] == 20.0
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("stage"):
            torch.ones(4).sum()
    assert "stage" in (tmp_path / "tr" / "trace.json").read_text()
