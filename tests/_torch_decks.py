"""Deck variants of tests/test_io.py for the port's I/O, builder and driver
tests: each takes a directory holding one of test_io.py's decks (its
``bar_case`` fixture: a 20×2 Q4 bar, FEM, NPC-FS, fixed ends) and edits it
the way the named test of test_io.py does."""

import textwrap

from test_io import write_gid_quad_mesh


def set_shapefun(case, kind):
    """The bar with another ``GramsShapeFun`` type (test_transfer_auto_selects_engine)."""
    txt = (case / "sim.nlp").read_text().replace("Type=FEM", f"Type={kind}")
    (case / "sim.nlp").write_text(txt)
    return case / "sim.nlp"


def set_scheme(case, scheme, rb=None):
    """The bar under another scheme (test_driver_dispatches_fe_and_generalized_alpha)."""
    txt = (case / "sim.nlp").read_text().replace("Type=NPC-FS", f"Type={scheme}")
    if rb is not None:
        txt = txt.replace("N=20", f"N=20\n    rb-Generalized-alpha={rb}")
    (case / "sim.nlp").write_text(txt)
    return case / "sim.nlp"


def add_neumann(case, x0):
    """An end-load on the bar's last particle column with its right end
    freed (test_traction_alignment_windowed_vs_scatter); ``x0`` the built
    particle positions in seeding order."""
    right_ids = [i for i, x in enumerate(x0[:, 0]) if x > x0[:, 0].max() - 0.03]
    (case / "load_ids.txt").write_text("\n".join(map(str, right_ids)))
    (case / "pull.txt").write_text("CONSTANT_CURVE SCALE#1e4\n")
    txt = (case / "sim.nlp").read_text().replace(
        "One-Phase-Analysis",
        "Define-Neumann-Boundary (File=load_ids.txt) {\n"
        "    BcNeumann T.x pull.txt\n"
        "}\nOne-Phase-Analysis",
        1,
    )
    txt = txt.replace(
        "GramsBoundary (File=right.txt) {\n"
        "        BcDirichlet V.x zero.txt\n"
        "        BcDirichlet V.y zero.txt\n"
        "    }\n    ", "", 1)
    (case / "sim.nlp").write_text(txt)
    return case / "sim.nlp"


def add_csv_events(case):
    """The particle-path event of test_csv_path_events and a nodal-path
    event on the left end's nodes."""
    (case / "pids.txt").write_text("0\n4\n")
    txt = (case / "sim.nlp").read_text() + textwrap.dedent("""
    Out-particles-path-csv (i_ini=0; i_step=7; i_end=20) {
        DIR=csvout
        PATH=pids.txt
        Out-velocity=true
        Out-damage=true
    }
    Out-nodal-path-csv (i_ini=2; i_step=5; i_end=20) {
        DIR=csvout
        PATH=left.txt
    }
    """)
    (case / "sim.nlp").write_text(txt)
    return case / "sim.nlp"


def add_fracture(case):
    """The bar with the deck form of --Fracture-Modulus and its material
    parameters (Ceps, Gf)."""
    txt = (case / "sim.nlp").read_text().replace(
        "N=20", "N=20\n    Fracture-Modulus=Eigenerosion").replace(
        "rho=1000", "rho=1000\n    Ceps=1.5\n    Gf=0.08")
    (case / "sim.nlp").write_text(txt)
    return case / "sim.nlp"


def write_initial_conditions_case(tmp_path):
    """The deck of test_hydrostatic_and_nodal_initial_conditions."""
    write_gid_quad_mesh(tmp_path / "bg.msh", 4, 4, 0.25)
    write_gid_quad_mesh(tmp_path / "body.msh", 4, 4, 0.25)
    (tmp_path / "all.txt").write_text("\n".join(map(str, range(25))))
    (tmp_path / "sim.nlp").write_text(textwrap.dedent("""
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.25
        Cel=10.0
        N=4
    }
    GramsBox (Type=GID, File=bg.msh) {
    }
    GramsShapeFun (Type=FEM) {
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e6
        nu=0.3
        rho=2000
    }
    One-Phase-Analysis (File=body.msh, GPxElement=1) {
    }
    Hydrostatic-condition
    {
        Origin = {0 ; 1.0}
        Direction = {0 ; -1}
        Gravity = 10
        MatIndx = 0
    }
    Initial-nodal-values (NODES=all.txt)
    {
        VELOCITY=[2.5,0.0,0.0]
    }
    GramsOutputs (i=10) {
        DIR=out
    }
    """))
    return tmp_path / "sim.nlp"


def set_triangle_background(case):
    """The bar over a background of T3 triangles whose node columns are not
    evenly spaced: a non-Cartesian mesh (the unstructured path)."""
    write_triangle_mesh(case / "bg.msh", 20, 2, 0.05, 0.01)
    return case / "sim.nlp"


def write_triangle_mesh(path, nx, ny, h, shift):
    """A GiD mesh of T3 triangles (two a cell) over (nx+1)×(ny+1) nodes of
    spacing h, the odd interior node columns moved by ``shift`` along x."""
    with open(path, "w") as fh:
        fh.write("MESH dimension 2 ElemType Triangle Nnode 3\nCoordinates\n")
        nid = 1
        for i in range(nx + 1):
            x = i * h + (shift if 0 < i < nx and i % 2 else 0.0)
            for j in range(ny + 1):
                fh.write(f"{nid} {x} {j * h}\n")
                nid += 1
        fh.write("End Coordinates\nElements\n")
        eid = 1
        for i in range(nx):
            for j in range(ny):
                n0 = i * (ny + 1) + j + 1
                n1 = (i + 1) * (ny + 1) + j + 1
                for tri in ((n0, n1, n1 + 1), (n0, n1 + 1, n0 + 1)):
                    fh.write(f"{eid} {tri[0]} {tri[1]} {tri[2]}\n")
                    eid += 1
        fh.write("End Elements\n")
    return path
