"""The port's driver and CLI against the JAX package's: the step
configuration ``make_step_config`` picks for each scheme, formulation and
shape function (the JAX transfer 'pallas' is the port's 'fused'); a whole
``run_simulation`` of tests/test_io.py's bar, and a JAX backup resumed by
the port, tracking the JAX run by pid; tractions aligned through pid under
a shuffled storage order on both engines; the CLI's outputs; and a
fracture deck through both CLIs, and a JAX backup taken mid-fracture
resumed by the port."""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nlpartsol_tpu import driver as jdriver
from nlpartsol_tpu.io.builder import build_simulation as jax_build
from nlpartsol_tpu_torch import cli, convert, driver
from nlpartsol_tpu_torch.io.builder import build_simulation

import _torch_decks as decks
from _torch_port import assert_tracks, by_pid, cheap_jax_compiles  # noqa: F401
from test_io import bar_case, fracture_bar_case, upw_case  # noqa: F401

torch.set_num_threads(1)

_CONVERTERS = {
    "ExplicitConfig": convert.config_from_fields,
    "ImplicitConfig": convert.implicit_config_from_fields,
    "UpConfig": convert.up_config_from_fields,
    "UpwConfig": convert.upw_config_from_fields,
    "UpwImplicitConfig": convert.upw_implicit_config_from_fields,
    "DEMConfig": convert.dem_config_from_fields,
}


def _outcome(make, setup, transfer):
    """The config ``make`` returns, or the type of the error it raises."""
    try:
        return make(setup, transfer=transfer)
    except (ValueError, NotImplementedError) as exc:
        return type(exc)


def test_make_step_config_matches_jax(bar_case, upw_case):  # noqa: F811
    """Schemes × formulations × shape functions × transfers: the same
    config class and fields (or the same refusal); 'auto' picks the fused
    kernels by the JAX package's eligibility rule."""
    checked = 0
    for case, formulations in ((bar_case, ("u", "up")), (upw_case, ("upw",))):
        sj, st = jax_build(str(case / "sim.nlp")), build_simulation(str(case / "sim.nlp"),
                                                                    device="cpu")
        for scheme in ("NPC-FS", "Verlet", "FE", "Generalized-alpha", "Newmark-beta", "Static",
                       "Discrete-Energy-Momentum"):
            for formulation in formulations:
                for shapefun in ("fem", "lme"):
                    for s in (sj, st):
                        s.solver.scheme, s.formulation, s.shapefun = scheme, formulation, shapefun
                    for tj, tt in (("auto", "auto"), ("pallas", "fused"), ("windowed", "windowed"),
                                   ("scatter", "scatter")):
                        cj = _outcome(jdriver.make_step_config, sj, tj)
                        ct = _outcome(driver.make_step_config, st, tt)
                        where = (scheme, formulation, shapefun, tt)
                        if isinstance(cj, type):
                            assert ct is cj, where
                            continue
                        static = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)}
                        assert ct == _CONVERTERS[type(cj).__name__](static), where
                        checked += 1
    assert checked > 100
    setup = build_simulation(str(decks.set_shapefun(bar_case, "LME")), device="cpu")
    assert driver.make_step_config(setup, transfer="auto").transfer == "fused"
    for shapefun in ("gimp", "alme"):
        # the kernels compute LME only: the windowed engine takes the deck
        setup.shapefun = shapefun
        assert driver.make_step_config(setup, transfer="auto").transfer == "windowed"


def _with_mode(setup, tensor):
    """test_io.py's initial velocity mode v = 0.01·sin(πx)."""
    x = np.asarray(setup.particles.x)
    v = (0.01 * np.stack([np.sin(np.pi * x[:, 0]), np.zeros(len(x))], -1)).astype(np.float32)
    setup.particles = setup.particles.replace(v=tensor(v))
    return setup


def test_run_and_resume_track_jax(bar_case, tmp_path, monkeypatch):  # noqa: F811
    """20 windowed steps of the FEM bar through both drivers, by pid within
    STEP_TOL and the energies within 1e-4; then the JAX run's step-10
    backup resumed by the port reproduces the JAX 20-step run."""
    monkeypatch.chdir(tmp_path)
    path = str(bar_case / "sim.nlp")
    kw = dict(transfer="windowed", write_outputs=False, progress=False)
    pj, hj = jdriver.run_simulation(_with_mode(jax_build(path), jnp.asarray), n_steps=20, **kw)
    pt, ht = driver.run_simulation(_with_mode(build_simulation(path, device="cpu"),
                                              torch.as_tensor), n_steps=20, **kw)
    assert_tracks(pt, pj)
    assert len(ht["kinetic_energy"]) == 20
    for key in ("kinetic_energy", "strain_energy"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-4, atol=1e-4 * max(hj[key]))
    np.testing.assert_allclose(ht["t"], hj["t"], rtol=1e-12)
    assert set(ht) == set(hj)

    jdriver.run_simulation(_with_mode(jax_build(path), jnp.asarray), n_steps=10,
                           backup_every=10, **kw)
    pr, hr = driver.run_simulation(_with_mode(build_simulation(path, device="cpu"),
                                              torch.as_tensor),
                                   n_steps=20, resume=os.path.join("out", "backup.npz"), **kw)
    assert len(hr["kinetic_energy"]) == 10
    assert_tracks(pr, pj)


def test_tractions_follow_pid_under_shuffled_order(bar_case, tmp_path, monkeypatch):  # noqa: F811
    """An end-load on the LME bar with the particles stored in a shuffled
    order: the windowed and the fused engine (its plain versions here)
    stretch the bar alike, matched by pid."""
    decks.set_shapefun(bar_case, "LME")
    x0 = build_simulation(str(bar_case / "sim.nlp"), device="cpu").particles.x.numpy()
    path = str(decks.add_neumann(bar_case, x0))
    monkeypatch.chdir(tmp_path)
    perm = torch.as_tensor(np.random.default_rng(3).permutation(len(x0)))
    outs = {}
    for transfer in ("windowed", "fused"):
        setup = build_simulation(path, device="cpu")
        assert setup.neumann
        setup.particles = setup.particles.map_tensors(lambda a: a[perm])
        assert driver.make_step_config(setup, transfer=transfer).transfer == transfer
        p, _ = driver.run_simulation(setup, transfer=transfer, write_outputs=False,
                                     progress=False, n_steps=8)
        outs[transfer] = by_pid(p, names=("x",))["x"]
    assert outs["fused"][:, 0].max() > x0[:, 0].max() + 1e-6
    np.testing.assert_allclose(outs["fused"], outs["windowed"], rtol=1e-5, atol=1e-8)


def test_cli_writes_outputs(bar_case, monkeypatch):  # noqa: F811
    """``--platform cpu``: the VTK pair at every output step, the CSV
    events' files, and a backup that --resume continues from."""
    monkeypatch.chdir(bar_case)
    decks.add_csv_events(bar_case)
    txt = (bar_case / "sim.nlp").read_text().replace("DIR=out", "DIR=out\n    Out-backup=5")
    (bar_case / "sim.nlp").write_text(txt)
    assert cli.main(["--FORMULATION-U", "-f", "sim.nlp", "--platform", "cpu"]) == 0
    vtks = sorted(os.listdir("out"))
    assert [f for f in vtks if f.endswith(".vtk")] == [
        "nodes_000000.vtk", "nodes_000010.vtk", "particles_000000.vtk", "particles_000010.vtk"]
    assert "DIMENSIONS 21 3 1" in (bar_case / "out" / "nodes_000010.vtk").read_text()
    rows = (bar_case / "out" / "csvout" / "particles_path_0.csv").read_text().splitlines()
    assert len(rows) == 1 + 3 and rows[0].startswith("t,p0.v")  # steps 0, 7, 14
    rows = (bar_case / "out" / "csvout" / "nodes_path_1.csv").read_text().splitlines()
    assert len(rows) == 1 + 4 and len(rows[1].split(",")) == 1 + 3 * 2  # steps 2, 7, 12, 17
    assert os.path.exists("out/backup.npz")
    assert cli.main(["-f", "sim.nlp", "--platform", "cpu", "--no-output",
                     "--resume", "out/backup.npz"]) == 0


@pytest.mark.parametrize("transfer", ["windowed", "auto"])
def test_fracture_deck_matches_jax_cli(transfer, fracture_bar_case, monkeypatch):  # noqa: F811
    """tests/test_io.py's notched-bar deck through both CLIs with
    --Fracture-Modulus Eigenerosion ('auto': the fused engine, its plain
    versions here, at a re-bin every step): the last backups' states by pid
    (x within STEP_TOL, damage equal), the centre eroded and the VTK damage
    field written; an unknown modulus is refused as by the JAX CLI."""
    from nlpartsol_tpu.cli import main as jax_main
    from nlpartsol_tpu_torch.io.checkpoint import load_checkpoint

    monkeypatch.chdir(fracture_bar_case)
    args = ["--FORMULATION-U", "-f", "sim.nlp", "--Fracture-Modulus", "Eigenerosion",
            "--backup-every", "60", "--transfer"]
    assert jax_main(args + [{"auto": "auto", "windowed": "windowed"}[transfer]]) == 0
    os.rename("out", "out_jax")
    setup = build_simulation("sim.nlp", device="cpu")
    setup.fracture = "eigenerosion"
    cfg = driver.make_step_config(setup, transfer=transfer)
    assert cfg.damage == "eigenerosion" and cfg.beps_reach == 2 and cfg.rebin_every == 1
    assert cfg.transfer == {"auto": "fused", "windowed": "windowed"}[transfer]
    assert cli.main(args + [transfer, "--platform", "cpu"]) == 0
    pt, step_t, _ = load_checkpoint(os.path.join("out", "backup.npz"), device="cpu")
    pj, step_j, _ = load_checkpoint(os.path.join("out_jax", "backup.npz"), device="cpu")
    assert step_t == step_j == 60
    assert_tracks(pt, pj)
    got, ref = by_pid(pt, names=("damage",)), by_pid(pj, names=("damage",))
    np.testing.assert_array_equal(got["damage"], ref["damage"])
    assert ref["damage"].max() == 1.0 and ref["damage"].min() == 0.0
    last = sorted(f for f in os.listdir("out") if f.startswith("particles_"))[-1]
    assert "SCALARS damage" in (fracture_bar_case / "out" / last).read_text()
    with pytest.raises(SystemExit, match="Eigenerosion or"):
        cli.main(["-f", "sim.nlp", "--platform", "cpu", "--Fracture-Modulus", "PhaseField"])


def test_jax_fracture_backup_resumes_in_port(fracture_bar_case, tmp_path,  # noqa: F811
                                            monkeypatch):
    """A JAX backup taken mid-fracture (some particles eroded, the rest
    intact) resumed by the port's driver: the next steps match the JAX
    run's, by pid (x within STEP_TOL, damage equal)."""
    monkeypatch.chdir(fracture_bar_case)
    kw = dict(transfer="windowed", write_outputs=False, progress=False, n_steps=36)
    sj = jax_build("sim.nlp")
    sj.fracture = "eigenerosion"
    pj, _ = jdriver.run_simulation(sj, backup_every=24, **kw)
    from nlpartsol_tpu_torch.io.checkpoint import load_checkpoint

    mid, step, _ = load_checkpoint(os.path.join("out", "backup.npz"), device="cpu")
    dmg = mid.damage[mid.active]
    assert step == 24 and 0 < int((dmg == 1.0).sum()) < int(mid.active.sum()), \
        "the backup is not mid-fracture"
    st = build_simulation("sim.nlp", device="cpu")
    st.fracture = "eigenerosion"
    pt, hist = driver.run_simulation(st, resume=os.path.join("out", "backup.npz"), **kw)
    assert len(hist["kinetic_energy"]) == 12
    assert_tracks(pt, pj)
    got, ref = by_pid(pt, names=("damage",)), by_pid(pj, names=("damage",))
    np.testing.assert_array_equal(got["damage"], ref["damage"])


def test_alme_deck_runs_like_explicit_run(tmp_path, monkeypatch):
    """An aLME deck (γ 2.5) through ``run_simulation`` on the windowed
    engine, against ``explicit.run`` on the same built particles with the
    config's ``ALMEParams`` and β₀ (the JAX driver has no aLME route to hold
    it against): x, v, F, stress and β by pid, β finite and pulled back."""
    from chip_smoke import write_deck
    from nlpartsol_tpu_torch.formulations import explicit
    from nlpartsol_tpu_torch.ops import windowed
    from nlpartsol_tpu_torch.shapefun import alme

    h = 1.0 / 12
    path = write_deck(str(tmp_path), (12, 12), h, (6, 6), (3 * h, 3 * h), shapefun="aLME",
                      steps=4)
    with open(path) as fh:
        text = fh.read()
    assert "gamma=3.0" in text
    with open(path, "w") as fh:
        fh.write(text.replace("gamma=3.0", "gamma=2.5"))
    monkeypatch.chdir(tmp_path)

    def built():
        setup = build_simulation(path, device="cpu")
        x = setup.particles.x.numpy()
        v = 0.5 * np.stack([np.sin(2 * np.pi * x[:, 1]), np.zeros(len(x))], -1)
        setup.particles = setup.particles.replace(v=torch.as_tensor(v.astype(np.float32)))
        return setup

    setup = built()
    p0 = setup.particles
    box = windowed.default_box(setup.grid, p0.x.numpy(), p0.active.numpy())
    cfg = driver.make_step_config(setup, transfer="windowed", active_box=box)
    assert cfg.shapefun == "alme" and cfg.alme_params == alme.ALMEParams(gamma=2.5)
    beta0 = alme.init_lme_beta(p0.count, cfg.alme_params, h, 2, device="cpu")
    ref, _ = explicit.run(p0.replace(lme_beta=beta0), setup.grid, setup.materials, cfg, 4)
    got, hist = driver.run_simulation(built(), transfer="windowed", n_steps=4,
                                      write_outputs=False, progress=False)
    assert len(hist["kinetic_energy"]) == 4
    assert_tracks(got, ref)
    bg = by_pid(got, names=("lme_beta",))["lme_beta"]
    br = by_pid(ref, names=("lme_beta",))["lme_beta"]
    np.testing.assert_allclose(bg, br, rtol=1e-5, atol=1e-5 * np.abs(br).max())
    b0 = alme.beta0(cfg.alme_params, h, 2)
    assert np.isfinite(bg).all() and np.abs(bg - b0).max() > 1e-4 * np.abs(b0).max()
