"""Port-level contracts of nlpartsol_tpu_torch: state carried across by
convert.py, loud errors for bad input, and no silent fall-back to the CPU."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from nlpartsol_tpu.formulations import explicit as jex
from nlpartsol_tpu.ops import windowed as jwin

import nlpartsol_tpu_torch
from nlpartsol_tpu_torch import config as tconfig, convert
from nlpartsol_tpu_torch.formulations import common as tcommon, courant, explicit as tex
from nlpartsol_tpu_torch.models import materials as tM
from nlpartsol_tpu_torch.ops import fused_transfer as ft, windowed as twin
from nlpartsol_tpu_torch.types import Particles, make_particles

from _torch_port import (cheap_jax_compiles, fields_to_numpy, neo_hookean_tables,  # noqa: F401
                         problem)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_convert_round_trip_keeps_every_field():
    (gj, bj, pj, _), (tg, tb, tp, _) = problem(seed=0)
    src = fields_to_numpy(pj)
    assert [f.name for f in dataclasses.fields(Particles)] == list(src)
    back = convert.particles_to_numpy(tp)
    for name, ref in src.items():
        assert back[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(back[name], ref, err_msg=name)
    assert tp.pid.dtype == torch.int32 and tp.active.dtype == torch.bool
    # the port owns its memory: writing to the source does not reach it
    mine = {k: v.copy() for k, v in src.items()}
    tp2 = convert.particles_from_numpy(mine, device="cpu")
    mine["x"][:] = 0
    np.testing.assert_array_equal(tp2.x.numpy(), src["x"])
    with pytest.raises(ValueError, match="missing fields"):
        convert.particles_from_numpy({"x": src["x"]}, device="cpu")
    assert (tg.dims, tg.spacing, tg.origin) == (tuple(gj.dims), gj.spacing, tuple(gj.origin))
    assert tg.valid_bounds() == ((0, 0), (gj.dims[0] - 1, gj.dims[1] - 1))
    g2 = convert.grid_from_numpy(gj.dims, gj.spacing, gj.origin, valid_lo=np.int32(2),
                                 valid_hi=np.asarray([7, 8]), device="cpu")
    assert g2.valid_bounds() == ((2, 0), (7, 8))
    assert tp.to("cpu").x.device.type == "cpu" and tp.replace(x=tp.v).x is tp.v
    assert tb == twin.box_for_extent(tg, [0.1, 0.1], [0.9, 0.9], capacity=tb.capacity)
    assert twin.full_box(tg, 3).n_slots == jwin.full_box(gj, 3).n_slots


def test_config_from_fields_maps_the_jax_config():
    (gj, bj, _, lj), (_, tb, _, lt) = problem(seed=0)
    cfg_j = jex.ExplicitConfig(dt=1e-4, lme_params=lj, active_box=bj, transfer="pallas",
                               rebin_every=4, fbar=True)
    static = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    cfg_t = convert.config_from_fields(static)
    assert cfg_t == tex.ExplicitConfig(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused",
                                       rebin_every=4, fbar=True)
    assert convert.config_from_fields({**static, "beps_reach": 2}).beps_reach == 2
    assert convert.config_from_fields({**static, "prebinned": True}).prebinned
    with pytest.raises(ValueError, match="unknown field"):
        convert.config_from_fields({**static, "bogus": 1})


def test_3d_and_unknown_options_raise():
    _, (tg, tb, tp, lt) = problem(seed=0)
    _, mt = neo_hookean_tables()
    cfg = tex.ExplicitConfig(dt=1e-5, lme_params=lt, active_box=tb)
    # 3D runs (tests/test_torch_explicit3d.py); other dimensions raise
    p1 = make_particles(np.zeros((4, 1), np.float32), np.ones(4), np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="2D and 3D"):
        tex.run(p1, tg, mt, cfg, 1)
    with pytest.raises(ValueError, match="unknown transfer"):
        tex.explicit_step(tp, tg, mt, cfg.replace(transfer="magic"), torch.zeros(2))
    with pytest.raises(ValueError, match="active_box"):
        tex.explicit_step(tp, tg, mt, cfg.replace(active_box=None), torch.zeros(2))
    with pytest.raises(ValueError, match="no fused transfer path"):
        tcommon.make_engine(cfg.replace(transfer="fused"), tg, {}, None, None)
    with pytest.raises(TypeError, match="must be a Grid or a FEMesh"):
        tcommon.shapefun_eval(cfg, object(), tp)
    with pytest.raises(ValueError, match="tractions require rebin_every=1"):
        tex.explicit_step(tp, tg, mt, cfg.replace(transfer="fused", rebin_every=2,
                                                  rebin_mode="global"),
                          torch.zeros(2), traction=tp.v, traction_area=tp.mass, rebin=True)


def test_to_slot_layout_refuses_silent_loss():
    _, (tg, tb, tp, _) = problem(seed=0, slots=False)
    tight = tb.replace(capacity=1)
    with pytest.raises(ValueError, match="needs capacity >= "):
        tex.to_slot_layout(tp, tg, tight)
    kept = tex.to_slot_layout(tp, tg, tight, allow_lost=True)
    assert 0 < int(kept.active.sum()) < tp.count


def test_nothing_falls_back_to_the_cpu():
    """Entry points default to the card; on a machine without one they fail
    where they allocate.  A CUDA tensor never reaches a plain version."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        make_particles(np.zeros((4, 2), np.float32), np.ones(4), np.ones(4))
    with pytest.raises((RuntimeError, AssertionError)):
        tM.material_table([tM.material()])
    src = (ROOT / "nlpartsol_tpu_torch" / "ops" / "fused_transfer.py").read_text()
    tree = ast.parse(src)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], "no try/fall-back"
    ft.reset_launch_counts()
    assert sum(ft.launch_counts.values()) == 0


def test_config_and_courant():
    assert nlpartsol_tpu_torch.__version__
    assert tconfig.dtype() == torch.float32 and tconfig.index_dtype() == torch.int32
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert (tconfig.TOL_NR, tconfig.TOL_LME, tconfig.RCOND_GUARD) == (1e-5, 1e-10, 1e-8)
    tconfig.set_dtype("float64")
    try:
        p = make_particles(np.zeros((2, 2)), np.ones(2), np.ones(2), device="cpu")
        assert p.x.dtype == torch.float64 and p.F.dtype == torch.float64
    finally:
        tconfig.set_dtype("float32")
    with pytest.raises(ValueError):
        tconfig.set_dtype("bfloat16")
    cel = courant.celerity(1e7, 1000.0)
    assert cel == 100.0 and courant.courant_dt(0.25, 0.1, cel) == 0.25 * 0.1 / 100.0
    v = torch.tensor([[3.0, -4.0]])
    assert float(courant.courant_dt_dynamic(0.5, 0.1, cel, v)) == pytest.approx(0.05 / 104.0)
