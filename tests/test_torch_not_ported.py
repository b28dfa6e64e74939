"""What the port does not hold yet fails loudly: each option that waits for
a later slice raises NotImplementedError naming that slice of ROADMAP.md —
sharding (item 15, fracture included), unstructured background meshes and
the 'binned' transfer (item 13), and the implicit, u-p and DEM steps'
material kinds beyond the hyperelastic ones (item 12b; the explicit step
takes every kind)."""

import pytest
import torch

from nlpartsol_tpu_torch.formulations import dem as tdem, explicit as tex, implicit as tim
from nlpartsol_tpu_torch.formulations import up as tup
from nlpartsol_tpu_torch.models import materials as tM

from _torch_port import cheap_jax_compiles, neo_hookean_tables, problem  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "step,changes,match",
    [
        ("explicit", [dict(halo=object()), dict(axis_name="p")], "Multi-device"),
        ("explicit", [dict(rebin_mode="none")], "Multi-device"),
        # the Beps sums across shard seams wait with the sharding itself
        ("explicit", [dict(damage="eigenerosion", halo=object())], "item 15, 'Multi-device'"),
        ("unstructured", [dict(transfer="scatter")],
         "unstructured background meshes.*'Other shape functions"),
        ("explicit", [dict(transfer="binned")], "Other shape functions"),
        # a return mapping's forward-mode J·v waits on the implicit steps
        ("implicit", [dict(kinds=(tM.DRUCKER_PRAGER,))],
         "Drucker-Prager.*item 12b, 'Remaining models'"),
        ("up", [dict(kinds=(tM.HENCKY,))], "Hencky.*u-p step.*item 12b"),
        ("dem", [dict(kinds=(tM.VON_MISES,))], "Von-Mises.*item 12b"),
    ],
    ids=["halo,axis_name", "rebin_mode=none", "damage+halo", "unstructured_grid",
         "transfer=binned", "implicit_kinds=Drucker-Prager", "up_kinds=Hencky",
         "dem_kinds=Von-Mises"],
)
def test_what_waits_raises_not_implemented(step, changes, match):
    _, (tg, tb, tp, lt) = problem(seed=0)
    _, mt = neo_hookean_tables()
    if step == "implicit":
        cfg, fn = tim.ImplicitConfig(dt=1e-5, lme_params=lt, active_box=tb), tim.implicit_step
    elif step == "up":
        cfg, fn = tup.UpConfig(dt=1e-5, lme_params=lt), tup.up_step
    elif step == "dem":
        cfg, fn = tdem.DEMConfig(dt=1e-5, lme_params=lt), tdem.dem_step
    else:
        cfg = tex.ExplicitConfig(dt=1e-5, lme_params=lt, active_box=tb, transfer="fused")
        fn = tex.explicit_step
    grid = object() if step == "unstructured" else tg  # a background that is no Grid
    for change in changes:
        with pytest.raises(NotImplementedError, match=match):
            fn(tp, grid, mt, cfg.replace(**change), torch.zeros(2))
