"""What the port does not hold yet fails loudly: each option of the explicit
step that waits for a later slice raises NotImplementedError naming that
slice of ROADMAP.md, and so do the implicit step's material kinds beyond the
hyperelastic ones (the explicit step takes every kind)."""

import pytest
import torch

from nlpartsol_tpu_torch.formulations import explicit as tex, implicit as tim
from nlpartsol_tpu_torch.models import materials as tM

from _torch_port import cheap_jax_compiles, neo_hookean_tables, problem  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "changes,match",
    [
        ([dict(halo=object()), dict(axis_name="p")], "Multi-device"),
        ([dict(rebin_mode="none")], "Multi-device"),
        ([dict(damage="eigenerosion")], "item 12c, 'Remaining models'"),
        ([dict(shapefun="gimp")], "Other shape functions"),
        ([dict(shapefun="alme")], "Other shape functions"),
        ([dict(transfer="scatter")], "Other shape functions"),
        ([dict(transfer="binned")], "Other shape functions"),
        # the implicit step: a return mapping's forward-mode J·v waits
        ([dict(kinds=(tM.DRUCKER_PRAGER,))], "Drucker-Prager.*item 12b, 'Remaining models'"),
    ],
    ids=["halo,axis_name", "rebin_mode=none", "damage", "shapefun=gimp", "shapefun=alme",
         "transfer=scatter", "transfer=binned", "kinds=Drucker-Prager"],
)
def test_what_waits_raises_not_implemented(changes, match):
    _, (tg, tb, tp, lt) = problem(seed=0)
    _, mt = neo_hookean_tables()
    if "kinds" in changes[0]:
        cfg, step = tim.ImplicitConfig(dt=1e-5, lme_params=lt, active_box=tb), tim.implicit_step
    else:
        cfg = tex.ExplicitConfig(dt=1e-5, lme_params=lt, active_box=tb, transfer="fused")
        step = tex.explicit_step
    for change in changes:
        with pytest.raises(NotImplementedError, match=match):
            step(tp, tg, mt, cfg.replace(**change), torch.zeros(2))
