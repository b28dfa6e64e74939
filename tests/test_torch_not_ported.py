"""What the port does not hold yet fails loudly: each option of the explicit
step that waits for a later slice raises NotImplementedError naming that
slice of ROADMAP.md."""

import pytest
import torch

from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.models import materials as tM

from _torch_port import cheap_jax_compiles, neo_hookean_tables, problem  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "changes,match",
    [
        ([dict(halo=object()), dict(axis_name="p")], "Multi-device"),
        ([dict(rebin_mode="none")], "Multi-device"),
        ([dict(damage="eigenerosion")], "Remaining models"),
        ([dict(shapefun="gimp")], "Other shape functions"),
        ([dict(scheme="FE")], "Other shape functions"),
        ([dict(transfer="scatter")], "Other shape functions"),
        ([dict(transfer="binned")], "Other shape functions"),
        ([dict(kinds=(tM.DRUCKER_PRAGER,))], "Drucker-Prager"),
    ],
    ids=["halo,axis_name", "rebin_mode=none", "damage", "shapefun=gimp", "scheme=FE",
         "transfer=scatter", "transfer=binned", "kinds=Drucker-Prager"],
)
def test_what_waits_raises_not_implemented(changes, match):
    _, (tg, tb, tp, lt) = problem(seed=0)
    _, mt = neo_hookean_tables()
    cfg = tex.ExplicitConfig(dt=1e-5, lme_params=lt, active_box=tb, transfer="fused")
    for change in changes:
        with pytest.raises(NotImplementedError, match=match):
            tex.explicit_step(tp, tg, mt, cfg.replace(**change), torch.zeros(2))
