"""What the port does not hold fails loudly: each option that waits for a
later slice raises NotImplementedError naming that slice of ROADMAP.md —
sharding (item 15, fracture included) — the 'binned' transfer names the
do-not-port list (queue 2), and an unstructured FEMesh on a slot-layout
engine (or under a fracture driver) raises ValueError naming the scatter
engine.  Every step takes every material kind (item 12b)."""

import pytest
import torch

from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.shapefun import femesh as tfem

from _torch_port import cheap_jax_compiles, neo_hookean_tables, problem  # noqa: F401

torch.set_num_threads(1)


NOT_PORTED = NotImplementedError


def _t3_mesh(grid):
    """A FEMesh of two triangles a cell over the grid's nodes."""
    ids = torch.arange(grid.n_nodes).reshape(grid.dims)
    a, b, c, d = ids[:-1, :-1], ids[1:, :-1], ids[1:, 1:], ids[:-1, 1:]
    tris = torch.cat([torch.stack([a, b, c], -1).reshape(-1, 3),
                      torch.stack([a, c, d], -1).reshape(-1, 3)])
    return tfem.build_femesh(grid.node_coords(device="cpu").double().numpy(), tris.numpy(), "T3",
                             device="cpu")


@pytest.mark.parametrize(
    "step,changes,match,error",
    [
        ("explicit", [dict(halo=object()), dict(axis_name="p")], "Multi-device", NOT_PORTED),
        ("explicit", [dict(rebin_mode="none")], "Multi-device", NOT_PORTED),
        # the Beps sums across shard seams wait with the sharding itself
        ("explicit", [dict(damage="eigenerosion", halo=object())], "item 15, 'Multi-device'",
         NOT_PORTED),
        # a FEMesh has no slot layout: the scatter engine only, no fracture
        ("unstructured", [dict(transfer="windowed"), dict(transfer="fused"),
                          dict(transfer="scatter", damage="eigenerosion")],
         r"scatter engine \(transfer='scatter'\)|fracture drivers require", ValueError),
        ("explicit", [dict(transfer="binned")], "do-not-port list, ROADMAP.md queue 2",
         NOT_PORTED),
    ],
    ids=["halo,axis_name", "rebin_mode=none", "damage+halo", "unstructured_grid",
         "transfer=binned"],
)
def test_what_waits_raises_not_implemented(step, changes, match, error):
    _, (tg, tb, tp, lt) = problem(seed=0)
    _, mt = neo_hookean_tables()
    cfg = tex.ExplicitConfig(dt=1e-5, lme_params=lt, active_box=tb, transfer="fused")
    grid = _t3_mesh(tg) if step == "unstructured" else tg
    for change in changes:
        with pytest.raises(error, match=match):
            tex.explicit_step(tp, grid, mt, cfg.replace(**change), torch.zeros(2))
