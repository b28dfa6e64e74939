"""The slice as a whole, through the time loop: the port's ``run`` with the
k-periodic local re-bin against the JAX package's, from state carried across
by convert.py, at the tolerances of tests/test_torch_explicit.py."""

import numpy as np
import jax
import torch

from nlpartsol_tpu.formulations import explicit as jex

from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.ops import windowed as twin

from _torch_port import (assert_tracks, cheap_jax_compiles, explicit_configs,  # noqa: F401
                         neo_hookean_tables, problem)

torch.set_num_threads(1)


def test_run_with_rebin_every_3_matches_jax(rebin_mode="local"):
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=11, n_side=9, n_particles=60, speed=0.1,
                                                slots=False)
    mj, mt = neo_hookean_tables()
    cfg_j, cfg_t = explicit_configs(gj, bj, lj, 0.2, transfer="pallas", rebin_every=3,
                            rebin_mode=rebin_mode)
    qj, dj = jax.jit(lambda q: jex.run(q, gj, mj, cfg_j, 3))(pj)
    qt, dt_ = tex.run(tp, tg, mt, cfg_t, 3)
    np.testing.assert_array_equal(dt_["nnz"].numpy(), np.asarray(dj["nnz"]))
    assert dt_["nnz"].shape == (3,) and int(dt_["lost"].sum()) == 0
    np.testing.assert_allclose(dt_["kinetic_energy"].numpy(), np.asarray(dj["kinetic_energy"]),
                               rtol=1e-4)
    assert_tracks(qt, qj)
    # the rebin restored the slot invariant: each particle in its slot's cell
    cells = torch.as_tensor(twin.slot_cells(tb))
    assert torch.equal(tg.cell_of(qt.x)[qt.active], cells[qt.active])
