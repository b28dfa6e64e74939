"""The port's 2-D decomposition (parallel/domain.py, ranks row-major over
2×2 shards) against the JAX package's: the decomposition and strips array
for array; the two-phase halo add and fill and the two-phase seam migration
on 4 gloo ranks against the JAX functions under ``shard_map`` on a 2×2
virtual CPU mesh; the 2×2-decomposed explicit run on both engines, and a 3D
run on 4 strips, against the JAX single-device windowed runs by pid
(tests/test_domain.py's tolerances).  One launch of ranks for the file."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nlpartsol_tpu.formulations import explicit as jex
from nlpartsol_tpu.models import materials as jM
from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.parallel import domain as jdom
from nlpartsol_tpu.shapefun import lme as jlme
from nlpartsol_tpu.types import Particles as JParticles

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.parallel import domain
from nlpartsol_tpu_torch.types import make_particles

import _torch_domain_worker as worker
from _torch_domain import (H, jax_by_pid, jax_run, problem2, problem3, ranks_by_pid,
                           static_fields, to_numpy)
from _torch_port import cheap_jax_compiles, to_torch_box  # noqa: F401

torch.set_num_threads(1)

SHARDS = (2, 2)
LP = jlme.LMEParams(gamma=3.0)
OFFS = jlme.offsets_for(2, LP)
# the 3D band at γ = 5 (a 5³ window, tests/_torch_port.py::problem3): the
# γ = 3 window of 7³ nodes makes the JAX reference's compile the slowest of
# these files
LP3 = jlme.LMEParams(gamma=5.0, tol_zero=1e-6)
EXPLICIT_TOL = dict(x=5e-5, v=5e-4, J=5e-5)  # tests/test_domain.py:172-174
FIELDS = domain._FIELDS
ENGINES = ("windowed", "fused")


def _decomps(capacity=2):
    (gj, pj, mj), (tg, tp, tm) = problem2()
    bj = jwin.full_box(gj, capacity=capacity)
    return (gj, pj, mj, jdom.decompose2(gj, bj, SHARDS, OFFS)), (
        tg, tp, tm, domain.decompose2(tg, to_torch_box(bj), SHARDS, OFFS))


def _smap(fn, n_out=1):
    mesh = jdom.make_mesh2(SHARDS)
    ax = P(("g0", "g1"))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(ax,),
                             out_specs=(ax,) * n_out if n_out > 1 else ax, check_vma=False))


def _explicit(gj, pj, mj, lp, n):
    box = jwin.full_box(gj, capacity=2)
    cfg_j = jex.ExplicitConfig(dt=0.3 * H / np.sqrt(10.0), shapefun="lme", lme_params=lp,
                               kinds=(jM.NEO_HOOKEAN,), transfer="windowed", active_box=box)
    p = jex.to_slot_layout(pj, gj, box)
    body = jnp.zeros((gj.dim,), jnp.float32)
    ref = jax_run(lambda q: jex.explicit_step(q, gj, mj, cfg_j, body)[0], p, n)
    return jax_by_pid(ref), convert.config_from_fields(static_fields(cfg_j)), box


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(1)
    cases, inputs = [], {}
    (gj, pj, mj, jdec), (tg, tp, tm, tdec) = _decomps()
    n_local = tdec.local_grid.n_nodes
    f = rng.standard_normal((4, n_local, 2)).astype(np.float32)
    inputs["halo"] = f
    cases.append(dict(name="halo", kind="halo", spec=tdec.spec, shape=SHARDS,
                      fields=[torch.as_tensor(a) for a in f]))

    # two-phase migration: a particle at each cell centre of the 6×6 cells
    # around the shards' common corner, drifted by 0.55-0.95 of a cell on
    # both axes toward the corner (a capacity-6 box takes the crowding): the
    # corner cells' particles reach the diagonal shard in two hops
    _, (_, _, _, tdec6) = _decomps(capacity=6)
    xs = np.array([[(i + 0.5) * H, (j + 0.5) * H] for i in range(9, 15) for j in range(5, 11)],
                  np.float32)
    pm = make_particles(xs, mass=np.ones(len(xs), np.float32),
                        vol0=np.full(len(xs), H * H, np.float32), device="cpu")
    parts = []
    seam = np.array([12 * H, 8 * H])
    for q, (s0, s1) in zip(domain.shard_particles2(pm, tdec6), tdec6.shard_coords()):
        sgn = np.sign(seam - (q.x.numpy() + tdec6.shift(s0, s1)))  # toward the corner
        dx = (sgn * rng.uniform(0.55, 0.95, q.x.shape) * H).astype(np.float32)
        parts.append(q.replace(x=torch.where(q.active[:, None], q.x + torch.as_tensor(dx), q.x)))
    inputs["migrate"] = parts
    cases.append(dict(name="migrate", kind="migrate", dec=tdec6, parts=parts, shape=SHARDS,
                      grids=domain.shard_grid2(tg, tdec6)))

    # the 2×2-decomposed explicit run, 30 steps (test_domain.py:518)
    ref, cfg_t, _ = _explicit(gj, pj, mj, LP, 30)
    inputs["explicit2"] = ref
    for eng in ENGINES:
        cases.append(dict(name=f"explicit2_{eng}", kind="driver", driver="explicit", dec=tdec,
                          p=tp, grid=tg, mats=tm, cfg=cfg_t.replace(transfer=eng), steps=30,
                          body=torch.zeros(2), shape=SHARDS))

    # 3D strips along axis 0, 4 shards, 10 steps (test_domain.py:383)
    (gj, pj, mj), (tg, tp, tm) = problem3()
    ref, cfg_t, box = _explicit(gj, pj, mj, LP3, 10)
    inputs["3d"] = ref
    tdec3 = domain.decompose(tg, to_torch_box(box), 4, jlme.offsets_for(3, LP3))
    for eng in ENGINES:
        cases.append(dict(name=f"3d_{eng}", kind="driver", driver="explicit", dec=tdec3, p=tp,
                          grid=tg, mats=tm, cfg=cfg_t.replace(transfer=eng), steps=10,
                          body=torch.zeros(3)))
    outs = worker.launch(cases, 4, str(tmp_path_factory.mktemp("ranks")))
    return outs, inputs


def test_decompose2_and_strips_match_jax():
    (gj, pj, _, jdec), (tg, tp, _, tdec) = _decomps()
    js = jdec.spec
    assert (tdec.spec.shards, tdec.spec.wlo, tdec.spec.whi, tdec.spec.bc, tdec.spec.ln) == (
        js.shards, js.wlo, js.whi, js.bc, js.ln)
    assert tdec.spec.bc == (12, 8) and tdec.spec.ln == (18, 14)
    assert tdec.local_grid.dims == jdec.local_grid.dims
    assert tdec.local_box == to_torch_box(jdec.local_box)
    for s0, s1 in tdec.shard_coords():
        np.testing.assert_array_equal(tdec.shift(s0, s1), jdec.shift(s0, s1))
    assert convert.decomp2_from_fields(jdec, device="cpu").spec == tdec.spec
    gjs = jdom.shard_grid2(gj, jdec)
    tgs = domain.shard_grid2(tg, tdec)
    np.testing.assert_array_equal([g.valid_lo for g in tgs], np.asarray(gjs.valid_lo))
    np.testing.assert_array_equal([g.valid_hi for g in tgs], np.asarray(gjs.valid_hi))
    pjs = jdom.shard_particles2(pj, jdec)
    tps = domain.shard_particles2(tp, tdec)
    back_j = jdom.unshard_particles2(pjs, jdec)
    back_t = domain.unshard_particles2(tps, tdec)
    for name in FIELDS:
        np.testing.assert_array_equal(np.concatenate([to_numpy(getattr(q, name)) for q in tps]),
                                      np.asarray(getattr(pjs, name)), err_msg=name)
        np.testing.assert_array_equal(to_numpy(getattr(back_t, name)),
                                      np.asarray(getattr(back_j, name)), err_msg=name)
    with pytest.raises(ValueError, match="axis 1"):
        domain.decompose2(tg, tdec.global_box, (2, 8), OFFS)


def test_two_phase_halo_matches_jax_shard_map(ranks):
    outs, inputs = ranks
    (_, _, _, jdec), _ = _decomps()
    stacked = jnp.asarray(inputs["halo"].reshape(-1, 2))
    add = _smap(functools.partial(jdom.halo_exchange_add, spec=jdec.spec))(stacked)
    fill = _smap(functools.partial(jdom.halo_fill, spec=jdec.spec))(stacked)
    for r in range(4):
        np.testing.assert_array_equal(to_numpy(outs[r]["halo"]["add"]),
                                      np.asarray(add).reshape(4, -1, 2)[r])
        np.testing.assert_array_equal(to_numpy(outs[r]["halo"]["fill"]),
                                      np.asarray(fill).reshape(4, -1, 2)[r])


def test_two_phase_migration_matches_jax_shard_map(ranks):
    outs, inputs = ranks
    (_, _, _, jdec), _ = _decomps(capacity=6)
    stacked = JParticles(**{n: jnp.asarray(np.concatenate(
        [to_numpy(getattr(q, n)) for q in inputs["migrate"]])) for n in FIELDS})

    def mig(p):
        q, lost = jdom.migrate_local2(p, jdec.spec, jdec.local_grid, jdec.local_box)
        return q, lost[None]

    q, lost = _smap(mig, 2)(stacked)
    ns = jdec.local_box.n_slots
    corner = 0
    for r in range(4):
        got = outs[r]["migrate"]["p"]
        for n in FIELDS:
            np.testing.assert_array_equal(to_numpy(got[n]),
                                          np.asarray(getattr(q, n))[r * ns:(r + 1) * ns],
                                          err_msg=f"rank {r} {n}")
        assert outs[r]["migrate"]["lost"] == int(lost[r])
        # a particle that started on the diagonal shard reached this one
        diag = inputs["migrate"][3 - r]
        corner += len(set(to_numpy(got["pid"][got["active"]]))
                      & set(to_numpy(diag.pid[diag.active])))
    assert corner > 0, "no diagonal mover: the two-hop route is untested"


@pytest.mark.parametrize("case", ["explicit2_windowed", "explicit2_fused", "3d_windowed",
                                  "3d_fused"])
def test_sharded_runs_match_jax(ranks, case):
    outs, inputs = ranks
    ref = inputs[case.split("_")[0]]
    got = ranks_by_pid(outs, case)
    np.testing.assert_array_equal(got["pid"], ref["pid"])
    for name, atol in EXPLICIT_TOL.items():
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=atol, err_msg=name)
    for o in outs:
        assert int(o[case]["diag"]["lost"]) == 0
