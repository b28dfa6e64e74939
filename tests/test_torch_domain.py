"""The port's 1-D decomposition (parallel/domain.py) against the JAX
package's: the host-side decomposition and strips array for array; the halo
add and fill, the seam migrations and the particle halo on 4 gloo ranks
against the JAX functions under ``shard_map`` on 4 virtual CPU devices, on
the same random strips; the Krylov solvers' all-reduced dots against one
process; and the particle-split P2G sums of both engines and a scatter-engine
step against one process.  The ranks run once for the whole file
(tests/_torch_domain_worker.py)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.parallel import domain as jdom
from nlpartsol_tpu.shapefun import lme as jlme
from nlpartsol_tpu.types import Particles as JParticles

from nlpartsol_tpu_torch import convert
from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.ops import solvers, sparse, windowed as twin
from nlpartsol_tpu_torch.parallel import domain
from nlpartsol_tpu_torch.shapefun import lme as tlme

import _torch_domain_worker as worker
from _torch_domain import H, problem, to_numpy
from _torch_port import cheap_jax_compiles, to_torch_box  # noqa: F401

torch.set_num_threads(1)

S = 4
LP = jlme.LMEParams(gamma=3.0)
OFFS = jlme.offsets_for(2, LP)
FIELDS = domain._FIELDS


def _decomps(margin=0):
    (gj, pj, mj), (tg, tp, tm) = problem(vx=0.5)
    bj = jwin.full_box(gj, capacity=2)
    return (gj, pj, jdom.decompose(gj, bj, S, OFFS, margin=margin)), (
        tg, tp, domain.decompose(tg, to_torch_box(bj), S, OFFS, margin=margin))


def _smap(fn, n_in, n_out=1):
    mesh = jdom.make_mesh(S)
    ax = P(jdom.GRID_AXIS)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(ax,) * n_in,
                             out_specs=(ax,) * n_out if n_out > 1 else ax, check_vma=False))


def _drifted(parts, rng):
    """Each shard's slot layout with its particles (at cell centres) moved
    by 0.55-0.95 of a cell either way on axis 0 and up to 0.3 on axis 1:
    every particle changes cell, and those of the seam planes cross."""
    out = []
    for q in parts:
        dx = np.zeros(q.x.shape, np.float32)
        dx[:, 0] = rng.choice([-1.0, 1.0], len(dx)) * rng.uniform(0.55, 0.95, len(dx)) * H
        dx[:, 1] = rng.uniform(-0.3, 0.3, len(dx)) * H
        out.append(q.replace(x=torch.where(q.active[:, None], q.x + torch.as_tensor(dx), q.x)))
    return out


def _stack_j(parts):
    return JParticles(**{n: jnp.asarray(np.concatenate([to_numpy(getattr(q, n)) for q in parts]))
                         for n in FIELDS})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of 4 ranks for every case of the file, and the inputs the
    JAX side compares against."""
    rng = np.random.default_rng(0)
    cases, inputs = [], {}
    (_, _, jdec), (tg, tp, tdec) = _decomps()

    # halo add and fill on random strips, 3 channels
    n_local = tdec.local_grid.n_nodes
    f = rng.standard_normal((S, n_local, 3)).astype(np.float32)
    inputs["halo"] = f
    cases.append(dict(name="halo", kind="halo", spec=tdec.spec,
                      fields=[torch.as_tensor(a) for a in f]))

    # seam migration, sort-free and sort-based, from drifted strips
    local = domain.shard_grid(tg, tdec)
    for name, sorted_ in (("migrate", False), ("migrate_sorted", True)):
        parts = _drifted(domain.shard_particles(tp, tdec), rng)
        inputs[name] = parts
        cases.append(dict(name=name, kind="migrate", dec=tdec, parts=parts, grids=local,
                          sorted=sorted_))

    # the fracture particle halo: slot arrays of 2 cell planes a seam
    ns = tdec.local_box.n_slots
    arrs = [dict(x=torch.as_tensor(rng.uniform(0, 1, (ns, 2)).astype(np.float32)),
                 active=torch.as_tensor((rng.uniform(size=ns) > 0.5).astype(np.float32)),
                 W=torch.as_tensor(rng.standard_normal(ns).astype(np.float32)))
            for _ in range(S)]
    inputs["slot_halo"] = arrs
    cases.append(dict(name="slot_halo", kind="slot_halo", dec=tdec, arrs=arrs, reach=2))

    # the solvers on a tridiagonal operator over 4 strips of m planes
    m = 6
    sp = dict(n_shards=S, wlo=1, whi=1, bc=m, ln=m + 2)
    own = [domain._owned_along(m + 2, 1, m, r, S, "cpu").numpy() for r in range(S)]
    n = sum(int(o.sum()) for o in own)
    diag = 2.5 + rng.uniform(size=n)
    b = rng.standard_normal(n)

    def split(v):
        out, i = [], 0
        for o in own:
            loc = np.zeros(m + 2)
            loc[o] = v[i:i + o.sum()]
            i += o.sum()
            out.append(torch.as_tensor(loc))
        return out

    inputs["solver"] = (diag, b, own)
    cases.append(dict(name="solver", kind="solver", spec=sp, diag=split(diag), b=split(b)))

    # particle-split sums: each rank holds the particles with pid % 4 == rank
    (_, _, _), (tg2, tp2, tm2) = problem(vx=0.5)
    box = twin.full_box(tg2, capacity=2)
    tp2 = tex.to_slot_layout(tp2, tg2, box)
    sf = tlme.evaluate(tg2, tp2.x, tp2.lme_lambda, tlme.LMEParams(gamma=3.0))
    mask = sf["mask"] & tp2.active[:, None]
    vals = sf["N"][..., None] * tp2.v[:, None, :]
    cfg = tex.ExplicitConfig(dt=0.3 * H / np.sqrt(10.0), lme_params=tlme.LMEParams(gamma=3.0),
                             transfer="scatter")
    inputs["split"] = (sf, mask, vals, tg2, box, tp2, tm2, cfg)
    cases.append(dict(name="split", kind="split", owner=tp2.pid % S, ids=sf["node_ids"],
                      mask=mask, vals=vals, n_nodes=tg2.n_nodes, wmask=mask,
                      wowner=tp2.pid % S, wvals=vals, box=box, grid=tg2,
                      offsets=tlme.offsets_for(2, tlme.LMEParams(gamma=3.0)), p=tp2, mats=tm2,
                      cfg=cfg, body=torch.zeros(2)))
    outs = worker.launch(cases, S, str(tmp_path_factory.mktemp("ranks")))
    return outs, inputs


def test_decompose_and_strips_match_jax():
    for margin in (0, 1):
        (gj, pj, jdec), (tg, tp, tdec) = _decomps(margin)
        js = jdec.spec
        assert (tdec.spec.n_shards, tdec.spec.wlo, tdec.spec.whi, tdec.spec.bc, tdec.spec.ln) == (
            js.n_shards, js.wlo, js.whi, js.bc, js.ln)
        assert tdec.local_grid.dims == jdec.local_grid.dims
        assert tdec.local_grid.origin == tuple(jdec.local_grid.origin)
        assert tdec.local_box == to_torch_box(jdec.local_box)
        assert tdec.global_box == to_torch_box(jdec.global_box)
        assert (tdec.mig_capacity, tdec.margin) == (jdec.mig_capacity, jdec.margin)
        for s in range(S):
            assert tdec.base_plane(s) == jdec.base_plane(s)
            np.testing.assert_array_equal(tdec.shift(s), jdec.shift(s))
        # the JAX decomposition carried across drives the port's strips
        assert convert.decomp_from_fields(jdec, device="cpu").spec == tdec.spec
        # strips: Dirichlet arrays and valid plane bounds, array for array
        gjs = jdom.shard_grid(gj, jdec)
        tgs = domain.shard_grid(tg, tdec)
        for name in ("dirichlet_mask", "dirichlet_value"):
            np.testing.assert_array_equal(
                np.concatenate([to_numpy(getattr(g, name)) for g in tgs]),
                np.asarray(getattr(gjs, name)))
        np.testing.assert_array_equal([g.valid_lo for g in tgs], np.asarray(gjs.valid_lo))
        np.testing.assert_array_equal([g.valid_hi for g in tgs], np.asarray(gjs.valid_hi))
        # slot layouts of every shard and the way back, field for field
        pjs = jdom.shard_particles(pj, jdec)
        tps = domain.shard_particles(tp, tdec)
        back_j = jdom.unshard_particles(pjs, jdec)
        back_t = domain.unshard_particles(tps, tdec)
        for name in FIELDS:
            np.testing.assert_array_equal(
                np.concatenate([to_numpy(getattr(q, name)) for q in tps]),
                np.asarray(getattr(pjs, name)), err_msg=name)
            np.testing.assert_array_equal(to_numpy(getattr(back_t, name)),
                                          np.asarray(getattr(back_j, name)), err_msg=name)
    # an uneven split pads the box; a slab thinner than the halo is refused
    assert domain.decompose(tg, tdec.global_box, 7, OFFS).global_box.cdims[0] % 7 == 0
    with pytest.raises(ValueError, match="thinner than the halo"):
        domain.decompose(tg, tdec.global_box, 12, OFFS)
    with pytest.raises(ValueError, match="fit no shard"):
        domain.shard_particles(tp.replace(x=tp.x + 10.0), tdec)


def test_halo_add_and_fill_match_jax_shard_map(ranks):
    outs, inputs = ranks
    (_, _, jdec), _ = _decomps()
    f = inputs["halo"]
    stacked = jnp.asarray(f.reshape(-1, 3))
    add = _smap(functools.partial(jdom.halo_exchange_add, spec=jdec.spec), 1)(stacked)
    fill = _smap(functools.partial(jdom.halo_fill, spec=jdec.spec), 1)(stacked)
    for r in range(S):
        np.testing.assert_array_equal(to_numpy(outs[r]["halo"]["add"]),
                                      np.asarray(add).reshape(S, -1, 3)[r])
        np.testing.assert_array_equal(to_numpy(outs[r]["halo"]["fill"]),
                                      np.asarray(fill).reshape(S, -1, 3)[r])
        # one exchange each, both directions posted at once
        assert outs[r]["halo"]["stats"]["exchanges"] == 2


@pytest.mark.parametrize("name", ["migrate", "migrate_sorted"])
def test_migration_matches_jax_shard_map(ranks, name):
    outs, inputs = ranks
    (_, _, jdec), _ = _decomps()
    spec, lg, lb = jdec.spec, jdec.local_grid, jdec.local_box

    def mig(p):
        if name == "migrate":
            q, lost = jdom.migrate_local(p, spec, lg, lb)
        else:
            q, lost = jdom.migrate_and_rebin(p, spec, lg, lb, jdec.mig_capacity)
        return q, lost[None]

    q, lost = _smap(mig, 1, 2)(_stack_j(inputs[name]))
    ns = jdec.local_box.n_slots
    moved = 0
    for r in range(S):
        got = outs[r][name]["p"]
        for n in FIELDS:
            np.testing.assert_array_equal(to_numpy(got[n]),
                                          np.asarray(getattr(q, n))[r * ns:(r + 1) * ns],
                                          err_msg=f"rank {r} {n}")
        assert outs[r][name]["lost"] == int(lost[r])
        before = set(to_numpy(inputs[name][r].pid[inputs[name][r].active]))
        moved += len(set(to_numpy(got["pid"][got["active"]])) - before)
    assert moved > 0, "no particle crossed a seam: migration untested"


def test_particle_halo_matches_jax_shard_map(ranks):
    outs, inputs = ranks
    (_, _, jdec), _ = _decomps()
    arrs = inputs["slot_halo"]
    stacked = {k: jnp.asarray(np.concatenate([to_numpy(a[k]) for a in arrs])) for k in arrs[0]}
    ext = _smap(lambda a: jdom.slot_plane_halo(a, jdec.spec, jdec.local_box, 2, H)[0], 1)(
        stacked)
    _, jbox = jdom.slot_plane_halo(
        {k: v[:jdec.local_box.n_slots] for k, v in stacked.items()}, jdom.HaloSpec(
            "g", 1, jdec.spec.wlo, jdec.spec.whi, jdec.spec.bc, jdec.spec.ln),
        jdec.local_box, 2, H)
    for r in range(S):
        got = outs[r]["slot_halo"]
        assert got["ext_box"] == to_torch_box(jbox)
        for k in arrs[0]:
            n = got["ext"][k].shape[0]
            np.testing.assert_array_equal(to_numpy(got["ext"][k]),
                                          np.asarray(ext[k])[r * n:(r + 1) * n], err_msg=k)
            np.testing.assert_array_equal(to_numpy(got["back"][k]), to_numpy(arrs[r][k]))


def test_krylov_solvers_sum_their_dots_over_the_ranks(ranks):
    """Each solver on 4 ranks (all-reduced dots) against the same solver in
    one process on the whole vector: equal iteration counts on every rank,
    the same solution."""
    outs, inputs = ranks
    diag, b, own = inputs["solver"]
    n = len(b)
    T = torch.diag(torch.as_tensor(diag)) - torch.diag(torch.ones(n - 1), 1).double() - torch.diag(
        torch.ones(n - 1), -1).double()
    bt = torch.as_tensor(b)

    def whole(r):
        return np.concatenate([to_numpy(r_[o]) for r_, o in zip(r, own)])

    one = {"pcg": solvers.pcg(lambda v: T @ v, bt, tol=1e-10),
           "bicgstab": solvers.bicgstab(lambda v: T @ v, bt, tol=1e-10),
           "gmres": solvers.gmres(lambda v: T @ v, bt, tol=1e-10)}
    for linear in ("cg", "gmres"):
        one["newton_" + linear] = solvers.newton_krylov(
            lambda x: T @ x + 0.1 * x ** 3 - bt, torch.zeros_like(bt), tol=1e-10, linear=linear,
            cg_tol=1e-10)
    for name, res in one.items():
        got = [o["solver"][name] for o in outs]
        assert {g["iters"] for g in got} == {res.iters}, name
        np.testing.assert_allclose(whole([g["x"] for g in got]), to_numpy(res.x), rtol=1e-8,
                                   atol=1e-10, err_msg=name)
    # a dense solve cannot span the ranks: refused
    with pytest.raises(ValueError, match="dense"):
        solvers.newton_krylov(lambda x: x, bt, linear="dense", axis_name=object())


def test_particle_split_sums_match_one_process(ranks):
    """axis_name without a halo: particles split over the ranks, the grid
    whole on each; every P2G is summed over the group."""
    outs, inputs = ranks
    sf, mask, vals, tg, box, tp, tm, cfg = inputs["split"]
    sp = sparse.p2g(sf["node_ids"], mask, vals, tg.n_nodes)
    wi = twin.p2g(torch.where(mask[..., None], vals, torch.zeros(())), box, tg,
                  tlme.offsets_for(2, tlme.LMEParams(gamma=3.0)))
    q, diag = tex.explicit_step(tp, tg, tm, cfg, torch.zeros(2))
    for r in range(S):
        got = outs[r]["split"]
        torch.testing.assert_close(got["sparse"], sp, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(got["windowed"], wi, rtol=1e-5, atol=1e-7)
        assert int(got["diag"]["nnz"]) == int(diag["nnz"])
        torch.testing.assert_close(got["diag"]["kinetic_energy"], diag["kinetic_energy"],
                                   rtol=1e-5, atol=0)
        mine = (tp.pid % S == r) & tp.active
        for n in ("x", "v", "F"):
            torch.testing.assert_close(got["p"][n][mine], getattr(q, n)[mine], rtol=1e-5,
                                       atol=1e-7)
