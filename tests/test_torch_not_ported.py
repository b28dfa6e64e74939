"""What the port does not hold fails loudly: the 'binned' transfer names the
do-not-port list (ROADMAP.md queue 2), and an unstructured FEMesh on a
slot-layout engine (or under a fracture driver) raises ValueError naming the
scatter engine.  The sharding options that once waited for item 15 run: on
one shard and a one-rank group each equals the step without them.  Every
step takes every material kind (item 12b)."""

import datetime
import socket

import pytest
import torch
import torch.distributed as dist

from nlpartsol_tpu_torch.formulations import dem as tdem, explicit as tex
from nlpartsol_tpu_torch.formulations import implicit as tim, up as tup, upw as tupw
from nlpartsol_tpu_torch.models import materials as tM
from nlpartsol_tpu_torch.parallel import collectives, domain
from nlpartsol_tpu_torch.shapefun import femesh as tfem, lme as tlme

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
        # a FEMesh has no slot layout: the scatter engine only, no fracture
        ("unstructured", [dict(transfer="windowed"), dict(transfer="fused"),
                          dict(transfer="scatter", damage="eigenerosion")],
         r"scatter engine \(transfer='scatter'\)|fracture drivers require", ValueError),
        ("explicit", [dict(transfer="binned")], "do-not-port list, ROADMAP.md queue 2",
         NOT_PORTED),
    ],
    ids=["unstructured_grid", "transfer=binned"],
)
def test_what_waits_raises_not_implemented(step, changes, match, error):
    _, (tg, tb, tp, lt) = problem(seed=0)
    _, mt = neo_hookean_tables()
    cfg = tex.ExplicitConfig(dt=1e-5, lme_params=lt, active_box=tb, transfer="fused")
    grid = _t3_mesh(tg) if step == "unstructured" else tg
    for change in changes:
        with pytest.raises(error, match=match):
            tex.explicit_step(tp, grid, mt, cfg.replace(**change), torch.zeros(2))


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process: the group a sharding option
    names (its collectives are identities)."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=30))
    yield collectives.Comm()
    dist.destroy_process_group()


def _by_pid(p, names=("x", "v", "damage")):
    order = torch.argsort(p.pid[p.active])
    return {n: getattr(p, n)[p.active][order] for n in names}


def _same(a, b):
    for n, v in _by_pid(a).items():
        torch.testing.assert_close(v, _by_pid(b)[n], rtol=1e-5, atol=1e-7, msg=n)


@pytest.mark.parametrize("case", ["halo,axis_name", "rebin_mode=none", "damage+halo",
                                  "implicit", "upw", "up,dem"])
def test_sharding_options_run(case, one_rank):
    """Each option item 15 used to refuse, on one shard: the step runs and
    equals the step without it, by pid."""
    _, (tg, tb, tp, lt) = problem(seed=0, speed=0.05)
    _, mt = neo_hookean_tables()
    body = torch.zeros(2)
    dec = domain.decompose(tg, tb, 1, tlme.offsets_for(2, lt)).on(one_rank)
    (p1,) = domain.shard_particles(tp, dec)
    (g1,) = domain.shard_grid(tg, dec)

    def sharded(step, cfg, *extra):
        q, diag = step(p1, g1, mt, *extra, domain._localize_cfg(cfg, dec), body)
        return domain.unshard_particles([q], dec), diag

    cfg = tex.ExplicitConfig(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused")
    if case == "halo,axis_name":
        for eng in ("windowed", "fused"):
            c = cfg.replace(transfer=eng)
            _same(sharded(tex.explicit_step, c)[0], tex.explicit_step(tp, tg, mt, c, body)[0])
    elif case == "rebin_mode=none":
        q, diag = tex.explicit_step(tp, tg, mt, cfg.replace(rebin_mode="none"), body)
        assert int(diag["lost"]) == 0
        _same(q, tex.explicit_step(tp, tg, mt, cfg, body)[0])
    elif case == "damage+halo":
        c = cfg.replace(transfer="windowed", damage="eigenerosion", beps_reach=2)
        _same(sharded(tex.explicit_step, c)[0], tex.explicit_step(tp, tg, mt, c, body)[0])
    elif case == "implicit":
        c = tim.ImplicitConfig(dt=1e-3, lme_params=lt, active_box=tb)
        (q, dq), (r, dr) = sharded(tim.implicit_step, c), tim.implicit_step(tp, tg, mt, c, body)
        assert dq["newton_iters"] == dr["newton_iters"]
        _same(q, r)
    elif case == "upw":
        # both u-pw steps on one shard, the halo engine and the fused strip,
        # in float64: 2 Newton iterations of 2 GMRES cycles sit at this
        # problem's float32 floor, where pw carries the GMRES rounding
        mats = tM.material_table([
            tM.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=2700.0),
            tM.material(kind="Newtonian-Fluid-Compressible", rho0=1000.0,
                        compressibility=2.2e7)], device="cpu")
        mix = tupw.make_mixture_table([dict(soil_id=0, water_id=1, phi_s0=0.6, phi_f0=0.4,
                                            permeability=1e-5)], device="cpu")
        tp, mats, mix = (r.map_tensors(lambda t: t.double() if t.is_floating_point() else t)
                         for r in (tupw.init_mixture_state(tp, mats, mix), mats, mix))
        (p1,) = domain.shard_particles(tp, dec)
        body = torch.zeros(2, dtype=torch.float64)
        for c in (tupw.UpwConfig(dt=1e-5, lme_params=lt, active_box=tb, transfer="fused"),
                  tupw.UpwConfig(dt=1e-5, lme_params=lt, active_box=tb),
                  tupw.UpwImplicitConfig(dt=2e-4, lme_params=lt, active_box=tb,
                                         newton_maxiter=2, krylov_maxiter=40)):
            step = tupw.upw_step if isinstance(c, tupw.UpwConfig) else tupw.upw_newmark_step
            q, dq = step(p1, g1, mats, mix, domain._localize_cfg(c, dec), body)
            r, dr = step(tp, tg, mats, mix, c, body)
            assert dq.get("newton_iters") == dr.get("newton_iters")
            _same(domain.unshard_particles([q], dec), r)
    else:
        # in float64 at 2 Newton iterations of at most 40 Krylov ones: a
        # step that re-bins at its start orders its sums otherwise
        tp, mt = (r.map_tensors(lambda t: t.double() if t.is_floating_point() else t)
                  for r in (tp, mt))
        body = torch.zeros(2, dtype=torch.float64)
        for c, step in ((tup.UpConfig(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused",
                                      newton_maxiter=2, krylov_maxiter=40), tup.up_step),
                        (tdem.DEMConfig(dt=1e-4, lme_params=lt, active_box=tb, transfer="fused",
                                        newton_maxiter=2, cg_maxiter=40), tdem.dem_step)):
            q, dq = step(tp, tg, mt, c.replace(axis_name=one_rank, rebin_mode="none"), body)
            r, dr = step(tp, tg, mt, c, body)
            assert dq["newton_iters"] == dr["newton_iters"] and int(dq["nnz"]) == int(dr["nnz"])
            _same(q, r)
