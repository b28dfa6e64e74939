"""The port's process-group layer (parallel/multihost.py) on 2 gloo ranks
that join from torchrun's environment variables: each rank builds only its
own strip; ``gather_particles`` gives every rank the whole cloud, equal to
``unshard_particles`` of the strips; the shards' VTK files together hold the
whole cloud (the counterpart of tests/test_multihost.py).  And what one shard
does without a group: every collective the identity, the sharded driver the
single-device step."""

import os

import numpy as np
import pytest
import torch

from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch.formulations import explicit as tex
from nlpartsol_tpu_torch.parallel import collectives, domain, multihost
from nlpartsol_tpu_torch.types import Particles

import _torch_domain_worker as worker
from _torch_domain import H, problem, to_numpy
from _torch_port import cheap_jax_compiles, to_torch_box  # noqa: F401

torch.set_num_threads(1)

S = 2
LP = jlme.LMEParams(gamma=3.0)


def _setup():
    (gj, _, _), (tg, tp, tm) = problem(vx=0.5)
    box = to_torch_box(jwin.full_box(gj, capacity=2))
    return tg, tp, tm, box, domain.decompose(tg, box, S, jlme.offsets_for(2, LP))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tg, tp, _, _, dec = _setup()
    vtk_dir = str(tmp_path_factory.mktemp("vtk"))
    cases = [dict(name="mh", kind="multihost", dec=dec, p=tp, vtk_dir=vtk_dir)]
    outs = worker.launch(cases, S, str(tmp_path_factory.mktemp("ranks")), env_init=True)
    return outs, vtk_dir


def _vtk_points(path):
    """The (n, 3) POINTS of a legacy VTK file."""
    tokens = open(path).read().split()
    i = tokens.index("POINTS")
    n = int(tokens[i + 1])
    return np.array(tokens[i + 3:i + 3 + 3 * n], float).reshape(n, 3)


def test_each_rank_builds_its_own_strip_from_the_torchrun_env(ranks):
    outs, _ = ranks
    tg, tp, _, _, dec = _setup()
    host = domain.shard_particles(tp, dec)
    for r, o in enumerate(outs):
        assert o["mh"]["ids"] == [r]
        assert o["mh"]["device"] == "cpu"
        for n in domain._FIELDS:
            torch.testing.assert_close(o["mh"]["mine"][n], getattr(host[r], n), rtol=0, atol=0)


def test_gather_particles_equals_unshard_particles(ranks):
    outs, _ = ranks
    _, tp, _, _, dec = _setup()
    whole = domain.unshard_particles(domain.shard_particles(tp, dec), dec)
    for o in outs:
        gathered = [Particles(**q) for q in o["mh"]["gathered"]]
        back = domain.unshard_particles(gathered, dec)
        for n in domain._FIELDS:
            torch.testing.assert_close(getattr(back, n), getattr(whole, n), rtol=0, atol=0)


def test_shard_vtk_files_together_hold_the_cloud(ranks):
    outs, vtk_dir = ranks
    _, tp, _, _, dec = _setup()
    paths = sorted(p for o in outs for p in o["mh"]["paths"])
    assert [os.path.basename(p) for p in paths] == [
        f"particles_000007_shard{s:03d}.vtk" for s in range(S)]
    # each shard's file holds its particles in pid order, in world coordinates
    pts = np.concatenate([_vtk_points(p) for p in paths])[:, :2]
    mine = [o["mh"]["mine"] for o in outs]
    want = np.concatenate([to_numpy(m["x"][m["active"]][torch.argsort(m["pid"][m["active"]])])
                           + dec.shift(r)[None, :] for r, m in enumerate(mine)])
    np.testing.assert_allclose(pts, want, rtol=1e-6, atol=1e-7)
    assert pts.shape[0] == int(tp.active.sum())


def test_one_shard_needs_no_group():
    """S = 1: the collectives are identities, the halo functions return
    their input, and the sharded driver runs the single-device step."""
    tg, tp, tm, box, _ = _setup()
    a, b = torch.ones(3), torch.arange(4.0)
    from_dn, from_up = collectives.neighbour_exchange(a, b, None)
    assert torch.equal(from_dn, torch.zeros(3)) and torch.equal(from_up, torch.zeros(4))
    assert collectives.all_sum([a, b], None)[1] is b
    dec = domain.decompose(tg, box, 1, jlme.offsets_for(2, LP))
    f = torch.randn(dec.local_grid.n_nodes, 2)
    assert domain.halo_exchange_add(f, dec.spec) is f and domain.halo_fill(f, dec.spec) is f
    cfg = tex.ExplicitConfig(dt=0.3 * H / np.sqrt(10.0), lme_params=LP, transfer="fused",
                             active_box=box)
    # the strip of one shard is the grid padded by phantom planes: the same
    # step in another frame
    (p1,) = domain.shard_particles(tp, dec)
    (g1,) = domain.shard_grid(tg, dec)
    q, diag = domain.sharded_explicit_run(dec, cfg, 5)(p1, g1, tm, torch.zeros(2))
    ref, _ = tex.run(tp, tg, tm, cfg, 5)
    got = domain.unshard_particles([q], dec)
    for name in ("x", "v"):
        a_, b_ = (getattr(z, name)[z.active][torch.argsort(z.pid[z.active])] for z in (got, ref))
        torch.testing.assert_close(a_, b_, rtol=1e-5, atol=1e-6)
    assert int(diag["lost"]) == 0


def test_group_timeouts_are_bounded():
    with pytest.raises(ValueError, match="timeout"):
        multihost.initialize("localhost:1", 1, 0, timeout_s=120.0)
