"""The port's slot-layout engine (ops/windowed.py: binning, slot permute,
local re-bin, P2G, G2P) against the JAX package's on the same numpy inputs,
both on the CPU.  Integers are equal and floats agree to 1e-6: the same
float32 operations in the same order — only the libraries' kernels differ."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nlpartsol_tpu.ops import windowed as jwin
from nlpartsol_tpu.shapefun import lme as jlme

from nlpartsol_tpu_torch.ops import windowed as twin
from nlpartsol_tpu_torch.shapefun import lme as tlme

from _torch_port import cheap_jax_compiles, fields_to_numpy, problem  # noqa: F401

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _assert_particles_equal(tp, pj, rows=None):
    """Every field, slot by slot (ints and bools equal, floats to 1e-6)."""
    for name, ref in fields_to_numpy(pj).items():
        got = getattr(tp, name).numpy()
        if rows is not None:
            got, ref = got[rows], ref[rows]
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, err_msg=name, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)


def test_bin_particles_and_permute_match_jax():
    (gj, bj, pj, _), (tg, tb, tp, _) = problem(seed=0, slots=False)
    # an inactive particle and one outside the box must both be dropped
    act = np.ones(pj.count, bool)
    act[7] = False
    x = np.asarray(pj.x).copy()
    x[11] = [-0.05, 0.5]
    pj = pj.replace(x=jnp.asarray(x), active=jnp.asarray(act))
    tp = tp.replace(x=torch.as_tensor(x), active=torch.as_tensor(act))

    @jax.jit
    def bin_and_permute(q):
        b = jwin.bin_particles(gj, bj, q.x, q.active)
        return b, jwin.permute_to_slots(q, b)

    bin_j, slots_j = bin_and_permute(pj)
    bin_t = twin.bin_particles(tg, tb, tp.x, tp.active)
    np.testing.assert_array_equal(bin_t.slot_particle.numpy(), np.asarray(bin_j.slot_particle))
    np.testing.assert_array_equal(bin_t.valid.numpy(), np.asarray(bin_j.valid))
    assert int(bin_t.lost) == int(bin_j.lost) == 1
    assert bin_t.slot_particle.dtype == torch.int32

    _assert_particles_equal(twin.permute_to_slots(tp, bin_t), slots_j)

    assert twin.required_capacity(tg, tb, tp.x, tp.active) == jwin.required_capacity(
        gj, bj, x, act)
    assert twin.default_box(tg, tp.x) == twin.ActiveBox(
        **{k: tuple(v) if k != "capacity" else v
           for k, v in vars(jwin.default_box(gj, x)).items()})
    np.testing.assert_array_equal(twin.slot_cells(tb), jwin.slot_cells(bj))


def test_capacity_overflow_is_counted():
    (gj, bj, pj, _), (tg, tb, tp, _) = problem(seed=1, slots=False)
    bj1, tb1 = bj.replace(capacity=1), tb.replace(capacity=1)
    bin_j = jax.jit(lambda x, a: jwin.bin_particles(gj, bj1, x, a))(pj.x, pj.active)
    bin_t = twin.bin_particles(tg, tb1, tp.x, tp.active)
    assert int(bin_t.lost) == int(bin_j.lost) > 0
    np.testing.assert_array_equal(bin_t.slot_particle.numpy(), np.asarray(bin_j.slot_particle))


def test_local_rebin_after_one_cell_drift_matches_jax():
    (gj, bj, pj, _), (tg, tb, tp, _) = problem(seed=2)
    rng = np.random.default_rng(3)
    h = gj.spacing
    x = np.asarray(pj.x) + (h * (2 * rng.random((pj.count, 2)) - 1)).astype(np.float32)
    sel = np.flatnonzero(np.asarray(pj.active))
    x[sel[0]] += 2.5 * h  # drifts more than one cell: lost
    x[sel[1]] = [-0.02, -0.02]  # leaves the box: lost
    pj = pj.replace(x=jnp.asarray(x))
    tp = tp.replace(x=torch.as_tensor(x))

    pj2, lost_j = jax.jit(lambda q: jwin.local_rebin(q, gj, bj))(pj)
    tp2, lost_t = twin.local_rebin(tp, tg, tb)
    assert int(lost_t) == int(lost_j) == 2
    # the same particle in the same slot (ranks follow the walk order of the
    # 3^d neighbour groups), empty slots zeroed
    _assert_particles_equal(tp2, pj2)
    assert tp2.pid.dtype == torch.int32 and tp2.active.dtype == torch.bool
    # every surviving particle now sits in the cell of its slot
    cells = torch.as_tensor(twin.slot_cells(tb))
    act = tp2.active
    assert torch.equal(tg.cell_of(tp2.x)[act], cells[act])

    # in_capacity: two extra rows of incoming particles are compacted to C
    C, nc = tb.capacity, tb.n_cells
    extra = tp.map_tensors(lambda a: a[: 2 * nc])
    wide = tp.map_tensors(lambda a: a).replace(
        **{n: torch.cat([getattr(tp, n), getattr(extra, n)]) for n in fields_to_numpy(pj)})
    wide = wide.replace(active=torch.cat([tp.active, torch.zeros(2 * nc, dtype=torch.bool)]))
    tp3, lost3 = twin.local_rebin(wide, tg, tb, in_capacity=C + 2)
    assert int(lost3) == 2 and tp3.count == tb.n_slots
    _assert_particles_equal(tp3, pj2)


def test_p2g_g2p_and_edge_field_match_jax():
    (gj, bj, pj, lj), (tg, tb, tp, lt) = problem(seed=4)
    offs = jlme.offsets_for(2, lj)
    np.testing.assert_array_equal(tlme.offsets_for(2, lt), offs)
    # the transfers are linear in the weights: any masked (Ns, K) array does
    w_rng = np.random.default_rng(6)
    mask = (w_rng.random((pj.count, len(offs))) < 0.5) & np.asarray(pj.active)[:, None]
    N = np.where(mask, w_rng.random(mask.shape), 0.0).astype(np.float32)
    rng = np.random.default_rng(5)
    vel = rng.standard_normal((pj.count, 2)).astype(np.float32)
    vals = (N * np.asarray(pj.mass)[:, None])[..., None] * vel[:, None, :]
    field = rng.standard_normal((gj.n_nodes, 2)).astype(np.float32)

    p2g_j = jax.jit(lambda v: jwin.p2g(v, bj, gj, offs))
    np.testing.assert_allclose(
        twin.p2g(torch.as_tensor(vals), tb, tg, offs).numpy(),
        np.asarray(p2g_j(jnp.asarray(vals))), **FLOAT_TOL)
    np.testing.assert_allclose(
        twin.p2g(torch.as_tensor(vals[..., 0]), tb, tg, offs).numpy(),
        np.asarray(p2g_j(jnp.asarray(vals[..., 0]))), **FLOAT_TOL)
    np.testing.assert_allclose(
        twin.g2p(torch.as_tensor(field), torch.as_tensor(N), tb, tg, offs).numpy(),
        np.asarray(jax.jit(lambda f, w: jwin.g2p(f, w, bj, gj, offs))(
            jnp.asarray(field), jnp.asarray(N))), **FLOAT_TOL)
    np.testing.assert_array_equal(
        twin.cell_edge_field(torch.as_tensor(field), tb, tg, offs).numpy(),
        np.asarray(jax.jit(lambda f: jwin.cell_edge_field(f, bj, gj, offs))(
            jnp.asarray(field))))
