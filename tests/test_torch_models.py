"""The port's constitutive update (models/) and small-tensor algebra
(ops/tensor.py) against the JAX package's on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nlpartsol_tpu.models import dispatch as jcon, hyperelastic as jhyper, materials as jM
from nlpartsol_tpu.ops import tensor as jtn

from nlpartsol_tpu_torch.formulations import common
from nlpartsol_tpu_torch.models import dispatch as tcon, hyperelastic as thyper, materials as tM
from nlpartsol_tpu_torch.ops import tensor as ttn

from _torch_port import cheap_jax_compiles, fields_to_numpy, to_torch_materials  # noqa: F401

torch.set_num_threads(1)


def _deformation_gradients(n, scale, seed):
    rng = np.random.default_rng(seed)
    return (np.eye(2) + scale * rng.standard_normal((n, 2, 2))).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-6, 1e-4, 1e-2, 0.1, 0.3])
def test_neo_hookean_matches_jax(scale):
    F = _deformation_gradients(64, scale, 0)
    E = np.full(64, 1e7, np.float32)
    nu = np.full(64, 0.3, np.float32)
    ref = jax.jit(jhyper.neo_hookean)(jnp.asarray(F), jnp.asarray(E), jnp.asarray(nu))
    got = thyper.neo_hookean(torch.as_tensor(F), torch.as_tensor(E), torch.as_tensor(nu))
    # the same cancellation-free float32 expressions: agreement to rounding,
    # absolute floor a few ulps of the modulus times the strain
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-5, atol=2e-6 * np.abs(r).max())


def test_small_tensor_algebra_matches_jax():
    A = _deformation_gradients(32, 0.2, 1)
    v = np.random.default_rng(2).standard_normal((32, 2)).astype(np.float32)
    a_t, a_j = torch.as_tensor(A), jnp.asarray(A)
    names = ("trace", "det", "adj", "inv", "inv_transpose", "det_minus_one",
             "bmi_from_disp_grad")
    refs = jax.jit(lambda a: [getattr(jtn, n)(a) for n in names])(a_j)
    for name, ref in zip(names, refs):
        np.testing.assert_allclose(getattr(ttn, name)(a_t).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    x = np.concatenate([np.linspace(-0.5, 2.0, 50), np.linspace(-1e-2, 1e-2, 21)]).astype(np.float32)
    np.testing.assert_allclose(ttn.sub_log1p(torch.as_tensor(x)).numpy(),
                               np.asarray(jtn.sub_log1p(jnp.asarray(x))), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(ttn.bmm(a_t, a_t).numpy(), np.asarray(jtn.bmm(a_j, a_j)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ttn.bmm_t(a_t, a_t).numpy(), np.asarray(jtn.bmm_t(a_j, a_j)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ttn.bmv(a_t, torch.as_tensor(v)).numpy(),
                               np.asarray(jtn.bmv(a_j, jnp.asarray(v))), rtol=1e-5, atol=1e-6)
    A3 = (np.eye(3) + 0.1 * np.random.default_rng(3).standard_normal((8, 3, 3))).astype(np.float32)
    for name in ("det", "inv", "det_minus_one"):
        np.testing.assert_allclose(getattr(ttn, name)(torch.as_tensor(A3)).numpy(),
                                   np.asarray(getattr(jtn, name)(jnp.asarray(A3))),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_stress_integration_blends_kinds_like_jax():
    rows = [dict(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3),
            dict(kind="Solid-Rigid"),
            dict(kind="Neo-Hookean-Wriggers", E=5e6, nu=0.2)]
    mj = jM.material_table([jM.material(**r) for r in rows])
    mt = tM.material_table([tM.material(**r) for r in rows], device="cpu")
    for name, ref in fields_to_numpy(mj).items():
        np.testing.assert_array_equal(getattr(mt, name).numpy(), ref, err_msg=name)
    assert mt.kinds_present() == mj.kinds_present() and mt.count == 3
    assert fields_to_numpy(mj).keys() == vars(to_torch_materials(mj)).keys()
    lam_g = tM.lame_parameters(1e6, 0.3), tM.bulk_shear(1e6, 0.3)
    assert lam_g == (jM.lame_parameters(1e6, 0.3), jM.bulk_shear(1e6, 0.3))

    n = 90
    rng = np.random.default_rng(4)
    F = _deformation_gradients(n, 0.05, 5)
    mat_id = rng.integers(0, 3, n).astype(np.int32)
    state = dict(bemi=rng.standard_normal((n, 2, 2)), bemi_zz=rng.standard_normal(n),
                 eps=rng.random(n), kappa=rng.random(n), back_stress=rng.standard_normal((n, 3)))
    state = {k: v.astype(np.float32) for k, v in state.items()}
    kinds = (jM.NEO_HOOKEAN, jM.SOLID_RIGID)
    ref = jax.jit(lambda F_, st: jcon.stress_integration(
        F_n1=F_, DF=F_, dFdt_n1=jnp.zeros_like(F_), mat_id=jnp.asarray(mat_id), mats=mj,
        kinds=kinds, **st))(jnp.asarray(F), {k: jnp.asarray(v) for k, v in state.items()})
    got = tcon.stress_integration(
        F_n1=torch.as_tensor(F), DF=torch.as_tensor(F), dFdt_n1=torch.zeros(n, 2, 2),
        mat_id=torch.as_tensor(mat_id), mats=mt, kinds=kinds,
        **{k: torch.as_tensor(v) for k, v in state.items()})
    assert got._fields == ref._fields
    for name in got._fields:
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=2e-5,
                                   atol=2e-6 * max(np.abs(r).max(), 1.0), err_msg=name)
    assert float(got.tau[torch.as_tensor(mat_id) == 1].abs().max()) == 0.0

    # the dispatch takes every kind (tests/test_torch_models_more.py), and
    # so does every step: the kind filter of the implicit, u-p, u-pw and DEM
    # steps is gone (tests/test_torch_implicit_models.py,
    # test_torch_mixture_models.py run them with the return mappings)
    assert not hasattr(common, "check_hyperelastic_kinds")
    with pytest.raises(ValueError, match="unknown material kind"):
        tcon.stress_integration(
            F_n1=torch.as_tensor(F), DF=torch.as_tensor(F), dFdt_n1=torch.zeros(n, 2, 2),
            mat_id=torch.as_tensor(mat_id), mats=mt, kinds=(99,),
            **{k: torch.as_tensor(v) for k, v in state.items()})
    with pytest.raises(ValueError, match="unknown material parameters"):
        tM.material(youngs=1.0)
