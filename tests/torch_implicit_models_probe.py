"""Probes behind the implicit-models phases of chip_smoke.py (not collected
by pytest; run on the card from the repository's root):

    python tests/torch_implicit_models_probe.py calibrate
        each plastic kind's and Hencky's stress update at 65,536 states
        (chip_smoke._model_fn_inputs), primal and forward-mode J·v host ms,
        2D and 3D; then the implicit_models phases (2D, and 3D while the
        run is young)
    python tests/torch_implicit_models_probe.py newton-tol
        the implicit-models problem at 64², 3 steps on the fused and the
        windowed engine at Newton tolerances 1e-5, 1e-6 and 1e-4 and at half
        the time step: Newton and CG counts, ‖R‖/max(1, ‖R₀‖) at the end,
        converged (why the phases take IMPLICIT_MODELS_NEWTON_TOL)
    python tests/torch_implicit_models_probe.py rehearse-models-jv [rows]
        (on the CPU) the models_jv phase on the CPU's own build, its
        tolerances opened: the float32-against-float64 spread that JV_TOL is
        four times of
    python tests/torch_implicit_models_probe.py forward-mode-ops
        (on the CPU) host ms of a (100, 3) product under forward mode: dual
        by plain tensor, dual by dual with a zero tangent, dual by a Python
        scalar, plain by plain
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def calibrate():
    from nlpartsol_tpu_torch.models import dispatch, materials as M
    from nlpartsol_tpu_torch.ops import solvers

    n = 65536
    for dim in (2, 3):
        for name, params in cs.MODEL_STRIPS[2]:
            if name not in ("Von-Mises", "Drucker-Prager", "Matsuoka-Nakai", "Lade-Duncan",
                            "Hencky"):
                continue
            row = M.material(kind=name, **params)
            mats = M.material_table([row], device="cuda")
            inp = cs._model_fn_inputs(name, row, dim, n, seed=1)
            t = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in inp.items()}
            mid = torch.zeros(n, dtype=torch.int32, device="cuda")
            X0 = torch.zeros(n, dim, dim, device="cuda")
            V = 1e-3 * torch.randn(n, dim, dim, device="cuda")

            def f(X):
                return dispatch.stress_integration(
                    F_n1=t["F_n1"], DF=t["DF"] + X, dFdt_n1=t["dFdt_n1"], bemi=t["bemi"],
                    bemi_zz=t["bemi_zz"], eps=t["eps"], kappa=t["kappa"],
                    back_stress=t["back_stress"], mat_id=mid, mats=mats,
                    kinds=(row["kind"],)).tau

            f(X0)
            solvers.jvp(f, X0, V)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f(X0)
            torch.cuda.synchronize()
            primal = time.perf_counter() - t0
            t0 = time.perf_counter()
            solvers.jvp(f, X0, 2.0 * V)
            torch.cuda.synchronize()
            print(json.dumps(dict(probe="calibrate", dim=dim, kind=name, primal_ms=1e3 * primal,
                                  jv_ms=1e3 * (time.perf_counter() - t0))), flush=True)
    cs.phase_implicit_models("cuda", 2)
    if time.perf_counter() - cs.T_START < 600:
        cs.phase_implicit_models("cuda", 3)


def newton_tol():
    from nlpartsol_tpu_torch.formulations.explicit import to_slot_layout
    from nlpartsol_tpu_torch.formulations.implicit import implicit_step
    from nlpartsol_tpu_torch.ops import solvers

    seen, real = {}, solvers.newton_krylov

    def spy(residual, x0, **kw):
        out = real(residual, x0, **kw)
        r0 = residual(x0)
        seen["ratio"] = float(out.residual_norm / torch.clamp(torch.sqrt((r0 * r0).sum()),
                                                              min=1.0))
        return out

    solvers.newton_krylov = spy
    for variant in ("tol1e-5", "dt_half", "tol1e-6", "tol1e-4"):
        grid, p0, mats, cfg, h, _, _ = cs.build_implicit_models(2, "cuda", 64)
        cfg = cfg.replace(newton_tol=1e-5)
        if variant == "dt_half":
            cfg = cfg.replace(dt=cfg.dt / 2)
        elif variant != "tol1e-5":
            cfg = cfg.replace(newton_tol=float(variant[3:]))
        p1 = to_slot_layout(p0, grid, cfg.active_box)
        res = {}
        t0 = time.perf_counter()
        for transfer in ("fused", "windowed"):
            p, out = p1, []
            for _ in range(3):
                p, dg = implicit_step(p, grid, mats, cfg.replace(transfer=transfer),
                                      torch.zeros(2, device="cuda"))
                out.append((dg["newton_iters"], dg["cg_iters"], seen["ratio"],
                            bool(dg["converged"])))
            res[transfer] = out
        print(json.dumps(dict(probe="newton-tol", variant=variant,
                              seconds=time.perf_counter() - t0, **res)), flush=True)


def rehearse_models_jv(rows):
    import torch_fracture_probe

    torch_fracture_probe._stub_cuda()
    cs.JV_ROWS = rows
    cs.JV_TOL = {k: {q: float("inf") for q in v} for k, v in cs.JV_TOL.items()}
    cs.phase_models_jv("cpu")


def forward_mode_ops(reps=1000):
    import torch.autograd.forward_ad as fwAD

    torch.set_num_threads(1)
    a, b = torch.rand(100, 3) + 0.5, torch.randn(100, 3)
    with fwAD.dual_level():
        x = fwAD.make_dual(a, torch.randn(100, 3))
        b0 = fwAD.make_dual(b, torch.zeros_like(b))
        for label, fn in (("dual*plain", lambda: x * b), ("dual*dual0", lambda: x * b0),
                          ("dual*scalar", lambda: x * 2.5), ("plain*plain", lambda: a * b)):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            print(json.dumps(dict(probe="forward-mode-ops", op=label,
                                  ms=1e3 * (time.perf_counter() - t0) / reps)), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "rehearse-models-jv":
        rehearse_models_jv(int(sys.argv[2]) if len(sys.argv) > 2 else 2048)
    elif sys.argv[1] == "forward-mode-ops":
        forward_mode_ops()
    else:
        if not torch.cuda.is_available():
            raise SystemExit("these probes run on the card")
        cs.phase_device()
        cs.phase_build()
        {"calibrate": calibrate, "newton-tol": newton_tol}[sys.argv[1]]()
