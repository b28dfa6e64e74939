"""Command-line driver mirroring the reference CLI (NL-PartSol's
driver-nl-partsol.c:109-175, help at :525-571); counterpart of
``nlpartsol_tpu/cli.py`` with the same flags:

  nl-partsol-torch --FORMULATION-U  -f sim.nlp
  nl-partsol-torch --FORMULATION-U  -ff static.nlp dynamic.nlp   (two-stage)
  python -m nlpartsol_tpu_torch.cli --FORMULATION-U -f sim.nlp

plus the port's options: ``--transfer`` {auto, scatter, windowed, fused}
and ``--platform``, a torch device (default ``cuda``; ``cpu`` runs the
plain versions of the kernels).  The --OPENMP-CORES flag is accepted for
compatibility and ignored.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="nl-partsol-torch",
        description="Material Point Method solver on one GPU (NL-PartSol capabilities)",
    )
    form = ap.add_mutually_exclusive_group()
    form.add_argument("--FORMULATION-U", dest="formulation", action="store_const",
                      const="u", help="single-phase displacement formulation")
    form.add_argument("--FORMULATION-Up", dest="formulation", action="store_const",
                      const="up", help="displacement-pressure formulation")
    form.add_argument("--FORMULATION-Upw", dest="formulation", action="store_const",
                      const="upw", help="soil-water mixture formulation")
    ap.add_argument("-f", dest="sim_file", help="simulation .nlp file")
    ap.add_argument("-ff", dest="two_stage", nargs=2, metavar=("STATIC", "DYNAMIC"),
                    help="two-stage static preload then dynamic run")
    ap.add_argument("--OPENMP-CORES", type=int, default=0,
                    help="(compat; ignored)")
    ap.add_argument(
        "--Fracture-Modulus", dest="Fracture_Modulus", default=None,
        metavar="Eigenerosion|Eigensoftening",
        help="activate nonlocal fracture (reference --Fracture-Modulus, "
        "driver-nl-partsol.c:133-143); requires fracture material params "
        "(Ceps + Gf for Eigenerosion; Ceps/ft/heps/Wc for Eigensoftening)",
    )
    ap.add_argument(
        "--Print-Convergence", dest="Print_Convergence", action="store_true",
        help="per-step Newton/CG convergence monitor (reference __monitor, "
        "U-Newmark-beta.c:2076-2152)",
    )
    ap.add_argument(
        "--transfer",
        choices=["auto", "scatter", "windowed", "fused"],
        default="auto",
        help="particle<->grid engine: 'auto' (default; the fused CUDA kernels "
        "when the step is eligible, the windowed engine otherwise), "
        "'fused' (request the kernels), 'windowed' (plain tensor code on the "
        "slot layout), 'scatter' (segment sums, any particle order)",
    )
    ap.add_argument("--platform", default="cuda",
                    help="torch device to run on (default cuda; e.g. cpu)")
    ap.add_argument("--steps", type=int, default=None, help="override N time steps")
    ap.add_argument("--no-output", action="store_true")
    ap.add_argument(
        "--backup-every", type=int, default=None, metavar="N",
        help="write a resumable checkpoint to <out_dir>/backup.npz every N "
        "steps (overrides the deck's Out-backup key)",
    )
    ap.add_argument(
        "--resume", default=None, metavar="FILE",
        help="resume the deck's schedule from a backup checkpoint "
        "(continues from the saved step to the original end step — the "
        "reference's i0/InitialTimeStep semantics with state actually "
        "loaded, Read_GramsTime.c:140)",
    )
    args = ap.parse_args(argv)

    from .io.builder import build_simulation
    from .driver import run_simulation

    if not args.sim_file and not args.two_stage:
        ap.error("provide -f sim.nlp or -ff static.nlp dynamic.nlp")

    formulation = args.formulation
    fracture = None
    if args.Fracture_Modulus is not None:
        from .io.builder import normalize_fracture

        try:
            fracture = normalize_fracture(args.Fracture_Modulus)
        except ValueError as e:
            raise SystemExit(str(e))

    def _apply_formulation(setup):
        # CLI --FORMULATION-* overrides the .nlp-inferred formulation
        # (driver-nl-partsol.c:115-131)
        if formulation and formulation != setup.formulation:
            if formulation == "upw" and setup.mixtures is None:
                raise SystemExit("-upw needs a Define-Mixture block in the .nlp")
            setup.formulation = formulation
        if fracture is not None:
            setup.fracture = fracture
        return setup

    run_kw = dict(
        transfer=args.transfer,
        write_outputs=not args.no_output,
        n_steps=args.steps,
        print_convergence=args.Print_Convergence,
        backup_every=args.backup_every,
    )
    if args.two_stage:
        # reference -ff flow (driver-nl-partsol.c:206-292): static gravity
        # preload, then continue dynamically with the particle state
        static_setup = _apply_formulation(build_simulation(args.two_stage[0], args.platform))
        p_static, _ = run_simulation(static_setup, **run_kw)
        dyn_setup = _apply_formulation(build_simulation(args.two_stage[1], args.platform))
        dyn_setup = dyn_setup.__class__(**{**dyn_setup.__dict__, "particles": p_static})
        # --resume applies to the dynamic stage (the static preload is
        # cheap and stateless relative to the saved dynamic schedule)
        p, hist = run_simulation(dyn_setup, resume=args.resume, **run_kw)
    else:
        setup = _apply_formulation(build_simulation(args.sim_file, args.platform))
        p, hist = run_simulation(setup, resume=args.resume, **run_kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
