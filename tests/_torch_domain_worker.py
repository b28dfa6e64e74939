"""One rank of the port's halo-sharded tests (launched by
tests/test_torch_domain*.py and tests/test_torch_multihost.py):

    python tests/_torch_domain_worker.py <job dir> <rank> <world size> <port>

Reads ``<job dir>/job.pt`` (a list of cases built by the test in numpy and
carried across as the port's records), joins a gloo group over
``tcp://localhost:<port>`` with a 30 s timeout, runs every case on this
rank's strip on the CPU with one thread, and writes ``<job dir>/out_<rank>.pt``
(one entry per case).  Imports only the port, never JAX.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nlpartsol_tpu_torch.parallel import collectives, domain, multihost  # noqa: E402

torch.set_num_threads(1)

FIELDS = domain._FIELDS


def world_frame(p, dec, comm):
    """This rank's particles in world coordinates, as numpy."""
    return multihost.addressable_particles(p, dec, comm)[0][1]


def case_comm(case, comm):
    """The launch's group, laid out over the case's shard grid."""
    return comm if case.get("shape") is None else collectives.Comm(None, case["shape"])


def run_halo(case, comm):
    spec = dataclasses.replace(case["spec"], comm=comm)
    f = case["fields"][comm.rank]
    return dict(add=domain.halo_exchange_add(f, spec), fill=domain.halo_fill(f, spec),
                stats=dict(comm.stats))


def run_migrate(case, comm):
    dec = case["dec"].on(comm)
    p = case["parts"][comm.rank]
    if isinstance(dec, domain.Decomp2):
        q, lost = domain.migrate_local2(p, dec.spec, case["grids"][comm.rank], dec.local_box)
    elif case.get("sorted"):
        q, lost = domain.migrate_and_rebin(p, dec.spec, case["grids"][comm.rank], dec.local_box,
                                           dec.mig_capacity)
    else:
        q, lost = domain.migrate_local(p, dec.spec, case["grids"][comm.rank], dec.local_box)
    return dict(p={n: getattr(q, n) for n in FIELDS}, lost=int(lost))


def run_slot_halo(case, comm):
    dec = case["dec"].on(comm)
    arrs = case["arrs"][comm.rank]
    ext, ext_box = domain.slot_plane_halo(arrs, dec.spec, dec.local_box, case["reach"],
                                          dec.global_grid.spacing)
    back = {k: domain.slot_plane_restrict(v, dec.spec, dec.local_box, case["reach"])
            for k, v in ext.items()}
    return dict(ext=ext, back=back, ext_box=ext_box)


def run_driver(case, comm):
    """A sharded run from the whole problem: each rank shards its own strip,
    runs, and returns its particles in world coordinates and the diag."""
    dec = case["dec"].on(comm)
    p, grid = case["p"], case["grid"]
    two = isinstance(dec, domain.Decomp2)
    p_mine = multihost.shard_particles_global(p, dec, comm)
    g_mine = multihost.shard_grid_global(grid, dec, comm, device="cpu")
    kind = case["driver"]
    body = case["body"]
    if kind == "explicit":
        run = (domain.sharded_explicit_run2 if two else domain.sharded_explicit_run)(
            dec, case["cfg"], case["steps"])
        q, diag = run(p_mine, g_mine, case["mats"], body)
    elif kind == "implicit":
        run = (domain.sharded_implicit_run2 if two else domain.sharded_implicit_run)(
            dec, case["cfg"], case["steps"])
        q, diag = run(p_mine, g_mine, case["mats"], body)
    elif kind == "upw":
        run = domain.sharded_upw_run(dec, case["cfg"], case["mix"], case["steps"])
        q, diag = run(p_mine, g_mine, case["mats"], body)
    else:
        raise ValueError(kind)
    return dict(p=world_frame(q, dec, comm), diag=diag, stats=dict(comm.stats))


def run_solver(case, comm):
    """The tridiagonal operator of tests/test_torch_domain.py on this rank's
    strip: each Krylov solver and Newton-Krylov with all-reduced dots."""
    from nlpartsol_tpu_torch.ops import solvers

    spec = domain.HaloSpec(**case["spec"], comm=comm)
    owned = domain.plane_owned_mask(spec).to(torch.float64)
    diag = case["diag"][comm.rank]
    b = case["b"][comm.rank]

    def A(v):
        vf = domain.halo_fill(v, spec)
        pad = torch.nn.functional.pad(vf, (1, 1))
        return owned * (diag * vf - pad[:-2] - pad[2:])

    out = {}
    for name, fn in (("pcg", solvers.pcg), ("bicgstab", solvers.bicgstab),
                     ("gmres", solvers.gmres)):
        res = fn(A, b, tol=1e-10, axis_name=comm)
        out[name] = dict(x=res.x, iters=res.iters, residual=res.residual)

    def residual(x):
        return A(x) + owned * 0.1 * x ** 3 - b

    for linear in ("cg", "gmres"):
        res = solvers.newton_krylov(residual, torch.zeros_like(b), tol=1e-10, linear=linear,
                                    cg_tol=1e-10, axis_name=comm)
        out["newton_" + linear] = dict(x=res.x, iters=res.iters, lin=res.linear_iters,
                                       residual=res.residual_norm)
    return out


def run_split(case, comm):
    """Particles split over ranks, the grid whole on each: the P2G of both
    engines and a scatter-engine explicit step with ``axis_name``."""
    from nlpartsol_tpu_torch.formulations import explicit
    from nlpartsol_tpu_torch.ops import sparse, windowed

    mine = case["owner"] == comm.rank
    vals = case["vals"]
    sp = sparse.p2g(case["ids"], case["mask"] & mine[:, None], vals, case["n_nodes"],
                    axis_name=comm)
    wmask = case["wmask"] & (case["wowner"][:, None] == comm.rank)
    wvals = torch.where(wmask[..., None], case["wvals"], torch.zeros(()))
    wi = windowed.p2g(wvals, case["box"], case["grid"], case["offsets"], axis_name=comm)
    p = case["p"]
    p = p.replace(active=p.active & mine)
    q, diag = explicit.explicit_step(p, case["grid"], case["mats"],
                                     case["cfg"].replace(axis_name=comm), case["body"])
    return dict(sparse=sp, windowed=wi, p={n: getattr(q, n) for n in FIELDS},
                diag={k: v for k, v in diag.items() if k != "reactions"})


def run_multihost(case, comm):
    dec = case["dec"].on(comm)
    p_mine = multihost.shard_particles_global(case["p"], dec, comm)
    gathered = multihost.gather_particles(p_mine, comm)
    paths = multihost.write_shard_vtk(case["vtk_dir"], 7, p_mine, dec, comm)
    return dict(mine={n: getattr(p_mine, n) for n in FIELDS},
                gathered=[{n: getattr(q, n) for n in FIELDS} for q in gathered],
                paths=paths, device=str(multihost.local_device("cpu")),
                ids=multihost.my_shard_ids(comm))


KINDS = dict(halo=run_halo, migrate=run_migrate, slot_halo=run_slot_halo, driver=run_driver,
             solver=run_solver, split=run_split, multihost=run_multihost)


def launch(cases, world, job_dir, env_init=False, timeout_s=60):
    """Run ``cases`` on ``world`` gloo ranks (one process each, one thread)
    and return their outputs by rank; a rank that fails, reports a case's
    error or outlives ``timeout_s`` fails the launch."""
    os.makedirs(job_dir, exist_ok=True)
    torch.save(dict(cases=cases, env_init=env_init), os.path.join(job_dir, "job.pt"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job_dir, str(r),
                               str(world), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=timeout_s)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        if pr.returncode != 0 or "TORCH_DOMAIN_WORKER_OK" not in log:
            raise RuntimeError(f"rank {r} failed ({pr.returncode}):\n{log[-4000:]}")
    outs = [torch.load(os.path.join(job_dir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]
    errors = [f"rank {r}, {name}:\n{res['error']}" for r, out in enumerate(outs)
              for name, res in out.items() if isinstance(res, dict) and "error" in res]
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def main():
    job_dir, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    cases = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    if cases.get("env_init"):
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world),
                          RANK=str(rank))
        multihost.initialize()
    else:
        multihost.initialize(f"localhost:{port}", world, rank)
    world_comm = multihost.global_comm()
    out = {}
    for case in cases["cases"]:
        comm = case_comm(case, world_comm)
        comm.reset_stats()
        t0 = time.perf_counter()
        try:
            out[case["name"]] = KINDS[case["kind"]](case, comm)
        except Exception:  # reported to the test, which fails on it
            out[case["name"]] = dict(error=traceback.format_exc())
        out[case["name"]]["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(job_dir, f"out_{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("TORCH_DOMAIN_WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
