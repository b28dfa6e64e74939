"""Process groups for the halo-sharded grid, one rank a shard.

Counterpart of ``nlpartsol_tpu/parallel/multihost.py`` on
``torch.distributed``.  Where the JAX package spans a mesh over every device
of every process, the port runs one rank per shard: rank r holds strip r of
the decomposition (parallel/domain.py), builds only that strip, and writes
only its own output.

Usage (one call per rank, e.g. under ``torchrun --nproc-per-node 2``)::

    from nlpartsol_tpu_torch.parallel import domain, multihost
    multihost.initialize()                      # torchrun's RANK, WORLD_SIZE, ...
    comm = multihost.global_comm()
    dec = domain.decompose(grid, box, comm.size, offsets, margin=1).on(comm)
    p_mine = multihost.shard_particles_global(p, dec, comm)
    g_mine = multihost.shard_grid_global(grid, dec, comm)
    run = domain.sharded_explicit_run(dec, cfg, n_steps)
    p_mine, diag = run(p_mine, g_mine, mats, body)
    multihost.write_shard_vtk(out_dir, n_steps, p_mine, dec, comm)

Each rank's device is ``cuda:(local_rank % device_count)``; the CPU only
where the caller asks for it.  The backend is gloo unless asked otherwise:
ranks that share a card cannot use NCCL, and gloo stages CUDA tensors
through host memory (parallel/collectives.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..types import Grid, Particles
from . import domain
from .collectives import Comm
from .domain import _pack, _unpack

_FIELDS = domain._FIELDS
#: the longest a collective may wait before the group fails (seconds)
MAX_TIMEOUT_S = 60.0


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo",
               timeout_s: float = 30.0) -> None:
    """Join the process group.  Arguments left None come from torchrun's
    environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``),
    as the JAX package's auto-detects its cluster.  The group's timeout is
    finite (at most 60 s): a rank that hangs fails the run."""
    if timeout_s > MAX_TIMEOUT_S:
        raise ValueError(f"timeout {timeout_s} s is above {MAX_TIMEOUT_S} s")
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_comm(shape=None) -> Comm:
    """Every rank of the process group, row-major over ``shape`` (default
    1-D)."""
    return Comm(None, shape)


def local_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: ``device`` when given, else the card
    ``local_rank % device_count`` (``LOCAL_RANK``, default the rank)."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


def my_shard_ids(comm: Comm) -> list:
    """The shards this rank holds: its own (one rank a shard)."""
    return [comm.rank]


def shard_particles_global(p: Particles, dec, comm: Comm) -> Particles:
    """This rank's strip only: its particles binned in its frame (no rank
    builds another's)."""
    if isinstance(dec, domain.Decomp2):
        return domain.shard_particles2(p, dec, shards=my_shard_ids(comm))[0]
    return domain.shard_particles(p, dec, shards=my_shard_ids(comm))[0]


def shard_grid_global(grid: Grid, dec, comm: Comm, device=None) -> Grid:
    if isinstance(dec, domain.Decomp2):
        return domain.shard_grid2(grid, dec, shards=my_shard_ids(comm), device=device)[0]
    return domain.shard_grid(grid, dec, shards=my_shard_ids(comm), device=device)[0]


def gather_particles(p_local: Particles, comm: Comm) -> list:
    """Every rank's particles (device frames, slot layouts) on every rank,
    as CPU tensors in shard order — for :func:`~.domain.unshard_particles`;
    O(global size) a rank: use :func:`write_shard_vtk` for large runs."""
    host = {n: getattr(p_local, n).detach().cpu() for n in _FIELDS}
    rows = p_local.count
    buf = _pack(host, rows)
    bufs = [torch.empty_like(buf) for _ in range(comm.size)]
    dist.all_gather(bufs, buf, group=comm.group)
    return [Particles(**_unpack(b, host)) for b in bufs]


def addressable_particles(p_local: Particles, dec, comm: Comm) -> list:
    """This rank's particles shifted back to world coordinates, as numpy:
    [(shard id, {field: array})] — the gather-free output path."""
    out = []
    for sid in my_shard_ids(comm):
        if isinstance(dec, domain.Decomp2):
            shift = dec.shift(*dec.shard_coords()[sid])
        else:
            shift = dec.shift(sid)
        arrays = {n: getattr(p_local, n).detach().cpu().numpy() for n in _FIELDS}
        arrays["x"] = arrays["x"] + shift[None, :].astype(arrays["x"].dtype)
        out.append((sid, arrays))
    return out


def write_shard_vtk(out_dir: str, step: int, p_local: Particles, dec, comm: Comm,
                    **vtk_kw) -> list:
    """Gather-free VTK output: one particle-cloud file per shard this rank
    holds (``particles_<step>_shard<k>.vtk``); the files of every rank
    together are the whole cloud.  Returns the paths this rank wrote."""
    from ..io import vtk as vtk_mod

    paths = []
    for sid, arrays in addressable_particles(p_local, dec, comm):
        loc = Particles(**{n: torch.as_tensor(np.ascontiguousarray(a))
                           for n, a in arrays.items()})
        path = os.path.join(out_dir, f"particles_{step:06d}_shard{sid:03d}.vtk")
        paths.append(vtk_mod.write_particles_vtk(path, loc, **vtk_kw))
    return paths
