"""Collectives of the halo-sharded grid on ``torch.distributed``.

The port's counterpart of ``jax.lax.ppermute``, ``psum`` and
``axis_index`` inside the JAX package's ``shard_map``: a :class:`Comm` names
a process group and this rank's place in it (the JAX axis name), ranks laid
out row-major over the decomposition's shard grid, (S,) or (S0, S1).

* :func:`neighbour_exchange` posts both directions along one shard axis at
  once (``dist.batch_isend_irecv``).  Edge ranks post nothing toward a
  missing neighbour and receive zeros from it, as the JAX ``ppermute``
  pairs give.
* :func:`all_sum` packs every tensor it is given into one buffer and makes
  one ``all_reduce``: a step's scalars, a Krylov dot, a particle-split node
  field.

Transport: with the gloo backend a tensor on a CUDA device is staged
through a pinned host buffer and back (gloo's ``send``/``recv`` take CPU
tensors; NCCL refuses two ranks on one device, so this is the transport of
several ranks sharing one card), counted in ``Comm.stats['bytes_staged']``
and ``['host_syncs']``.  With NCCL (one rank per card) tensors go as they
are; that route needs a card per rank.  Without a process group (one
shard) every collective is the identity.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

Tensor = torch.Tensor


class Comm:
    """A process group, its size and this rank's index in it, and the shape
    of the shard grid its ranks cover (row-major).  ``stats`` counts the
    traffic: ``exchanges``, ``all_reduces``, ``bytes_staged`` (through host
    memory, both ways), ``host_syncs``."""

    def __init__(self, group=None, shape: Optional[Sequence[int]] = None):
        if not dist.is_initialized():
            raise RuntimeError("Comm: no process group (multihost.initialize first)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.shape = tuple(int(s) for s in shape) if shape is not None else (self.size,)
        if _prod(self.shape) != self.size:
            raise ValueError(f"Comm: shard grid {self.shape} does not cover {self.size} ranks")
        self.backend = str(dist.get_backend(group))
        self.stats: collections.Counter = collections.Counter()

    @property
    def coords(self) -> tuple:
        """This rank's index along each shard axis (row-major)."""
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def neighbour(self, axis: int, step: int) -> Optional[int]:
        """Group rank of the neighbour ``step`` (±1) along ``axis``, or None
        past the edge."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        r = 0
        for n, i in zip(self.shape, c):
            r = r * n + i
        return r

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _staged(self, t: Tensor) -> bool:
        return t.device.type == "cuda" and self.backend == "gloo"

    def reset_stats(self) -> None:
        self.stats.clear()


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _to_host(comm: Comm, t: Tensor) -> Tensor:
    if not comm._staged(t):
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    comm.stats["bytes_staged"] += host.numel() * host.element_size()
    return host


def _host_buffer(comm: Comm, like: Tensor) -> Tensor:
    if not comm._staged(like):
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _to_device(comm: Comm, host: Tensor, like: Tensor) -> Tensor:
    if not comm._staged(like):
        return host
    comm.stats["bytes_staged"] += host.numel() * host.element_size()
    return host.to(like.device)


def neighbour_exchange(send_up: Optional[Tensor], send_dn: Optional[Tensor],
                       comm: Optional[Comm], axis: int = 0):
    """Send ``send_up`` to the next rank along ``axis`` and ``send_dn`` to
    the previous one, both at once.  Returns ``(from_dn, from_up)``: what the
    previous rank sent up (shaped as ``send_up``) and what the next rank sent
    down (shaped as ``send_dn``); zeros past an edge, None for a direction
    that carries nothing (the same on every rank)."""
    from_dn = None if send_up is None else torch.zeros_like(send_up)
    from_up = None if send_dn is None else torch.zeros_like(send_dn)
    if comm is None or comm.shape[axis] == 1:
        return from_dn, from_up
    up, dn = comm.neighbour(axis, +1), comm.neighbour(axis, -1)
    ops, recvs = [], []
    if send_up is not None and send_up.numel():
        if up is not None:
            ops.append(dist.P2POp(dist.isend, _to_host(comm, send_up), comm._peer(up),
                                  comm.group))
        if dn is not None:
            buf = _host_buffer(comm, send_up)
            ops.append(dist.P2POp(dist.irecv, buf, comm._peer(dn), comm.group))
            recvs.append(("dn", buf, send_up))
    if send_dn is not None and send_dn.numel():
        if dn is not None:
            ops.append(dist.P2POp(dist.isend, _to_host(comm, send_dn), comm._peer(dn),
                                  comm.group))
        if up is not None:
            buf = _host_buffer(comm, send_dn)
            ops.append(dist.P2POp(dist.irecv, buf, comm._peer(up), comm.group))
            recvs.append(("up", buf, send_dn))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        comm.stats["exchanges"] += 1
        if any(comm._staged(t) for t in (send_up, send_dn) if t is not None):
            comm.stats["host_syncs"] += 1
    for side, buf, like in recvs:
        got = _to_device(comm, buf, like)
        if side == "dn":
            from_dn = got
        else:
            from_up = got
    return from_dn, from_up


def all_sum(tensors: Sequence[Tensor], comm: Optional[Comm]) -> list:
    """Global sums of ``tensors`` over the group, in one ``all_reduce``: the
    tensors are packed into one buffer (float64 when integers and floats
    mix, else their floating type), summed, and returned in their own shapes
    and dtypes.  Every rank gets the same values, so decisions taken on them
    take the same branch everywhere."""
    tensors = [torch.as_tensor(t) for t in tensors]
    if comm is None or comm.size == 1:
        return list(tensors)
    parts = [fwAD.unpack_dual(t) for t in tensors]
    if any(u.tangent is not None for u in parts):
        # forward mode (a J·v through a particle-split P2G): the sum is
        # linear, so the primals and tangents go in the same reduce
        flat = [u.primal for u in parts] + [
            torch.zeros_like(u.primal) if u.tangent is None else u.tangent for u in parts]
        sums = all_sum(flat, comm)
        n = len(parts)
        return [fwAD.make_dual(sums[i], sums[n + i]) for i in range(n)]
    floats = [t.dtype for t in tensors if t.is_floating_point()]
    exact = len(floats) == len(tensors) and len(set(floats)) == 1
    pack_dtype = floats[0] if exact else torch.float64
    dev = tensors[0].device
    flat = torch.cat([t.reshape(-1).to(device=dev, dtype=pack_dtype) for t in tensors])
    staged = comm._staged(flat)
    buf = _to_host(comm, flat)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=comm.group)
    comm.stats["all_reduces"] += 1
    if staged:
        comm.stats["host_syncs"] += 1
    flat = _to_device(comm, buf, flat)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(t.shape).to(t.dtype))
        i += n
    return out
