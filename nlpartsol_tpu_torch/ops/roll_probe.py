"""Probes of a lane roll: the counterparts of the TPU probes
``scripts/probe_roll.py`` (P1: ten rolls of an (8, 3456) f32 array summed,
checked exactly; P2: 160 rolls summed, timed) and ``scripts/probe_roll2.py``
(P3: 160 roll+add against 160 mul+add at four shapes).

They compute nothing of the MPM system.  They tell what the Hopper
counterpart of a TPU lane roll costs — an indexed read of a row staged in
shared memory (``csrc/roll_probe.cu``) — should a later kernel come to lean
on one.  As everywhere in the port, a wrapper takes the plain version for a
CPU tensor, and for a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_build

Tensor = torch.Tensor

MAX_SHIFTS = 256  # csrc: MAX_SHIFTS
MAX_ROW = 12 * 1024  # a row staged in 48 KB of shared memory

#: launches per kernel: ``launch_counts["roll_sum"]``, ``["mul_sum"]``
launch_counts: collections.Counter = collections.Counter()

# the probes' shifts (scripts/probe_roll.py): P1 spans several 128-lane TPU
# tiles and wraps at both ends; P2/P3 are 160 odd shifts
P1_SHIFTS = (0, 1, 57, 58, 127, 128, 129, 354, 3456 - 354, 3456 - 1)
P2_SHIFTS = tuple(3 + 2 * s for s in range(160))


def reset_launch_counts() -> None:
    launch_counts.clear()


def roll_sum_plain(a: Tensor, shifts) -> Tensor:
    """Σ_k roll(a, s_k) along axis 1, summed in the order of ``shifts``."""
    acc = torch.zeros_like(a)
    for s in shifts:
        acc = acc + torch.roll(a, int(s), dims=1)
    return acc


def mul_sum_plain(a: Tensor, n_ops: int) -> Tensor:
    """Σ_{s < n_ops} a·(1 + s), summed in order."""
    acc = torch.zeros_like(a)
    for s in range(n_ops):
        acc = acc + a * (1.0 + s)
    return acc


def _library():
    lib = cuda_build.load("roll_probe")
    if lib.roll_sum.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.roll_sum.argtypes = [P, P, I, I, ctypes.POINTER(ctypes.c_int), I, P]
        lib.roll_sum.restype = I
        lib.mul_sum.argtypes = [P, P, I, I, I, P]
        lib.mul_sum.restype = I
    return lib


def _check(a: Tensor):
    if a.dtype != torch.float32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError(f"expected a contiguous 2D float32 tensor, got {a.dtype} {tuple(a.shape)}")
    if a.shape[1] > MAX_ROW:
        raise ValueError(f"rows of {a.shape[1]} exceed the {MAX_ROW} a block stages")


def roll_sum(a: Tensor, shifts) -> Tensor:
    """(R, L) f32 → Σ_k roll(a, s_k, dims=1)."""
    if a.device.type == "cpu":
        return roll_sum_plain(a, shifts)
    _check(a)
    if not 1 <= len(shifts) <= MAX_SHIFTS:
        raise ValueError(f"1..{MAX_SHIFTS} shifts, got {len(shifts)}")
    out = torch.empty_like(a)
    arr = (ctypes.c_int * len(shifts))(*[int(s) for s in shifts])
    with torch.cuda.device(a.device):
        err = _library().roll_sum(a.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1], arr,
                                  len(shifts), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roll_sum: CUDA launch failed with cudaError {err}")
    launch_counts["roll_sum"] += 1
    return out


def mul_sum(a: Tensor, n_ops: int) -> Tensor:
    """(R, L) f32 → Σ_{s < n_ops} a·(1 + s)."""
    if a.device.type == "cpu":
        return mul_sum_plain(a, n_ops)
    _check(a)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = _library().mul_sum(a.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1], n_ops,
                                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mul_sum: CUDA launch failed with cudaError {err}")
    launch_counts["mul_sum"] += 1
    return out
