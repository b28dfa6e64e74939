"""Global numerical configuration of the PyTorch port.

Counterpart of ``nlpartsol_tpu/config.py``.  The solver dtype is a
process-level switch:

* ``float32`` (default) — the production dtype on the GPU.
* ``float64`` — opt-in (``NLPS_DTYPE=float64`` or :func:`set_dtype`) for
  verification runs.  The CUDA kernels take float32 only and their wrappers
  refuse float64 tensors on the card: a float64 run takes
  ``transfer="windowed"`` (plain tensor code on either device).

Where the reference pins full-precision matmul accumulation, the port keeps
float32 products in full float32: TF32 keeps about three decimal digits and
would round ``F_{n+1} = (I + ∇Δu)·F_n`` (∇Δu ~ 1e-4) straight back to
``F_n``, so the solver would silently compute rigid motion.
"""

from __future__ import annotations

import os

import torch

_DTYPE_NAME = os.environ.get("NLPS_DTYPE", "float32")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
if _DTYPE_NAME not in _DTYPES:
    raise ValueError(f"unsupported solver dtype: {_DTYPE_NAME}")


def set_dtype(name: str) -> None:
    """Set the solver scalar dtype ('float32' or 'float64')."""
    global _DTYPE_NAME
    if name not in _DTYPES:
        raise ValueError(f"unsupported solver dtype: {name}")
    _DTYPE_NAME = name


def dtype() -> torch.dtype:
    return _DTYPES[_DTYPE_NAME]


def index_dtype() -> torch.dtype:
    return torch.int32


torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

# Numerical tolerances mirroring the reference solver's gates (Newton-Raphson
# tolerance, LME zero tolerance, reciprocal-condition guard).
TOL_NR = 1e-5
TOL_LME = 1e-10
RCOND_GUARD = 1e-8
