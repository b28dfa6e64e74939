"""Pattern accounting for the particle↔grid transfers.

Counterpart of ``nlpartsol_tpu/ops/sparse.py``; only :func:`nnz` is needed by
the structured-grid path (the general scatter engine comes with the
unstructured-mesh slice).
"""

from __future__ import annotations

import torch


def nnz(mask: torch.Tensor) -> torch.Tensor:
    """Number of nonzeros in the current pattern (for nnz/s accounting);
    a 0-dim int32 tensor on the mask's device."""
    return torch.sum(mask, dtype=torch.int32)
