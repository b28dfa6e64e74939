"""CSV time-series outputs.

Counterpart of ``nlpartsol_tpu/io/csv_out.py``: the same rows and text for
the same particles; the fields a row needs go to the host when it is
recorded.  Reference: NL-PartSol's src/InOutFun/Outputs/NLPS-Out-*.c (~1300 LoC of ``Event``-driven
node-path / particle-path / Gauss-point-evolution writers, Types.h:872-975).
Here: lightweight recorders that accumulate rows per step and flush to CSV.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..types import Particles


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class PathRecorder:
    """Records selected particle (by pid) or node fields over time."""

    def __init__(self, pids: Sequence[int], fields: Sequence[str] = ("x", "v")):
        self.pids = np.asarray(pids, np.int64)
        self.fields = tuple(fields)
        self.rows = []

    def record(self, t: float, p: Particles):
        pid = _host(p.pid)
        act = _host(p.active)
        # pid -> current slot index
        lookup = {int(q): i for i, q in enumerate(pid) if act[i]}
        arrays = {f: _host(getattr(p, f)) for f in self.fields}
        row = [t]
        for q in self.pids:
            idx = lookup.get(int(q))
            for f in self.fields:
                arr = arrays[f]
                if idx is None:
                    row.extend([np.nan] * int(np.prod(arr.shape[1:], dtype=np.int64)))
                elif arr.ndim == 1:
                    row.append(arr[idx])
                else:
                    row.extend(arr[idx].reshape(-1))
        self.rows.append(row)

    _VECTOR_FIELDS = ("x", "v", "a", "dis")
    _TENSOR_FIELDS = ("stress", "F", "eps_tensor")

    def header(self, dim: int) -> str:
        cols = ["t"]
        comps = "xyz"
        for q in self.pids:
            for f in self.fields:
                if f in self._VECTOR_FIELDS:
                    cols.extend(f"p{q}.{f}.{comps[i]}" for i in range(dim))
                elif f in self._TENSOR_FIELDS:
                    cols.extend(
                        f"p{q}.{f}.{comps[i]}{comps[j]}"
                        for i in range(dim)
                        for j in range(dim)
                    )
                else:
                    cols.append(f"p{q}.{f}")
        return ",".join(cols)

    def write(self, path: str, dim: int = 2) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.header(dim) + "\n")
            for row in self.rows:
                fh.write(",".join(f"{v:.8e}" for v in row) + "\n")
        return path


class NodeRecorder:
    """Records nodal field values (e.g. reactions) at fixed node ids.

    ``record`` receives the field ALREADY GATHERED at ``node_ids`` — the
    driver gathers ``r[ids]`` on the device after each step
    (driver.run_simulation) so the recorder must append verbatim, never
    re-index (re-indexing a (len(ids), d) array with global node ids was
    an out-of-bounds/permutation bug)."""

    def __init__(self, node_ids: Sequence[int]):
        self.node_ids = np.asarray(node_ids, np.int64)
        self.rows = []

    def record(self, t: float, gathered: np.ndarray):
        vals = _host(gathered)
        if vals.shape[0] != len(self.node_ids):
            raise ValueError(
                f"NodeRecorder.record expects a ({len(self.node_ids)}, d) "
                f"pre-gathered array, got shape {vals.shape}"
            )
        self.rows.append([t] + vals.reshape(-1).tolist())

    def header(self, dim: int) -> str:
        comps = "xyz"
        cols = ["t"]
        for q in self.node_ids:
            cols.extend(f"n{q}.r.{comps[i]}" for i in range(dim))
        return ",".join(cols)

    def write(self, path: str, dim: int = 2) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.header(dim) + "\n")
            for row in self.rows:
                fh.write(",".join(f"{v:.8e}" for v in row) + "\n")
        return path
