"""Tracing / profiling (counterpart of ``nlpartsol_tpu/utils/profiling.py``).

* :func:`trace` — context manager around ``torch.profiler.profile``; the
  trace is written to ``log_dir`` as a Chrome trace (device timelines where
  the profiler sees the card, the host's ops otherwise).
* :class:`StageTimer` — coarse per-stage wall timers that synchronise the
  device at the boundaries, for host-side stage breakdowns (the driver's
  ``stage_timings``).
* :func:`annotate` — a named ``record_function`` region, so custom stages
  show up on the timeline inside a :func:`trace` capture.
* :func:`throughput` — nnz/s + step/s summary dict from counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace into ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region on the timeline (inside a :func:`trace`)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulating per-stage wall timers with device synchronisation.

    >>> st = StageTimer()
    >>> with st("p2g", sync=out_tensor):
    ...     out_tensor = step(...)
    >>> st.summary()                   # {'p2g': {'total_s': ..., 'calls': N}}

    A region given ``sync`` (a tensor, or anything with a ``device``) waits
    for that device at exit, so stage times are honest on an asynchronous
    card — use at driver granularity (per chunk, per output event), not
    around single ops.
    """

    def __init__(self):
        self.totals: dict = {}
        self.calls: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device = getattr(sync, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: dict(total_s=self.totals[k], calls=self.calls[k],
                    mean_s=self.totals[k] / max(self.calls[k], 1))
            for k in self.totals
        }

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'stage':<28}{'total s':>10}{'calls':>8}{'mean ms':>10}{'%':>6}"]
        for k, v in rows:
            n = self.calls[k]
            lines.append(
                f"{k:<28}{v:>10.3f}{n:>8}{1e3 * v / max(n, 1):>10.2f}"
                f"{100 * v / total:>6.1f}"
            )
        return "\n".join(lines)


def throughput(nnz_total: int, steps: int, wall_s: float) -> dict:
    """nnz/s + step-rate summary."""
    return dict(
        nnz=int(nnz_total),
        steps=int(steps),
        wall_s=float(wall_s),
        nnz_per_s=float(nnz_total) / max(wall_s, 1e-12),
        steps_per_s=float(steps) / max(wall_s, 1e-12),
    )
