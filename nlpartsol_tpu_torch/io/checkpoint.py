"""Checkpoint / resume (counterpart of ``nlpartsol_tpu/io/checkpoint.py``).

The full particle SoA and the step counter round-trip through one
compressed npz, in the JAX package's layout and keys (``particles.<field>``,
``meta.step``, ``meta.version``, ``extra.<name>``): a backup written by
either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ..types import Particles

_FORMAT_VERSION = 1


def save_checkpoint(path: str, p: Particles, step: int, extra: dict = None) -> str:
    """Write particle state + step counter (+ optional extra arrays)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fields = {f"particles.{f.name}": getattr(p, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(p)}
    fields["meta.step"] = np.asarray(step, np.int64)
    fields["meta.version"] = np.asarray(_FORMAT_VERSION, np.int64)
    for k, v in (extra or {}).items():
        fields[f"extra.{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **fields)
    # np.savez appends .npz to the name it's given
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    return path


def load_checkpoint(path: str, device="cuda") -> Tuple[Particles, int, dict]:
    """Restore (particles on ``device``, step, extra)."""
    data = np.load(path)
    version = int(data["meta.version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
    kw = {
        key.split(".", 1)[1]: torch.as_tensor(data[key], device=device)
        for key in data.files
        if key.startswith("particles.")
    }
    extra = {
        key.split(".", 1)[1]: data[key]
        for key in data.files
        if key.startswith("extra.")
    }
    return Particles(**kw), int(data["meta.step"]), extra
