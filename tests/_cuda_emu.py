"""The port's CUDA sources run on the CPU: the build fixture shared by
``tests/test_torch_cuda_emu2d.py`` and ``tests/test_torch_cuda_emu3d.py``.

A source ``csrc/<name>.cu`` is compiled by the host C++ compiler with
``tests/cuda_emu/cuda_runtime.h``, which emulates what the kernels use of
CUDA: one std::thread per CUDA thread, std::barrier for ``__syncthreads``
and the warp reductions, ``std::atomic_ref`` for atomics, dynamic shared
memory per block.  The library is loaded where the wrappers
look for the CUDA one, so CPU tensors reach it through
``fused_transfer.scatter_cuda`` / ``gather_cuda``.  That holds the kernels'
index arithmetic (cell tiles, footprints, flush, slot layout) and their
algebra to the plain versions on every test run; speed, registers and the
GPU compiler are the chip's to check (``chip_smoke.py``)."""

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import types

import pytest
import torch

from nlpartsol_tpu_torch.ops import cuda_build
from nlpartsol_tpu_torch.ops import fused_transfer as ft

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


def emulated_source(name: str) -> str:
    """``csrc/<name>.cu`` rewritten for the emulation header: the dynamic
    shared array and every ``<<<...>>>`` launch."""
    src = open(os.path.join(cuda_build.CSRC_DIR, name + ".cu")).read()
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];", r"EMU_SHARED(\1, \2);", src)
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch(kernel, grid, ..., args)
    return re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", src)


def build_emulated(name: str) -> str:
    """The CPU library of ``csrc/<name>.cu``, built under
    ``nlpartsol_tpu_torch/build/emu/`` unless its source and the header are
    unchanged since the last build; skips the test without a C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    src = emulated_source(name)
    header = open(os.path.join(EMU_DIR, "cuda_runtime.h")).read()
    digest = hashlib.sha256((src + header).encode()).hexdigest()[:16]
    out = os.path.join(cuda_build.BUILD_DIR, "emu")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"lib{name}_emu_{digest}.so")
    if not os.path.exists(lib):
        cpp = os.path.join(out, f"{name}_emu_{digest}.cpp")
        with open(cpp, "w") as fh:
            fh.write(src)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
             "-I", EMU_DIR, "-o", tmp, cpp], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        os.replace(tmp, lib)
    return lib


@contextlib.contextmanager
def emulated_kernels(name: str):
    """Within the block, the wrappers launch the emulated ``csrc/<name>.cu``
    for CPU tensors through ``scatter_cuda`` / ``gather_cuda``.  ``MIN_TILES``
    is 1, so a test's small box keeps the main paths' tile (several slots a
    thread) instead of the thinner tiles a small box gets on the card."""
    lib = ctypes.CDLL(build_emulated(name))
    mp = pytest.MonkeyPatch()
    mp.setitem(cuda_build._loaded, name, lib)
    mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    mp.setattr(torch.cuda, "current_stream",
               lambda d=None: types.SimpleNamespace(cuda_stream=None))
    mp.setattr(ft, "MIN_TILES", 1)
    ft._tile_plan_of.cache_clear()
    try:
        yield
    finally:
        mp.undo()
        ft._tile_plan_of.cache_clear()
