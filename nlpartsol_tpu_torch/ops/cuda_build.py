"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use ``nvcc``
compiles it for ``sm_90a`` into a shared library under
``nlpartsol_tpu_torch/build/`` (git-ignored), and ``ctypes`` loads it.  The
library's file name carries a hash of the source and of the compiler
flags, so an edited source, or another flag, is never served by a stale
build (the sources include no header of their own).  A failed build raises
with the compiler's output; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of nlpartsol_tpu_torch cannot be built here"
    )


def _extra_flags() -> list:
    return shlex.split(os.environ.get("NLPS_NVCC_FLAGS", ""))


def _paths(name: str):
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update("\0".join(NVCC_FLAGS + _extra_flags()).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names) -> list:
    """Compile each ``csrc/<name>.cu`` whose up-to-date library is missing,
    one ``nvcc`` per source, all started together; returns the libraries'
    paths.  Extra ``nvcc`` flags (``-Xptxas -v`` to see registers and
    spills) may be given in the environment variable ``NLPS_NVCC_FLAGS``;
    they are part of the library's hash, so they always rebuild.  The
    compiler's output is printed when there is any."""
    extra = _extra_flags()
    libs, running = [], []
    for name in names:
        src, lib = _paths(name)
        libs.append(lib)
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((proc, cmd, tmp, lib))
    failed = []
    for proc, cmd, tmp, lib in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
        if out.strip():
            print(out.strip())
    if failed:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failed))
    return libs


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its up-to-date library exists;
    returns the library's path (see :func:`build_all`)."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
