"""ctypes binding of the C++ GiD mesh parser (``native/nlps_native.cpp``).

Counterpart of ``nlpartsol_tpu/io/native.py``, for the parser the port's
reader uses.  The source lives at the repository root, beside both
packages; here ``g++`` builds it at first use into
``nlpartsol_tpu_torch/build/`` (git-ignored) under a name that carries a
hash of the source, the flags, the compiler's version and the host's C
library, so neither an edited source nor a copy of the tree on another host
is served by a library built for something else.
The library has a plain C ABI, consumed via ctypes.

:func:`available` says whether the library could be built and loaded (no
``g++`` means the pure-Python reader of ``io/gid_mesh.py``).  Once a parse
has begun, its failure raises: nothing falls back after that point.
The library's mesh-topology entry points serve unstructured background
meshes, which wait for ROADMAP.md queue 1, item 13.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "native", "nlps_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_tried = False


def _build():
    """Path of the built library, or None when the source or ``g++`` is
    missing.  A compiler that runs and fails raises with its output."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(SRC):
        return None
    with open(SRC, "rb") as fh:
        h = hashlib.sha256(fh.read())
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                             check=True).stdout
    h.update("\0".join([*_FLAGS, version, platform.machine(), *platform.libc_ver()]).encode())
    lib = os.path.join(BUILD_DIR, f"libnlps_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    r = subprocess.run([gxx, *_FLAGS, "-o", tmp, SRC], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ build of {SRC} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders each install a whole file
    return lib


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    path = _build()  # a failed build raises, each time the library is asked for
    _tried = True
    if path is None:
        return None
    lib = C.CDLL(path)
    lib.nlps_free.argtypes = [C.c_void_p]
    lib.nlps_free.restype = None
    lib.nlps_read_gid_mesh.argtypes = [
        C.c_char_p, C.POINTER(C.c_int), C.POINTER(C.c_int),
        C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.POINTER(C.c_double)),
        C.POINTER(C.POINTER(C.c_int64)), C.c_char_p,
    ]
    lib.nlps_read_gid_mesh.restype = C.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


_ERRORS = {1: "cannot open the file", 2: "short read", 3: "no MESH header, nodes or Nnode"}


def read_gid_mesh_native(path: str):
    """C++ GiD parser → (dim, elem_name, coords (n, dim) float64, conn (e,
    nnode) int64, 0-indexed).  Raises ``ValueError`` when the parse fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native GiD parser is not available (see available())")
    dim, nnode = C.c_int(), C.c_int()
    n_nodes, n_elems = C.c_int64(), C.c_int64()
    coords_p = C.POINTER(C.c_double)()
    conn_p = C.POINTER(C.c_int64)()
    name = C.create_string_buffer(32)
    rc = lib.nlps_read_gid_mesh(
        path.encode(), C.byref(dim), C.byref(nnode), C.byref(n_nodes),
        C.byref(n_elems), C.byref(coords_p), C.byref(conn_p), name,
    )
    if rc != 0:
        raise ValueError(f"{path}: GiD parse failed ({_ERRORS.get(rc, f'code {rc}')})")
    nn, ne, d, k = int(n_nodes.value), int(n_elems.value), dim.value, nnode.value
    coords = np.ctypeslib.as_array(coords_p, shape=(nn * d,)).copy().reshape(nn, d)
    lib.nlps_free(C.cast(coords_p, C.c_void_p))
    conn = np.ctypeslib.as_array(conn_p, shape=(ne * k,)).copy().reshape(ne, k)
    lib.nlps_free(C.cast(conn_p, C.c_void_p))
    return d, name.value.decode(), coords, conn
