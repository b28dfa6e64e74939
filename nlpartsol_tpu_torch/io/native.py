"""ctypes bindings of ``native/nlps_native.cpp``: the GiD mesh parser and
the mesh topology of unstructured background meshes.

Counterpart of ``nlpartsol_tpu/io/native.py``.  The source lives at the repository root, beside both
packages; here ``g++`` builds it at first use into
``nlpartsol_tpu_torch/build/`` (git-ignored) under a name that carries a
hash of the source, the flags, the compiler's version and the host's C
library, so neither an edited source nor a copy of the tree on another host
is served by a library built for something else.
The library has a plain C ABI, consumed via ctypes.

:func:`available` says whether the library could be built and loaded (no
``g++`` means the pure-Python reader of ``io/gid_mesh.py``).  Once a parse
has begun, its failure raises: nothing falls back after that point.
:func:`mesh_topology` and :func:`ring_localities` bind the library's
linear-time node→element / node→node CSR build and its ring expansion of
nodal localities (the reference's Read_GramsBox.c:57-103); they return None
where the library is not available, as the JAX package's do.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import platform
import shutil
import subprocess
from typing import NamedTuple, Optional

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
    i64p = C.POINTER(C.c_int64)
    dp = C.POINTER(C.c_double)
    lib.nlps_free.argtypes = [C.c_void_p]
    lib.nlps_free.restype = None
    lib.nlps_read_gid_mesh.argtypes = [
        C.c_char_p, C.POINTER(C.c_int), C.POINTER(C.c_int),
        i64p, i64p, C.POINTER(dp), C.POINTER(i64p), C.c_char_p,
    ]
    lib.nlps_read_gid_mesh.restype = C.c_int
    lib.nlps_topology.argtypes = [
        C.c_int64, C.c_int64, C.c_int, C.c_int, i64p, dp,
        C.POINTER(i64p), C.POINTER(i64p), C.POINTER(i64p), C.POINTER(i64p),
        C.POINTER(C.POINTER(C.c_uint8)), dp,
    ]
    lib.nlps_topology.restype = C.c_int
    lib.nlps_ring_expand.argtypes = [
        C.c_int64, i64p, i64p, C.c_int, C.POINTER(i64p), C.POINTER(i64p)]
    lib.nlps_ring_expand.restype = C.c_int
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


def _take_i64(lib, ptr, n) -> np.ndarray:
    """A copy of the library's int64 array of ``n`` entries; frees it."""
    arr = np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()
    lib.nlps_free(C.cast(ptr, C.c_void_p))
    return arr


class Topology(NamedTuple):
    node_elem_off: np.ndarray  # (n_nodes+1,) CSR offsets
    node_elem_idx: np.ndarray  # node→element adjacency
    node_node_off: np.ndarray  # (n_nodes+1,) 1-ring CSR offsets
    node_node_idx: np.ndarray
    boundary: np.ndarray  # (n_nodes,) bool
    min_dx: float  # minimum edge length (DeltaX)


def mesh_topology(coords: np.ndarray, conn: np.ndarray, dim: int) -> Optional[Topology]:
    """Linear-time CSR topology of a mesh (replaces the reference's
    O(Nnodes·Nelems) get_sourrounding_elements scan).  None where the
    library is not available; a failed build of the tables raises."""
    lib = _load()
    if lib is None:
        return None
    conn64 = np.ascontiguousarray(conn, dtype=np.int64)
    crd = np.ascontiguousarray(coords, dtype=np.float64)
    n_nodes, n_elems, nnode = coords.shape[0], conn.shape[0], conn.shape[1]
    i64p = C.POINTER(C.c_int64)
    ne_off, ne_idx, nn_off, nn_idx = i64p(), i64p(), i64p(), i64p()
    bnd = C.POINTER(C.c_uint8)()
    min_dx = C.c_double()
    rc = lib.nlps_topology(
        n_nodes, n_elems, nnode, dim,
        conn64.ctypes.data_as(i64p), crd.ctypes.data_as(C.POINTER(C.c_double)),
        C.byref(ne_off), C.byref(ne_idx), C.byref(nn_off), C.byref(nn_idx),
        C.byref(bnd), C.byref(min_dx),
    )
    if rc != 0:
        raise ValueError(f"nlps_topology failed (code {rc})")
    neo = _take_i64(lib, ne_off, n_nodes + 1)
    nei = _take_i64(lib, ne_idx, n_elems * nnode)
    nno = _take_i64(lib, nn_off, n_nodes + 1)
    nni = _take_i64(lib, nn_idx, nno[-1])
    b = np.ctypeslib.as_array(bnd, shape=(n_nodes,)).copy().astype(bool)
    lib.nlps_free(C.cast(bnd, C.c_void_p))
    return Topology(neo, nei, nno, nni, b, float(min_dx.value))


def ring_localities(top: Topology, rings: int = 2):
    """Ring-``rings`` nodal localities (fill_nodal_locality,
    Read_GramsBox.c:57-103) as CSR (offsets, indices); None where the
    library is not available."""
    lib = _load()
    if lib is None:
        return None
    n_nodes = top.node_node_off.shape[0] - 1
    i64p = C.POINTER(C.c_int64)
    off, idx = i64p(), i64p()
    nno = np.ascontiguousarray(top.node_node_off, dtype=np.int64)
    nni = np.ascontiguousarray(top.node_node_idx, dtype=np.int64)
    rc = lib.nlps_ring_expand(n_nodes, nno.ctypes.data_as(i64p), nni.ctypes.data_as(i64p),
                              rings, C.byref(off), C.byref(idx))
    if rc != 0:
        raise ValueError(f"nlps_ring_expand failed (code {rc})")
    offs = _take_i64(lib, off, n_nodes + 1)
    return offs, _take_i64(lib, idx, offs[-1])
