"""ctypes bindings for the native host-side graph kit (``native/graphkit.cpp``).

Port of ``bathymetric_gnn_tpu/native/__init__.py`` with its own loader: the
C++ source at the root of the checkout is compiled with g++ on first use
into ``build/torch_kernels/graphkit-<hash>.so`` (hash of the source and the
flags, as the CUDA kernels are built by ``ops/cuda/_build.py``) and loaded
with ctypes. The flags are those of ``native/build.sh``, so the port's
library computes the same float distances as the JAX package's.

Unlike the JAX module, nothing falls back to NumPy when the library cannot
be built: ``knn2d`` and ``ell_pack`` raise. The k-NN graph depends on the
C++ code's tie-breaking (on grid-derived point clouds many candidates lie
at equal distances, and which of them the heap keeps depends on its
cell-visit order); the NumPy version, kept as ``knn2d_numpy``, breaks ties
differently and so builds a different graph.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graphkit.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    if not SOURCE.exists():
        raise RuntimeError(f"the graph kit's source {SOURCE} is missing: "
                           "run from a checkout of the repository")
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"graphkit-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native graph kit needs a C++ "
                           "compiler (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE),
                          "-lpthread"], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building the graph kit failed (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded graph kit, built first if needed; raises when it cannot
    be built or loaded."""
    global _LIB
    if _LIB is None:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.knn2d.restype = ctypes.c_int
        lib.knn2d.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.ell_pack.restype = ctypes.c_int32
        lib.ell_pack.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
    return _LIB


def knn2d(pos: np.ndarray, k: int, n_threads: int = 0) -> np.ndarray:
    """Exact 2-D k-NN indices [n, k] (self excluded; -1 pads), by the C++
    spatial hash. Raises when the library cannot be built or fails."""
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    out = np.full((n, k), -1, np.int32)
    if n == 0 or min(k, n - 1) <= 0:
        return out
    ret = library().knn2d(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int32(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n_threads))
    if ret != 0:
        raise RuntimeError(f"knn2d failed with code {ret}")
    return out


def knn2d_numpy(pos: np.ndarray, k: int) -> np.ndarray:
    """The JAX module's blocked O(N^2) NumPy k-NN: the same neighbour
    distances as ``knn2d``, but ties at equal distance broken otherwise.
    Not on any path of the port."""
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    k_eff = min(k, max(n - 1, 0))
    out = np.full((n, k), -1, np.int32)
    if k_eff <= 0:
        return out
    block = 2048
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = ((pos[s:e, None, :] - pos[None, :, :]) ** 2).sum(-1)
        d2[np.arange(e - s), np.arange(s, e)] = np.inf
        part = np.argpartition(d2, k_eff - 1, axis=1)[:, :k_eff]
        rows = np.arange(e - s)[:, None]
        ordered = part[rows, np.argsort(d2[rows, part], axis=1)]
        out[s:e, :k_eff] = ordered
    return out


def ell_pack(src: np.ndarray, dst: np.ndarray, n: int, k: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack dst-sorted COO into ELL: (nbr_src [n,k], nbr_mask [n,k] bool,
    slot_of_edge [e], max_degree), by the C++ packer."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    nbr_src = np.empty((n, k), np.int32)
    nbr_mask = np.empty((n, k), np.uint8)
    slot = np.empty(len(src), np.int32)
    maxdeg = library().ell_pack(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(src)), ctypes.c_int64(n), ctypes.c_int32(k),
        nbr_src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nbr_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        slot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return nbr_src, nbr_mask.astype(bool), slot, int(maxdeg)
