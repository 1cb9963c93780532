"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` is compiled on first use, by one ``nvcc`` per
source (all started together by ``build_all``), into a shared library with
a plain C interface under ``build/torch_kernels/`` at the root of the
checkout. The file name carries a hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt and a stale
library is never loaded. ``lineinfo=True`` builds the same source with
``-lineinfo`` into a file of its own (``<name>-lineinfo-<hash>.so``), for
tools that name source lines in their reports (compute-sanitizer); no
model path loads it. Nothing is built from
outside the checkout; nvcc is taken from ``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_LL = ctypes.c_longlong
# the dropout arguments of the layer entries: mode, dmask, seed pointer,
# threshold, 1 / keep. The ELL entries and kernel F's mode (a) take a dtype
# code first (grid_gat_fused._DTYPE_CODE), as grid_gat_fwd does.
_DROP = [_I, _VP, _VP, _U, _F]
# name -> (source file, {C function: (restype, argtypes)})
KERNELS: Dict[str, tuple] = {
    "grid_gat_fwd": ("grid_gat_fwd.cu", {
        "grid_gat_fwd": (_I, [_I] + [_VP] * 10 + [_I] * 7 + [_F, _I, _I]
                         + _DROP + [_VP]),
        "grid_gat_drop_mask": (_I, [_VP, _VP, _U, _F] + [_I] * 5 + [_VP]),
        "grid_gat_cuda_error_string": (ctypes.c_char_p, [_I]),
    }),
    "grid_gat_bwd": ("grid_gat_bwd.cu", {
        "grid_gat_bwd": (_I, [_I] + [_VP] * 15 + [_I] * 8 + [_F] + _DROP
                         + [_I, _I, _VP]),
        "grid_gat_bwd_blocks": (_I, [_I] * 4),
        "grid_gat_bwd_error_string": (ctypes.c_char_p, [_I]),
    }),
    "ell_gat_fwd": ("ell_gat_fwd.cu", {
        "ell_gat_fwd": (_I, [_I] + [_VP] * 10
                        + [_LL, _I, _I, _I, _F, _I, _I] + _DROP + [_VP]),
        "ell_gat_drop_mask": (_I, [_VP, _VP, _U, _F, _LL, _I, _I, _VP]),
        "ell_gat_dots": (_I, [_I, _VP, _VP, _VP, _LL, _I, _I, _I, _VP]),
        "ell_gat_fwd_warps_per_block": (_I, [_I, _I]),
        "ell_gat_fwd_error_string": (ctypes.c_char_p, [_I]),
    }),
    "ell_gat_bwd": ("ell_gat_bwd.cu", {
        "ell_gat_bwd": (_I, [_I] + [_VP] * 8 + _DROP + [_VP] * 11
                        + [_LL, _I, _I, _I, _F, _I, _I, _I, _VP]),
        "ell_gat_bwd_blocks": (_I, [_I, _LL, _I, _I, _I, _I]),
        "ell_gat_bwd_error_string": (ctypes.c_char_p, [_I]),
    }),
    "ell_gat_band": ("ell_gat_band.cu", {
        "ell_gat_band": (_I, [_I] + [_VP] * 9 + [_LL] + [_I] * 4
                         + [_F, _I, _VP]),
        "ell_gat_band_error_string": (ctypes.c_char_p, [_I]),
    }),
    "ell_gat_v2_fwd": ("ell_gat_v2_fwd.cu", {
        "ell_gat_v2_fwd": (_I, [_I] + [_VP] * 14 + [_LL] + [_I] * 5
                           + [_F, _I, _VP]),
        "ell_gat_mat_dots": (_I, [_I] + [_VP] * 3 + [_LL] + [_I] * 3
                             + [_VP]),
        "ell_gat_v2_fwd_error_string": (ctypes.c_char_p, [_I]),
    }),
    "ell_gat_v2_bwd": ("ell_gat_v2_bwd.cu", {
        "ell_gat_v2_bwd": (_I, [_I] + [_VP] * 26 + [_LL] + [_I] * 5
                           + [_F, _I, _I, _I, _VP]),
        "ell_gat_v2_bwd_blocks": (_I, [_I, _LL, _I, _I, _I, _I]),
        "ell_gat_v2_bwd_error_string": (ctypes.c_char_p, [_I]),
    }),
    "segment_reduce": ("segment_reduce.cu", {
        "segment_reduce_sorted": (_I, [_I] + [_VP] * 4
                                  + [_LL, _I, _I, _VP]),
        "segment_reduce_gat_rows": (_I, [_VP] * 7 + [_LL, _I, _I, _I, _I,
                                                      _VP]),
        "segment_reduce_error_string": (ctypes.c_char_p, [_I]),
    }),
}

_loaded: Dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, lineinfo: bool = False) -> Path:
    h = hashlib.sha1((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    tag = "-lineinfo" if lineinfo else ""
    return BUILD_DIR / f"{name}{tag}-{digest}.so"


def _start(name: str, lineinfo: bool = False):
    """Start nvcc for one kernel; returns (proc, tmp path, final path, log)
    or None when the library is already built."""
    out = library_path(name, lineinfo)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *(["-lineinfo"] if lineinfo else []), "-o", tmp,
           str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out, out.with_suffix(".log")


def _finish(name: str, job) -> None:
    proc, tmp, out, log = job
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode})"
                           f":\n{text}")
    os.replace(tmp, out)


def build_all() -> Dict[str, Path]:
    """Compile every kernel that is not built yet, one nvcc per source,
    all in parallel. Returns {name: library path}."""
    jobs = {name: _start(name) for name in KERNELS}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in KERNELS}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last
    build of ``name``, or '' when it was not built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(name: str, lineinfo: bool = False) -> Path:
    """The library file of kernel ``name``, built first if needed."""
    job = _start(name, lineinfo)
    if job is not None:
        _finish(name, job)
    return library_path(name, lineinfo)


def library(name: str, lineinfo: bool = False) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (its ``-lineinfo`` build with
    ``lineinfo``), built first if needed."""
    key = (name, lineinfo)
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, lineinfo)))
        for fn, (restype, argtypes) in KERNELS[name][1].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[key] = lib
    return lib
