"""Guard-page allocations on the card: a debug tool for the hand-written
kernels' checks.

A kernel that reads or writes a few bytes past the end of a buffer usually
lands in mapped memory (the next tensor, the rest of the caching
allocator's segment) and faults only in the processes where the buffer
happens to end just before an unmapped page. Here a tensor is placed flush
against address space that is reserved but never mapped, so such an access
faults on every run ("an illegal memory access"):

- ``cuMemAddressReserve`` reserves the buffer's granules plus one more
  (granularity from ``cuMemGetAllocationGranularity``, 2 MiB on an H100);
- ``cuMemCreate``, ``cuMemMap`` and ``cuMemSetAccess`` map only the
  granules the buffer needs, leaving the extra granule unmapped after them
  (layout ``"end"``) or before them (``"start"``);
- the tensor ends at the last mapped byte (``"end"``: its start rounded
  down to ``ALIGN`` bytes, so it ends exactly there when its size is a
  multiple of 16 bytes, and within 15 bytes of it otherwise) or starts at
  the first mapped byte after the hole (``"start"``);
- torch takes it through ``__cuda_array_interface__``.

The driver's virtual memory API is reached through ctypes on
``libcuda.so.1``. No model path uses this module, and it never stands in
for the caching allocator: ``chip_smoke.py`` phase 2a, the card tests and
``scripts/chip_phase2_repeat.py --guard`` hand a pool's ``empty`` to the
kernel wrappers (their ``empty=`` argument) and copy the inputs in with
``copy``. ``placement`` is the layout's arithmetic alone, which the CPU
tests check.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

ALIGN = 16                     # bytes: a tensor's start keeps this alignment
LAYOUTS = ("end", "start")


class Placement(NamedTuple):
    """Where a buffer of ``nbytes`` goes, in bytes from the start of the
    reserved range: ``reserve`` bytes reserved, ``map_size`` mapped from
    ``map_offset``, the tensor at ``offset``."""
    reserve: int
    map_offset: int
    map_size: int
    offset: int


def placement(nbytes: int, granularity: int, at: str,
              align: int = ALIGN) -> Placement:
    """The guard layout of an ``nbytes`` buffer: whole granules mapped
    and one granule left unmapped after them (``at="end"``, the tensor's
    end against the hole) or before them (``at="start"``, its start
    against the hole)."""
    if at not in LAYOUTS:
        raise ValueError(f"layout {at!r} not in {LAYOUTS}")
    if nbytes < 1:
        raise ValueError(f"nothing to place: {nbytes} bytes")
    if granularity < align or granularity % align:
        raise ValueError(f"granularity {granularity} is not a multiple of "
                         f"the alignment {align}")
    map_size = -(-nbytes // granularity) * granularity
    if at == "end":
        return Placement(map_size + granularity, 0, map_size,
                         (map_size - nbytes) // align * align)
    return Placement(map_size + granularity, granularity, map_size,
                     granularity)


# cuda.h (CUDA 12): the structures and constants the calls below take
class _Location(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _AllocationProp(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int),
                ("requestedHandleTypes", ctypes.c_int),
                ("location", _Location),
                ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _AccessDesc(ctypes.Structure):
    _fields_ = [("location", _Location), ("flags", ctypes.c_int)]


_ALLOCATION_TYPE_PINNED = 1
_LOCATION_TYPE_DEVICE = 1
_ACCESS_READWRITE = 3
_GRANULARITY_MINIMUM = 0

_P = ctypes.POINTER
_U64 = ctypes.c_ulonglong
_SZ = ctypes.c_size_t
_SIGNATURES = {
    "cuInit": [ctypes.c_uint],
    "cuDeviceGet": [_P(ctypes.c_int), ctypes.c_int],
    "cuMemGetAllocationGranularity": [_P(_SZ), _P(_AllocationProp),
                                      ctypes.c_int],
    "cuMemAddressReserve": [_P(_U64), _SZ, _SZ, _U64, _U64],
    "cuMemAddressFree": [_U64, _SZ],
    "cuMemCreate": [_P(_U64), _SZ, _P(_AllocationProp), _U64],
    "cuMemRelease": [_U64],
    "cuMemMap": [_U64, _SZ, _SZ, _U64, _U64],
    "cuMemUnmap": [_U64, _SZ],
    "cuMemSetAccess": [_U64, _SZ, _P(_AccessDesc), _SZ],
    "cuGetErrorString": [ctypes.c_int, _P(ctypes.c_char_p)],
}
_driver = None


class GuardError(RuntimeError):
    pass


def _cu():
    """libcuda.so.1 with the signatures above, loaded once."""
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _driver = lib
    return _driver


def _check(res: int, what: str) -> None:
    if res != 0:
        msg = ctypes.c_char_p()
        _cu().cuGetErrorString(res, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise GuardError(f"{what} failed: CUDA driver error {res} ({text})")


class _Span:
    """``nbytes`` bytes at device address ``ptr`` as a CUDA array (uint8)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


class GuardPool:
    """Guard-page tensors on the current card, laid out ``at`` ("end" or
    "start"), released together by ``release`` (or on leaving a ``with``
    block), after a synchronize. A tensor of the pool must not be used
    after that."""

    def __init__(self, at: str = "end"):
        import torch

        if at not in LAYOUTS:
            raise ValueError(f"layout {at!r} not in {LAYOUTS}")
        self.at = at
        self.device = torch.device("cuda", torch.cuda.current_device())
        # the runtime makes the device's primary context current here,
        # which the driver calls below act on
        torch.cuda.synchronize(self.device)
        cu = _cu()
        _check(cu.cuInit(0), "cuInit")
        ordinal = ctypes.c_int()
        _check(cu.cuDeviceGet(ctypes.byref(ordinal), self.device.index),
               "cuDeviceGet")
        self._loc = _Location(_LOCATION_TYPE_DEVICE, ordinal.value)
        self._prop = _AllocationProp(type=_ALLOCATION_TYPE_PINNED,
                                     location=self._loc)
        gran = _SZ()
        _check(cu.cuMemGetAllocationGranularity(
            ctypes.byref(gran), ctypes.byref(self._prop),
            _GRANULARITY_MINIMUM), "cuMemGetAllocationGranularity")
        self.granularity = gran.value
        self._maps = []          # (base, Placement, handle), mapped ones

    def _map(self, nbytes: int) -> int:
        """A guard-placed buffer of ``nbytes``; returns its address."""
        cu = _cu()
        p = placement(nbytes, self.granularity, self.at)
        base = _U64()
        _check(cu.cuMemAddressReserve(ctypes.byref(base), p.reserve,
                                      self.granularity, 0, 0),
               "cuMemAddressReserve")
        handle = _U64()
        res = cu.cuMemCreate(ctypes.byref(handle), p.map_size,
                             ctypes.byref(self._prop), 0)
        if res != 0:
            cu.cuMemAddressFree(base.value, p.reserve)
            _check(res, "cuMemCreate")
        start = base.value + p.map_offset
        res = cu.cuMemMap(start, p.map_size, 0, handle.value, 0)
        if res != 0:
            cu.cuMemRelease(handle.value)
            cu.cuMemAddressFree(base.value, p.reserve)
            _check(res, "cuMemMap")
        self._maps.append((base.value, p, handle.value))
        access = _AccessDesc(self._loc, _ACCESS_READWRITE)
        _check(cu.cuMemSetAccess(start, p.map_size, ctypes.byref(access), 1),
               "cuMemSetAccess")
        return base.value + p.offset

    def empty(self, *size, dtype=None, device=None):
        """``torch.empty(*size, dtype=, device=)`` in guard-page memory
        (uninitialized); ``device`` must be this pool's card."""
        import torch

        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = tuple(size[0])
        dtype = torch.float32 if dtype is None else dtype
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"pool on {self.device}, asked for {device}")
        n = 1
        for s in size:
            n *= int(s)
        nbytes = n * dtype.itemsize
        raw = torch.as_tensor(_Span(self._map(nbytes), nbytes),
                              device=self.device)
        return raw.view(dtype).view(size)

    def copy(self, t):
        """A guard-page copy of tensor ``t`` (on this pool's card)."""
        out = self.empty(t.shape, dtype=t.dtype, device=t.device)
        out.copy_(t)
        return out

    def release(self) -> None:
        """Synchronize, then unmap and free every buffer of the pool."""
        import torch

        torch.cuda.synchronize(self.device)
        cu = _cu()
        while self._maps:
            base, p, handle = self._maps.pop()
            _check(cu.cuMemUnmap(base + p.map_offset, p.map_size),
                   "cuMemUnmap")
            _check(cu.cuMemRelease(handle), "cuMemRelease")
            _check(cu.cuMemAddressFree(base, p.reserve), "cuMemAddressFree")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            self.release()
        except RuntimeError:
            # after a fault the context is gone and so are the mappings;
            # the fault is the error to report
            if exc is None:
                raise


def guarded_call(fn, kw: dict, at: str):
    """``fn(**kw, empty=...)`` with every tensor of ``kw`` copied into
    guard-page memory laid out ``at`` and every tensor ``fn`` allocates
    through ``empty`` placed there too (``fn``: a kernel wrapper such as
    ``grid_gat_fused.call_kernel``). Synchronizes, so that a fault raises
    here, and returns ``fn``'s tensors (one, or a tuple) copied back to
    ordinary memory."""
    import torch

    with GuardPool(at) as pool:
        gkw = {k: pool.copy(v) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        out = fn(**gkw, empty=pool.empty)
        torch.cuda.synchronize(pool.device)
        if isinstance(out, torch.Tensor):
            return out.clone()
        return tuple(t.clone() for t in out)


def overrun(at: str) -> None:
    """Have a kernel read the 8 bytes just past the end (``at="end"``) or
    just before the start (``"start"``) of a guard-placed tensor, then
    synchronize. The reader is kernel A's library's dropout-draw entry
    (``grid_gat_drop_mask``), which reads its Philox seed, one 8-byte word,
    from the device address it is given (torch itself refuses a tensor
    that starts at an unmapped address). Where the guard works this
    faults, which ends the process's CUDA context: run it in a process of
    its own (``faults``)."""
    import torch

    from ._build import library

    pool = GuardPool(at)
    t = pool.empty(1 << 18, dtype=torch.float32)        # 1 MiB, flush
    t.fill_(1.0)
    out = torch.empty(1, 9, 1, 1, 1, device=pool.device)
    torch.cuda.synchronize()
    addr = t.data_ptr() + t.numel() * 4 if at == "end" else t.data_ptr() - 8
    err = library("grid_gat_fwd").grid_gat_drop_mask(
        out.data_ptr(), addr, 0, 1.0, 1, 8, 1, 1, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise GuardError(f"grid_gat_drop_mask did not launch: {err}")
    torch.cuda.synchronize()


def faults(at: str, timeout: float = 300) -> tuple:
    """Whether ``overrun(at)`` faults in a fresh process: (True, its error
    line) when it ended with an illegal memory access, else (False, its
    first error line or what it printed last)."""
    root = Path(__file__).resolve().parents[3]
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from bathymetric_gnn_tpu_torch.ops.cuda import guard; "
            f"guard.overrun({at!r})")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout)
    lines = [ln for ln in (p.stdout + p.stderr).splitlines() if ln.strip()]
    hit = [ln for ln in lines if "an illegal memory access" in ln]
    if p.returncode != 0 and hit:
        return True, hit[0]
    errors = [ln for ln in lines if "error" in ln.lower()]
    return False, f"rc {p.returncode}: " + (
        errors[0] if errors else lines[-1] if lines else "")
