"""CPU checks of the kernel checks' tools: the guard-page layout's
arithmetic (``ops/cuda/guard.placement``: flush at the end and at the
start, sizes that are and are not granule multiples, 16-byte alignment
kept, with a fake granularity), the ``-lineinfo`` build's own file name and
flag (``ops/cuda/_build``), and the failure-rate bound of
``scripts/chip_phase2_repeat.py``. The guard pages themselves act only on
a card (``tests/test_torch_cuda_kernel.py -k guard``)."""

import importlib.util
import math
from pathlib import Path
from unittest import mock

import pytest

from bathymetric_gnn_tpu_torch.ops.cuda import _build, guard

ROOT = Path(__file__).resolve().parents[1]
SIZES = [1, 4, 15, 16, 17, 1000, 4095, 4096, 4097, 3 * 4096, 3 * 4096 + 8,
         10 * 4096 - 12]


@pytest.mark.parametrize("gran", [4096, 2 << 20])
@pytest.mark.parametrize("nbytes", SIZES)
def test_flush_end_placement(nbytes, gran):
    p = guard.placement(nbytes, gran, "end")
    # whole granules mapped from the start of the range, one left after
    assert p.map_offset == 0
    assert p.map_size % gran == 0
    assert nbytes <= p.map_size < nbytes + gran
    assert p.reserve == p.map_size + gran
    # the tensor lies in the mapped granules, 16-byte aligned, its end
    # against the hole (exactly when its size is a multiple of 16)
    assert p.offset % guard.ALIGN == 0
    end = p.offset + nbytes
    assert p.offset >= 0 and end <= p.map_offset + p.map_size
    gap = p.map_size - end
    assert 0 <= gap < guard.ALIGN
    assert (gap == 0) == (nbytes % guard.ALIGN == 0)


@pytest.mark.parametrize("gran", [4096, 2 << 20])
@pytest.mark.parametrize("nbytes", SIZES)
def test_flush_start_placement(nbytes, gran):
    p = guard.placement(nbytes, gran, "start")
    # one granule left unmapped first, then whole granules mapped
    assert p.map_offset == gran
    assert p.map_size % gran == 0
    assert nbytes <= p.map_size < nbytes + gran
    assert p.reserve == p.map_offset + p.map_size
    # the tensor starts at the first mapped byte, aligned
    assert p.offset == p.map_offset
    assert p.offset % guard.ALIGN == 0
    assert p.offset + nbytes <= p.map_offset + p.map_size


def test_placement_rejects_what_it_cannot_place():
    with pytest.raises(ValueError, match="layout"):
        guard.placement(64, 4096, "middle")
    with pytest.raises(ValueError, match="nothing"):
        guard.placement(0, 4096, "end")
    with pytest.raises(ValueError, match="granularity"):
        guard.placement(64, 4104, "end")
    with pytest.raises(ValueError, match="layout"):
        guard.GuardPool("middle")


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_lineinfo_library_has_its_own_file(name):
    plain = _build.library_path(name)
    lined = _build.library_path(name, lineinfo=True)
    assert lined != plain and lined.parent == plain.parent
    assert lined.name.startswith(f"{name}-lineinfo-")
    assert "lineinfo" not in plain.name
    # the same hash of the sources
    assert lined.name.rsplit("-", 1)[1] == plain.name.rsplit("-", 1)[1]


@pytest.mark.parametrize("lineinfo", [False, True])
def test_lineinfo_flag_only_in_its_build(tmp_path, lineinfo):
    with mock.patch.object(_build, "BUILD_DIR", tmp_path), \
            mock.patch.object(_build, "_nvcc", return_value="nvcc"), \
            mock.patch.object(_build.subprocess, "Popen") as popen:
        proc, tmp, out, log = _build._start("grid_gat_fwd", lineinfo)
    cmd = popen.call_args[0][0]
    assert ("-lineinfo" in cmd) == lineinfo
    assert out.parent == tmp_path
    assert out.name == _build.library_path("grid_gat_fwd", lineinfo).name
    assert cmd[cmd.index("-o") + 1] == str(tmp)
    assert ("-lineinfo-" in out.name) == lineinfo
    tmp.unlink()


def _repeat_script():
    spec = importlib.util.spec_from_file_location(
        "chip_phase2_repeat", ROOT / "scripts" / "chip_phase2_repeat.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("runs", [1, 36, 200, 400])
def test_failure_rate_upper_bound(runs):
    bound = _repeat_script().rate_upper_bound
    # no failure: (1 - p)^n = 0.05 at the bound
    assert math.isclose(bound(0, runs), 1 - 0.05 ** (1 / runs),
                        rel_tol=1e-9)
    assert bound(runs, runs) == 1.0
    if runs > 1:
        # one failure: P(X <= 1) = 0.05 at the bound, above the bound of 0
        p = bound(1, runs)
        cdf = (1 - p) ** runs + runs * p * (1 - p) ** (runs - 1)
        assert math.isclose(cdf, 0.05, rel_tol=1e-6)
        assert bound(0, runs) < p
