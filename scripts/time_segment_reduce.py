"""Kernel F's mode (a) (``ops/cuda/segment_reduce.call_kernel``) at the
shapes of the port's main paths, for the checkout whose root is given
(default: the one holding this script), so that two checkouts of the port
can be timed alike in one run on one card:

    python3 scripts/time_segment_reduce.py [ROOT] [--json PATH]

Shapes (built by this checkout's ``chip_smoke.py`` helpers with ROOT's
port): the COO flush (65,536-node grid graph of a 256^2 survey, 5 % holes)
and the COO train batch (4 tiles of 256^2, N = 262,144): segment sums over
the destination table at widths 256, 4, 1, 3 and 64 and the 256-wide
gather backward over the source table; the k-NN train batch's route-D
spill-row cotangent [1,991,912, 256], f32 and bf16. For each: the CUDA
event span over 20 calls, the device time of the calls' kernels (a CUDA
graph of 20 calls replayed between events: ``chip_smoke.device_ms``) and
the host time of a call (enqueue of 20 calls), beside ``index_add_`` (its
fill included; none for the bf16 rows) timed alike. Prints one line a
shape and the card's name and power limit; with ``--json`` writes the rows
there. Needs a CUDA card and nvcc (the kernel is built on first use, into
ROOT/build)."""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("root", nargs="?", default=str(HERE))
ap.add_argument("--json", default=None)
ARGS = ap.parse_args()
ROOT = Path(ARGS.root).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr  # noqa


def smoke_helpers():
    """This checkout's chip_smoke.py as a module (its graph builders import
    the port lazily, so they take ROOT's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(cs, dev):
    """[(label, ct, perm, row_ptr, n, index_add_ ids or None)]."""
    gen = torch.Generator().manual_seed(cs.SEED + 130)
    _, g, _ = cs.coo_flush_graph(torch, np, dev)
    samples = cs.coo_train_samples(np, cs.knn_survey(
        np, cs.KNN_BATCH_SURVEY, cs.SEED + 60)[0])
    work = ROOT / "build" / "time_segment_reduce"
    work.mkdir(parents=True, exist_ok=True)
    _, _, gt, _ = cs.coo_step_setup(torch, np, work, samples, dropout=0.0)
    out = []
    for where, gg in (("flush", g), ("train", gt)):
        n, e = gg.x.shape[0], gg.edge_src.shape[0]
        m = gg.edge_mask
        live = int(m.sum())
        for f in (256, 4, 1, 3, 64):
            ct = torch.randn(e, f, generator=gen).to(dev)
            out.append((f"{where} sum [{live}, {f}]", ct, *gg.dst_table, n,
                        gg.edge_dst[m].long(), m))
        ct = torch.randn(e, 256, generator=gen).to(dev)
        out.append((f"{where} gather backward [{live}, 256]", ct,
                    *gg.src_table, n, gg.edge_src[m].long(), m))
    ksamples = cs.knn_train_samples(np, cs.knn_survey(
        np, cs.KNN_BATCH_SURVEY, cs.SEED + 60)[0])
    kg, _, _ = cs.knn_train_batch(torch, np, dev, ksamples)
    src, _ = cs.fa_inputs(torch, dict(nbr_mask=kg.nbr_mask,
                                      node_mask=kg.node_mask,
                                      nbr_src=kg.nbr_src))
    n = kg.x.shape[0]
    pa, ra = cs.fa_tables(torch, src, n)
    ct = torch.randn(src.numel(), 256, generator=gen).to(dev)
    out.append((f"route D [{src.numel()}, 256] f32", ct, pa, ra, n,
                src.long(), None))
    out.append((f"route D [{src.numel()}, 256] bf16", ct.bfloat16(), pa, ra,
                n, None, None))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_segment_reduce: no CUDA device", file=sys.stderr)
        return 1
    if ROOT not in Path(sr.__file__).resolve().parents:
        print(f"time_segment_reduce: imported {sr.__file__}, not {ROOT}'s",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"time_segment_reduce: {ROOT} on {card}")
    cs = smoke_helpers()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    with torch.no_grad():
        for label, ct, perm, row_ptr, n, ids, m in shapes(cs, dev):
            fn = lambda: sr.call_kernel(ct, perm, row_ptr, n)  # noqa: E731
            row = dict(shape=label, ms=cs.cuda_ms(torch, fn, 20),
                       device_ms=cs.device_ms(torch, fn),
                       host_us=cs.host_us(torch, fn))
            if ids is not None:
                rows_l = ct[m] if m is not None else ct
                f = ct.shape[1]
                lib = lambda: torch.zeros(  # noqa: E731
                    n, f, device=dev).index_add_(0, ids, rows_l)
                row.update(library_ms=cs.cuda_ms(torch, lib, 20),
                           library_device_ms=cs.device_ms(torch, lib))
            rows.append(row)
            print("time_segment_reduce: " + json.dumps(row))
    if ARGS.json:
        Path(ARGS.json).parent.mkdir(parents=True, exist_ok=True)
        Path(ARGS.json).write_text(json.dumps(dict(root=str(ROOT), card=card,
                                                   rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
