"""Device time of the attention dots of kernels D, D' and E
(``rows::mat_dots*`` in ``csrc/ell_gat_rows.cuh``) inside kernel E's call,
read from ``torch.profiler``, for the checkout whose root is given (default:
the one holding this script), so that two checkouts of the port can be
timed alike in one run on one card:

    python3 scripts/time_dots.py [ROOT]

Kernel E runs on a synthetic banded layer (random in-band slots, 128-row
bands) at N 65,536 and 262,144, HC 256 / 4 heads and HC 64 / 1 head, f32
and bf16; each line gives the dots kernel's name and its mean device time
per call over 20 calls (after 3 warm-up calls), and the card's name and
power limit. Needs a CUDA card and nvcc (the kernels are built on first
use, into ROOT/build)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb  # noqa


def main() -> int:
    if not torch.cuda.is_available():
        print("time_dots: no CUDA device", file=sys.stderr)
        return 1
    if ROOT not in Path(eb.__file__).resolve().parents:
        print(f"time_dots: imported {eb.__file__}, not {ROOT}'s",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"time_dots: {ROOT} on {card}")
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    r, k = 128, 8
    for n in (65536, 262144):
        loc = torch.randint(-1, 3 * r, (k, n), generator=gen).int().to(dev)
        for heads, c in ((4, 64), (1, 64)):
            hc = heads * c
            el = torch.randn(k * heads, n, generator=gen).to(dev)
            el_self = torch.randn(heads, n, generator=gen).to(dev)
            acat = (0.1 * torch.randn(hc, 2 * heads, generator=gen)).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                xh = torch.randn(n, hc, generator=gen).to(dev, dtype)
                kw = eb.kernel_args(xh, acat, loc, el, el_self, band_rows=r)
                for _ in range(3):
                    eb.call_band_kernel(**kw)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        eb.call_band_kernel(**kw)
                    torch.cuda.synchronize()
                for ev in prof.key_averages():
                    if "mat_dots" not in ev.key:
                        continue
                    us = getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0.0))
                    print(f"time_dots: N {n} HC {hc} heads {heads} "
                          f"{str(dtype).split('.')[1]}: {ev.key[:60]} "
                          f"x{ev.count} {us / 1e3 / 20:.4f} ms per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
