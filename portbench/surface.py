"""Seeded synthetic bathymetry, made on the device in bulk.

As the synthetic surveys the port's smoke checks use: a depth ramp at ~30
m with two sinusoids and 2 cm roughness, on request 1 % spikes of 0.5-4 m
of either sign, one nodata hole of 150 x 200 cells at (h / 3, w / 2) and
0.2 % scattered dropouts. The size, the hole and the shares are the same
for every seed; the seed moves the roughness, the spikes and the
dropouts.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_survey(h: int, w: int, seed: int, device,
                     spikes: bool = True) -> np.ndarray:
    """[h, w] float32 depth with NaN where there is no data, on the host."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    depth = (30.0 + 0.002 * xx + 0.001 * yy + 0.5 * torch.sin(xx / 37.0)
             + 0.3 * torch.cos(yy / 53.0))
    depth = depth + 0.02 * torch.randn(h, w, generator=gen, device=device)
    if spikes:
        hit = torch.rand(h, w, generator=gen, device=device) < 0.01
        mag = 0.5 + 3.5 * torch.rand(h, w, generator=gen, device=device)
        sign = torch.where(torch.rand(h, w, generator=gen, device=device)
                           < 0.5, -1.0, 1.0)
        depth = torch.where(hit, depth + mag * sign, depth)
    depth[h // 3:h // 3 + 150, w // 2:w // 2 + 200] = float("nan")
    drop = torch.rand(h, w, generator=gen, device=device) < 0.002
    depth = torch.where(drop, torch.full_like(depth, float("nan")), depth)
    return depth.cpu().numpy()
