"""Grid featurization on the device, batched over tiles ([B, H, W]), and
the dense per-offset edge features of grid graphs.

Port of ``bathymetric_gnn_tpu/ops/features.py``. All local statistics are
boundary-aware: only valid cells contribute (masked sums / counts), as in
the reference's featurization (data/graph_construction.py:245-456).

Numerics: float32 throughout. ``masked_local_stats`` subtracts each tile's
mean depth before forming E[x^2] - E[x]^2; without that shift the
difference cancels badly at survey depths (~30 m and more). On the CPU
the square roots and arctangents come from NumPy (``sqrt``,
``atan_deg``), so that a feature's bits do not depend on what ran before
in the process, and a lone large tile's depth sum is taken in float64
(``_tile_sum``), so that they do not depend on torch's thread count.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Canonical feature order; uncertainty is appended as channel 8 when present.
NODE_FEATURE_NAMES = (
    "depth",
    "local_mean",
    "local_std",
    "gradient_x",
    "gradient_y",
    "gradient_magnitude",
    "curvature",
)


class GridFeatures(NamedTuple):
    """Dense per-cell features of a batch of tiles."""

    features: torch.Tensor  # [B, H, W, F] float32, zero where invalid
    local_std: torch.Tensor  # [B, H, W] (correction normalizer)
    local_mean: torch.Tensor  # [B, H, W]
    valid_count: torch.Tensor  # [B, H, W] (# valid cells in window)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root, correctly rounded on either device (as XLA's).

    On the CPU torch's float32 sqrt is MKL's VML, and the first such call
    in a process, split over two threads, has returned the second thread's
    values, or a block of them, at ~12 bits (relative error up to 3.2e-4)
    from bit-identical input (``scripts/cpu_sqrt_first_call.py``): a
    feature's bits then depend on what ran before. NumPy's sqrt (the
    square-root instruction) gives the same bits every time.
    Featurization takes no gradient."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def atan_deg(x: torch.Tensor) -> torch.Tensor:
    """arctan in degrees (the edge slope). On the CPU not MKL's VML, for
    the reason ``sqrt`` gives, but NumPy's arctan in float64 rounded to
    x's type: correctly rounded, so it keeps XLA's bits at least as often
    as MKL's float32 arctan did (NumPy's float32 arctan, up to 2 ulp off,
    misses them more often)."""
    if x.device.type != "cpu":
        return torch.rad2deg(torch.atan(x))
    a = x.numpy()
    return torch.rad2deg(torch.from_numpy(
        np.arctan(a.astype(np.float64)).astype(a.dtype)))


def _box_filter_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over a size x size window, zero outside the tile, as separable
    slice-adds in the JAX order (``ndimage.uniform_filter(mode='constant')
    * size**2``). ``x`` is [B, H, W]."""
    pad = size // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, pad, size - 1 - pad))
    xr = xp[:, 0:h]
    for i in range(1, size):
        xr = xr + xp[:, i:i + h]
    xp = F.pad(xr, (pad, size - 1 - pad))
    xc = xp[:, :, 0:w]
    for i in range(1, size):
        xc = xc + xp[:, :, i:i + w]
    return xc


# torch's reduction grain (at::internal::GRAIN_SIZE): a sum of more
# elements than this into one output is split across the intra-op threads
SERIAL_SUM_CELLS = 32768


def _tile_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-tile sums of [B, H, W] as [B, 1, 1].

    On the card ``pairwise_tile_sum``, whose order is fixed by the tile's
    size alone, so that a tile's sum, and with it every feature, does not
    depend on the batch it is served in: the library's reduction splits a
    sum across blocks by the whole tensor's shape. On the CPU, the
    library's sum, whose roundings the JAX parity tests hold; but a lone
    tile of more than ``SERIAL_SUM_CELLS`` cells (a graph build's) is
    summed in float64 and rounded once. Torch splits a float32 sum of that
    many elements into one output across its intra-op threads, so its
    bits moved with the thread count (a training worker runs one thread),
    and the local std, which cancels against the tile's mean, moved with
    them (``tests/test_torch_mp_loader.py`` holds the bits at 1 and 4
    threads). Smaller sums, and sums into
    several outputs, run one output per thread."""
    if x.device.type != "cuda":
        if x.shape[0] == 1 and x[0].numel() > SERIAL_SUM_CELLS:
            return x.sum(dim=(1, 2), keepdim=True,
                         dtype=torch.float64).to(x.dtype)
        return x.sum(dim=(1, 2), keepdim=True)
    return pairwise_tile_sum(x)


def pairwise_tile_sum(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, 1, 1]: each tile's sum as a pairwise tree of
    elementwise adds over the flattened tile, zero-padded to a power of
    two (the order depends on the tile's size alone)."""
    b = x.shape[0]
    v = x.reshape(b, -1)
    n = v.shape[1]
    v = F.pad(v, (0, (1 << (n - 1).bit_length()) - n))
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v.reshape(b, 1, 1)


def _laplace_replicate(x: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian with edge replication. The JAX code pads with
    ``mode="symmetric"``, which at width 1 repeats the edge cell: the same
    as PyTorch's ``replicate``."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    # same term order as the JAX stencil loop (row-major over the kernel)
    out = torch.zeros_like(x)
    out = out + xp[:, 0:h, 1:w + 1]
    out = out + xp[:, 1:h + 1, 0:w]
    out = out + -4.0 * xp[:, 1:h + 1, 1:w + 1]
    out = out + xp[:, 1:h + 1, 2:w + 2]
    out = out + xp[:, 2:h + 2, 1:w + 1]
    return out


def masked_local_stats(
    depth: torch.Tensor,
    valid_mask: torch.Tensor,
    size: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boundary-aware local mean/std/count over a size x size window
    (masked sums over valid-neighbour counts; variance clamped at 0)."""
    vf = valid_mask.to(torch.float32)
    n_valid = vf.sum(dim=(1, 2), keepdim=True).clamp_min(1.0)
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
    center = _tile_sum(torch.where(valid_mask, depth, zero)) / n_valid
    d0 = torch.where(valid_mask, depth - center, zero)

    sum_vals = _box_filter_sum(d0, size)
    count = _box_filter_sum(vf, size)
    safe_count = count.clamp_min(1.0)
    mean0 = sum_vals / safe_count

    sum_sq = _box_filter_sum(torch.where(valid_mask, d0 * d0, zero), size)
    variance = (sum_sq / safe_count - mean0 * mean0).clamp_min(0.0)
    local_std = sqrt(variance)
    # cells with no valid neighbour report mean 0, like the reference
    local_mean = torch.where(count > 0, mean0 + center, zero)
    return local_mean, local_std, count


def _grad_axis(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``np.gradient`` along one axis: central inside, one-sided at the
    borders; 0 along an axis of length 1."""
    n = a.shape[dim]
    if n < 2:
        return torch.zeros_like(a)
    g = (torch.roll(a, -1, dim) - torch.roll(a, 1, dim)) / 2.0
    first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    g.narrow(dim, 0, 1).copy_(first)
    g.narrow(dim, n - 1, 1).copy_(last)
    return g


def gradients(depth_filled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_y, grad_x) of [B, H, W], as ``np.gradient`` per tile."""
    return _grad_axis(depth_filled, 1), _grad_axis(depth_filled, 2)


def curvature(depth_filled: torch.Tensor,
              valid_mask: torch.Tensor) -> torch.Tensor:
    """Laplacian curvature, zeroed where <3 valid cells in the 3x3 window
    (``ndimage.laplace`` plus the reference's valid-neighbour gate)."""
    lap = _laplace_replicate(depth_filled)
    count = _box_filter_sum(valid_mask.to(torch.float32), 3)
    return torch.where(count < 3, torch.zeros_like(lap), lap)


def compute_grid_features(
    depth: torch.Tensor,
    valid_mask: torch.Tensor,
    uncertainty: Optional[torch.Tensor] = None,
    stats_window: int = 5,
) -> GridFeatures:
    """The reference's 7 node features (+ uncertainty as channel 8), dense
    over [B, H, W] tiles; invalid cells carry zeros."""
    depth = depth.to(torch.float32)
    valid_mask = valid_mask.to(torch.bool)
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    depth_c = torch.where(valid_mask, depth, zero)  # NaN-safe

    local_mean, local_std, count = masked_local_stats(
        depth_c, valid_mask, stats_window)
    # fill invalid cells with the local mean before differential ops so
    # boundaries see the local trend, not nodata spikes
    depth_filled = torch.where(valid_mask, depth_c, local_mean)

    gy, gx = gradients(depth_filled)
    gmag = sqrt(gx * gx + gy * gy)
    curv = curvature(depth_filled, valid_mask)

    feats = [depth_c, local_mean, local_std, gx, gy, gmag, curv]
    if uncertainty is not None:
        unc = uncertainty.to(torch.float32)
        feats.append(torch.where(valid_mask & torch.isfinite(unc), unc, zero))
    f = torch.stack(feats, dim=-1)
    f = torch.where(valid_mask[..., None], f, zero)
    f = torch.nan_to_num(f, nan=0.0)
    return GridFeatures(
        features=f,
        local_std=torch.where(valid_mask, local_std, zero),
        local_mean=local_mean,
        valid_count=count,
    )


def edge_features_for_offset(depth_filled: torch.Tensor, dr: int, dc: int,
                             resolution: Tuple[float, float]) -> torch.Tensor:
    """Dense per-cell edge features [..., H, W, 3] for the (dr, dc)
    neighbour direction of depth [..., H, W]: for a source cell (r, c)
    with target (r + dr, c + dc), the distance, the depth difference
    (target - source) and the slope in degrees. Targets outside the grid
    wrap (like ``jnp.roll``) and are masked by the caller."""
    res_x, res_y = resolution
    dist = math.sqrt((dc * res_x) ** 2 + (dr * res_y) ** 2)
    tgt = torch.roll(depth_filled, shifts=(-dr, -dc), dims=(-2, -1))
    ddiff = tgt - depth_filled
    slope = atan_deg(ddiff / dist) if dist > 0 else torch.zeros_like(ddiff)
    return torch.stack([torch.full_like(ddiff, dist), ddiff, slope], dim=-1)
