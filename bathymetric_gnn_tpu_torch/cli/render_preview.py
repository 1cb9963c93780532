"""Quicklook renderer (port of ``bathymetric_gnn_tpu/cli/render_preview.py``):
PNG previews of surveys and GNN outputs.

The reference's QA process asks for visual and spatial checks of every
output (reference docs/LESSONS_LEARNED.md:233-242). This CLI draws them
headlessly: hillshaded depth, the classification overlay, confidence and
correction maps, and the residual (cleaned - original).

    python -m bathymetric_gnn_tpu_torch.cli.render_preview out.tif \\
        [--output out.png] [--original survey.tif]

Needs matplotlib (imported in ``main``); no card. ``main(argv)``
returns the PNG path.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import for_caller, setup_logging


def hillshade(depth: np.ndarray, azimuth=315.0, altitude=45.0) -> np.ndarray:
    az = np.radians(azimuth)
    alt = np.radians(altitude)
    gy, gx = np.gradient(np.nan_to_num(depth))
    slope = np.pi / 2.0 - np.arctan(np.hypot(gx, gy))
    aspect = np.arctan2(-gx, gy)
    shaded = (np.sin(alt) * np.sin(slope)
              + np.cos(alt) * np.cos(slope) * np.cos((az - np.pi / 2.0)
                                                     - aspect))
    return np.clip(shaded, 0, 1)


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = argparse.ArgumentParser(description="Render survey/output quicklooks")
    p.add_argument("raster", help="GeoTIFF (survey or inference output)")
    p.add_argument("--output", help="PNG path (default <raster>.png)")
    p.add_argument("--original", help="original survey for residual map")
    p.add_argument("--dpi", type=int, default=110)
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)

    from ..io.geotiff import read_geotiff

    bands, info = read_geotiff(args.raster)
    n_bands = bands.shape[0]
    depth = bands[0]
    valid = np.isfinite(depth)
    if info.nodata is not None:
        valid &= depth != info.nodata
    d = np.where(valid, depth, np.nan)

    panels = [("depth (hillshade)", None)]
    if n_bands >= 4:
        panels += [("classification", 1), ("confidence", 2),
                   ("correction", 3)]
    if args.original:
        panels.append(("residual (cleaned - original)", "residual"))

    ncols = min(len(panels), 3)
    nrows = (len(panels) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(5.2 * ncols, 4.4 * nrows),
                             squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")

    for i, (title, src) in enumerate(panels):
        ax = axes[i // ncols][i % ncols]
        ax.set_title(title, fontsize=10)
        if src is None:
            hs = hillshade(d)
            ax.imshow(hs, cmap="gray", interpolation="nearest")
            im = ax.imshow(d, cmap="viridis", alpha=0.55,
                           interpolation="nearest")
            fig.colorbar(im, ax=ax, shrink=0.75)
        elif src == "residual":
            orig, _ = read_geotiff(args.original)
            res = np.where(valid, depth - orig[0][:depth.shape[0],
                                                  :depth.shape[1]], np.nan)
            lim = np.nanpercentile(np.abs(res), 99) or 1.0
            im = ax.imshow(res, cmap="RdBu_r", vmin=-lim, vmax=lim,
                           interpolation="nearest")
            fig.colorbar(im, ax=ax, shrink=0.75)
        else:
            band = np.where(valid, bands[src], np.nan)
            if title == "classification":
                im = ax.imshow(band, cmap="tab10", vmin=0, vmax=9,
                               interpolation="nearest")
            elif title == "confidence":
                im = ax.imshow(band, cmap="magma", vmin=0, vmax=1,
                               interpolation="nearest")
            else:
                lim = np.nanpercentile(np.abs(band), 99) or 1.0
                im = ax.imshow(band, cmap="RdBu_r", vmin=-lim, vmax=lim,
                               interpolation="nearest")
            fig.colorbar(im, ax=ax, shrink=0.75)

    out = args.output or str(Path(args.raster).with_suffix(".png"))
    fig.tight_layout()
    fig.savefig(out, dpi=args.dpi)
    plt.close(fig)
    print(out)
    return for_caller(out, argv)


if __name__ == "__main__":
    main()
