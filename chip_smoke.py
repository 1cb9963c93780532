#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bathymetric_gnn_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every CUDA source of the port is compiled from ``csrc/``, one nvcc per
   source, all in parallel, into ``build/torch_kernels/``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (full width: hidden 64 x 4 heads);
3. the main path through the port's CLI (``cli.inference.main``) on a
   synthetic 2304x2304 survey (9 tiles of 1024 with overlap 128: one batch
   of 8, then one single tile), with the launch counts read around that
   run; the outputs are checked, and one tile's model forward through the
   kernel is compared with the same model on its plain functions;
4. timings with CUDA events after warm-up.

Then one JSON line describing every kernel, and last the line
``{"ok": true, "device": {...}}``. Any failed check or phase exits
non-zero without that line. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero at once. Weights are random, from
fixed seeds; nothing is read from the network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
SEED = 0
TILE = 1024
RAGGED = 600           # width of the ragged edge tile in phase 2
SURVEY = 2304          # 3 x 3 tiles of 1024 at stride 896
MODEL_LAYERS = 4
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by
# input type (FP32 outside the tensor cores; bf16 tensor cores).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# kernel vs plain version on the card: |err| <= TOL * (1 + |ref|).
# f32: the same f32 products summed in another order (~1e-6 measured);
# bf16: one or two bf16 rounding steps of the output (2^-7 relative each).
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# -- phase 1 ------------------------------------------------------------------

def phase_card_and_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from bathymetric_gnn_tpu_torch.ops.cuda import _build

    t0 = time.time()
    libs = _build.build_all()
    build_s = time.time() - t0
    log(f"[1] card: {torch.cuda.get_device_name(0)} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[1] kernels built in {build_s:.2f} s: "
        + ", ".join(p.name for p in libs.values()))
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   {name}: {line.strip()}")
    return card


# -- inputs --------------------------------------------------------------------

def synthetic_survey(np, h, w, seed):
    """Depth ramp + sinusoid + roughness at ~30 m, 1% spikes of 0.5-4 m,
    one NaN hole and scattered dropouts; uncertainty 0.1-0.4 m."""
    rg = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (30.0 + 0.002 * xx + 0.001 * yy + 0.5 * np.sin(xx / 37.0)
             + 0.3 * np.cos(yy / 53.0)
             + rg.normal(0, 0.02, (h, w))).astype(np.float32)
    spikes = rg.random((h, w)) < 0.01
    depth[spikes] += (rg.uniform(0.5, 4.0, spikes.sum())
                      * rg.choice([-1, 1], spikes.sum())).astype(np.float32)
    depth[h // 3:h // 3 + 150, w // 2:w // 2 + 200] = np.nan
    depth[rg.random((h, w)) < 0.002] = np.nan
    unc = rg.uniform(0.1, 0.4, (h, w)).astype(np.float32)
    return depth, unc


def seeded_model(torch, np):
    """Full-width default-config model (GAT, hidden 64, 4 layers, 4 heads,
    8-conn, edge_dim 3) with random weights and BatchNorm statistics."""
    from bathymetric_gnn_tpu_torch.models.grid_gat import GridBathymetricGNN

    g = torch.Generator().manual_seed(SEED)
    model = GridBathymetricGNN(7, 64, MODEL_LAYERS, 4, generator=g)
    rg = np.random.default_rng(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.from_numpy(
                    rg.normal(0, 0.2, buf.shape).astype(np.float32)))
            elif name.endswith(".var"):
                buf.copy_(torch.from_numpy(
                    rg.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    return model.eval()


# -- phase 2 ---------------------------------------------------------------------

def layer_cases(torch, np, model, dev):
    """(label, args, kwargs, dims) for the main path's layer shapes."""
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    depth, _ = synthetic_survey(np, TILE, TILE, SEED + 1)
    inputs = {}   # each tile shape is featurized on its own, as a tile is
    for conn, wid in ((8, TILE), (8, RAGGED), (4, TILE)):
        d = depth[:, :wid]
        inputs[conn, wid] = build_grid_inputs(
            torch.from_numpy(np.nan_to_num(d))[None].to(dev),
            torch.from_numpy(np.isfinite(d))[None].to(dev),
            connectivity=conn)
    g = torch.Generator().manual_seed(SEED + 2)
    cases = []
    layers = [(0, "layer0 64->256 h4 BN+ReLU", True),
              (1, "mid 256->256 h4 BN+ReLU", True),
              (MODEL_LAYERS - 1, "last 256->64 h1 BN", False)]
    for (hgt, wid) in ((TILE, TILE), (TILE, RAGGED)):
        for li, label, relu in layers:
            for dtype in ("float32", "bfloat16"):
                cases.append((li, label, relu, dtype, hgt, wid, 8))
    cases.append((1, "mid 256->256 h4 BN+ReLU", True, "float32", TILE, TILE,
                  4))
    out = []
    for li, label, relu, dtype, hgt, wid, conn in cases:
        conv = getattr(model, f"GridGATConv_{li}")
        norm = getattr(model, f"MaskedBatchNorm_{li}")
        _, v, nbr, ea, _ = inputs[conn, wid]
        nbr = nbr.float()
        f_in = conv.lin_src.shape[0]
        x = torch.randn(1, hgt, wid, f_in, generator=g).to(dev) * v[..., None]
        params = {n: p.detach().clone()
                  for n, p in conv.named_parameters(recurse=False)}
        w_lin, a_s, a_d, m_e, bias = gf.gat_param_matrices(
            params, conv.heads, conv.out_channels, 3)
        sc, sh = (t.detach().clone() for t in norm.affine())
        args = (x, w_lin, a_s, a_d, m_e, ea, nbr, v.float(), bias, conn,
                0.2, True)
        kw = dict(bn_scale=sc, bn_bias=sh, fuse_relu=relu,
                  compute_dtype=getattr(torch, dtype))
        dims = dict(h=hgt, w=wid, f=f_in, hc=w_lin.shape[1],
                    heads=conv.heads, k=conn, dtype=dtype)
        out.append((f"{label} {dtype} {hgt}x{wid} conn{conn}", args, kw,
                    dims))
    return out


def phase_kernel_vs_plain(torch, cases):
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    worst = {}
    with torch.no_grad():
        for label, args, kw, dims in cases:
            out = gf.fused_grid_gat_infer(*args, **kw)
            torch.cuda.synchronize()
            ref = gf.grid_gat_infer_reference(*args, **kw)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            rel = (d / (1 + ref.float().abs())).max().item()
            ok = (rel <= TOL[dims["dtype"]]
                  and bool(torch.isfinite(out.float()).all()))
            log(f"[2] {label}: max_abs {d.max().item():.3e} "
                f"max_rel(1+|ref|) {rel:.3e} tol {TOL[dims['dtype']]:.1e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with its plain version: {label}")
            worst[label] = d.max().item()
            del out, ref
    return worst


# -- phase 3 ---------------------------------------------------------------------

def phase_end_to_end(torch, np, model, work):
    from bathymetric_gnn_tpu_torch.cli import inference as cli
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff, write_geotiff
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.utils.weights import save_checkpoint

    depth, unc = synthetic_survey(np, SURVEY, SURVEY, SEED + 3)
    src = work / "survey.tif"
    write_geotiff(src, np.stack([depth, unc]), pixel_scale=(2.0, 2.0),
                  origin=(500000.0, 4000000.0), nodata=float("nan"))
    ckpt = save_checkpoint(work / "ckpt", model.state_dict(),
                           calibration={"confidence_scale": 1.5,
                                        "confidence_bias": 0.3})
    check(not (ckpt / "config.yaml").exists(), "checkpoint has a config")
    out = work / "cleaned.tif"
    # random weights give confidences near 0.5: a threshold of 0.5 lets
    # the run apply corrections, so the correction path is exercised too
    argv = ["--input", str(src), "--output", str(out), "--model", str(ckpt),
            "--confidence-threshold", "0.5",
            "--stats-json", str(work / "stats.json")]

    cli.main(argv)                       # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    gf.launches = 0                      # counts of the main path's run
    t0 = time.perf_counter()
    stats = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gf.launches

    n_tiles = stats["tiles_processed"]
    calls = n_tiles // 8 + n_tiles % 8   # one batch of 8, the rest single
    check(n_tiles == 9, f"expected 9 tiles, got {n_tiles}")
    check(launches == MODEL_LAYERS * calls,
          f"grid_gat_fwd launches {launches} != {MODEL_LAYERS} layers x "
          f"{calls} forward calls")
    bands, _ = read_geotiff(out)
    valid = np.isfinite(depth)
    check(bands.shape == (6, SURVEY, SURVEY), f"output bands {bands.shape}")
    for i, name in enumerate(("depth", "uncertainty", "classification",
                              "confidence", "correction")):
        check(np.isfinite(bands[i][valid]).all(), f"non-finite {name}")
    classes = set(np.unique(bands[2][valid]).tolist())
    check(classes <= {0.0, 1.0, 2.0}, f"classes {classes}")
    check(0.0 <= bands[3][valid].min() and bands[3][valid].max() <= 1.0,
          "confidence outside [0, 1]")
    fixed = valid & (bands[2] == 2) & (bands[3] > 0.5)   # confident noise
    check(stats["cells_corrected"] == int(fixed.sum()) > 0,
          f"cells_corrected {stats['cells_corrected']} vs {fixed.sum()}")
    check(np.array_equal(bands[0][fixed], (depth - bands[4])[fixed])
          and np.array_equal(bands[0][valid & ~fixed],
                             depth[valid & ~fixed]),
          "cleaned depth is not depth - correction on confident noise")
    check(np.allclose(bands[1][fixed], unc[fixed] * (2 - bands[3][fixed]),
                      rtol=1e-6), "uncertainty not scaled on corrected cells")
    log(f"[3] cli.inference on {SURVEY}x{SURVEY}: {n_tiles} tiles in "
        f"{wall:.3f} s ({n_tiles / wall:.3f} tiles/s), grid_gat_fwd "
        f"launches {launches} = {MODEL_LAYERS} layers x {calls} calls, "
        f"classes {sorted(classes)}, cells_corrected "
        f"{stats['cells_corrected']}, mean_confidence "
        f"{stats['mean_confidence']:.4f}")
    return dict(launches=launches, wall=wall, tiles=n_tiles, src=src,
                ckpt=ckpt, depth=depth, argv=argv)


def phase_model_kernel_vs_plain(torch, np, pipe, depth):
    """One 1024^2 tile: model through the kernel vs the same model with
    every GAT layer on its plain version, both on the card."""
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    tile = depth[:TILE, :TILE]
    dev = pipe.device
    inputs = build_grid_inputs(
        torch.from_numpy(np.nan_to_num(tile))[None].to(dev),
        torch.from_numpy(np.isfinite(tile))[None].to(dev))[:4]
    with torch.no_grad():
        k = pipe.model(*inputs)
        with mock.patch.object(gf, "fused_grid_gat_infer",
                               gf.grid_gat_infer_reference):
            p = pipe.model(*inputs)
    v = inputs[1][0]
    agree = (k["predicted_class"] == p["predicted_class"])[0][v].float()
    dconf = (k["confidence"] - p["confidence"]).abs()[0][v].max().item()
    dcorr = (k["correction"] - p["correction"]).abs()[0][v].max().item()
    log(f"[3] model on one {TILE}^2 tile, kernel vs plain on the card: "
        f"class agreement {agree.mean().item():.6f}, max |d confidence| "
        f"{dconf:.3e}, max |d correction| {dcorr:.3e}")
    check(agree.mean().item() >= 0.999, "class agreement below 0.999")
    check(dconf <= 1e-3 and dcorr <= 1e-2, "model outputs disagree")


# -- phase 4 ---------------------------------------------------------------------

def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(dims):
    """Least time for one call: the kernel's inputs read once and its
    output written once over HBM bandwidth, vs its operations (x@W, the
    attention dots, the 9-way weighted sum) over the peak rate of the
    input type."""
    n = dims["h"] * dims["w"]
    f, hc, heads, k = dims["f"], dims["hc"], dims["heads"], dims["k"]
    s = 4 if dims["dtype"] == "float32" else 2
    nbytes = (s * (n * f + f * hc + f * 2 * heads + (k + 1) * heads * n
                   + n * hc) + 4 * n + 12 * hc)
    flops = 2 * n * f * hc + 2 * n * f * 2 * heads + 2 * (k + 1) * n * hc
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dims["dtype"]] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def phase_timings(torch, np, cases, pipe, depth):
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    rows = []
    with torch.no_grad():
        for label, args, kw, dims in cases:
            if dims["w"] != TILE or dims["k"] != 8:
                continue
            kargs = gf.kernel_args(*args, **kw)
            ms = cuda_ms(torch, lambda: gf.call_kernel(**kargs), 10)
            wrap_ms = cuda_ms(torch,
                              lambda: gf.fused_grid_gat_infer(*args, **kw), 5)
            plain_ms = cuda_ms(
                torch, lambda: gf.grid_gat_infer_reference(*args, **kw), 3,
                warmup=1)
            b_ms, b_by, nbytes, flops = bound(dims)
            rows.append(dict(shape=label, ms=ms, wrapper_ms=wrap_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             bytes=nbytes, flops=flops))
            log(f"[4] {label}: kernel {ms:.3f} ms (wrapper incl. edge "
                f"precompute {wrap_ms:.3f} ms), plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.3f} ms by {b_by} ({nbytes / 1e9:.3f} GB, "
                f"{flops / 1e9:.1f} GFLOP), {b_ms / ms:.3f} of bound")
            del kargs

        tiles = [depth[r:r + TILE, c:c + TILE] for r in (0, 896, 1280)
                 for c in (0, 896, 1280)][:8]
        d8 = np.stack([np.nan_to_num(t) for t in tiles])
        v8 = np.stack([np.isfinite(t) for t in tiles])
        fwd_ms = cuda_ms(
            torch, lambda: pipe.forward_tiles(d8, v8, None, (2.0, 2.0)), 3,
            warmup=1)
        log(f"[4] featurize + model forward, batch of 8 {TILE}^2 tiles: "
            f"{fwd_ms:.3f} ms ({fwd_ms / 8:.3f} ms per tile, 4 kernel "
            f"launches per forward call)")
    return rows, fwd_ms / 8


def phase_profile(torch, argv):
    """One more CLI run under torch.profiler: device time by kernel and
    the device's busy share of the run's wall time (the profiler slows the
    host, so the idle share it gives is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    from bathymetric_gnn_tpu_torch.cli import inference as cli

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []   # device-side events only (kernels, copies); the CPU ops
    for ev in prof.key_averages():   # that launched them would count twice
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log("[4] profiler: no device time recorded; busy share not measured")
        return None
    log(f"[4] profiled cli run: wall {wall:.3f} s, device busy "
        f"{busy / 1e3:.3f} s ({busy / 1e3 / wall:.3f} of wall)")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"[4]   {ms:10.3f} ms  x{n:<5d} {key[:90]}")
    return busy / 1e3 / wall


# -- main --------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    try:
        import bathymetric_gnn_tpu_torch as port
    except ImportError:
        print(f"chip_smoke: the port is not beside this script ({HERE}); "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    if HERE not in Path(port.__file__).resolve().parents:
        print(f"chip_smoke: imported {port.__file__}, not the checkout's "
              "package", file=sys.stderr)
        return 1
    import numpy as np

    phase = "setup"
    try:
        from bathymetric_gnn_tpu_torch.inference.pipeline import (
            BathymetricPipeline)
        from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

        pipe = BathymetricPipeline(tile_batch=8)   # sets allow_tf32 = False
        dev = pipe.device
        work = HERE / "build" / "chip_smoke"
        work.mkdir(parents=True, exist_ok=True)

        phase = "1 card and build"
        card = phase_card_and_build(torch)
        phase = "2 kernel vs plain"
        model = seeded_model(torch, np).to(dev)
        cases = layer_cases(torch, np, model, dev)
        errs = phase_kernel_vs_plain(torch, cases)
        phase = "3 end to end"
        e2e = phase_end_to_end(torch, np, model, work)
        pipe.load_model(e2e["ckpt"])
        phase_model_kernel_vs_plain(torch, np, pipe, e2e["depth"])
        phase = "4 timings"
        rows, tile_ms = phase_timings(torch, np, cases, pipe, e2e["depth"])
        log(f"[4] end to end (cli.inference, load + 9 tiles + stitch + "
            f"write): {e2e['tiles'] / e2e['wall']:.3f} tiles/s")
        busy_share = phase_profile(torch, e2e["argv"])
    except Exception:
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        traceback.print_exc()
        return 1

    main_row = next(r for r in rows if r["shape"].startswith("mid")
                    and "float32" in r["shape"])
    mid_label = main_row["shape"]
    kernels = [{
        "name": "grid_gat_fwd",
        "route": "cuda",
        "source": "bathymetric_gnn_tpu_torch/csrc/grid_gat_fwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py:149",
        "launches": e2e["launches"],
        "max_abs_err": errs[mid_label],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "at": mid_label,
        "shapes": rows,
        "model_forward_ms_per_tile": tile_ms,
        "end_to_end_tiles_per_s": e2e["tiles"] / e2e["wall"],
        "end_to_end_device_busy_share": busy_share,
    }]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
