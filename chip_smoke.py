#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bathymetric_gnn_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every CUDA source of the port is compiled from ``csrc/``, one nvcc per
   source, all in parallel, into ``build/torch_kernels/``, and the native
   graph kit (``native/graphkit.cpp``) with g++ beside them; ptxas's
   registers and spills of each library, and of the forward passes of C,
   E and D and D's dots one by one;
2. kernel A (inference form) against its plain PyTorch version on the
   card, at the shapes the inference path gives it (full width: hidden
   64 x 4 heads, 1024^2 tiles) and at the default VR route's slab shape
   ([128, 56, 56] of refinement grids, the three layer widths, f32 and
   bf16);
2a. kernels A and B with every input and output flush against unmapped
   address space (``ops/cuda/guard.py``), once at the end of the mapping
   and once at the start, so that an access just past either end of a
   buffer faults every time (first checked: a kernel's read just outside
   a guard-placed tensor faults, in two child processes, one a layout):
   kernel A at every phase-2 case and at odd
   shapes (F 7 and 13, HC not a multiple of 4, H and W below one 14 x 14
   block, heads 1, 2 and 8), kernel A's training form and kernel B at
   phase 2b's f32 cases and the odd shapes, with a streamed mask and with
   the Philox draw; each call synchronized, bit for bit the ordinary call
   and within 2's / 2b's tolerances of the plain version; then 50 more
   launches of each phase-2 case, each synchronized and bit for bit the
   first;
2b. kernel A (training form, streamed dropout mask) and kernel B against
   the plain forward and autograd of it, at the training model's three
   layer shapes on [4, 256, 256], f32 and bf16, plus a ragged shape and
   4-connectivity; and the in-kernel Philox draw: its drop rate, and A + B
   with the draw equal to A + B given the same draw as a streamed mask;
2c. kernel C (the GAT layer on ELL graphs) against its plain version on
   the card: a k-NN graph (k 8) of a synthetic 256x256 survey with 5 %
   holes (~62k nodes padded to 65,536) at HC 256 / 4 heads and HC 64 /
   1 head, and a ragged batch of small graphs (isolated nodes, fewer than
   K live slots) at K = 16;
2d. kernel C's dropout form, kernel C' (the layer's backward) and kernel F
   (the sorted-segment reduction: mode (b), the training path's, on its
   own, and mode (a) against ``index_add_``) against the plain forward and
   autograd of it, on a merged batch of 4 k-NN graphs of synthetic 256^2
   tiles with 5 % holes (N = 262,144) at HC 256 / 4 heads and HC 64 /
   1 head, and on the ragged K = 16 batch, with no dropout, a streamed
   mask and the Philox draw (its rate, and C + C' with the draw equal to
   C + C' given it as a streamed mask); C' given the attention dots kernel
   C wrote (the training layer's path) equal, bit for bit, to C' computing
   its own, and the dots pass equal to the generic ``dots_kernel``; and C'
   at a row past its untiled instances (HC 2056 = 2 x 1028, f32: column
   tiles) against autograd of the plain version;
3. the inference path through the port's CLI (``cli.inference.main``) on
   a synthetic 2304x2304 survey (9 tiles of 1024 with overlap 128: one
   batch of 8, then one single tile), with the launch counts read around
   that run; the outputs are checked, and one tile's model forward through
   the kernel is compared with the same model on its plain functions;
3b. the training path through ``cli.train.main --trainer grid`` on a
   synthetic clean 928x928 survey (16 tiles of 256, batches of 4, 2
   epochs, dropout 0.1, f32; then the same in bf16), with the launch
   counts read around the f32 run; losses finite, every parameter has a
   gradient, one step's gradients through the kernels agree with the same
   step on the plain functions, and ``cli.inference`` serves the
   checkpoint the run wrote;
3c. k-NN serving through ``NativeVRProcessor`` (``knn_k=8``, node budget
   50,000) on 2,000 synthetic refinement grids (sides 3..50, 5 % NODATA)
   plus one 512x512 grid, from a graph-trained port checkpoint at full
   width: every grid returns, kernel C's launch count is 4 x the graph
   chunks and the plain version is not called; one flush is compared with
   the same processor on the plain functions; grids/s, Mnodes/s and the
   device's busy share; and ``cli.inference_native`` on a VR BAG when h5py
   is installed;
3d. k-NN training through ``cli.train.main --trainer graph --knn-k 8`` on
   a synthetic 1024^2 survey with 5 % holes (25 tiles of 256, batches of
   4, 1 epoch, default width), with the launch counts of kernels C
   (training form), C' and F read around the run (4 per step each) and no
   plain version called; losses finite, every parameter has a gradient,
   ``best/calibration.json`` written, and ``NativeVRProcessor`` serves the
   checkpoint; one step through the kernels against the same step on the
   plain functions (dropout 0); the ``"banded"`` route trains too (at
   dropout 0, phase 3f);
4. timings with CUDA events after warm-up: kernel A per inference shape,
   kernels A (training form) and B per training shape, each beside its
   bound (products at the tensor-core rate, ``MMA_FLOPS``) and, as
   information, ``torch.matmul`` of the same x@W product (the port never
   calls it), kernel A at phase 2's slab shape and one slab chunk's
   featurization + forward (f32, bf16), the whole train step in f32 and
   bf16, kernel C per shape with the model forward of
   one 65,536-node flush, and (4d) kernel C's training form, C', F's two
   modes (``index_add_`` beside mode (a)) per k-NN training shape and the
   k-NN train step on one merged batch with its device busy share and the
   launches and time of the attention dots a step (C's only: C' takes
   them from C);
2e. (run after 2d) kernel E (the banded band part) on phase 2c's k-NN
   graph split into 128-row bands (HC 256 / 4 heads and HC 64 / 1 head),
   kernels D and D' (the fused banded layer and its backward, with F's
   mode (a) behind its spill gathers) on phase 2d's merged batch, with no
   dropout and a streamed mask, against their plain versions; D' given
   the attention dots kernel D wrote (the training layer's path) equal,
   bit for bit, to D' computing its own, and those dots equal to the
   generic ``mat_dots_kernel``'s; and D' at HC 2056 (column tiles);
3e. (run after 3d) ``NativeVRProcessor`` with ``sparse_kernel="banded"``
   (kernel E and the spill fold) on phase 3c's grids from the same
   checkpoint: E's launch count is 4 x the graph chunks, kernel C and the
   plain versions are not called, the results agree with 3c's; grids/s
   and the device's busy share;
4e. (run after 4d) CUDA-event times of E, D and D' (given D's dots, and
   computing its own) against their bounds and plain versions, the D + D'
   layer beside C + C' on the same batch, the attention dots of D, D' and
   E alone (``mat_dots``, beside its generic form and ``torch.matmul``) at
   N 65,536 and 262,144, HC 256 and 64, and one k-NN train step with every
   layer on route D (``wide_kernel=False``): its launches (4 dots launches
   a step: D' takes D's), ms and busy share;
2f. (run after 2e) the bf16 forms (``compute_dtype="bfloat16"``) against
   their plain versions on the same bf16 inputs: kernels C and E on phase
   2c's graph (HC 256 / 4 heads and HC 64 / 1 head), C's training form
   (no dropout, a streamed mask, the Philox draw) with C' and F (b), F (a)
   on a bf16 cotangent, and D and D' (F (a) on the bf16 spill rows) on
   phase 2d's batch, D' given D's dots bit for bit as in 2e; tolerances
   TOL / GRAD_TOL bf16 (E's f32 outputs: BAND_FWD_TOL);
3f. (run after 3e) the bf16 model at full width serving the 65,536-node
   flush on routes C, D and E: 4 launches of the route's kernel, no other
   kernel and no plain version, classes against the f32 model of the same
   weights (>= 99 %); and one ``Trainer`` step on the ``"banded"`` route at
   dropout 0 (the route trains since this slice: the JAX XLA route's plain
   math under autograd, no kernel) on the card against the same step on
   the CPU;
3g. (run after 3f) the default VR route: ``NativeVRProcessor`` with
   ``knn_k=0`` on 3c's checkpoint and grids (node budget 50,000), at the
   default precision (bf16 on the card) and in f32: the refinements in
   slabs through the dense grid model (kernel A launched 4 x the slab
   chunks), the 512^2 grid on a grid-connectivity graph through
   ``GATConvELL`` (kernel C, 4 x the graph chunks), no plain version
   called; one slab flush against the same processor on the plain
   functions; bf16 classes against f32 (>= 99 %); 2,100 grids of 3x3 in
   one flush (two slab chunks, 2,048 + 52); grids/s, Mnodes/s and the
   device's busy share beside 3c's; ``cli.inference_native`` without
   ``--knn-k`` where h5py is installed;
3h. (run after 3g) streaming inference through ``cli.inference
   --streaming``: phase 3's survey and checkpoint (12 launches of kernel A
   = 4 x 3 tile rows, no plain version), its five bands against phase 3's
   in-memory output (classes and valid mask equal, the rest within
   1e-4 / 1e-3, cells_corrected equal); then a 16,384 x 4,096 survey
   (95 tiles of 1024^2 in 19 tile rows) written band by band and streamed
   twice: 76 launches of A each run, the output read back in row windows
   and checked (classes, confidence range, the swath gap, the
   corrections), tiles/s, the growth of the host's VmRSS (sampled every
   20 ms; at most 1 GiB) and the split of the wall time by stage in the
   first run, the device's busy share under the profiler in the second;
   SR and VR BAGs through the CLI where h5py is installed;
4f. (run after 4e) CUDA-event times of every bf16 form against its bound
   (bf16 streams at 2 bytes) and its plain version, the bf16 dots alone
   as in 4e, the bf16 flush forward
   beside 4c's f32 one, and one bf16 train step on routes C and D (dropout
   0.1, f32 master weights) beside the f32 steps of 4d and 4e: launches,
   ms and the device's busy share;
2g. (run after 2f) kernel F as the COO path's segment sum: on the
   grid-connectivity graph of a synthetic 256^2 survey with 5 % holes
   (65,536-node bucket, pads at N - 1), rows of width 256 and 64
   (messages), 4 and 1 (softmax denominators, counts) and 3 (edge
   attributes), f32 and bf16, summed over the destination table and over
   the source-sorted table (a gather's backward): bit for bit against the
   in-order sum (each segment's rows added from 0 in ascending slot
   order), two calls bit for bit, and within 1e-5 (1 + max |ref|) of
   ``index_add_`` on the card;
3i. (run after 3h) ``NativeVRProcessor(use_ell=False)``: the COO model at
   full width on 3g's first 500 refinements and its 512^2 grid (every
   grid a grid-connectivity graph): F launched 4 x 4 layers x the graph
   chunks, no plain version, two runs bit for bit, classes against 3g's
   f32 default route (>= 99 %), grids/s and busy share beside 3g's; GCN,
   GraphSAGE and GIN models on the default route (slab ELL graphs and
   the 512^2 graph, 200 refinements), card against CPU; and
   ``cli.smoke_test`` on the card (all stages; A launched 2 times, F 8);
3j. (run after 3i) ``cli.train --trainer graph`` at its defaults (no
   ``--knn-k``: the COO model) for 1 epoch on 3d's survey: F launches
   against the count the code implies, no plain version, finite losses,
   best/last/final with calibration.json, the checkpoint served on the
   default route; one step through F against the step on F's plain
   version (dropout 0, N = 262,144: loss 1e-5; each gradient against the
   step in f64, clipped to the global norm as the step clips its own,
   F's error no more than the f32 plain version's plus
   1e-3: of each entry's sum of |terms| for lin_edge and att_edge, which
   cancel, of the leaf's largest |entry| for the others); two steps
   from one state and seed bit for bit; one epoch of ``--gnn-type GCN``
   on 8 tiles;
4g. (run after 4f) F at each COO shape, the flush's and the train
   batch's (event span, device time from a CUDA graph of 20 calls, the
   wrapper's host time a call; bound, plain version, ``index_add_``,
   launches by width), the COO model's 65,536-node flush forward
   beside route C on the same chunk, and the COO train step at
   N = 262,144 (busy share) beside 4d's route-C step;
3k. (run after 3j) the ground-truth workflow: a 1536^2 clean / noisy pair
   (deflate GeoTIFFs; the noisy copy's origin 3 rows / 5 cols in, 0.05 m
   deeper, with spikes and an uncertainty band) and an ENC cell from the
   port's S57Writer (a wreck and a rock); ``cli.prepare_ground_truth
   --s57`` (5 bands, the offset, class-1 discs at the features, noise
   labels where |diff - offset| > 0.15); ``cli.train --trainer graph
   --ground-truth-dir`` for 1 epoch at ``--num-workers`` 0, 2 and 4 (F's
   launches as the code implies, no plain version; while 4 workers build
   tiles only this process holds the card: nvidia-smi's count of contexts
   does not grow and no worker has a card device file open; the 2- and
   4-worker histories bit for bit; the 0-worker epoch-0 loss within 1e-5
   of the 2-worker one; tiles/s, wall and usable CPUs a run);
   ``cli.inference`` of the trained checkpoint on the noisy survey (A, 4 x
   the forward calls) scored by ``cli.evaluate_model`` (n_cells = the GT's
   valid cells); a reference-layout PyTorch checkpoint at full width
   through ``cli.import_torch`` (every tensor as mapped), served on phase
   3's survey (A, 8 launches) and by ``NativeVRProcessor(use_ell=False)``
   on 100 refinements (F, twice bit for bit); ``cli.diagnose_tiles`` and
   ``cli.analyze_noise_patterns`` JSON;
3l. (run after 3k) the sharded paths (``parallel/``) in a world of 1
   over NCCL, in this process: the COO data-parallel step on 3j's 4-tile
   batch and the k-NN one (route C) on 3d's merged batch against
   ``Trainer.train_step`` (SGD at learning rate 1, dropout 0: losses and
   each leaf's change, launches of F, of C / C' / F (b), no plain version),
   both with ``exact=False`` (local BatchNorm) too, bit for bit the
   ``exact=True`` step at world 1 with the same launches and no plain
   version; the ``exact=False`` step of 2 ranks computed in this process
   (each half batch's own loss and gradient, averaged, then the clip and
   SGD) and the k-NN step's exact gradient in f64, 3m's references; the
   COO step once more at dropout 0.1; the 1-D (overlapped and serial)
   and 2-D sharded forwards on a 2048^2 survey with holes against
   ``GridBathymetricGNN`` on the whole grid (classes >= 99.99 %,
   confidence and correction within 1e-3; A launched 1 + 3 x 3 or 4
   times, no plain version); the 1-D and 2-D halo train steps on 3b's 4
   tiles against ``GridTrainer.train_step`` on each tile alone, the
   tiles' updates averaged (A and B launches); CUDA-event times of each
   beside its single-card counterpart, and of one BatchNorm all-reduce;
3m. (run after 3l) 2 spawned processes on the one card joined over gloo
   (NCCL refuses two ranks on one device), each rank's compute on the
   card through kernels A, B and F: the 1-D forwards (2 row shards, a
   hole across their seam), the 2-D forwards on 1 x 2 and 2 x 1 meshes,
   the 1-D halo train step, the COO data-parallel step (kernel F) and the
   k-NN one (route C: kernels C, C' and F (b)), 2 tiles a rank, each with
   ``exact`` True and False, against 3l's world-1 results (``exact=False``
   against 3l's 2-rank reference; the k-NN ``exact=True`` step also
   against the exact gradient in f64, no further from it than 3l's step
   plus 1e-3); the launches of F and of C / C' / F (b) as in 3l; each
   rank's times, its exchange
   of one layer's boundary rows and a BatchNorm all-reduce (through the
   host on gloo); each rank's failures printed, the phase failing on
   any.

Then one JSON line describing every kernel, and last the line
``{"ok": true, "device": {...}}``. Any failed check or phase exits
non-zero without that line. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero at once. Weights are random, from
fixed seeds; nothing is read from the network.
"""

from __future__ import annotations

import gc
import json
import re
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
# The rate of the fastest f32-accurate matrix product the card has, for
# kernels A and B's products: f32 products run as 3xTF32 (three TF32
# tensor-core MMAs a product, 495 / 3 TFLOP/s); bf16 on bf16 MMAs. Their
# other operations (the 9-way sums) run on the CUDA cores at the FP32 rate.
MMA_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# kernel vs plain version on the card: |err| <= TOL * (1 + |ref|).
# f32: the same f32 products summed in another order (~1e-6 measured);
# bf16: one or two bf16 rounding steps of the output (2^-7 relative each).
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# kernel B vs autograd of the plain version, per gradient against its
# largest |entry|: f32 2e-4 (sums over all cells in another order); bf16
# 3e-2 (kernel B rounds dxh and d_ad to bf16 before its products, where
# autograd rounds after them; the JAX bf16 backward tests' tolerance).
GRAD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
TRAIN_TILE = 256
TRAIN_BATCH = 4
TRAIN_SURVEY = 928      # 4 x 4 tiles of 256 at stride 224
TRAIN_EPOCHS = 2
KEEP = 0.9              # 1 - the default dropout (config.model.dropout)
LEAVES = ("x", "w_lin", "a_src", "a_dst", "m_edge", "bias")


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

    from bathymetric_gnn_tpu_torch import native

    t0 = time.time()
    libs = _build.build_all()
    native.library()
    build_s = time.time() - t0
    log(f"[1] card: {torch.cuda.get_device_name(0)} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[1] kernels built in {build_s:.2f} s: "
        + ", ".join(p.name for p in libs.values()) + ", "
        + native.library_path().name)
    for name in libs:
        kernels = ptxas_report(_build.build_log(name))
        regs = [r for _, r, _ in kernels]
        spilled = [b for _, _, b in kernels if b]
        log(f"[1]   {name}: {len(kernels)} kernels, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{len(spilled)} spill (<= {max(spilled, default=0)} B stores)")
        for kernel, r, b in kernels:
            if (name in ("ell_gat_fwd", "ell_gat_band") and any(
                    x in kernel for x in FWD_KERNELS)) or (
                    name == "ell_gat_v2_fwd" and any(
                        kernel.startswith(x) for x in V2_KERNELS)):
                log(f"[1]     {kernel}: {r} registers, {b} B spill stores")
    return card


# The kernels of C's and E's forward passes, and of D's with the forms of
# the dots its main path runs (HC 256 / 4 heads, HC 64 / 1 head), whose
# ptxas lines phase 1 prints one by one.
FWD_KERNELS = ("aggregate_kernel", "band_kernel", "node_dots_kernel")
V2_KERNELS = ("v2_fwd_kernel", "mat_dots_reg_kernel<float,8,8>",
              "mat_dots_reg_kernel<bf16,8,8>",
              "mat_dots_reg_kernel<float,2,2>",
              "mat_dots_reg_kernel<bf16,2,2>")


def ptxas_report(text):
    """[(kernel, registers, spill store bytes)] from nvcc's -Xptxas -v
    output, the kernel named by its function and template arguments
    (``aggregate_kernel<float,4>``) read from the mangled name."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            # the kernel's name: the <length><name> part that ends in
            # _kernel and is followed by its template arguments
            k = next((x for x in re.finditer(
                r"(?=(\d{1,2})([a-z][a-z0-9_]*_kernel)I(.*?)EE?v)", mangled)
                if len(x.group(2)) == int(x.group(1))), None)
            if k:
                args = k.group(3).replace("13__nv_bfloat16", "bf16,")
                if args.startswith("f"):
                    args = "float," + args[1:]
                args = re.sub(r"Lb([01])E?", lambda x: ("true" if x.group(1)
                                                        == "1" else "false")
                              + ",", args)
                args = re.sub(r"Li(\d+)E?", r"\1,", args)
                name = f"{k.group(2)}<{args.rstrip(',E')}>"
            else:
                name = mangled[:60]
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return out


# -- inputs --------------------------------------------------------------------

def synthetic_survey(np, h, w, seed, spikes=True):
    """Depth ramp + sinusoid + roughness at ~30 m, 1% spikes of 0.5-4 m
    (unless ``spikes`` is off: a clean survey), one NaN hole and scattered
    dropouts; uncertainty 0.1-0.4 m."""
    rg = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (30.0 + 0.002 * xx + 0.001 * yy + 0.5 * np.sin(xx / 37.0)
             + 0.3 * np.cos(yy / 53.0)
             + rg.normal(0, 0.02, (h, w))).astype(np.float32)
    if spikes:
        hit = rg.random((h, w)) < 0.01
        depth[hit] += (rg.uniform(0.5, 4.0, hit.sum())
                       * rg.choice([-1, 1], hit.sum())).astype(np.float32)
    depth[h // 3:h // 3 + 150, w // 2:w // 2 + 200] = np.nan
    depth[rg.random((h, w)) < 0.002] = np.nan
    unc = rg.uniform(0.1, 0.4, (h, w)).astype(np.float32)
    return depth, unc


def seeded_model(torch, np, in_channels=7):
    """Full-width default-config model (GAT, hidden 64, 4 layers, 4 heads,
    8-conn, edge_dim 3) with random weights and BatchNorm statistics."""
    from bathymetric_gnn_tpu_torch.models.grid_gat import GridBathymetricGNN

    g = torch.Generator().manual_seed(SEED)
    model = GridBathymetricGNN(in_channels, 64, MODEL_LAYERS, 4, generator=g)
    return random_bn_stats(torch, np, model, SEED).eval()


def random_bn_stats(torch, np, model, seed):
    """``model`` with random BatchNorm running statistics from ``seed``
    (means N(0, 0.2), variances U(0.5, 2))."""
    rg = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.from_numpy(
                    rg.normal(0, 0.2, buf.shape).astype(np.float32)))
            elif name.endswith(".var"):
                buf.copy_(torch.from_numpy(
                    rg.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    return model


# -- phase 2 ---------------------------------------------------------------------

def layer_cases(torch, np, model, dev, n=None, tile=TILE, ragged=RAGGED):
    """(label, args, kwargs, dims) for the main path's layer shapes (the
    first ``n`` of them; at a ``tile`` x ``tile`` tile and a ``tile`` x
    ``ragged`` edge tile)."""
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    cases = []
    layers = [(0, "layer0 64->256 h4 BN+ReLU", True),
              (1, "mid 256->256 h4 BN+ReLU", True),
              (MODEL_LAYERS - 1, "last 256->64 h1 BN", False)]
    for (hgt, wid) in ((tile, tile), (tile, ragged)):
        for li, label, relu in layers:
            for dtype in ("float32", "bfloat16"):
                cases.append((li, label, relu, dtype, hgt, wid, 8))
    cases.append((1, "mid 256->256 h4 BN+ReLU", True, "float32", tile, tile,
                  4))
    cases = cases[:n]
    depth, _ = synthetic_survey(np, tile, tile, SEED + 1)
    inputs = {}   # each tile shape is featurized on its own, as a tile is
    for conn, wid in dict.fromkeys((c[6], c[5]) for c in cases):
        d = depth[:, :wid]
        inputs[conn, wid] = build_grid_inputs(
            torch.from_numpy(np.nan_to_num(d))[None].to(dev),
            torch.from_numpy(np.isfinite(d))[None].to(dev),
            connectivity=conn)
    g = torch.Generator().manual_seed(SEED + 2)
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


SLAB = 56                # the default VR route's slab frame (JAX's slab_size)
SLAB_B = 128             # refinements in phase 2's slab shape


def slab_grids(np, n, seed):
    """``n`` refinement-like grids for the slab: sides 3..50, ~5 % NODATA
    (1e6), resolution 0.5-4 m (make_refinements' grids)."""
    return [(d, np.abs(d) < 1e5, u, r)
            for d, u, r in make_refinements(np, n, seed)]


def slab_layer_cases(torch, np, model, dev):
    """Kernel A's inference form at the default VR route's slab shape:
    [SLAB_B, SLAB, SLAB] of refinement grids (their valid masks, the
    slab's neighbour masks and edge attributes from build_slab_grid_inputs)
    at the model's three layer widths, f32 and bf16."""
    from bathymetric_gnn_tpu_torch.data.slab_build import (
        build_slab_grid_inputs, pack_slab)
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    depth, _, unc, hs, ws, res = pack_slab(
        slab_grids(np, SLAB_B, SEED + 3), SLAB, SLAB_B, True,
        implicit_valid=True)
    t = [torch.from_numpy(a).to(dev) for a in (depth, unc, hs, ws, res)]
    _, v, nbr, ea, _ = build_slab_grid_inputs(
        t[0], None, t[1], *t[2:], connectivity=8, with_uncertainty=True)
    g = torch.Generator().manual_seed(SEED + 4)
    out = []
    for li, label, relu in ((0, "slab layer0 64->256 h4 BN+ReLU", True),
                            (1, "slab mid 256->256 h4 BN+ReLU", True),
                            (MODEL_LAYERS - 1, "slab last 256->64 h1 BN",
                             False)):
        conv = getattr(model, f"GridGATConv_{li}")
        norm = getattr(model, f"MaskedBatchNorm_{li}")
        f_in = conv.lin_src.shape[0]
        x = torch.randn(SLAB_B, SLAB, SLAB, f_in, generator=g).to(dev) \
            * v[..., None]
        params = {n: p.detach().clone()
                  for n, p in conv.named_parameters(recurse=False)}
        w_lin, a_s, a_d, m_e, bias = gf.gat_param_matrices(
            params, conv.heads, conv.out_channels, 3)
        sc, sh = (t_.detach().clone() for t_ in norm.affine())
        args = (x, w_lin, a_s, a_d, m_e, ea, nbr.float(), v.float(), bias, 8,
                0.2, True)
        for dtype in ("float32", "bfloat16"):
            kw = dict(bn_scale=sc, bn_bias=sh, fuse_relu=relu,
                      compute_dtype=getattr(torch, dtype))
            dims = dict(b=SLAB_B, h=SLAB, w=SLAB, f=f_in, hc=w_lin.shape[1],
                        heads=conv.heads, k=8, dtype=dtype,
                        valid=int(v.sum().item()))
            out.append((f"{label} {dtype} {SLAB_B}x{SLAB}x{SLAB} conn8",
                        args, kw, dims))
    return out


def phase_kernel_vs_plain(torch, cases):
    """Kernel A (``fused_grid_gat_infer``'s two steps: ``kernel_args``, the
    setup, then ``call_kernel``) against its plain version, each step
    synchronized, so that a CUDA error names the step it surfaced in."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    worst = {}
    with torch.no_grad():
        for label, args, kw, dims in cases:
            step = "inputs"
            try:
                torch.cuda.synchronize()
                step = "setup (kernel_args)"
                kargs = gf.kernel_args(*args, **kw)
                torch.cuda.synchronize()
                step = "kernel A"
                out = gf.call_kernel(**kargs)
                torch.cuda.synchronize()
                step = "plain version"
                ref = gf.grid_gat_reference(*args, **kw)
                torch.cuda.synchronize()
            except RuntimeError as e:
                log(f"[2] {label}: failed in the {step}: "
                    f"{str(e).splitlines()[0]}")
                raise
            del kargs
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


# -- phase 2a --------------------------------------------------------------------

GUARD_REPEATS = 50     # phase 2a: launches of each phase-2 case, bit for bit
# Shapes phases 2 and 2b miss, (B, H, W, F, heads, C, connectivity): F not
# a multiple of the 16-byte vector (7, 13), HC not a multiple of 4 (6, 5,
# 1), C not a multiple of 4 (3, 5, 2, 6), H and W below one 14 x 14 block,
# heads 1, 2 and 8.
GUARD_SHAPES = [
    (2, 37, 53, 7, 2, 3, 8),
    (1, 29, 31, 13, 1, 5, 4),
    (3, 5, 9, 13, 8, 2, 8),
    (1, 13, 11, 7, 2, 6, 4),
    (2, 17, 15, 40, 8, 8, 8),
    (1, 1, 1, 7, 1, 1, 8),
]


def guard_cases(torch, np, dev):
    """Kernel A's inference cases at GUARD_SHAPES (BatchNorm + ReLU
    epilogue), and the training cases (label, args, dims) of the same
    shapes, from seeded random layers and surveys."""
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
    from bathymetric_gnn_tpu_torch.models.grid_gat import GridGATConv
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    g = torch.Generator().manual_seed(SEED + 7)
    infer, train = [], []
    for b, h, w, f_in, heads, c, conn in GUARD_SHAPES:
        depth = 30 + torch.randn(b, h, w, generator=g).cumsum(1) * 0.05
        valid = torch.rand(b, h, w, generator=g) > 0.05
        _, v, nbr, ea, _ = build_grid_inputs(depth.to(dev), valid.to(dev),
                                             connectivity=conn)
        conv = GridGATConv(f_in, c, heads=heads, concat=heads > 1,
                           connectivity=conn, generator=g)
        params = {n: p.detach() for n, p in conv.named_parameters()}
        w_lin, a_s, a_d, m_e, bias = (
            t.to(dev) for t in gf.gat_param_matrices(params, heads, c, 3))
        x = torch.randn(b, h, w, f_in, generator=g).to(dev) * v[..., None]
        sc = (torch.rand(heads * c, generator=g) + 0.5).to(dev)
        sh = (torch.randn(heads * c, generator=g) * 0.1).to(dev)
        args = (x, w_lin, a_s, a_d, m_e, ea, nbr.float(), v.float(), bias,
                conn, 0.2, True)
        dims = dict(b=b, h=h, w=w, f=f_in, hc=heads * c, heads=heads, k=conn,
                    ed=3)
        shape = f"{b}x{h}x{w} F{f_in} h{heads} HC{heads * c} conn{conn}"
        for dtype in ("float32", "bfloat16"):
            infer.append((f"odd {shape} {dtype}", args,
                          dict(bn_scale=sc, bn_bias=sh, fuse_relu=True,
                               compute_dtype=getattr(torch, dtype)),
                          dict(dims, dtype=dtype)))
            train.append((f"odd {shape} {dtype}", args,
                          dict(dims, dtype=dtype)))
    return infer, train


def same_bits(torch, a, b):
    """a and b hold the same bits (torch.equal takes -0 == 0 and NaN !=
    NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    it = ints[a.element_size()]
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def rel_err(torch, out, ref):
    d = (out.float() - ref.float()).abs()
    return (d / (1 + ref.float().abs())).max().item()


def guard_infer(torch, label, args, kw, dims, tag):
    """Kernel A's inference form on guard-page copies of its inputs, its
    output guard-placed too, at the end and at the start of the mapping:
    no CUDA error, bit for bit the ordinary call, within TOL of the plain
    version. Returns the number of guarded launches."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.ops.cuda import guard

    dt = dims["dtype"]
    with torch.no_grad():
        kargs = gf.kernel_args(*args, **kw)
        base = gf.call_kernel(**kargs)
        ref = gf.grid_gat_reference(*args, **kw)
        torch.cuda.synchronize()
        for at in guard.LAYOUTS:
            log(f"[{tag}] start A {label} flush {at}")
            out = guard.guarded_call(gf.call_kernel, kargs, at)
            rel = rel_err(torch, out, ref)
            ok = (same_bits(torch, out, base) and rel <= TOL[dt]
                  and bool(torch.isfinite(out.float()).all()))
            log(f"[{tag}] A {label} flush {at}: bit for bit the ordinary "
                f"call {same_bits(torch, out, base)}, max_rel(1+|ref|) "
                f"{rel:.3e} tol {TOL[dt]:.1e} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel A under guard pages ({at}): {label}")
    return len(guard.LAYOUTS)


def guard_train(torch, label, args, dims, tag, drop, with_b=True):
    """Kernel A's training form and kernel B on guard-page copies of their
    inputs, their outputs (and B's dxh / d_ad scratch) guard-placed, at
    the end and at the start: no CUDA error, bit for bit the ordinary
    calls, within TOL / GRAD_TOL of the plain forward and autograd of it.
    ``drop``: "mask" (a streamed dropout mask) or "philox" (the in-kernel
    draw). Returns the number of guarded launches."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.ops.cuda import guard

    dt = dims["dtype"]
    cdt = getattr(torch, dt)
    x, w_lin, a_s, a_d, m_e, ea, nbr, v, bias, conn, slope, use_edge = args
    seed = torch.tensor([0x5EED0000C0FFEE], dtype=torch.int64,
                        device=x.device)
    if drop == "philox":
        mask = gf.drop_mask(seed, KEEP, dims["b"], dims["k"], dims["heads"],
                            dims["h"], dims["w"])
        dkw = dict(drop_seed=seed, keep_prob=KEEP)
    else:
        mask = case_dmask(torch, args, dims, SEED + 20)
        dkw = dict(dmask=mask)
    ref, rgrads, g = train_run(torch, gf.grid_gat_reference, args, dt,
                               dmask=mask)
    with torch.no_grad():
        kargs = gf.kernel_args(*args, bn_scale=None, bn_bias=None,
                               fuse_relu=False, compute_dtype=cdt, train=True,
                               **dkw)
        eattr, mattr = gf.edge_attr_terms(ea, nbr, use_edge, cdt)
        bkw = {k: kargs[k] for k in (
            "x", "w", "wa", "el", "el_self", "valid", "heads",
            "connectivity", "negative_slope", "drop_mode", "dmask", "seed",
            "thresh", "keep_inv")}
        bkw.update(g=g.to(cdt).contiguous(), eattr=eattr, mattr=mattr)
        base = gf.call_kernel(**kargs)
        base_b = gf.call_bwd_kernel(**bkw) if with_b else ()
        torch.cuda.synchronize()
        for at in guard.LAYOUTS:
            log(f"[{tag}] start A (train, {drop}) {label} flush {at}")
            out = guard.guarded_call(gf.call_kernel, kargs, at)
            rel = rel_err(torch, out, ref)
            ok = (same_bits(torch, out, base) and rel <= TOL[dt]
                  and bool(torch.isfinite(out.float()).all()))
            msg = (f"A bit for bit {same_bits(torch, out, base)}, "
                   f"max_rel(1+|ref|) {rel:.3e}")
            if with_b:
                log(f"[{tag}] start B ({drop}) {label} flush {at}")
                parts = guard.guarded_call(gf.call_bwd_kernel, bkw, at)
                bits = all(same_bits(torch, p, q)
                           for p, q in zip(parts, base_b))
                grads = gf.bwd_gradients(*parts, w_lin, a_s, a_d)
                worst = 0.0
                for a, r in zip(grads, rgrads):
                    scale = r.float().abs().max().item() + 1e-12
                    e = (a.float() - r.float()).abs().max().item() / scale
                    worst = max(worst, e)
                    ok = ok and bool(torch.isfinite(a.float()).all())
                ok = ok and bits and worst <= GRAD_TOL[dt]
                msg += (f"; B bit for bit {bits}, worst err/scale "
                        f"{worst:.2e} (tol {GRAD_TOL[dt]:.1e})")
            log(f"[{tag}] A{'+B' if with_b else ''} (train, {drop}) {label} "
                f"flush {at}: {msg} {'ok' if ok else 'FAIL'}")
            check(ok, f"training kernels under guard pages ({at}, {drop}): "
                      f"{label}")
    return len(guard.LAYOUTS) * (2 if with_b else 1)


def repeat_bits(torch, cases, n, tag):
    """Each case's kernel A launched n more times on the same prepared
    inputs, each launch synchronized (a CUDA error raises there) and
    bit for bit the first launch (the kernel is deterministic: a race on
    shared memory shows here as differing bits even when it does not
    fault). Returns the number of launches."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    with torch.no_grad():
        for label, args, kw, dims in cases:
            kargs = gf.kernel_args(*args, **kw)
            first = gf.call_kernel(**kargs)
            torch.cuda.synchronize()
            for i in range(n):
                out = gf.call_kernel(**kargs)
                torch.cuda.synchronize()
                check(same_bits(torch, out, first),
                      f"kernel A launch {i + 2} differs from the first: "
                      f"{label}")
                del out
            log(f"[{tag}] {label}: {n} more launches, each bit for bit the "
                f"first")
            del kargs, first
    return len(cases) * (n + 1)


def phase_guard_and_repeat(torch, np, cases, tcases, dev, repeats=GUARD_REPEATS,
                           train_dtypes=("float32",), tag="2a"):
    """Phase 2a: the guard's self-check (a kernel's read just outside a
    guard-placed tensor faults, in a child process a layout); kernel A at
    every phase-2 case and at GUARD_SHAPES under guard pages (inference
    form; the training form with kernel B at phase 2b's cases of
    ``train_dtypes`` and at GUARD_SHAPES, streamed mask and Philox), flush
    at the end and at the start; then ``repeats`` launches of each phase-2
    case, bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    from bathymetric_gnn_tpu_torch.ops.cuda import guard

    t0 = time.perf_counter()
    # the guard itself: a kernel's 8-byte read just outside a guard-placed
    # tensor faults, each in a process of its own (a fault ends the CUDA
    # context)
    with ThreadPoolExecutor(len(guard.LAYOUTS)) as ex:
        probes = dict(zip(guard.LAYOUTS, ex.map(guard.faults,
                                                 guard.LAYOUTS)))
    for at, (hit, line) in probes.items():
        log(f"[{tag}] guard self-check, a read just outside a tensor flush "
            f"at the {at}: {'faulted' if hit else 'DID NOT FAULT'}: {line}")
        check(hit, f"a read just outside a guard-placed tensor ({at}) did "
                   f"not fault: {line}")
    oinfer, otrain = guard_cases(torch, np, dev)
    n_guard = 0
    for label, args, kw, dims in cases + oinfer:
        n_guard += guard_infer(torch, label, args, kw, dims, tag)
    for label, args, dims in tcases + otrain:
        if dims["dtype"] not in train_dtypes and not label.startswith("odd"):
            continue
        for drop in ("mask", "philox"):
            n_guard += guard_train(torch, label, args, dims, tag, drop)
    t_guard = time.perf_counter() - t0
    n_rep = repeat_bits(torch, cases, repeats, tag) if repeats else 0
    secs = time.perf_counter() - t0
    log(f"[{tag}] {n_guard} guarded launches in {t_guard:.3f} s, {n_rep} "
        f"repeated launches; phase 2a took {secs:.3f} s")
    return dict(guarded_launches=n_guard, repeats_per_case=repeats,
                repeated_launches=n_rep, seconds=secs)


# -- phase 2b --------------------------------------------------------------------

def train_cases(torch, np, dev):
    """(label, args, dims) for the training model's three layer shapes on
    a batch of TRAIN_BATCH tiles of TRAIN_TILE^2, f32 and bf16, plus the
    mid layer on ragged 250x200 tiles and in 4-connectivity."""
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
    from bathymetric_gnn_tpu_torch.models.grid_batched import BatchedGridGNN
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    # the training model at the default config's full width, random
    # weights from SEED
    model = BatchedGridGNN(7, 64, MODEL_LAYERS, 4,
                           generator=torch.Generator().manual_seed(SEED)
                           ).to(dev)
    t = TRAIN_TILE
    depth, _ = synthetic_survey(np, 2 * t, 2 * t, SEED + 4)
    tiles = np.stack([depth[r:r + t, c:c + t] for r in (0, t)
                      for c in (0, t)])
    inputs = {}
    for conn, hgt, wid in ((8, t, t), (8, 250, 200), (4, t, t)):
        d = tiles[:, :hgt, :wid]
        inputs[conn, hgt, wid] = build_grid_inputs(
            torch.from_numpy(np.nan_to_num(d)).to(dev),
            torch.from_numpy(np.isfinite(d)).to(dev), connectivity=conn)
    layers = [(0, "layer0 64->256 h4"), (1, "mid 256->256 h4"),
              (MODEL_LAYERS - 1, "last 256->64 h1")]
    cases = [(li, label, dt, t, t, 8) for li, label in layers
             for dt in ("float32", "bfloat16")]
    cases += [(1, layers[1][1], "float32", 250, 200, 8),
              (1, layers[1][1], "float32", t, t, 4)]
    g = torch.Generator().manual_seed(SEED + 5)
    out = []
    for li, label, dtype, hgt, wid, conn in cases:
        conv = getattr(model, f"GridGATConv_{li}")
        _, v, nbr, ea, _ = inputs[conn, hgt, wid]
        f_in = conv.lin_src.shape[0]
        x = torch.randn(TRAIN_BATCH, hgt, wid, f_in, generator=g).to(dev) \
            * v[..., None]
        params = {n: p.detach().clone()
                  for n, p in conv.named_parameters(recurse=False)}
        w_lin, a_s, a_d, m_e, bias = gf.gat_param_matrices(
            params, conv.heads, conv.out_channels, 3)
        bias = bias + 0.1 * torch.randn(bias.shape, generator=g).to(dev)
        args = (x, w_lin, a_s, a_d, m_e, ea, nbr.float(), v.float(), bias,
                conn, 0.2, True)
        dims = dict(b=TRAIN_BATCH, h=hgt, w=wid, f=f_in, hc=w_lin.shape[1],
                    heads=conv.heads, k=conn, ed=3, dtype=dtype)
        out.append((f"{label} {dtype} {TRAIN_BATCH}x{hgt}x{wid} conn{conn}",
                    args, dims))
    return out


def train_run(torch, fn, args, dtype, g=None, **kw):
    """fn(*args) and the gradients of <out, g> with respect to x, W,
    a_src, a_dst, M_edge and bias; g is drawn when not given."""
    leaves = [t.detach().clone().requires_grad_() for t in
              (args[0], args[1], args[2], args[3], args[4], args[8])]
    x, wl, a_s, a_d, me, bias = leaves
    out = fn(x, wl, a_s, a_d, me, args[5], args[6], args[7], bias,
             *args[9:], compute_dtype=getattr(torch, dtype), **kw)
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator(
            ).manual_seed(SEED + 6)).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads, g


def case_dmask(torch, args, dims, seed):
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    shape = (dims["b"], dims["k"] + 1, dims["heads"], dims["h"], dims["w"])
    return (torch.rand(shape, generator=gen, device=args[0].device)
            < KEEP).float() / KEEP


def phase_train_kernels_vs_plain(torch, cases):
    """Kernel A (training form, streamed mask) and kernel B vs the plain
    forward and autograd of it, then the Philox draw."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    errs = {}
    for i, (label, args, dims) in enumerate(cases):
        dt = dims["dtype"]
        dmask = case_dmask(torch, args, dims, SEED + 10 + i)
        out, grads, g = train_run(torch, gf.fused_grid_gat, args, dt,
                                  dmask=dmask)
        torch.cuda.synchronize()
        ref, rgrads, _ = train_run(torch, gf.grid_gat_reference, args, dt,
                                   g, dmask=dmask)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        rel = (d / (1 + ref.float().abs())).max().item()
        ok = rel <= TOL[dt] and bool(torch.isfinite(out.float()).all())
        gerr, parts = {}, []
        for name, a, r in zip(LEAVES, grads, rgrads):
            scale = r.float().abs().max().item() + 1e-12
            e = (a.float() - r.float()).abs().max().item()
            gerr[name] = e
            parts.append(f"{name} {e / scale:.2e}")
            ok = ok and e <= GRAD_TOL[dt] * scale and bool(
                torch.isfinite(a.float()).all())
        log(f"[2b] {label}: A max_rel(1+|ref|) {rel:.3e} (tol "
            f"{TOL[dt]:.1e}); B err/scale: {', '.join(parts)} (tol "
            f"{GRAD_TOL[dt]:.1e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"training kernels disagree with the plain version: "
                  f"{label}")
        errs[label] = (d.max().item(), gerr)
        del out, grads, ref, rgrads, dmask

    label, args, dims = next(c for c in cases if c[0].startswith("mid")
                             and c[2]["dtype"] == "float32"
                             and c[2]["w"] == TRAIN_TILE and c[2]["k"] == 8)
    seed = torch.tensor([0x5EED0000C0FFEE], dtype=torch.int64,
                        device=args[0].device)
    mask = gf.drop_mask(seed, KEEP, dims["b"], dims["k"], dims["heads"],
                        dims["h"], dims["w"])
    rate = (mask == 0).float().mean().item()
    inv = torch.tensor(1.0 / KEEP, dtype=torch.float32, device=mask.device)
    check(bool(((mask == 0) | (mask == inv)).all()), "mask values")
    out_s, gr_s, g = train_run(torch, gf.fused_grid_gat, args, "float32",
                               drop_seed=seed, keep_prob=KEEP)
    out_m, gr_m, _ = train_run(torch, gf.fused_grid_gat, args, "float32", g,
                               dmask=mask)
    same = torch.equal(out_s, out_m) and all(
        torch.equal(a, b) for a, b in zip(gr_s, gr_m))
    log(f"[2b] Philox draw on {label}: realized drop rate {rate:.6f} over "
        f"{mask.numel()} draws (want {1 - KEEP:.1f} +- 0.002); A and B with "
        f"the in-kernel draw {'equal' if same else 'DIFFER FROM'} A and B "
        f"given it as a streamed mask")
    check(abs(rate - (1 - KEEP)) <= 0.002, f"drop rate {rate}")
    check(same, "in-kernel draw and streamed mask disagree")
    return errs


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
                ckpt=ckpt, depth=depth, argv=argv,
                cells_corrected=stats["cells_corrected"])


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
                               gf.grid_gat_reference):
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


# -- phase 3b --------------------------------------------------------------------

def plain_layer(gf):
    """fused_grid_gat with every GAT layer on its plain version."""
    def plain(*args, dmask=None, drop_seed=None, keep_prob=1.0, **kw):
        check(drop_seed is None, "plain layer given an in-kernel seed")
        return gf.grid_gat_reference(*args, dmask=dmask, **kw)
    return plain


def phase_train_end_to_end(torch, np, work):
    """cli.train --trainer grid on a synthetic clean survey, launch counts
    read around the f32 run; then the same run in bf16, and cli.inference
    serving the f32 run's checkpoint."""
    import json
    import shutil

    from bathymetric_gnn_tpu_torch.cli import inference as icli
    from bathymetric_gnn_tpu_torch.cli import train as tcli
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.data.tiling import TileManager
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff, write_geotiff
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    clean, _ = synthetic_survey(np, TRAIN_SURVEY, TRAIN_SURVEY, SEED + 7,
                                spikes=False)
    data = work / "train_data"
    data.mkdir(parents=True, exist_ok=True)
    write_geotiff(data / "clean.tif", clean[None], pixel_scale=(2.0, 2.0),
                  origin=(500000.0, 4000000.0), nodata=float("nan"))
    tm = TileManager(TRAIN_TILE, 32, 0.3)
    n_tiles = sum(1 for t in tm.iterate_tiles(clean)
                  if t.shape == (TRAIN_TILE, TRAIN_TILE))
    batches = n_tiles // TRAIN_BATCH
    check(batches >= 2, f"{n_tiles} tiles: fewer than 2 batches")

    def argv(run, *extra):
        shutil.rmtree(run, ignore_errors=True)
        return ["--trainer", "grid", "--data-dir", str(data),
                "--output-dir", str(run), "--epochs", str(TRAIN_EPOCHS),
                "--batch-size", str(TRAIN_BATCH), "--tile-size",
                str(TRAIN_TILE), "--overlap", "32", "--seed", str(SEED),
                *extra]

    def check_run(run, state, tag):
        hist = json.loads((run / "history.json").read_text())
        losses = hist["train_loss"] + hist["val_loss"]
        check(len(hist["train_loss"]) == TRAIN_EPOCHS
              and all(np.isfinite(losses)), f"{tag} losses {hist}")
        missing = [n for n, p in state.model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        check(not missing, f"{tag}: no finite gradient for {missing}")
        for name in ("best", "last", "final"):
            check((run / name / "model.pt").exists()
                  and (run / name / "train_state.pt").exists(),
                  f"{tag}: checkpoint {name} missing")
        return hist

    run = work / "train_run"
    a = argv(run)
    gf.launches = gf.train_launches = gf.bwd_launches = 0
    t0 = time.perf_counter()
    state = tcli.main(a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fwd_infer=gf.launches, fwd_train=gf.train_launches,
                  bwd=gf.bwd_launches)
    steps = state.step
    hist = check_run(run, state, "f32")
    check(steps == TRAIN_EPOCHS * batches, f"steps {steps}")
    check(counts["fwd_train"] == MODEL_LAYERS * steps
          and counts["bwd"] == MODEL_LAYERS * steps,
          f"training launches {counts} != {MODEL_LAYERS} x {steps} steps")
    check(counts["fwd_infer"] == MODEL_LAYERS * TRAIN_EPOCHS * batches,
          f"eval launches {counts['fwd_infer']} != {MODEL_LAYERS} layers x "
          f"{TRAIN_EPOCHS * batches} eval batches")
    log(f"[3b] cli.train --trainer grid, f32, {n_tiles} tiles of "
        f"{TRAIN_TILE}^2, {TRAIN_EPOCHS} epochs x {batches} batches of "
        f"{TRAIN_BATCH}: {steps} steps in {wall:.3f} s (with set-up and "
        f"eval); launches: kernel A training {counts['fwd_train']}, kernel "
        f"B {counts['bwd']} (= {MODEL_LAYERS} x {steps}), kernel A "
        f"inference {counts['fwd_infer']} (eval); train loss "
        f"{hist['train_loss']}, val loss {hist['val_loss']}; every "
        f"parameter has a finite gradient")

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg_path = work / "bf16.yaml"
    cfg.save(cfg_path)
    run16 = work / "train_run_bf16"
    state16 = tcli.main(argv(run16, "--config", str(cfg_path)))
    torch.cuda.synchronize()
    hist16 = check_run(run16, state16, "bf16")
    log(f"[3b] the same run in bf16: train loss {hist16['train_loss']}, val "
        f"loss {hist16['val_loss']}")

    out = work / "train_served.tif"
    n0 = gf.launches
    stats = icli.main(["--input", str(data / "clean.tif"), "--output",
                       str(out), "--model", str(run / "final"),
                       "--tile-size", str(TRAIN_TILE), "--overlap", "32"])
    torch.cuda.synchronize()
    # bands: depth, classification, confidence, correction, valid (the
    # survey has no uncertainty band)
    bands, _ = read_geotiff(out)
    valid = np.isfinite(clean)
    classes = set(np.unique(bands[1][valid]).tolist())
    calls = stats["tiles_processed"] // 8 + stats["tiles_processed"] % 8
    check(stats["tiles_processed"] == n_tiles, f"served {stats}")
    check(gf.launches - n0 == MODEL_LAYERS * calls, "serve launches")
    check(bands.shape[0] == 5
          and all(np.isfinite(bands[i][valid]).all() for i in range(5))
          and classes <= {0.0, 1.0, 2.0}
          and 0.0 <= bands[2][valid].min() <= bands[2][valid].max() <= 1.0,
          "served outputs")
    log(f"[3b] cli.inference served {run / 'final'}: {n_tiles} tiles, "
        f"classes {sorted(classes)}, mean_confidence "
        f"{stats['mean_confidence']:.4f}")
    return dict(counts=counts, steps=steps, wall=wall, data=data)


def phase_train_step_kernel_vs_plain(torch, np, work, data):
    """One training step (dropout 0, full width, one batch of the training
    data) through kernels A and B vs the same step with every GAT layer on
    its plain version, both on the card: gradients of every parameter
    within 1e-3 of the leaf's largest |entry| (the conv biases, whose true
    gradient under a batch-stats BatchNorm is ~0: within 1e-3 of the
    largest gradient of all)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    trainer, state, batch = step_setup(torch, np, work, data, "float32",
                                       dropout=0.0)
    model = state.model
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def grads():
        model.load_state_dict(snapshot)
        for p in model.parameters():
            p.grad = None
        losses, _ = trainer.loss_fn(model, batch, train=True)
        losses["total"].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    gk = grads()
    with mock.patch.object(gf, "fused_grid_gat", plain_layer(gf)):
        gp = grads()
    big = max(r.abs().max().item() for r in gp.values())
    worst = 0.0
    for name, r in gp.items():
        scale = (big if "GridGATConv" in name and name.endswith(".bias")
                 else r.abs().max().item() + 1e-12)
        e = (gk[name] - r).abs().max().item() / scale
        worst = max(worst, e)
        check(e <= 1e-3, f"step gradient {name}: {e:.3e} of scale")
    log(f"[3b] one train step, kernels vs plain on the card (dropout 0): "
        f"{len(gp)} parameter gradients agree, worst {worst:.3e} of scale "
        f"(tol 1e-3)")


def step_setup(torch, np, work, data, dtype, dropout=1.0 - KEEP):
    """A GridTrainer on the training survey (full width, ``dtype``), its
    initial state and one batch of TRAIN_BATCH tiles."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff
    from bathymetric_gnn_tpu_torch.training.grid_trainer import (
        GridTrainer, SyntheticGridDataset, collate_grids)

    cfg = Config()
    cfg.model.compute_dtype = dtype
    cfg.model.dropout = dropout
    cfg.training.class_weights = (1.0, 1.0, 1.0)
    bands, _ = read_geotiff(data / "clean.tif")
    ds = SyntheticGridDataset([bands[0]], cfg, tile_size=TRAIN_TILE,
                              overlap=32, seed=SEED)
    trainer = GridTrainer(cfg, ds, output_dir=str(work / "step_check"))
    state = trainer.init_state()
    batch = collate_grids([ds[i] for i in range(TRAIN_BATCH)])
    return trainer, state, batch


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


def split_bound(nbytes, mma_flops, other_flops, dtype):
    """(ms, "bytes" | "operations", old ms): the larger of bytes over HBM
    bandwidth and the operations' time, products at MMA_FLOPS[dtype] plus
    the other operations at the FP32 rate; the old ms counts every
    operation at PEAK_FLOPS[dtype] (the bound before the kernels ran their
    products on the tensor cores)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (mma_flops / MMA_FLOPS[dtype]
             + other_flops / PEAK_FLOPS["float32"]) * 1e3
    old = max(t_bytes, (mma_flops + other_flops) / PEAK_FLOPS[dtype] * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", old)


def bound(dims):
    """Least time for one call: the kernel's inputs read once and its
    output written once over HBM bandwidth, vs its operations: the x@W and
    attention-dot products at the tensor-core rate of the input type
    (``MMA_FLOPS``) plus the 9-way weighted sum at the FP32 rate. Returns
    (ms, bound by, bytes, flops, old ms with every operation at
    ``PEAK_FLOPS``)."""
    n = dims.get("b", 1) * dims["h"] * dims["w"]
    f, hc, heads, k = dims["f"], dims["hc"], dims["heads"], dims["k"]
    s = 4 if dims["dtype"] == "float32" else 2
    nbytes = (s * (n * f + f * hc + f * 2 * heads + (k + 1) * heads * n
                   + n * hc) + 4 * n + 12 * hc)
    mma = 2 * n * f * hc + 2 * n * f * 2 * heads
    other = 2 * (k + 1) * n * hc
    ms, by, old = split_bound(nbytes, mma, other, dims["dtype"])
    return ms, by, nbytes, mma + other, old


def cublas_xw_ms(torch, n, f, hc, dtype, dev):
    """Info only (the port never calls it): one torch.matmul of the layer's
    [n, f] x [f, hc] product on the card, f32 with allow_tf32 False (full
    f32) or bf16, seeded inputs."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    dt = getattr(torch, dtype)
    a = torch.randn(n, f, generator=g, device=dev).to(dt)
    b = torch.randn(f, hc, generator=g, device=dev).to(dt)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(torch, lambda: torch.matmul(a, b), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
                torch, lambda: gf.grid_gat_reference(*args, **kw), 3,
                warmup=1)
            b_ms, b_by, nbytes, flops, b_old = bound(dims)
            mm_ms = cublas_xw_ms(torch, dims["h"] * dims["w"], dims["f"],
                                 dims["hc"], dims["dtype"], dev=args[0].device)
            rows.append(dict(shape=label, ms=ms, wrapper_ms=wrap_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             bound_old_ms=b_old, bytes=nbytes, flops=flops,
                             cublas_xw_ms=mm_ms))
            log(f"[4] {label}: kernel {ms:.3f} ms (wrapper incl. edge "
                f"precompute {wrap_ms:.3f} ms), plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.3f} ms by {b_by} (old, all operations at "
                f"the FP32 or bf16 peak: {b_old:.3f}; {nbytes / 1e9:.3f} GB, "
                f"{flops / 1e9:.1f} GFLOP), {b_ms / ms:.3f} of bound")
            log(f"[4]   info: torch.matmul of the x@W product "
                f"[{dims['h'] * dims['w']}, {dims['f']}] x [{dims['f']}, "
                f"{dims['hc']}] in {dims['dtype']} (allow_tf32 False): "
                f"{mm_ms:.3f} ms")
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


def phase_slab_timings(torch, np, scases, dvr):
    """Kernel A at phase 2's slab shape ([SLAB_B, SLAB, SLAB], the three
    layer widths, f32 and bf16) beside its bound (every cell of the slab:
    the layer's function is dense over it) and its plain version; and one
    slab chunk of 3g's flush (featurization on the card and the grid
    model's forward) at each precision."""
    from bathymetric_gnn_tpu_torch.data.slab_build import (
        build_slab_grid_inputs, pack_slab)
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    rows = []
    with torch.no_grad():
        for label, args, kw, dims in scases:
            kargs = gf.kernel_args(*args, **kw)
            ms = cuda_ms(torch, lambda: gf.call_kernel(**kargs), 10)
            plain_ms = cuda_ms(
                torch, lambda: gf.grid_gat_reference(*args, **kw), 3,
                warmup=1)
            b_ms, b_by, nbytes, flops, _ = bound(dims)
            cells = dims["b"] * dims["h"] * dims["w"]
            rows.append(dict(shape=label, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                             flops=flops, valid_share=dims["valid"] / cells))
            log(f"[4] {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.3f} GB, "
                f"{flops / 1e9:.1f} GFLOP; {dims['valid'] / cells:.3f} of "
                f"the slab's cells valid), {b_ms / ms:.3f} of bound")
            del kargs
        flush = dvr["flush"]
        depth, _, unc, hs, ws, res = pack_slab(
            [(d, np.abs(d) < 1e5, u, r) for d, u, r in flush], SLAB,
            len(flush), True, implicit_valid=True)
        dev = scases[0][1][0].device
        t = [torch.from_numpy(a).to(dev) for a in (depth, unc, hs, ws, res)]
        fwd = {}
        for name, proc in dvr["procs"].items():
            def fwd_once(model=proc.grid_model):
                f, v, nb, ea, _ = build_slab_grid_inputs(
                    t[0], None, t[1], *t[2:], connectivity=8,
                    with_uncertainty=True)
                return model(f, v, nb, ea)
            fwd[name] = cuda_ms(torch, fwd_once, 5, warmup=2)
            log(f"[4] one slab chunk ({len(flush)} refinements, "
                f"[{len(flush)}, {SLAB}, {SLAB}]), featurization + grid "
                f"model forward, {name}: {fwd[name]:.3f} ms")
    return rows, fwd


def train_bounds(dims):
    """Least time of kernel A's training form and of kernel B for one call
    (the larger of bytes / 3.35 TB/s and the operations' time: products at
    ``MMA_FLOPS``, the rest at the FP32 rate; ``split_bound``). A: as
    ``bound`` without the epilogue (dropout drawn in the kernel: no mask
    bytes). B: x, W, W@a, the edge logit terms, mask, g and the edge
    attributes read once, dx and the summed dW, d(W@a), dM_edge and dbias
    written once; products: the xh and attention-dot recompute, dx, dW and
    d(W@a); other operations: the 9-way dxh and d(weights) sums. Each entry
    is (ms, bound by, bytes, flops, old ms)."""
    n = dims["b"] * dims["h"] * dims["w"]
    f, hc, heads, k, ed = (dims["f"], dims["hc"], dims["heads"], dims["k"],
                           dims["ed"])
    s = 4 if dims["dtype"] == "float32" else 2
    a2 = 2 * heads
    a_bytes = (s * (n * f + f * hc + f * a2 + (k + 1) * heads * n + n * hc)
               + 4 * n + 4 * hc)
    a_mma, a_other = 2 * n * f * hc + 2 * n * f * a2, 2 * (k + 1) * n * hc
    b_bytes = (s * (2 * n * f + f * hc + f * a2 + (k + 1) * heads * n
                    + n * hc + (k + 1) * n * ed)
               + 4 * n + 4 * (f * hc + f * a2 + ed * heads + hc))
    b_mma, b_other = 3 * 2 * n * f * (hc + a2), 4 * (k + 1) * n * hc
    out = {}
    for name, nbytes, mma, other in (("A", a_bytes, a_mma, a_other),
                                     ("B", b_bytes, b_mma, b_other)):
        ms, by, old = split_bound(nbytes, mma, other, dims["dtype"])
        out[name] = (ms, by, nbytes, mma + other, old)
    return out


def phase_train_timings(torch, np, cases, work, data):
    """Kernel A (training form, in-kernel draw) and kernel B per training
    layer shape against their bounds and plain versions (B's plain version:
    autograd's backward of the plain forward, forward not timed); then the
    whole train step (featurize, forward, backward, clip, AdamW) in f32 and
    bf16."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    rows = []
    for i, (label, args, dims) in enumerate(cases):
        if dims["w"] != TRAIN_TILE or dims["k"] != 8:
            continue
        dt = getattr(torch, dims["dtype"])
        seed = torch.tensor([SEED + 20 + i], dtype=torch.int64,
                            device=args[0].device)
        kw = gf.kernel_args(*args, bn_scale=None, bn_bias=None,
                            fuse_relu=False, compute_dtype=dt,
                            drop_seed=seed, keep_prob=KEEP, train=True)
        ea, mattr = gf.edge_attr_terms(args[5], args[6], True, dt)
        g = torch.randn(dims["b"], dims["h"], dims["w"], dims["hc"],
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(args[0].device, dt)
        bkw = {k: kw[k] for k in ("x", "w", "wa", "el", "el_self", "valid",
                                  "heads", "connectivity", "negative_slope",
                                  "drop_mode", "dmask", "seed", "thresh",
                                  "keep_inv")}
        a_ms = cuda_ms(torch, lambda: gf.call_kernel(**kw), 10)
        b_ms = cuda_ms(torch, lambda: gf.call_bwd_kernel(
            g=g, eattr=ea, mattr=mattr, **bkw), 10)
        layer_ms = cuda_ms(torch, lambda: train_run(
            torch, gf.fused_grid_gat, args, dims["dtype"], g,
            drop_seed=seed, keep_prob=KEEP), 5)
        mask = gf.drop_mask(seed, KEEP, dims["b"], dims["k"], dims["heads"],
                            dims["h"], dims["w"])
        with torch.no_grad():
            pa_ms = cuda_ms(torch, lambda: gf.grid_gat_reference(
                *args, dmask=mask, compute_dtype=dt), 3, warmup=1)
        leaves = [t.detach().clone().requires_grad_() for t in
                  (args[0], args[1], args[2], args[3], args[4], args[8])]
        ref = gf.grid_gat_reference(leaves[0], *leaves[1:5], *args[5:8],
                                    leaves[5], *args[9:], dmask=mask,
                                    compute_dtype=dt)
        pb_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref, leaves, g, retain_graph=True), 3, warmup=1)
        bd = train_bounds(dims)
        mm_ms = cublas_xw_ms(torch, dims["b"] * dims["h"] * dims["w"],
                             dims["f"], dims["hc"], dims["dtype"],
                             dev=args[0].device)
        rows.append(dict(shape=label, a_ms=a_ms, b_ms=b_ms,
                         layer_fwd_bwd_ms=layer_ms, a_plain_ms=pa_ms,
                         b_plain_ms=pb_ms, a_bound_ms=bd["A"][0],
                         a_bound_by=bd["A"][1], b_bound_ms=bd["B"][0],
                         b_bound_by=bd["B"][1], a_bytes=bd["A"][2],
                         a_flops=bd["A"][3], b_bytes=bd["B"][2],
                         b_flops=bd["B"][3], a_bound_old_ms=bd["A"][4],
                         b_bound_old_ms=bd["B"][4], cublas_xw_ms=mm_ms))
        log(f"[4b] {label}: kernel A (training) {a_ms:.3f} ms, plain "
            f"{pa_ms:.3f} ms, bound {bd['A'][0]:.3f} ms by {bd['A'][1]} "
            f"({bd['A'][0] / a_ms:.3f} of bound); kernel B {b_ms:.3f} ms, "
            f"plain backward {pb_ms:.3f} ms, bound {bd['B'][0]:.3f} ms by "
            f"{bd['B'][1]} ({bd['B'][2] / 1e9:.3f} GB, "
            f"{bd['B'][3] / 1e9:.1f} GFLOP; {bd['B'][0] / b_ms:.3f} of "
            f"bound); layer fwd + bwd through autograd {layer_ms:.3f} ms; "
            f"old bounds (all operations at the FP32 or bf16 peak) A "
            f"{bd['A'][4]:.3f}, B {bd['B'][4]:.3f} ms")
        log(f"[4b]   info: torch.matmul of the x@W product "
            f"[{dims['b'] * dims['h'] * dims['w']}, {dims['f']}] x "
            f"[{dims['f']}, {dims['hc']}] in {dims['dtype']} (allow_tf32 "
            f"False): {mm_ms:.3f} ms")
        del kw, bkw, ea, mattr, g, mask, ref, leaves

    steps = {}
    for dtype in ("float32", "bfloat16"):
        trainer, state, batch = step_setup(torch, np, work, data, dtype)
        fn = lambda: trainer.train_step(state, batch, 1e-3)  # noqa: E731
        ms = cuda_ms(torch, fn, 5, warmup=2)
        t0 = time.perf_counter()
        for _ in range(5):
            losses, _ = fn()
        float(losses["total"])
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        check(bool(torch.isfinite(losses["total"])), f"{dtype} step loss")
        steps[dtype] = dict(ms=ms, host_ms=host_ms)
        log(f"[4b] train step ({TRAIN_BATCH} x {TRAIN_TILE}^2, full width, "
            f"dropout {1 - KEEP:.1f}, {dtype}): {ms:.3f} ms (CUDA events), "
            f"{host_ms:.3f} ms (host clock, ending in a sync)")
        wall, prows = device_profile(torch, lambda: [fn() for _ in range(3)])
        steps[dtype]["busy_share"] = log_profile(
            "4b", f"3 train steps, {dtype}", wall, prows, top=12)
        mine = sum(r[0] for r in prows if "grid_gat" in r[2])
        log(f"[4b]   kernels A and B: {mine / 3:.3f} ms per step of "
            f"{sum(r[0] for r in prows) / 3:.3f} ms device time")
        del trainer, state, batch
    return rows, steps


def device_profile(torch, fn, cpu=True):
    """fn() under torch.profiler: (wall s, [(device ms, count, kernel)])
    over the device-side events (kernels, copies; the CPU ops that
    launched them would count twice). The profiler slows the host, so the
    idle share it gives is an upper bound. ``cpu=False`` records the
    device's activity only: on a path whose host runs many small torch
    ops (the COO route's per-grid graph builds: ~1,500 a refinement),
    recording them slows the host several times and summing them takes
    about a minute."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    return wall, sorted(rows, reverse=True)


def log_profile(tag, what, wall, rows, top=8):
    if not rows:
        log(f"[{tag}] profiler: no device time recorded; busy share not "
            f"measured")
        return None
    busy = sum(r[0] for r in rows) / 1e3
    log(f"[{tag}] profiled {what}: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({busy / wall:.3f} of wall), {sum(r[1] for r in rows)}"
        f" device events")
    for ms, n, key in rows[:top]:
        log(f"[{tag}]   {ms:10.3f} ms  x{n:<5d} {key[:90]}")
    return busy / wall


def phase_profile(torch, argv):
    """One more CLI run under torch.profiler: device time by kernel and
    the device's busy share of the run's wall time."""
    from bathymetric_gnn_tpu_torch.cli import inference as cli

    wall, rows = device_profile(torch, lambda: cli.main(argv))
    return log_profile("4", "cli run", wall, rows)


# -- phase 2c: kernel C ---------------------------------------------------------

KNN_K = 8
KNN_SURVEY = 256        # 256^2 cells, 5 % holes: ~62k nodes, padded to 65,536
VR_GRIDS = 2000
VR_BIG = 512            # one SR-surface-sized grid: the one-off 2^18 bucket
VR_BUDGET = 50000


def knn_survey(np, n, seed, holes=0.05):
    """An n x n survey (ramp + sinusoid + roughness at ~30 m) with
    ``holes`` of its cells NaN at random; uncertainty 0.1-0.4 m."""
    rg = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    depth = (30.0 + 0.002 * xx + 0.001 * yy + 0.5 * np.sin(xx / 37.0)
             + rg.normal(0, 0.02, (n, n))).astype(np.float32)
    depth[rg.random((n, n)) < holes] = np.nan
    return depth, rg.uniform(0.1, 0.4, (n, n)).astype(np.float32)


def ell_model(torch, dev):
    """The k-NN serving model at full width (GAT, hidden 64, 4 layers,
    4 heads, edge_dim 3, 8 input channels), random weights from SEED."""
    from bathymetric_gnn_tpu_torch.models.gnn_ell import EllBathymetricGNN

    return EllBathymetricGNN(8, 64, MODEL_LAYERS, heads=4,
                             sparse_kernel="banded_pallas",
                             generator=torch.Generator().manual_seed(SEED)
                             ).to(dev).eval()


def knn_graph(torch, np, dev):
    """The k-NN ELL graph (k 8) of a synthetic KNN_SURVEY^2 survey, built
    by the port's GraphBuilder, on the card."""
    from bathymetric_gnn_tpu_torch.config.config import GraphConfig
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

    depth, unc = knn_survey(np, KNN_SURVEY, SEED + 30)
    valid = np.isfinite(depth)
    bg = GraphBuilder(GraphConfig(knn_k=KNN_K)).build_graph(
        depth, valid, unc, (1.0, 1.0))
    return coo_to_ell(bg.graph, KNN_K).to(dev), bg.num_nodes


def ragged_graph(torch, np, dev, k=16, slots=False):
    """A batch of small k-NN graphs (k 16) as batch_graphs packs them:
    1x1 and 1x2 grids (isolated nodes, one live slot) and grids with
    fewer than k + 1 cells among larger ones; with ``slots``, with the
    source-sorted slot tables that the layer's backward reduces over."""
    from bathymetric_gnn_tpu_torch.config.config import GraphConfig
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.graph import batch_graphs

    gb = GraphBuilder(GraphConfig(knn_k=k))
    parts, stds = [], []
    for i, n in enumerate((1, 2, 5, 40, 3, 63, 1, 17)):
        depth, unc = knn_survey(np, n, SEED + 40 + i, holes=0.0)
        if n == 2:
            depth, unc = depth[:1], unc[:1]
        bg = gb.build_graph(depth, np.isfinite(depth), unc, (1.0, 1.0))
        g, m = bg.graph, bg.graph.edge_mask
        parts.append((g.x[:bg.num_nodes],
                      np.stack([g.edge_src, g.edge_dst])[:, m],
                      g.edge_attr[m]))
        stds.append(g.local_std[:bg.num_nodes])
    graph, counts = batch_graphs(parts, n_pad=8192, e_pad=8192 * k,
                                 local_std_list=stds)
    ell = coo_to_ell(graph, k)
    if slots:
        ell = ell.with_src_sorted_slots()
    return ell.to(dev), int(counts.sum())


def ell_cases(torch, np, model, dev):
    """(label, kernel C kwargs, dims) at the serving path's layer shapes
    on the survey's k-NN graph (HC 256 / 4 heads: layers 0-2; HC 64 /
    1 head: the last), and the ragged K = 16 batch."""
    g, n_live = knn_graph(torch, np, dev)
    rg_, n_rg = ragged_graph(torch, np, dev)
    gen = torch.Generator().manual_seed(SEED + 31)
    bb = model.GNNBackbone_0
    out = []
    for li, label, graph, live in (
            (1, "mid 256->256 h4", g, n_live),
            (MODEL_LAYERS - 1, "last 256->64 h1", g, n_live),
            (1, "ragged K16 256->256 h4", rg_, n_rg)):
        conv = getattr(bb, f"GATConv_{li}")
        n = graph.x.shape[0]
        f_in = conv.lin_src.shape[0]
        mask = graph.node_mask
        with torch.no_grad():
            x = torch.randn(n, f_in, generator=gen).to(dev) * mask[:, None]
            xh = x @ conv.lin_src
            el, el_self = conv._edge_terms(graph)
            bias = conv.bias + 0.1 * torch.randn(
                conv.bias.shape, generator=gen).to(dev)
        kw = dict(xh=xh, att_src=conv.att_src.detach(),
                  att_dst=conv.att_dst.detach(), nbr_src=graph.nbr_src,
                  nbr_mask=graph.nbr_mask, el=el, el_self=el_self,
                  bias=bias, node_mask=mask)
        k = graph.nbr_src.shape[1]
        dims = dict(n=n, k=k, heads=conv.heads, hc=xh.shape[1],
                    live_nodes=live,
                    live_edges=int(graph.nbr_mask.sum().item()))
        out.append((f"{label} N={n} K={k} f32", kw, dims))
    return out, g


def phase_ell_kernel_vs_plain(torch, cases):
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    worst = {}
    with torch.no_grad():
        for label, kw, dims in cases:
            out = ef.ell_gat_fused(**kw)
            torch.cuda.synchronize()
            ref = ef.ell_gat_reference(**kw)
            torch.cuda.synchronize()
            d = (out - ref).abs()
            rel = (d / (1 + ref.abs())).max().item()
            dead = ~kw["node_mask"]
            ok = (rel <= TOL["float32"] and bool(torch.isfinite(out).all())
                  and not bool(out[dead].any()))
            log(f"[2c] {label}: {dims['live_nodes']} live nodes, "
                f"{dims['live_edges']} live edges; max_abs "
                f"{d.max().item():.3e} max_rel(1+|ref|) {rel:.3e} tol "
                f"{TOL['float32']:.1e} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel C disagrees with its plain version: {label}")
            worst[label] = d.max().item()
            del out, ref
    return worst


# -- phase 3c: k-NN serving -------------------------------------------------------

def make_refinements(np, n_grids, seed):
    """Refinement grids as benchmarks/vr_bench.py makes them: sides 3..50,
    depth ramps + noise, ~5 % NODATA (1e6), resolution 0.5-4 m,
    uncertainty 0.25."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(3, 51, size=(n_grids, 2))
    grids = []
    for i in range(n_grids):
        h, w = int(sizes[i, 0]), int(sizes[i, 1])
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = (20.0 + rng.uniform(-5, 5) + 0.1 * xx + 0.05 * yy
                 + rng.normal(0, 0.05, (h, w)).astype(np.float32))
        depth[rng.random((h, w)) < 0.05] = 1.0e6
        uncert = np.full((h, w), 0.25, np.float32)
        res = float(rng.uniform(0.5, 4.0))
        grids.append((depth, uncert, (res, res)))
    return grids


def serve(proc, grids):
    """Feed grids to a NativeVRProcessor as benchmarks/vr_bench.py does;
    returns every grid's result, in input order."""
    out = []
    for depth, unc, res in grids:
        proc.add_to_batch(depth, unc, res)
        if proc.batch_ready():
            out.extend(proc.flush_batch())
    return out + proc.drain()


def phase_vr_knn(torch, np, work):
    """NativeVRProcessor (knn_k 8, node budget 50,000) on VR_GRIDS
    refinement grids + one VR_BIG^2 grid from a graph-trained port
    checkpoint (full width, 8 input channels)."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.utils.weights import (load_state_dict,
                                                         save_checkpoint)

    ckpt = save_checkpoint(work / "knn_ckpt",
                           seeded_model(torch, np, 8).state_dict(),
                           meta={"param_layout": "coo"})
    sd, meta = load_state_dict(ckpt)
    check(meta["trained_layout"] == "coo", f"checkpoint meta {meta}")
    cfg = Config()
    cfg.graph.knn_k = KNN_K
    proc = NativeVRProcessor(sd, cfg, node_budget=VR_BUDGET)
    check(proc.sparse_kernel == "banded_pallas",
          f"sparse_kernel {proc.sparse_kernel}")
    grids = make_refinements(np, VR_GRIDS, SEED + 50)
    big, big_unc = knn_survey(np, VR_BIG, SEED + 51)
    big[np.isnan(big)] = 1.0e6
    grids.insert(VR_GRIDS // 2, (big, big_unc, (2.0, 2.0)))
    n_nodes = sum(int((np.abs(d) < 1e5).sum()) for d, _, _ in grids)

    serve(proc, grids[:300])            # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    chunks, plain_calls = [], []
    launch_chunk = proc._launch_graphs_chunk
    reference = ef.ell_gat_reference

    def counted_chunk(idx):
        chunks.append(sum(len(proc.pending[i]["rows"]) for i in idx))
        return launch_chunk(idx)

    def counted_reference(*a, **k):
        plain_calls.append(1)
        return reference(*a, **k)

    ef.launches = 0                     # counts of the main path's run
    with mock.patch.object(proc, "_launch_graphs_chunk", counted_chunk), \
            mock.patch.object(ef, "ell_gat_reference", counted_reference):
        t0 = time.perf_counter()
        results = serve(proc, grids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ef.launches

    check(len(results) == len(grids), f"{len(results)} results for "
          f"{len(grids)} grids")
    seen = set()
    for (depth, _, _), r in zip(grids, results):
        valid = np.abs(depth) < 1e5
        cls = r["classification"]
        check(cls.shape == depth.shape, f"result shape {cls.shape}")
        check(set(np.unique(cls[valid]).tolist()) <= {0, 1, 2}
              and bool((cls[~valid] == -1).all()), "classes")
        check(all(np.isfinite(r[c]).all() for c in ("confidence",
                                                    "correction")),
              "non-finite outputs")
        seen |= set(np.unique(cls[valid]).tolist())
    check(not plain_calls, f"the plain version ran {len(plain_calls)} times "
          "on the serving path")
    check(launches == MODEL_LAYERS * len(chunks),
          f"ell_gat_fwd launches {launches} != {MODEL_LAYERS} layers x "
          f"{len(chunks)} graph chunks")
    check(max(chunks) > proc.node_buckets[-1],
          "the big grid did not take a one-off bucket")
    log(f"[3c] NativeVRProcessor knn_k {KNN_K}, budget {VR_BUDGET}: "
        f"{len(grids)} grids ({VR_GRIDS} refinements + one {VR_BIG}^2), "
        f"{n_nodes} nodes in {wall:.3f} s: {len(grids) / wall:.3f} grids/s, "
        f"{n_nodes / wall / 1e6:.4f} Mnodes/s; {len(chunks)} graph chunks, "
        f"ell_gat_fwd launches {launches} = {MODEL_LAYERS} x "
        f"{len(chunks)}; plain version called 0 times; classes "
        f"{sorted(seen)}")

    # one flush, kernel vs plain functions, both on the card
    flush, nodes = [], 0
    for gr in grids:
        flush.append(gr)
        nodes += int((np.abs(gr[0]) < 1e5).sum())
        if nodes >= VR_BUDGET:
            break
    k_out = serve(proc, flush)
    with mock.patch.object(ef, "ell_gat_fused",
                           lambda *a, **k: reference(*a, **k)):
        p_out = serve(proc, flush)
    agree = n = 0
    dconf = 0.0
    for (depth, _, _), a, b in zip(flush, k_out, p_out):
        v = np.abs(depth) < 1e5
        agree += int((a["classification"][v] == b["classification"][v]).sum())
        n += int(v.sum())
        dconf = max(dconf, float(np.abs(a["confidence"]
                                        - b["confidence"]).max()))
    log(f"[3c] one flush ({len(flush)} grids, {nodes} nodes), kernel vs "
        f"plain on the card: class agreement {agree / n:.6f}, max |d "
        f"confidence| {dconf:.3e}")
    check(agree / n >= 0.999 and dconf <= 1e-3, "flush outputs disagree")

    wall_p, prows = device_profile(torch, lambda: serve(proc, grids[:500]))
    busy = log_profile("3c", "500 refinement grids", wall_p, prows, top=10)
    cli_stats = vr_cli(np, work, ckpt, grids[:300])
    return dict(launches=launches, chunks=len(chunks), wall=wall,
                grids=len(grids), nodes=n_nodes, busy_share=busy,
                proc=proc, cli=cli_stats, grid_list=grids, results=results,
                ckpt=ckpt)


def vr_cli(np, work, ckpt, grids, tag="3c", knn_k=KNN_K):
    """cli.inference_native on a VR BAG of ``grids`` written by the port's
    write_vr_bag, when h5py is installed: ``--knn-k knn_k``, or without
    the flag (the checkpoint's knn_k 0: the default route) when knn_k is
    None."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        log(f"[{tag}] cli.inference_native on a VR BAG: not run, h5py is "
            "not installed on this machine")
        return None
    from bathymetric_gnn_tpu_torch.cli import inference_native
    from bathymetric_gnn_tpu_torch.io.bag import write_vr_bag

    cols = 20
    refs = [(i // cols, i % cols, d, u, r[0])
            for i, (d, u, r) in enumerate(grids)]
    src = work / f"vr_in_{tag}.bag"
    write_vr_bag(src, (-(-len(refs) // cols), cols), 64.0, refs)
    flag = [] if knn_k is None else ["--knn-k", str(knn_k)]
    stats = inference_native.main([
        "--input", str(src), "--output", str(work / f"vr_out_{tag}.bag"),
        "--model", str(ckpt)] + flag)
    check(stats["grids"] == len(grids), f"cli grids {stats}")
    log(f"[{tag}] cli.inference_native {' '.join(flag) or '(no --knn-k)'} "
        f"on a VR BAG of {len(grids)} refinements: {stats}")
    return stats


# -- phase 3g: the default VR route (knn_k 0) ---------------------------------

def check_results(np, grids, results, tag):
    """Every grid returned, in order, with its shape, classes in {0, 1, 2}
    on valid cells and -1 on invalid ones, finite outputs."""
    check(len(results) == len(grids), f"[{tag}] {len(results)} results for "
          f"{len(grids)} grids")
    for (depth, _, _), r in zip(grids, results):
        valid = np.abs(depth) < 1e5
        cls = r["classification"]
        check(cls.shape == depth.shape, f"[{tag}] result shape {cls.shape}")
        check(set(np.unique(cls[valid]).tolist()) <= {0, 1, 2}
              and bool((cls[~valid] == -1).all()), f"[{tag}] classes")
        check(all(np.isfinite(r[c]).all() for c in ("confidence",
                                                    "correction")),
              f"[{tag}] non-finite outputs")


def phase_vr_default(torch, np, work, vr):
    """NativeVRProcessor with knn_k 0 (the JAX default) on 3c's checkpoint
    and grids, node budget VR_BUDGET: the refinements in slabs through the
    dense grid model (kernel A), the 512^2 grid on a grid-connectivity
    graph through GATConvELL (kernel C); at the default precision (bf16 on
    the card) and in f32."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.utils.weights import load_state_dict

    sd, _ = load_state_dict(vr["ckpt"])
    grids = vr["grid_list"]
    n_nodes = vr["nodes"]
    grid_ref, ell_ref = gf.grid_gat_reference, ef.ell_gat_reference
    plain_calls = []

    def counted(ref):
        def run(*a, **k):
            plain_calls.append(1)
            return ref(*a, **k)
        return run

    runs, procs = {}, {}
    for cd in (None, "float32"):
        proc = NativeVRProcessor(sd, Config(), node_budget=VR_BUDGET,
                                 compute_dtype=cd)
        name = proc.compute_dtype
        check(proc.sparse_kernel == "xla" and proc.use_slab
              and proc.use_grid and name == (cd or "bfloat16"),
              f"default route resolved to {proc.sparse_kernel}, slab "
              f"{proc.use_slab}, grid {proc.use_grid}, {name}")
        serve(proc, grids[:300])        # warm-up (allocator, first launches)
        torch.cuda.synchronize()
        slabs, graphs = [], []
        launch_slab = proc._launch_slab_chunk
        launch_graphs = proc._launch_graphs_chunk

        def counted_slab(idx, launch=launch_slab, out=slabs):
            out.append(len(idx))
            return launch(idx)

        def counted_graphs(idx, launch=launch_graphs, out=graphs):
            out.append(len(idx))
            return launch(idx)

        with mock.patch.object(proc, "_launch_slab_chunk", counted_slab), \
                mock.patch.object(proc, "_launch_graphs_chunk",
                                  counted_graphs), \
                mock.patch.object(gf, "grid_gat_reference",
                                  counted(grid_ref)), \
                mock.patch.object(ef, "ell_gat_reference", counted(ell_ref)):
            gf.launches = ef.launches = 0   # counts of the main path's run
            t0 = time.perf_counter()
            results = serve(proc, grids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            a_launches, c_launches = gf.launches, ef.launches
        check_results(np, grids, results, "3g")
        check(not plain_calls, f"a plain version ran {len(plain_calls)} "
              "times on the default route")
        check(a_launches == MODEL_LAYERS * len(slabs),
              f"grid_gat_fwd launches {a_launches} != {MODEL_LAYERS} x "
              f"{len(slabs)} slab chunks")
        check(c_launches == MODEL_LAYERS * len(graphs),
              f"ell_gat_fwd launches {c_launches} != {MODEL_LAYERS} x "
              f"{len(graphs)} graph chunks")
        runs[name] = dict(a_launches=a_launches, c_launches=c_launches,
                          slab_chunks=len(slabs), graph_chunks=len(graphs),
                          wall=wall, grids_per_s=len(grids) / wall,
                          mnodes_per_s=n_nodes / wall / 1e6,
                          results=results)
        procs[name] = proc
        log(f"[3g] NativeVRProcessor knn_k 0, {name}, budget {VR_BUDGET}: "
            f"{len(grids)} grids, {n_nodes} nodes in {wall:.3f} s: "
            f"{len(grids) / wall:.3f} grids/s, "
            f"{n_nodes / wall / 1e6:.4f} Mnodes/s; {len(slabs)} slab chunks "
            f"(up to {max(slabs)} grids), {len(graphs)} graph chunks; "
            f"grid_gat_fwd launches {a_launches} = {MODEL_LAYERS} x "
            f"{len(slabs)}, ell_gat_fwd launches {c_launches} = "
            f"{MODEL_LAYERS} x {len(graphs)}; plain versions called 0 times")
    log(f"[3g] beside 3c's k-NN route in this run: "
        f"{vr['grids'] / vr['wall']:.3f} grids/s, "
        f"{vr['nodes'] / vr['wall'] / 1e6:.4f} Mnodes/s")

    agree = n = 0
    for (depth, _, _), a, b in zip(grids, runs["bfloat16"]["results"],
                                   runs["float32"]["results"]):
        v = np.abs(depth) < 1e5
        agree += int((a["classification"][v] == b["classification"][v]).sum())
        n += int(v.sum())
    bf_agree = agree / n
    log(f"[3g] bf16 (default) vs f32 classes: {bf_agree:.6f} of {n} valid "
        "cells (want >= 0.99)")
    check(bf_agree >= 0.99, "bf16 classes disagree with f32")

    # one flush of small grids, kernels vs the plain functions, both on the
    # card (f32: the kernel's accurate form)
    proc = procs["float32"]
    flush, nodes = [], 0
    for gr in grids:
        if max(gr[0].shape) > SLAB:
            continue
        flush.append(gr)
        nodes += int((np.abs(gr[0]) < 1e5).sum())
        if nodes >= VR_BUDGET:
            break
    k_out = serve(proc, flush)
    with mock.patch.object(gf, "fused_grid_gat_infer",
                           lambda *a, **k: grid_ref(*a, **k)):
        p_out = serve(proc, flush)
    agree = n = 0
    dconf = 0.0
    for (depth, _, _), a, b in zip(flush, k_out, p_out):
        v = np.abs(depth) < 1e5
        agree += int((a["classification"][v] == b["classification"][v]).sum())
        n += int(v.sum())
        dconf = max(dconf, float(np.abs(a["confidence"]
                                        - b["confidence"]).max()))
    log(f"[3g] one slab flush ({len(flush)} grids, {nodes} nodes), kernel "
        f"A vs plain on the card: class agreement {agree / n:.6f}, max |d "
        f"confidence| {dconf:.3e}")
    check(agree / n >= 0.999 and dconf <= 1e-3, "slab flush outputs disagree")

    # 2,100 grids of 3 x 3 in one flush: two slab chunks (2,048 + 52),
    # where the JAX processor's bucketing raises
    proc = procs["bfloat16"]
    rg = np.random.default_rng(SEED + 55)
    small = [((20 + rg.normal(0, 0.3, (3, 3))).astype(np.float32),
              np.full((3, 3), 0.25, np.float32), (1.0, 1.0))
             for _ in range(2100)]
    sizes = []
    launch_slab = proc._launch_slab_chunk
    with mock.patch.object(proc, "_launch_slab_chunk",
                           lambda idx: sizes.append(len(idx))
                           or launch_slab(idx)):
        proc.node_budget = 10 ** 9
        t0 = time.perf_counter()
        out_small = serve(proc, small)
        torch.cuda.synchronize()
        wall_small = time.perf_counter() - t0
        proc.node_budget = VR_BUDGET
    check_results(np, small, out_small, "3g")
    check(sizes == [2048, 52], f"2,100-grid flush chunks {sizes}")
    log(f"[3g] 2,100 grids of 3x3 in one flush: slab chunks {sizes}, "
        f"{wall_small:.3f} s")

    wall_p, prows = device_profile(torch, lambda: serve(procs["bfloat16"],
                                                        grids[:500]))
    busy = log_profile("3g", "500 refinement grids, bf16", wall_p, prows,
                       top=10)
    wall_p, prows = device_profile(torch, lambda: serve(procs["float32"],
                                                        grids[:500]))
    busy32 = log_profile("3g", "500 refinement grids, f32", wall_p, prows,
                         top=6)
    cli_stats = vr_cli(np, work, vr["ckpt"], grids[:300], "3g", None)
    results32 = runs["float32"]["results"]
    for name, r in runs.items():
        r.pop("results")
        r["device_busy_share"] = busy if name == "bfloat16" else busy32
    return dict(runs=runs, bf16_class_agreement=bf_agree,
                small_flush_chunks=sizes, small_flush_s=wall_small,
                cli=cli_stats, procs=procs, flush=flush,
                results32=results32)


# -- phase 3h: streaming survey inference ----------------------------------------

STREAM_H, STREAM_W = 16384, 4096    # 19 tile rows of 5 full 1024^2 tiles
STREAM_STRIP = 1024                 # rows a strip of the input survey
# the host memory the streaming run may add: 4 of this survey's f32
# full-grid arrays (the in-memory path holds >= 8 such arrays)
RSS_GROWTH_LIMIT = 1 << 30


def vm_rss():
    """The process's resident set now (bytes). ``ru_maxrss`` is a
    high-water mark that earlier phases have already raised."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def trim_heap():
    """Return the C heap's free pages to the system (glibc
    ``malloc_trim``): earlier phases leave GiBs freed but resident, which a
    run would reuse unseen by VmRSS. Returns False where there is none."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        return False
    return True


class RssSampler:
    """Peak VmRSS over a ``with`` block, sampled every ``period`` s in a
    thread."""

    def __init__(self, period=0.02):
        import threading

        self.period = period
        self.peak = self.start = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, vm_rss())
            self._stop.wait(self.period)

    def __enter__(self):
        self.start = self.peak = vm_rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, vm_rss())


def write_streamed_survey(np, path, h, w, chunk=STREAM_STRIP, seed=SEED):
    """An [h, w] survey written row band by row band with the port's
    StreamingGeoTiffWriter, never held whole: swell + shoals + N(0, 0.05)
    noise + a NaN swath gap, one band (the kind of survey of
    ``benchmarks/streaming_survey_bench.py``)."""
    from bathymetric_gnn_tpu_torch.io.geotiff import StreamingGeoTiffWriter

    rg = np.random.default_rng(seed)
    wr = StreamingGeoTiffWriter(path, h, w, 1, pixel_scale=(1.0, 1.0),
                                origin=(0.0, float(h)), nodata=float("nan"),
                                rows_per_strip=chunk)
    xx = np.arange(w, dtype=np.float32)[None, :]
    for r0 in range(0, h, chunk):
        r1 = min(r0 + chunk, h)
        yy = np.arange(r0, r1, dtype=np.float32)[:, None]
        band = (30 + 8 * np.sin(xx / 90) + 5 * np.cos(yy / 70)
                + 2 * np.sin(xx / 17 + yy / 23)
                + rg.normal(0, 0.05, (r1 - r0, w))).astype(np.float32)
        band[:, w // 2 - 20:w // 2 - 10] = np.nan   # swath gap
        wr.write_rows(0, r0, band)
    wr.close()


def forward_calls(tm, shape, batch=8):
    """(tiles, forward calls) of the streaming path on a survey without
    holes: each tile row's full tiles in batches of up to ``batch``, a
    ragged tile alone."""
    _, _, specs = tm.compute_tile_grid(shape)
    calls = 0
    for tr in {s.tile_row for s in specs}:
        row = [s for s in specs if s.tile_row == tr]
        full = sum(s.shape == (tm.tile_size, tm.tile_size) for s in row)
        calls += -(-full // batch) + len(row) - full
    return len(specs), calls


def stream_cli(torch, argv, tag, plain_calls):
    """cli.inference --streaming with kernel A's launches counted from 0
    and its plain version counted: (stats, launches, wall s)."""
    from bathymetric_gnn_tpu_torch.cli import inference as cli
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    ref = gf.grid_gat_reference

    def counted(*a, **k):
        plain_calls.append(tag)
        return ref(*a, **k)

    with mock.patch.object(gf, "grid_gat_reference", counted):
        gf.launches = 0                  # counts of this run
        t0 = time.perf_counter()
        stats = cli.main(argv + ["--streaming"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gf.launches
    return stats, launches, wall


def stage_timers(torch, acc):
    """Patches that add each stage's host-clock seconds to ``acc``: the
    windowed reads, forward_tiles (ended by a sync, so the device's time
    is the forward's), the merge (add_tile), the band's roll (advance),
    finalize_rows, the back-fill and calibration (_finish_channels) and
    the writes. The streaming path fetches each forward's result at once,
    so the sync moves no work."""
    from bathymetric_gnn_tpu_torch.inference.pipeline import (
        BathymetricPipeline)
    from bathymetric_gnn_tpu_torch.inference.streaming import RowBandMerger
    from bathymetric_gnn_tpu_torch.io.geotiff import (GeoTiffWindowReader,
                                                      StreamingGeoTiffWriter)

    def timed(key, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return run

    return [mock.patch.object(cls, name, timed(key, getattr(cls, name),
                                               key == "forward"))
            for key, cls, name in (
                ("read", GeoTiffWindowReader, "read_rows"),
                ("forward", BathymetricPipeline, "forward_tiles"),
                ("merge", RowBandMerger, "add_tile"),
                ("advance", RowBandMerger, "advance"),
                ("finalize_rows", RowBandMerger, "finalize_rows"),
                ("finish", BathymetricPipeline, "_finish_channels"),
                ("write", StreamingGeoTiffWriter, "write_rows"))]


def check_streamed_output(np, src, out, h, w, thr, stats):
    """The streamed product read back in row windows: five bands of
    [h, w], classes in {0, 1, 2} and confidence in [0, 1] on valid cells,
    NaN on invalid ones (the swath gap), cleaned = depth - correction on
    confident noise and the depth elsewhere."""
    from bathymetric_gnn_tpu_torch.io.geotiff import GeoTiffWindowReader

    fixed_total = gap_cells = 0
    with GeoTiffWindowReader(src) as rin, GeoTiffWindowReader(out) as rout:
        check((rout.bands, rout.height, rout.width) == (5, h, w),
              f"[3h] output {(rout.bands, rout.height, rout.width)}")
        for r0 in range(0, h, STREAM_STRIP):
            r1 = min(r0 + STREAM_STRIP, h)
            depth = rin.read_rows(0, r0, r1)
            cleaned, cls, conf, corr, vm = (rout.read_rows(b, r0, r1)
                                            for b in range(5))
            valid = np.isfinite(depth)
            check(np.array_equal(vm, valid.astype(np.float32)),
                  f"[3h] valid mask, rows {r0}:{r1}")
            check(set(np.unique(cls[valid]).tolist()) <= {0.0, 1.0, 2.0},
                  f"[3h] classes, rows {r0}:{r1}")
            check(0.0 <= conf[valid].min() and conf[valid].max() <= 1.0,
                  f"[3h] confidence outside [0, 1], rows {r0}:{r1}")
            check(all(np.isnan(b[~valid]).all()
                      for b in (cleaned, cls, conf, corr))
                  and np.isfinite(cleaned[valid]).all(),
                  f"[3h] NaN outside the valid cells, rows {r0}:{r1}")
            check(not valid[:, w // 2 - 20:w // 2 - 10].any(),
                  "[3h] the swath gap has valid cells")
            gap_cells += int((~valid).sum())
            fixed = valid & (cls == 2) & (conf > thr)
            check(np.array_equal(cleaned[fixed], (depth - corr)[fixed])
                  and np.array_equal(cleaned[valid & ~fixed],
                                     depth[valid & ~fixed]),
                  f"[3h] cleaned depth, rows {r0}:{r1}")
            fixed_total += int(fixed.sum())
    check(fixed_total == stats["cells_corrected"],
          f"[3h] {fixed_total} corrected cells, stats say "
          f"{stats['cells_corrected']}")
    check(stats["valid_cells"] == h * w - gap_cells,
          f"[3h] valid_cells {stats['valid_cells']}")


def phase_streaming(torch, np, work, e2e):
    """cli.inference --streaming: phase 3's survey against phase 3's
    in-memory output, then a survey taller than the merger's band,
    streamed twice (host memory, stage split; device busy share)."""
    from bathymetric_gnn_tpu_torch.data.tiling import TileManager
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff

    plain_calls = []
    argv = list(e2e["argv"])
    mem_out = argv[argv.index("--output") + 1]
    out = work / "streamed.tif"
    argv[argv.index("--output") + 1] = str(out)
    thr = float(argv[argv.index("--confidence-threshold") + 1])
    tm = TileManager(TILE, 128)
    n_tiles, calls = forward_calls(tm, (SURVEY, SURVEY))
    stats, launches, wall = stream_cli(torch, argv, "2304", plain_calls)
    check(stats["tiles_processed"] == n_tiles == 9,
          f"[3h] {stats['tiles_processed']} tiles on the {SURVEY}^2 survey")
    check(launches == MODEL_LAYERS * calls,
          f"[3h] grid_gat_fwd launches {launches} != {MODEL_LAYERS} x "
          f"{calls} forward calls")
    check(not plain_calls, "[3h] the plain version ran")
    mem, _ = read_geotiff(mem_out)
    st, _ = read_geotiff(out)
    check(st.shape == (5, SURVEY, SURVEY), f"[3h] bands {st.shape}")
    diffs = {}
    for si, mi, name in ((0, 0, "cleaned"), (1, 2, "classification"),
                         (2, 3, "confidence"), (3, 4, "correction"),
                         (4, 5, "valid")):
        a, b = mem[mi], st[si]
        if name in ("classification", "valid"):
            both = np.isfinite(a) & np.isfinite(b)
            check(np.array_equal(a[both], b[both]),
                  f"[3h] streaming {name} differs from in-memory on "
                  f"{int((a[both] != b[both]).sum())} cells")
        else:
            a, b = np.nan_to_num(a), np.nan_to_num(b)
            diffs[name] = float(np.abs(a - b).max())
            check(np.allclose(a, b, rtol=1e-3, atol=1e-4),
                  f"[3h] streaming {name} differs from in-memory by "
                  f"{diffs[name]:.3e}")
    check(stats["cells_corrected"] == e2e["cells_corrected"],
          f"[3h] cells_corrected {stats['cells_corrected']} streaming, "
          f"{e2e['cells_corrected']} in memory")
    log(f"[3h] cli.inference --streaming on {SURVEY}x{SURVEY}: {n_tiles} "
        f"tiles in {wall:.3f} s ({n_tiles / wall:.3f} tiles/s), "
        f"grid_gat_fwd launches {launches} = {MODEL_LAYERS} x {calls}, "
        f"plain version called 0 times; against phase 3's in-memory "
        f"output: classes and valid mask equal, max |d| {diffs}, "
        f"cells_corrected {stats['cells_corrected']} both")
    small = dict(launches=launches, wall=wall, tiles=n_tiles, diffs=diffs)

    t0 = time.perf_counter()
    src = work / "tall_survey.tif"
    big_out = work / "tall_streamed.tif"
    write_streamed_survey(np, src, STREAM_H, STREAM_W)
    synth_s = time.perf_counter() - t0
    f32_mib = STREAM_H * STREAM_W * 4 / 2 ** 20
    n_tiles, calls = forward_calls(tm, (STREAM_H, STREAM_W))
    big_argv = ["--input", str(src), "--output", str(big_out), "--model",
                str(e2e["ckpt"]), "--confidence-threshold", str(thr)]
    log(f"[3h] wrote a {STREAM_H}x{STREAM_W} survey ({STREAM_H * STREAM_W}"
        f" cells, {f32_mib:.0f} MiB per f32 array, {n_tiles} tiles of "
        f"{TILE}^2) in {synth_s:.3f} s")

    gc.collect()
    rss_used = vm_rss()
    trimmed = trim_heap()
    log(f"[3h] host VmRSS {rss_used / 2 ** 20:.1f} MiB, after malloc_trim "
        f"{vm_rss() / 2 ** 20:.1f} MiB" if trimmed else
        "[3h] no malloc_trim on this machine: VmRSS keeps the earlier "
        "phases' freed heap, which the run may reuse unseen")
    acc = {}
    patches = stage_timers(torch, acc)
    for p in patches:
        p.start()
    try:
        with RssSampler() as rss:
            stats, launches, wall = stream_cli(torch, big_argv, "tall",
                                               plain_calls)
    finally:
        for p in patches:
            p.stop()
    growth = rss.peak - rss.start
    check(stats["tiles_processed"] == n_tiles,
          f"[3h] {stats['tiles_processed']} tiles, want {n_tiles}")
    check(launches == MODEL_LAYERS * calls,
          f"[3h] grid_gat_fwd launches {launches} != {MODEL_LAYERS} x "
          f"{calls} forward calls")
    check(not plain_calls, "[3h] the plain version ran")
    stages = {k: round(v, 4) for k, v in acc.items()}
    stages["other"] = round(wall - sum(acc.values()), 4)
    log(f"[3h] streamed {STREAM_H}x{STREAM_W}: {n_tiles} tiles in "
        f"{wall:.3f} s ({n_tiles / wall:.3f} tiles/s, host clock ending in "
        f"a sync), grid_gat_fwd launches {launches} = {MODEL_LAYERS} x "
        f"{calls}, plain version called 0 times; stats {stats}")
    log(f"[3h] stage split of that run (s): {stages} (forward ends in a "
        f"sync; other = tile extraction, the fetch, the correction mask, "
        f"the output rows)")
    log(f"[3h] host VmRSS before {rss.start / 2 ** 20:.1f} MiB, peak "
        f"{rss.peak / 2 ** 20:.1f} MiB: growth {growth / 2 ** 20:.1f} MiB "
        f"= {growth / 2 ** 20 / f32_mib:.3f} of one f32 survey array "
        f"({f32_mib:.0f} MiB); limit {RSS_GROWTH_LIMIT / 2 ** 20:.0f} MiB")
    check(growth <= RSS_GROWTH_LIMIT,
          f"[3h] host memory grew {growth / 2 ** 20:.1f} MiB")
    check_streamed_output(np, src, big_out, STREAM_H, STREAM_W, thr, stats)

    runs = []
    wall_p, rows = device_profile(
        torch, lambda: runs.append(stream_cli(torch, big_argv, "profiled",
                                              plain_calls)))
    busy = log_profile("3h", f"streamed {STREAM_H}x{STREAM_W}", wall_p,
                       rows, top=8)
    check(runs[0][1] == MODEL_LAYERS * calls and not plain_calls,
          f"[3h] profiled run: grid_gat_fwd launches {runs[0][1]}")
    src.unlink()
    big_out.unlink()
    bags = stream_bags(np, work, e2e["ckpt"])
    return dict(small=small, tiles=n_tiles, launches=launches,
                profiled_launches=runs[0][1], wall=wall,
                tiles_per_s=n_tiles / wall, busy_share=busy, stages=stages,
                rss_growth_mib=growth / 2 ** 20, f32_array_mib=f32_mib,
                bags=bags)


def stream_bags(np, work, ckpt):
    """cli.inference --streaming on a small SR BAG and a small VR BAG,
    where h5py is installed."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("[3h] cli.inference --streaming on SR and VR BAGs: not run, "
            "h5py is not installed on this machine")
        return None
    from bathymetric_gnn_tpu_torch.cli import inference as cli
    from bathymetric_gnn_tpu_torch.io.bag import write_sr_bag, write_vr_bag

    depth, unc = synthetic_survey(np, 1200, 1100, SEED + 70)
    sr = work / "stream_sr.bag"
    write_sr_bag(sr, np.flipud(np.where(np.isfinite(depth), depth, 1e6)),
                 np.flipud(unc), resolution=2.0, origin=(500000.0, 4e6))
    rg = np.random.default_rng(SEED + 71)
    refs = [(r, c, (20 + rg.normal(0, 1, (16, 16))).astype(np.float32),
             np.full((16, 16), 0.2, np.float32), 2.0)
            for r in range(40) for c in range(40)]
    vr = work / "stream_vr.bag"
    write_vr_bag(vr, (40, 40), 32.0, refs)
    out = {}
    for name, src in (("sr", sr), ("vr", vr)):
        stats = cli.main(["--input", str(src), "--output",
                          str(work / f"stream_{name}.tif"), "--model",
                          str(ckpt), "--streaming"])
        check(stats["tiles_processed"] > 0 and stats["valid_cells"] > 0,
              f"[3h] {name} BAG stats {stats}")
        log(f"[3h] cli.inference --streaming on a {name.upper()} BAG: "
            f"{stats}")
        out[name] = stats
    return out


# -- phase 4c ------------------------------------------------------------------

def ell_bound(dims, dtype="float32"):
    """Least time of one kernel C call on this graph's data, over HBM
    bandwidth: the rows of xh and el_self of the live nodes, el and nbr_src
    of the live slots, nbr_mask of the live nodes' slots read once,
    node_mask and out (zeros at padded nodes) over all N, att and bias
    once; vs its operations for the live nodes and edges (attention dots
    4 * HC per node; ~8 per live slot and head for logit, max, exp, sum and
    divide; 2 * HC per live slot and self loop for the weighted sum) over
    the peak of ``dtype``. xh, att, bias and out take 2 bytes an element
    in bfloat16, the rest 4."""
    n, k, h, hc = dims["n"], dims["k"], dims["heads"], dims["hc"]
    ln, le = dims["live_nodes"], dims["live_edges"]
    s = 4 if dtype == "float32" else 2
    nbytes = (s * (ln * hc + 3 * hc + n * hc) + 4 * (ln * h + le * h + le)
              + ln * k + n)
    flops = 4 * ln * hc + 8 * (le + ln) * h + 2 * (le + ln) * hc
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes,
            flops)


def phase_ell_timings(torch, cases, proc, graph):
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    rows = []
    with torch.no_grad():
        for label, kw, dims in cases:
            kargs = ef.kernel_args(**kw)
            ms = cuda_ms(torch, lambda: ef.call_kernel(**kargs), 20)
            wrap_ms = cuda_ms(torch, lambda: ef.ell_gat_fused(**kw), 10)
            plain_ms = cuda_ms(torch, lambda: ef.ell_gat_reference(**kw), 5,
                               warmup=1)
            b_ms, b_by, nbytes, flops = ell_bound(dims)
            rows.append(dict(shape=label, ms=ms, wrapper_ms=wrap_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             bytes=nbytes, flops=flops))
            log(f"[4c] {label}: kernel C {ms:.4f} ms (wrapper {wrap_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), "
                f"{b_ms / ms:.3f} of bound")
            del kargs
        fwd_ms = cuda_ms(torch, lambda: proc.model(graph), 5, warmup=2)
    log(f"[4c] EllBathymetricGNN forward, one {graph.x.shape[0]}-node "
        f"flush (full width, 4 kernel C launches): {fwd_ms:.3f} ms")
    return rows, fwd_ms


# -- phase 2d: kernel C's dropout form, C' and F -------------------------------

KNN_TRAIN_SURVEY = 1024   # 25 tiles of 256^2 at stride 224, 5 % holes
KNN_BATCH_SURVEY = 480    # 2 x 2 tiles of 256^2: one merged batch of 4
LR = 1e-3


class FixedSamples:
    """Graph samples built once (the trainer's dataset interface), so the
    step checks and timings pay the host's graph build once."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def class_counts(self):
        import numpy as np

        return sum(np.bincount(s.targets["labels"][:s.num_nodes],
                               minlength=3)[:3] for s in self.samples)

    def sample_normalized_corrections(self):
        import numpy as np

        return np.concatenate([
            s.targets["correction"][:s.num_nodes][
                s.targets["noise_mask"][:s.num_nodes]]
            for s in self.samples])


def knn_train_samples(np, depth):
    """TRAIN_BATCH training samples (k-NN graphs of 256^2 tiles with
    synthetic noise and targets) of ``depth``, as the trainer's dataset
    makes them."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training.datasets import (
        SyntheticTileDataset)

    cfg = Config()
    cfg.graph.knn_k = KNN_K
    ds = SyntheticTileDataset([depth], cfg, tile_size=TRAIN_TILE, overlap=32,
                              seed=SEED)
    return FixedSamples([ds[i] for i in range(TRAIN_BATCH)])


def knn_train_batch(torch, np, dev, samples):
    """The merged batch of ``samples`` as the trainer packs it
    (merge_stacked, coo_to_ell, src_sorted_slots) on the card, its
    targets, and its live node count."""
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.graph import merge_stacked
    from bathymetric_gnn_tpu_torch.training.datasets import collate_samples
    from bathymetric_gnn_tpu_torch.training.trainer import _to_device_targets

    graph, targets = collate_samples(samples.samples)
    g = coo_to_ell(merge_stacked(graph), KNN_K).with_src_sorted_slots()
    return (g.to(dev), _to_device_targets(targets, dev),
            int(np.asarray(g.node_mask).sum()))


def knn_train_cases(torch, np, model, dev, samples):
    """(label, layer kwargs, slot tables, dims) at the k-NN train step's
    layer shapes on its merged batch (N = 262,144: HC 256 / 4 heads and
    HC 64 / 1 head), and the ragged K = 16 batch."""
    g, _, n_live = knn_train_batch(torch, np, dev, samples)
    rg_, n_rg = ragged_graph(torch, np, dev, slots=True)
    gen = torch.Generator().manual_seed(SEED + 61)
    bb = model.GNNBackbone_0
    out = []
    for li, label, graph, live in (
            (1, "mid 256->256 h4", g, n_live),
            (MODEL_LAYERS - 1, "last 256->64 h1", g, n_live),
            (1, "ragged K16 256->256 h4", rg_, n_rg)):
        conv = getattr(bb, f"GATConv_{li}")
        n = graph.x.shape[0]
        f_in = conv.lin_src.shape[0]
        mask = graph.node_mask
        with torch.no_grad():
            x = torch.randn(n, f_in, generator=gen).to(dev) * mask[:, None]
            xh = x @ conv.lin_src
            el, el_self = conv._edge_terms(graph)
            bias = conv.bias + 0.1 * torch.randn(
                conv.bias.shape, generator=gen).to(dev)
        kw = dict(xh=xh, att_src=conv.att_src.detach(),
                  att_dst=conv.att_dst.detach(), nbr_src=graph.nbr_src,
                  nbr_mask=graph.nbr_mask, el=el, el_self=el_self,
                  bias=bias, node_mask=mask)
        k = graph.nbr_src.shape[1]
        live_slots = graph.nbr_mask & mask[:, None]
        dims = dict(n=n, k=k, heads=conv.heads, hc=xh.shape[1],
                    live_nodes=live, live_edges=int(live_slots.sum().item()))
        out.append((f"{label} N={n} K={k} f32", kw,
                    (graph.slot_perm, graph.slot_row_ptr), dims))
    return out, g


ELL_LEAVES = ("xh", "att_src", "att_dst", "el", "el_self", "bias")


def ell_train_run(torch, fn, kw, g=None, **extra):
    """fn(**kw) and the gradients of <out, g> with respect to xh, att_src,
    att_dst, el, el_self and bias; g is drawn when not given."""
    leaves = {n: kw[n].detach().clone().requires_grad_() for n in ELL_LEAVES}
    out = fn(**{**kw, **leaves}, **extra)
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            SEED + 62)).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, list(leaves.values()), g)
    return out.detach(), dict(zip(leaves, grads)), g


def phase_knn_train_kernels_vs_plain(torch, cases):
    """Kernel C (training form) and C' (+ F's mode (b)) vs the plain
    forward and autograd of it, with no dropout, a streamed mask and the
    Philox draw; the draw's rate and its fwd/bwd agreement; F's mode (a)
    vs index_add_ and mode (b) on its own vs its plain version."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    errs = {}
    for i, (label, kw, (perm, row_ptr), dims) in enumerate(cases):
        dev = kw["xh"].device
        n, k, heads, hc = dims["n"], dims["k"], dims["heads"], dims["hc"]
        seed = torch.tensor([0x5EED000 + i], dtype=torch.int64,
                            device=dev)
        drawn = ef.drop_mask(seed, KEEP, n, k, heads)
        rate = (drawn == 0).float().mean().item()
        check(abs(rate - (1 - KEEP)) <= 1e-3, f"drop rate {rate}: {label}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 63 + i)
        streamed = (torch.rand(n, k + 1, heads, generator=gen, device=dev)
                    < KEEP).float() / KEEP
        tables = dict(slot_tables=(perm, row_ptr))
        worst = {"out": 0.0}
        g = None
        for mode, extra, mult in (
                ("no dropout", {}, None),
                ("streamed mask", dict(dmask=streamed), streamed),
                ("Philox", dict(drop_seed=seed, keep_prob=KEEP), drawn)):
            out, grads, g = ell_train_run(torch, ef.ell_gat_fused_train, kw,
                                          g, **extra, **tables)
            torch.cuda.synchronize()
            ref, rgrads, _ = ell_train_run(torch, ef.ell_gat_reference, kw,
                                           g, dmask=mult)
            torch.cuda.synchronize()
            d = (out - ref).abs()
            rel = (d / (1 + ref.abs())).max().item()
            ok = (rel <= TOL["float32"] and bool(torch.isfinite(out).all())
                  and not bool(out[~kw["node_mask"]].any()))
            worst["out"] = max(worst["out"], d.max().item())
            parts = []
            for name in ELL_LEAVES:
                a, r = grads[name], rgrads[name]
                scale = r.abs().max().item() + 1e-12
                e = (a - r).abs().max().item()
                worst[name] = max(worst.get(name, 0.0), e)
                parts.append(f"{name} {e / scale:.2e}")
                ok = ok and e <= GRAD_TOL["float32"] * scale and bool(
                    torch.isfinite(a).all())
            log(f"[2d] {label}, {mode}: C max_rel(1+|ref|) {rel:.3e} (tol "
                f"{TOL['float32']:.1e}); C' err/scale: {', '.join(parts)} "
                f"(tol {GRAD_TOL['float32']:.1e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"C / C' disagree with the plain version: {label}, "
                      f"{mode}")
            if mode == "Philox":
                out_m, gr_m, _ = ell_train_run(torch, ef.ell_gat_fused_train,
                                               kw, g, dmask=drawn, **tables)
                same = torch.equal(out, out_m) and all(
                    torch.equal(grads[nm], gr_m[nm]) for nm in ELL_LEAVES)
                log(f"[2d] {label}: Philox drop rate {rate:.6f} over "
                    f"{drawn.numel()} draws (want {1 - KEEP:.1f} +- 1e-3); "
                    f"C and C' with the in-kernel draw "
                    f"{'equal' if same else 'DIFFER FROM'} C and C' given it "
                    f"as a streamed mask")
                check(same, f"in-kernel draw and streamed mask disagree: "
                            f"{label}")
            del out, grads, ref, rgrads
        # kernel F, mode (b) on its own, on C''s coefficients
        args = ef.kernel_args(**kw, train=True)
        bkw = {nm: args[nm] for nm in (
            "xh", "att", "nbr", "nmask", "el", "el_self", "node_mask",
            "dmask", "seed", "n", "k", "heads", "c", "negative_slope",
            "has_self", "drop_mode", "thresh", "keep_inv", "dtype")}
        p32, r32 = perm.int(), row_ptr.int()
        _, alpha, dl, _, _ = ef.call_bwd_kernel(**bkw, perm=p32, row_ptr=r32,
                                                g=g, source_side=False)
        fb = sr.gat_rows(alpha, dl, g, kw["att_src"], perm, row_ptr, n, k)
        fb_ref = sr.gat_rows_reference(alpha, dl, g, kw["att_src"], perm,
                                       row_ptr, n, k)
        d_b = (fb - fb_ref).abs()
        rel_b = (d_b / (1 + fb_ref.abs())).max().item()
        # kernel F, mode (a), on a cotangent of the live slots' rows
        src, live = fa_inputs(torch, kw)
        ct = torch.randn(src.numel(), hc, generator=torch.Generator(
            ).manual_seed(SEED + 64)).to(dev)
        pa, ra = fa_tables(torch, src, n)
        fa = sr.segment_reduce_sorted(ct, pa, ra, n)
        fa_lib = torch.zeros(n, hc, device=dev).index_add_(0, src.long(), ct)
        d_a = (fa - fa_lib).abs()
        rel_a = (d_a / (1 + fa_lib.abs())).max().item()
        ok = rel_a <= TOL["float32"] and rel_b <= TOL["float32"]
        log(f"[2d] {label}: F mode (b) vs plain max_rel(1+|ref|) "
            f"{rel_b:.3e}; F mode (a) vs index_add_ over {src.numel()} live "
            f"slots max_rel {rel_a:.3e} (tol {TOL['float32']:.1e}) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel F disagrees: {label}")
        # C' given the dots kernel C wrote (the training layer's path) vs
        # C' computing its own; the dots pass vs the generic dots_kernel
        dots = torch.empty(n, 2 * heads, device=dev)
        ef.call_kernel(**args, dots=dots)
        given = ef.call_bwd_kernel(**bkw, perm=p32, row_ptr=r32, g=g,
                                   dots=dots)
        own = ef.call_bwd_kernel(**bkw, perm=p32, row_ptr=r32, g=g)
        same_bwd = all(torch.equal(a, b) for a, b in zip(given, own))
        same_dots = torch.equal(dots, ef.attention_dots(
            args["xh"], args["att"], heads, generic=True))
        log(f"[2d] {label}: C' given C's dots "
            f"{'equals' if same_bwd else 'DIFFERS FROM'} C' computing its "
            f"own, bit for bit; the dots pass "
            f"{'equals' if same_dots else 'DIFFERS FROM'} the generic "
            f"dots_kernel, bit for bit")
        check(same_bwd and same_dots, f"dots bits: {label}")
        del given, own, dots
        worst["f_b"] = d_b.max().item()
        worst["f_a"] = d_a.max().item()
        errs[label] = worst
        del ct, fa, fa_lib, fb, fb_ref, alpha, dl, streamed, drawn
    return errs


# A row wider than the backward passes' untiled instances hold (f32 float4
# chunks: HC <= 2048), which C', D' and F (b) take in column tiles.
WIDE_HEADS, WIDE_C = 2, 1028
WIDE_N = 4096


def wide_row_inputs(torch, np, dev, banded_layer):
    """Layer inputs at HC = WIDE_HEADS x WIDE_C on a k-NN graph (k 8) of
    WIDE_N - WIDE_N / 16 random points padded to WIDE_N: kernel C's
    (``ell_gat_fused_train``) or, with ``banded_layer``, kernel D's
    (``ell_gat_fused_v2`` on BAND_ROWS-row bands), from seeded draws."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell

    rg = np.random.default_rng(SEED + 66)
    n_live = WIDE_N - WIDE_N // 16
    gb = GraphBuilder()
    gb.buckets.node_buckets = (WIDE_N,)
    g = coo_to_ell(gb.build_knn_graph(
        rg.normal(size=(n_live, 3)).astype(np.float32),
        (rg.random((n_live, 2)) * 100).astype(np.float32), KNN_K).graph,
        KNN_K)
    gen = torch.Generator().manual_seed(SEED + 67)
    h, c, hc, k = WIDE_HEADS, WIDE_C, WIDE_HEADS * WIDE_C, KNN_K

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=gen) * sc).to(dev)

    if not banded_layer:
        gd = g.to(dev)
        return dict(xh=rnd(WIDE_N, hc), att_src=rnd(1, h, c, sc=0.05),
                    att_dst=rnd(1, h, c, sc=0.05), nbr_src=gd.nbr_src,
                    nbr_mask=gd.nbr_mask, el=rnd(WIDE_N, k, h),
                    el_self=rnd(WIDE_N, h), bias=rnd(hc, sc=0.1),
                    node_mask=gd.node_mask), None
    banded = band_ell(g, band_rows=BAND_ROWS, heads=h).to(dev)
    xh = rnd(WIDE_N, h, c)
    att = rnd(2, h, c, sc=0.05)
    diag = (torch.arange(hc, device=dev)[:, None] // c
            == torch.arange(h, device=dev)[None]).float()
    return dict(xh=xh, a_src=(xh * att[0]).sum(-1),
                a_dst=(xh * att[1]).sum(-1),
                a_cat_mat=torch.cat([diag * att[0].reshape(hc, 1),
                                     diag * att[1].reshape(hc, 1)], 1),
                el_t=banded.negmask_t + rnd(k * h, WIDE_N),
                el_self_t=rnd(h, WIDE_N), m_edge=rnd(3, h, sc=0.3)), banded


def phase_wide_rows(torch, np, dev, tag):
    """Kernel C' (+ F (b)), tag "2d", or D', tag "2e", at a row past the
    untiled instances (HC = WIDE_HEADS x WIDE_C, f32, column tiles) with a
    streamed dropout mask, against autograd of the plain version. Returns
    the largest gradient error."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    kw, banded = wide_row_inputs(torch, np, dev, tag == "2e")
    if banded is None:
        n, k = kw["nbr_src"].shape
        gen = torch.Generator(device=dev).manual_seed(SEED + 68)
        dmask = (torch.rand(n, k + 1, WIDE_HEADS, generator=gen, device=dev)
                 < KEEP).float() / KEEP
        n0 = ef.bwd_launches
        out, grads, g = ell_train_run(torch, ef.ell_gat_fused_train, kw,
                                      dmask=dmask)
        torch.cuda.synchronize()
        launched = ef.bwd_launches - n0
        ref, rgrads, _ = ell_train_run(torch, ef.ell_gat_reference, kw, g,
                                       dmask=dmask)
        name, tol = "C'", GRAD_TOL["float32"]
        fwd = ((out - ref).abs() / (1 + ref.abs())).max().item()
        fwd_ok = fwd <= TOL["float32"]
    else:
        dims = dict(k=KNN_K, heads=WIDE_HEADS, n=WIDE_N,
                    t=banded.spill_dst_local_b.shape[0],
                    s_max=banded.spill_dst_local_b.shape[2])
        masks = v2_masks(torch, dims, dev, SEED + 69)
        n0 = eb.v2_bwd_launches
        out, grads, g = v2_run(torch, eb.ell_gat_fused_v2, kw, banded,
                               masks=masks)
        torch.cuda.synchronize()
        launched = eb.v2_bwd_launches - n0
        ref, rgrads, _ = v2_run(torch, eb.fused_v2_reference, kw, banded, g,
                                masks)
        name, tol = "D'", BAND_GRAD_TOL
        fwd = ((out - ref).abs().max() / (ref.abs().max() + 1e-12)).item()
        fwd_ok = fwd <= BAND_FWD_TOL
    ok, parts, worst = fwd_ok and launched == 1, [], 0.0
    for nm, a in grads.items():
        r = rgrads[nm]
        scale = r.abs().max().item() + 1e-12
        e = (a - r).abs().max().item()
        worst = max(worst, e)
        parts.append(f"{nm} {e / scale:.2e}")
        ok = ok and e <= tol * scale and bool(torch.isfinite(a).all())
    log(f"[{tag}] {name} at a wide row, HC {WIDE_HEADS * WIDE_C} "
        f"({WIDE_HEADS} x {WIDE_C}, f32, column tiles), N={WIDE_N} K={KNN_K}, "
        f"streamed mask: forward err {fwd:.2e}; {name} err/scale "
        f"{', '.join(parts)} (tol {tol:.0e}); launches {launched} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} at HC {WIDE_HEADS * WIDE_C} disagrees with its plain "
              "version")
    return worst


def fa_inputs(torch, kw):
    """The source of each live slot (padded destinations excluded), in
    slot order, and the live-slot mask [N, K]."""
    live = kw["nbr_mask"] & kw["node_mask"][:, None]
    return kw["nbr_src"][live].int(), live


def fa_tables(torch, src, n):
    """Source-sorted tables (stable) over the rows of a [S, F] cotangent
    whose row s belongs to source src[s]: mode (a)'s perm and row_ptr."""
    perm = torch.sort(src.long(), stable=True).indices.int()
    row_ptr = torch.searchsorted(src.long()[perm.long()],
                                 torch.arange(n + 1, device=src.device)).int()
    return perm, row_ptr


# -- phase 3d: k-NN training end to end -----------------------------------------

def plain_ell_train(ef):
    """ell_gat_fused_train with every GAT layer on its plain version."""
    def plain(*args, dmask=None, drop_seed=None, keep_prob=1.0,
              slot_tables=None, **kw):
        check(drop_seed is None, "plain layer given an in-kernel seed")
        return ef.ell_gat_reference(*args, dmask=dmask, **kw)
    return plain


def phase_knn_train_end_to_end(torch, np, work):
    """cli.train --trainer graph --knn-k 8 on a synthetic KNN_TRAIN_SURVEY^2
    survey with 5 % holes (default width, tile 256, batch 4, 1 epoch), the
    launch counts read around the run and the plain versions watched;
    then NativeVRProcessor serves the checkpoint it wrote."""
    import json
    import shutil

    from bathymetric_gnn_tpu_torch.cli import train as tcli
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.data.tiling import TileManager
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.utils.weights import load_state_dict

    depth, _ = knn_survey(np, KNN_TRAIN_SURVEY, SEED + 70)
    data = work / "knn_train_data"
    data.mkdir(parents=True, exist_ok=True)
    write_geotiff(data / "survey.tif", depth[None], pixel_scale=(1.0, 1.0),
                  origin=(500000.0, 4000000.0), nodata=float("nan"))
    n_tiles = sum(1 for _ in TileManager(TRAIN_TILE, 32, 0.3).iterate_tiles(
        depth))
    batches = n_tiles // TRAIN_BATCH
    run = work / "knn_train_run"
    shutil.rmtree(run, ignore_errors=True)
    argv = ["--trainer", "graph", "--knn-k", str(KNN_K), "--data-dir",
            str(data), "--output-dir", str(run), "--epochs", "1", "--seed",
            str(SEED)]

    plain_calls = []

    def counted(fn):
        def wrapped(*a, **k):
            plain_calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    ef.launches = ef.train_launches = ef.bwd_launches = sr.launches = 0
    with mock.patch.object(ef, "ell_gat_reference",
                           counted(ef.ell_gat_reference)), \
            mock.patch.object(sr, "segment_reduce_reference",
                              counted(sr.segment_reduce_reference)), \
            mock.patch.object(sr, "gat_rows_reference",
                              counted(sr.gat_rows_reference)):
        t0 = time.perf_counter()
        state = tcli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(fwd_train=ef.train_launches, bwd=ef.bwd_launches,
                  segment_reduce=sr.launches, fwd_infer=ef.launches)
    steps = state.step
    check(steps == batches, f"steps {steps} != {batches} batches")
    check(not plain_calls, f"plain versions ran on the training path: "
                           f"{sorted(set(plain_calls))}")
    for key in ("fwd_train", "bwd", "segment_reduce"):
        check(counts[key] == MODEL_LAYERS * steps,
              f"{key} launches {counts[key]} != {MODEL_LAYERS} x {steps}")
    # eval over the training set and the calibration pass: one forward
    # per batch each, kernel C's inference form
    check(counts["fwd_infer"] == MODEL_LAYERS * 2 * batches,
          f"inference-form launches {counts['fwd_infer']}")
    hist = json.loads((run / "history.json").read_text())
    check(all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
          f"losses {hist}")
    missing = [n for n, p in state.model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not missing, f"no finite gradient for {missing}")
    cal = json.loads((run / "best" / "calibration.json").read_text())
    check("fit_on" in cal and cal["confidence_scale"] > 0,
          f"calibration {cal}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[3d] cli.train --trainer graph --knn-k {KNN_K} on a "
        f"{KNN_TRAIN_SURVEY}^2 survey (5 % holes): {n_tiles} tiles of "
        f"{TRAIN_TILE}^2, 1 epoch, {steps} steps of {TRAIN_BATCH} in "
        f"{wall:.3f} s (with the training-stats sample, eval, calibration "
        f"and checkpoints); launches: kernel C training {counts['fwd_train']}"
        f", C' {counts['bwd']}, F {counts['segment_reduce']} (= "
        f"{MODEL_LAYERS} x {steps}), C inference {counts['fwd_infer']} (eval "
        f"+ calibration); plain versions called 0 times; train loss "
        f"{hist['train_loss']}, val loss {hist['val_loss']}; every parameter "
        f"has a finite gradient; best/calibration.json: scale "
        f"{cal['confidence_scale']:.4f} bias {cal['confidence_bias']:.4f} on "
        f"{cal['fit_on']} ({cal['fit_nodes']} cells); training loop "
        f"{metrics['tiles_per_s']} tiles/s, {metrics['edges_per_s']} edges/s "
        f"(host clock, metrics.jsonl)")

    sd, meta = load_state_dict(run / "best")
    check(meta["trained_layout"] == "coo", f"checkpoint meta {meta}")
    proc = NativeVRProcessor(sd, Config.load(run / "config.yaml"),
                             node_budget=VR_BUDGET)
    grids = make_refinements(np, 200, SEED + 71)
    n0 = ef.launches
    results = serve(proc, grids)
    torch.cuda.synchronize()
    check(len(results) == len(grids), "served grids")
    for (d, _, _), r in zip(grids, results):
        v = np.abs(d) < 1e5
        check(set(np.unique(r["classification"][v]).tolist()) <= {0, 1, 2}
              and np.isfinite(r["confidence"]).all(), "served outputs")
    check(ef.launches > n0, "serving did not launch kernel C")
    log(f"[3d] NativeVRProcessor knn_k {KNN_K} served {len(grids)} "
        f"refinement grids from {run / 'best'} ({ef.launches - n0} kernel C "
        f"launches)")
    return dict(counts=counts, steps=steps, wall=wall, depth=depth,
                tiles=n_tiles)


def knn_step_setup(torch, np, work, samples, dropout):
    """A k-NN Trainer (full width, ``dropout``, class weights 1) on the
    fixed samples, its initial state and their merged batch on the card."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training.trainer import Trainer

    cfg = Config()
    cfg.graph.knn_k = KNN_K
    cfg.model.dropout = dropout
    cfg.training.class_weights = (1.0, 1.0, 1.0)
    trainer = Trainer(cfg, samples, output_dir=str(work / "knn_step"))
    state = trainer.init_state(samples[0].graph)
    g, targets, _ = knn_train_batch(torch, np, trainer.device, samples)
    return trainer, state, g, targets


def knn_step_f64(torch, trainer, model, snapshot, g, targets):
    """(loss, gradients in f64, clip factor) of the k-NN train step at
    ``snapshot`` in f64: a copy of the model, the graph's float fields and
    the targets in f64, every GAT layer on its plain version, and
    ``torch.float32`` read as float64 while the step runs, so that the
    port's own casts (the extractor's input, the backbone's output, the
    masked BatchNorm's f32 path, the plain layer's compute type) compute in
    f64 as well; the gradients clipped to the global norm as the step
    clips its own (``train_step``). No kernel launches."""
    import copy
    import dataclasses

    from bathymetric_gnn_tpu_torch.models.conv_ell import GATConvEllBanded
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    f64 = torch.float64
    m64 = copy.deepcopy(model)
    m64.load_state_dict(snapshot)
    m64 = m64.to(f64)
    for m in m64.modules():
        if isinstance(m, GATConvEllBanded):
            m.cd = f64
    g64 = dataclasses.replace(g, **{
        f: getattr(g, f).to(f64) for f in ("x", "edge_attr", "local_std")})
    t64 = {k: v.to(f64) if v.is_floating_point() else v
           for k, v in targets.items()}
    n0 = (ef.launches, sr.launches)
    with mock.patch.object(ef, "ell_gat_fused_train", plain_ell_train(ef)), \
            mock.patch.object(torch, "float32", f64):
        losses, _ = trainer.loss_fn(m64, g64, t64, train=True)
        losses["total"].backward()
    check((ef.launches, sr.launches) == n0, "[3d] the f64 step launched a "
          "kernel")
    grads = {n: p.grad for n, p in m64.named_parameters()}
    check(losses["total"].dtype == f64
          and all(v.dtype == f64 for v in grads.values()),
          "[3d] the f64 step is not in f64")
    norm = float(torch.sqrt(sum(v.square().sum() for v in grads.values())))
    max_norm = trainer.config.training.grad_clip_norm
    clip = 1.0 if norm < max_norm else max_norm / norm
    return (float(losses["total"].detach()),
            {n: v * clip for n, v in grads.items()}, clip)


def step_with_lin_src(torch, model, ef, step):
    """``step()`` (a k-NN train step) with each GAT layer's input x and the
    cotangent d xh of its xh captured: lin_src reaches the loss only
    through xh = x @ lin_src, so its gradient is x^T d xh. Returns
    (step's result, {lin_src name: (x, d xh)})."""
    from bathymetric_gnn_tpu_torch.models.conv_ell import GATConvEllBanded

    convs = [n for n, m in model.named_modules()
             if isinstance(m, GATConvEllBanded)]
    xs, dxhs = [], []
    hooks = [model.get_submodule(n).register_forward_pre_hook(
        lambda mod, args: xs.append(args[1].detach())) for n in convs]
    layer = ef.ell_gat_fused_train

    def capture(xh, *a, **k):
        i = len(dxhs)
        dxhs.append(None)
        xh.register_hook(lambda d: dxhs.__setitem__(i, d.detach()))
        return layer(xh, *a, **k)

    try:
        with mock.patch.object(ef, "ell_gat_fused_train", capture):
            out = step()
    finally:
        for h in hooks:
            h.remove()
    check(len(xs) == len(dxhs) == len(convs) == MODEL_LAYERS
          and all(d is not None for d in dxhs), "[3d] lin_src capture")
    return out, {f"{n}.lin_src": (x, d) for n, x, d in zip(convs, xs, dxhs)}


def planted_dxh(torch, dxh, share, factor, seed):
    """d xh with the rows of a seeded ``share`` of its nodes times
    ``factor`` (0: dropped): a C' fault to hold 3d's measure against."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.rand(dxh.shape[0], generator=gen).to(dxh.device) < share
    return torch.where(rows[:, None], dxh * factor, dxh)


def phase_knn_step_kernel_vs_plain(torch, np, work, samples):
    """One k-NN train step (dropout 0, full width, N = 262,144) through
    kernels C, C' and F vs the same step with every GAT layer on its plain
    version, both on the card: the loss within 1e-4 relative; every
    gradient within 1e-3 of its leaf's largest |entry| (the GAT biases,
    whose true gradient under a batch-statistics BatchNorm is ~0: of the
    largest gradient of all), as phase 3b holds the grid step; every
    parameter after the step within 1e-4 of its leaf's largest |entry|.
    Each GAT layer's ``lin_src`` is held as 3j holds its leaves, against
    the step in f64 (``knn_step_f64``): the kernels' error no more than
    the plain f32 step's own plus 1e-3 of the leaf's largest |entry|. Its
    gradient x^T d xh sums over all 262,144 nodes and cancels, so the two
    f32 steps alone differ by ~1e-3 of that |entry| (printed). The measure
    is shown to see a C' fault: the kernels' gradient with d xh dropped on
    1 % of the nodes must fail it (d xh times 1.01 on 5 % is printed).
    Adam's first step moves each element by LR x g / (|g| + eps): where
    the element's gradient is within 100 x eps of 0, or the two gradients
    differ by more than a tenth of it (f32 noise on a ~0 gradient), that
    move is decided by the noise, so those elements are held within
    2 x LR instead."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.training.optim import AdamW

    trainer, state, g, targets = knn_step_setup(torch, np, work, samples,
                                                dropout=0.0)
    model = state.model
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def step():
        model.load_state_dict(snapshot)
        state.optimizer = AdamW(model.parameters(),
                                trainer.config.training.weight_decay)
        losses, _ = trainer.train_step(state, g, targets, LR)
        return (float(losses["total"]),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    (lk, gk, pk), cap = step_with_lin_src(torch, model, ef, step)
    with mock.patch.object(ef, "ell_gat_fused_train", plain_ell_train(ef)):
        lp, gp, pp = step()
    torch.cuda.empty_cache()
    l64, g64, clip = knn_step_f64(torch, trainer, model, snapshot, g,
                                  targets)
    torch.cuda.empty_cache()
    big = max(r.abs().max().item() for r in gp.values())
    worst_g = worst = 0.0
    lin_err = {}
    n_ill = 0
    for name, r in pp.items():
        if name in cap:
            ref = g64[name]
            scale = ref.abs().max().item()

            def err(got):
                return (got.double() - ref).abs().max().item() / scale

            def planted(share, factor, seed):
                # the kernels' gradient with d xh so changed, as the step
                # would clip it
                x, d = cap[name]
                return err(gk[name].double() + clip * (
                    x.double().t() @ (planted_dxh(torch, d, share, factor,
                                                  seed) - d).double()))

            e = dict(k=err(gk[name]), p=err(gp[name]),
                     f32=(gk[name] - gp[name]).abs().max().item() / scale,
                     drop=planted(0.01, 0.0, SEED + 100),
                     scaled=planted(0.05, 1.01, SEED + 101))
            lin_err[name] = e
            check(e["k"] <= e["p"] + 1e-3, f"[3d] gradient {name}: kernels "
                  f"{e['k']:.3e}, plain {e['p']:.3e} of scale against f64 "
                  f"(tol plain + 1e-3)")
            check(e["drop"] > e["p"] + 1e-3, f"[3d] {name}: d xh dropped "
                  f"on 1 % of the nodes reads {e['drop']:.3e}, within the "
                  f"tolerance")
        else:
            gscale = (big if "GATConv" in name and name.endswith(".bias")
                      else gp[name].abs().max().item() + 1e-12)
            eg = (gk[name] - gp[name]).abs().max().item() / gscale
            worst_g = max(worst_g, eg)
            check(eg <= 1e-3, f"gradient {name}: {eg:.3e} of scale")
        ill = (((gk[name] - gp[name]).abs() > 0.1 * gp[name].abs())
               | (gp[name].abs() < 100 * state.optimizer.eps))
        n_ill += int(ill.sum())
        d = (pk[name] - r).abs()
        scale = r.abs().max().item() + 1e-12
        check(bool((d[ill] <= 2.02 * LR).all()), f"noise moves {name}")
        e = d[~ill].max().item() / scale if bool((~ill).any()) else 0.0
        worst = max(worst, e)
        check(e <= 1e-4, f"parameter {name} after the step: {e:.3e} of "
                         f"scale")
    del cap
    rel = abs(lk - lp) / abs(lp)
    log(f"[3d] one k-NN train step, kernels vs plain on the card (dropout "
        f"0, N={g.x.shape[0]}): loss {lk:.6f} vs {lp:.6f} (rel {rel:.2e}, "
        f"tol 1e-4; f64 {l64:.6f}); {len(pp) - len(lin_err)} gradients "
        f"agree, worst {worst_g:.3e} of scale (tol 1e-3); parameters after "
        f"the step agree, worst {worst:.3e} of scale (tol 1e-4), {n_ill} "
        f"elements with a noise-decided Adam move within 2 x LR")
    log("[3d] lin_src against the step in f64 (clipped as the step, factor "
        f"{clip:.6f}), of its largest |entry|: kernels / plain f32 (tol "
        "plain + 1e-3), then kernels vs plain in f32, and the kernels with "
        "d xh dropped on 1 % / times 1.01 on 5 % of the nodes: " + "; ".join(
            f"{k.split('.')[-2]} {e['k']:.3e} / {e['p']:.3e} "
            f"({e['f32']:.3e}; planted {e['drop']:.3e} / {e['scaled']:.3e})"
            for k, e in sorted(lin_err.items())))
    check(rel <= 1e-4, f"step loss {lk} vs {lp}")


# -- phase 4d: k-NN training timings ----------------------------------------------

def knn_train_bounds(dims, dtype="float32"):
    """Least time of one call (bytes over 3.35 TB/s vs operations over the
    FP32 peak), counting this graph's live data: ln live nodes, le live
    slots. C (training form): as ``ell_bound``, the draw made in the
    kernel. C' whole call ("Cw", the call the main path makes: dots,
    destination pass, F (b)): reads xh and dy rows, el_self of the live
    nodes, el, nbr_src and perm of the live slots, nbr_mask of the live
    nodes' slots, row_ptr, node_mask and att; writes d el (dl) for the
    live nodes' slots, dxh and d el_self over all N (zeros at padded
    rows); operations: the attention dots, the softmax recompute, a dot
    product and an axpy of C per live slot and head (P and d att_src), the
    d att_dst and d bias sums, the destination-side rows and F (b)'s 4 per
    live slot and column. C' destination pass alone ("Cp", an info line):
    the same reads but perm and row_ptr; writes alpha and dl for the live
    nodes' slots, d el_self and the destination side's three scalars per
    node and head over all N. F mode (b) alone: reads alpha, dl and perm
    of the live slots, row_ptr, the dy rows once and att_src, writes out
    [N, HC]; 4 operations per live slot and column. F mode (a): reads the
    [S, HC] cotangent (S = live slots), perm and row_ptr, writes out; one
    add per element read. In bfloat16 the xh, dy, att, dxh and cotangent
    streams take 2 bytes an element (F (b) alone is f32 only)."""
    n, k, h, hc = dims["n"], dims["k"], dims["heads"], dims["hc"]
    ln, le = dims["live_nodes"], dims["live_edges"]
    s = 4 if dtype == "float32" else 2
    out = {"C": ell_bound(dims, dtype)}
    parts = {
        "Cw": (s * (2 * ln * hc + 2 * hc + n * hc)
               + 4 * (ln * h + le * h + le + ln * k * h + n * h + le + n
                      + 1) + ln * k + n,
               4 * ln * hc + 8 * (le + ln) * h + 4 * (le + ln) * hc
               + 8 * ln * hc + 4 * le * hc),
        "Cp": (s * (2 * ln * hc + 2 * hc)
               + 4 * (ln * h + le * h + le + 2 * ln * k * h + 4 * n * h)
               + ln * k + n,
               4 * ln * hc + 8 * (le + ln) * h + 4 * (le + ln) * hc
               + 3 * ln * hc),
        "Fb": (4 * (2 * le * h + le + n + 1 + ln * hc + hc + n * hc),
               4 * le * hc),
        "Fa": (s * le * hc + 4 * (le + n + 1 + n * hc), le * hc),
    }
    for name, (nbytes, flops) in parts.items():
        t_b = nbytes / PEAK_BYTES * 1e3
        t_o = flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                     nbytes, flops)
    return out


def phase_knn_train_timings(torch, np, cases, work, samples):
    """CUDA-event times of kernel C's training form (Philox draw), C''s
    whole call (with F (b), as the main path makes it) and its destination
    pass alone, F's mode (b) alone and mode (a) (index_add_ beside it)
    per shape against their bounds and plain versions; then the k-NN train
    step on one fixed merged batch: ms per step, the device's busy share
    under torch.profiler and the top device operations."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    rows = []
    for i, (label, kw, (perm, row_ptr), dims) in enumerate(cases):
        dev = kw["xh"].device
        n, k, heads, hc = dims["n"], dims["k"], dims["heads"], dims["hc"]
        seed = torch.tensor([SEED + 80 + i], dtype=torch.int64, device=dev)
        args = ef.kernel_args(**kw, drop_seed=seed, keep_prob=KEEP,
                              train=True)
        bkw = {nm: args[nm] for nm in (
            "xh", "att", "nbr", "nmask", "el", "el_self", "node_mask",
            "dmask", "seed", "n", "k", "heads", "c", "negative_slope",
            "has_self", "drop_mode", "thresh", "keep_inv", "dtype")}
        p32, r32 = perm.int().contiguous(), row_ptr.int().contiguous()
        g = torch.randn(n, hc, generator=torch.Generator().manual_seed(
            SEED + 81)).to(dev)
        c_ms = cuda_ms(torch, lambda: ef.call_kernel(**args), 10)
        cp_ms = cuda_ms(torch, lambda: ef.call_bwd_kernel(
            **bkw, perm=p32, row_ptr=r32, g=g, source_side=False), 10)
        call_ms = cuda_ms(torch, lambda: ef.call_bwd_kernel(
            **bkw, perm=p32, row_ptr=r32, g=g), 10)
        _, alpha, dl, _, _ = ef.call_bwd_kernel(**bkw, perm=p32, row_ptr=r32,
                                                g=g)
        att_src = kw["att_src"]
        fb_ms = cuda_ms(torch, lambda: sr.call_gat_rows_kernel(
            alpha, dl, g, att_src, p32, r32, n, k), 10)
        mask = ef.drop_mask(seed, KEEP, n, k, heads)
        with torch.no_grad():
            pc_ms = cuda_ms(torch, lambda: ef.ell_gat_reference(
                **kw, dmask=mask), 3, warmup=1)
            pfb_ms = cuda_ms(torch, lambda: sr.gat_rows_reference(
                alpha, dl, g, att_src, perm, row_ptr, n, k), 3, warmup=1)
        leaves = {nm: kw[nm].detach().clone().requires_grad_()
                  for nm in ELL_LEAVES}
        ref = ef.ell_gat_reference(**{**kw, **leaves}, dmask=mask)
        pcp_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref, list(leaves.values()), g, retain_graph=True), 3, warmup=1)
        del ref, leaves
        src, _ = fa_inputs(torch, kw)
        ct = torch.randn(src.numel(), hc, generator=torch.Generator(
            ).manual_seed(SEED + 82)).to(dev)
        pa, ra = fa_tables(torch, src, n)
        srcl = src.long()
        fa_ms = cuda_ms(torch, lambda: sr.call_kernel(ct, pa, ra, n), 10)
        lib_ms = cuda_ms(torch, lambda: torch.zeros(n, hc, device=dev
                                                    ).index_add_(0, srcl, ct),
                         10)
        pfa_ms = cuda_ms(torch, lambda: sr.segment_reduce_reference(
            ct, pa, ra, n), 3, warmup=1)
        bd = knn_train_bounds(dims)
        row = dict(shape=label, c_ms=c_ms, c_plain_ms=pc_ms,
                   c_bound_ms=bd["C"][0], c_bound_by=bd["C"][1],
                   cp_ms=cp_ms, cp_call_with_f_ms=call_ms,
                   cp_plain_ms=pcp_ms, cp_bound_ms=bd["Cp"][0],
                   cp_bound_by=bd["Cp"][1], cw_bound_ms=bd["Cw"][0],
                   cw_bound_by=bd["Cw"][1], fb_ms=fb_ms, fb_plain_ms=pfb_ms,
                   fb_bound_ms=bd["Fb"][0], fb_bound_by=bd["Fb"][1],
                   fa_ms=fa_ms, fa_plain_ms=pfa_ms, fa_library_ms=lib_ms,
                   fa_bound_ms=bd["Fa"][0], fa_bound_by=bd["Fa"][1],
                   **{f"{nm}_bytes": bd[nm][2] for nm in bd},
                   **{f"{nm}_flops": bd[nm][3] for nm in bd})
        rows.append(row)
        log(f"[4d] {label}: C training {c_ms:.4f} ms (plain {pc_ms:.4f}, "
            f"bound {bd['C'][0]:.4f} by {bd['C'][1]}, {bd['C'][0] / c_ms:.3f}"
            f" of bound); C' whole call (+ F (b)) {call_ms:.4f} ms (plain "
            f"autograd backward {pcp_ms:.4f}; bound {bd['Cw'][0]:.4f} by "
            f"{bd['Cw'][1]}, {bd['Cw'][2] / 1e6:.1f} MB, "
            f"{bd['Cw'][0] / call_ms:.3f} of bound); info: its destination "
            f"pass alone {cp_ms:.4f} ms (bound {bd['Cp'][0]:.4f} by "
            f"{bd['Cp'][1]}, {bd['Cp'][0] / cp_ms:.3f} of bound); F (b) {fb_ms:.4f} ms "
            f"(plain {pfb_ms:.4f}, bound {bd['Fb'][0]:.4f} by "
            f"{bd['Fb'][1]}, {bd['Fb'][0] / fb_ms:.3f} of bound); F (a) over "
            f"{src.numel()} x {hc} {fa_ms:.4f} ms (index_add_ {lib_ms:.4f}, "
            f"plain {pfa_ms:.4f}, bound {bd['Fa'][0]:.4f} by {bd['Fa'][1]})")
        del args, bkw, g, alpha, dl, mask, ct, pa, ra, src, srcl

    trainer, state, g, targets = knn_step_setup(torch, np, work, samples,
                                                dropout=1.0 - KEEP)
    fn = lambda: trainer.train_step(state, g, targets, LR)  # noqa: E731
    ms = cuda_ms(torch, fn, 5, warmup=2)
    t0 = time.perf_counter()
    for _ in range(5):
        losses, _ = fn()
    float(losses["total"])
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    check(bool(torch.isfinite(losses["total"])), "k-NN step loss")
    n = g.x.shape[0]
    log(f"[4d] k-NN train step (merged batch of {TRAIN_BATCH} tiles, N={n}, "
        f"full width, dropout {1 - KEEP:.1f}, f32, batch on the card): "
        f"{ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host clock, ending "
        f"in a sync)")
    wall, prows = device_profile(torch, lambda: [fn() for _ in range(3)])
    busy = log_profile("4d", "3 k-NN train steps", wall, prows, top=14)
    dots_names = ("ellgat::dots_kernel", "rows::node_dots_kernel")
    names = ("aggregate_kernel", "::bwd_kernel", "segred::gat_src_kernel",
             "segred::sum_rows_kernel", "drop_mask_kernel") + dots_names
    mine = sum(r[0] for r in prows if any(x in r[2] for x in names))
    dots_n = sum(r[1] for r in prows if any(x in r[2] for x in dots_names))
    dots_ms = sum(r[0] for r in prows if any(x in r[2] for x in dots_names))
    log(f"[4d]   kernels C, C' and F: {mine / 3:.3f} ms per step of "
        f"{sum(r[0] for r in prows) / 3:.3f} ms device time; the attention "
        f"dots (C's and C''s dots kernels): {dots_n / 3:.1f} launches, "
        f"{dots_ms / 3:.3f} ms per step")
    return rows, dict(ms=ms, host_ms=host_ms, busy_share=busy,
                      kernels_ms=mine / 3,
                      device_ms=sum(r[0] for r in prows) / 3,
                      dots_launches=dots_n / 3, dots_ms=dots_ms / 3)


# -- phase 2e: kernels E, D and D' (the banded-ELL routes) ---------------------

BAND_ROWS = 128
# kernel vs plain version on the card, against the largest |entry| of the
# plain result: forward 1e-5 (the same f32 operations summed in another
# order); gradients 1e-4 of each gradient's scale (sums over slots and
# over the d acat partials in another order)
BAND_FWD_TOL = 1e-5
BAND_GRAD_TOL = 1e-4
V2_LEAVES = ("xh", "a_src", "a_dst", "a_cat_mat", "el_t", "el_self_t",
             "m_edge")


def band_cases(torch, np, model, dev, g, seed):
    """(label, layer inputs, banded, dims) for kernels E, D and D' on g (an
    ELL graph on the card) split into BAND_ROWS-row bands by band_ell on
    the host: the mid layer (HC 256 / 4 heads) and the last (HC 64 /
    1 head) of ``model`` on a random x, their inputs built as the layer
    builds them (``GATConvEllBanded.banded_inputs``)."""
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell

    banded = band_ell(g.to("cpu"), band_rows=BAND_ROWS).to(dev)
    gen = torch.Generator().manual_seed(seed)
    mask = g.node_mask
    n, k = g.nbr_src.shape
    t_count, _, s_max = banded.spill_dst_local_b.shape
    dims = dict(n=n, k=k, r=BAND_ROWS, t=t_count, s_max=s_max,
                live_nodes=int(mask.sum().item()),
                in_band=int(((banded.loc_t >= 0) & mask[None, :]).sum()
                            .item()),
                spills=int((banded.spill_dst_local_b >= 0).sum().item()))
    out = []
    for li, label in ((1, "mid 256->256 h4"),
                      (MODEL_LAYERS - 1, "last 256->64 h1")):
        conv = getattr(model.GNNBackbone_0, f"GATConv_{li}")
        with torch.no_grad():
            x = torch.randn(n, conv.lin_src.shape[0],
                            generator=gen).to(dev) * mask[:, None]
            kw = conv.banded_inputs(g, banded, x)
        d = dict(dims, heads=conv.heads, hc=conv.heads * conv.out_channels)
        out.append((f"{label} N={n} K={k} R={BAND_ROWS} f32", kw, banded, d))
    return out


def v2_run(torch, fn, kw, banded, g=None, masks=None):
    """fn(**kw) (ell_gat_fused_v2 or its plain version) and the gradients
    of <out, g> with respect to the layer inputs; g drawn when not
    given."""
    leaves = {n: kw[n].detach().clone().requires_grad_()
              for n in V2_LEAVES if kw.get(n) is not None}
    out = fn(**{**kw, **leaves}, banded=banded, dropout_masks=masks)
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            SEED + 92)).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, list(leaves.values()), g)
    return out.detach(), dict(zip(leaves, grads)), g


def v2_masks(torch, dims, dev, seed):
    """Streamed dropout multipliers (keep KEEP) in kernel D's layout:
    ([(K+1) * heads, N], [T, heads, S])."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = (((dims["k"] + 1) * dims["heads"], dims["n"]),
              (dims["t"], dims["heads"], dims["s_max"]))
    return tuple((torch.rand(sh, generator=gen, device=dev) < KEEP).float()
                 / KEEP for sh in shapes)


def phase_banded_kernels_vs_plain(torch, ecases, dcases):
    """Kernel E at the serving flush's shapes, kernels D and D' (with F's
    mode (a) behind D's three spill gathers) at the k-NN training batch's,
    with no dropout and a streamed mask, against their plain versions."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    errs = {}
    with torch.no_grad():
        for label, kw, banded, dims in ecases:
            args = (kw["xh"], kw["a_cat_mat"], kw["el_t"], kw["el_self_t"],
                    banded)
            got = eb.ell_gat_band_part(*args)
            torch.cuda.synchronize()
            ref = eb.band_part_reference(*args)
            torch.cuda.synchronize()
            ok, parts, worst = True, [], {}
            for name, a, b in zip(("y", "m", "denom"), got, ref):
                scale = b.abs().max().item() + 1e-12
                e = (a - b).abs().max().item()
                worst[name] = e
                parts.append(f"{name} {e / scale:.2e}")
                ok = ok and e <= BAND_FWD_TOL * scale and bool(
                    torch.isfinite(a).all())
            log(f"[2e] E {label}: {dims['live_nodes']} live nodes, "
                f"{dims['in_band']} in-band slots, {dims['spills']} spills; "
                f"err/scale {', '.join(parts)} (tol {BAND_FWD_TOL:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel E disagrees with its plain version: {label}")
            errs[("E", label)] = worst["y"]
            del got, ref
    for i, (label, kw, banded, dims) in enumerate(dcases):
        g = None
        worst = {"out": 0.0}
        for mode, masks in (("no dropout", None), ("streamed mask",
                                                   v2_masks(torch, dims,
                                                            kw["xh"].device,
                                                            SEED + 93 + i))):
            n0 = sr.launches
            out, grads, g = v2_run(torch, eb.ell_gat_fused_v2, kw, banded, g,
                                   masks)
            torch.cuda.synchronize()
            f_a = sr.launches - n0
            ref, rgrads, _ = v2_run(torch, eb.fused_v2_reference, kw, banded,
                                    g, masks)
            torch.cuda.synchronize()
            scale = ref.abs().max().item() + 1e-12
            e = (out - ref).abs().max().item()
            worst["out"] = max(worst["out"], e)
            ok = e <= BAND_FWD_TOL * scale and bool(torch.isfinite(out).all())
            parts = []
            for name, a in grads.items():
                r = rgrads[name]
                gs = r.abs().max().item() + 1e-12
                ge = (a - r).abs().max().item()
                worst[name] = max(worst.get(name, 0.0), ge)
                parts.append(f"{name} {ge / gs:.2e}")
                ok = ok and ge <= BAND_GRAD_TOL * gs and bool(
                    torch.isfinite(a).all())
            ok = ok and f_a == 3
            log(f"[2e] D/D' {label}, {mode}: {dims['live_nodes']} live "
                f"nodes, {dims['in_band']} in-band slots, {dims['spills']} "
                f"spills (S {dims['s_max']}); D err/scale {e / scale:.2e} "
                f"(tol {BAND_FWD_TOL:.0e}); D' err/scale: {', '.join(parts)} "
                f"(tol {BAND_GRAD_TOL:.0e}); F (a) launches in the backward "
                f"{f_a} (want 3) {'ok' if ok else 'FAIL'}")
            check(ok, f"D / D' disagree with the plain version: {label}, "
                      f"{mode}")
            del out, grads, ref, rgrads
        errs[("D", label)] = worst["out"]
        errs[("Dp", label)] = max(v for n_, v in worst.items() if n_ != "out")
        same_bwd, same_dots = saved_dots_bits(torch, kw, banded)
        log(f"[2e] {label}: D' given D's dots "
            f"{'equals' if same_bwd else 'DIFFERS FROM'} D' computing its "
            f"own, bit for bit; D's dots "
            f"{'equal' if same_dots else 'DIFFER FROM'} the generic "
            f"mat_dots_kernel's, bit for bit")
        check(same_bwd and same_dots, f"D's dots bits: {label}")
    return errs


def v2_kernel_args(torch, kw, banded, dtype=None):
    """kernel_args of kernels D and D' (with the spill tables) on a band
    case's layer inputs, xh in ``dtype`` (its own when None), and D''s
    keyword arguments (those of D without vec, with the in-band source
    tables)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    xh = kw["xh"] if dtype is None else kw["xh"].to(dtype)
    n, heads, c = xh.shape
    with torch.no_grad():
        l_spill, xh_spill = eb._spill_inputs(
            xh.reshape(n, heads * c), kw["a_src"], kw["a_dst"], kw["m_edge"],
            banded, 0.2, eb._plain_gather)
        kargs = eb.kernel_args(
            xh.reshape(n, heads * c), kw["a_cat_mat"], banded.loc_t,
            kw["el_t"], kw["el_self_t"], l_spill, xh_spill,
            banded.spill_dst_local_b, band_rows=banded.band_rows,
            spill_perm_d=banded.spill_perm_d,
            spill_row_ptr_d=banded.spill_row_ptr_d)
    bkw = {nm: v for nm, v in kargs.items() if nm != "vec"}
    bkw.update(perm=banded.band_perm.int().contiguous(),
               row_ptr=banded.band_row_ptr.int().contiguous())
    return kargs, bkw


def saved_dots_bits(torch, kw, banded):
    """(D' given the dots kernel D wrote returns what D' computing its own
    returns, bit for bit; those dots are the generic mat_dots_kernel's,
    bit for bit) on one band case, NaN counted equal to itself."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    kargs, bkw = v2_kernel_args(torch, kw, banded)
    n, heads = kargs["n"], kargs["heads"]
    g = torch.randn(n, heads * kargs["c"], generator=torch.Generator(
        ).manual_seed(SEED + 95)).to(kargs["xh"].device, kargs["xh"].dtype)
    ac = torch.empty(n, 2 * heads, device=g.device)
    eb.call_v2_kernel(**kargs, ac=ac)
    given = eb.call_v2_bwd_kernel(**bkw, dout=g, ac=ac)
    own = eb.call_v2_bwd_kernel(**bkw, dout=g)
    generic = eb.mat_dots(kargs["xh"], kargs["acat"], generic=True)
    torch.cuda.synchronize()

    def same(a, b):
        ints = torch.int16 if a is not None and a.element_size() == 2 \
            else torch.int32
        return (a is None and b is None) or torch.equal(a.view(ints),
                                                        b.view(ints))
    return (all(same(a, b) for a, b in zip(given, own)),
            same(ac, generic))


# -- phase 3e: k-NN serving on the "banded" route ---------------------------------

def phase_vr_banded(torch, np, work, vr):
    """NativeVRProcessor with sparse_kernel "banded" (kernel E and the spill
    fold, band_ell per chunk on the host) on phase 3c's grids from the same
    checkpoint: E launched 4 x the chunks, kernel C and every plain version
    never; the results agree with 3c's (kernel C's route)."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.utils.weights import load_state_dict

    sd, _ = load_state_dict(work / "knn_ckpt")
    cfg = Config()
    cfg.graph.knn_k = KNN_K
    cfg.model.sparse_kernel = "banded"
    proc = NativeVRProcessor(sd, cfg, node_budget=VR_BUDGET)
    check(proc.sparse_kernel == "banded", f"sparse_kernel {proc.sparse_kernel}")
    grids = vr["grid_list"]
    n_nodes = vr["nodes"]
    serve(proc, grids[:300])            # warm-up
    torch.cuda.synchronize()
    chunks, plain_calls = [], []
    launch_chunk = proc._launch_graphs_chunk

    def counted_chunk(idx):
        chunks.append(sum(len(proc.pending[i]["rows"]) for i in idx))
        return launch_chunk(idx)

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            plain_calls.append(name)
            return fn(*a, **k)
        return mock.patch.object(mod, name, wrapped)

    eb.band_launches = eb.v2_launches = 0   # counts of the main path's run
    ef.launches = ef.train_launches = 0
    with mock.patch.object(proc, "_launch_graphs_chunk", counted_chunk), \
            counted(eb, "band_part_reference"), \
            counted(eb, "fused_v2_reference"), counted(eb, "_v2_plain"), \
            counted(ef, "ell_gat_reference"):
        t0 = time.perf_counter()
        results = serve(proc, grids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = eb.band_launches
    check(len(results) == len(grids), f"{len(results)} results")
    check(not plain_calls, f"plain versions ran on the serving path: "
                           f"{sorted(set(plain_calls))}")
    check(launches == MODEL_LAYERS * len(chunks),
          f"ell_gat_band launches {launches} != {MODEL_LAYERS} x "
          f"{len(chunks)} graph chunks")
    check(ef.launches == ef.train_launches == eb.v2_launches == 0,
          "kernels C or D launched on the banded route")
    agree = n = 0
    dconf = 0.0
    for (depth, _, _), a, b in zip(grids, results, vr["results"]):
        v = np.abs(depth) < 1e5
        check(a["classification"].shape == depth.shape
              and bool((a["classification"][~v] == -1).all())
              and all(np.isfinite(a[c]).all() for c in ("confidence",
                                                        "correction")),
              "banded route outputs")
        agree += int((a["classification"][v] == b["classification"][v]).sum())
        n += int(v.sum())
        dconf = max(dconf, float(np.abs(a["confidence"]
                                        - b["confidence"]).max()))
    log(f"[3e] NativeVRProcessor sparse_kernel banded, knn_k {KNN_K}, budget "
        f"{VR_BUDGET}: {len(grids)} grids, {n_nodes} nodes in {wall:.3f} s: "
        f"{len(grids) / wall:.3f} grids/s, {n_nodes / wall / 1e6:.4f} "
        f"Mnodes/s (3c, kernel C: {vr['grids'] / vr['wall']:.3f} grids/s); "
        f"{len(chunks)} graph chunks, ell_gat_band launches {launches} = "
        f"{MODEL_LAYERS} x {len(chunks)}; kernel C 0, plain versions 0; vs "
        f"kernel C's route: class agreement {agree / n:.6f}, max |d "
        f"confidence| {dconf:.3e}")
    check(agree / n >= 0.999 and dconf <= 2e-3,
          "the banded route disagrees with kernel C's")
    wall_p, prows = device_profile(torch, lambda: serve(proc, grids[:500]))
    busy = log_profile("3e", "500 refinement grids, banded", wall_p, prows,
                       top=10)
    return dict(launches=launches, chunks=len(chunks), wall=wall,
                grids=len(grids), nodes=n_nodes, busy_share=busy,
                agreement=agree / n, max_dconf=dconf)


# -- phase 4e: timings of kernels E, D and D' -------------------------------------

def band_bounds(dims, drop=False, dtype="float32"):
    """Least time of one call (bytes over 3.35 TB/s vs operations over the
    FP32 peak), counting this graph's live data: ln live nodes, lb live
    in-band slots, ls live spill entries. E reads xh and el_self of the live
    nodes, loc of their slots, el of the in-band slots and acat, and writes
    y, m and denom over all N; operations: the attention dots (4 HC a
    node), ~8 per slot and head for the softmax, 2 HC per slot and self
    loop for the weighted sum. D: as E, plus the spill rows, logits and
    rows of dst_loc read, ~8 H + 2 HC per spill, one divide per output,
    and (``drop``) the masks; out written over all N. D' (one call): reads
    xh, dout, el, loc, el_self, acat, the spill tables, the in-band
    source tables and the spill entries' destination tables; writes dxh,
    d el, d el_self, the spill cotangents over
    their full tables and d acat; operations: the dots, the softmax
    recompute, a dot product and an axpy of C per slot, self loop and
    spill and head, and the acat products of dxh and d acat (8 HC H a
    node). In bfloat16 xh, acat, the spill rows, dout, out and dxh take 2
    bytes an element (E's outputs and the spill cotangents of D' stay f32)."""
    n, k, h, hc = dims["n"], dims["k"], dims["heads"], dims["hc"]
    ln, lb, ls = dims["live_nodes"], dims["in_band"], dims["spills"]
    ts = dims["t"] * dims["s_max"]
    s = 4 if dtype == "float32" else 2
    e_in = s * (ln * hc + 2 * hc * h) + 4 * (lb * h + ln * k + ln * h)
    e_ops = 4 * ln * hc + 8 * (lb + ln) * h + 2 * (lb + ln) * hc
    masks = 4 * ((lb + ln) * h + ls * h) if drop else 0
    spill_in = ls * (s * hc + 4 * (h + 1))
    parts = {
        "E": (e_in + 4 * (n * hc + 2 * n * h), e_ops),
        "D": (e_in + spill_in + masks + s * n * hc,
              e_ops + ls * (8 * h + 2 * hc) + n * hc),
        "Dp": (e_in + s * n * hc + spill_in + 4 * (lb + ls + 2 * n + 2)
               + masks
               + s * n * hc + 4 * (k * h * n + n * h + ts * (h + hc)
                                   + 2 * hc * h),
               4 * ln * hc + 8 * (lb + ln + ls) * h
               + 4 * (lb + ln + ls) * hc + 8 * ln * hc * h),
    }
    out = {}
    for name, (nbytes, flops) in parts.items():
        t_b = nbytes / PEAK_BYTES * 1e3
        t_o = flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                     nbytes, flops)
    return out


def phase_banded_timings(torch, np, ecases, dcases, kcases, work, samples):
    """CUDA-event times of kernel E per serving shape and of kernels D and
    D' per training shape (no dropout) against their bounds and plain
    versions; the D + D' layer beside the C + C' layer on the same batch;
    then one k-NN train step of the full-width model with every layer on
    route D (``wide_kernel=False``, dropout 0.1): its launches, ms and the
    device's busy share."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell

    erows, drows = [], []
    with torch.no_grad():
        for label, kw, banded, dims in ecases:
            xh = kw["xh"]
            n, heads, c = xh.shape
            args = (xh, kw["a_cat_mat"], kw["el_t"], kw["el_self_t"], banded)
            kargs = eb.kernel_args(xh.reshape(n, heads * c), kw["a_cat_mat"],
                                   banded.loc_t, kw["el_t"], kw["el_self_t"],
                                   band_rows=banded.band_rows)
            ms = cuda_ms(torch, lambda: eb.call_band_kernel(**kargs), 20)
            plain_ms = cuda_ms(torch, lambda: eb.band_part_reference(*args),
                               5, warmup=1)
            b = band_bounds(dims)["E"]
            erows.append(dict(shape=label, ms=ms, plain_ms=plain_ms,
                              bound_ms=b[0], bound_by=b[1], bytes=b[2],
                              flops=b[3]))
            log(f"[4e] E {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b[0]:.4f} ms by {b[1]} ({b[2] / 1e6:.1f} MB, "
                f"{b[3] / 1e9:.3f} GFLOP), {b[0] / ms:.3f} of bound")
    for (label, kw, banded, dims), (_, ckw, tables, _) in zip(dcases,
                                                              kcases):
        xh = kw["xh"]
        n, heads, c = xh.shape
        with torch.no_grad():
            kargs, bkw = v2_kernel_args(torch, kw, banded)
            g = torch.randn(n, heads * c, generator=torch.Generator(
                ).manual_seed(SEED + 94)).to(xh.device)
            ac = torch.empty(n, 2 * heads, device=xh.device)
            d_ms = cuda_ms(torch, lambda: eb.call_v2_kernel(**kargs, ac=ac),
                           10)
            dp_ms = cuda_ms(torch, lambda: eb.call_v2_bwd_kernel(
                **bkw, dout=g), 10)
            dpg_ms = cuda_ms(torch, lambda: eb.call_v2_bwd_kernel(
                **bkw, dout=g, ac=ac), 10)
            pd_ms = cuda_ms(torch, lambda: eb.fused_v2_reference(
                **kw, banded=banded), 3, warmup=1)
        leaves = {nm: kw[nm].detach().clone().requires_grad_()
                  for nm in V2_LEAVES if kw.get(nm) is not None}
        ref = eb.fused_v2_reference(**{**kw, **leaves}, banded=banded)
        pdp_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref, list(leaves.values()), g, retain_graph=True), 3, warmup=1)
        del ref

        def layer_d():
            out = eb.ell_gat_fused_v2(**{**kw, **leaves}, banded=banded)
            return torch.autograd.grad(out, list(leaves.values()), g)

        cleaves = {nm: ckw[nm].detach().clone().requires_grad_()
                   for nm in ELL_LEAVES}

        def layer_c():
            out = ef.ell_gat_fused_train(**{**ckw, **cleaves},
                                         slot_tables=tables)
            return torch.autograd.grad(out, list(cleaves.values()), g)

        ld_ms = cuda_ms(torch, layer_d, 5)
        lc_ms = cuda_ms(torch, layer_c, 5)
        bd = band_bounds(dims)
        drows.append(dict(
            shape=label, d_ms=d_ms, d_plain_ms=pd_ms, d_bound_ms=bd["D"][0],
            d_bound_by=bd["D"][1], dp_ms=dpg_ms, dp_own_dots_ms=dp_ms,
            dp_plain_ms=pdp_ms, dp_bound_ms=bd["Dp"][0],
            dp_bound_by=bd["Dp"][1],
            layer_d_fwd_bwd_ms=ld_ms, layer_c_fwd_bwd_ms=lc_ms,
            **{f"{nm}_bytes": bd[nm][2] for nm in ("D", "Dp")},
            **{f"{nm}_flops": bd[nm][3] for nm in ("D", "Dp")}))
        log(f"[4e] D {label}: {d_ms:.4f} ms (plain {pd_ms:.4f}, bound "
            f"{bd['D'][0]:.4f} by {bd['D'][1]}, {bd['D'][0] / d_ms:.3f} of "
            f"bound); D' given D's dots {dpg_ms:.4f} ms, computing its own "
            f"{dp_ms:.4f} ms (plain autograd backward {pdp_ms:.4f}, bound "
            f"{bd['Dp'][0]:.4f} by {bd['Dp'][1]}, {bd['Dp'][2] / 1e6:.1f} "
            f"MB, {bd['Dp'][0] / dpg_ms:.3f} of bound); layer forward + "
            f"backward: D + D' (+ spill gathers and F (a)) {ld_ms:.4f} ms, "
            f"C + C' (+ F (b)) {lc_ms:.4f} ms")
        del kargs, bkw, g, ac, leaves, cleaves
    dots = dots_timings(torch, ecases + dcases, "4e")

    trainer, state, g, targets = knn_step_setup(torch, np, work, samples,
                                                dropout=1.0 - KEEP)
    banded = band_ell(g.to("cpu"), band_rows=BAND_ROWS).to(g.x.device)
    model = state.model
    for i in range(MODEL_LAYERS):
        getattr(model.GNNBackbone_0, f"GATConv_{i}").wide_kernel = False
    fn = lambda: trainer.train_step(state, g, targets, LR,  # noqa: E731
                                    banded)
    eb.v2_launches = eb.v2_bwd_launches = sr.launches = 0  # the main path
    ef.train_launches = ef.bwd_launches = 0
    losses, _ = fn()
    torch.cuda.synchronize()
    counts = dict(v2=eb.v2_launches, v2_bwd=eb.v2_bwd_launches,
                  segment_reduce=sr.launches,
                  c=ef.train_launches + ef.bwd_launches)
    check(bool(torch.isfinite(losses["total"])), "route D step loss")
    check(counts == dict(v2=MODEL_LAYERS, v2_bwd=MODEL_LAYERS,
                         segment_reduce=3 * MODEL_LAYERS, c=0),
          f"route D step launches {counts}")
    missing = [nm for nm, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not missing, f"no finite gradient for {missing}")
    ms = cuda_ms(torch, fn, 5, warmup=1)
    log(f"[4e] k-NN train step on route D (every layer wide_kernel=False; "
        f"merged batch N={g.x.shape[0]}, full width, dropout "
        f"{1 - KEEP:.1f}, f32): launches D {counts['v2']}, D' "
        f"{counts['v2_bwd']}, F (a) {counts['segment_reduce']}, C 0; "
        f"{ms:.3f} ms (CUDA events)")
    wall, prows = device_profile(torch, lambda: [fn() for _ in range(3)])
    busy = log_profile("4e", "3 route-D k-NN train steps", wall, prows,
                       top=14)
    names = ("v2_fwd_kernel", "v2_bwd_", "rows::mat_dots",
             "segred::sum_rows_kernel")
    mine = sum(r[0] for r in prows if any(x in r[2] for x in names))
    dots_n = sum(r[1] for r in prows if "rows::mat_dots" in r[2]) / 3
    dots_ms = sum(r[0] for r in prows if "rows::mat_dots" in r[2]) / 3
    log(f"[4e]   kernels D, D' and F (a): {mine / 3:.3f} ms per step of "
        f"{sum(r[0] for r in prows) / 3:.3f} ms device time; the attention "
        f"dots: {dots_n:.1f} launches, {dots_ms:.3f} ms per step (D's only: "
        f"D' takes them)")
    # with a profile, D' launched no dots pass of its own
    check(not prows or dots_n == MODEL_LAYERS,
          f"route D step: {dots_n} dots launches a step, want {MODEL_LAYERS}")
    return erows, drows, dict(ms=ms, busy_share=busy, counts=counts,
                              kernels_ms=mine / 3,
                              device_ms=sum(r[0] for r in prows) / 3,
                              dots_launches=dots_n, dots_ms=dots_ms), dots


def dots_timings(torch, cases, tag, dtype=None):
    """CUDA-event times of the attention dots of kernels D, D' and E alone
    (``mat_dots``: the register form, and the generic form it replaced) on
    each band case's xh (in ``dtype`` when given) and acat, beside one
    ``torch.matmul`` of the same product (f32 only: in bf16 it rounds its
    output) and their bound: xh and acat read once, ac written once, 2 HC
    M operations a node."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    out = []
    with torch.no_grad():
        for label, kw, _, dims in cases:
            xh = kw["xh"] if dtype is None else kw["xh"].to(dtype)
            n, heads, c = xh.shape
            hc, m = heads * c, 2 * heads
            xf = xh.reshape(n, hc).contiguous()
            acat = kw["a_cat_mat"].to(xf.dtype).contiguous()
            ms = cuda_ms(torch, lambda: eb.mat_dots(xf, acat), 20)
            gms = cuda_ms(torch, lambda: eb.mat_dots(xf, acat, generic=True),
                          20)
            lib = (cuda_ms(torch, lambda: torch.matmul(xf, acat), 20)
                   if xf.dtype == torch.float32 else None)
            nbytes = xf.element_size() * (n * hc + hc * m) + 4 * n * m
            flops = 2 * n * hc * m
            t_b = nbytes / PEAK_BYTES * 1e3
            t_o = flops / PEAK_FLOPS[str(xf.dtype).split(".")[1]] * 1e3
            lbl = label if dtype is None else bf16_label(label)
            out.append(dict(shape=lbl, ms=ms, generic_ms=gms, library_ms=lib,
                            bound_ms=max(t_b, t_o),
                            bound_by="bytes" if t_b >= t_o else "operations",
                            bytes=nbytes, flops=flops))
            log(f"[{tag}] mat_dots {lbl}: {ms:.4f} ms, generic form "
                f"{gms:.4f} ms, torch.matmul "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{max(t_b, t_o):.4f} ms ({nbytes / 1e6:.1f} MB), "
                f"{max(t_b, t_o) / ms:.3f} of bound")
    return out


# -- phase 2f: the bf16 forms of C, C', D, D', E and F ------------------------

def bf16_label(label):
    return label.replace(" f32", " bf16")


def bf16_kw(kw):
    """Layer inputs with xh in bf16 (the bf16 layer's x @ W)."""
    return dict(kw, xh=kw["xh"].bfloat16())


def grad_errs(torch, grads, rgrads, tol):
    """(ok, worst |d| per leaf, 'name err/scale' parts) of kernel against
    plain gradients, each against its leaf's largest |entry|."""
    ok, worst, parts = True, {}, []
    for name, a in grads.items():
        r = rgrads[name].float()
        scale = r.abs().max().item() + 1e-12
        e = (a.float() - r).abs().max().item()
        worst[name] = e
        parts.append(f"{name} {e / scale:.2e}")
        ok = ok and e <= tol * scale and bool(torch.isfinite(a).all())
    return ok, worst, parts


def phase_bf16_kernels_vs_plain(torch, ecases, kcases, becases, bdcases):
    """The bf16 forms against their plain versions on the same bf16
    inputs: kernel C (serving) and kernel E at the 65,536-node flush's
    shapes; kernel C's training form with no dropout, a streamed mask and
    the Philox draw, with C' (+ F (b)), and kernels D and D' (with F (a) on
    the bf16 spill-row cotangent) with no dropout and a streamed mask, on
    the k-NN training batch (N = 262,144). Outputs within TOL[bf16] of
    (1 + |ref|), gradients within GRAD_TOL[bf16] of each leaf's scale;
    kernel E's f32 outputs from the same bf16 inputs within BAND_FWD_TOL."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    tol, gtol = TOL["bfloat16"], GRAD_TOL["bfloat16"]
    errs = {}
    with torch.no_grad():
        for label, kw, dims in ecases[:2]:
            kb = bf16_kw(kw)
            out = ef.ell_gat_fused(**kb)
            torch.cuda.synchronize()
            ref = ef.ell_gat_reference(**kb)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            rel = (d / (1 + ref.float().abs())).max().item()
            ok = (out.dtype == torch.bfloat16 and rel <= tol
                  and bool(torch.isfinite(out).all())
                  and not bool(out[~kw["node_mask"]].float().any()))
            log(f"[2f] C {bf16_label(label)}: max_abs {d.max().item():.3e} "
                f"max_rel(1+|ref|) {rel:.3e} tol {tol:.1e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel C (bf16) disagrees: {label}")
            errs[("C", bf16_label(label))] = d.max().item()
            del out, ref
        for label, kw, banded, dims in becases:
            args = (kw["xh"].bfloat16(), kw["a_cat_mat"], kw["el_t"],
                    kw["el_self_t"], banded)
            got = eb.ell_gat_band_part(*args)
            torch.cuda.synchronize()
            ref = eb.band_part_reference(*args)
            torch.cuda.synchronize()
            ok, parts = True, []
            for name, a, b in zip(("y", "m", "denom"), got, ref):
                scale = b.abs().max().item() + 1e-12
                e = (a - b).abs().max().item()
                if name == "y":
                    errs[("E", bf16_label(label))] = e
                parts.append(f"{name} {e / scale:.2e}")
                ok = ok and a.dtype == torch.float32 and e <= (
                    BAND_FWD_TOL * scale) and bool(torch.isfinite(a).all())
            log(f"[2f] E {bf16_label(label)}: err/scale {', '.join(parts)} "
                f"(f32 outputs of the same bf16 inputs, tol "
                f"{BAND_FWD_TOL:.0e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel E (bf16) disagrees: {label}")
            del got, ref
    for i, (label, kw, (perm, row_ptr), dims) in enumerate(kcases[:2]):
        kb = bf16_kw(kw)
        dev = kb["xh"].device
        n, k, heads = dims["n"], dims["k"], dims["heads"]
        seed = torch.tensor([0x5EED100 + i], dtype=torch.int64, device=dev)
        drawn = ef.drop_mask(seed, KEEP, n, k, heads)
        gen = torch.Generator(device=dev).manual_seed(SEED + 65 + i)
        streamed = (torch.rand(n, k + 1, heads, generator=gen, device=dev)
                    < KEEP).float() / KEEP
        tables = dict(slot_tables=(perm, row_ptr))
        lbl = bf16_label(label)
        worst_out, worst_g, g = 0.0, {}, None
        for mode, extra, mult in (
                ("no dropout", {}, None),
                ("streamed mask", dict(dmask=streamed), streamed),
                ("Philox", dict(drop_seed=seed, keep_prob=KEEP), drawn)):
            out, grads, g = ell_train_run(torch, ef.ell_gat_fused_train, kb,
                                          g, **extra, **tables)
            torch.cuda.synchronize()
            ref, rgrads, _ = ell_train_run(torch, ef.ell_gat_reference, kb,
                                           g, dmask=mult)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            rel = (d / (1 + ref.float().abs())).max().item()
            ok, worst, parts = grad_errs(torch, grads, rgrads, gtol)
            ok = (ok and rel <= tol and out.dtype == torch.bfloat16
                  and grads["xh"].dtype == torch.bfloat16)
            worst_out = max(worst_out, d.max().item())
            for nm, e in worst.items():
                worst_g[nm] = max(worst_g.get(nm, 0.0), e)
            same = True
            if mode == "Philox":
                out_m, gr_m, _ = ell_train_run(torch, ef.ell_gat_fused_train,
                                               kb, g, dmask=drawn, **tables)
                same = torch.equal(out, out_m) and all(
                    torch.equal(grads[nm], gr_m[nm]) for nm in ELL_LEAVES)
            log(f"[2f] C/C' {lbl}, {mode}: C max_rel(1+|ref|) {rel:.3e} (tol "
                f"{tol:.1e}); C' err/scale: {', '.join(parts)} (tol "
                f"{gtol:.1e})"
                + ("; with the in-kernel draw "
                   + ("equal to" if same else "DIFFERENT FROM")
                   + " the same draw streamed" if mode == "Philox" else "")
                + f" {'ok' if ok and same else 'FAIL'}")
            check(ok and same, f"C / C' (bf16) disagree: {label}, {mode}")
            del out, grads, ref, rgrads
        errs[("Ct", lbl)] = worst_out
        errs[("Cp", lbl)] = max(worst_g.values())
        # kernel F, mode (a), on a bf16 cotangent of the live slots' rows
        src, _ = fa_inputs(torch, kw)
        ct = torch.randn(src.numel(), dims["hc"], generator=torch.Generator(
            ).manual_seed(SEED + 66)).to(dev).bfloat16()
        pa, ra = fa_tables(torch, src, n)
        fa = sr.segment_reduce_sorted(ct, pa, ra, n)
        fa_ref = torch.zeros(n, dims["hc"], device=dev).index_add_(
            0, src.long(), ct.float())
        d_a = (fa - fa_ref).abs()
        rel_a = (d_a / (1 + fa_ref.abs())).max().item()
        ok = fa.dtype == torch.float32 and rel_a <= TOL["float32"]
        log(f"[2f] {lbl}: F mode (a) on a bf16 {src.numel()} x {dims['hc']}"
            f" cotangent vs index_add_ of its f32 values max_rel(1+|ref|) "
            f"{rel_a:.3e} (tol {TOL['float32']:.1e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"kernel F (bf16 rows) disagrees: {label}")
        errs[("Fa", lbl)] = d_a.max().item()
        del drawn, streamed, ct, fa, fa_ref
    for i, (label, kw, banded, dims) in enumerate(bdcases):
        kb = bf16_kw(kw)
        lbl = bf16_label(label)
        g = None
        worst = {"out": 0.0}
        for mode, masks in (("no dropout", None),
                            ("streamed mask", v2_masks(torch, dims,
                                                       kb["xh"].device,
                                                       SEED + 96 + i))):
            n0 = sr.launches
            out, grads, g = v2_run(torch, eb.ell_gat_fused_v2, kb, banded, g,
                                   masks)
            torch.cuda.synchronize()
            f_a = sr.launches - n0
            ref, rgrads, _ = v2_run(torch, eb.fused_v2_reference, kb, banded,
                                    g, masks)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            rel = (d / (1 + ref.float().abs())).max().item()
            ok, gw, parts = grad_errs(torch, grads, rgrads, gtol)
            ok = (ok and rel <= tol and f_a == 3
                  and out.dtype == grads["xh"].dtype == torch.bfloat16)
            worst["out"] = max(worst["out"], d.max().item())
            for nm, e in gw.items():
                worst[nm] = max(worst.get(nm, 0.0), e)
            log(f"[2f] D/D' {lbl}, {mode}: D max_rel(1+|ref|) {rel:.3e} (tol "
                f"{tol:.1e}); D' err/scale: {', '.join(parts)} (tol "
                f"{gtol:.1e}); F (a) launches in the backward {f_a} (want 3, "
                f"one on the bf16 spill rows) {'ok' if ok else 'FAIL'}")
            check(ok, f"D / D' (bf16) disagree: {label}, {mode}")
            del out, grads, ref, rgrads
        errs[("D", lbl)] = worst["out"]
        errs[("Dp", lbl)] = max(v for nm, v in worst.items() if nm != "out")
        same_bwd, same_dots = saved_dots_bits(torch, kb, banded)
        log(f"[2f] {lbl}: D' given D's dots "
            f"{'equals' if same_bwd else 'DIFFERS FROM'} D' computing its "
            f"own, bit for bit; D's dots "
            f"{'equal' if same_dots else 'DIFFER FROM'} the generic "
            f"mat_dots_kernel's, bit for bit")
        check(same_bwd and same_dots, f"D's dots bits (bf16): {label}")
    return errs


# -- phase 3f: the bf16 model -------------------------------------------------

BF16_ROUTES = (("C", "banded_pallas", True), ("D", "banded_pallas", False),
               ("E", "banded", True))


def routed_model(torch, kmodel, sparse_kernel, wide, dtype):
    """The k-NN serving model's weights in an EllBathymetricGNN on one
    route (``wide_kernel`` set on every layer) and compute dtype, eval."""
    from bathymetric_gnn_tpu_torch.models.gnn_ell import EllBathymetricGNN

    m = EllBathymetricGNN(8, 64, MODEL_LAYERS, heads=4,
                          sparse_kernel=sparse_kernel, compute_dtype=dtype)
    m.load_state_dict(kmodel.state_dict())
    for i in range(MODEL_LAYERS):
        getattr(m.GNNBackbone_0, f"GATConv_{i}").wide_kernel = wide
    return m.to(next(kmodel.parameters()).device).eval()


def phase_bf16_model(torch, np, kmodel, kgraph, kbanded, work, samples):
    """The bf16 model (compute_dtype "bfloat16", full width) serving the
    65,536-node flush on routes C, D and E: the launch counts of that run
    (4 of the route's kernel, no other kernel, no plain version) and its
    classes against the f32 model of the same weights on the same route;
    then one Trainer step on the "banded" route at dropout 0 (the JAX XLA
    route's plain math under autograd: no kernel, as in JAX) on the card,
    against the same step on the CPU."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    def zero():
        ef.launches = ef.train_launches = ef.bwd_launches = 0
        eb.band_launches = eb.v2_launches = eb.v2_bwd_launches = 0
        sr.launches = 0

    def counts():
        return dict(C=ef.launches, E=eb.band_launches, D=eb.v2_launches,
                    other=ef.train_launches + ef.bwd_launches
                    + eb.v2_bwd_launches + sr.launches)

    plain_calls = []

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            plain_calls.append(name)
            return fn(*a, **k)
        return mock.patch.object(mod, name, wrapped)

    live = kgraph.node_mask
    flush = {}
    for route, sk, wide in BF16_ROUTES:
        mb = routed_model(torch, kmodel, sk, wide, "bfloat16")
        m32 = routed_model(torch, kmodel, sk, wide, "float32")
        with torch.no_grad():
            mb(kgraph, banded=kbanded)            # warm-up
            torch.cuda.synchronize()
            zero()                                # the main path's run
            with counted(ef, "ell_gat_reference"), \
                    counted(eb, "band_part_reference"), \
                    counted(eb, "fused_v2_reference"), \
                    counted(eb, "_v2_plain"):
                out = mb(kgraph, banded=kbanded)
                torch.cuda.synchronize()
            c = counts()
            ref = m32(kgraph, banded=kbanded)
        want = {key: (MODEL_LAYERS if key == route else 0) for key in c}
        check(c == want, f"bf16 flush on route {route}: launches {c}")
        check(not plain_calls, f"plain versions ran: {sorted(plain_calls)}")
        agree = (out["predicted_class"] == ref["predicted_class"])[live]
        agree = agree.float().mean().item()
        dconf = (out["confidence"] - ref["confidence"])[live].abs().max(
            ).item()
        finite = all(bool(torch.isfinite(out[key]).all())
                     for key in ("class_logits", "confidence", "correction"))
        log(f"[3f] bf16 model, route {route} ({sk}, wide_kernel {wide}), "
            f"one {kgraph.x.shape[0]}-node flush: launches {c} (want "
            f"{MODEL_LAYERS} of route {route}'s kernel), plain versions 0; "
            f"vs the f32 model: class agreement {agree:.6f}, max |d "
            f"confidence| {dconf:.3e}")
        check(finite and agree >= 0.99, f"bf16 route {route} outputs")
        flush[route] = dict(launches=c[route], agreement=agree,
                            max_dconf=dconf)
        del mb, m32, out, ref

    # one "banded"-route Trainer step at dropout 0, card vs CPU
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training.datasets import collate_samples
    from bathymetric_gnn_tpu_torch.training.trainer import (
        Trainer, _to_device_targets)

    one = FixedSamples(samples.samples[:1])
    cfg = Config()
    cfg.graph.knn_k = KNN_K
    cfg.model.dropout = 0.0
    cfg.model.sparse_kernel = "banded"
    cfg.training.class_weights = (1.0, 1.0, 1.0)
    graph, targets = collate_samples(one.samples)
    steps = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, one, output_dir=str(work / "banded_step"),
                          device=device)
        state = trainer.init_state(one[0].graph)
        ell = trainer.sparse_batch(graph)
        banded = trainer.banded_batch(ell)
        zero()
        t0 = time.perf_counter()
        losses, _ = trainer.train_step(
            state, ell.to(trainer.device),
            _to_device_targets(targets, trainer.device), LR,
            banded.to(trainer.device))
        loss = float(losses["total"])
        wall = time.perf_counter() - t0
        steps[device] = (loss, {n: p.grad.detach().cpu() for n, p in
                                state.model.named_parameters()
                                if p.grad is not None}, counts(), wall,
                         len(list(state.model.parameters())))
    lk, gk, ck, wk, n_par = steps["cuda"]
    lc, gc, _, wc, _ = steps["cpu"]
    check(np.isfinite(lk) and len(gk) == n_par and all(
        bool(torch.isfinite(v).all()) for v in gk.values()),
        "banded step: loss or gradients")
    check(ck == dict(C=0, E=0, D=0, other=0), f"banded step launches {ck}")
    # card vs CPU: other summation orders (cuBLAS, atomic index_add_) through
    # four batch-statistics BatchNorms move the gradients of the leaves
    # that sum over all nodes (biases, att_edge) by up to ~1e-3 of their
    # scale, in the worst entry and in relative L2 alike (measured on an
    # H100: 9.9e-4 to 1.004e-3 and 9.4e-4 to 9.6e-4; 3d's kernels vs plain
    # on one card: ~9e-4), so each leaf is held within 5e-3 in both; a
    # wrong gradient is off by O(1). The GAT biases, whose gradient is ~0
    # under BatchNorm, are measured against the largest gradient of all,
    # and in L2 against a leaf of their size at that gradient.
    big = max(r.abs().max().item() for r in gc.values())
    worst, worst_l2 = (0.0, ""), (0.0, "")
    for name, r in gc.items():
        d = gk[name] - r
        if "GATConv" in name and name.endswith(".bias"):
            scale, norm = big, big * r.numel() ** 0.5
        else:
            scale, norm = r.abs().max().item() + 1e-12, r.norm().item()
        worst = max(worst, (d.abs().max().item() / scale, name))
        worst_l2 = max(worst_l2, (d.norm().item() / (norm + 1e-12), name))
    rel = abs(lk - lc) / abs(lc)
    log(f"[3f] one Trainer step on sparse_kernel \"banded\" (dropout 0, full "
        f"width, one 256^2 tile, N={ell.x.shape[0]}): loss {lk:.6f} on the "
        f"card vs {lc:.6f} on the CPU (rel {rel:.2e}, tol 1e-4); {len(gk)} "
        f"of {n_par} parameters with a finite gradient; worst entry "
        f"{worst[0]:.3e} of scale ({worst[1]}, tol 5e-3), worst relative L2 "
        f"{worst_l2[0]:.3e} ({worst_l2[1]}, tol 5e-3); kernel launches {ck} "
        f"(the JAX route runs no kernel either); {wk:.3f} s card, {wc:.3f} s "
        f"CPU (host clock)")
    check(rel <= 1e-4 and worst[0] <= 5e-3 and worst_l2[0] <= 5e-3,
          "banded step: card vs CPU")
    return dict(flush=flush, banded_step=dict(
        loss_card=lk, loss_cpu=lc, worst_grad=worst[0],
        worst_grad_l2=worst_l2[0]))


# -- phase 4f: timings of the bf16 forms --------------------------------------

def bf16_step(torch, np, work, samples, route, dstep32):
    """One k-NN train step of the bf16 model (full width, dropout 0.1, f32
    master weights, the trainer's losses, clip and AdamW) on route C or D
    on the merged batch: launch counts of its first run, ms (CUDA events)
    and the device's busy share."""
    from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell
    from bathymetric_gnn_tpu_torch.training.optim import AdamW
    from bathymetric_gnn_tpu_torch.training.trainer import TrainState

    trainer, state, g, targets = knn_step_setup(torch, np, work, samples,
                                                dropout=1.0 - KEEP)
    s0 = samples[0].graph
    model = make_ell_model(trainer.config.model, int(s0.x.shape[-1]),
                           edge_dim=int(s0.edge_attr.shape[-1]),
                           sparse_kernel="banded_pallas",
                           dropout=1.0 - KEEP, compute_dtype="bfloat16")
    model.load_state_dict(state.model.state_dict())
    model.to(g.x.device)
    banded = None
    if route == "D":
        for i in range(MODEL_LAYERS):
            getattr(model.GNNBackbone_0, f"GATConv_{i}").wide_kernel = False
        banded = band_ell(g.to("cpu"), band_rows=BAND_ROWS).to(g.x.device)
    state = TrainState(model, AdamW(model.parameters(),
                                    trainer.config.training.weight_decay), 0)
    fn = lambda: trainer.train_step(state, g, targets, LR,  # noqa: E731
                                    banded)
    ef.train_launches = ef.bwd_launches = ef.launches = 0   # the main path
    eb.v2_launches = eb.v2_bwd_launches = eb.band_launches = 0
    sr.launches = 0
    fa_dtypes = []
    call_fa = sr.call_kernel

    def seen(ct, *a, **k):
        fa_dtypes.append(ct.dtype)
        return call_fa(ct, *a, **k)

    with mock.patch.object(sr, "call_kernel", seen):
        losses, _ = fn()
        torch.cuda.synchronize()
    counts = dict(c=ef.train_launches, cp=ef.bwd_launches, d=eb.v2_launches,
                  dp=eb.v2_bwd_launches, f=sr.launches,
                  f_a_bf16=sum(dt == torch.bfloat16 for dt in fa_dtypes),
                  other=ef.launches + eb.band_launches)
    L = MODEL_LAYERS
    want = (dict(c=L, cp=L, d=0, dp=0, f=L, f_a_bf16=0, other=0)
            if route == "C" else
            dict(c=0, cp=0, d=L, dp=L, f=3 * L, f_a_bf16=L, other=0))
    check(counts == want, f"bf16 route {route} step launches {counts}")
    check(bool(torch.isfinite(losses["total"])), "bf16 step loss")
    missing = [nm for nm, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not missing, f"no finite gradient for {missing}")
    ms = cuda_ms(torch, fn, 5, warmup=1)
    wall, prows = device_profile(torch, lambda: [fn() for _ in range(3)])
    busy = log_profile("4f", f"3 bf16 route-{route} k-NN train steps", wall,
                       prows, top=8)
    log(f"[4f] bf16 k-NN train step on route {route} (merged batch N="
        f"{g.x.shape[0]}, full width, dropout {1 - KEEP:.1f}, f32 master "
        f"weights): launches {counts}; {ms:.3f} ms (CUDA events) vs the f32 "
        f"step on route {route} {dstep32:.3f} ms: {ms / dstep32:.3f} x")
    return dict(ms=ms, busy_share=busy, counts=counts,
                device_ms=sum(r[0] for r in prows) / 3)


def phase_bf16_timings(torch, np, ecases, kcases, becases, bdcases, kmodel,
                       kgraph, work, samples, f32):
    """CUDA-event times of each bf16 form against its bound (bf16 streams
    at 2 bytes) and its plain version: C (serving) and E at the flush's
    shapes; C's training form (Philox), C' (without F, and with F (b) in
    the same call), F (a) on a bf16 cotangent, D and D' at the training
    batch's; the bf16 flush forward on route C; one bf16 train step on
    routes C and D beside the f32 steps of phases 4d and 4e."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    bf = "bfloat16"
    rows = dict(C=[], E=[], Ct=[], D=[])
    with torch.no_grad():
        for label, kw, dims in ecases[:2]:
            kb = bf16_kw(kw)
            kargs = ef.kernel_args(**kb)
            ms = cuda_ms(torch, lambda: ef.call_kernel(**kargs), 20)
            plain_ms = cuda_ms(torch, lambda: ef.ell_gat_reference(**kb), 5,
                               warmup=1)
            b = ell_bound(dims, bf)
            rows["C"].append(dict(shape=bf16_label(label), ms=ms,
                                  plain_ms=plain_ms, bound_ms=b[0],
                                  bound_by=b[1], bytes=b[2], flops=b[3]))
            log(f"[4f] C {bf16_label(label)}: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms by {b[1]} "
                f"({b[2] / 1e6:.1f} MB), {b[0] / ms:.3f} of bound")
            del kargs
        for label, kw, banded, dims in becases:
            xh = kw["xh"].bfloat16()
            n, heads, c = xh.shape
            args = (xh, kw["a_cat_mat"], kw["el_t"], kw["el_self_t"], banded)
            kargs = eb.kernel_args(xh.reshape(n, heads * c), kw["a_cat_mat"],
                                   banded.loc_t, kw["el_t"], kw["el_self_t"],
                                   band_rows=banded.band_rows)
            ms = cuda_ms(torch, lambda: eb.call_band_kernel(**kargs), 20)
            plain_ms = cuda_ms(torch, lambda: eb.band_part_reference(*args),
                               5, warmup=1)
            b = band_bounds(dims, dtype=bf)["E"]
            rows["E"].append(dict(shape=bf16_label(label), ms=ms,
                                  plain_ms=plain_ms, bound_ms=b[0],
                                  bound_by=b[1], bytes=b[2], flops=b[3]))
            log(f"[4f] E {bf16_label(label)}: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms by {b[1]} "
                f"({b[2] / 1e6:.1f} MB), {b[0] / ms:.3f} of bound")
            del kargs
    for i, (label, kw, (perm, row_ptr), dims) in enumerate(kcases[:2]):
        kb = bf16_kw(kw)
        dev = kb["xh"].device
        n, k, heads, hc = dims["n"], dims["k"], dims["heads"], dims["hc"]
        seed = torch.tensor([SEED + 85 + i], dtype=torch.int64, device=dev)
        args = ef.kernel_args(**kb, drop_seed=seed, keep_prob=KEEP,
                              train=True)
        bkw = {nm: args[nm] for nm in (
            "xh", "att", "nbr", "nmask", "el", "el_self", "node_mask",
            "dmask", "seed", "n", "k", "heads", "c", "negative_slope",
            "has_self", "drop_mode", "thresh", "keep_inv", "dtype")}
        p32, r32 = perm.int().contiguous(), row_ptr.int().contiguous()
        g = torch.randn(n, hc, generator=torch.Generator().manual_seed(
            SEED + 86)).to(dev).bfloat16()
        c_ms = cuda_ms(torch, lambda: ef.call_kernel(**args), 10)
        cp_ms = cuda_ms(torch, lambda: ef.call_bwd_kernel(
            **bkw, perm=p32, row_ptr=r32, g=g, source_side=False), 10)
        call_ms = cuda_ms(torch, lambda: ef.call_bwd_kernel(
            **bkw, perm=p32, row_ptr=r32, g=g), 10)
        mask = ef.drop_mask(seed, KEEP, n, k, heads)
        with torch.no_grad():
            pc_ms = cuda_ms(torch, lambda: ef.ell_gat_reference(
                **kb, dmask=mask), 3, warmup=1)
        leaves = {nm: kb[nm].detach().clone().requires_grad_()
                  for nm in ELL_LEAVES}
        ref = ef.ell_gat_reference(**{**kb, **leaves}, dmask=mask)
        pcp_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref, list(leaves.values()), g, retain_graph=True), 3, warmup=1)
        del ref, leaves
        src, _ = fa_inputs(torch, kw)
        ct = torch.randn(src.numel(), hc, generator=torch.Generator(
            ).manual_seed(SEED + 87)).to(dev).bfloat16()
        pa, ra = fa_tables(torch, src, n)
        fa_ms = cuda_ms(torch, lambda: sr.call_kernel(ct, pa, ra, n), 10)
        pfa_ms = cuda_ms(torch, lambda: sr.segment_reduce_reference(
            ct, pa, ra, n), 3, warmup=1)
        bd = knn_train_bounds(dims, bf)
        rows["Ct"].append(dict(
            shape=bf16_label(label), c_ms=c_ms, c_plain_ms=pc_ms,
            c_bound_ms=bd["C"][0], c_bound_by=bd["C"][1], cp_ms=cp_ms,
            cp_call_with_f_ms=call_ms, cp_plain_ms=pcp_ms,
            cp_bound_ms=bd["Cp"][0], cp_bound_by=bd["Cp"][1],
            cw_bound_ms=bd["Cw"][0], cw_bound_by=bd["Cw"][1], fa_ms=fa_ms,
            fa_plain_ms=pfa_ms, fa_bound_ms=bd["Fa"][0],
            fa_bound_by=bd["Fa"][1],
            **{f"{nm}_bytes": bd[nm][2] for nm in ("C", "Cw", "Cp", "Fa")}))
        log(f"[4f] {bf16_label(label)}: C training {c_ms:.4f} ms (plain "
            f"{pc_ms:.4f}, bound {bd['C'][0]:.4f} by {bd['C'][1]}, "
            f"{bd['C'][0] / c_ms:.3f} of bound); C' whole call (+ F (b)) "
            f"{call_ms:.4f} ms (plain autograd backward {pcp_ms:.4f}; bound "
            f"{bd['Cw'][0]:.4f} by {bd['Cw'][1]}, "
            f"{bd['Cw'][0] / call_ms:.3f} of bound); info: its destination "
            f"pass alone {cp_ms:.4f} ms (bound {bd['Cp'][0]:.4f} by "
            f"{bd['Cp'][1]}, {bd['Cp'][0] / cp_ms:.3f} of bound); F (a) on a bf16 "
            f"{src.numel()} x {hc} cotangent {fa_ms:.4f} ms (plain "
            f"{pfa_ms:.4f}, bound {bd['Fa'][0]:.4f} by {bd['Fa'][1]})")
        del args, bkw, g, mask, ct, pa, ra, src
    for label, kw, banded, dims in bdcases:
        xh = kw["xh"].bfloat16()
        kb = bf16_kw(kw)
        n, heads, c = xh.shape
        with torch.no_grad():
            kargs, bkw = v2_kernel_args(torch, kb, banded)
            g = torch.randn(n, heads * c, generator=torch.Generator(
                ).manual_seed(SEED + 97)).to(xh.device).bfloat16()
            ac = torch.empty(n, 2 * heads, device=xh.device)
            d_ms = cuda_ms(torch, lambda: eb.call_v2_kernel(**kargs, ac=ac),
                           10)
            dp_ms = cuda_ms(torch, lambda: eb.call_v2_bwd_kernel(
                **bkw, dout=g), 10)
            dpg_ms = cuda_ms(torch, lambda: eb.call_v2_bwd_kernel(
                **bkw, dout=g, ac=ac), 10)
            pd_ms = cuda_ms(torch, lambda: eb.fused_v2_reference(
                **kb, banded=banded), 3, warmup=1)
        leaves = {nm: kb[nm].detach().clone().requires_grad_()
                  for nm in V2_LEAVES if kb.get(nm) is not None}
        ref = eb.fused_v2_reference(**{**kb, **leaves}, banded=banded)
        pdp_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref, list(leaves.values()), g, retain_graph=True), 3, warmup=1)
        del ref, leaves
        bd = band_bounds(dims, dtype=bf)
        rows["D"].append(dict(
            shape=bf16_label(label), d_ms=d_ms, d_plain_ms=pd_ms,
            d_bound_ms=bd["D"][0], d_bound_by=bd["D"][1], dp_ms=dpg_ms,
            dp_own_dots_ms=dp_ms, dp_plain_ms=pdp_ms,
            dp_bound_ms=bd["Dp"][0], dp_bound_by=bd["Dp"][1],
            **{f"{nm}_bytes": bd[nm][2] for nm in ("D", "Dp")}))
        log(f"[4f] D {bf16_label(label)}: {d_ms:.4f} ms (plain {pd_ms:.4f}, "
            f"bound {bd['D'][0]:.4f} by {bd['D'][1]}, {bd['D'][0] / d_ms:.3f}"
            f" of bound); D' given D's dots {dpg_ms:.4f} ms, computing its "
            f"own {dp_ms:.4f} ms (plain autograd backward {pdp_ms:.4f}, "
            f"bound {bd['Dp'][0]:.4f} by {bd['Dp'][1]}, "
            f"{bd['Dp'][0] / dpg_ms:.3f} of bound)")
        del kargs, bkw, g, ac
    rows["dots"] = dots_timings(torch, becases + bdcases, "4f",
                                torch.bfloat16)

    mb = routed_model(torch, kmodel, "banded_pallas", True, bf)
    m32 = routed_model(torch, kmodel, "banded_pallas", True, "float32")
    with torch.no_grad():
        t32 = cuda_ms(torch, lambda: m32(kgraph), 5, warmup=2)
        flush_ms = cuda_ms(torch, lambda: mb(kgraph), 5, warmup=2)
        for name, m in (("f32", m32), ("bf16", mb)):
            wall, prows = device_profile(
                torch, lambda m=m: [m(kgraph) for _ in range(5)])
            log_profile("4f", f"5 {name} flush forwards (route C)", wall,
                        prows, top=8)
    log(f"[4f] bf16 EllBathymetricGNN forward, one {kgraph.x.shape[0]}-node "
        f"flush (route C, 4 bf16 kernel C launches): {flush_ms:.3f} ms vs "
        f"{t32:.3f} ms in f32 timed beside it ({f32['flush_ms']:.3f} in 4c):"
        f" {flush_ms / t32:.3f} x")
    del mb, m32
    steps = {route: bf16_step(torch, np, work, samples, route,
                              f32[f"step_{route}"])
             for route in ("C", "D")}
    return rows, flush_ms, steps


def bf16_entries(errs, bmod, rows, flush_ms, steps):
    """The kernels line's entries of the bf16 forms: launches from the bf16
    main paths (phase 3f's flush for C and E, phase 4f's bf16 train steps
    for C's training form, C', D, D' and F), errors from phase 2f, times
    and bounds from phase 4f."""
    src = "bathymetric_gnn_tpu_torch/csrc/"
    rep = "bathymetric_gnn_tpu/ops/pallas/"
    c, e, ct, d = rows["C"][0], rows["E"][0], rows["Ct"][0], rows["D"][0]
    sc, sd = steps["C"], steps["D"]
    common = dict(route="cuda", library_ms=None, dtype="bfloat16")
    return [{
        "name": "ell_gat_fwd_bf16", "source": src + "ell_gat_fwd.cu",
        "replaces": rep + "ell_gat_fused.py:1107",
        "launches": bmod["flush"]["C"]["launches"],
        "max_abs_err": errs[("C", c["shape"])], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "at": c["shape"], "shapes": rows["C"],
        "model_forward_ms_per_flush": flush_ms,
        "class_agreement_with_f32": bmod["flush"]["C"]["agreement"],
        **common,
    }, {
        "name": "ell_gat_fwd_train_bf16", "source": src + "ell_gat_fwd.cu",
        "replaces": rep + "ell_gat_fused.py:1107",
        "launches": sc["counts"]["c"],
        "max_abs_err": errs[("Ct", ct["shape"])], "ms": ct["c_ms"],
        "plain_ms": ct["c_plain_ms"], "bound_ms": ct["c_bound_ms"],
        "bound_by": ct["c_bound_by"], "at": ct["shape"],
        "shapes": rows["Ct"], "train_step": sc, **common,
    }, {
        "name": "ell_gat_bwd_bf16", "source": src + "ell_gat_bwd.cu",
        "replaces": rep + "ell_gat_fused.py:1258",
        "launches": sc["counts"]["cp"],
        "max_abs_err": errs[("Cp", ct["shape"])],
        "ms": ct["cp_call_with_f_ms"], "plain_ms": ct["cp_plain_ms"],
        "bound_ms": ct["cw_bound_ms"], "bound_by": ct["cw_bound_by"],
        "share_of_bound": ct["cw_bound_ms"] / ct["cp_call_with_f_ms"],
        "timed": "the whole call (dots, destination pass, F (b))",
        "destination_pass": {"ms": ct["cp_ms"],
                             "bound_ms": ct["cp_bound_ms"],
                             "bound_by": ct["cp_bound_by"]},
        "at": ct["shape"], **common,
    }, {
        "name": "ell_gat_band_bf16", "source": src + "ell_gat_band.cu",
        "replaces": rep + "ell_gat_fused.py:88",
        "launches": bmod["flush"]["E"]["launches"],
        "max_abs_err": errs[("E", e["shape"])], "ms": e["ms"],
        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "at": e["shape"], "shapes": rows["E"],
        "class_agreement_with_f32": bmod["flush"]["E"]["agreement"],
        **common,
    }, {
        "name": "ell_gat_v2_fwd_bf16", "source": src + "ell_gat_v2_fwd.cu",
        "replaces": rep + "ell_gat_fused.py:268",
        "launches": sd["counts"]["d"],
        "max_abs_err": errs[("D", d["shape"])], "ms": d["d_ms"],
        "plain_ms": d["d_plain_ms"], "bound_ms": d["d_bound_ms"],
        "bound_by": d["d_bound_by"], "at": d["shape"], "shapes": rows["D"],
        "serving_flush_launches": bmod["flush"]["D"]["launches"],
        "train_step": sd, "mat_dots": rows["dots"], **common,
    }, {
        "name": "ell_gat_v2_bwd_bf16", "source": src + "ell_gat_v2_bwd.cu",
        "replaces": rep + "ell_gat_fused.py:625",
        "launches": sd["counts"]["dp"],
        "max_abs_err": errs[("Dp", d["shape"])], "ms": d["dp_ms"],
        "plain_ms": d["dp_plain_ms"], "bound_ms": d["dp_bound_ms"],
        "bound_by": d["dp_bound_by"],
        "share_of_bound": d["dp_bound_ms"] / d["dp_ms"], "at": d["shape"],
        "timed": "the whole call given D's attention dots (the main path's)",
        "ms_computing_its_own_dots": d["dp_own_dots_ms"],
        **common,
    }, {
        "name": "segment_reduce_bf16", "source": src + "segment_reduce.cu",
        "replaces": rep + "segment_reduce.py:52",
        "mode": "a, on the bf16 spill-row cotangent of the route-D step",
        "launches": sd["counts"]["f_a_bf16"],
        "max_abs_err": errs[("Fa", ct["shape"])], "ms": ct["fa_ms"],
        "plain_ms": ct["fa_plain_ms"], "bound_ms": ct["fa_bound_ms"],
        "bound_by": ct["fa_bound_by"], "at": ct["shape"],
        "mode_b_launches_in_bf16_route_c_step": sc["counts"]["f"],
        **common,
    }]


# -- phase 2g: kernel F as the COO segment sum ------------------------------------

COO_N = 65536          # the COO flush: a 256^2 survey's grid graph, 5 % holes
COO_WIDTHS = {256: "message rows (wide layers)", 4: "denominators (4 heads)",
              1: "denominators (last layer), counts", 3: "edge attributes",
              64: "message rows (last layer)"}
# F per GAT layer with edge attributes on the COO path: forward 4 (the
# self loop's mean attribute: sum and count; the softmax denominator; the
# message sum), backward 4 (the gathers of alpha_src, alpha_dst, the
# denominator and xh); GCN 2 forward (degree, message sum) + 1 backward
# (the gather of x W)
COO_F = {"GAT": (4, 4), "GCN": (2, 1)}
COO_VR_GRIDS = 500     # 3i serves 3g's first 500 refinements + the 512^2 grid
COO_GCN_SURVEY = (480, 928)   # 2 x 4 tiles of 256^2 at stride 224


def coo_flush_graph(torch, np, dev):
    """The grid-connectivity graph (the port's GraphBuilder, knn_k 0) of a
    synthetic 256^2 survey with 5 % holes and uncertainty (8 features), in
    the 65,536-node bucket with its pads at N - 1: the PaddedGraph, its
    CooGraph (both tables) on the card, and its ELL form (route C's
    input) on the card."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.graph import CooGraph

    depth, unc = knn_survey(np, KNN_SURVEY, SEED + 100)
    valid = np.isfinite(depth)
    bg = GraphBuilder().build_graph(depth, valid, unc, (1.0, 1.0))
    pg = bg.graph
    check(pg.x.shape == (COO_N, 8), f"COO flush graph {pg.x.shape}")
    return pg, CooGraph.from_padded(pg).to(dev), coo_to_ell(pg, 8).to(dev)


def phase_coo_segment_vs_plain(torch, np, dev):
    """Kernel F (mode a) as the COO segment sum (the destination table) and
    as a gather's backward (the source table), at each COO_WIDTHS width, on
    f32 and bf16 rows: bit for bit against the in-order sum (each segment's
    rows added from 0 in ascending slot order, the kernel's adds), two calls
    bit for bit, and against index_add_ of the live rows (f32 sums of <= 9
    rows in another order: |err| <= 1e-5 (1 + max |ref|)); the gather's
    autograd backward equals the direct call."""
    from bathymetric_gnn_tpu_torch.ops import segment as seg
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    pg, g, ell = coo_flush_graph(torch, np, dev)
    n, e = g.x.shape[0], g.edge_src.shape[0]
    m = g.edge_mask
    live = int(m.sum())
    gen = torch.Generator().manual_seed(SEED + 101)
    errs = {}
    tables = (("sum", g.dst_table, g.edge_dst),
              ("gather backward", g.src_table, g.edge_src))
    for f, what in COO_WIDTHS.items():
        for dtype in (torch.float32, torch.bfloat16):
            ct = torch.randn(e, f, generator=gen).to(dev, dtype)
            for kind, table, ids in tables:
                if kind == "sum" and dtype == torch.float32:
                    out = seg.segment_sum(ct, g.edge_dst, n, m, table)
                else:
                    out = sr.segment_reduce_sorted(ct, *table, n)
                again = sr.segment_reduce_sorted(ct, *table, n)
                order = sr.segment_reduce_in_order(ct, *table, n)
                ref = torch.zeros(n, f, device=dev).index_add_(
                    0, ids[m].long(), ct[m].float())
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                label = f"{kind} [E, {f}]" + (
                    "" if dtype == torch.float32 else " bf16 rows")
                errs[label] = err
                check(torch.equal(out, order), f"[2g] F {label} differs "
                      f"from the in-order sum")
                check(torch.equal(out, again), f"[2g] F {label} differs "
                      "between two calls")
                check(err <= 1e-5 * (1 + ref.abs().max().item()),
                      f"[2g] F {label} vs index_add_: {err:.3e}")
                log(f"[2g] F {label} ({what}) over {live} live of {e} edges"
                    f" into {n} nodes: equal to the in-order sum bit for "
                    f"bit, two calls bit for bit, vs index_add_ max |err| "
                    f"{err:.3e}")
    ct = torch.randn(e, 256, generator=gen).to(dev)
    x = torch.zeros(n, 256, device=dev, requires_grad=True)
    seg.gather(x, g.edge_src, g.src_table).backward(ct)
    out = sr.segment_reduce_sorted(ct, *g.src_table, n)
    torch.cuda.synchronize()
    check(torch.equal(out, x.grad), "[2g] the gather's autograd backward "
          "differs from the direct call")
    log("[2g] the gather's autograd backward [E, 256] equals the direct "
        "call bit for bit")
    return errs, dict(pg=pg, g=g, ell=ell)


# -- phase 3i: COO serving, non-GAT serving and the smoke test -----------------

def seeded_graph_state(torch, np, gnn_type, seed):
    """The grid-named state_dict of a full-width COO model of ``gnn_type``
    (8 input channels), random weights and BatchNorm statistics from
    ``seed``."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.models.gnn import make_model
    from bathymetric_gnn_tpu_torch.utils.weights import grid_state_dict

    cfg = Config()
    cfg.model.gnn_type = gnn_type
    model = random_bn_stats(torch, np, make_model(
        cfg.model, 8, generator=torch.Generator().manual_seed(seed)), seed)
    return cfg, grid_state_dict(model.state_dict())


def counted_calls(fn, calls):
    def wrapped(*a, **k):
        calls.append(getattr(fn, "__name__", "plain"))
        return fn(*a, **k)
    return wrapped


def f_widths(sr, widths):
    """mock.patch of kernel F's mode (a) wrapper that records the width
    of each call in ``widths`` (the launches stay counted by the wrapper
    itself)."""
    call = sr.call_kernel

    def recorded(ct, *a, **k):
        widths.append(int(ct.shape[1]))
        return call(ct, *a, **k)
    return mock.patch.object(sr, "call_kernel", recorded)


def class_agreement(np, grids, a, b):
    agree = n = 0
    dconf = 0.0
    for (depth, _, _), ra, rb in zip(grids, a, b):
        v = np.abs(depth) < 1e5
        agree += int((ra["classification"][v]
                      == rb["classification"][v]).sum())
        n += int(v.sum())
        dconf = max(dconf, float(np.abs(ra["confidence"]
                                        - rb["confidence"]).max()))
    return agree / n, dconf


def phase_vr_coo(torch, np, work, vr, dvr):
    """NativeVRProcessor(use_ell=False) (the COO model at full width, every
    grid a grid-connectivity graph, kernel F behind its sums) on 3g's
    first COO_VR_GRIDS refinements and its 512^2 grid, from 3c's
    checkpoint; GCN, GraphSAGE and GIN models on the default route, card
    against CPU; cli.smoke_test on the card."""
    from collections import Counter

    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.utils.weights import load_state_dict

    sd, _ = load_state_dict(vr["ckpt"])
    grids = vr["grid_list"]
    idx = list(range(COO_VR_GRIDS)) + [VR_GRIDS // 2]
    sub = [grids[i] for i in idx]
    check(sub[-1][0].shape == (VR_BIG, VR_BIG), "the 512^2 grid")
    n_nodes = sum(int((np.abs(d) < 1e5).sum()) for d, _, _ in sub)
    proc = NativeVRProcessor(sd, Config(), node_budget=VR_BUDGET,
                             use_ell=False)
    check(not proc.use_slab and not proc.use_grid, "COO route took slabs")
    serve(proc, sub[:100])              # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    chunks, plain = [], []
    launch = proc._launch_graphs_chunk

    def counted_chunk(idx_):
        chunks.append(len(idx_))
        return launch(idx_)

    runs, widths = [], []
    with mock.patch.object(proc, "_launch_graphs_chunk", counted_chunk), \
            mock.patch.object(sr, "segment_reduce_reference",
                              counted_calls(sr.segment_reduce_reference,
                                            plain)), \
            f_widths(sr, widths):
        for _ in range(2):
            chunks.clear()
            widths.clear()
            sr.launches = 0             # counts of the main path's run
            t0 = time.perf_counter()
            results = serve(proc, sub)
            torch.cuda.synchronize()
            runs.append((results, time.perf_counter() - t0, sr.launches,
                         len(chunks), Counter(widths)))
    ((results, wall, launches, n_chunks, by_width),
     (results2, wall2, _, _, _)) = runs
    check(sum(by_width.values()) == launches, "[3i] F widths vs launches")
    check_results(np, sub, results, "3i")
    check(not plain, f"the plain version ran {len(plain)} times")
    per_layer = COO_F["GAT"][0]         # serving: the forward's launches
    check(launches == per_layer * MODEL_LAYERS * n_chunks,
          f"[3i] F launches {launches} != {per_layer} x {MODEL_LAYERS} "
          f"layers x {n_chunks} graph chunks")
    same = all(np.array_equal(a[c], b[c]) for a, b in zip(results, results2)
               for c in ("classification", "confidence", "correction"))
    check(same, "[3i] two COO serving runs differ")
    ref = [dvr["results32"][i] for i in idx]
    agree, dconf = class_agreement(np, sub, results, ref)
    check(agree >= 0.99, f"[3i] classes vs 3g's f32 route: {agree}")
    wall_p, prows = device_profile(torch, lambda: serve(proc, sub),
                                   cpu=False)
    busy = log_profile("3i", f"{len(sub)} grids on the COO route (device "
                       "activity only)", wall_p, prows, top=10)
    r32 = dvr["runs"]["float32"]
    log(f"[3i] NativeVRProcessor(use_ell=False), GAT full width, budget "
        f"{VR_BUDGET}: 3g's first {COO_VR_GRIDS} refinements + its "
        f"{VR_BIG}^2 grid ({len(sub)} grids, {n_nodes} nodes) in "
        f"{wall:.3f} s ({wall2:.3f} s again): {len(sub) / wall:.3f} "
        f"grids/s, {n_nodes / wall / 1e6:.4f} Mnodes/s, device busy "
        f"{busy}; {n_chunks} graph chunks, F launches {launches} = "
        f"{per_layer} x {MODEL_LAYERS} x {n_chunks} (by width "
        f"{dict(by_width)}); plain version called "
        f"0 times; two runs bit for bit; classes vs 3g's f32 default route "
        f"{agree:.6f} (want >= 0.99), max |d confidence| {dconf:.3e}; "
        f"beside 3g in this run (all {len(grids)} grids): f32 "
        f"{r32['grids_per_s']:.3f} grids/s, busy "
        f"{r32['device_busy_share']}; bf16 "
        f"{dvr['runs']['bfloat16']['grids_per_s']:.3f} grids/s")

    # GCN, GraphSAGE and GIN on the default route, card against the CPU
    sub2 = grids[:200] + [grids[VR_GRIDS // 2]]
    others = {}
    for i, t in enumerate(("GCN", "GraphSAGE", "GIN")):
        cfg, sd_t = seeded_graph_state(torch, np, t, SEED + 110 + i)
        card = NativeVRProcessor(sd_t, cfg, node_budget=VR_BUDGET)
        cpu = NativeVRProcessor(sd_t, cfg, node_budget=VR_BUDGET,
                                device="cpu")
        check(card.use_slab and not card.use_grid, f"[3i] {t} route")
        t0 = time.perf_counter()
        a = serve(card, sub2)
        torch.cuda.synchronize()
        wall_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = serve(cpu, sub2)
        wall_cpu = time.perf_counter() - t0
        check_results(np, sub2, a, "3i")
        agree_t, dconf_t = class_agreement(np, sub2, a, b)
        others[t] = dict(class_agreement=agree_t, max_dconf=dconf_t,
                         grids_per_s=len(sub2) / wall_t)
        log(f"[3i] {t} (full width, random weights) on the default route, "
            f"{len(sub2)} grids (200 refinements + the {VR_BIG}^2): card "
            f"{wall_t:.3f} s, CPU {wall_cpu:.3f} s; card vs CPU classes "
            f"{agree_t:.6f} (want >= "
            f"0.999), max |d confidence| {dconf_t:.3e} (want <= 2e-3)")
        check(agree_t >= 0.999 and dconf_t <= 2e-3, f"[3i] {t} card vs CPU")

    smoke = smoke_test_on_card(torch)
    return dict(launches=launches, launches_by_width=by_width,
                chunks=n_chunks, wall=wall, wall2=wall2,
                grids=len(sub), nodes=n_nodes, busy_share=busy,
                class_agreement_with_3g_f32=agree, max_dconf=dconf,
                non_gat=others, smoke=smoke)


def smoke_test_on_card(torch):
    """cli.smoke_test's main on the card (as ``python -m``), its output
    captured: every stage passes, kernel F launched by the COO model
    stage (2 GAT layers x 4) and kernel A by the dense grid stage (2)."""
    import contextlib
    import io

    from bathymetric_gnn_tpu_torch.cli import smoke_test
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    buf = io.StringIO()
    gf.launches = sr.launches = 0
    with contextlib.redirect_stdout(buf):
        try:
            smoke_test.main([])
        except SystemExit as e:
            raise Failed(f"[3i] cli.smoke_test exited {e.code}: "
                         f"{buf.getvalue()}")
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"[3i] smoke_test | {line}")
    a, f = gf.launches, sr.launches
    check(lines[-1] == "all stages passed", "[3i] cli.smoke_test")
    check(a == 2 and f == 2 * COO_F["GAT"][0],
          f"[3i] smoke test launches: A {a} (want 2), F {f} (want 8)")
    log(f"[3i] cli.smoke_test on the card: all stages passed; kernel A "
        f"launched {a} times (2 layers), F {f} times (2 GAT layers x 4)")
    return dict(grid_gat_fwd_launches=a, segment_reduce_launches=f)


# -- phase 3j: COO training -----------------------------------------------------

def coo_train_cli(torch, np, data, run, extra, tiles, gnn_type,
                  data_flag="--data-dir"):
    """cli.train --trainer graph (no --knn-k) on ``data`` (clean surveys,
    or GT rasters with ``data_flag="--ground-truth-dir"``), 1 epoch: the
    kernel F launches against the count the code implies (per step:
    COO_F's forward + backward per layer; eval over the training set and
    the calibration pass: forward per layer per batch), no plain version;
    finite losses; best/, last/, final/ with calibration.json."""
    import json
    import shutil

    from bathymetric_gnn_tpu_torch.cli import train as tcli
    from bathymetric_gnn_tpu_torch.models.gnn import BathymetricGNN
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    shutil.rmtree(run, ignore_errors=True)
    argv = ["--trainer", "graph", data_flag, str(data), "--output-dir",
            str(run), "--epochs", "1", "--seed", str(SEED), "--tile-size",
            str(TRAIN_TILE)] + extra
    plain = []
    sr.launches = 0
    with mock.patch.object(sr, "segment_reduce_reference",
                           counted_calls(sr.segment_reduce_reference,
                                         plain)):
        t0 = time.perf_counter()
        state = tcli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = sr.launches
    batches = tiles // TRAIN_BATCH
    fwd, bwd = COO_F[gnn_type]
    want = MODEL_LAYERS * ((fwd + bwd) * state.step + fwd * 2 * batches)
    check(isinstance(state.model, BathymetricGNN), "not the COO model")
    check(state.step == batches, f"steps {state.step} != {batches}")
    check(not plain, f"the plain version ran {len(plain)} times")
    check(launches == want, f"F launches {launches} != {want} ({MODEL_LAYERS}"
          f" x ({fwd + bwd} x {state.step} steps + {fwd} x 2 x {batches} "
          "eval and calibration batches))")
    hist = json.loads((run / "history.json").read_text())
    check(all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
          f"losses {hist}")
    cals = [json.loads((run / nm / "calibration.json").read_text())
            for nm in ("best", "last", "final")]
    check(all("fit_on" in c and c["confidence_scale"] > 0 for c in cals),
          "calibration.json")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    return dict(state=state, wall=wall, launches=launches, steps=state.step,
                hist=hist, cal=cals[0], metrics=metrics)


def coo_train_samples(np, depth):
    """TRAIN_BATCH training samples (grid-connectivity graphs of 256^2
    tiles with synthetic noise and targets: knn_k 0) of ``depth``."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training.datasets import (
        SyntheticTileDataset)

    ds = SyntheticTileDataset([depth], Config(), tile_size=TRAIN_TILE,
                              overlap=32, seed=SEED)
    return FixedSamples([ds[i] for i in range(TRAIN_BATCH)])


def coo_step_setup(torch, np, work, samples, dropout):
    """A COO Trainer (full width, ``dropout``, class weights 1) on the
    fixed samples, its initial state, and their merged batch on the card
    (the CooGraph with both tables, as the prefetch thread builds it)."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training.datasets import collate_samples
    from bathymetric_gnn_tpu_torch.training.trainer import (
        Trainer, _to_device_targets)

    cfg = Config()
    cfg.model.dropout = dropout
    cfg.training.class_weights = (1.0, 1.0, 1.0)
    trainer = Trainer(cfg, samples, output_dir=str(work / "coo_step"))
    check(not trainer.use_banded_training, "not the COO path")
    state = trainer.init_state(samples[0].graph)
    graph, targets = collate_samples(samples.samples)
    g = trainer.sparse_batch(graph).to(trainer.device)
    return trainer, state, g, _to_device_targets(targets, trainer.device)


def coo_step_f64(torch, trainer, model, snapshot, g, targets):
    """(loss, gradients, term scales) of the train step's loss at
    ``snapshot`` in f64: a copy of the model, the graph's float fields and
    the targets in f64, every segment sum on the plain version in f64.

    The gradients are clipped to the global norm as the step clips them.
    The term scales are, for each GAT layer's ``lin_edge`` and
    ``att_edge``, the sum of the |terms| that make up each entry of its
    gradient: both reach the loss only through m_edge [edge_dim, heads],
    whose gradient sums x^T dy over every edge (and every node's self
    loop) of ``matmul(x, m_edge)``, and those terms cancel. The scale of
    m_edge's entry is |x|^T |dy|, taken by a hook on each such product;
    lin_edge[f, a, c]'s is that times |att_edge[a, c]|, att_edge[a, c]'s
    the sum over f of it times |lin_edge[f, a, c]|."""
    import copy
    import dataclasses

    from bathymetric_gnn_tpu_torch.models import conv as conv_mod
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    f64 = torch.float64
    m64 = copy.deepcopy(model)
    m64.load_state_dict(snapshot)
    m64 = m64.to(f64)
    g64 = dataclasses.replace(g, **{
        f: getattr(g, f).to(f64) for f in ("x", "edge_attr", "local_std")})
    t64 = {k: v.to(f64) if v.is_floating_point() else v
           for k, v in targets.items()}

    def plain64(ct, perm, row_ptr, n):
        live = perm[:int(row_ptr[n])].long()
        return torch.zeros(n, ct.shape[1], dtype=ct.dtype,
                           device=ct.device).index_add_(
            0, sr._segment_of_sorted(row_ptr, n), ct[live])

    m_scales = {}                  # id(m_edge) -> [m_edge, |x|^T |dy|]
    product = conv_mod.matmul

    def matmul_terms(x, w):
        y = product(x, w)
        if w.grad_fn is not None:  # m_edge; lin_src is a leaf
            ent = m_scales.setdefault(id(w), [w, torch.zeros_like(w)])
            xa = x.detach().abs()

            def hook(dy):
                ent[1].add_(xa.t() @ dy.abs())

            y.register_hook(hook)
        return y

    with mock.patch.object(sr, "segment_reduce_sorted", plain64), \
            mock.patch.object(conv_mod, "matmul", matmul_terms):
        losses, _ = trainer.loss_fn(m64, g64, t64, train=True)
        losses["total"].backward()
    # the step clips its gradients to the global norm (train_step,
    # optim.clip_by_global_norm_): so does this one, and its term scales
    norm = torch.sqrt(sum(p.grad.square().sum() for p in m64.parameters()))
    max_norm = trainer.config.training.grad_clip_norm
    clip = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    out = {n: (p.grad * clip).to(torch.float32)
           for n, p in m64.named_parameters()}
    log(f"[3j] the f64 step's gradients clipped as the step clips its own:"
        f" global norm {float(norm):.6f}, factor {clip:.6f}")
    params = dict(m64.named_parameters())
    convs = [n[:-len(".lin_edge")] for n in params if n.endswith(".lin_edge")]
    check(len(convs) == len(m_scales),
          f"[3j] {len(m_scales)} m_edge products for {len(convs)} layers")
    scales = {}
    for name, (_, sm) in zip(convs, m_scales.values()):
        att = params[name + ".att_edge"].detach()        # [1, H, C]
        lin = params[name + ".lin_edge"].detach()        # [F, H * C]
        h, c = att.shape[1:]
        lin3 = lin.reshape(lin.shape[0], h, c).abs()
        scales[name + ".lin_edge"] = (sm[:, :, None] * att.abs()).reshape(
            lin.shape).mul(clip).to(torch.float32)
        scales[name + ".att_edge"] = (sm[:, :, None] * lin3).sum(0)[
            None].mul(clip).to(torch.float32)
    loss = float(losses["total"])
    del m64, g64, t64, losses, params
    return loss, out, scales


def phase_coo_train(torch, np, work, samples):
    """cli.train --trainer graph at its defaults on 3d's 1024^2 survey; the
    checkpoint served on the default route; one step through F against
    the same step on F's plain version (dropout 0, N = 262,144); two steps
    from one state and seed bit for bit (dropout 0.1); one epoch of
    --gnn-type GCN on 8 tiles."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.data.tiling import TileManager
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff, write_geotiff
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.training.optim import AdamW
    from bathymetric_gnn_tpu_torch.training.trainer import make_dropout_key
    from bathymetric_gnn_tpu_torch.utils.weights import load_state_dict

    data = work / "knn_train_data"          # 3d's survey
    depth = read_geotiff(data / "survey.tif")[0][0]
    n_tiles = sum(1 for _ in TileManager(TRAIN_TILE, 32, 0.3).iterate_tiles(
        depth))
    run = work / "coo_train_run"
    tr = coo_train_cli(torch, np, data, run, [], n_tiles, "GAT")
    hist, cal = tr["hist"], tr["cal"]
    log(f"[3j] cli.train --trainer graph (no --knn-k: the COO model, GAT "
        f"full width, dropout 0.1, f32) on 3d's {KNN_TRAIN_SURVEY}^2 survey:"
        f" {n_tiles} tiles, 1 epoch, {tr['steps']} steps of {TRAIN_BATCH} "
        f"in {tr['wall']:.3f} s (with the training-stats sample, eval, "
        f"calibration and checkpoints); F launches {tr['launches']} = "
        f"{MODEL_LAYERS} x (8 x {tr['steps']} steps + 4 x 2 x "
        f"{tr['steps']} eval and calibration batches); "
        f"plain version called 0 times; train loss {hist['train_loss']}, "
        f"val loss {hist['val_loss']}; best/calibration.json scale "
        f"{cal['confidence_scale']:.4f} bias {cal['confidence_bias']:.4f} on "
        f"{cal['fit_on']}; training loop {tr['metrics']['tiles_per_s']} "
        f"tiles/s (host clock, metrics.jsonl)")
    sd, meta = load_state_dict(run / "best")
    check(meta["trained_layout"] == "coo", f"checkpoint meta {meta}")
    cfg = Config.load(run / "config.yaml")
    check(cfg.graph.knn_k == 0, "the run's knn_k")
    proc = NativeVRProcessor(sd, cfg, node_budget=VR_BUDGET)
    grids = make_refinements(np, 200, SEED + 120)
    big, big_unc = knn_survey(np, VR_BIG // 4, SEED + 121)
    big[np.isnan(big)] = 1.0e6
    grids.append((big, big_unc, (2.0, 2.0)))
    a0, c0 = gf.launches, ef.launches
    results = serve(proc, grids)
    torch.cuda.synchronize()
    check_results(np, grids, results, "3j")
    check(gf.launches > a0 and ef.launches > c0,
          "serving did not launch kernels A and C")
    log(f"[3j] NativeVRProcessor (default route) served {len(grids)} grids "
        f"from {run / 'best'}: kernel A {gf.launches - a0} launches, C "
        f"{ef.launches - c0}")

    # one step through F vs the same step on F's plain version
    trainer, state, g, targets = coo_step_setup(torch, np, work, samples,
                                                dropout=0.0)
    model = state.model
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def step():
        model.load_state_dict(snapshot)
        state.optimizer = AdamW(model.parameters(),
                                trainer.config.training.weight_decay)
        trainer.dropout_rng = make_dropout_key(SEED, trainer.device)
        losses, _ = trainer.train_step(state, g, targets, LR)
        return (float(losses["total"]),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    n0 = sr.launches
    lk, gk, pk = step()
    torch.cuda.synchronize()
    f_step = sr.launches - n0
    check(f_step == MODEL_LAYERS * sum(COO_F["GAT"]),
          f"[3j] F launches a step {f_step}")
    with mock.patch.object(sr, "segment_reduce_sorted",
                           lambda ct, p, r, n: sr.segment_reduce_reference(
                               ct, p, r, n)):
        n0 = sr.launches
        lp, gp, _ = step()
        check(sr.launches == n0, "the plain step launched F")
    l64, g64, terms = coo_step_f64(torch, trainer, model, snapshot, g,
                                   targets)
    # each gradient against the step in f64 (plain version): F's error no
    # more than the f32 plain version's own plus 1e-3 (3b's and 3d's
    # bound). Both f32 steps miss the f64 one by the model's own f32
    # error, which F does not change. Units: lin_edge and att_edge sum
    # over all ~1.9M edges and cancel, so their error is taken entry by
    # entry over the sum of the entry's |terms|; every other leaf over its
    # largest |entry|, and a leaf whose gradient is ~0 (the GAT biases
    # under a batch-statistics BatchNorm; any below 1e-3 of the largest)
    # over the largest gradient of all
    rel = abs(lk - lp) / abs(lp)
    big_g = max(r.abs().max().item() for r in g64.values())
    errs = {}
    for name, r in g64.items():
        if name in terms:
            t = terms[name].clamp_min(1e-30)
            errs[name] = (((gk[name] - r).abs() / t).max().item(),
                          ((gp[name] - r).abs() / t).max().item())
            continue
        scale = r.abs().max().item()
        if (scale < 1e-3 * big_g
                or ("GATConv" in name and name.endswith(".bias"))):
            scale = big_g
        errs[name] = ((gk[name] - r).abs().max().item() / scale,
                      (gp[name] - r).abs().max().item() / scale)
    rest = [k for k in errs if k not in terms]
    over = max(errs, key=lambda k: errs[k][0] - errs[k][1])
    worst_t = max(terms, key=lambda k: errs[k][0])
    worst_r = max(rest, key=lambda k: errs[k][0])
    log(f"[3j] one COO train step (merged batch of {TRAIN_BATCH} tiles, "
        f"N={g.x.shape[0]}, {int(g.edge_mask.sum())} live edges, dropout 0),"
        f" F ({f_step} launches) vs its plain version on the card: loss "
        f"{lk:.6f} vs {lp:.6f} (rel {rel:.2e}, tol 1e-5; f64 {l64:.6f}); "
        f"{len(gp)} gradients against the f64 step: {len(terms)} cancelling"
        f" leaves, F worst {errs[worst_t][0]:.3e} of the sum of |terms| "
        f"({worst_t}; plain f32 there {errs[worst_t][1]:.3e}); the other "
        f"{len(rest)}, F worst {errs[worst_r][0]:.3e} of scale ({worst_r}; "
        f"plain f32 there {errs[worst_r][1]:.3e}); F's largest excess over "
        f"the plain version {errs[over][0] - errs[over][1]:.3e} ({over}; "
        f"tol 1e-3)")
    check(rel <= 1e-5, f"[3j] step loss {lk} vs {lp}")
    for name, (ef_, ep_) in errs.items():
        check(ef_ <= ep_ + 1e-3,
              f"[3j] gradient {name}: F {ef_:.3e}, plain {ep_:.3e} (tol "
              f"plain + 1e-3)")
    worst = errs[over][0] - errs[over][1]

    # two steps from one state and seed: the same bits (dropout 0.1)
    trainer.config.model.dropout = 1.0 - KEEP
    for m in model.modules():
        if hasattr(m, "dropout"):
            m.dropout = 1.0 - KEEP
    (l1, _, p1), (l2, _, p2) = step(), step()
    same = l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    check(same, "[3j] two COO train steps differ")
    log(f"[3j] two COO train steps from one state and seed (dropout "
        f"{1 - KEEP:.1f}): loss {l1:.6f} both, every parameter bit for bit")

    # one epoch of --gnn-type GCN on 8 tiles
    h, w = COO_GCN_SURVEY
    gdata = work / "coo_gcn_data"
    gdata.mkdir(parents=True, exist_ok=True)
    write_geotiff(gdata / "survey.tif", depth[None, :h, :w],
                  pixel_scale=(1.0, 1.0), origin=(500000.0, 4000000.0),
                  nodata=float("nan"))
    g_tiles = sum(1 for _ in TileManager(TRAIN_TILE, 32, 0.3).iterate_tiles(
        depth[:h, :w]))
    check(g_tiles == 8, f"GCN survey tiles {g_tiles}")
    gtr = coo_train_cli(torch, np, gdata, work / "coo_gcn_run",
                        ["--gnn-type", "GCN"], g_tiles, "GCN")
    log(f"[3j] cli.train --trainer graph --gnn-type GCN on {g_tiles} tiles, "
        f"1 epoch: {gtr['steps']} steps in {gtr['wall']:.3f} s, F launches "
        f"{gtr['launches']}; train loss {gtr['hist']['train_loss']}")
    return dict(launches=tr["launches"], steps=tr["steps"], wall=tr["wall"],
                f_per_step=f_step, step_loss_rel=rel, step_grad_excess=worst,
                gcn=dict(steps=gtr["steps"], launches=gtr["launches"],
                         wall=gtr["wall"]),
                setup=(trainer, state, g, targets))


# -- phase 3k: the ground-truth workflow -----------------------------------------

GT_SURVEY = 1536        # the clean / noisy pair: 1536^2 cells of 1 m
GT_SHIFT = (3, 5)       # the noisy survey's origin, in cells down / right
GT_OFFSET = 0.05        # the noisy survey's systematic offset (m)
GT_ORIGIN = (2000.0, 6000.0)    # the clean survey's top-left (projected m)
GT_COMF = 1e5           # the ENC cell's coordinate factor: 6,000 m fits int32
# the ENC cell's features at ground-truth cells (row, col), with their disc
# radii (m, data/s57.FEATURE_CLASSES' defaults)
GT_FEATURES = (("WRECKS", 700, 400, 50.0), ("UWTROC", 1100, 1200, 25.0))
GT_WORKERS = (0, 2, 4)
GT_NOISE = 0.15         # prepare_ground_truth's default noise threshold (m)
IMPORT_REFINEMENTS = 100
REF_HIDDEN, REF_HEADS, REF_IN, REF_EDGE = 64, 4, 7, 3


def gt_geo(row, col):
    """Projected (x, y) of ground-truth cell (row, col): the GT raster
    starts at the noisy survey's origin, cells of 1 m."""
    return (GT_ORIGIN[0] + GT_SHIFT[1] + col,
            GT_ORIGIN[1] - GT_SHIFT[0] - row)


def gt_inputs(np, d):
    """The clean / noisy pair as deflate GeoTIFFs with geotransforms, and
    an ENC cell: a GT_SURVEY^2 surface (phase 3's kind: ramp, sinusoid,
    roughness, a NaN hole and dropouts) without spikes; the noisy copy has
    its origin GT_SHIFT cells down / right, lies GT_OFFSET deeper, carries
    1 % spikes of 0.5-4 m and an uncertainty band; the cell, written by the
    port's S57Writer, holds a wreck and a rock inside the overlap. Returns
    (clean, noisy)."""
    from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
    from bathymetric_gnn_tpu_torch.io.s57_8211 import S57Writer

    n, (dr, dc) = GT_SURVEY, GT_SHIFT
    surface, unc = synthetic_survey(np, n + dr, n + dc, SEED + 130,
                                    spikes=False)
    rg = np.random.default_rng(SEED + 131)
    clean = surface[:n, :n]
    noisy = surface[dr:, dc:] + np.float32(GT_OFFSET)
    hit = rg.random(noisy.shape) < 0.01
    noisy[hit] += (rg.uniform(0.5, 4.0, hit.sum())
                   * rg.choice([-1, 1], hit.sum())).astype(np.float32)
    d.mkdir(parents=True, exist_ok=True)
    x0, y0 = GT_ORIGIN
    write_geotiff(d / "clean.tif", clean[None], pixel_scale=(1.0, 1.0),
                  origin=(x0, y0), nodata=float("nan"))
    write_geotiff(d / "noisy.tif", np.stack([noisy, unc[dr:, dc:]]),
                  pixel_scale=(1.0, 1.0), origin=(x0 + dc, y0 - dr),
                  nodata=float("nan"))
    w = S57Writer(comf=GT_COMF)
    for cls, row, col, _ in GT_FEATURES:
        w.add_feature(cls, [w.add_node(*gt_geo(row, col))])
    w.save(d / "cell.000")
    return clean, noisy


def quiet_main(main, argv):
    """A CLI's main(argv) with its printed output kept off this log."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def gt_prepare(np, d, clean, noisy):
    """cli.prepare_ground_truth --s57 on the pair: 5 bands over the
    overlap, the reported offset near GT_OFFSET (and the median the code
    implies), class-1 discs at the two features, noise labels where
    |diff - offset| > GT_NOISE off the discs, nodata where either survey
    has none. Returns (stats, GT path, labels)."""
    from bathymetric_gnn_tpu_torch.cli import prepare_ground_truth as pg
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff

    t0 = time.perf_counter()
    stats = quiet_main(pg.main, [
        "--clean", str(d / "clean.tif"), "--noisy", str(d / "noisy.tif"),
        "--output-dir", str(d / "gt"), "--s57", str(d / "cell.000")])
    wall = time.perf_counter() - t0
    bands, info = read_geotiff(stats["output"])
    n, (dr, dc) = GT_SURVEY, GT_SHIFT
    shape = (n - dr, n - dc)
    check(bands.shape == (5,) + shape, f"[3k] GT bands {bands.shape}")
    check(info.geotransform[0] == GT_ORIGIN[0] + dc
          and info.geotransform[3] == GT_ORIGIN[1] - dr,
          f"[3k] GT origin {info.geotransform}")
    labels = bands[0]
    c, z = clean[dr:, dc:], noisy[:n - dr, :n - dc]
    valid = np.isfinite(c) & np.isfinite(z)
    check(np.array_equal(labels >= 0, valid), "[3k] GT valid cells")
    diff = np.where(valid, z - c, 0.0).astype(np.float32)
    off = float(np.median(diff[valid]))
    got = stats["systematic_offset_m"]
    check(got == round(off, 4) and abs(got - GT_OFFSET) < 1e-3,
          f"[3k] offset {got} (median {off}, want ~{GT_OFFSET})")
    rr, cc = np.ogrid[:shape[0], :shape[1]]
    discs = np.zeros(shape, bool)
    for _, row, col, radius in GT_FEATURES:
        discs |= (rr - row) ** 2 + (cc - col) ** 2 <= radius ** 2
    check(np.array_equal(labels == 1, discs & valid)
          and stats["feature_cells"] == int((discs & valid).sum()),
          "[3k] class-1 cells are not the features' discs")
    noise = np.abs(np.where(valid, diff - off, 0.0).astype(np.float32))
    check(np.array_equal(labels == 2, (noise > GT_NOISE) & valid & ~discs),
          "[3k] noise labels")
    log(f"[3k] cli.prepare_ground_truth --s57 on a {n}^2 clean / noisy pair"
        f" (noisy origin {dr} rows / {dc} cols in): {shape[0]}x{shape[1]} "
        f"overlap in {wall:.3f} s; offset {got} m (want ~{GT_OFFSET}); "
        f"{stats['valid_cells']} valid cells, {stats['noise_cells']} noise"
        f" ({stats['noise_pct']} %), {stats['feature_cells']} class-1 in "
        f"the {len(GT_FEATURES)} discs; every label as the pair implies")
    return stats, Path(stats["output"]), labels


def child_pids():
    """Pids of this process's live children, from /proc."""
    import os

    me, out = os.getpid(), []
    for p in Path("/proc").iterdir():
        if not p.name.isdigit():
            continue
        try:
            ppid = int((p / "stat").read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == me:
            out.append(int(p.name))
    return out


def proc_text(pid, name):
    try:
        return Path(f"/proc/{pid}/{name}").read_bytes().decode(
            errors="replace")
    except OSError:
        return ""


def card_contexts():
    """The rows nvidia-smi lists on the card, one a context: in a PID
    namespace its pids need not be this machine's, so rows are counted,
    not pids."""
    res = subprocess.run(["nvidia-smi",
                          "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return [r.strip() for r in res.stdout.splitlines() if r.strip()]


def holds_card(pid):
    """Whether ``pid`` has a card device file open or mapped (CUDA's
    initialisation opens /dev/nvidiactl and /dev/nvidia<N>)."""
    import os

    fds = Path(f"/proc/{pid}/fd")
    try:
        for fd in fds.iterdir():
            try:
                if os.readlink(fd).startswith("/dev/nvidia"):
                    return True
            except OSError:
                continue
    except OSError:
        pass
    return "/dev/nvidia" in proc_text(pid, "maps")


def is_worker(pid):
    """Whether ``pid`` runs a multiprocessing spawn worker."""
    return "spawn_main" in proc_text(pid, "cmdline")


class CardHolders:
    """Over a ``with`` block, sampled every ``period`` s in a thread: the
    most contexts nvidia-smi listed on the card at once, this process's
    spawned workers, and the workers that had a card device file open or
    mapped."""

    def __init__(self, period=0.25):
        import threading

        self.period = period
        self.rows, self.workers, self.holders = 0, set(), set()
        self.listed = []
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            rows = card_contexts()
            if len(rows) > self.rows:
                self.rows, self.listed = len(rows), rows
            for pid in child_pids():
                if is_worker(pid):
                    self.workers.add(pid)
                    if holds_card(pid):
                        self.holders.add(pid)
            self.samples += 1
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def gt_train(torch, np, work, gt, n_tiles):
    """cli.train --trainer graph --ground-truth-dir at --num-workers 0, 2
    and 4 (coo_train_cli's checks in each: F's launches as the code
    implies, no plain version); only this process on the card while the
    4 workers build tiles; the 2- and 4-worker histories bit for bit; the
    0-worker run's epoch-0 train loss within 1e-5 of the 2-worker run's."""
    import os

    runs = {}
    me = os.getpid()
    cpus = len(os.sched_getaffinity(0))
    parent_holds = holds_card(me)
    for w in GT_WORKERS:
        run = work / f"gt_run_w{w}"
        args = (torch, np, gt.parent, run, ["--num-workers", str(w)],
                n_tiles, "GAT")
        if w == max(GT_WORKERS):
            # two views of who holds the card, each checked to see this
            # process first: nvidia-smi's contexts (the count may not grow
            # while the workers run) and the card device files each
            # worker has open or mapped (none may)
            before = card_contexts()
            with CardHolders() as holders:
                tr = coo_train_cli(*args, data_flag="--ground-truth-dir")
            workers = holders.workers
            check(before or parent_holds, "[3k] neither nvidia-smi nor "
                  "/proc shows this process on the card: no check of the "
                  "workers is possible")
            check(len(workers) >= w, f"[3k] {len(workers)} workers seen")
            if before:
                check(holders.rows <= len(before), f"[3k] {holders.rows} "
                      f"contexts on the card while the workers ran "
                      f"({holders.listed}), {len(before)} before "
                      f"({before})")
            if parent_holds:
                check(not holders.holders, f"[3k] workers holding the "
                      f"card: {sorted(holders.holders)}")
            left = [p for p in child_pids() if is_worker(p)]
            check(not left, f"[3k] workers left after the run: {left}")
            log(f"[3k] while {w} workers built tiles ({holders.samples} "
                f"samples): nvidia-smi listed at most {holders.rows} "
                f"context(s) ({len(before)} before the run, this process's:"
                f" {before or 'not listed'}; "
                f"{'checked' if before else 'not checked'}); "
                f"{len(workers)} workers seen, {len(holders.holders)} of "
                f"them with a card device file open or mapped (this "
                f"process has: {parent_holds}; "
                f"{'checked' if parent_holds else 'not checked'}); no "
                f"worker left after the run")
        else:
            tr = coo_train_cli(*args, data_flag="--ground-truth-dir")
        runs[w] = tr
        log(f"[3k] cli.train --trainer graph --ground-truth-dir "
            f"--num-workers {w}: {n_tiles} GT tiles of {TRAIN_TILE}^2, "
            f"{tr['steps']} steps in {tr['wall']:.3f} s of wall clock "
            f"(with the stats sample, eval, calibration, checkpoints); "
            f"{tr['metrics']['tiles_per_s']} tiles/s (metrics.jsonl: the "
            f"epoch's tiles over the time from the trainer's set-up to the "
            f"end of its eval, {tr['metrics']['elapsed_s']} s); F launches "
            f"{tr['launches']}, plain version called 0 times; train loss "
            f"{tr['hist']['train_loss']}; {cpus} usable CPUs")
    h0, h2, h4 = (runs[w]["hist"] for w in GT_WORKERS)
    check(h2 == h4, f"[3k] 2- and 4-worker histories differ: {h2} {h4}")
    l0, l2 = h0["train_loss"][0], h2["train_loss"][0]
    rel = abs(l0 - l2) / abs(l2)
    check(rel <= 1e-5, f"[3k] epoch-0 train loss {l0} (0 workers) vs {l2} "
          f"(2 workers): rel {rel:.2e}")
    log(f"[3k] the 2- and 4-worker histories bit for bit; epoch-0 train "
        f"loss 0 workers {l0!r} vs 2 workers {l2!r} (rel {rel:.2e}, tol "
        f"1e-5)")
    return runs, cpus


def gt_serve_and_score(torch, np, work, d, gt, labels, ckpt):
    """cli.inference serves ``ckpt`` on the noisy survey (kernel A, 4 x
    the forward calls, no plain version); cli.evaluate_model scores its
    classification and confidence bands against the GT: the JSON's keys,
    and n_cells = the GT's valid cells in the overlap."""
    from bathymetric_gnn_tpu_torch.cli import evaluate_model as ecli
    from bathymetric_gnn_tpu_torch.cli import inference as icli
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

    pred = work / "gt_predictions.tif"
    plain = []
    with mock.patch.object(gf, "grid_gat_reference",
                           counted_calls(gf.grid_gat_reference, plain)):
        gf.launches = 0
        t0 = time.perf_counter()
        stats = quiet_main(icli.main, ["--input", str(d / "noisy.tif"),
                                       "--output", str(pred), "--model",
                                       str(ckpt)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gf.launches
    n = stats["tiles_processed"]
    calls = n // 8 + n % 8
    check(not plain, f"[3k] kernel A's plain version ran {len(plain)} times")
    check(launches == MODEL_LAYERS * calls, f"[3k] A launches {launches} != "
          f"{MODEL_LAYERS} x {calls} forward calls")
    t0 = time.perf_counter()
    m = quiet_main(ecli.main, ["--predictions", str(pred), "--ground-truth",
                               str(gt), "--class-band", "3",
                               "--confidence-band", "4", "--output-json",
                               str(work / "gt_metrics.json")])
    ewall = time.perf_counter() - t0
    check(set(m) >= {"accuracy", "macro_f1", "per_class",
                     "confusion_matrix", "calibration"}
          and set(m["per_class"]) == {"seafloor", "feature", "noise"},
          f"[3k] metrics keys {sorted(m)}")
    want = int((labels >= 0).sum())
    check(m["n_cells"] == want, f"[3k] n_cells {m['n_cells']} != {want}")
    log(f"[3k] cli.inference served {ckpt} on the noisy survey: {n} tiles "
        f"in {wall:.3f} s, kernel A launches {launches} = {MODEL_LAYERS} x "
        f"{calls} calls, plain version 0 times; cli.evaluate_model in "
        f"{ewall:.3f} s: {m['n_cells']} cells, accuracy {m['accuracy']}, "
        f"macro F1 {m['macro_f1']}, per class "
        f"{ {k: v['f1'] for k, v in m['per_class'].items()} }")
    return dict(launches=launches, calls=calls, wall=wall,
                macro_f1=m["macro_f1"], accuracy=m["accuracy"],
                n_cells=m["n_cells"])


def reference_state_dict(torch, np, seed):
    """A state_dict in the original PyTorch reference's layout and names
    (its BathymetricGNN: ``feature_extractor.mlp.*``, ``gnn.convs.{i}.*``
    as PyG's GATConv, ``gnn.norms.{i}.module.*`` as PyG's BatchNorm, the
    three heads' ``mlp.*``) at full width: GAT, 4 layers, hidden 64, 4
    heads (1 on the last layer), 7 inputs, edge_dim 3, values from seeded
    numpy; and the (port key, reference key, transposed) of every
    weight the import must carry."""
    rg = np.random.default_rng(seed)
    sd, pairs = {}, []

    def put(key, a, port=None, t=False):
        sd[key] = a
        if port:
            pairs.append((port, key, t))

    def lin(ref, port, out, inp, bias=True):
        put(f"{ref}.weight", rg.normal(0, inp ** -0.5, (out, inp)),
            f"{port}.kernel", True)
        if bias:
            put(f"{ref}.bias", rg.normal(0, 0.1, out), f"{port}.bias")

    hid = REF_HIDDEN
    lin("feature_extractor.mlp.0", "MLPFeatureExtractor_0.TorchLinear_0",
        hid, REF_IN)
    lin("feature_extractor.mlp.3", "MLPFeatureExtractor_0.TorchLinear_1",
        hid, hid)
    width = hid
    for i in range(MODEL_LAYERS):
        h = 1 if i == MODEL_LAYERS - 1 else REF_HEADS
        ref, port = f"gnn.convs.{i}", f"GridGATConv_{i}"
        put(f"{ref}.lin.weight", rg.normal(0, width ** -0.5,
                                           (h * hid, width)),
            f"{port}.lin_src", True)
        for a in ("att_src", "att_dst", "att_edge"):
            put(f"{ref}.{a}", rg.normal(0, 0.3, (1, h, hid)), f"{port}.{a}")
        put(f"{ref}.lin_edge.weight", rg.normal(0, 0.5, (h * hid, REF_EDGE)),
            f"{port}.lin_edge", True)
        put(f"{ref}.bias", rg.normal(0, 0.1, h * hid), f"{port}.bias")
        width = h * hid
        ref, port = f"gnn.norms.{i}.module", f"MaskedBatchNorm_{i}"
        put(f"{ref}.weight", rg.uniform(0.5, 1.5, width), f"{port}.scale")
        put(f"{ref}.bias", rg.normal(0, 0.1, width), f"{port}.bias")
        put(f"{ref}.running_mean", rg.normal(0, 0.2, width), f"{port}.mean")
        put(f"{ref}.running_var", rg.uniform(0.5, 2.0, width), f"{port}.var")
        sd[f"{ref}.num_batches_tracked"] = np.array(100)
    for name, port, out in (("classification_head", "ClassificationHead_0", 3),
                            ("confidence_head", "ConfidenceHead_0", 1),
                            ("correction_head", "CorrectionHead_0", 1)):
        lin(f"{name}.mlp.0", f"{port}.TorchLinear_0", hid // 2, hid)
        lin(f"{name}.mlp.3", f"{port}.TorchLinear_1", out, hid // 2)
    sd = {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in sd.items()}
    return sd, pairs


def gt_import(torch, np, work, e2e):
    """A reference-layout checkpoint at full width through
    cli.import_torch: every imported tensor equal to its source entry
    after the mapping; the checkpoint served on phase 3's survey through
    cli.inference (kernel A, 8 launches, no plain version) and on
    IMPORT_REFINEMENTS refinements through NativeVRProcessor(use_ell=False)
    (kernel F, 4 x 4 layers x the graph chunks, no plain version), twice,
    bit for bit."""
    from bathymetric_gnn_tpu_torch.cli import import_torch as imp
    from bathymetric_gnn_tpu_torch.cli import inference as icli
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.inference.native_vr import (
        NativeVRProcessor)
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.utils.weights import load_state_dict

    ref, pairs = reference_state_dict(torch, np, SEED + 140)
    src = work / "reference.pt"
    torch.save({"model_state_dict": ref, "in_channels": REF_IN,
                "edge_dim": REF_EDGE,
                "config": {"model": {"num_layers": MODEL_LAYERS,
                                     "gnn_type": "GAT",
                                     "hidden_channels": REF_HIDDEN,
                                     "attention_heads": REF_HEADS}}}, src)
    ckpt = quiet_main(imp.main, ["--input", str(src), "--output-dir",
                                 str(work / "imported")])
    sd, meta = load_state_dict(ckpt)
    check(sorted(sd) == sorted(p for p, _, _ in pairs),
          f"[3k] imported keys {sorted(set(sd) ^ {p for p, _, _ in pairs})}")
    for port, key, t in pairs:
        want = ref[key].t() if t else ref[key]
        check(torch.equal(sd[port], want), f"[3k] {port} != {key}")
    check(meta["trained_layout"] == "coo" and meta["imported_from"] == str(src),
          f"[3k] import meta {meta}")

    plain = []
    argv = ["--input", str(e2e["src"]), "--output",
            str(work / "imported_cleaned.tif"), "--model", str(ckpt)]
    with mock.patch.object(gf, "grid_gat_reference",
                           counted_calls(gf.grid_gat_reference, plain)):
        gf.launches = 0
        t0 = time.perf_counter()
        stats = quiet_main(icli.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        a_launches = gf.launches
    check(stats["tiles_processed"] == 9 and a_launches == MODEL_LAYERS * 2,
          f"[3k] imported model: {stats['tiles_processed']} tiles, A "
          f"launches {a_launches} (want {MODEL_LAYERS} x 2)")
    check(not plain, f"[3k] A's plain version ran {len(plain)} times")

    cfg = Config.load(ckpt / "config.yaml")
    proc = NativeVRProcessor(sd, cfg, node_budget=VR_BUDGET, use_ell=False)
    grids = make_refinements(np, IMPORT_REFINEMENTS, SEED + 141)
    chunks, runs = [], []
    launch = proc._launch_graphs_chunk

    def counted_chunk(idx):
        chunks.append(len(idx))
        return launch(idx)

    with mock.patch.object(proc, "_launch_graphs_chunk", counted_chunk), \
            mock.patch.object(sr, "segment_reduce_reference",
                              counted_calls(sr.segment_reduce_reference,
                                            plain)):
        for _ in range(2):
            chunks.clear()
            sr.launches = 0
            t0 = time.perf_counter()
            results = serve(proc, grids)
            torch.cuda.synchronize()
            runs.append((results, time.perf_counter() - t0, sr.launches,
                         len(chunks)))
    (res1, vwall, f_launches, n_chunks), (res2, _, _, _) = runs
    check_results(np, grids, res1, "3k")
    check(not plain, f"[3k] F's plain version ran {len(plain)} times")
    want = COO_F["GAT"][0] * MODEL_LAYERS * n_chunks
    check(f_launches == want, f"[3k] F launches {f_launches} != {want}")
    same = all(np.array_equal(a[c], b[c]) for a, b in zip(res1, res2)
               for c in ("classification", "confidence", "correction"))
    check(same, "[3k] two runs of the imported COO model differ")
    log(f"[3k] cli.import_torch: a reference-layout GAT state_dict at full "
        f"width ({len(ref)} entries, {len(pairs)} carried, each equal to its"
        f" source after the mapping) -> {ckpt}; cli.inference on phase 3's "
        f"{SURVEY}^2 survey: 9 tiles in {wall:.3f} s, A launches "
        f"{a_launches}; NativeVRProcessor(use_ell=False) on "
        f"{IMPORT_REFINEMENTS} refinements: {n_chunks} graph chunks in "
        f"{vwall:.3f} s, F launches {f_launches} = {COO_F['GAT'][0]} x "
        f"{MODEL_LAYERS} x {n_chunks}, two runs bit for bit; plain "
        f"versions called 0 times")
    return dict(a_launches=a_launches, f_launches=f_launches,
                chunks=n_chunks, serve_wall=wall, vr_wall=vwall)


def gt_reports(d, gt):
    """cli.diagnose_tiles on the noisy survey and
    cli.analyze_noise_patterns on the GT, their JSON printed; the preview
    and BAG explorer need matplotlib and h5py."""
    import importlib.util

    from bathymetric_gnn_tpu_torch.cli import analyze_noise_patterns as an
    from bathymetric_gnn_tpu_torch.cli import diagnose_tiles as dt

    diag = quiet_main(dt.main, [str(d / "noisy.tif")])
    noise = quiet_main(an.main, [str(gt)])
    check(list(diag.values())[0]["valid"] > 0
          and list(noise.values())[0]["noise_cells"] > 0, "[3k] reports")
    log(f"[3k] cli.diagnose_tiles: {json.dumps(diag)}")
    log(f"[3k] cli.analyze_noise_patterns: {json.dumps(noise)}")
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "h5py")}
    log(f"[3k] cli.render_preview and cli.explore_bag not run here: they "
        f"need matplotlib and h5py (installed here: {have}) and run no "
        f"device code; the CPU tests hold them against JAX's")
    return dict(diagnose=diag, noise_patterns=noise)


def phase_ground_truth(torch, np, work, e2e):
    """The model developer's ground-truth workflow on the card (a-g)."""
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training.datasets import (
        GroundTruthTileDataset)

    d = work / "gt_workflow"
    clean, noisy = gt_inputs(np, d)
    stats, gt, labels = gt_prepare(np, d, clean, noisy)
    n_tiles = len(GroundTruthTileDataset([str(gt)], Config(),
                                         tile_size=TRAIN_TILE, overlap=32))
    runs, cpus = gt_train(torch, np, work, gt, n_tiles)
    scored = gt_serve_and_score(torch, np, work, d, gt, labels,
                                work / "gt_run_w2" / "best")
    imported = gt_import(torch, np, work, e2e)
    gt_reports(d, gt)
    return dict(
        gt=dict(offset_m=stats["systematic_offset_m"],
                noise_cells=stats["noise_cells"],
                feature_cells=stats["feature_cells"]),
        tiles=n_tiles, usable_cpus=cpus,
        training={w: dict(tiles_per_s=r["metrics"]["tiles_per_s"],
                          elapsed_s=r["metrics"]["elapsed_s"],
                          wall_s=r["wall"], steps=r["steps"],
                          segment_reduce_launches=r["launches"])
                  for w, r in runs.items()},
        serving=scored, imported=imported)


# -- phase 4g: the COO path's timings --------------------------------------------

def coo_f_bound(live, n, f):
    """Least time of one F call: each live row of the [S, f] f32 input,
    its perm entry, row_ptr and the [n, f] output moved once over HBM
    bandwidth, vs one add per element read at the FP32 peak."""
    nbytes = 4 * (live * f + live + n + 1 + n * f)
    flops = live * f
    t_b = nbytes / PEAK_BYTES * 1e3
    t_o = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes


def device_ms(torch, fn, iters=20, reps=5):
    """Device time of one call of fn: ``iters`` calls captured in a CUDA
    graph (after two warm-up calls on the capture's side stream), replayed
    ``reps`` times between CUDA events after one untimed replay, the span
    over reps x iters: the calls' kernels back to back, with no host time
    between them. (torch.profiler dropped most of F's kernels from its
    sessions late in this script's process, so 4g does not read it.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / (reps * iters)


def host_us(torch, fn, iters=20):
    """Host time of one call of fn in microseconds: the enqueue of
    ``iters`` calls on the host clock, with no sync inside the span."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def phase_coo_timings(torch, np, coo, coo_train, kstep, flush_widths):
    """F at each COO shape (the flush's and the train batch's sums at every
    COO_WIDTHS width and their 256-wide gather backward): CUDA-event span
    over 20 calls, the device time of the calls' kernels (device_ms: a
    CUDA graph of 20 calls), the wrapper's host time a call, beside its
    bound, its plain version and index_add_ (event span and device time,
    its fill included), and its launches a run by width (``flush_widths``: 3i's serving run; the train
    step's recorded here). The COO model's 65,536-node flush forward
    beside route C (GATConvELL, kernel C) on the same chunk; the COO train
    step at N = 262,144 with its busy share, beside 4d's route-C step."""
    from collections import Counter

    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.models.gnn import make_model
    from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    trainer, state, gt, targets = coo_train["setup"]
    g = coo["g"]
    step_widths = []
    with f_widths(sr, step_widths):
        trainer.train_step(state, gt, targets, LR)
    torch.cuda.synchronize()
    step_widths = Counter(step_widths)
    gen = torch.Generator().manual_seed(SEED + 130)
    shapes = []
    for where, gg, counts in (("flush", g, flush_widths),
                              ("train", gt, step_widths)):
        shapes += [(f"{where} sum [E, {f}]", gg, gg.dst_table, gg.edge_dst,
                    f, counts) for f in COO_WIDTHS]
        shapes.append((f"{where} gather backward [E, 256]", gg, gg.src_table,
                       gg.edge_src, 256, counts))
    rows = []
    for label, gg, (perm, row_ptr), ids, f, counts in shapes:
        n, e = gg.x.shape[0], gg.edge_src.shape[0]
        m = gg.edge_mask
        live = int(m.sum())
        ct = torch.randn(e, f, generator=gen).to(gg.x.device)
        ct_live, ids_live = ct[m], ids[m].long()
        fn = lambda: sr.call_kernel(ct, perm, row_ptr, n)  # noqa: E731
        lib = lambda: torch.zeros(  # noqa: E731
            n, f, device=ct.device).index_add_(0, ids_live, ct_live)
        with torch.no_grad():
            ms = cuda_ms(torch, fn, 20)
            dev_ms = device_ms(torch, fn)
            h_us = host_us(torch, fn)
            plain_ms = cuda_ms(torch, lambda: sr.segment_reduce_reference(
                ct, perm, row_ptr, n), 5)
            lib_ms = cuda_ms(torch, lib, 20)
            lib_dev_ms = device_ms(torch, lib)
        b_ms, b_by, nbytes = coo_f_bound(live, n, f)
        launches = counts.get(f, 0)
        rows.append(dict(shape=f"{label}, N {n}, {live} live edges", ms=ms,
                         device_ms=dev_ms, host_us_per_call=h_us,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_device_ms=lib_dev_ms, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes,
                         launches_of_width_a_run=launches))
        share = b_ms / dev_ms
        log(f"[4g] F {label} (N {n}, {live} live of {e} edges): event span "
            f"{ms:.4f} ms, device {dev_ms:.4f} ms (CUDA graph), host "
            f"{h_us:.1f} us a call; index_add_ event span {lib_ms:.4f} ms, "
            f"device {lib_dev_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.1f} MB), {share:.3f} of bound (device); F "
            f"launches of width {f} (sums and gather backwards) a run: "
            f"{launches}")
        del ct, ct_live, ids_live
    log(f"[4g] F launches by width: 3i's serving run {dict(flush_widths)}, "
        f"a COO train step {dict(step_widths)}")

    cfg = Config()
    model = make_model(cfg.model, 8, dropout=0.0,
                       generator=torch.Generator().manual_seed(SEED + 131))
    ell = make_ell_model(cfg.model, 8, sparse_kernel="xla")
    ell.load_state_dict(model.state_dict())
    model, ell = model.to(g.x.device).eval(), ell.to(g.x.device).eval()
    with torch.no_grad():
        a, b = model(g), ell(coo["ell"])
        agree = (a["predicted_class"] == b["predicted_class"])[
            g.node_mask.bool()].float().mean().item()
        coo_ms = cuda_ms(torch, lambda: model(g), 5, warmup=2)
        ell_ms = cuda_ms(torch, lambda: ell(coo["ell"]), 5, warmup=2)
        wall, prows = device_profile(torch, lambda: [model(g)
                                                     for _ in range(5)])
    flush_busy = log_profile("4g", "5 COO flush forwards", wall, prows,
                             top=10)
    log(f"[4g] the {g.x.shape[0]}-node flush forward (full width, "
        f"{int(g.node_mask.sum())} nodes, {int(g.edge_mask.sum())} edges of "
        f"a grid-connectivity graph): COO model {coo_ms:.3f} ms, route C "
        f"(GATConvELL, kernel C) on the same chunk {ell_ms:.3f} ms; classes "
        f"agree on {agree:.6f} of live nodes")
    check(agree >= 0.99, "[4g] COO vs route C classes")

    fn = lambda: trainer.train_step(state, gt, targets, LR)  # noqa: E731
    step_ms = cuda_ms(torch, fn, 5, warmup=2)
    wall, prows = device_profile(torch, lambda: [fn() for _ in range(3)])
    busy = log_profile("4g", "3 COO train steps", wall, prows, top=12)
    f_dev = sum(r[0] for r in prows
                if "segred::sum_rows_kernel" in r[2]) / 3
    log(f"[4g] COO train step (merged batch of {TRAIN_BATCH} tiles, N="
        f"{gt.x.shape[0]}, {int(gt.edge_mask.sum())} live edges, full width,"
        f" dropout {trainer.config.model.dropout:.1f}, f32): {step_ms:.3f} "
        f"ms (CUDA events), device busy {busy}, kernel F {f_dev:.3f} ms a "
        f"step; beside 4d's route-C k-NN step in this run: "
        f"{kstep['ms']:.3f} ms ({step_ms / kstep['ms']:.2f} x)")
    return rows, dict(flush_ms=coo_ms, route_c_flush_ms=ell_ms,
                      flush_busy_share=flush_busy,
                      flush_class_agreement=agree, step_ms=step_ms,
                      step_busy_share=busy, step_f_ms=f_dev,
                      route_c_step_ms=kstep["ms"])


# -- phases 3l and 3m: the sharded paths ---------------------------------------

SHARD_SURVEY = 2048     # the sharded forward's survey: 2048^2 cells, holes
# SGD at learning rate 1: a leaf's change is minus its gradient (at 1e-3
# a parameter near 1 rounds its update to ~2e-4 of it)
SHARD_LR = 1.0
SHARD_WORLD = 2         # phase 3m's processes (gloo) on the one card
# phase 3l (world 1, NCCL): the data-parallel steps run the trainers'
# operations (the all-reduces are identities): losses within 1e-6
# relative, each leaf's change within 1e-6 of the largest change of any
# leaf. The halo steps run one rank's layers on the L + 2 rows of a halo
# block and on 3-row strips: 1e-5 of the largest change. Phase 3m (2
# ranks) also sums the BatchNorm moments, loss terms and gradients over
# ranks in another order; the first layers' weight gradients sum
# depth-scaled features (~30 m) over cells, which moves them by up to
# 1.5e-5 of the largest change in f32 on the CPU's plain versions and
# 4.2e-5 on the H100: its halo step 1e-4, the atol of JAX's own
# sharded-step tests (tests/test_halo.py:237-239). The COO step over 2
# ranks: 1e-3. Its f32 gradients miss the f64 step by up to 1.05e-2 of a
# leaf's largest entry (phase 3j), and the 2-rank step read 1.12e-4 on
# the H100, so two f32 steps that sum in other orders can differ by more
# than 1e-4 of the largest change. The k-NN step over 2 ranks: 1e-3 as
# well (it read 2.29e-4 on the H100, at the first GAT layer's lin_src,
# whose gradient two f32 steps give ~1e-3 of its largest entry apart,
# phase 3d); and each leaf's update no further from the exact objective's
# gradient in f64 than 3l's world-1 step's, plus 1e-3 of that gradient's
# largest entry (3d's measure). Its exact=False step runs each rank's own
# operations, as 3l's one-process reference does: 10 x the 3.64e-6 of the
# largest change that the world-2 step reads against JAX's on the CPU
# (python tests/torch_dp_local_bn_readings.py, route D).
SHARD_STEP_TOL = {"trainer": 1e-6, "halo": 1e-5, "halo_ranks": 1e-4,
                  "coo_ranks": 1e-3, "knn_ranks": 1e-3,
                  "knn_local_ranks": 3.64e-5, "knn_f64": 1e-3}
# the forward against the single-card model: classes on >= 99.99 % of the
# valid cells, confidence and correction within 1e-3
SHARD_CLASS_AGREE = 0.9999
SHARD_OUT_TOL = 1e-3


def shard_survey(np):
    """A SHARD_SURVEY^2 synthetic survey (``synthetic_survey``'s holes and
    spikes) with a hole across the middle row (where 2 row shards meet)
    and one across the middle column: (depth with 0 in holes, valid)."""
    depth, _ = synthetic_survey(np, SHARD_SURVEY, SHARD_SURVEY, SEED + 160)
    mid = SHARD_SURVEY // 2
    depth[mid - 30:mid + 30, 300:700] = np.nan
    depth[600:700, mid - 25:mid + 25] = np.nan
    valid = np.isfinite(depth)
    return np.nan_to_num(depth).astype(np.float32), valid


def np_state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def step_err(np, got, want, init, worst=False):
    """The largest difference of a leaf after two steps from one state:
    of a parameter, against the largest change of any parameter in
    ``want``'s step; of a BatchNorm statistic, against its largest |value|
    (with ``worst``: (difference, that leaf's name))."""
    stat = [k for k in want if k.endswith((".mean", ".var"))]
    scale = max(float(np.abs(want[k] - init[k]).max())
                for k in want if k not in stat)
    errs = []
    for k, w in want.items():
        s = max(float(np.abs(w).max()), 1e-12) if k in stat else scale
        errs.append((float(np.abs(got[k] - w).max()) / s, k))
    return max(errs) if worst else max(errs)[0]


def loss_err(want, got):
    return max(abs(float(got[k]) - float(want[k]))
               / max(abs(float(want[k])), 1e-12) for k in want)


def out_agreement(np, got, want, valid):
    """(class agreement on valid cells, max |confidence diff|, max
    |correction diff|) of two sharded or single-card outputs (NumPy)."""
    return (float((got["predicted_class"][valid]
                   == want["predicted_class"][valid]).mean()),
            float(np.abs(got["confidence"][valid]
                         - want["confidence"][valid]).max()),
            float(np.abs(got["correction"][valid]
                         - want["correction"][valid]).max()))


def check_outputs(np, tag, got, want, valid):
    agree, dc, dr = out_agreement(np, got, want, valid)
    log(f"{tag}: classes equal on {agree:.6f} of the valid cells, "
        f"|confidence| diff {dc:.3e}, |correction| diff {dr:.3e}")
    check(agree >= SHARD_CLASS_AGREE and dc <= SHARD_OUT_TOL
          and dr <= SHARD_OUT_TOL, f"{tag}: outputs differ")


def outputs_np(out):
    """The per-cell outputs a forward is checked on, as NumPy arrays."""
    return {"predicted_class": out["predicted_class"].cpu().numpy().astype(
                "uint8"),
            "confidence": out["confidence"].detach().cpu().numpy(),
            "correction": out["correction"].detach().cpu().numpy()}


def grid_per_tile_reference(torch, np, trainer, model, sd0, batch, lr):
    """The halo steps' objective on the single card: ``GridTrainer.
    train_step`` on each tile alone (SGD, from the same weights), the
    tiles' states and losses averaged (the mean of the tiles' updates is
    the update of the mean of their losses; the halo step applies each
    tile's BatchNorm, as the JAX step vmaps them). Returns (state, losses,
    accuracy, A / B launches a tile)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.training.optim import SGD
    from bathymetric_gnn_tpu_torch.training.trainer import TrainState

    states, losses, accs = [], [], []
    n = batch["noisy"].shape[0]
    gf.train_launches = gf.bwd_launches = 0
    for t in range(n):
        model.load_state_dict(sd0)
        st = TrainState(model, SGD(model.parameters()))
        tile = {k: v[t:t + 1] for k, v in batch.items()}
        lo, acc = trainer.train_step(st, tile, lr)
        states.append(np_state(model))
        losses.append({k: float(v) for k, v in lo.items()})
        accs.append(float(acc))
    torch.cuda.synchronize()
    launches = (gf.train_launches // n, gf.bwd_launches // n)
    mean = {k: np.mean([s[k] for s in states], 0).astype(states[0][k].dtype)
            for k in states[0]}
    return (mean, {k: float(np.mean([lo[k] for lo in losses]))
                   for k in losses[0]}, float(np.mean(accs)), launches)


def batch_part(tree, i):
    """Rank i's part of a stacked [B, ...] batch on SHARD_WORLD ranks, as
    ``shard_batch_pytree`` slices it."""
    from bathymetric_gnn_tpu_torch.parallel.mesh import _map, _rank_slice

    return _map(tree, lambda x: _rank_slice(x, i, SHARD_WORLD))


def local_bn_reference(torch, np, model, sd0, tc, loss_fn, parts):
    """The ``exact=False`` step of SHARD_WORLD ranks in one process: each
    rank's part (``parts``: (graph, targets, banded) on the card) through
    ``loss_fn`` without a group (its own BatchNorm moments and loss
    counts) from ``sd0``; the parts' gradients, losses and BatchNorm
    running statistics averaged, then the step's clip and SGD. Returns
    (state, losses)."""
    from bathymetric_gnn_tpu_torch.training.optim import (
        SGD, clip_by_global_norm_)

    params = list(model.parameters())
    grads, stats, losses = [], [], []
    for g, t, banded in parts:
        model.load_state_dict(sd0)
        for p in params:
            p.grad = None
        lo, _ = loss_fn(model, g, t,
                        torch.Generator(device="cuda").manual_seed(SEED),
                        banded)
        lo["total"].backward()
        grads.append([torch.zeros_like(p) if p.grad is None
                      else p.grad.clone() for p in params])
        stats.append({n: b.clone() for n, b in model.named_buffers()
                      if n.endswith((".mean", ".var"))})
        losses.append({k: float(v.detach()) for k, v in lo.items()})
    model.load_state_dict(sd0)
    mean = [torch.stack(gs).mean(0) for gs in zip(*grads)]
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for n in stats[0]:
            bufs[n].copy_(torch.stack([s[n] for s in stats]).mean(0))
    clip_by_global_norm_(mean, tc.grad_clip_norm)
    SGD(params).step(mean, SHARD_LR)
    return np_state(model), {k: float(np.mean([lo[k] for lo in losses]))
                             for k in losses[0]}


def f64_update_err(np, state, init, grads_f64):
    """Each parameter's SGD update (init - state) / SHARD_LR against its
    exact gradient in f64 (clipped as the step clips), as a share of that
    gradient's largest |entry|; of a GAT layer's bias, whose exact
    gradient is 0 (BatchNorm follows), of the largest |entry| of any
    gradient (phase 3d's scales)."""
    big = max(float(np.abs(g).max()) for g in grads_f64.values())
    out = {}
    for n, g in grads_f64.items():
        scale = (big if "GATConv" in n and n.endswith(".bias")
                 else float(np.abs(g).max()) + 1e-30)
        upd = (init[n].astype(np.float64)
               - state[n].astype(np.float64)) / SHARD_LR
        out[n] = float(np.abs(upd - g).max()) / scale
    return out


def local_bn_world1(torch, np, tag, run, want, want_losses, counts,
                    want_counts, plain):
    """3l's ``exact=False`` step at world 1 (``run()`` -> (state, losses,
    accuracy)): bit for bit the ``exact=True`` step's ``want``, with its
    launches and no plain version."""
    got, lo, acc = run()
    torch.cuda.synchronize()
    c = counts()
    diff = [k for k in want if not np.array_equal(got[k], want[k])]
    same_losses = all(float(lo[k]) == want_losses[k] for k in want_losses)
    log(f"[3l] {tag} with exact=False (world 1) vs exact=True: "
        f"{len(diff)} leaves differ, losses equal {same_losses}; launches "
        f"{c} (exact=True {want_counts}), plain calls {len(plain)}")
    check(not diff and same_losses,
          f"[3l] {tag}: exact=False differs from exact=True at world 1 "
          f"({diff[:4]})")
    check(c == want_counts and not plain,
          f"[3l] {tag} exact=False: launches / plain calls")
    return c


def phase_sharded_world1(torch, np, work, tr_data, csamples, ksamples,
                         model):
    """Phase 3l: the sharded paths at world 1 over NCCL (module docstring),
    with CUDA-event times beside their single-card counterparts."""
    import torch.distributed as dist

    from bathymetric_gnn_tpu_torch.parallel import collectives as C
    from bathymetric_gnn_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh)

    store = work / "store_3l"
    if store.exists():       # left by a run killed before its teardown
        store.unlink()
    info = initialize_distributed(f"file://{store}", 1, 0)
    try:
        check(dist.get_backend() == "nccl" and info["processes"] == 1,
              f"[3l] not an NCCL world of 1: {dist.get_backend()} {info}")
        mesh = make_mesh(graph_axis=1)
        mesh3 = make_mesh(shape=(1, 1, 1), axis_names=("data", "row", "col"))
        log(f"[3l] world 1 over {dist.get_backend()}: {info}; meshes "
            f"{mesh.mesh_dim_names} {tuple(mesh.shape)} and "
            f"{mesh3.mesh_dim_names} {tuple(mesh3.shape)}")
        res = {"coo": sharded_coo_step(torch, np, work, csamples, mesh),
               "sparse": sharded_knn_step(torch, np, work, ksamples, mesh),
               "grid": sharded_grid(torch, np, work, tr_data, model, mesh,
                                    mesh3)}
        ones = torch.ones(256, device="cuda")
        res["all_reduce_ms"] = cuda_ms(
            torch, lambda: C.all_reduce_sum(ones, mesh.get_group("graph")),
            20)
        log(f"[3l] all_reduce_sum of a BatchNorm moment (256 f32) over "
            f"NCCL, world 1: {res['all_reduce_ms']:.4f} ms")
    finally:
        dist.destroy_process_group()
    return res


def sharded_coo_step(torch, np, work, csamples, mesh):
    """The COO data-parallel step against ``Trainer.train_step`` (SGD,
    dropout 0, the 3j batch), then once at dropout 0.1."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.graph import CooGraph, merge_stacked
    from bathymetric_gnn_tpu_torch.parallel import data_parallel as DP
    from bathymetric_gnn_tpu_torch.training.datasets import collate_samples
    from bathymetric_gnn_tpu_torch.training.optim import SGD
    from bathymetric_gnn_tpu_torch.training.trainer import (
        TrainState, _to_device_targets, make_loss_fn)

    trainer, state, g, targets = coo_step_setup(torch, np, work, csamples,
                                                0.0)
    m = state.model
    sd0 = {k: v.clone() for k, v in m.state_dict().items()}
    init = np_state(m)
    graph_np, targets_np = collate_samples(csamples.samples)
    ref = TrainState(m, SGD(m.parameters()))
    sr.launches = 0
    lt, at = trainer.train_step(ref, g, targets, SHARD_LR)
    torch.cuda.synchronize()
    f_ref = sr.launches
    want = np_state(m)
    m.load_state_dict(sd0)
    st = TrainState(m, SGD(m.parameters()))
    tc = trainer.config.training
    step = DP.make_dp_train_step(m, st.optimizer, tc, trainer.class_weights,
                                 trainer.huber_delta, mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    plain = []
    with mock.patch.object(sr, "segment_reduce_reference",
                           counted_calls(sr.segment_reduce_reference,
                                         plain)):
        sr.launches = 0
        _, ld, ad = step(st, graph_np, targets_np, gen, SHARD_LR)
        torch.cuda.synchronize()
    f_dp = sr.launches
    err, lerr = step_err(np, np_state(m), want, init), loss_err(lt, ld)
    log(f"[3l] COO data-parallel step (world 1, {TRAIN_BATCH} tiles, "
        f"dropout 0, SGD lr {SHARD_LR}) vs Trainer.train_step: losses rel "
        f"{lerr:.3e}, accuracy {float(ad):.6f} vs {float(at):.6f}, updated "
        f"leaves {err:.3e} of the largest change; F launches {f_dp} "
        f"(Trainer step {f_ref}), plain calls {len(plain)}")
    check(f_dp == f_ref and f_dp > 0 and not plain,
          "[3l] COO DP step: F launches / plain calls")
    check(lerr <= SHARD_STEP_TOL["trainer"] and abs(float(ad) - float(at))
          <= 1e-6 and err <= SHARD_STEP_TOL["trainer"],
          "[3l] COO DP step differs from the trainer's")
    after = np_state(m)
    losses = {k: float(v) for k, v in ld.items()}
    # exact=False: at world 1 the same computation, bit for bit
    m.load_state_dict(sd0)
    st_l = TrainState(m, SGD(m.parameters()))
    step_l = DP.make_dp_train_step(m, st_l.optimizer, tc,
                                   trainer.class_weights,
                                   trainer.huber_delta, mesh, exact=False)

    def run_local():
        with mock.patch.object(sr, "segment_reduce_reference",
                               counted_calls(sr.segment_reduce_reference,
                                             plain)):
            sr.launches = 0
            _, lo, acc = step_l(st_l, graph_np, targets_np, gen, SHARD_LR)
            torch.cuda.synchronize()
        return np_state(m), lo, acc

    local_bn_world1(torch, np, "COO DP step", run_local, after, losses,
                    lambda: sr.launches, f_dp, plain)
    # the exact=False step of 2 ranks in this process: 3m's reference
    loss_fn = make_loss_fn(tc, trainer.class_weights, trainer.huber_delta,
                           True)
    parts = [(CooGraph.from_padded(merge_stacked(batch_part(graph_np, i))
                                   ).to("cuda"),
              _to_device_targets(batch_part(targets_np, i), "cuda"), None)
             for i in range(SHARD_WORLD)]
    local_state, local_losses = local_bn_reference(torch, np, m, sd0, tc,
                                                   loss_fn, parts)
    del parts
    m.load_state_dict(sd0)
    ms_l = cuda_ms(torch, lambda: step_l(st_l, graph_np, targets_np, gen,
                                         SHARD_LR), 3)
    # dropout 0.1: the step runs, finite, and moves every parameter leaf
    tr_d, st_d, _, _ = coo_step_setup(torch, np, work, csamples, 0.1)
    st_d.model.load_state_dict(sd0)
    st_d = TrainState(st_d.model, SGD(st_d.model.parameters()))
    step_d = DP.make_dp_train_step(st_d.model, st_d.optimizer, tc,
                                   tr_d.class_weights, tr_d.huber_delta,
                                   mesh)
    _, l_d, _ = step_d(st_d, graph_np, targets_np, gen, SHARD_LR)
    moved = [k for k, v in np_state(st_d.model).items()
             if not k.endswith((".mean", ".var")) and not np.array_equal(
                 v, init[k])]
    n_leaves = sum(1 for _ in st_d.model.parameters())
    log(f"[3l] COO data-parallel step at dropout 0.1: total loss "
        f"{float(l_d['total']):.6f}, {len(moved)}/{n_leaves} parameter "
        f"leaves moved")
    check(np.isfinite(float(l_d["total"])) and len(moved) == n_leaves,
          "[3l] COO DP step at dropout 0.1")
    ms = cuda_ms(torch, lambda: step(st, graph_np, targets_np, gen,
                                     SHARD_LR), 3)
    ms_ref = cuda_ms(torch, lambda: trainer.train_step(ref, g, targets,
                                                       SHARD_LR), 3)
    log(f"[3l] COO step: data-parallel {ms:.3f} ms (its CooGraph built "
        f"from the stacked batch on the host each call), exact=False "
        f"{ms_l:.3f} ms, Trainer.train_step {ms_ref:.3f} ms (graph "
        f"prebuilt)")
    return dict(launches=f_dp, trainer_launches=f_ref, loss_err=lerr,
                leaf_err=err, ms=ms, local_bn_ms=ms_l, trainer_ms=ms_ref,
                state=after, init=init, losses=losses, acc=float(ad),
                local_state=local_state, local_losses=local_losses,
                sd0=sd0, graph=graph_np, targets=targets_np,
                cw=trainer.class_weights.cpu(), hd=trainer.huber_delta,
                tc=tc)


def sharded_knn_step(torch, np, work, ksamples, mesh):
    """The k-NN data-parallel step (route C) against the Trainer's step on
    3d's merged batch (N = 262,144), SGD, dropout 0."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.graph import merge_stacked
    from bathymetric_gnn_tpu_torch.parallel import data_parallel as DP
    from bathymetric_gnn_tpu_torch.training.datasets import collate_samples
    from bathymetric_gnn_tpu_torch.training.optim import SGD
    from bathymetric_gnn_tpu_torch.training.trainer import (
        TrainState, _to_device_targets, make_loss_fn)

    trainer, state, g, targets = knn_step_setup(torch, np, work, ksamples,
                                                0.0)
    m = state.model
    sd0 = {k: v.clone() for k, v in m.state_dict().items()}
    init = np_state(m)
    graph_np, targets_np = collate_samples(ksamples.samples)
    tc = trainer.config.training

    def counts():
        return (ef.train_launches, ef.bwd_launches, sr.launches)

    ref = TrainState(m, SGD(m.parameters()))
    ef.train_launches = ef.bwd_launches = sr.launches = 0
    lt, at = trainer.train_step(ref, g, targets, SHARD_LR)
    torch.cuda.synchronize()
    c_ref = counts()
    want = np_state(m)
    m.load_state_dict(sd0)
    st = TrainState(m, SGD(m.parameters()))
    step = DP.make_dp_sparse_train_step(
        m, st.optimizer, tc, trainer.class_weights, trainer.huber_delta,
        mesh)
    gl, banded = DP.stack_banded_batches([(g, None)], mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    plain = []
    with mock.patch.object(ef, "ell_gat_reference", counted_calls(
            ef.ell_gat_reference, plain)):
        ef.train_launches = ef.bwd_launches = sr.launches = 0
        _, ld, ad = step(st, gl, banded, targets_np, gen, SHARD_LR)
        torch.cuda.synchronize()
    c_dp = counts()
    err, lerr = step_err(np, np_state(m), want, init), loss_err(lt, ld)
    log(f"[3l] k-NN data-parallel step (route C, N 262,144, world 1) vs the "
        f"Trainer's step: losses rel {lerr:.3e}, updated leaves {err:.3e} "
        f"of the largest change; launches C (training form) / C' / F "
        f"{c_dp} (Trainer step {c_ref}), plain calls {len(plain)}")
    check(c_dp == c_ref and min(c_dp) > 0 and not plain,
          "[3l] k-NN DP step: launches / plain calls")
    check(lerr <= SHARD_STEP_TOL["trainer"]
          and err <= SHARD_STEP_TOL["trainer"],
          "[3l] k-NN DP step differs from the trainer's")
    after = np_state(m)
    losses = {k: float(v) for k, v in ld.items()}
    # the exact objective's gradients in f64: 3m's step is held to be no
    # further from them than this one (SHARD_STEP_TOL)
    _, g64, _ = knn_step_f64(torch, trainer, m, sd0, g, targets)
    g64 = {n: v.detach().cpu().numpy() for n, v in g64.items()}
    torch.cuda.empty_cache()
    f64_err = f64_update_err(np, after, init, g64)
    worst = max(f64_err, key=f64_err.get)
    log(f"[3l] k-NN data-parallel step against the exact gradient in f64: "
        f"worst {worst} {f64_err[worst]:.3e} of its largest entry")
    # exact=False: at world 1 the same computation, bit for bit
    m.load_state_dict(sd0)
    st_l = TrainState(m, SGD(m.parameters()))
    step_l = DP.make_dp_sparse_train_step(
        m, st_l.optimizer, tc, trainer.class_weights, trainer.huber_delta,
        mesh, exact=False)

    def run_local():
        with mock.patch.object(ef, "ell_gat_reference", counted_calls(
                ef.ell_gat_reference, plain)):
            ef.train_launches = ef.bwd_launches = sr.launches = 0
            _, lo, acc = step_l(st_l, gl, banded, targets_np, gen, SHARD_LR)
            torch.cuda.synchronize()
        return np_state(m), lo, acc

    c_l = local_bn_world1(torch, np, "k-NN DP step", run_local, after,
                          losses, counts, c_dp, plain)
    # the exact=False step of 2 ranks in this process: 3m's reference, on
    # the ranks' own merged halves of the batch
    halves = [coo_to_ell(merge_stacked(batch_part(graph_np, i)), KNN_K
                         ).with_src_sorted_slots()
              for i in range(SHARD_WORLD)]
    loss_fn = make_loss_fn(tc, trainer.class_weights, trainer.huber_delta,
                           True)
    parts = [(h.to("cuda"), _to_device_targets(batch_part(targets_np, i),
                                               "cuda"), None)
             for i, h in enumerate(halves)]
    local_state, local_losses = local_bn_reference(torch, np, m, sd0, tc,
                                                   loss_fn, parts)
    del parts
    m.load_state_dict(sd0)
    ms = cuda_ms(torch, lambda: step(st, gl, banded, targets_np, gen,
                                     SHARD_LR), 3)
    ms_l = cuda_ms(torch, lambda: step_l(st_l, gl, banded, targets_np, gen,
                                         SHARD_LR), 3)
    ms_ref = cuda_ms(torch, lambda: trainer.train_step(ref, g, targets,
                                                       SHARD_LR), 3)
    log(f"[3l] k-NN step: data-parallel {ms:.3f} ms, exact=False "
        f"{ms_l:.3f} ms, Trainer.train_step {ms_ref:.3f} ms")
    return dict(launches=c_dp, local_bn_launches=c_l, loss_err=lerr,
                leaf_err=err, ms=ms, local_bn_ms=ms_l, trainer_ms=ms_ref,
                state=after, init=init, losses=losses, grads_f64=g64,
                f64_err=f64_err, local_state=local_state,
                local_losses=local_losses, sd0=sd0, halves=halves,
                targets=targets_np,
                cw=trainer.class_weights.cpu(), hd=trainer.huber_delta,
                tc=tc, dims=(int(graph_np.x.shape[-1]),
                             int(graph_np.edge_attr.shape[-1])))


def sharded_grid(torch, np, work, tr_data, model, mesh, mesh3):
    """The 1-D and 2-D halo forwards on the SHARD_SURVEY^2 survey against
    the single-card model, and their train steps on 3b's tiles against the
    grid trainer's per-tile steps (world 1)."""
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
    from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
    from bathymetric_gnn_tpu_torch.parallel import halo, halo2d
    from bathymetric_gnn_tpu_torch.training.optim import SGD
    from bathymetric_gnn_tpu_torch.training.trainer import TrainState

    depth, valid = shard_survey(np)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    d = torch.from_numpy(depth)[None].cuda()
    v = torch.from_numpy(valid)[None].cuda()

    def single():
        with torch.no_grad():
            return model(*build_grid_inputs(d, v)[:4])

    gf.launches = 0
    want = outputs_np({k: t[0] for k, t in single().items()})
    torch.cuda.synchronize()
    check(gf.launches == MODEL_LAYERS, f"[3l] single-card forward: "
          f"{gf.launches} launches of A")
    res = {"forward": {}}
    single_ms = cuda_ms(torch, single, 3)
    for name, cls, m_, kw in (
            ("1-D overlap", halo.HaloGridGNN, mesh, dict(overlap=True)),
            ("1-D serial", halo.HaloGridGNN, mesh, dict(overlap=False)),
            ("2-D", halo2d.HaloGrid2DGNN, mesh3, {})):
        hm = cls(7, 64, MODEL_LAYERS, 4, **kw).cuda()
        hm.load_state_dict(sd)
        fwd = (halo2d.make_sharded_grid2d_forward if cls is
               halo2d.HaloGrid2DGNN else halo.make_sharded_grid_forward)(
            hm, m_)
        plain = []
        with mock.patch.object(gf, "grid_gat_reference", counted_calls(
                gf.grid_gat_reference, plain)):
            gf.launches = 0
            got = outputs_np(fwd(depth, valid))
            torch.cuda.synchronize()
        want_launches = (1 + 3 * (MODEL_LAYERS - 1) if kw.get("overlap")
                         else MODEL_LAYERS)
        check_outputs(np, f"[3l] {name} sharded forward (world 1) vs the "
                      f"single-card model, {SHARD_SURVEY}^2", got, want,
                      valid)
        check(gf.launches == want_launches and not plain,
              f"[3l] {name}: {gf.launches} launches of A (want "
              f"{want_launches}), plain calls {len(plain)}")
        ms = cuda_ms(torch, lambda: fwd(depth, valid), 3)
        log(f"[3l] {name} forward: {ms:.3f} ms, A launches "
            f"{want_launches}; single-card GridBathymetricGNN "
            f"{single_ms:.3f} ms")
        res["forward"][name] = dict(launches=want_launches, ms=ms,
                                    agreement=out_agreement(np, got, want,
                                                            valid))
        if name == "1-D overlap":
            res["forward_out"] = got
        del got
    res["single_ms"] = single_ms
    res["valid"] = valid
    res["depth"] = depth
    del d, v

    trainer, gstate, batch = step_setup(torch, np, work, tr_data, "float32",
                                        dropout=0.0)
    trainer.config.training.grad_clip_norm = 1e9
    gm = gstate.model
    sd0 = {k: t.clone() for k, t in gm.state_dict().items()}
    init = np_state(gm)
    want_st, want_l, want_a, per_tile = grid_per_tile_reference(
        torch, np, trainer, gm, sd0, batch, SHARD_LR)
    tc = trainer.config.training
    res["steps"] = {}
    for name, cls, m_, make in (
            ("1-D", halo.HaloGridGNN, mesh, halo.make_halo_train_step),
            ("2-D", halo2d.HaloGrid2DGNN, mesh3,
             halo2d.make_halo2d_train_step)):
        hm = cls(7, 64, MODEL_LAYERS, 4, dropout=0.0).cuda()
        hm.load_state_dict(sd0)
        st = TrainState(hm, SGD(hm.parameters()))
        step = make(hm, st.optimizer, tc, trainer.class_weights,
                    trainer.huber_delta, m_, trainer.resolution)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        plain = []
        with mock.patch.object(gf, "grid_gat_reference", counted_calls(
                gf.grid_gat_reference, plain)):
            gf.train_launches = gf.bwd_launches = 0
            _, lo, acc = step(st, batch, gen, SHARD_LR)
            torch.cuda.synchronize()
        launches = (gf.train_launches, gf.bwd_launches)
        err, lerr = step_err(np, np_state(hm), want_st, init), loss_err(
            want_l, lo)
        per = (1 + 3 * (MODEL_LAYERS - 1)) if name == "1-D" else MODEL_LAYERS
        log(f"[3l] {name} halo train step (world 1, {TRAIN_BATCH} tiles of "
            f"{TRAIN_TILE}^2, dropout 0, SGD) vs GridTrainer.train_step on "
            f"each tile: losses rel {lerr:.3e}, accuracy {float(acc):.6f} "
            f"vs {want_a:.6f}, updated leaves {err:.3e} of the largest "
            f"change; A / B launches {launches} (GridTrainer {per_tile} a "
            f"tile), plain calls {len(plain)}")
        check(launches == (TRAIN_BATCH * per, TRAIN_BATCH * per)
              and not plain,
              f"[3l] {name} halo step launches {launches}, plain calls "
              f"{len(plain)}")
        check(lerr <= SHARD_STEP_TOL["halo"] and err <= SHARD_STEP_TOL["halo"]
              and abs(float(acc) - want_a) <= 1e-6,
              f"[3l] {name} halo step differs from the grid trainer's")
        if name == "1-D":
            res["halo_state"], res["halo_losses"] = np_state(hm), {
                k: float(t) for k, t in lo.items()}
        ms = cuda_ms(torch, lambda: step(st, batch, gen, SHARD_LR), 2)
        res["steps"][name] = dict(launches=launches, loss_err=lerr,
                                  leaf_err=err, ms=ms)
    st_ref = TrainState(gm, SGD(gm.parameters()))
    gm.load_state_dict(sd0)
    ms_ref = cuda_ms(torch, lambda: trainer.train_step(st_ref, batch,
                                                       SHARD_LR), 2)
    log(f"[3l] halo train steps: 1-D {res['steps']['1-D']['ms']:.3f} ms, "
        f"2-D {res['steps']['2-D']['ms']:.3f} ms, GridTrainer.train_step "
        f"on the {TRAIN_BATCH} tiles {ms_ref:.3f} ms")
    res.update(grid_trainer_ms=ms_ref, grid_sd0=sd0, grid_init=init,
               batch=batch, grid_tc=tc, grid_cw=trainer.class_weights.cpu(),
               grid_hd=trainer.huber_delta, grid_sd=sd)
    return res


def _sharded_worker(rank, world, init_method, inputs, out_dir):
    """Phase 3m's rank: the sharded paths over a gloo group, their compute
    on the card; writes its results, or its traceback, under out_dir."""
    import torch

    sys.path.insert(0, str(HERE))
    out = Path(out_dir)
    try:
        from bathymetric_gnn_tpu_torch.models.gnn import make_model
        from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
        from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
        from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf
        from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
        from bathymetric_gnn_tpu_torch.parallel import collectives as C
        from bathymetric_gnn_tpu_torch.parallel import data_parallel as DP
        from bathymetric_gnn_tpu_torch.parallel import halo, halo2d
        from bathymetric_gnn_tpu_torch.parallel.mesh import (
            host_local_batch_to_global, initialize_distributed, make_mesh,
            shard_batch_pytree)
        from bathymetric_gnn_tpu_torch.config.config import Config
        from bathymetric_gnn_tpu_torch.training.optim import SGD
        from bathymetric_gnn_tpu_torch.training.trainer import TrainState

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        initialize_distributed(init_method, world, rank, backend="gloo")
        inp = torch.load(inputs, weights_only=False)
        res, lines = {"fwd": {}}, []
        # the plain versions of A / B, of C / C' and of F, counted for the
        # rank's whole run: none may run on the card's path
        plain = []
        for mod, name in ((gf, "grid_gat_reference"),
                          (ef, "ell_gat_reference"),
                          (sr, "segment_reduce_reference")):
            setattr(mod, name, counted_calls(getattr(mod, name), plain))
        depth, valid = inp["depth"], inp["valid"]
        for name, shape, axes in (
                ("1-D overlap", (1, world), ("graph",)),
                ("1-D serial", (1, world), ("graph",)),
                ("2-D 1 x 2", (1, 1, world), ("row", "col")),
                ("2-D 2 x 1", (1, world, 1), ("row", "col"))):
            mesh = make_mesh(shape=shape, axis_names=("data",) + axes)
            if len(axes) == 1:
                hm = halo.HaloGridGNN(7, 64, MODEL_LAYERS, 4,
                                      overlap="overlap" in name)
                make = halo.make_sharded_grid_forward
            else:
                hm = halo2d.HaloGrid2DGNN(7, 64, MODEL_LAYERS, 4)
                make = halo2d.make_sharded_grid2d_forward
            hm = hm.cuda()
            hm.load_state_dict(inp["grid_sd"])
            fwd = make(hm, mesh)
            gf.launches = 0
            fo = fwd(depth, valid)
            torch.cuda.synchronize()
            launches = gf.launches
            ms = cuda_ms(torch, lambda: fwd(depth, valid), 2)
            lines.append(f"{name} forward: {ms:.3f} ms, A launches "
                         f"{launches}")
            res["fwd"][name] = dict(ms=ms, launches=launches)
            if rank == 0:
                res["fwd"][name]["out"] = outputs_np(fo)
            del fo
        # the exchange of one layer's boundary rows (2 x 2048 x 256 f32)
        # and a BatchNorm moment's all-reduce, through the host on gloo
        g = make_mesh(shape=(1, world), axis_names=("data", "graph")
                      ).get_group("graph")
        x = torch.randn(4, SHARD_SURVEY, 256, device="cuda")
        res["exchange_ms"] = cuda_ms(
            torch, lambda: C.halo_rows_split(x, 1, g), 5)
        ones = torch.ones(256, device="cuda")
        res["all_reduce_ms"] = cuda_ms(torch,
                                       lambda: C.all_reduce_sum(ones, g), 20)
        del x
        # the 1-D halo train step, rows over 2 ranks
        mesh = make_mesh(shape=(1, world), axis_names=("data", "graph"))
        hm = halo.HaloGridGNN(7, 64, MODEL_LAYERS, 4, dropout=0.0).cuda()
        hm.load_state_dict(inp["grid_sd0"])
        st = TrainState(hm, SGD(hm.parameters()))
        step = halo.make_halo_train_step(
            hm, st.optimizer, inp["grid_tc"], inp["grid_cw"].cuda(),
            inp["grid_hd"], mesh)
        local = host_local_batch_to_global(
            inp["batch"], mesh, lambda a: ("data", "graph"))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        gf.train_launches = gf.bwd_launches = 0
        _, lo, acc = step(st, local, gen, SHARD_LR)
        torch.cuda.synchronize()
        res["halo_step"] = dict(
            state=np_state(hm), losses={k: float(v) for k, v in lo.items()},
            acc=float(acc), launches=(gf.train_launches, gf.bwd_launches),
            ms=cuda_ms(torch, lambda: step(st, local, gen, SHARD_LR), 2))
        # the COO data-parallel step, 2 tiles a rank
        mesh = make_mesh(graph_axis=1)
        cfg = Config()
        cm = make_model(cfg.model, 7, dropout=0.0).cuda()
        cm.load_state_dict(inp["coo_sd0"])
        st = TrainState(cm, SGD(cm.parameters()))
        step = DP.make_dp_train_step(cm, st.optimizer, inp["coo_tc"],
                                     inp["coo_cw"].cuda(), inp["coo_hd"],
                                     mesh)
        gl = shard_batch_pytree(inp["coo_graph"], mesh)
        tl = shard_batch_pytree(inp["coo_targets"], mesh)
        sr.launches = 0
        _, lo, acc = step(st, gl, tl, gen, SHARD_LR)
        torch.cuda.synchronize()
        res["coo_step"] = dict(
            state=np_state(cm), losses={k: float(v) for k, v in lo.items()},
            acc=float(acc), launches=sr.launches,
            ms=cuda_ms(torch, lambda: step(st, gl, tl, gen, SHARD_LR), 2))
        # the COO step with exact=False (local BatchNorm), then the k-NN
        # step (route C: C / C' / F (b)) in both modes, 2 tiles a rank
        cm.load_state_dict(inp["coo_sd0"])
        st = TrainState(cm, SGD(cm.parameters()))
        step = DP.make_dp_train_step(cm, st.optimizer, inp["coo_tc"],
                                     inp["coo_cw"].cuda(), inp["coo_hd"],
                                     mesh, exact=False)
        sr.launches = 0
        _, lo, acc = step(st, gl, tl, gen, SHARD_LR)
        torch.cuda.synchronize()
        res["coo_local_bn_step"] = dict(
            state=np_state(cm), losses={k: float(v) for k, v in lo.items()},
            acc=float(acc), launches=sr.launches,
            ms=cuda_ms(torch, lambda: step(st, gl, tl, gen, SHARD_LR), 2))
        del cm, st, step
        km = make_ell_model(cfg.model, inp["knn_dims"][0],
                            edge_dim=inp["knn_dims"][1],
                            sparse_kernel="banded_pallas").cuda()
        kg, kb = DP.stack_banded_batches(
            [(h, None) for h in inp["knn_halves"]], mesh)
        kg = kg.to("cuda")
        kt = shard_batch_pytree(inp["knn_targets"], mesh)
        for key, exact in (("knn_step", True), ("knn_local_bn_step", False)):
            km.load_state_dict(inp["knn_sd0"])
            st = TrainState(km, SGD(km.parameters()))
            step = DP.make_dp_sparse_train_step(
                km, st.optimizer, inp["knn_tc"], inp["knn_cw"].cuda(),
                inp["knn_hd"], mesh, exact=exact)
            ef.train_launches = ef.bwd_launches = sr.launches = 0
            _, lo, acc = step(st, kg, kb, kt, gen, SHARD_LR)
            torch.cuda.synchronize()
            res[key] = dict(
                state=np_state(km),
                losses={k: float(v) for k, v in lo.items()}, acc=float(acc),
                launches=(ef.train_launches, ef.bwd_launches, sr.launches),
                ms=cuda_ms(torch, lambda: step(st, kg, kb, kt, gen,
                                               SHARD_LR), 2))
        res["lines"] = lines
        res["plain_calls"] = list(plain)
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def sharded_summary(w1, w2):
    """Phases 3l and 3m's numbers for the kernels' JSON line."""
    g = w1["grid"]
    keep = ("launches", "local_bn_launches", "loss_err", "leaf_err", "ms",
            "local_bn_ms", "trainer_ms", "trainer_launches")
    return {
        "world_1_nccl": {
            "forward": g["forward"], "single_card_forward_ms": g["single_ms"],
            "halo_steps": g["steps"], "grid_trainer_step_ms":
                g["grid_trainer_ms"],
            "coo_dp_step": {k: w1["coo"][k] for k in keep if k in w1["coo"]},
            "knn_dp_step": {k: w1["sparse"][k] for k in keep
                            if k in w1["sparse"]},
            "all_reduce_ms": w1["all_reduce_ms"]},
        "two_ranks_gloo": w2}


def phase_sharded_two_ranks(torch, np, work, w1):
    """Phase 3m: SHARD_WORLD processes on the one card over a gloo group
    (NCCL refuses two ranks on one device), each rank's compute on the
    card, held against phase 3l's world-1 results."""
    import torch.multiprocessing as mp

    out = work / "sharded_3m"
    if out.exists():
        for p in out.iterdir():
            p.unlink()
    out.mkdir(parents=True, exist_ok=True)
    g, c, k = w1["grid"], w1["coo"], w1["sparse"]
    inputs = out / "inputs.pt"
    torch.save(dict(
        depth=g["depth"], valid=g["valid"], grid_sd=g["grid_sd"],
        grid_sd0=g["grid_sd0"], grid_tc=g["grid_tc"], grid_cw=g["grid_cw"],
        grid_hd=g["grid_hd"], batch=g["batch"], coo_sd0=c["sd0"],
        coo_tc=c["tc"], coo_cw=c["cw"], coo_hd=c["hd"], coo_graph=c["graph"],
        coo_targets=c["targets"], knn_sd0=k["sd0"], knn_tc=k["tc"],
        knn_cw=k["cw"], knn_hd=k["hd"], knn_halves=k["halves"],
        knn_targets=k["targets"], knn_dims=k["dims"]), inputs)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.spawn(_sharded_worker, args=(SHARD_WORLD,
                                          f"file://{out}/store", str(inputs),
                                          str(out)),
                   nprocs=SHARD_WORLD, join=False)
    failed = None
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 600:
                failed = "timed out after 600 s"
                break
    except Exception as e:                      # a rank raised
        failed = f"{type(e).__name__}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    for r in range(SHARD_WORLD):
        err = out / f"rank{r}.err"
        if err.exists():
            log(f"[3m] rank {r} failed:\n{err.read_text()}")
    check(failed is None, f"[3m] the ranks failed: {failed}")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(SHARD_WORLD)]
    wall = time.perf_counter() - t0
    fails = []
    valid = g["valid"]
    for r, res in enumerate(ranks):
        for line in res["lines"]:
            log(f"[3m] rank {r}: {line}")
        log(f"[3m] rank {r}: exchange of one layer's boundary rows "
            f"({SHARD_SURVEY} x 256 f32 each way, through the host) "
            f"{res['exchange_ms']:.3f} ms; all_reduce_sum of 256 f32 "
            f"{res['all_reduce_ms']:.4f} ms")
        want_fwd = {"1-D overlap": 1 + 3 * (MODEL_LAYERS - 1)}
        for name, f in res["fwd"].items():
            want = want_fwd.get(name, MODEL_LAYERS)
            if f["launches"] != want:
                fails.append(f"rank {r} {name}: {f['launches']} launches "
                             f"of A, want {want}")
        hs = res["halo_step"]
        per = TRAIN_BATCH * (1 + 3 * (MODEL_LAYERS - 1))
        if hs["launches"] != (per, per):
            fails.append(f"rank {r} halo step launches {hs['launches']}")
        for tag, got, want, tol in (
                ("1-D halo train step", hs, (g["halo_state"],
                                             g["halo_losses"]),
                 SHARD_STEP_TOL["halo_ranks"]),
                ("COO data-parallel step", res["coo_step"],
                 (c["state"], c["losses"]), SHARD_STEP_TOL["coo_ranks"]),
                ("COO data-parallel step, exact=False",
                 res["coo_local_bn_step"],
                 (c["local_state"], c["local_losses"]),
                 SHARD_STEP_TOL["coo_ranks"]),
                ("k-NN data-parallel step", res["knn_step"],
                 (k["state"], k["losses"]), SHARD_STEP_TOL["knn_ranks"]),
                ("k-NN data-parallel step, exact=False",
                 res["knn_local_bn_step"],
                 (k["local_state"], k["local_losses"]),
                 SHARD_STEP_TOL["knn_local_ranks"])):
            init = (g["grid_init"] if "halo" in tag
                    else k["init"] if "k-NN" in tag else c["init"])
            err, leaf = step_err(np, got["state"], want[0], init, True)
            lerr = loss_err(want[1], got["losses"])
            log(f"[3m] rank {r}: {tag} (2 ranks) vs 3l's world 1: losses "
                f"rel {lerr:.3e}, updated leaves {err:.3e} of the largest "
                f"change (at {leaf}; tol {tol:g}); {got['ms']:.3f} ms; "
                f"launches {got['launches']}")
            if max(err, lerr) > tol:
                fails.append(f"rank {r} {tag}: {err:.3e} / {lerr:.3e}")
        for key in ("coo_step", "coo_local_bn_step"):
            if res[key]["launches"] != c["launches"]:
                fails.append(f"rank {r}: {res[key]['launches']} F "
                             f"launches in {key}, 3l's {c['launches']}")
        e64 = f64_update_err(np, res["knn_step"]["state"], k["init"],
                             k["grads_f64"])
        over = {n: (e64[n], k["f64_err"][n]) for n in e64
                if e64[n] > k["f64_err"][n] + SHARD_STEP_TOL["knn_f64"]}
        worst = max(e64, key=lambda n: e64[n] - k["f64_err"][n])
        log(f"[3m] rank {r}: k-NN data-parallel step (2 ranks) against the "
            f"exact gradient in f64: worst {worst} {e64[worst]:.3e} of its "
            f"largest entry (3l's world-1 step {k['f64_err'][worst]:.3e}; "
            f"tol 3l's + {SHARD_STEP_TOL['knn_f64']:g})")
        if over:
            fails.append(f"rank {r} k-NN step against f64: {over}")
        for key in ("knn_step", "knn_local_bn_step"):
            if res[key]["launches"] != k["launches"]:
                fails.append(f"rank {r}: C / C' / F launches "
                             f"{res[key]['launches']} in {key}, 3l's "
                             f"{k['launches']}")
        log(f"[3m] rank {r}: plain calls {len(res['plain_calls'])}")
        if res["plain_calls"]:
            fails.append(f"rank {r}: plain versions ran: "
                         f"{sorted(set(res['plain_calls']))}")
    for name, f in ranks[0]["fwd"].items():
        agree, dc, dr = out_agreement(np, f["out"], g["forward_out"], valid)
        log(f"[3m] {name} forward (2 ranks) vs 3l's world 1: classes equal "
            f"on {agree:.6f} of the valid cells, |confidence| diff "
            f"{dc:.3e}, |correction| diff {dr:.3e}")
        if (agree < SHARD_CLASS_AGREE or dc > SHARD_OUT_TOL
                or dr > SHARD_OUT_TOL):
            fails.append(f"{name} forward differs from world 1")
    for f in fails:
        log(f"[3m] FAILED: {f}")
    check(not fails, f"[3m] {len(fails)} failed checks")
    log(f"[3m] {SHARD_WORLD} ranks on one card (gloo), spawn to join: "
        f"{wall:.3f} s")
    return dict(wall_s=wall, ranks=[{k: v for k, v in res.items()
                                     if k in ("exchange_ms",
                                              "all_reduce_ms")}
                                    | {"fwd_ms": {n: f["ms"] for n, f in
                                                  res["fwd"].items()},
                                       "halo_step_ms":
                                           res["halo_step"]["ms"]}
                                    | {key: {"ms": res[key]["ms"],
                                             "launches": res[key]["launches"]}
                                       for key in ("coo_step",
                                                   "coo_local_bn_step",
                                                   "knn_step",
                                                   "knn_local_bn_step")}
                                    for res in ranks])


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
        scases = slab_layer_cases(torch, np, model, dev)
        errs = phase_kernel_vs_plain(torch, cases + scases)
        phase = "2a kernels A and B under guard pages, repeated bit for bit"
        tcases = train_cases(torch, np, dev)
        guard_2a = phase_guard_and_repeat(torch, np, cases + scases, tcases,
                                          dev)
        phase = "2b training kernels vs plain"
        terrs = phase_train_kernels_vs_plain(torch, tcases)
        phase = "2c kernel C vs plain"
        kmodel = ell_model(torch, dev)
        ecases, kgraph = ell_cases(torch, np, kmodel, dev)
        eerrs = phase_ell_kernel_vs_plain(torch, ecases)
        phase = "2d kernels C (training form), C' and F vs plain"
        ksamples = knn_train_samples(np, knn_survey(np, KNN_BATCH_SURVEY,
                                                    SEED + 60)[0])
        kcases, kbatch = knn_train_cases(torch, np, kmodel, dev, ksamples)
        kerrs = phase_knn_train_kernels_vs_plain(torch, kcases)
        wide_cp = phase_wide_rows(torch, np, dev, "2d")
        phase = "2e kernels E, D and D' vs plain"
        becases = band_cases(torch, np, kmodel, dev, kgraph, SEED + 90)
        bdcases = band_cases(torch, np, kmodel, dev, kbatch, SEED + 91)
        berrs = phase_banded_kernels_vs_plain(torch, becases, bdcases)
        wide_dp = phase_wide_rows(torch, np, dev, "2e")
        phase = "2f the bf16 forms vs plain"
        ferrs = phase_bf16_kernels_vs_plain(torch, ecases, kcases, becases,
                                            bdcases)
        phase = "2g kernel F as the COO segment sum vs plain"
        t2g = time.perf_counter()
        coo_errs, coo = phase_coo_segment_vs_plain(torch, np, dev)
        log(f"[2g] phase 2g took {time.perf_counter() - t2g:.3f} s")
        phase = "3 end to end"
        e2e = phase_end_to_end(torch, np, model, work)
        pipe.load_model(e2e["ckpt"])
        phase_model_kernel_vs_plain(torch, np, pipe, e2e["depth"])
        phase = "3b training end to end"
        tr = phase_train_end_to_end(torch, np, work)
        phase_train_step_kernel_vs_plain(torch, np, work, tr["data"])
        phase = "3c k-NN serving"
        vr = phase_vr_knn(torch, np, work)
        phase = "3d k-NN training end to end"
        ktr = phase_knn_train_end_to_end(torch, np, work)
        phase_knn_step_kernel_vs_plain(torch, np, work, ksamples)
        phase = "3e k-NN serving on the banded route"
        bvr = phase_vr_banded(torch, np, work, vr)
        phase = "3f the bf16 model and banded training"
        bmod = phase_bf16_model(torch, np, kmodel, kgraph, becases[0][2],
                                work, ksamples)
        phase = "3g the default VR route"
        dvr = phase_vr_default(torch, np, work, vr)
        phase = "3h streaming survey inference"
        t3h = time.perf_counter()
        stream = phase_streaming(torch, np, work, e2e)
        stream["phase_s"] = time.perf_counter() - t3h
        log(f"[3h] phase 3h took {stream['phase_s']:.3f} s")
        phase = "3i COO serving, non-GAT serving and the smoke test"
        t3i = time.perf_counter()
        cvr = phase_vr_coo(torch, np, work, vr, dvr)
        log(f"[3i] phase 3i took {time.perf_counter() - t3i:.3f} s")
        phase = "3j COO training"
        t3j = time.perf_counter()
        csamples = coo_train_samples(np, knn_survey(
            np, KNN_BATCH_SURVEY, SEED + 60)[0])
        ctr = phase_coo_train(torch, np, work, csamples)
        log(f"[3j] phase 3j took {time.perf_counter() - t3j:.3f} s")
        phase = "3k the ground-truth workflow"
        t3k = time.perf_counter()
        gtw = phase_ground_truth(torch, np, work, e2e)
        gtw["phase_s"] = time.perf_counter() - t3k
        log(f"[3k] phase 3k took {gtw['phase_s']:.3f} s")
        phase = "3l the sharded paths, world 1 over NCCL"
        t3l = time.perf_counter()
        shard1 = phase_sharded_world1(torch, np, work, tr["data"], csamples,
                                      ksamples, model)
        log(f"[3l] phase 3l took {time.perf_counter() - t3l:.3f} s")
        phase = "3m the sharded paths, 2 ranks on the card over gloo"
        t3m = time.perf_counter()
        shard2 = phase_sharded_two_ranks(torch, np, work, shard1)
        log(f"[3m] phase 3m took {time.perf_counter() - t3m:.3f} s")
        phase = "4 timings"
        rows, tile_ms = phase_timings(torch, np, cases, pipe, e2e["depth"])
        srows, slab_fwd = phase_slab_timings(torch, np, scases, dvr)
        log(f"[4] end to end (cli.inference, load + 9 tiles + stitch + "
            f"write): {e2e['tiles'] / e2e['wall']:.3f} tiles/s")
        busy_share = phase_profile(torch, e2e["argv"])
        phase = "4b training timings"
        trows, step_ms = phase_train_timings(torch, np, tcases, work,
                                             tr["data"])
        phase = "4c kernel C timings"
        erows, flush_ms = phase_ell_timings(torch, ecases, vr["proc"],
                                            kgraph)
        phase = "4d k-NN training timings"
        krows, kstep = phase_knn_train_timings(torch, np, kcases, work,
                                               ksamples)
        phase = "4e kernels E, D and D' timings"
        berows, bdrows, dstep, dots = phase_banded_timings(
            torch, np, becases, bdcases, kcases, work, ksamples)
        phase = "4f bf16 timings"
        frows, bflush_ms, bsteps = phase_bf16_timings(
            torch, np, ecases, kcases, becases, bdcases, kmodel, kgraph,
            work, ksamples, dict(flush_ms=flush_ms, step_C=kstep["ms"],
                                 step_D=dstep["ms"]))
        phase = "4g COO timings"
        t4g = time.perf_counter()
        grows, ctime = phase_coo_timings(torch, np, coo, ctr, kstep,
                                         cvr["launches_by_width"])
        log(f"[4g] phase 4g took {time.perf_counter() - t4g:.3f} s")
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
        "default_vr_route": {
            "runs": dvr["runs"],
            "bf16_class_agreement_with_f32": dvr["bf16_class_agreement"],
            "flush_of_2100_grids_slab_chunks": dvr["small_flush_chunks"],
            "slab_shape": srows,
            "slab_chunk_forward_ms": slab_fwd,
            "max_abs_err_slab_shape": {r["shape"]: errs[r["shape"]]
                                       for r in srows},
        },
        "streaming": {k: v for k, v in stream.items() if k != "bags"},
        "sharded": sharded_summary(shard1, shard2),
        "guard_and_repeat_checks": guard_2a,
    }]
    trow = next(r for r in trows if r["shape"].startswith("mid")
                and "float32" in r["shape"])
    tlabel = trow["shape"]
    common = dict(route="cuda", library_ms=None, at=tlabel, shapes=trows,
                  train_step_ms={k: v["ms"] for k, v in step_ms.items()},
                  train_steps=tr["steps"])
    kernels += [{
        "name": "grid_gat_fwd_train",
        "source": "bathymetric_gnn_tpu_torch/csrc/grid_gat_fwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py:149",
        "launches": tr["counts"]["fwd_train"],
        "max_abs_err": terrs[tlabel][0],
        "ms": trow["a_ms"], "plain_ms": trow["a_plain_ms"],
        "bound_ms": trow["a_bound_ms"], "bound_by": trow["a_bound_by"],
        **common,
    }, {
        "name": "grid_gat_bwd",
        "source": "bathymetric_gnn_tpu_torch/csrc/grid_gat_bwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py:549",
        "launches": tr["counts"]["bwd"],
        "max_abs_err": max(terrs[tlabel][1].values()),
        "grad_max_abs_err": terrs[tlabel][1],
        "ms": trow["b_ms"], "plain_ms": trow["b_plain_ms"],
        "bound_ms": trow["b_bound_ms"], "bound_by": trow["b_bound_by"],
        **common,
    }]
    erow = erows[0]
    kernels.append({
        "name": "ell_gat_fwd",
        "route": "cuda",
        "source": "bathymetric_gnn_tpu_torch/csrc/ell_gat_fwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py:1107",
        "launches": vr["launches"],
        "max_abs_err": eerrs[erow["shape"]],
        "ms": erow["ms"],
        "plain_ms": erow["plain_ms"],
        "bound_ms": erow["bound_ms"],
        "bound_by": erow["bound_by"],
        "library_ms": None,
        "at": erow["shape"],
        "shapes": erows,
        "graph_chunks": vr["chunks"],
        "default_vr_route_launches": {
            name: {"launches": r["c_launches"],
                   "graph_chunks": r["graph_chunks"]}
            for name, r in dvr["runs"].items()},
        "model_forward_ms_per_flush": flush_ms,
        "end_to_end_grids_per_s": vr["grids"] / vr["wall"],
        "end_to_end_mnodes_per_s": vr["nodes"] / vr["wall"] / 1e6,
        "end_to_end_device_busy_share": vr["busy_share"],
    })
    krow = krows[0]
    klabel = krow["shape"]
    kerr = kerrs[klabel]
    kcommon = dict(route="cuda", library_ms=None, at=klabel, shapes=krows,
                   train_step=kstep, train_steps=ktr["steps"],
                   end_to_end_wall_s=ktr["wall"])
    kernels += [{
        "name": "ell_gat_fwd_train",
        "source": "bathymetric_gnn_tpu_torch/csrc/ell_gat_fwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py:1107",
        "launches": ktr["counts"]["fwd_train"],
        "max_abs_err": kerr["out"],
        "ms": krow["c_ms"], "plain_ms": krow["c_plain_ms"],
        "bound_ms": krow["c_bound_ms"], "bound_by": krow["c_bound_by"],
        **kcommon,
    }, {
        "name": "ell_gat_bwd",
        "source": "bathymetric_gnn_tpu_torch/csrc/ell_gat_bwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py:1258",
        "launches": ktr["counts"]["bwd"],
        "max_abs_err": max(kerr[nm] for nm in ELL_LEAVES),
        "grad_max_abs_err": {nm: kerr[nm] for nm in ELL_LEAVES},
        "ms": krow["cp_call_with_f_ms"], "plain_ms": krow["cp_plain_ms"],
        "bound_ms": krow["cw_bound_ms"], "bound_by": krow["cw_bound_by"],
        "share_of_bound": krow["cw_bound_ms"] / krow["cp_call_with_f_ms"],
        "timed": "the whole call (dots, destination pass, F (b))",
        "destination_pass": {"ms": krow["cp_ms"],
                             "bound_ms": krow["cp_bound_ms"],
                             "bound_by": krow["cp_bound_by"]},
        "wide_row_max_abs_err": {f"HC {WIDE_HEADS * WIDE_C} f32": wide_cp},
        **kcommon,
    }, {
        "name": "segment_reduce",
        "source": "bathymetric_gnn_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/segment_reduce.py:52",
        "launches": ktr["counts"]["segment_reduce"],
        "mode": "b (the training path's: rows formed from C' coefficients)",
        "max_abs_err": kerr["f_b"],
        "ms": krow["fb_ms"], "plain_ms": krow["fb_plain_ms"],
        "bound_ms": krow["fb_bound_ms"], "bound_by": krow["fb_bound_by"],
        "mode_a": {"max_abs_err": kerr["f_a"], "ms": krow["fa_ms"],
                   "plain_ms": krow["fa_plain_ms"],
                   "library_ms": krow["fa_library_ms"],
                   "library": "torch.Tensor.index_add_",
                   "bound_ms": krow["fa_bound_ms"],
                   "bound_by": krow["fa_bound_by"]},
        **kcommon,
    }]
    berow, bdrow = berows[0], bdrows[0]
    kernels += [{
        "name": "ell_gat_band",
        "route": "cuda",
        "source": "bathymetric_gnn_tpu_torch/csrc/ell_gat_band.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py:88",
        "launches": bvr["launches"],
        "max_abs_err": berrs[("E", berow["shape"])],
        "ms": berow["ms"], "plain_ms": berow["plain_ms"],
        "bound_ms": berow["bound_ms"], "bound_by": berow["bound_by"],
        "library_ms": None,
        "at": berow["shape"],
        "shapes": berows,
        "graph_chunks": bvr["chunks"],
        "end_to_end_grids_per_s": bvr["grids"] / bvr["wall"],
        "end_to_end_mnodes_per_s": bvr["nodes"] / bvr["wall"] / 1e6,
        "end_to_end_device_busy_share": bvr["busy_share"],
        "class_agreement_with_kernel_c_route": bvr["agreement"],
    }]
    dcommon = dict(route="cuda", library_ms=None, at=bdrow["shape"],
                   shapes=bdrows, route_d_train_step=dstep)
    kernels += [{
        "name": "ell_gat_v2_fwd",
        "source": "bathymetric_gnn_tpu_torch/csrc/ell_gat_v2_fwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py:268",
        "launches": dstep["counts"]["v2"],
        "max_abs_err": berrs[("D", bdrow["shape"])],
        "ms": bdrow["d_ms"], "plain_ms": bdrow["d_plain_ms"],
        "bound_ms": bdrow["d_bound_ms"], "bound_by": bdrow["d_bound_by"],
        **dcommon,
    }, {
        "name": "ell_gat_v2_bwd",
        "source": "bathymetric_gnn_tpu_torch/csrc/ell_gat_v2_bwd.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py:625",
        "launches": dstep["counts"]["v2_bwd"],
        "max_abs_err": berrs[("Dp", bdrow["shape"])],
        "ms": bdrow["dp_ms"], "plain_ms": bdrow["dp_plain_ms"],
        "bound_ms": bdrow["dp_bound_ms"], "bound_by": bdrow["dp_bound_by"],
        "share_of_bound": bdrow["dp_bound_ms"] / bdrow["dp_ms"],
        "timed": "the whole call given D's attention dots (the main path's)",
        "ms_computing_its_own_dots": bdrow["dp_own_dots_ms"],
        "segment_reduce_mode_a_launches": dstep["counts"]["segment_reduce"],
        "wide_row_max_abs_err": {f"HC {WIDE_HEADS * WIDE_C} f32": wide_dp},
        **dcommon,
    }]
    kernels[-2]["mat_dots"] = dots
    kernels += bf16_entries(ferrs, bmod, frows, bflush_ms, bsteps)
    grow = grows[0]
    kernels.append({
        "name": "segment_reduce_coo",
        "route": "cuda",
        "source": "bathymetric_gnn_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "bathymetric_gnn_tpu/ops/pallas/segment_reduce.py:52",
        "launches": cvr["launches"],
        "mode": "a: the COO path's segment sums and gather backward",
        "max_abs_err": coo_errs["sum [E, 256]"],
        "ms": grow["ms"], "plain_ms": grow["plain_ms"],
        "bound_ms": grow["bound_ms"], "bound_by": grow["bound_by"],
        "library_ms": grow["library_ms"],
        "library": "torch.Tensor.index_add_",
        "ms_by": "CUDA-event span over 20 calls; device_ms: a CUDA graph of "
                 "20 calls replayed between events",
        "device_ms": grow["device_ms"],
        "library_device_ms": grow["library_device_ms"],
        "host_us_per_call": grow["host_us_per_call"],
        "at": grow["shape"],
        "shapes": grows,
        "bits": "equal to the in-order sum at every width, both tables, "
                "f32 and bf16 rows (phase 2g)",
        "max_abs_err_by_shape": coo_errs,
        "coo_serving": {k: v for k, v in cvr.items()},
        "coo_training": {k: v for k, v in ctr.items() if k != "setup"},
        "ground_truth_workflow": gtw,
        "timings": ctime,
    })
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
