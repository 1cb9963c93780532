"""PyTorch port vs JAX: native VR inference on k-NN graphs.

The same weights (a JAX ``BathymetricGNN`` init at a small width, with
BatchNorm statistics of real activations and sharpened output heads,
bridged with ``utils/weights``) serve the same refinement grids through the JAX
``NativeVRProcessor`` (``knn_k=8``; on the CPU its ELL model runs the plain
``GATConvELL``) and the port's (``device="cpu"``: kernel C's plain
version), and the same VR BAG through both ``cli.inference_native``.
Outputs are packed to f16 on both sides (confidence step 4.9e-4 near 0.5),
so: classes agree on >= 99.9 % of valid cells, confidence and correction
within 2e-3 (correction relative to max(|correction|, 1)).
"""

import json

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (Config as JaxConfig,
                                               GraphConfig as JaxGraph,
                                               ModelConfig as JaxModel)
from bathymetric_gnn_tpu.config.constants import BAG_NODATA
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.inference.native_vr import (
    NativeVRProcessor as JaxProcessor)
from bathymetric_gnn_tpu.io.bag import VRBagHandler as JaxVRBagHandler
from bathymetric_gnn_tpu.models.gnn import make_model
from bathymetric_gnn_tpu_torch.cli import inference_native as port_cli
from bathymetric_gnn_tpu_torch.config.config import (Config, GraphConfig,
                                                     ModelConfig)
from bathymetric_gnn_tpu_torch.inference.native_vr import NativeVRProcessor
from bathymetric_gnn_tpu_torch.io.bag import VRBagHandler, write_vr_bag
from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
from bathymetric_gnn_tpu_torch.ops.graph import batch_graphs
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     save_checkpoint,
                                                     state_dict_from_flax)

from test_torch_knn_graph import ensure_jax_native_kit

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
BUCKETS = (1024, 4096)     # the 80 x 80 grid takes a one-off 8192 bucket
BUDGET = 1500


# refinement sides 3..50 as benchmarks/vr_bench.py draws them, from a few
# shapes only: the JAX builder compiles its featurization once per shape
SHAPES = ((3, 3), (7, 12), (21, 16), (33, 47), (50, 50))


def make_refinements(n_grids, seed=0, big=None):
    """Refinement grids as benchmarks/vr_bench.py makes them (~5 %
    NODATA, resolution 0.5-4 m; sides from SHAPES) with uncertainty
    0.1-0.4, plus one big x big grid in the middle."""
    rng = np.random.default_rng(seed)
    grids = []
    for i in range(n_grids):
        h, w = SHAPES[int(rng.integers(len(SHAPES)))]
        if big and i == n_grids // 2:
            h = w = big
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = (20.0 + rng.uniform(-5, 5) + 0.1 * xx + 0.05 * yy
                 + rng.normal(0, 0.05, (h, w))).astype(np.float32)
        depth[rng.random((h, w)) < 0.05] = BAG_NODATA
        unc = rng.uniform(0.1, 0.4, (h, w)).astype(np.float32)
        grids.append((depth, unc, (float(rng.uniform(0.5, 4.0)),) * 2))
    return grids


@pytest.fixture(scope="module")
def weights():
    """(JAX model, its variables, the port's state_dict): 8 input
    channels, so the uncertainty is a feature."""
    ensure_jax_native_kit()
    jcfg = JaxConfig(model=JaxModel(**MODEL), graph=JaxGraph(knn_k=8))
    model = make_model(jcfg.model, in_channels=8, edge_dim=3)
    d = make_refinements(1, seed=5)[0][0][:20, :20]
    bg = JaxBuilder(jcfg.graph).build_graph(
        d, np.isfinite(d), np.full(d.shape, 0.2, np.float32))
    variables = model.init(jax.random.PRNGKey(0), bg.graph)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    # BatchNorm statistics of real activations (one training-mode pass of
    # the port's plain model over a batch of grids, momentum 1), so the
    # heads see normalized features; then sharper output layers spread
    # the classes and the confidence (as in test_torch_pipeline)
    sd = state_dict_from_flax(params, stats, "coo")
    proc = NativeVRProcessor(sd, _port_cfg(), device="cpu")
    for depth, unc, res in make_refinements(20, seed=9):
        proc.add_to_batch(depth, unc, res)
    graph, _ = batch_graphs(
        [(p["x"], p["edge_index"], p["edge_attr"]) for p in proc.pending],
        n_pad=proc.pending_nodes, e_pad=proc.pending_nodes * 8)
    train_model = make_ell_model(_port_cfg().model, 8, sparse_kernel="xla")
    train_model.load_state_dict(coo_state_dict(sd))
    for m in train_model.modules():
        m.momentum = 1.0
    with torch.no_grad():
        train_model.train()(coo_to_ell(graph, 8).to("cpu"))
    bb = train_model.GNNBackbone_0
    for name, leaf in stats["GNNBackbone_0"].items():
        leaf["mean"] = getattr(bb, name).mean.numpy().copy()
        leaf["var"] = getattr(bb, name).var.numpy().copy()
    params["ClassificationHead_0"]["TorchLinear_1"]["kernel"] *= 8.0
    params["ConfidenceHead_0"]["TorchLinear_1"]["kernel"] *= 4.0
    return model, {"params": params, "batch_stats": stats}, \
        state_dict_from_flax(params, stats, "coo")


def _port_cfg(knn_k=8):
    return Config(model=ModelConfig(**MODEL), graph=GraphConfig(knn_k=knn_k))


def _run(proc, grids):
    out = []
    for depth, unc, res in grids:
        proc.add_to_batch(depth, unc, res, context=len(out) + len(
            proc.pending))
        if proc.batch_ready():
            out.extend(proc.flush_batch())
    return out + proc.drain()


def _compare(got, want, valid):
    agree = np.mean(got["classification"][valid]
                    == want["classification"][valid])
    dconf = np.abs(got["confidence"] - want["confidence"]).max()
    dcorr = (np.abs(got["correction"] - want["correction"])
             / np.maximum(np.abs(want["correction"]), 1.0)).max()
    return agree, dconf, dcorr


def test_processor_matches_jax(weights):
    model, variables, sd = weights
    grids = make_refinements(30, seed=1, big=80)
    jproc = JaxProcessor(model, variables,
                         JaxConfig(model=JaxModel(**MODEL),
                                   graph=JaxGraph(knn_k=8)),
                         node_budget=BUDGET, node_buckets=BUCKETS)
    tproc = NativeVRProcessor(sd, _port_cfg(), node_budget=BUDGET,
                              node_buckets=BUCKETS, device="cpu")
    assert tproc.sparse_kernel == "banded_pallas"
    want, got = _run(jproc, grids), _run(tproc, grids)
    assert len(got) == len(want) == len(grids)
    n_valid = total_agree = 0
    classes = set()
    for g, w, (depth, _, _) in zip(got, want, grids):
        valid = np.abs(depth) < 1e5
        assert g["classification"].shape == depth.shape
        assert (g["classification"][~valid] == -1).all()
        agree, dconf, dcorr = _compare(g, w, valid)
        assert dconf <= 2e-3 and dcorr <= 2e-3, (dconf, dcorr)
        total_agree += agree * valid.sum()
        n_valid += valid.sum()
        classes |= set(np.unique(g["classification"][valid]).tolist())
    assert total_agree / n_valid >= 0.999
    assert classes <= {0, 1, 2} and len(classes) >= 2


def test_processor_defaults():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NativeVRProcessor({}, _port_cfg(knn_k=0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NativeVRProcessor({}, _port_cfg())


@pytest.fixture(scope="module")
def vr_bag(tmp_path_factory, weights):
    """A VR BAG of 12 refinements (one of 60 x 60) written by the port's
    ``write_vr_bag``, a port checkpoint (graph-trained) and a grid-trained
    one."""
    d = tmp_path_factory.mktemp("vr")
    grids = make_refinements(12, seed=2, big=60)
    refs = [(i // 4, i % 4, depth, unc, res[0])
            for i, (depth, unc, res) in enumerate(grids)]
    src = d / "in.bag"
    write_vr_bag(src, (3, 4), 64.0, refs, origin=(1000.0, 2000.0))
    cal = {"confidence_scale": 2.0, "confidence_bias": 0.5}
    _, _, sd = weights
    ckpt = save_checkpoint(d / "ckpt", sd, _port_cfg(0),
                           meta={"param_layout": "coo"}, calibration=cal)
    grid_ckpt = save_checkpoint(d / "grid_ckpt", sd, _port_cfg(0))
    return dict(dir=d, src=src, ckpt=ckpt, grid_ckpt=grid_ckpt, cal=cal)


ARGS = ["--knn-k", "8", "--confidence-threshold", "0.3",
        "--batch-node-budget", "2000"]


def test_cli_matches_jax(vr_bag, weights, monkeypatch, capsys):
    from bathymetric_gnn_tpu.cli import inference_native as jax_cli
    from bathymetric_gnn_tpu.inference import pipeline as jax_pipeline

    model, variables, _ = weights
    cal = vr_bag["cal"]

    def fake_load(path):
        return (variables["params"], variables["batch_stats"],
                JaxConfig(model=JaxModel(**MODEL)),
                {"param_layout": "coo", "confidence_calibration": (
                    cal["confidence_scale"], cal["confidence_bias"])})

    monkeypatch.setattr(jax_pipeline, "load_checkpoint_variables", fake_load)
    d = vr_bag["dir"]
    jax_cli.main(["--input", str(vr_bag["src"]), "--output",
                  str(d / "jax.bag"), "--model", str(d / "unused")] + ARGS)
    jstats = json.loads(capsys.readouterr().out)
    tstats = port_cli.main(["--input", str(vr_bag["src"]), "--output",
                            str(d / "port.bag"), "--model",
                            str(vr_bag["ckpt"]), "--device", "cpu"] + ARGS)
    assert json.loads(capsys.readouterr().out) == tstats
    assert tstats["grids"] == jstats["grids"] == 12
    assert tstats["total_nodes"] == jstats["total_nodes"]
    assert tstats["cells_corrected"] > 0
    assert abs(tstats["cells_corrected"] - jstats["cells_corrected"]) <= 2
    assert abs(tstats["mean_confidence"] - jstats["mean_confidence"]) <= 2e-3
    src = list(VRBagHandler(vr_bag["src"]).iterate_refinements())
    jout = list(JaxVRBagHandler(d / "jax.bag").iterate_refinements())
    tout = list(VRBagHandler(d / "port.bag").iterate_refinements())
    n_same = n_valid = 0
    for s, j, t in zip(src, jout, tout):
        valid = s.valid_mask
        same = ((t.depth != s.depth) == (j.depth != s.depth)) & valid
        n_same += same.sum()
        n_valid += valid.sum()
        np.testing.assert_allclose(t.depth[same], j.depth[same], rtol=0,
                                   atol=2e-3)
        np.testing.assert_allclose(t.uncertainty[same], j.uncertainty[same],
                                   rtol=2e-3)
    assert n_same / n_valid >= 0.999
    assert (d / "port_gnn_outputs.tif").exists()


def test_cli_refuses_grid_checkpoints_and_knn_0(vr_bag):
    base = ["--input", str(vr_bag["src"]), "--output",
            str(vr_bag["dir"] / "x.bag"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="COO-layout"):
        port_cli.main(base + ["--model", str(vr_bag["grid_ckpt"]),
                              "--knn-k", "8"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        port_cli.main(base + ["--model", str(vr_bag["ckpt"])])
