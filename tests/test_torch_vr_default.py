"""PyTorch port vs JAX: native VR inference on the default route
(``graph.knn_k == 0``).

The same weights (a JAX COO ``BathymetricGNN`` init at hidden 32, 2
layers, 4 heads, with BatchNorm statistics of real activations and
sharpened output heads, bridged with ``utils/weights``) serve the same
refinement grids through the JAX ``NativeVRProcessor`` and the port's
(``device="cpu"``: the kernels' plain versions), in the three modes of the
JAX test ``test_processor_slab_matches_noslab``: ``grid`` (slabs through
the dense grid model), ``ell`` (the slabs' ELL graphs) and ``noslab``
(grid-connectivity graphs for every grid). Grids larger than the slab or
one cell thin take grid-connectivity graphs in every mode. Outputs are
packed to f16 on both sides (confidence step 4.9e-4 near 0.5), so: classes
agree on >= 99.9 % of valid cells, confidence and correction within 2e-3
(correction relative to max(|correction|, 1)), invalid cells -1.
"""

import json

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (Config as JaxConfig,
                                               ModelConfig as JaxModel)
from bathymetric_gnn_tpu.config.constants import BAG_NODATA
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.inference.native_vr import (
    NativeVRProcessor as JaxProcessor)
from bathymetric_gnn_tpu.io.bag import VRBagHandler as JaxVRBagHandler
from bathymetric_gnn_tpu.models.gnn import make_model
from bathymetric_gnn_tpu_torch.cli import inference_native as port_cli
from bathymetric_gnn_tpu_torch.config.config import Config, ModelConfig
from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
from bathymetric_gnn_tpu_torch.inference.native_vr import NativeVRProcessor
from bathymetric_gnn_tpu_torch.io.bag import VRBagHandler, write_vr_bag
from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
from bathymetric_gnn_tpu_torch.ops.graph import batch_graphs
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     save_checkpoint,
                                                     state_dict_from_flax)

torch.set_num_threads(2)

MODEL = dict(hidden_channels=32, num_layers=2, heads=4)
BUDGET = 4000
MODES = {
    "grid": dict(use_slab=True, use_grid=True),
    "ell": dict(use_slab=True, use_grid=False),
    "noslab": dict(use_slab=False, use_grid=False),
}
# refinement sides from a few shapes: the JAX per-grid builder compiles
# once per shape (the slabs take any shape up to the frame)
SHAPES = ((3, 3), (7, 12), (21, 16), (33, 47), (50, 50), (2, 9))


def make_refinements(n_grids, seed=0, extra=()):
    """Refinement grids (~5 % NODATA, resolution 0.5-4 m, sides from
    SHAPES) with uncertainty 0.1-0.4; the ``extra`` shapes are placed in
    the middle."""
    rng = np.random.default_rng(seed)
    shapes = [SHAPES[int(rng.integers(len(SHAPES)))] for _ in range(n_grids)]
    shapes[n_grids // 2:n_grids // 2] = list(extra)
    grids = []
    for h, w in shapes:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = (20.0 + rng.uniform(-5, 5) + 0.1 * xx + 0.05 * yy
                 + rng.normal(0, 0.05, (h, w))).astype(np.float32)
        depth[rng.random((h, w)) < 0.05] = BAG_NODATA
        unc = rng.uniform(0.1, 0.4, (h, w)).astype(np.float32)
        grids.append((depth, unc, (float(rng.uniform(0.5, 4.0)),
                                   float(rng.uniform(0.5, 4.0)))))
    return grids


def _port_cfg():
    return Config(model=ModelConfig(**MODEL))


def _jax_cfg():
    return JaxConfig(model=JaxModel(**MODEL))


@pytest.fixture(scope="module")
def weights():
    """(JAX model, its variables, the port's state_dict): 8 input
    channels, so the uncertainty is a feature."""
    jcfg = _jax_cfg()
    model = make_model(jcfg.model, in_channels=8, edge_dim=3)
    d = make_refinements(1, seed=5)[0][0]
    d = np.where(np.abs(d) < 1e5, d, np.nan)
    bg = JaxBuilder(jcfg.graph).build_graph(
        d, np.isfinite(d), np.full(d.shape, 0.2, np.float32))
    variables = model.init(jax.random.PRNGKey(0), bg.graph)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    # BatchNorm statistics of real activations (one training-mode pass of
    # the port's plain model over grid graphs, momentum 1), then sharper
    # output layers spread the classes and the confidence
    sd = state_dict_from_flax(params, stats, "coo")
    gb = GraphBuilder(_port_cfg().graph)
    graphs = []
    for depth, unc, res in make_refinements(12, seed=9):
        valid = np.abs(depth) < 1e5
        g = gb.build_graph(np.where(valid, depth, np.nan), valid, unc, res)
        n = g.num_nodes
        graphs.append((g.graph.x[:n], np.stack(
            [g.graph.edge_src, g.graph.edge_dst])[:, g.graph.edge_mask],
            g.graph.edge_attr[g.graph.edge_mask]))
    n = sum(x.shape[0] for x, _, _ in graphs)
    graph, _ = batch_graphs(graphs, n_pad=n, e_pad=n * 8)
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


def _run(proc, grids, drains=1):
    out = []
    per = -(-len(grids) // drains)
    for start in range(0, len(grids), per):
        for depth, unc, res in grids[start:start + per]:
            proc.add_to_batch(depth, unc, res)
            if proc.batch_ready():
                out.extend(proc.flush_batch())
        out.extend(proc.drain())
    return out


def _check(got, want, grids):
    assert len(got) == len(want) == len(grids)
    n_valid = total_agree = 0
    classes = set()
    for g, w, (depth, _, _) in zip(got, want, grids):
        valid = np.abs(depth) < 1e5
        assert g["classification"].shape == depth.shape
        assert (g["classification"][~valid] == -1).all()
        total_agree += (g["classification"][valid]
                        == w["classification"][valid]).sum()
        n_valid += valid.sum()
        dconf = np.abs(g["confidence"] - w["confidence"]).max()
        dcorr = (np.abs(g["correction"] - w["correction"])
                 / np.maximum(np.abs(w["correction"]), 1.0)).max()
        assert dconf <= 2e-3 and dcorr <= 2e-3, (dconf, dcorr)
        classes |= set(np.unique(g["classification"][valid]).tolist())
    assert total_agree / n_valid >= 0.999
    assert classes <= {0, 1, 2} and len(classes) >= 2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_processor_matches_jax(weights, mode):
    """30 refinements plus an 80 x 70 grid (larger than the slab) and a
    1 x 40 one (one cell thin): both take grid-connectivity graphs."""
    model, variables, sd = weights
    grids = make_refinements(30, seed=1, extra=((80, 70), (1, 40)))
    jproc = JaxProcessor(model, variables, _jax_cfg(), node_budget=BUDGET,
                         **MODES[mode])
    tproc = NativeVRProcessor(sd, _port_cfg(), node_budget=BUDGET,
                              device="cpu", **MODES[mode])
    assert (tproc.use_slab, tproc.use_grid) == (jproc.use_slab,
                                                 jproc.use_grid)
    assert tproc.sparse_kernel == jproc.sparse_kernel == "xla"
    _check(_run(tproc, grids), _run(jproc, grids), grids)


def test_processor_mixed_slab_and_large_grids_preserve_order(weights):
    """Slab and graph entries of one flush come back in input order."""
    _, _, sd = weights
    rng = np.random.default_rng(2)
    proc = NativeVRProcessor(sd, _port_cfg(), node_budget=10 ** 9,
                             device="cpu")
    shapes = [(10, 10), (80, 70), (5, 9), (1, 7)]
    for h, w in shapes:
        depth = (20 + rng.normal(0, 0.5, (h, w))).astype(np.float32)
        proc.add_to_batch(depth, np.full((h, w), 0.3, np.float32), (1.0, 1.0),
                          context=(h, w))
    assert [p["kind"] for p in proc.pending] == ["slab", "graph", "slab",
                                                 "graph"]
    res = proc.drain()
    assert [r["classification"].shape for r in res] == shapes
    assert [r["context"] for r in res] == shapes
    for r in res:
        assert (r["classification"] >= 0).all()   # all cells valid here


def test_slab_flush_past_the_largest_batch_bucket(weights, monkeypatch):
    """2,100 grids of 3 x 3 in one flush: the port serves them in two slab
    chunks (2,048 and 52 grids), where the JAX processor, which splits a
    flush only by nodes, raises; the results equal JAX's on the same grids
    fed in two drains of 1,050. The frame is 4 x 4 on both sides: the
    chunking does not depend on it, and a 56 x 56 frame would make this
    CPU run ~200 times larger (the card runs it, chip_smoke.py phase
    3g)."""
    model, variables, sd = weights
    rng = np.random.default_rng(7)
    grids = []
    for _ in range(2100):
        depth = (20 + rng.normal(0, 0.3, (3, 3))).astype(np.float32)
        depth[rng.random((3, 3)) < 0.05] = BAG_NODATA
        grids.append((depth, np.full((3, 3), 0.3, np.float32),
                      (float(rng.uniform(0.5, 4)),) * 2))
    kw = dict(node_budget=10 ** 9, slab_size=4)
    jproc = JaxProcessor(model, variables, _jax_cfg(), **kw)
    with pytest.raises(ValueError, match="exceeds largest bucket 2048"):
        _run(jproc, grids)
    want = _run(JaxProcessor(model, variables, _jax_cfg(), **kw), grids,
                drains=2)
    tproc = NativeVRProcessor(sd, _port_cfg(), device="cpu", **kw)
    sizes = []
    launch = tproc._launch_slab_chunk
    monkeypatch.setattr(tproc, "_launch_slab_chunk",
                        lambda idx: sizes.append(len(idx)) or launch(idx))
    got = _run(tproc, grids)
    assert sizes == [2048, 52]
    _check(got, want, grids)


@pytest.fixture(scope="module")
def vr_bag(tmp_path_factory, weights):
    """A VR BAG of 12 refinements (one of 60 x 60, larger than the slab)
    and a port checkpoint of graph-trained weights with the default
    configuration (knn_k 0)."""
    d = tmp_path_factory.mktemp("vr")
    grids = make_refinements(11, seed=2, extra=((60, 60),))
    refs = [(i // 4, i % 4, depth, unc, res[0])
            for i, (depth, unc, res) in enumerate(grids)]
    src = d / "in.bag"
    write_vr_bag(src, (3, 4), 64.0, refs, origin=(1000.0, 2000.0))
    cal = {"confidence_scale": 2.0, "confidence_bias": 0.5}
    _, _, sd = weights
    ckpt = save_checkpoint(d / "ckpt", sd, _port_cfg(),
                           meta={"param_layout": "coo"}, calibration=cal)
    return dict(dir=d, src=src, ckpt=ckpt, cal=cal)


ARGS = ["--confidence-threshold", "0.3", "--batch-node-budget", "2000"]


def test_cli_matches_jax(vr_bag, weights, monkeypatch, capsys):
    """cli.inference_native without --knn-k (the default route) against
    the JAX CLI on the same VR BAG, calibration included."""
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
