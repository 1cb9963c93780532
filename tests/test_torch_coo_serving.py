"""PyTorch port vs JAX: native VR serving through the COO model and the
non-GAT default route, and the staged smoke test.

The same weights (a JAX COO ``BathymetricGNN`` init at hidden 16, 2
layers, 2 heads, with BatchNorm statistics of real activations and
sharpened output heads, bridged with ``utils/weights``) serve the same
refinement grids (``tests/test_torch_vr_default.make_refinements``: 30
refinements plus an 80 x 70 and a 1 x 40 grid, each shape at one
resolution) through the JAX
``NativeVRProcessor`` and the port's (``device="cpu"``):

- ``use_ell=False``: every grid on a grid-connectivity graph through the
  COO model (kernel F's plain version behind its sums), GAT and GCN;
- the default route of a GCN, GraphSAGE and GIN model: slabs as ELL graphs
  and larger grids on graphs, through the ELL model's plain layers.

Outputs are packed to f16 on both sides, so classes agree on >= 99.9 % of
valid cells and confidence and correction within 2e-3
(``test_torch_vr_default._check``). Then ``cli.smoke_test --device cpu``
passes all eight stages.
"""

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (Config as JaxConfig,
                                               ModelConfig as JaxModel)
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.inference.native_vr import (
    NativeVRProcessor as JaxProcessor)
from bathymetric_gnn_tpu.models.gnn import make_model as jax_make_model
from bathymetric_gnn_tpu_torch.cli import smoke_test
from bathymetric_gnn_tpu_torch.config.config import Config, ModelConfig
from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
from bathymetric_gnn_tpu_torch.inference.native_vr import NativeVRProcessor
from bathymetric_gnn_tpu_torch.models.gnn import make_model
from bathymetric_gnn_tpu_torch.ops.graph import CooGraph, batch_graphs
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from test_torch_vr_default import _check, _run, make_refinements

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
BUDGET = 4000


def _cfgs(gnn_type):
    return (JaxConfig(model=JaxModel(**MODEL, gnn_type=gnn_type)),
            Config(model=ModelConfig(**MODEL, gnn_type=gnn_type)))


def weights(gnn_type):
    """(JAX model, its variables, the port's state_dict) of one type, 8
    input channels: BatchNorm statistics of one training-mode pass of the
    port's COO model over grid graphs (momentum 1), then sharper output
    layers to spread the classes and the confidence."""
    jcfg, cfg = _cfgs(gnn_type)
    model = jax_make_model(jcfg.model, in_channels=8, edge_dim=3)
    d = make_refinements(1, seed=5)[0][0]
    d = np.where(np.abs(d) < 1e5, d, np.nan)
    bg = JaxBuilder(jcfg.graph).build_graph(
        d, np.isfinite(d), np.full(d.shape, 0.2, np.float32))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), bg.graph)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    gb = GraphBuilder(cfg.graph)
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
    tm = make_model(cfg.model, 8, dropout=0.0)
    tm.load_state_dict(coo_state_dict(state_dict_from_flax(params, stats,
                                                           "coo")))
    for m in tm.modules():
        m.momentum = 1.0
    with torch.no_grad():
        tm.train()(CooGraph.from_padded(graph, src_table=False).to("cpu"))
    bb = tm.GNNBackbone_0
    for name, leaf in stats["GNNBackbone_0"].items():
        leaf["mean"] = getattr(bb, name).mean.numpy().copy()
        leaf["var"] = getattr(bb, name).var.numpy().copy()
    params["ClassificationHead_0"]["TorchLinear_1"]["kernel"] *= 8.0
    params["ConfidenceHead_0"]["TorchLinear_1"]["kernel"] *= 4.0
    return model, {"params": params, "batch_stats": stats}, \
        state_dict_from_flax(params, stats, "coo")


GRIDS = dict(n_grids=30, seed=1, extra=((80, 70), (1, 40)))


def _grids():
    """GRIDS, every grid of one shape at the resolution of the first of
    that shape: the JAX graph builder compiles once for each shape and
    resolution."""
    res = {}
    return [(depth, unc, res.setdefault(depth.shape, r))
            for depth, unc, r in make_refinements(**GRIDS)]


@pytest.mark.parametrize("gnn_type", ["GAT", "GCN"])
def test_coo_processor_matches_jax(gnn_type):
    """use_ell=False: no slabs, every grid through the COO model."""
    model, variables, sd = weights(gnn_type)
    jcfg, cfg = _cfgs(gnn_type)
    grids = _grids()
    jproc = JaxProcessor(model, variables, jcfg, node_budget=BUDGET,
                         use_ell=False)
    tproc = NativeVRProcessor(sd, cfg, node_budget=BUDGET, device="cpu",
                              use_ell=False)
    assert not tproc.use_slab and not jproc.use_slab
    chunks = []
    launch = tproc._launch_graphs_chunk
    tproc._launch_graphs_chunk = lambda idx: (chunks.append(len(idx))
                                              or launch(idx))
    got = _run(tproc, grids)
    assert sum(chunks) == len(grids)
    _check(got, _run(jproc, grids), grids)


@pytest.mark.parametrize("gnn_type", ["GCN", "GraphSAGE", "GIN"])
def test_non_gat_default_route_matches_jax(gnn_type):
    """knn_k 0, a non-GAT model: slabs through their ELL graphs (no dense
    grid model: it is GAT only) and larger grids on graphs, through the
    ELL model's plain GCN / SAGE / GIN layers."""
    model, variables, sd = weights(gnn_type)
    jcfg, cfg = _cfgs(gnn_type)
    grids = _grids()
    jproc = JaxProcessor(model, variables, jcfg, node_budget=BUDGET)
    tproc = NativeVRProcessor(sd, cfg, node_budget=BUDGET, device="cpu")
    assert (tproc.use_slab, tproc.use_grid) == (jproc.use_slab,
                                                 jproc.use_grid) == (True,
                                                                     False)
    assert hasattr(tproc.model.GNNBackbone_0,
                   {"GCN": "GCNConv_0", "GraphSAGE": "SAGEConv_0",
                    "GIN": "GINConv_0"}[gnn_type])
    _check(_run(tproc, grids), _run(jproc, grids), grids)


def test_smoke_test_cli_passes_on_cpu(capsys):
    smoke_test.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "all stages passed"
    oks = [s for s in out if s.startswith("[ ok ]")]
    assert [s.split("]")[1].split("(")[0].strip() for s in oks] == [
        "imports", "data loading", "tiling", "graph construction",
        "synthetic noise", "model forward", "dense grid path",
        "memory estimate"]
    assert "device: cpu" in oks[0]


def test_smoke_test_aborts_on_the_first_failure(capsys, monkeypatch):
    def broken(ctx):
        raise RuntimeError("broken stage")

    broken._stage_name = "tiling"
    monkeypatch.setattr(smoke_test, "STAGES", [
        smoke_test.check_imports, smoke_test.test_data_loading, broken,
        smoke_test.test_graph_construction])
    with pytest.raises(SystemExit) as e:
        smoke_test.main(["--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] tiling: broken stage" in out
    assert "graph construction" not in out
