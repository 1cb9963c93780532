"""PyTorch port: importing a model trained with the original PyTorch
reference (``utils/torch_import``, ``cli/import_torch``).

For each of the four conv families (GAT, GCN, GraphSAGE, GIN), a model
with the reference's module tree and ``state_dict`` names, its layers the
hand-written PyG semantics of ``tests/torch_ref.py`` and random BatchNorm
running statistics, is imported into the port:

- the port's COO model on the imported weights reproduces the reference
  model's outputs on a random graph, within the tolerances of JAX's own
  migration test (``tests/test_torch_import.py``: logits and confidence
  rtol 1e-3 / atol 1e-4, correction atol 1e-3);
- the port's importer gives JAX's ``import_torch_state_dict`` tree, leaf
  for leaf, and the same port ``state_dict`` through the weight bridge;
- ``cli/import_torch`` on the saved reference checkpoint writes a port
  checkpoint (the JAX CLI's meta fields) whose weights load into the COO
  model, into the dense-grid pipeline's ``load_model`` (GAT) and into the
  graph trainer's resume (epoch 1, no best value, a fresh optimizer).
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as TF
from torch import nn

import torch_ref as TR

from bathymetric_gnn_tpu.utils import torch_import as jti
from bathymetric_gnn_tpu_torch.cli import import_torch as tcli
from bathymetric_gnn_tpu_torch.config.config import Config
from bathymetric_gnn_tpu_torch.models.gnn import make_model
from bathymetric_gnn_tpu_torch.ops.graph import CooGraph, make_padded_graph
from bathymetric_gnn_tpu_torch.utils import torch_import as tti
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     load_state_dict,
                                                     state_dict_from_flax)

torch.set_num_threads(2)

HIDDEN, HEADS, LAYERS, IN_CH, EDGE_DIM = 16, 2, 3, 7, 3
TYPES = ("GAT", "GCN", "GraphSAGE", "GIN")


class _BNWrap(nn.Module):
    """PyG BatchNorm: a wrapper holding ``.module`` = BatchNorm1d."""

    def __init__(self, width):
        super().__init__()
        self.module = nn.BatchNorm1d(width)

    def forward(self, x):
        return self.module(x)


class _GIN(nn.Module):
    """PyG GINConv's names (``nn``) over torch_ref's GIN arithmetic."""

    def __init__(self, in_c, out_c):
        super().__init__()
        self.nn = TR.RefGINConv(in_c, out_c).mlp

    def forward(self, x, edge_index):
        agg = TR.scatter_sum(x[edge_index[0]], edge_index[1], x.shape[0])
        return self.nn(x + agg)


class RefStyleModel(nn.Module):
    """The reference BathymetricGNN's structure and names, any family."""

    def __init__(self, gnn_type):
        super().__init__()
        self.gnn_type = gnn_type
        fe = nn.Module()
        fe.mlp = nn.Sequential(nn.Linear(IN_CH, HIDDEN), nn.ReLU(),
                               nn.Dropout(0.1), nn.Linear(HIDDEN, HIDDEN))
        self.feature_extractor = fe
        gnn = nn.Module()
        gnn.convs, gnn.norms = nn.ModuleList(), nn.ModuleList()
        width = HIDDEN
        for i in range(LAYERS):
            last = i == LAYERS - 1
            if gnn_type == "GAT":
                conv = TR.RefGATConv(width, HIDDEN, heads=1 if last else HEADS,
                                     concat=not last, edge_dim=EDGE_DIM)
                width = HIDDEN * (1 if last else HEADS)
            else:
                conv = {"GCN": TR.RefGCNConv, "GraphSAGE": TR.RefSAGEConv,
                        "GIN": _GIN}[gnn_type](width, HIDDEN)
                width = HIDDEN
            gnn.convs.append(conv)
            gnn.norms.append(_BNWrap(width))
        self.gnn = gnn
        for name, out in (("classification_head", 3), ("confidence_head", 1),
                          ("correction_head", 1)):
            head = nn.Module()
            head.mlp = nn.Sequential(nn.Linear(HIDDEN, HIDDEN // 2),
                                     nn.ReLU(), nn.Dropout(0.1),
                                     nn.Linear(HIDDEN // 2, out))
            setattr(self, name, head)
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for norm in gnn.norms:
                bn = norm.module
                bn.running_mean.normal_(0, 0.2, generator=g)
                bn.running_var.uniform_(0.5, 2.0, generator=g)
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.bias.normal_(0, 0.1, generator=g)

    def forward(self, x, edge_index, edge_attr):
        x = self.feature_extractor.mlp(x)
        for i, (conv, norm) in enumerate(zip(self.gnn.convs,
                                             self.gnn.norms)):
            x = (conv(x, edge_index, edge_attr) if self.gnn_type == "GAT"
                 else conv(x, edge_index))
            x = norm(x)
            if i < LAYERS - 1:
                x = TF.relu(x)
        return (self.classification_head.mlp(x),
                torch.sigmoid(self.confidence_head.mlp(x))[:, 0],
                self.correction_head.mlp(x)[:, 0])


def _graph(n=40, e=220, seed=0):
    rg = np.random.default_rng(seed)
    x = rg.normal(size=(n, IN_CH)).astype(np.float32)
    pairs = np.unique(np.stack([rg.integers(0, n, e),
                                rg.integers(0, n, e)], 1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    ei = pairs.T.astype(np.int64)
    attr = rg.normal(size=(ei.shape[1], EDGE_DIM)).astype(np.float32)
    return x, ei, attr


def _port_model(gnn_type, sd):
    cfg = Config()
    cfg.model.gnn_type = gnn_type
    cfg.model.hidden_channels, cfg.model.num_layers = HIDDEN, LAYERS
    cfg.model.heads = HEADS
    model = make_model(cfg.model, IN_CH, edge_dim=EDGE_DIM)
    model.load_state_dict(coo_state_dict(sd))
    return model.eval()


def _ckpt(model, gnn_type):
    return {"model_state_dict": model.state_dict(), "in_channels": IN_CH,
            "edge_dim": EDGE_DIM,
            "config": {"model": {"num_layers": LAYERS, "gnn_type": gnn_type,
                                 "hidden_channels": HIDDEN,
                                 "attention_heads": HEADS}}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=TYPES)
def imported(request):
    gnn_type = request.param
    torch.manual_seed(7)
    ref = RefStyleModel(gnn_type).eval()
    x, ei, attr = _graph()
    with torch.no_grad():
        want = ref(torch.tensor(x), torch.tensor(ei), torch.tensor(attr))
    params, stats, meta = tti.import_torch_checkpoint(_ckpt(ref, gnn_type))
    return gnn_type, ref, (x, ei, attr), want, params, stats, meta


def _port_forward(model, x, ei, attr):
    g = CooGraph.from_padded(make_padded_graph(x, ei, attr, n_pad=64,
                                               e_pad=512)).to("cpu")
    with torch.no_grad():
        out = model(g)
    n = x.shape[0]
    return (out["class_logits"][:n], out["confidence"][:n],
            out["correction"][:n])


def test_port_forward_matches_reference(imported):
    gnn_type, _, (x, ei, attr), want, params, stats, meta = imported
    assert meta["gnn_type"] == gnn_type and meta["num_layers"] == LAYERS
    assert meta["in_channels"] == IN_CH and meta["heads"] == HEADS
    model = _port_model(gnn_type, state_dict_from_flax(params, stats, "coo"))
    got = _port_forward(model, x, ei, attr)
    for a, b, atol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=atol)


def test_port_import_equals_jax_import(imported):
    gnn_type, ref, *_ = imported
    sd = ref.state_dict()
    tp, ts = tti.import_torch_state_dict(sd, num_layers=LAYERS,
                                         gnn_type=gnn_type)
    jp, js = jti.import_torch_state_dict(sd, num_layers=LAYERS,
                                         gnn_type=gnn_type)
    for t, j in ((tp, jp), (ts, js)):
        ft, fj = _flat(t), _flat(j)
        assert ft.keys() == fj.keys()
        for k in fj:
            assert ft[k].dtype == fj[k].dtype == np.float32
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    a = state_dict_from_flax(tp, ts, "coo")
    b = state_dict_from_flax(jp, js, "coo")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_cli_checkpoint_serves_and_resumes(imported, tmp_path, capsys):
    from bathymetric_gnn_tpu_torch.inference.pipeline import (
        BathymetricPipeline)
    from bathymetric_gnn_tpu_torch.training.trainer import Trainer

    gnn_type, ref, (x, ei, attr), want, params, stats, _ = imported
    src = tmp_path / "ref.pt"
    torch.save(_ckpt(ref, gnn_type), src)
    ckpt = tcli.main(["--input", str(src), "--output-dir",
                      str(tmp_path / "out")])
    assert ckpt == tmp_path / "out" / "imported"
    assert "imported" in capsys.readouterr().out
    sd, meta = load_state_dict(ckpt)
    assert meta["trained_layout"] == "coo" and meta["huber_delta"] == 1.0
    assert meta["imported_from"] == str(src)
    assert meta["class_weights"] == [1.0, 1.0, 1.0]
    bridged = state_dict_from_flax(params, stats, "coo")
    assert sd.keys() == bridged.keys()
    assert all(torch.equal(sd[k], bridged[k]) for k in sd)
    cfg = Config.load(ckpt / "config.yaml")
    assert (cfg.model.gnn_type, cfg.model.hidden_channels,
            cfg.model.num_layers, cfg.model.heads) == (gnn_type, HIDDEN,
                                                       LAYERS, HEADS)
    got = _port_forward(_port_model(gnn_type, sd), x, ei, attr)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-3,
                               atol=1e-4)
    if gnn_type == "GAT":
        pipe = BathymetricPipeline(device="cpu")
        pipe.load_model(ckpt)
        assert pipe.in_channels == IN_CH
        assert pipe.config.model.heads == HEADS

    class _One:
        """A one-sample dataset shaped like the imported model's inputs."""

        def __init__(self):
            self.graph = make_padded_graph(x, ei, attr, n_pad=64, e_pad=512)

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return self

        def class_counts(self):
            return np.ones(3)

        def sample_normalized_corrections(self):
            return np.zeros(0)

    cfg.training.seed = 0
    tr = Trainer(cfg, _One(), output_dir=str(tmp_path / "run"), device="cpu")
    state = tr.init_state(_One().graph)
    state, epoch, best = tr.load_checkpoint(ckpt, state)
    assert (epoch, best, state.step) == (1, float("inf"), 0)
    loaded = state.model.state_dict()
    for k, v in coo_state_dict(sd).items():
        assert torch.equal(loaded[k], v), k
    assert json.loads((ckpt / "calibration.json").read_text()) == {
        "confidence_scale": 1.0, "confidence_bias": 0.0}
