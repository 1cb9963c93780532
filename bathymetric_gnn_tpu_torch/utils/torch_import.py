"""Import reference PyTorch checkpoints into the port (copy of
``bathymetric_gnn_tpu/utils/torch_import.py``).

Maps the reference BathymetricGNN's state_dict (reference: models/gnn.py:
263-358: feature_extractor.mlp.*, gnn.convs.{i}.*, gnn.norms.{i}.module.*,
{classification,confidence,correction}_head.mlp.*; GAT, GCN, GraphSAGE
and GIN convs) onto the JAX package's COO parameter tree (nested dicts of
NumPy arrays, the names of ``models/gnn.BathymetricGNN``), which
``utils/weights.state_dict_from_flax(..., layout="coo")`` turns into the
port's state_dict. Every path of the port serves the result.

The reference saves checkpoints as
``{'model_state_dict', 'config', 'in_channels', 'edge_dim', ...}``
(reference: training/trainer.py:809-829); pass either the full checkpoint
dict or a bare state_dict. A checkpoint file is read with
``torch.load(weights_only=False)``, because reference checkpoints pickle
their config: that unpickles arbitrary objects, so import only files you
trust.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["import_torch_checkpoint", "import_torch_state_dict"]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _linear(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _mlp_head(sd: Dict, prefix: str) -> Dict[str, Dict]:
    """Sequential(Linear, ReLU, Dropout, Linear) -> TorchLinear_0/1."""
    return {
        "TorchLinear_0": _linear(sd, f"{prefix}.0"),
        "TorchLinear_1": _linear(sd, f"{prefix}.3"),
    }


def _extractor(sd: Dict, prefix: str, num_layers: int) -> Dict[str, Dict]:
    """LocalFeatureExtractor.mlp: Linear at indices 0, 3, 6, ... and the
    final Linear (reference: models/gnn.py:52-68)."""
    out = {}
    idx = 0
    for li in range(num_layers - 1):
        out[f"TorchLinear_{li}"] = _linear(sd, f"{prefix}.{idx}")
        idx += 3  # Linear, ReLU, Dropout
    out[f"TorchLinear_{num_layers - 1}"] = _linear(sd, f"{prefix}.{idx}")
    return out


def _gat_conv(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    # PyG GATConv: 'lin' (newer) or 'lin_src' (older) for the shared
    # transform; attention vectors [1, H, C]; optional edge path.
    lin_key = (f"{prefix}.lin.weight" if f"{prefix}.lin.weight" in sd
               else f"{prefix}.lin_src.weight")
    out = {
        "lin_src": _np(sd[lin_key]).T,
        "att_src": _np(sd[f"{prefix}.att_src"]),
        "att_dst": _np(sd[f"{prefix}.att_dst"]),
    }
    if f"{prefix}.lin_edge.weight" in sd:
        out["lin_edge"] = _np(sd[f"{prefix}.lin_edge.weight"]).T
        out["att_edge"] = _np(sd[f"{prefix}.att_edge"])
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _gcn_conv(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.lin.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _sage_conv(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "lin_l": _np(sd[f"{prefix}.lin_l.weight"]).T,
        "bias_l": _np(sd[f"{prefix}.lin_l.bias"]),
        "lin_r": _np(sd[f"{prefix}.lin_r.weight"]).T,
    }


def _gin_conv(sd: Dict, prefix: str) -> Dict[str, Dict]:
    return {
        "TorchLinear_0": _linear(sd, f"{prefix}.nn.0"),
        "TorchLinear_1": _linear(sd, f"{prefix}.nn.2"),
    }


def import_torch_state_dict(
    sd: Dict,
    num_layers: int = 4,
    gnn_type: str = "GAT",
    feature_extractor_layers: int = 2,
    predict_correction: bool = True,
) -> Tuple[Dict, Dict]:
    """state_dict -> (params, batch_stats) for models/gnn.BathymetricGNN."""
    conv_fn = {"GAT": _gat_conv, "GCN": _gcn_conv, "GraphSAGE": _sage_conv,
               "GIN": _gin_conv}[gnn_type]
    conv_name = {"GAT": "GATConv", "GCN": "GCNConv",
                 "GraphSAGE": "SAGEConv", "GIN": "GINConv"}[gnn_type]

    backbone_params: Dict = {}
    backbone_stats: Dict = {}
    for i in range(num_layers):
        backbone_params[f"{conv_name}_{i}"] = conv_fn(sd, f"gnn.convs.{i}")
        bn = f"gnn.norms.{i}.module"
        backbone_params[f"MaskedBatchNorm_{i}"] = {
            "scale": _np(sd[f"{bn}.weight"]),
            "bias": _np(sd[f"{bn}.bias"]),
        }
        backbone_stats[f"MaskedBatchNorm_{i}"] = {
            "mean": _np(sd[f"{bn}.running_mean"]),
            "var": _np(sd[f"{bn}.running_var"]),
        }

    params = {
        "MLPFeatureExtractor_0": _extractor(
            sd, "feature_extractor.mlp", feature_extractor_layers),
        "GNNBackbone_0": backbone_params,
        "ClassificationHead_0": _mlp_head(sd, "classification_head.mlp"),
        "ConfidenceHead_0": _mlp_head(sd, "confidence_head.mlp"),
    }
    if predict_correction and any(k.startswith("correction_head.")
                                  for k in sd):
        params["CorrectionHead_0"] = _mlp_head(sd, "correction_head.mlp")
    batch_stats = {"GNNBackbone_0": backbone_stats}
    return params, batch_stats


def import_torch_checkpoint(path_or_ckpt) -> Tuple[Dict, Dict, Dict]:
    """Load a reference .pt checkpoint -> (params, batch_stats, meta).

    meta carries in_channels/edge_dim/model config fields recorded by the
    reference trainer (training/trainer.py:811-822).
    """
    if isinstance(path_or_ckpt, (str, bytes)) or hasattr(path_or_ckpt,
                                                         "__fspath__"):
        import torch

        ckpt = torch.load(path_or_ckpt, map_location="cpu",
                          weights_only=False)
    else:
        ckpt = path_or_ckpt
    sd = ckpt.get("model_state_dict", ckpt)

    cfg = ckpt.get("config")
    model_cfg = getattr(cfg, "model", None) if cfg is not None else None

    def cfg_get(name, default):
        if model_cfg is not None and hasattr(model_cfg, name):
            return getattr(model_cfg, name)
        if isinstance(cfg, dict):
            return cfg.get("model", {}).get(name, default)
        return default

    num_layers = cfg_get("num_layers", 4)
    gnn_type = cfg_get("gnn_type", "GAT")
    params, batch_stats = import_torch_state_dict(
        sd, num_layers=num_layers, gnn_type=gnn_type)
    meta = {
        "in_channels": ckpt.get("in_channels"),
        "edge_dim": ckpt.get("edge_dim"),
        "num_layers": num_layers,
        "gnn_type": gnn_type,
        "hidden_channels": cfg_get("hidden_channels", 64),
        "heads": cfg_get("attention_heads", cfg_get("heads", 4)),
        "param_layout": "coo",
    }
    return params, batch_stats, meta
