"""Weight bridge between the JAX package's flax trees and the port.

The port's modules keep the flax names, so a ``params``/``batch_stats``
tree maps onto a ``state_dict`` key for key: nested dict keys joined with
'.', batch stats (``mean``/``var``) becoming the BatchNorm buffers. The
port never reads an orbax checkpoint; a JAX user converts one with

    from bathymetric_gnn_tpu.inference.pipeline import load_checkpoint_variables
    params, stats, cfg, meta = load_checkpoint_variables("run/best")
    save_checkpoint("run_torch", state_dict_from_flax(
        params, stats, meta.get("param_layout", "coo")), cfg, meta)

A port checkpoint directory holds ``model.pt`` (the state_dict),
``meta.json`` (with ``param_layout``, always ``"grid"``: the naming of
``model.pt``, and ``trained_layout``: the trainer that made the weights,
``"grid"`` for the dense-grid trainer, ``"coo"`` for the graph trainer),
``calibration.json`` and, when a config is given, ``config.yaml``.
``coo_state_dict`` renames a grid-named state_dict to the keys of the
graph models (``models/gnn.py``, ``models/gnn_ell.py``), which nest their
layers under ``GNNBackbone_0`` as the JAX graph models do;
``grid_state_dict`` renames back, so the graph trainer writes grid-named
checkpoints too. GAT layers are ``GridGATConv_i`` in the grid names; the
GCN, GraphSAGE and GIN layers (``GCNConv_i``, ``SAGEConv_i`` with
``lin_l`` / ``bias_l`` / ``lin_r``, ``GINConv_i.TorchLinear_{0,1}``) keep
their names there, beside the ``MaskedBatchNorm_i``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config.config import Config
from ..models.grid_gat import params_from_coo


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


# a conv layer of a graph model's backbone, of any of the four families
_CONV = re.compile(r"(GAT|GCN|SAGE|GIN)Conv_(\d+)$")


def _coo_layers(params: Mapping) -> int:
    bb = params.get("GNNBackbone_0", {})
    return sum(1 for k in bb if _CONV.match(k))


def state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping],
                         layout: str = "grid") -> Dict[str, torch.Tensor]:
    """A flax ``params``/``batch_stats`` pair (nested dicts of arrays) in
    the ``grid`` (GridTrainer) or ``coo`` (graph Trainer) layout -> the
    port's ``state_dict`` (float32 tensors on the CPU)."""
    if layout not in ("grid", "coo"):
        raise ValueError(f"unknown param layout {layout!r}")
    batch_stats = batch_stats or {}
    if layout == "coo":
        n = _coo_layers(params)
        params = params_from_coo(params, n)
        batch_stats = params_from_coo(batch_stats, n)
    flat = _flatten(params)
    flat.update(_flatten(batch_stats))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def coo_state_dict(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A grid-named state_dict (``GridGATConv_i.*``, ``GCNConv_i.*``,
    ``SAGEConv_i.*``, ``GINConv_i.*``, ``MaskedBatchNorm_i.*`` at the top)
    -> the graph models' keys (``GNNBackbone_0.GATConv_i.*``, ...,
    ``GNNBackbone_0.MaskedBatchNorm_i.*``): the inverse of
    ``params_from_coo`` on state_dict keys. Other keys are kept."""
    out = {}
    for key, t in state_dict.items():
        head, _, rest = key.partition(".")
        if head.startswith("GridGATConv_"):
            key = f"GNNBackbone_0.GATConv_{head[len('GridGATConv_'):]}.{rest}"
        elif head.startswith("MaskedBatchNorm_") or _CONV.match(head):
            key = f"GNNBackbone_0.{key}"
        out[key] = t
    return out


def grid_state_dict(state_dict: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The graph models' keys (``GNNBackbone_0.GATConv_i.*``, ...,
    ``GNNBackbone_0.MaskedBatchNorm_i.*``) -> the grid names of a port
    checkpoint (``GridGATConv_i.*``, the other families' ``XConv_i.*`` and
    ``MaskedBatchNorm_i.*`` at the top): the inverse of
    ``coo_state_dict``. Other keys are kept."""
    out = {}
    for key, t in state_dict.items():
        head, _, rest = key.partition(".")
        if head == "GNNBackbone_0":
            layer, _, leaf = rest.partition(".")
            if layer.startswith("GATConv_"):
                key = f"GridGATConv_{layer[len('GATConv_'):]}.{leaf}"
            else:
                key = rest
        out[key] = t
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict, Dict]:
    """Inverse of ``state_dict_from_flax`` (grid layout): returns
    (params, batch_stats) as nested dicts of numpy arrays."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        is_stat = path and path[-1].startswith("MaskedBatchNorm_") and (
            leaf in ("mean", "var"))
        node = stats if is_stat else params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return params, stats


def save_checkpoint(directory, state_dict: Mapping[str, torch.Tensor],
                    config: Optional[Config] = None,
                    meta: Optional[Mapping] = None,
                    calibration: Optional[Mapping] = None) -> Path:
    """Write a port checkpoint directory (see the module docstring).
    ``calibration`` is {"confidence_scale", "confidence_bias"}; identity
    when omitted. Non-JSON values in ``meta`` are dropped."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               d / "model.pt")
    m = {}
    for k, v in (meta or {}).items():
        v = v.tolist() if isinstance(v, np.ndarray) else v
        try:
            json.dumps(v)
        except TypeError:
            continue
        m[k] = v
    # the trainer that made the weights (the caller's param_layout, as the
    # JAX checkpoints record it); model.pt itself is always grid-named
    m["trained_layout"] = m.get("trained_layout",
                                m.get("param_layout", "grid"))
    m["param_layout"] = "grid"
    (d / "meta.json").write_text(json.dumps(m, indent=2))
    cal = dict(calibration or {"confidence_scale": 1.0,
                               "confidence_bias": 0.0})
    (d / "calibration.json").write_text(json.dumps(cal, indent=2))
    if config is not None:
        config.save(d / "config.yaml")
    return d


def load_state_dict(directory) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state_dict, meta) of a port checkpoint directory."""
    d = Path(directory)
    sd = torch.load(d / "model.pt", map_location="cpu", weights_only=True)
    meta_f = d / "meta.json"
    meta = json.loads(meta_f.read_text()) if meta_f.exists() else {}
    return sd, meta
