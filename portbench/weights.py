"""Seeded weights of a configuration, made on the device in one draw.

The shapes follow the configuration's sizes and the parameter names the
reference's (flax) names, which the port's modules keep. Initialization
as published: dense layers U(-1/sqrt(in), 1/sqrt(in)), the GAT matrices
and attention vectors Glorot-uniform, GAT biases 0, BatchNorm scale 1 and
bias 0. Every value comes from one ``torch.rand`` over the whole
parameter count with a generator on the device seeded by the run's seed.
The BatchNorm running statistics, which serving reads, are drawn too
(means U(-0.35, 0.35), variances U(0.5, 2)); ``with_batch_statistics``
replaces them by the moments of a tile the traffic serves, as a trained
model's match its data: random statistics leave a served model's outputs
all but constant over a survey (its depth, ~30 m, swamps every other
feature), and a comparison of constants sees little.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def grid_gat_shapes(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter and BatchNorm statistic."""
    m, g = cfg["model"], cfg["graph"]
    hid, heads, ed = m["hidden_channels"], m["heads"], g["edge_dim"]
    out = []

    def linear(prefix, fin, fout):
        out.append((f"{prefix}.kernel", (fin, fout), f"lin:{fin}"))
        out.append((f"{prefix}.bias", (fout,), f"lin:{fin}"))

    widths = [cfg["in_channels"]] + [hid] * m["feature_extractor_layers"]
    for i in range(m["feature_extractor_layers"]):
        linear(f"MLPFeatureExtractor_0.TorchLinear_{i}", widths[i],
               widths[i + 1])
    fin = hid
    for i in range(m["num_layers"]):
        hds = 1 if i == m["num_layers"] - 1 else heads
        hc = hid * hds
        p = f"GridGATConv_{i}"
        out += [(f"{p}.lin_src", (fin, hc), "glorot"),
                (f"{p}.att_src", (1, hds, hid), "glorot"),
                (f"{p}.att_dst", (1, hds, hid), "glorot"),
                (f"{p}.lin_edge", (ed, hc), "glorot"),
                (f"{p}.att_edge", (1, hds, hid), "glorot"),
                (f"{p}.bias", (hc,), "zeros")]
        b = f"MaskedBatchNorm_{i}"
        out += [(f"{b}.scale", (hc,), "ones"), (f"{b}.bias", (hc,), "zeros"),
                (f"{b}.mean", (hc,), "bn_mean"), (f"{b}.var", (hc,), "bn_var")]
        fin = hc
    half = hid // 2
    heads_out = [("ClassificationHead_0", m["num_classes"]),
                 ("ConfidenceHead_0", 1)]
    if m["predict_correction"]:
        heads_out.append(("CorrectionHead_0", 1))
    for name, o in heads_out:
        linear(f"{name}.TorchLinear_0", hid, half)
        linear(f"{name}.TorchLinear_1", half, o)
    return out


def _scale(u: torch.Tensor, shape: tuple, init: str) -> torch.Tensor:
    if init.startswith("lin:"):
        bound = 1.0 / math.sqrt(int(init[4:]))
        return (2.0 * u - 1.0) * bound
    if init == "glorot":
        receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
        return (2.0 * u - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
    if init == "zeros":
        return torch.zeros_like(u)
    if init == "ones":
        return torch.ones_like(u)
    if init == "bn_mean":
        return (2.0 * u - 1.0) * 0.35
    if init == "bn_var":
        return 0.5 + 1.5 * u
    raise ValueError(init)


def seeded_state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and statistic of the configuration from ``seed``:
    one uniform draw on ``device``, cut into the leaves."""
    spec = grid_gat_shapes(cfg)
    sizes = [math.prod(s) for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, init), part in zip(spec, flat.split(sizes)):
        out[name] = _scale(part, shape, init).reshape(shape).contiguous()
    return out


def with_batch_statistics(sd: Dict[str, torch.Tensor], cfg: Dict, depth,
                          valid) -> Dict[str, torch.Tensor]:
    """``sd`` with each BatchNorm's running mean and variance set to the
    moments of the [B, H, W] tiles ``depth`` / ``valid`` (the plain
    reference's forward, each BatchNorm normalizing by its own)."""
    from portbench.reference import gat_grid8

    out = dict(sd)
    for name, (mean, var) in gat_grid8.batch_statistics(
            sd, cfg, depth, valid).items():
        out[f"{name}.mean"] = mean.contiguous()
        out[f"{name}.var"] = var.contiguous()
    return out
