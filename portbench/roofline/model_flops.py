"""Operations of the grid GAT model, counted from its shapes.

The count is the model's, not a kernel's: whichever kernel or library
computes a layer, the same tiles cost the same operations. A multiply-add
counts 2. Per cell and layer: the node MLP's products, x @ W, the
attention dots x @ (W @ [a_src | a_dst]), the (k + 1)-way weighted sum of
the neighbours' rows and the three heads' products; the featurization,
BatchNorm, softmax and the loss are elementwise and left out (under 2 % of
the total at the default widths). A training step counts 3 x the forward:
the backward of every product takes two products of its size.
"""

from __future__ import annotations

from typing import Dict, List


def gat_layer_dims(cfg: Dict, b: int, h: int, w: int,
                   dtype: str = "float32") -> List[Dict]:
    """The dims of each GAT layer's kernel call for [b, h, w] tiles, in
    the keys of ``h100.gat_infer_bound`` / ``gat_train_bounds``."""
    m, g = cfg["model"], cfg["graph"]
    hid, heads = m["hidden_channels"], m["heads"]
    out, f = [], hid
    for i in range(m["num_layers"]):
        hds = 1 if i == m["num_layers"] - 1 else heads
        out.append(dict(b=b, h=h, w=w, f=f, hc=hid * hds, heads=hds,
                        k=g["connectivity"], ed=g["edge_dim"], dtype=dtype))
        f = hid * hds
    return out


def forward_flops(cfg: Dict, cells: int) -> float:
    """Forward operations of the model over ``cells`` grid cells."""
    m = cfg["model"]
    hid, fin = m["hidden_channels"], cfg["in_channels"]
    per_cell = 2 * (fin * hid + hid * hid * (m["feature_extractor_layers"]
                                             - 1))
    for d in gat_layer_dims(cfg, 1, 1, 1):
        per_cell += (2 * d["f"] * d["hc"] + 2 * d["f"] * 2 * d["heads"]
                     + 2 * (d["k"] + 1) * d["hc"])
    half = hid // 2
    head_outs = [m["num_classes"], 1] + ([1] if m["predict_correction"]
                                         else [])
    for o in head_outs:
        per_cell += 2 * (hid * half + half * o)
    return float(per_cell) * cells


def train_step_flops(cfg: Dict, cells: int) -> float:
    """Forward + backward operations of one training step over ``cells``."""
    return 3.0 * forward_flops(cfg, cells)
