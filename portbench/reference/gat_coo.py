"""Plain PyTorch reference of the ``gat-coo`` configuration: the same
published model as ``gat_grid8`` on COO tile graphs, trained as the
training CLI's default route trains it.

Each training tile becomes a graph of its valid cells (row-major order,
padded to the node bucket of its count) with an edge from every valid
cell to each valid neighbour of the 8-connected grid (the edge's
attributes taken at its source: distance, depth difference, slope),
ordered by destination and, within a destination, by offset, padded to
8 slots a node; a batch's graphs are laid end to end. The layer is PyG's
GATConv with edge attributes and a self loop whose attribute is the mean
of the incoming ones, summed with ``index_add_``. The dropout draws follow
the node, edge and padding slots in that order, from the benchmark's
generator. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .gat_grid8 import (CORRECTION_NORM_CAP, CORRECTION_NORM_FLOOR,
                        NEG_SLOPE, Dropout, batch_norm, class_weights,
                        features, loss, offsets, precision)

NODE_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
PREFIX = "GNNBackbone_0."


def node_bucket(n: int) -> int:
    for b in NODE_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"{n} nodes exceed the largest bucket")


def tile_graph(depth, valid, connectivity: int = 8, window: int = 5,
               resolution=(1.0, 1.0)) -> Dict[str, torch.Tensor]:
    """One [H, W] tile -> its padded COO graph: x [n_pad, 7], local_std,
    node_mask, rows/cols of the live nodes, src/dst/attr/edge_mask over
    n_pad * connectivity slots. A tile's graph is featurized alone, its
    mean depth summed in float64 (as the host builds a training tile)."""
    dev = depth.device
    valid = valid.bool()
    feats, lstd, lmean = features(depth[None], valid[None], window,
                                  wide_sum=depth.numel() > 32768)
    feats, lstd, lmean = feats[0], lstd[0], lmean[0]
    zero = torch.zeros((), device=dev)
    d = torch.where(valid & torch.isfinite(depth), depth.float(), zero)
    filled = torch.where(valid, d, lmean)
    h, w = valid.shape
    rows, cols = torch.nonzero(valid, as_tuple=True)
    n = rows.shape[0]
    n_pad = node_bucket(max(n, 1))
    ids = torch.full((h, w), -1, dtype=torch.long, device=dev)
    ids[rows, cols] = torch.arange(n, device=dev)
    src, dst, attr, key = [], [], [], []
    k = len(offsets(connectivity))
    for o, (dr, dc) in enumerate(offsets(connectivity)):
        nr, nc = rows + dr, cols + dc
        inb = (nr >= 0) & (nr < h) & (nc >= 0) & (nc < w)
        nbr = ids[nr.clamp(0, h - 1), nc.clamp(0, w - 1)]
        ok = inb & (nbr >= 0)
        s_i = torch.nonzero(ok, as_tuple=True)[0]
        dist = math.hypot(dc * resolution[0], dr * resolution[1])
        dd = (filled[nr.clamp(0, h - 1), nc.clamp(0, w - 1)]
              - filled[rows, cols])[s_i]
        slope = torch.rad2deg(torch.atan((dd / dist).double())).float()
        src.append(s_i)
        dst.append(nbr[s_i])
        attr.append(torch.stack([torch.full_like(dd, dist), dd, slope], -1))
        key.append(nbr[s_i] * k + o)
    order = torch.argsort(torch.cat(key))
    e_live = order.shape[0]
    e_pad = n_pad * k
    g = {"src": torch.zeros(e_pad, dtype=torch.long, device=dev),
         "dst": torch.full((e_pad,), n_pad - 1, dtype=torch.long,
                           device=dev),
         "attr": torch.zeros(e_pad, 3, device=dev),
         "edge_mask": torch.zeros(e_pad, dtype=torch.bool, device=dev),
         "x": torch.zeros(n_pad, feats.shape[-1], device=dev),
         "local_std": torch.zeros(n_pad, device=dev),
         "node_mask": torch.arange(n_pad, device=dev) < n,
         "rows": rows, "cols": cols}
    g["src"][:e_live] = torch.cat(src)[order]
    g["dst"][:e_live] = torch.cat(dst)[order]
    g["attr"][:e_live] = torch.cat(attr)[order]
    g["edge_mask"][:e_live] = True
    g["x"][:n] = feats[rows, cols]
    g["local_std"][:n] = lstd[rows, cols]
    return g


def batch_graph(graphs: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Graphs laid end to end (node indices offset by the nodes before)."""
    out, off = {}, 0
    parts = {k: [] for k in ("src", "dst", "attr", "edge_mask", "x",
                             "local_std", "node_mask")}
    for g in graphs:
        for k in parts:
            v = g[k]
            parts[k].append(v + off if k in ("src", "dst") else v)
        off += g["x"].shape[0]
    for k, v in parts.items():
        out[k] = torch.cat(v)
    return out


def gat_layer(p, name, x, g, heads, concat, keep_e=None, keep_s=None,
              keep_prob=1.0):
    """PyG GATConv with edge attributes and a mean-attribute self loop
    over the live edges of ``g``; ``keep_e`` [E, heads] / ``keep_s``
    [N, heads] drop attention weights after the softmax."""
    n = x.shape[0]
    live = g["edge_mask"]
    src, dst = g["src"][live], g["dst"][live]
    xh = x @ p[f"{name}.lin_src"]
    c = xh.shape[-1] // heads
    xv = xh.reshape(n, heads, c)
    a_s = (xv * p[f"{name}.att_src"].reshape(heads, c)).sum(-1)
    a_d = (xv * p[f"{name}.att_dst"].reshape(heads, c)).sum(-1)
    me = (p[f"{name}.lin_edge"].reshape(-1, heads, c)
          * p[f"{name}.att_edge"].reshape(1, heads, c)).sum(-1)
    ea = g["attr"][live]
    cnt = torch.zeros(n, device=x.device).index_add_(
        0, dst, torch.ones_like(dst, dtype=torch.float32))
    mean_attr = torch.zeros(n, ea.shape[-1], device=x.device).index_add_(
        0, dst, ea) / cnt.clamp_min(1.0)[:, None]
    al_e = F.leaky_relu(a_s[src] + a_d[dst] + ea @ me, NEG_SLOPE)
    al_s = F.leaky_relu(a_s + a_d + mean_attr @ me, NEG_SLOPE)
    with torch.no_grad():
        m = al_s.clone().scatter_reduce_(
            0, dst[:, None].expand(-1, heads), al_e, "amax")
    e_e = torch.exp(al_e - m[dst])
    e_s = torch.exp(al_s - m)
    den = e_s + torch.zeros(n, heads, device=x.device).index_add_(0, dst,
                                                                   e_e)
    w_e, w_s = e_e / den[dst], e_s / den
    if keep_e is not None:
        w_e = torch.where(keep_e[live], w_e / keep_prob,
                          torch.zeros_like(w_e))
        w_s = torch.where(keep_s, w_s / keep_prob, torch.zeros_like(w_s))
    out = xv * w_s[..., None]
    out = out.index_add(0, dst, xv[src] * w_e[..., None])
    out = out.reshape(n, heads * c) if concat else out.mean(1)
    out = out + p[f"{name}.bias"]
    return torch.where(g["node_mask"][:, None], out, torch.zeros_like(out))


def forward(p, cfg, g, drop: Optional[Dropout] = None):
    """The COO model over a batch graph: class logits, confidence and
    normalized correction per node slot; ``drop`` (training) draws the
    dropout in the program's slot order and takes the batch moments."""
    m = cfg["model"]
    train = drop is not None
    dev = g["x"].device
    nm = g["node_mask"]
    x = g["x"]
    n_lin = m["feature_extractor_layers"]
    for i in range(n_lin):
        x = x @ p[f"MLPFeatureExtractor_0.TorchLinear_{i}.kernel"] + p[
            f"MLPFeatureExtractor_0.TorchLinear_{i}.bias"]
        if i < n_lin - 1:
            x = torch.relu(x)
            if train:
                k = drop.keep(x.shape, dev)
                x = torch.where(k, x / drop.keep_prob, torch.zeros_like(x))
    e = g["src"].shape[0]
    for i in range(m["num_layers"]):
        last = i == m["num_layers"] - 1
        heads = 1 if last else m["heads"]
        ke = ks = None
        if train:
            ke = drop.keep((e, heads), dev)
            ks = drop.keep((x.shape[0], heads), dev)
        x = gat_layer(p, f"{PREFIX}GATConv_{i}", x, g, heads, not last, ke,
                      ks, drop.keep_prob if train else 1.0)
        x = batch_norm(p, f"{PREFIX}MaskedBatchNorm_{i}", x, nm, train)
        if not last:
            x = torch.relu(x)
            if train:
                k = drop.keep(x.shape, dev)
                x = torch.where(k, x / drop.keep_prob, torch.zeros_like(x))
        x = torch.where(nm[:, None], x, torch.zeros_like(x))

    def head(name):
        y = torch.relu(x @ p[f"{name}.TorchLinear_0.kernel"]
                       + p[f"{name}.TorchLinear_0.bias"])
        if train:
            k = drop.keep(y.shape, dev)
            y = torch.where(k, y / drop.keep_prob, torch.zeros_like(y))
        return (y @ p[f"{name}.TorchLinear_1.kernel"]
                + p[f"{name}.TorchLinear_1.bias"])

    out = {"class_logits": head("ClassificationHead_0")}
    out["confidence"] = torch.sigmoid(head("ConfidenceHead_0"))[..., 0]
    if m["predict_correction"]:
        out["correction"] = head("CorrectionHead_0")[..., 0]
    return out


def tile_targets(g, labels, raw_corr):
    """Per-node labels and normalized corrections of one tile graph
    (0 on padded slots)."""
    n_pad = g["x"].shape[0]
    n = g["rows"].shape[0]
    lab = torch.zeros(n_pad, dtype=torch.long, device=g["x"].device)
    corr = torch.zeros(n_pad, device=g["x"].device)
    lab[:n] = labels[g["rows"], g["cols"]].long()
    corr[:n] = (raw_corr[g["rows"], g["cols"]]
                / g["local_std"][:n].clamp_min(CORRECTION_NORM_FLOOR)
                ).clamp(-CORRECTION_NORM_CAP, CORRECTION_NORM_CAP)
    return lab, corr


class TrainReference:
    """Steps of the COO training objective from the benchmark's weights
    (as ``gat_grid8.TrainReference``; the Huber delta is the 95th
    percentile of the live noise nodes' |normalized correction| over the
    training tiles, at least 1)."""

    def __init__(self, params, leaves: List[str], cfg, tiles: List[Dict],
                 dropout_seed: int, device, mode: str = "float32"):
        self.cfg, self.mode, self.device = cfg, mode, device
        self.leaves = leaves
        self.p = {k: v.detach().clone().to(device)
                  for k, v in params.items()}
        self.mu = {k: torch.zeros_like(self.p[k]) for k in leaves}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in leaves}
        self.count = 0
        self.graphs = []
        counts = torch.zeros(3, dtype=torch.float64)
        noise_corr = []
        with precision(mode):
            for t in tiles:
                g = tile_graph(*(torch.as_tensor(t[k]).to(device)
                                 for k in ("noisy", "valid")),
                               cfg["graph"]["connectivity"],
                               cfg["graph"]["local_stats_window"])
                lab, corr = tile_targets(
                    g, torch.as_tensor(t["labels"]).to(device),
                    torch.as_tensor(t["raw_corr"]).to(device))
                nm = g["node_mask"]
                counts += torch.bincount(lab[nm], minlength=3)[:3].double(
                    ).cpu()
                noise_corr.append(corr[nm & (lab == 2)])
                self.graphs.append((g, lab, corr))
        self.cw = class_weights(counts.numpy()).to(device)
        nc = torch.cat(noise_corr).abs().double().cpu().numpy()
        self.delta = (float(max(np.percentile(nc, 95.0), 1.0)) if nc.size
                      else 1.0)
        gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
        self.drop = Dropout(gen, cfg["model"]["dropout"])
        self.losses: List[float] = []
        self.first_grads = None

    def step(self, idx: Sequence[int], lr: float):
        t = self.cfg["training"]
        parts = [self.graphs[i] for i in idx]
        g = batch_graph([q[0] for q in parts])
        labels = torch.cat([q[1] for q in parts])
        target = torch.cat([q[2] for q in parts])
        with precision(self.mode):
            for k in self.leaves:
                self.p[k].requires_grad_(True)
            out = forward(self.p, self.cfg, g, self.drop)
            total = loss(self.cfg, out, labels, target, g["node_mask"],
                         self.cw, self.delta)
            grads = torch.autograd.grad(total, [self.p[k]
                                                for k in self.leaves])
        with torch.no_grad():
            norm = torch.sqrt(sum(q.square().sum() for q in grads))
            if float(norm) >= t["grad_clip_norm"]:
                grads = [q / norm * t["grad_clip_norm"] for q in grads]
            self.count += 1
            bc1, bc2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
            for k, q in zip(self.leaves, grads):
                p = self.p[k].detach()
                self.mu[k] = 0.1 * q + 0.9 * self.mu[k]
                self.nu[k] = 0.001 * q * q + 0.999 * self.nu[k]
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                          + 1e-8)
                self.p[k] = p - lr * (u + t["weight_decay"] * p)
        if self.first_grads is None:
            self.first_grads = {k: q.detach().clone()
                                for k, q in zip(self.leaves, grads)}
        self.losses.append(float(total.detach()))
