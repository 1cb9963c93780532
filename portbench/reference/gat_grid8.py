"""Plain PyTorch reference of the ``gat-grid8`` configuration.

The reference's published default model (an MLP node encoder, four GAT
layers on the 8-connected grid with edge attributes and a self loop, a
masked BatchNorm after each, three heads), its featurization of gridded
depth, the packed survey output, the five-term training loss, global-norm
clipping and AdamW, written from the equations in plain torch operations.
It imports nothing of the program and takes nothing the program made:
the weights, the tiles and the dropout generator's seed are the
benchmark's, and every derived table (features, neighbour masks, edge
attributes, class weights, dropout masks) is worked out here again.

It runs in float32 with TF32 off (``precision="tf32"`` turns TF32 on:
the control a lower precision gives). Gradients come from autograd.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

OFFSETS_8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
             (1, 1))
OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
CLASS_FEATURE, CLASS_NOISE, CLASS_SEAFLOOR = 1, 2, 0
CORRECTION_NORM_FLOOR = 0.01
CORRECTION_NORM_CAP = 50.0
BN_EPS = 1e-5
NEG_SLOPE = 0.2


@contextlib.contextmanager
def precision(mode: str = "float32"):
    """Matrix products in true f32 (``"float32"``) or TF32 (``"tf32"``)
    inside the block; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def offsets(connectivity: int):
    return OFFSETS_8 if connectivity == 8 else OFFSETS_4


# -- featurization -------------------------------------------------------


def _sqrt(x):
    return torch.sqrt(x.double()).float()


def _shift(a, dr, dc):
    """a'[b, r, c] = a[b, r + dr, c + dc] (wrapping; callers mask)."""
    return torch.roll(a, shifts=(-dr, -dc), dims=(1, 2))


def _box_sum(x, size):
    """Sum over a size x size window, zero outside the tile: the rows'
    shifted copies added in order, then the columns'. The local variance
    is a difference of two such sums that cancels to ~1e-5 of either on
    smooth ground, so the order of the additions shows in the local std;
    this is the order of the published featurization (``uniform_filter``
    as separable passes)."""
    pad = size // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, pad, size - 1 - pad))
    acc = xp[:, 0:h]
    for i in range(1, size):
        acc = acc + xp[:, i:i + h]
    xp = F.pad(acc, (pad, size - 1 - pad))
    out = xp[:, :, 0:w]
    for i in range(1, size):
        out = out + xp[:, :, i:i + w]
    return out


def _tile_sum(x, wide: bool = False):
    """Per-tile sums [B, 1, 1]: a pairwise tree over the flat tile, or
    with ``wide`` one sum in float64, rounded once (the host's form, for
    a lone large tile)."""
    if wide:
        return x.sum(dim=(1, 2), keepdim=True, dtype=torch.float64).to(
            x.dtype)
    v = x.reshape(x.shape[0], -1)
    n = v.shape[1]
    v = F.pad(v, (0, (1 << (n - 1).bit_length()) - n))
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v.reshape(-1, 1, 1)


def _np_gradient(a, dim):
    n = a.shape[dim]
    if n < 2:
        return torch.zeros_like(a)
    g = (torch.roll(a, -1, dim) - torch.roll(a, 1, dim)) / 2.0
    g.narrow(dim, 0, 1).copy_(a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1))
    g.narrow(dim, n - 1, 1).copy_(a.narrow(dim, n - 1, 1)
                                  - a.narrow(dim, n - 2, 1))
    return g


def features(depth, valid, window: int = 5, wide_sum: bool = False):
    """[B, H, W] depth (NaN-safe) and valid -> (features [B, H, W, 7],
    local_std [B, H, W], local_mean [B, H, W]): depth, the boundary-aware
    local mean and std over a window x window box (about each tile's mean
    depth, summed as ``_tile_sum`` with ``wide_sum``), np.gradient's x
    and y, its magnitude and the 5-point Laplacian with edge replication
    (0 where fewer than 3 of the 3 x 3 cells are valid); zero on invalid
    cells."""
    valid = valid.bool()
    zero = torch.zeros((), device=depth.device)
    d = torch.where(valid & torch.isfinite(depth), depth.float(), zero)
    vf = valid.float()
    n_valid = vf.sum(dim=(1, 2), keepdim=True).clamp_min(1.0)
    center = _tile_sum(torch.where(valid, d, zero), wide_sum) / n_valid
    d0 = torch.where(valid, d - center, zero)
    cnt = _box_sum(vf, window)
    mean0 = _box_sum(d0, window) / cnt.clamp_min(1.0)
    var = (_box_sum(d0 * d0, window) / cnt.clamp_min(1.0)
           - mean0 * mean0).clamp_min(0.0)
    lstd = _sqrt(var)
    lmean = torch.where(cnt > 0, mean0 + center, zero)
    filled = torch.where(valid, d, lmean)
    gy, gx = _np_gradient(filled, 1), _np_gradient(filled, 2)
    gmag = _sqrt(gx * gx + gy * gy)
    xp = F.pad(filled[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    lap = (xp[:, :-2, 1:-1] + xp[:, 1:-1, :-2] - 4.0 * xp[:, 1:-1, 1:-1]
           + xp[:, 1:-1, 2:] + xp[:, 2:, 1:-1])
    curv = torch.where(_box_sum(vf, 3) < 3, torch.zeros_like(lap), lap)
    f = torch.stack([d, lmean, lstd, gx, gy, gmag, curv], -1)
    f = torch.nan_to_num(torch.where(valid[..., None], f, zero), nan=0.0)
    return f, torch.where(valid, lstd, zero), lmean


def grid_graph(depth, valid, connectivity: int = 8, window: int = 5,
               resolution=(1.0, 1.0)):
    """The dense grid graph of [B, H, W] tiles: (features, valid, nbr
    [B, K, H, W] bool: an in-bounds valid neighbour at offset k, eattr
    [B, K, H, W, 3]: distance, depth[i] - depth[neighbour] and the slope
    in degrees of the edge from offset k into each cell, local_std)."""
    valid = valid.bool()
    feats, lstd, lmean = features(depth, valid, window)
    zero = torch.zeros((), device=depth.device)
    d = torch.where(valid & torch.isfinite(depth), depth.float(), zero)
    filled = torch.where(valid, d, lmean)
    _, h, w = valid.shape
    rows = torch.arange(h, device=depth.device)[:, None]
    cols = torch.arange(w, device=depth.device)[None, :]
    nbrs, attrs = [], []
    for dr, dc in offsets(connectivity):
        inb = ((rows + dr >= 0) & (rows + dr < h) & (cols + dc >= 0)
               & (cols + dc < w))
        m = valid & _shift(valid, dr, dc) & inb
        dist = math.hypot(dc * resolution[0], dr * resolution[1])
        dd = filled - _shift(filled, dr, dc)
        slope = torch.rad2deg(torch.atan((dd / dist).double())).float()
        a = torch.stack([torch.full_like(dd, dist), dd, slope], -1)
        nbrs.append(m)
        attrs.append(torch.where(m[..., None], a, zero))
    return feats, valid, torch.stack(nbrs, 1), torch.stack(attrs, 1), lstd


# -- the model -----------------------------------------------------------


def _linear(p, name, x):
    return x @ p[f"{name}.kernel"] + p[f"{name}.bias"]


def _drop(x, keep, keep_prob):
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def philox_keep(seed: int, shape: Sequence[int], keep_prob: float,
                device) -> torch.Tensor:
    """The attention-dropout multipliers of the grid layers' in-kernel
    draw: Philox4x32-10 (Salmon et al., SC'11) keyed by the 64-bit
    ``seed``, counter (flat index low word, high word, 0, 0) over
    ``shape`` = [B, K + 1, heads, H, W]; an entry is kept, as 1 /
    keep_prob, where the first output word is >= round((1 - keep_prob) *
    2^32)."""
    m32 = 0xFFFFFFFF
    idx = torch.arange(math.prod(shape), device=device, dtype=torch.int64)
    c0, c1 = idx & m32, idx >> 32
    c2 = torch.zeros_like(idx)
    c3 = torch.zeros_like(idx)
    k0, k1 = seed & m32, (seed >> 32) & m32
    for _ in range(10):
        p0 = 0xD2511F53 * c0   # wraps mod 2^64: its low word is exact
        p1 = 0xCD9E8D57 * c2
        hi0, lo0 = (p0 >> 32) & m32, p0 & m32
        hi1, lo1 = (p1 >> 32) & m32, p1 & m32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & m32
        k1 = (k1 + 0xBB67AE85) & m32
    thresh = min(2 ** 32 - 1, int(round((1.0 - keep_prob) * 2 ** 32)))
    keep = (c0 >= thresh).reshape(shape)
    return keep.float() * (1.0 / keep_prob)


class Dropout:
    """The dropout draws of one training forward, in the order the model
    makes them, from the generator ``gen`` (the benchmark's, seeded from
    the run's seed): the node MLP's, then per GAT layer its attention
    dropout (on the card one 64-bit Philox seed drawn from ``gen``, on the
    CPU the multipliers themselves) and its feature dropout, then the
    three heads'."""

    def __init__(self, gen: torch.Generator, rate: float):
        self.gen, self.keep_prob = gen, 1.0 - rate

    def keep(self, shape, device):
        return torch.rand(shape, generator=self.gen,
                          device=device) < self.keep_prob

    def attention(self, shape, device):
        if torch.device(device).type == "cuda":
            seed = torch.randint(0, 2 ** 62, (1,), generator=self.gen,
                                 device=device, dtype=torch.int64)
            return philox_keep(int(seed.item()), shape, self.keep_prob,
                               device)
        return self.keep(shape, device).float() / self.keep_prob


def gat_layer(p, name, x, valid, nbr, eattr, heads, concat, connectivity,
              attn_mult=None):
    """One GAT layer, PyG GATConv semantics on the grid: per head the
    softmax over the valid neighbours' and the self loop's
    LeakyReLU(a_src . xh_j + a_dst . xh_i + a_edge . (e_ij W_edge))
    logits (the self loop's edge attribute is the mean of the valid
    incoming ones), weighted sum of the neighbours' xh (heads
    concatenated, or averaged when not ``concat``), + bias, 0 off the
    valid cells. ``attn_mult`` [B, K + 1, heads, H, W] (self loop last)
    scales the weights after the softmax (attention dropout)."""
    b, h, w, _ = x.shape
    xh = x @ p[f"{name}.lin_src"]
    c = xh.shape[-1] // heads
    xv = xh.reshape(b, h, w, heads, c)
    a_src = (xv * p[f"{name}.att_src"].reshape(heads, c)).sum(-1)
    a_dst = (xv * p[f"{name}.att_dst"].reshape(heads, c)).sum(-1)
    we = p[f"{name}.lin_edge"].reshape(-1, heads, c)
    me = (we * p[f"{name}.att_edge"].reshape(1, heads, c)).sum(-1)
    nbf = nbr.float()
    cnt = nbf.sum(1).clamp_min(1.0)[..., None]
    e_self = (eattr * nbf[..., None]).sum(1) / cnt             # [B,H,W,3]
    logits = []
    for k, (dr, dc) in enumerate(offsets(connectivity)):
        lg = F.leaky_relu(_shift(a_src, dr, dc) + a_dst
                          + eattr[:, k] @ me, NEG_SLOPE)
        logits.append(torch.where(nbr[:, k, ..., None], lg,
                                  torch.full_like(lg, -math.inf)))
    logits.append(F.leaky_relu(a_src + a_dst + e_self @ me, NEG_SLOPE))
    wts = torch.softmax(torch.stack(logits, 1), dim=1)       # [B,K+1,H,W,h]
    if attn_mult is not None:
        wts = wts * attn_mult.permute(0, 1, 3, 4, 2)
    out = xv * wts[:, -1, ..., None]
    for k, (dr, dc) in enumerate(offsets(connectivity)):
        out = out + _shift(xv, dr, dc) * wts[:, k, ..., None]
    out = out.reshape(b, h, w, heads * c) if concat else out.mean(-2)
    out = out + p[f"{name}.bias"]
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def batch_norm(p, name, x, valid, train: bool, stats=None):
    """Masked BatchNorm over the valid cells: the batch's biased moments
    in training or when ``stats`` (a dict, which receives them) is given,
    the running ones otherwise."""
    if train or stats is not None:
        m = valid[..., None].float()
        n = m.sum().clamp_min(1.0)
        dims = tuple(range(x.dim() - 1))
        mean = (x * m).sum(dims) / n
        var = (((x - mean) ** 2) * m).sum(dims) / n
        if stats is not None:
            stats[name] = (mean, var)
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    return ((x - mean) * torch.rsqrt(var + BN_EPS) * p[f"{name}.scale"]
            + p[f"{name}.bias"])


def forward(p: Dict[str, torch.Tensor], cfg: Dict, feats, valid, nbr,
            eattr, drop: Optional[Dropout] = None, stats=None):
    """The model on [B, H, W] tiles: the class logits, the confidence and
    the normalized correction per cell. ``drop`` (training) draws the
    dropout and takes the batch's BatchNorm moments; ``stats`` (a dict)
    takes the batch's moments too, without dropout, and receives them."""
    m, g = cfg["model"], cfg["graph"]
    train = drop is not None
    dev = feats.device
    x = feats
    n_lin = m["feature_extractor_layers"]
    for i in range(n_lin):
        x = _linear(p, f"MLPFeatureExtractor_0.TorchLinear_{i}", x)
        if i < n_lin - 1:
            x = torch.relu(x)
            if train:
                x = _drop(x, drop.keep(x.shape, dev), drop.keep_prob)
    b, h, w, _ = x.shape
    k = g["connectivity"]
    for i in range(m["num_layers"]):
        last = i == m["num_layers"] - 1
        heads = 1 if last else m["heads"]
        mult = (drop.attention((b, k + 1, heads, h, w), dev) if train
                else None)
        x = gat_layer(p, f"GridGATConv_{i}", x, valid, nbr, eattr, heads,
                      not last, k, mult)
        x = batch_norm(p, f"MaskedBatchNorm_{i}", x, valid, train, stats)
        if not last:
            x = torch.relu(x)
            if train:
                keep = drop.keep((b * h * w, x.shape[-1]), dev)
                x = _drop(x, keep.reshape(x.shape), drop.keep_prob)
        x = torch.where(valid[..., None], x, torch.zeros_like(x))

    def head(name):
        y = torch.relu(_linear(p, f"{name}.TorchLinear_0", x))
        if train:
            y = _drop(y, drop.keep(y.shape, dev), drop.keep_prob)
        return _linear(p, f"{name}.TorchLinear_1", y)

    out = {"class_logits": head("ClassificationHead_0")}
    out["confidence"] = torch.sigmoid(head("ConfidenceHead_0"))[..., 0]
    if m["predict_correction"]:
        out["correction"] = head("CorrectionHead_0")[..., 0]
    return out


@torch.no_grad()
def batch_statistics(p, cfg, depth, valid) -> Dict[str, tuple]:
    """Each BatchNorm's (mean, biased variance) over the valid cells of
    [B, H, W] tiles, every BatchNorm normalizing by its own (no
    dropout)."""
    stats: Dict[str, tuple] = {}
    with precision("float32"):
        feats, v, nbr, ea, _ = grid_graph(depth, valid,
                                          cfg["graph"]["connectivity"],
                                          cfg["graph"]["local_stats_window"])
        forward(p, cfg, feats, v, nbr, ea, stats=stats)
    return stats


# -- survey output -------------------------------------------------------


@torch.no_grad()
def survey_tiles(p, cfg, depth, valid, mode: str = "float32"):
    """[B, H, W] tiles -> the packed f16 [3, B, H, W] output (class,
    confidence, correction denormalized by max(local std, 0.01)), one tile
    at a time."""
    outs = []
    with precision(mode):
        for t in range(depth.shape[0]):
            feats, v, nbr, ea, lstd = grid_graph(
                depth[t:t + 1], valid[t:t + 1], cfg["graph"]["connectivity"],
                cfg["graph"]["local_stats_window"])
            o = forward(p, cfg, feats, v, nbr, ea)
            corr = o["correction"] * lstd.clamp_min(CORRECTION_NORM_FLOOR)
            outs.append(torch.stack([
                o["class_logits"].argmax(-1).to(torch.float16),
                o["confidence"].to(torch.float16),
                corr.to(torch.float16)]))
            del feats, nbr, ea, o
    return torch.cat(outs, 1)


# -- training ------------------------------------------------------------


def class_weights(counts, smoothing: float = 0.1) -> torch.Tensor:
    """Inverse-frequency class weights, smoothed, summing to the class
    count."""
    c = torch.as_tensor(counts, dtype=torch.float64)
    freq = c / max(float(c.sum()), 1.0)
    wt = 1.0 / (freq + smoothing)
    return (wt / wt.sum() * len(c)).float()


def loss(cfg, out, labels, corr_target, valid, cw, delta: float = 1.0):
    """The five-term objective over the valid cells: weighted cross
    entropy (normalized by the target classes' weights), Huber (``delta``)
    on the normalized correction of noise cells, the confidence's BCE
    against 1[predicted == true], the feature-erasure penalty (2 x the
    share of features called noise) and the shoal-safety penalty (3 per
    shoal-side and 1 per deep-side seafloor cell called noise, over their
    count)."""
    t = cfg["training"]
    logits = out["class_logits"].reshape(-1, cfg["model"]["num_classes"])
    y = labels.reshape(-1).long()
    vm = valid.reshape(-1)
    vf = vm.float()
    nv = vf.sum().clamp_min(1.0)
    pred = logits.argmax(-1)
    logp = torch.log_softmax(logits, -1)
    ce_num = -(logp.gather(1, y[:, None])[:, 0] * cw[y] * vf).sum()
    ce = ce_num / (cw[y] * vf).sum().clamp_min(1.0)
    noise = (y == CLASS_NOISE) & vm
    diff = torch.where(noise, out["correction"].reshape(-1)
                       - corr_target.reshape(-1), torch.zeros_like(vf))
    a = diff.abs()
    hub = torch.where(a <= delta, 0.5 * diff * diff,
                      delta * (a - 0.5 * delta))
    corr = hub.sum() / noise.float().sum().clamp_min(1.0)
    ok = (pred == y).float()
    cconf = out["confidence"].reshape(-1).clamp(1e-7, 1 - 1e-7)
    bce = -(ok * torch.log(cconf) + (1 - ok) * torch.log(1 - cconf))
    conf = (bce * vf).sum() / nv
    feat = 2.0 * ((y == CLASS_FEATURE) & (pred == CLASS_NOISE)
                  & vm).float().sum() / nv
    fp = ((y == CLASS_SEAFLOOR) & (pred == CLASS_NOISE) & vm).float()
    shoal = corr_target.reshape(-1) < 0
    sh = ((3.0 * (fp * shoal.float()).sum()
           + (fp * (~shoal).float()).sum()) / fp.sum().clamp_min(1.0))
    return (t["classification_weight"] * ce + t["correction_weight"] * corr
            + t["confidence_weight"] * conf
            + t["feature_preservation_weight"] * feat
            + t["shoal_safety_weight"] * sh)


class TrainReference:
    """Steps of the training objective from the benchmark's weights:
    forward with dropout, the loss, autograd, clipping by the global norm
    (unchanged below the limit, scaled to it above) and AdamW (b1 0.9, b2
    0.999, eps 1e-8, decoupled decay added to the update) at a fixed
    learning rate."""

    def __init__(self, params: Dict[str, torch.Tensor], leaves: List[str],
                 cfg: Dict, counts, dropout_seed: int, device,
                 mode: str = "float32"):
        self.cfg, self.mode, self.device = cfg, mode, device
        self.leaves = leaves
        self.p = {k: v.detach().clone().to(device) for k, v in
                  params.items()}
        self.mu = {k: torch.zeros_like(self.p[k]) for k in leaves}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in leaves}
        self.count = 0
        self.cw = class_weights(counts).to(device)
        gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
        self.drop = Dropout(gen, cfg["model"]["dropout"])
        self.losses: List[float] = []
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, batch: Dict, lr: float):
        t = self.cfg["training"]
        dev = self.device
        with precision(self.mode):
            depth = torch.as_tensor(batch["noisy"]).to(dev)
            valid = torch.as_tensor(batch["valid"]).to(dev)
            feats, v, nbr, ea, lstd = grid_graph(
                depth, valid, self.cfg["graph"]["connectivity"],
                self.cfg["graph"]["local_stats_window"])
            raw = torch.as_tensor(batch["raw_correction"]).to(dev)
            target = (raw / lstd.clamp_min(CORRECTION_NORM_FLOOR)).clamp(
                -CORRECTION_NORM_CAP, CORRECTION_NORM_CAP)
            labels = torch.as_tensor(batch["labels"]).to(dev)
            for k in self.leaves:
                self.p[k].requires_grad_(True)
            out = forward(self.p, self.cfg, feats, v, nbr, ea, self.drop)
            total = loss(self.cfg, out, labels, target, v, self.cw)
            grads = torch.autograd.grad(total, [self.p[k]
                                                for k in self.leaves])
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if float(norm) >= t["grad_clip_norm"]:
                grads = [g / norm * t["grad_clip_norm"] for g in grads]
            self.count += 1
            bc1 = 1 - 0.9 ** self.count
            bc2 = 1 - 0.999 ** self.count
            for k, g in zip(self.leaves, grads):
                p = self.p[k].detach()
                self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
                self.nu[k] = 0.001 * g * g + 0.999 * self.nu[k]
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                          + 1e-8)
                self.p[k] = p - lr * (u + t["weight_decay"] * p)
        if self.first_grads is None:
            self.first_grads = {k: g.detach().clone()
                                for k, g in zip(self.leaves, grads)}
        self.losses.append(float(total.detach()))
