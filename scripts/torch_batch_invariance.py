"""Does a tile's output on the card depend on the batch it is served in?

    python3 scripts/torch_batch_invariance.py [ROOT]

For the checkout whose root is given (default: the one holding this
script): the port's full-width dense grid model (``chip_smoke.py``'s
random weights from seed 0) serves the first 1024^2 tile of
``chip_smoke.py``'s 2304^2 survey in batches of 8, 3 and 1 (the other
slots hold other tiles of the survey), and each stage's output for that
tile (the featurization, the extractor, every GAT layer, the heads, the
packed f16 result) is compared bit for bit with the batch of 8. Then
CUDA-event times, per call over 10 calls after 2 warm-up calls: kernel A's
edge precompute at heads 4 on a batch of 8 (the port's elementwise form
beside the einsum form it replaced) and ``forward_tiles`` on a batch of 8.
Prints the card's name and power limit; exits non-zero when a stage
differs. Needs a CUDA card and nvcc (kernel A is built on first use, into
ROOT/build)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bathymetric_gnn_tpu_torch.data.graph_build import (  # noqa: E402
    build_grid_inputs)
from bathymetric_gnn_tpu_torch.inference.pipeline import (  # noqa: E402
    BathymetricPipeline)
from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf  # noqa


def einsum_edge_precompute(eattr, nbr_mask, m_edge):
    """The edge terms as matrix products (the form before the port made
    them elementwise), for timing."""
    ea, me, nbm = eattr.float(), m_edge.float(), nbr_mask > 0
    el = torch.einsum("bkhwf,fa->bkahw", ea, me)
    el = torch.where(nbm[:, :, None], el, torch.full_like(el, gf.NEG))
    cnt = nbm.float().sum(1).clamp_min(1.0)[..., None]
    mean_in = torch.where(nbm[..., None], ea, 0.0).sum(1) / cnt
    el_self = torch.einsum("bhwf,fa->bahw", mean_in, me)
    return el.contiguous(), el_self.contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_invariance: no CUDA device", file=sys.stderr)
        return 1
    if ROOT not in Path(gf.__file__).resolve().parents:
        print(f"torch_batch_invariance: imported {gf.__file__}, not "
              f"{ROOT}'s", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"torch_batch_invariance: {ROOT} on {card}")
    pipe = BathymetricPipeline()
    pipe.model = cs.seeded_model(torch, np).to(pipe.device)
    depth, _ = cs.synthetic_survey(np, cs.SURVEY, cs.SURVEY, cs.SEED + 3)
    starts = (0, (cs.SURVEY - cs.TILE) // 2, cs.SURVEY - cs.TILE)
    tiles = [depth[r:r + cs.TILE, c:c + cs.TILE]
             for r in starts for c in starts]
    d_all = np.stack([np.nan_to_num(t) for t in tiles])
    v_all = np.stack([np.isfinite(t) for t in tiles])
    res = (2.0, 2.0)

    outs = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=n: outs.__setitem__(n, o[0].float().clone()))
        for n, m in pipe.model.named_children()]
    stages = {}
    with torch.no_grad():
        for b in (8, 3, 1):
            outs.clear()
            d = torch.from_numpy(d_all[:b]).to(pipe.device)
            v = torch.from_numpy(v_all[:b]).to(pipe.device)
            feats, _, _, _, lstd = build_grid_inputs(d, v, resolution=res)
            packed = pipe.forward_tiles(d_all[:b], v_all[:b], None, res)
            stages[b] = dict(features=feats[0].clone(),
                             local_std=lstd[0].clone(), **outs,
                             packed=packed[:, 0].float().clone())
    for h in hooks:
        h.remove()
    bad = 0
    for b in (3, 1):
        for name, ref in stages[8].items():
            n = int((stages[b][name] != ref).sum())
            bad += n
            print(f"tile 0 in a batch of {b} vs of 8: {name}: {n} elements "
                  "differ")

    d = torch.from_numpy(d_all[:8]).to(pipe.device)
    v = torch.from_numpy(v_all[:8]).to(pipe.device)
    _, _, nbr, eattr, _ = build_grid_inputs(d, v, resolution=res)
    conv = pipe.model.GridGATConv_0
    params = dict(conv.named_parameters(recurse=False))
    w, a_src, a_dst, m_edge, _ = gf.gat_param_matrices(
        params, conv.heads, conv.out_channels, 3)
    nbm = nbr.float()
    with torch.no_grad():
        for _ in range(2):
            for name, fn in (
                    ("elementwise (the port's)", lambda: gf.edge_precompute(
                        w, a_src, a_dst, m_edge, eattr, nbm, True)),
                    ("einsum", lambda: einsum_edge_precompute(
                        eattr, nbm, m_edge))):
                print(f"edge precompute, heads 4, batch of 8 1024^2 tiles, "
                      f"{name}: {cs.cuda_ms(torch, fn, 10):.3f} ms")
        ms = cs.cuda_ms(torch, lambda: pipe.forward_tiles(
            d_all[:8], v_all[:8], None, res), 10)
    print(f"forward_tiles, batch of 8 1024^2 tiles: {ms:.3f} ms "
          f"({ms / 8:.3f} ms per tile)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
