"""The yardstick's arithmetic against counts made by hand."""

import math

import pytest

from portbench.roofline import h100, model_flops


def test_infer_bound_by_hand():
    d = dict(b=1, h=2, w=3, f=4, hc=8, heads=2, k=8, dtype="float32")
    ms, by, nbytes, flops = h100.gat_infer_bound(d)
    # n = 6: x 24, W 32, W@a 16, edge terms 9*2*6 = 108, out 48 (x4 B),
    # valid 6 x 4 B, bias / scale / shift 3 x 8 x 4 B
    assert nbytes == 4 * (24 + 32 + 16 + 108 + 48) + 24 + 96
    # x@W 2*6*4*8, dots 2*6*4*4; the 9-way sum 2*9*6*8
    assert flops == 384 + 192 + 864
    t_ops = (576 / (495e12 / 3) + 864 / 67e12) * 1e3
    t_bytes = 1032 / 3.35e12 * 1e3
    assert ms == pytest.approx(max(t_ops, t_bytes))
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


def test_train_bounds_by_hand():
    d = dict(b=2, h=1, w=1, f=3, hc=4, heads=1, k=8, ed=3,
             dtype="bfloat16")
    out = h100.gat_train_bounds(d)
    n, s = 2, 2
    a_bytes = s * (n * 3 + 3 * 4 + 3 * 2 + 9 * 1 * n + n * 4) + 4 * n + 16
    b_bytes = (s * (2 * n * 3 + 12 + 6 + 9 * n + n * 4 + 9 * n * 3)
               + 4 * n + 4 * (12 + 6 + 3 + 4))
    assert out["A"][2] == a_bytes and out["B"][2] == b_bytes
    assert out["A"][3] == 2 * n * 3 * 4 + 2 * n * 3 * 2 + 2 * 9 * n * 4
    assert out["B"][3] == 3 * 2 * n * 3 * (4 + 2) + 4 * 9 * n * 4
    for name in "AB":
        ms, by, nbytes, _ = out[name]
        assert ms >= nbytes / 3.35e12 * 1e3


def test_coo_f_bound_by_hand():
    ms, by, nbytes = h100.coo_f_bound(live=10, n=4, f=2)
    assert nbytes == 4 * (20 + 10 + 5 + 8)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def _tiny_cfg():
    return {"in_channels": 7,
            "model": {"hidden_channels": 4, "num_layers": 2, "heads": 2,
                      "feature_extractor_layers": 2, "num_classes": 3,
                      "predict_correction": True},
            "graph": {"connectivity": 8, "edge_dim": 3}}


def test_model_flops_by_hand():
    cfg = _tiny_cfg()
    # extractor 2*(7*4 + 4*4); GAT 0 (f 4, hc 8, 2 heads)
    # 2*4*8 + 2*4*4 + 2*9*8; GAT 1 (f 8, hc 4, 1 head) 2*8*4 + 2*8*2
    # + 2*9*4; heads (4 -> 2 -> 3, 1, 1) 2*(8 + 6) + 2*(8 + 2) * 2
    per_cell = 88 + 240 + 168 + 28 + 20 + 20
    assert model_flops.forward_flops(cfg, 10) == 10 * per_cell
    assert model_flops.train_step_flops(cfg, 10) == 30 * per_cell


def test_layer_dims_follow_the_config():
    dims = model_flops.gat_layer_dims(_tiny_cfg(), 4, 16, 32)
    assert [(d["f"], d["hc"], d["heads"]) for d in dims] == [(4, 8, 2),
                                                               (8, 4, 1)]
    assert all(d["b"] == 4 and d["h"] == 16 and d["w"] == 32 and
               d["k"] == 8 and d["ed"] == 3 for d in dims)


def test_published_model_flops():
    """The default model: ~0.3 MFLOP a cell forward, as its widths give."""
    import os

    from portbench import harness

    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "gat-grid8.json"))
    per = model_flops.forward_flops(cfg, 1)
    hand = (2 * (7 * 64 + 64 * 64)
            + (2 * 64 * 256 + 2 * 64 * 8 + 18 * 256)
            + 2 * (2 * 256 * 256 + 2 * 256 * 8 + 18 * 256)
            + (2 * 256 * 64 + 2 * 256 * 2 + 18 * 64)
            + 2 * (64 * 32 + 32 * 3) + 4 * (64 * 32 + 32))
    assert per == hand
    assert math.isclose(per, 3.5e5, rel_tol=0.2)
