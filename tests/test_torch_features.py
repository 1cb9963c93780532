"""PyTorch port vs JAX: dense-grid featurization (``build_grid_inputs``).

The same tiles (ramp surfaces with NaN holes, made from numpy seeds) go
through the JAX function one tile at a time and through the port's
batched function; all five outputs are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs as jax_bgi
from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu_torch.ops import features as tf

from conftest import make_ramp_surface

torch.set_num_threads(2)


def _tiles(h, w, n=2, base_depth=30.0):
    depths, valids, uncs = [], [], []
    for s in range(n):
        rg = np.random.default_rng(100 + s)
        d = make_ramp_surface(h, w, base_depth=base_depth, seed=s)
        v = np.ones((h, w), bool)
        v[3:9, 5:14] = False                      # a hole
        v[rg.random((h, w)) < 0.03] = False       # scattered dropouts
        d[~v] = np.nan
        depths.append(d)
        valids.append(v)
        uncs.append(rg.uniform(0.1, 0.5, (h, w)).astype(np.float32))
    return np.stack(depths), np.stack(valids), np.stack(uncs)


# Tolerances: both sides are float32 with the same formulas, so most
# outputs agree to a few ulp of their magnitude: atol 2e-5 (depth-scale
# values near 30 m have ulp 1.9e-6). The local std (feature channel 2 and
# output 4) gets atol 1e-4: it is sqrt(E[d^2] - E[d]^2) of tile-centred
# depths, whose f32 rounding (|d| up to ~3 m here, ulp(9) ~ 1e-6 in the
# variance) is ~5e-5 in a ~1e-2 m std on either side, and the two sides
# sum the tile mean in different orders.
STD_CHANNEL = 2


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("with_unc", [False, True])
@pytest.mark.parametrize("shape", [(37, 53), (16, 128)])
def test_build_grid_inputs_matches_jax(connectivity, with_unc, shape):
    depth, valid, unc = _tiles(*shape)
    res = (2.0, 1.5)
    got = build_grid_inputs(
        torch.from_numpy(np.nan_to_num(depth)), torch.from_numpy(valid),
        torch.from_numpy(unc) if with_unc else None, resolution=res,
        connectivity=connectivity, with_uncertainty=with_unc)
    names = ("features", "valid", "nbr_mask", "edge_attr", "local_std")
    for b in range(depth.shape[0]):
        want = jax_bgi(jnp.asarray(np.nan_to_num(depth[b])),
                       jnp.asarray(valid[b]),
                       jnp.asarray(unc[b]) if with_unc else None,
                       resolution=res, connectivity=connectivity,
                       with_uncertainty=with_unc)
        for name, g, w in zip(names, got, want):
            g, w = g[b].numpy(), np.asarray(w)
            assert g.shape == w.shape, (name, g.shape, w.shape)
            if g.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=name)
                continue
            if name == "features":
                np.testing.assert_allclose(
                    g[..., STD_CHANNEL], w[..., STD_CHANNEL], rtol=0,
                    atol=1e-4, err_msg="features[local_std]")
                g, w = (np.delete(a, STD_CHANNEL, -1) for a in (g, w))
            atol = 1e-4 if name == "local_std" else 2e-5
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol,
                                       err_msg=name)


def test_local_std_deep_water_no_cancellation():
    """At 3000 m a naive E[x^2] - E[x]^2 in f32 loses the centimetre
    roughness entirely; the tile-mean shift keeps it (vs float64)."""
    d = make_ramp_surface(32, 32, base_depth=3000.0, seed=3)
    v = np.ones_like(d, bool)
    _, std, _ = tf.masked_local_stats(torch.from_numpy(d)[None],
                                      torch.from_numpy(v)[None])
    d64 = d.astype(np.float64)
    pad = np.pad(d64, 2, constant_values=np.nan)
    win = np.lib.stride_tricks.sliding_window_view(pad, (5, 5))
    want = np.nanstd(win.reshape(32, 32, 25), axis=-1)
    np.testing.assert_allclose(std[0].numpy(), want, rtol=0, atol=2e-3)
