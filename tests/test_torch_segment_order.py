"""Kernel F's summation order on the CPU: ``segment_reduce_in_order``, the
oracle the card tests and ``chip_smoke.py`` phase 2g hold kernel F's
mode (a) to bit for bit.

On the same seeded NumPy inputs (77 segments of 0, 1, 8, 40 and random
lengths, so some are empty and one is longer than the kernel's register
slots; dead slots past row_ptr[n] that name NaN rows; rows of widths 1,
2, 3, 4, 8, 64, 256 and 260, f32 and bf16) the oracle equals a NumPy f32
loop that adds each segment's rows in ascending slot order from 0, bit
for bit; and agrees with kernel F's plain version
(``segment_reduce_reference``, ``index_add_``) and with JAX's
``jax.ops.segment_sum`` of the live rows within 1e-6 (1 + |ref|): f32
sums of the same rows in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

WIDTHS = [1, 2, 3, 4, 8, 64, 256, 260]
N = 77
DEAD = 9


def _case(width, dtype, seed=0):
    """(ct, perm, row_ptr, segment of each live sorted slot) with NaN rows
    wherever no live slot reads."""
    rg = np.random.default_rng(seed + width)
    lens = np.concatenate([[0, 1, 8, 40, 0], rg.integers(0, 12, N - 5)])
    live = int(lens.sum())
    rows = live + DEAD + 5
    perm = rg.permutation(rows)[:live + DEAD].astype(np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ct = (3 * rg.normal(size=(rows, width))).astype(np.float32)
    unread = np.ones(rows, bool)
    unread[perm[:live]] = False
    ct[unread] = np.nan
    t = torch.from_numpy(ct).to(dtype)
    seg = np.repeat(np.arange(N), lens)
    return t, torch.from_numpy(perm), torch.from_numpy(row_ptr), seg


def _rel(a, b):
    return ((a - b).abs() / (1 + b.abs())).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", WIDTHS)
def test_in_order_sum_is_ascending_f32_adds(width, dtype):
    ct, perm, row_ptr, _ = _case(width, dtype)
    got = sr.segment_reduce_in_order(ct, perm, row_ptr, N)
    rows = ct.to(torch.float32).numpy()
    want = np.zeros((N, width), np.float32)
    for j in range(N):
        for s in range(int(row_ptr[j]), int(row_ptr[j + 1])):
            want[j] = want[j] + rows[perm[s]]
    assert got.dtype == torch.float32 and got.shape == (N, width)
    assert np.array_equal(got.numpy(), want)
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", WIDTHS)
def test_in_order_sum_matches_plain_and_jax(width, dtype):
    ct, perm, row_ptr, seg = _case(width, dtype, seed=1)
    got = sr.segment_reduce_in_order(ct, perm, row_ptr, N)
    plain = sr.segment_reduce_reference(ct, perm, row_ptr, N)
    assert _rel(got, plain) <= 1e-6
    live = ct.to(torch.float32).numpy()[perm.numpy()[:len(seg)]]
    want = jax.ops.segment_sum(jnp.asarray(live), jnp.asarray(seg),
                               num_segments=N)
    assert _rel(got, torch.from_numpy(np.array(want))) <= 1e-6
    # the CPU entry runs the plain version
    assert torch.equal(sr.segment_reduce_sorted(ct, perm, row_ptr, N), plain)
