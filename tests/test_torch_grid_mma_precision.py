"""Why the f32 grid-GAT kernels (A and B) split their tensor-core products
into three TF32 passes (3xTF32), emulated in numpy on the CPU.

TF32 keeps 10 of f32's 23 mantissa bits; ``cvt.rna.tf32.f32`` rounds to
nearest with ties away from zero. The kernels split each f32 operand v into
hi = rna(v) and lo = rna(v - hi) and accumulate hi.hi + hi.lo + lo.hi in
f32 (``csrc/grid_gat_mma.cuh``). On seeded x and Glorot-scaled W at the
model's layer shapes, that product stays within the tolerance the card
holds the f32 kernel to (``chip_smoke.py``'s ``TOL``: 1e-4 of 1 + |ref|)
of the float64 product; one TF32 pass does not, which is the documented
reason for the split.
"""

import numpy as np
import pytest

TOL = 1e-4          # chip_smoke.TOL["float32"]: |err| <= TOL * (1 + |ref|)
N = 4096


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """f32 -> TF32 (kept in f32): round to nearest, ties away from zero, at
    10 mantissa bits (``cvt.rna.tf32.f32``) for finite values."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(v: np.ndarray):
    hi = tf32_rna(v)
    return hi, tf32_rna((v - hi).astype(np.float32))


def mm32(a, b):
    """A product of TF32 operands with f32 accumulation: each TF32 x TF32
    product is exact in f32 (2 x 11 significant bits), the sums are f32."""
    return np.matmul(a.astype(np.float32), b.astype(np.float32),
                     dtype=np.float32)


def three_tf32(x, w):
    xh, xl = split(x)
    wh, wl = split(w)
    return (mm32(xl, wh) + mm32(xh, wl)) + mm32(xh, wh)


def one_tf32(x, w):
    return mm32(tf32_rna(x), tf32_rna(w))


def _operands(f, hc, seed):
    rg = np.random.default_rng(seed)
    x = rg.standard_normal((N, f)).astype(np.float32)
    lim = np.sqrt(6.0 / (f + hc))
    w = rg.uniform(-lim, lim, (f, hc)).astype(np.float32)
    return x, w


def _rel_err(got, x, w):
    ref = x.astype(np.float64) @ w.astype(np.float64)
    return float((np.abs(got - ref) / (1 + np.abs(ref))).max())


def test_tf32_rounding_is_round_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's step at 1.0
    v = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4, 3.0], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(v), np.array([one + ulp, -(one + ulp), one, one + ulp,
                               3.0], np.float32))
    hi, lo = split(np.array([np.pi], np.float32))
    assert abs(float(hi[0]) + float(lo[0]) - float(np.float32(np.pi))) \
        <= 2.0 ** -21 * np.pi


@pytest.mark.parametrize("f,hc", [(64, 256), (256, 256), (256, 64)])
def test_three_tf32_meets_the_f32_tolerance(f, hc):
    x, w = _operands(f, hc, seed=f + hc)
    err3 = _rel_err(three_tf32(x, w), x, w)
    err32 = _rel_err(mm32(x, w), x, w)
    assert err3 <= TOL, err3
    # as close to float64 as a plain f32 product, within a factor 4
    assert err3 <= 4 * err32 + 1e-7, (err3, err32)


def test_one_tf32_pass_does_not():
    """The reason for the split: at 256 -> 256 a single TF32 pass misses
    the f32 tolerance by an order of magnitude."""
    x, w = _operands(256, 256, seed=512)
    err1 = _rel_err(one_tf32(x, w), x, w)
    assert err1 > 5 * TOL, err1
