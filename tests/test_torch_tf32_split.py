"""The split-TF32 ("3xTF32") arithmetic of the conv4d kernel's float32
route, emulated on the CPU with numpy.

The kernel (``csrc/conv4d_fwd.cu``, ``csrc/mma_tf32.cuh``) splits each
float32 operand ``a`` into ``hi = cvt.rna.tf32.f32(a)`` and ``lo =
cvt.rna.tf32.f32(a - hi)`` and, per k8 step of ``mma.sync.m16n8k8.tf32``,
accumulates ``A_lo*B_hi``, then ``A_hi*B_lo``, then ``A_hi*B_hi``. Here
that is emulated on the bit patterns: TF32 products are exact in float32,
and each MMA adds its 8 products to its accumulator and rounds the sum
toward zero, as the tensor cores do. The kernel keeps one such partial sum
for each dk slice of a staged row (5 taps x 16 channels, 10 k8 steps) and
adds it into a float32 accumulator with one rounding to nearest.

The tests show, on the serving check's input law (post-ReLU-like
activations in [0, 1), reference-init weights) and the 16->16, ks = 5
layer (10,000 terms an output), that the split holds the serving check's
1e-4 with room to spare, that one TF32 product does not, and that one
long sum inside the tensor cores would lose most of the split's gain.
This file imports neither JAX nor the JAX package.
"""

import re

import numpy as np
import pytest
import torch

from ncnet_tpu_torch.kernels.conv4d import float32_route, route
from ncnet_tpu_torch.kernels.conv4d_dw import DW_PARTIAL_K8, SOURCE as DW_SOURCE
from ncnet_tpu_torch.ops.conv4d import conv4d_plain

# the serving check of chip_smoke.py: kernel vs plain, relative to max |out|
SERVE_TOL = 1e-4
# chip_smoke.py's dw check (DW_TOL[float32], relative to max |dw|) and its
# NC gradient rule: within GRAD_RATIO times the plain float32 version's own
# error, or GRAD_TOL of the scale where that is larger
DW_TOL = 1e-4
GRAD_TOL, GRAD_RATIO = 1e-4, 4.0


def cvt_rna_tf32(a):
    """``cvt.rna.tf32.f32``: a float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero, on its bit pattern (infinities and
    NaNs pass through)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    finite = (bits & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    # adding half of the dropped 13 bits' unit to the magnitude rounds a
    # tie up in magnitude, i.e. away from zero
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(finite, rounded, bits).view(np.float32)


def tf32_split(a):
    hi = cvt_rna_tf32(a)
    lo = cvt_rna_tf32(np.asarray(a, np.float32) - hi)
    return hi, lo


def round_toward_zero(v):
    """float64 -> float32, rounded toward zero."""
    out = v.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(v)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


# k8 steps of one dk slice of a staged row: 5 taps x 16 channels
PARTIAL_K8 = 10


def mma_sum(pairs, k, partial_k8=PARTIAL_K8):
    """The kernel's float32 result: per k8 step, one MMA for each (A, B)
    pair in the listed order, each adding its 8 exact products to the
    partial sum and rounding toward zero; every ``partial_k8`` steps the
    partial goes into the float32 sum with one rounding to nearest (None:
    one partial over the whole sum)."""
    n, m = pairs[0][0].shape[0], pairs[0][1].shape[1]
    acc = np.zeros((n, m), np.float32)
    part = np.zeros((n, m), np.float32)
    for step, k0 in enumerate(range(0, k, 8)):
        for a, b in pairs:
            prod = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
            part = round_toward_zero(part.astype(np.float64) + prod)
        if partial_k8 is not None and (step + 1) % partial_k8 == 0:
            acc = (acc.astype(np.float64) + part).astype(np.float32)
            part[:] = 0
    return (acc.astype(np.float64) + part).astype(np.float32)


def _layer(seed, grid=8, ks=5, cin=16, cout=16):
    """A 16->16, ks = 5 layer on a small grid from a numpy seed: the
    contraction of each interior output (all 10,000 terms on the grid) as
    an im2col matrix, the weights as [k, cout], and the float64 answer."""
    rng = np.random.default_rng(seed)
    x = rng.random((1, grid, grid, grid, grid, cin), dtype=np.float32)
    bound = (cin * ks**4) ** -0.5
    w = ((rng.random((ks,) * 4 + (cin, cout)) * 2 - 1) * bound).astype(np.float32)
    win = np.lib.stride_tricks.sliding_window_view(x[0], (ks,) * 4, axis=(0, 1, 2, 3))
    n = grid - ks + 1
    a = np.ascontiguousarray(win.transpose(0, 1, 2, 3, 5, 6, 7, 8, 4)).reshape(
        n**4, ks**4 * cin)
    b = w.reshape(ks**4 * cin, cout)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    # the im2col order is the port's convolution: its plain version in
    # float64 gives the same interior outputs
    p = ks // 2
    plain = conv4d_plain(torch.from_numpy(x).double(), torch.from_numpy(w).double())
    interior = plain[0, p:grid - p, p:grid - p, p:grid - p, p:grid - p].reshape(-1, cout)
    np.testing.assert_allclose(interior.numpy(), ref, rtol=0, atol=1e-12)
    return a, b, ref


def test_cvt_rna_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's unit in the last place at 1
    cases = [
        (one, one),
        (one + ulp, one + ulp),                    # already TF32
        (one + ulp / 2, one + ulp),                # tie: away from zero
        (-(one + ulp / 2), -(one + ulp)),
        (one + ulp * 3 / 2, one + 2 * ulp),        # tie at an odd unit too
        (one + ulp / 2 - np.float32(2.0**-23), one),  # just below the tie
        (one + ulp / 2 + np.float32(2.0**-23), one + ulp),
        (np.float32(0.0), np.float32(0.0)),
    ]
    for a, want in cases:
        assert cvt_rna_tf32(np.float32(a)) == np.float32(want), (a, want)
    got = cvt_rna_tf32(np.array([np.inf, -np.inf, np.nan], np.float32))
    assert np.isinf(got[:2]).all() and np.isnan(got[2])
    # the result is a TF32 bit pattern: the low 13 mantissa bits are zero
    vals = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    assert not (cvt_rna_tf32(vals).view(np.uint32) & np.uint32(0x1FFF)).any()


def test_split_reconstructs_float32_to_2_pow_minus_21():
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(100_000) * np.exp(rng.uniform(-20, 20, 100_000))
         ).astype(np.float32)
    hi, lo = tf32_split(a)
    rel = np.abs(a.astype(np.float64) - hi.astype(np.float64) - lo) / np.abs(a)
    assert rel.max() <= 2.0**-21, rel.max()
    # hi alone keeps only about 2^-11: the residual is what the split adds
    assert (np.abs(a - hi) / np.abs(a)).max() > 2.0**-13


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_holds_the_serving_check_and_single_tf32_misses_it(seed):
    a, b, ref = _layer(seed)
    assert a.shape[1] == 10_000
    scale = np.abs(ref).max()
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    k = a.shape[1]
    split = mma_sum([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)], k)
    single = mma_sum([(a_hi, b_hi)], k)
    err_split = np.abs(split - ref).max() / scale
    err_single = np.abs(single - ref).max() / scale
    # the split: within 1e-5 of the scale, a tenth of the serving check
    assert err_split <= 1e-5, err_split
    # one TF32 product a term: the serving check would fail
    assert err_single > SERVE_TOL, err_single
    # the dropped lo*lo products (about 2^-22 relative each) sum to well
    # under a tenth of the split's own error
    dropped = np.abs(a_lo.astype(np.float64) @ b_lo).max() / scale
    assert dropped <= 1e-6, dropped


def test_one_long_tensor_core_sum_loses_the_split():
    """Rounding toward zero at every MMA biases a 10,000-term sum kept in
    the tensor cores (the kernel's first form read 7.8e-5 of the scale on
    an H100); per-dk partials added to nearest hold it near 1e-6."""
    a, b, ref = _layer(0)
    scale = np.abs(ref).max()
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    long_sum = np.abs(mma_sum(pairs, a.shape[1], None) - ref).max() / scale
    partials = np.abs(mma_sum(pairs, a.shape[1]) - ref).max() / scale
    assert long_sum > 1e-5, long_sum
    assert partials <= long_sum / 10, (partials, long_sum)


def _dw_contraction(seed, n=40_000, cin=16, cout=16):
    """One (di, dj, dk, dl) slice of a 16->16 dw as the float32 route sums
    it: x^T [cin, n] after a ReLU and a signed g [n, cout] over n positions
    (the 25^4 grid's 2-sample dw sums 781,250), the float64 answer, and the
    error of the plain float32 sum (a product, then one add, a position at
    a time), each relative to max |dw|."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((cin, n)), 0).astype(np.float32)
    g = rng.standard_normal((n, cout)).astype(np.float32)
    ref = x.astype(np.float64) @ g.astype(np.float64)
    scale = np.abs(ref).max()
    plain = np.cumsum(x.T[:, :, None] * g[:, None, :], axis=0, dtype=np.float32)[-1]
    x_hi, x_lo = tf32_split(x)
    g_hi, g_lo = tf32_split(g)
    pairs = [(x_lo, g_hi), (x_hi, g_lo), (x_hi, g_hi)]
    return pairs, ref, scale, np.abs(plain - ref).max() / scale


@pytest.mark.parametrize("seed", [0, 1])
def test_dw_drained_split_holds_dw_tol_and_the_gradient_rule(seed):
    """The float32 dw route: per k8 step lo*hi, hi*lo, hi*hi into a partial
    that rounds toward zero, drained into float32 every DW_PARTIAL_K8
    steps."""
    pairs, ref, scale, err32 = _dw_contraction(seed)
    got = mma_sum(pairs, pairs[0][0].shape[1], DW_PARTIAL_K8)
    err = np.abs(got - ref).max() / scale
    assert err <= DW_TOL, err
    assert err <= max(GRAD_RATIO * err32, GRAD_TOL), (err, err32)
    # the emulation's error is a small share of the check's: about 2e-6
    assert err <= DW_TOL / 20, err


@pytest.mark.parametrize("seed", [0, 1])
def test_dw_one_undrained_tensor_core_sum_misses_the_gradient_rule(seed):
    """Kept in the tensor cores the whole way, the same sum drifts toward
    zero by more than the gradient check allows."""
    pairs, ref, scale, err32 = _dw_contraction(seed)
    got = mma_sum(pairs, pairs[0][0].shape[1], None)
    err = np.abs(got - ref).max() / scale
    assert err > max(GRAD_RATIO * err32, GRAD_TOL), (err, err32)


def test_dw_kernel_drains_at_the_emulated_cadence():
    """The kernel's kDrainK8 is the wrapper's DW_PARTIAL_K8, the cadence the
    tests above emulate."""
    with open(DW_SOURCE) as f:
        src = f.read()
    found = re.findall(r"constexpr int kDrainK8 = (\d+);", src)
    assert found == [str(DW_PARTIAL_K8)], found
    # the k-step loop zeroes a partial for each k-step's three products and
    # adds it into the float32 sums: the cadence the constant names
    assert "static_assert(kDrainK8 == 1," in src


@pytest.mark.parametrize(
    "cin,cout,want",
    [
        (16, 16, "tf32x3"),  # the PF-Pascal 16->16 layer
        (2, 2, "tf32x3"),
        (3, 9, "tf32x3"),
        (32, 16, "tf32x3"),
        (1, 16, "ffma"),     # the 1->16 layer
        (16, 1, "ffma"),     # the 16->1 layer
        (2, 1, "ffma"),
        (1, 1, "ffma"),
    ],
)
def test_float32_route_rule(cin, cout, want):
    assert float32_route(cin, cout) == want
    assert route(torch.float32, cin, cout) == want
    assert route(torch.bfloat16, cin, cout) == "bf16_tc"
