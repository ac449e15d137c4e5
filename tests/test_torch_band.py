"""The port's band ops against the JAX package: top-K selection (mutual and
plain, with planted ties), the neighbour pointer tables (bitwise), the
gathers, the band mutual matching, and the plain band NC layer against
the Pallas kernel in interpret mode; the layer's CPU dispatch and the
band kernel wrapper's input checks. Inputs are numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.kernels.band_gemm_pallas import band_conv_bias_relu_pallas
from ncnet_tpu.ops import band as jband
from ncnet_tpu.sparse.matching import band_mutual_matching as jax_band_mm
from ncnet_tpu_torch.kernels.band_gemm import BandGemmForwardKernel, band_gemm_fwd
from ncnet_tpu_torch.ops import band
from ncnet_tpu_torch.sparse.matching import band_mutual_matching

# float32, the issue's starting tolerance; integer tables are exact
RTOL, ATOL = 1e-5, 1e-6


def _scores(rng, shape, ties=False):
    """Correlation-like scores; with ``ties`` values are drawn from a few
    levels, so rows and columns hold many equal scores."""
    if ties:
        return rng.randint(0, 4, shape).astype(np.float32) / 4
    return rng.randn(*shape).astype(np.float32)


def _jax_band(scores, k, mutual):
    return jband.topk_band(jnp.asarray(scores), k, mutual=mutual)


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize(
    "shape,k,ties",
    [
        ((2, 3, 4, 3, 4), 5, False),
        ((2, 3, 4, 3, 4), 5, True),   # planted ties
        ((1, 4, 3, 2, 5), 7, True),   # rectangular grids
        ((1, 3, 3, 2, 2), 4, False),  # K = hB*wB: the complete band
    ],
)
def test_topk_band_matches_jax(shape, k, ties, mutual):
    rng = np.random.RandomState(0)
    scores = _scores(rng, shape, ties)
    gated = rng.rand(*shape).astype(np.float32)
    want_v, want_i = jband.topk_band(jnp.asarray(scores), k,
                                     values_from=jnp.asarray(gated),
                                     mutual=mutual)
    got_v, got_i = band.topk_band(torch.from_numpy(scores), k,
                                  values_from=torch.from_numpy(gated),
                                  mutual=mutual)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=RTOL, atol=ATOL)


def test_topk_band_guards():
    with pytest.raises(ValueError, match="46340"):
        band.topk_band(torch.zeros(1, 1, 1, 1, 46341), 1, mutual=True)
    with pytest.raises(ValueError, match="band width"):
        band.topk_band(torch.zeros(1, 2, 2, 2, 2), 5)


def _indices(rng, b, ha, wa, hb, wb, k, mutual=True):
    scores = _scores(rng, (b, ha, wa, hb, wb))
    _, idx = _jax_band(scores, k, mutual)
    return np.array(idx)  # a writable copy for torch.from_numpy


@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize(
    "geom,ksize",
    [
        ((2, 4, 4, 4, 4, 6), 3),   # partial band, square
        ((1, 3, 5, 4, 2, 5), 3),   # rectangular A and B grids
        ((1, 5, 4, 3, 5, 4), 5),   # kernel wider than a grid: edge cells
        ((1, 3, 3, 3, 3, 9), 5),   # complete band
    ],
)
def test_neighbor_pointers_equal_jax_bitwise(geom, ksize, swapped):
    b, ha, wa, hb, wb, k = geom
    idx = _indices(np.random.RandomState(1), b, ha, wa, hb, wb, k)
    kern = (ksize,) * 4
    want = jband.band_neighbor_pointers(jnp.asarray(idx), (hb, wb), kern,
                                        swapped=swapped)
    got = band.band_neighbor_pointers(torch.from_numpy(idx), (hb, wb), kern,
                                      swapped=swapped)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_to_dense_and_gathers_match_jax():
    rng = np.random.RandomState(2)
    b, ha, wa, hb, wb, k, c = 2, 3, 4, 4, 3, 5, 3
    idx = _indices(rng, b, ha, wa, hb, wb, k)
    vals = rng.randn(b, ha, wa, k).astype(np.float32)
    np.testing.assert_array_equal(
        band.band_to_dense(torch.from_numpy(vals), torch.from_numpy(idx),
                           (hb, wb)).numpy(),
        np.asarray(jband.band_to_dense(jnp.asarray(vals), jnp.asarray(idx),
                                       (hb, wb))),
    )
    n = ha * wa * k
    ptr = np.array(jband.band_neighbor_pointers(
        jnp.asarray(idx), (hb, wb), (3, 3, 3, 3))).reshape(b, n, -1)
    x = rng.randn(b, n, c).astype(np.float32)
    w = rng.randn(3, 3, 3, 3, c, 2).astype(np.float32)
    np.testing.assert_array_equal(
        band.band_gather_neighbors(torch.from_numpy(x), torch.from_numpy(ptr)).numpy(),
        np.asarray(jband.band_gather_neighbors(jnp.asarray(x), jnp.asarray(ptr))),
    )
    np.testing.assert_allclose(
        band.band_conv_gemm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(ptr)).numpy(),
        np.asarray(jband.band_conv_gemm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(ptr))),
        rtol=RTOL, atol=ATOL * 10,  # sums of 81*3 products of N(0,1) terms
    )


@pytest.mark.parametrize("grid", [(3, 4, 4, 3), (4, 4, 4, 4)])
def test_band_mutual_matching_matches_jax(grid):
    rng = np.random.RandomState(3)
    ha, wa, hb, wb = grid
    idx = _indices(rng, 2, ha, wa, hb, wb, 5)
    vals = np.maximum(rng.randn(2, ha, wa, 5), 0).astype(np.float32)
    want = jax_band_mm(jnp.asarray(vals), jnp.asarray(idx), (hb, wb))
    got = band_mutual_matching(torch.from_numpy(vals), torch.from_numpy(idx),
                               (hb, wb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _layer_inputs(rng, b, ha, wa, hb, wb, k, cin, cout, ksize=3):
    idx = _indices(rng, b, ha, wa, hb, wb, k, mutual=False)
    n = ha * wa * min(k, hb * wb)
    ptr = np.array(jband.band_neighbor_pointers(
        jnp.asarray(idx), (hb, wb), (ksize,) * 4)).reshape(b, n, -1)
    x = np.abs(rng.randn(b, n, cin)).astype(np.float32)
    w = (rng.randn(ksize, ksize, ksize, ksize, cin, cout)
         * (cin * ksize**4) ** -0.5).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, bias, ptr


LAYER_CASES = [
    # (b, hA, wA, hB, wB, K, cin, cout)
    (2, 4, 4, 4, 4, 6, 1, 4),     # partial band, the first layer's shape
    (2, 4, 4, 4, 4, 6, 4, 4),
    (1, 3, 5, 4, 2, 5, 4, 1),     # rectangular grids, the last layer's shape
    (1, 5, 6, 5, 6, 7, 3, 3),     # N = 210: not a multiple of 128 rows
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_plain_band_layer_matches_pallas_interpret(case, dtype):
    b, ha, wa, hb, wb, k, cin, cout = LAYER_CASES[case]
    x, w, bias, ptr = _layer_inputs(np.random.RandomState(case), b, ha, wa,
                                    hb, wb, k, cin, cout)
    jdt = getattr(jnp, dtype)
    want = band_conv_bias_relu_pallas(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(bias),
        jnp.asarray(ptr), interpret=True,
    )
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    tb, tp = torch.from_numpy(bias), torch.from_numpy(ptr)
    got = band.band_conv_bias_relu_plain(tx, tw, tb, tp)
    assert got.dtype == tdt and got.shape == (b, x.shape[1], cout)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        # both round the product and then the biased sum to bfloat16, but
        # the float32 sums feeding the first rounding differ in order:
        # one bfloat16 ulp (2^-8 relative) of the output's scale
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                                   atol=2**-8 * scale)
    # the plain layer is relu(band_conv_gemm + bias) by definition
    ref = torch.relu(band.band_conv_gemm(tx, tw, tp) + tb.to(tdt))
    assert torch.equal(got, ref)


def test_band_layer_dispatch_takes_plain_path_on_cpu():
    rng = np.random.RandomState(9)
    idx = _indices(rng, 1, 3, 3, 3, 3, 4, mutual=False)
    x = rng.randn(1, 36, 2).astype(np.float32)
    w = (rng.randn(3, 3, 3, 3, 2, 2) * 0.1).astype(np.float32)
    bias = rng.randn(2).astype(np.float32)
    tx, tw, tb, ti = map(torch.from_numpy, (x, w, bias, idx))
    geom = band.BandGeometry(ti, (3, 3))
    before = band_gemm_fwd.launches
    out = band.band_layer(tx, tw, tb, geom)
    assert band_gemm_fwd.launches == before  # the kernel never ran
    assert torch.equal(out, band.band_layer_plain(tx, tw, tb, geom))
    assert torch.equal(out, band.band_conv_bias_relu_plain(
        tx, tw, tb, band.plain_pointers(ti, (3, 3), (3, 3, 3, 3))))


class _FakeCudaTensor:
    """Stand-in that claims to be on a card, for the wrapper's checks."""

    def __init__(self, t, dtype=None):
        self._t = t
        self.is_cuda = True
        self.device = torch.device("cuda", 0)
        self.dtype = dtype or t.dtype
        self.shape = t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()


def test_band_kernel_wrapper_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        band_gemm_fwd(torch.zeros(1, 4, 1), torch.zeros(3, 3, 3, 3, 1, 1),
                      torch.zeros(1), torch.zeros(1, 2, 2, 1, dtype=torch.int32),
                      (2, 2))


_I32, _I64 = torch.int32, torch.int64


@pytest.mark.parametrize(
    "x_shape,w_shape,i_shape,dtype,i_dtype,b_shape,inv,match",
    [
        # (x, w, indices, activation dtype, index dtype, bias, inv as
        # (shape, dtype) or None, what the error names)
        ((1, 4, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float16, _I32,
         (1,), None, "float32 or bfloat16"),
        ((1, 4, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float32, _I64,
         (1,), None, "int32 indices"),
        ((1, 4, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 2), torch.float32, _I32,
         (1,), None, "do not match x"),
        ((1, 4, 2), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float32, _I32,
         (1,), None, "cin"),
        ((1, 4, 1), (3, 3, 3, 3, 1, 17), (1, 2, 2, 1), torch.float32, _I32,
         (17,), None, "1 to 16 output channels"),
        ((1, 4), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float32, _I32,
         (1,), None, r"x \[b,N,cin\]"),
        ((1, 4, 1), (3, 3, 3, 3, 1, 2), (1, 2, 2, 1), torch.float32, _I32,
         (1,), None, "bias must be"),
        # a band wider than the 2x2 B grid
        ((1, 20, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 5), torch.float32, _I32,
         (1,), None, "band width"),
        # indices of another batch than x's
        ((2, 4, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float32, _I32,
         (1,), None, "do not match x"),
        ((1, 4, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float32, _I32,
         (1,), ((1, 4), _I64), "int32 inv"),
        ((1, 4, 1), (3, 3, 3, 3, 1, 1), (1, 2, 2, 1), torch.float32, _I32,
         (1,), ((1, 5), _I32), "inv must be"),
    ],
)
def test_band_kernel_wrapper_rejects_shapes_and_dtypes(
        x_shape, w_shape, i_shape, dtype, i_dtype, b_shape, inv, match):
    x = _FakeCudaTensor(torch.zeros(x_shape), dtype)
    w = _FakeCudaTensor(torch.zeros(w_shape), dtype)
    idx = _FakeCudaTensor(torch.zeros(i_shape, dtype=i_dtype))
    bias = _FakeCudaTensor(torch.zeros(b_shape))
    if inv is not None:
        inv = _FakeCudaTensor(torch.zeros(inv[0], dtype=inv[1]))
    with pytest.raises((ValueError, TypeError), match=match):
        BandGemmForwardKernel.check(x, w, bias, idx, (2, 2), inv)


@pytest.mark.parametrize("which", ["x", "indices", "inv"])
def test_band_kernel_wrapper_rejects_non_contiguous(which):
    t = {
        "x": torch.zeros(1, 2, 4).transpose(1, 2),
        "indices": torch.zeros(1, 2, 2, 2, dtype=torch.int32)[..., ::2],
        "inv": torch.zeros(1, 8, dtype=torch.int32)[:, ::2],
    }
    x = _FakeCudaTensor(t["x"] if which == "x" else torch.zeros(1, 4, 2))
    w = _FakeCudaTensor(torch.zeros(3, 3, 3, 3, 2, 1))
    idx = _FakeCudaTensor(t["indices"] if which == "indices"
                          else torch.zeros(1, 2, 2, 1, dtype=torch.int32))
    inv = _FakeCudaTensor(t["inv"] if which == "inv"
                          else torch.zeros(1, 4, dtype=torch.int32))
    bias = _FakeCudaTensor(torch.zeros(1))
    with pytest.raises(ValueError, match="contiguous"):
        BandGemmForwardKernel.check(x, w, bias, idx, (2, 2), inv)
