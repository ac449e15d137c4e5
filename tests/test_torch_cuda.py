"""The hand-written Hopper kernels (conv4d forward, dx and dw; the band
layer's forward, dx and dw) against their plain versions, on a card.

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""

import pytest
import torch

from ncnet_tpu_torch.kernels.band_gemm import band_gemm_dx, band_gemm_fwd
from ncnet_tpu_torch.kernels.band_gemm_dw import band_gemm_dw
from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd, route
from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw
from ncnet_tpu_torch.ops.band import (
    BandGeometry,
    b_major_order,
    band_dw_plain,
    band_dx_hits_plain,
    band_dx_plain,
    band_hits_plain,
    band_layer,
    band_layer_plain,
    topk_band,
)
from ncnet_tpu_torch.ops.conv4d import (
    conv4d,
    conv4d_dw_plain,
    conv4d_dx_plain,
    conv4d_plain,
)

pytestmark = pytest.mark.cuda

CASES = [
    # (x shape [b,i,j,k,l], k, cin, cout)
    ((2, 4, 5, 4, 6), 3, 1, 3),
    ((1, 5, 5, 5, 5), 5, 3, 3),
    ((2, 4, 3, 5, 6), 3, 3, 1),       # rectangular grid
    ((1, 2, 3, 2, 4), 5, 1, 3),       # grid smaller than the kernel
    ((2, 25, 25, 25, 25), 5, 1, 16),  # the PF-Pascal NC layers
    ((2, 25, 25, 25, 25), 5, 16, 16),
    ((2, 25, 25, 25, 25), 5, 16, 1),
    ((2, 25, 25, 19, 25), 5, 16, 16),  # A 25x25 against B 19x25
    ((1, 7, 3, 40, 33), 3, 16, 9),    # two position tiles, cout not 1/8/16
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv4d kernel has no CPU mode")
    # the plain version is the reference: no TF32 in its convolutions
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _inputs(shape, k, cin, cout, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    bound = (cin * k**4) ** -0.5
    x = torch.rand(*shape, cin, generator=g, device=device)
    w = (torch.rand(k, k, k, k, cin, cout, generator=g, device=device) * 2 - 1) * bound
    b = (torch.rand(cout, generator=g, device=device) * 2 - 1) * bound
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(card, case, dtype):
    shape, k, cin, cout = CASES[case]
    dt = getattr(torch, dtype)
    x, w, b = _inputs(shape, k, cin, cout, case, card)
    x, w = x.to(dt), w.to(dt)
    before = conv4d_fwd.launches
    got = conv4d(x, w, b)
    torch.cuda.synchronize()
    assert conv4d_fwd.launches == before + 1
    assert got.dtype == dt and got.shape == (*shape, cout)
    # the launcher's own shape rule is the one the port states
    assert conv4d_fwd.built_route(dt, cin, cout) == route(dt, cin, cout)
    want = conv4d_plain(x.float(), w.float(), b)
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    # float32: two float32 sums of up to 10,000 products in different
    # orders, and cuDNN may answer the plain version's conv3d with a
    # Winograd or FFT algorithm (about 1e-5 relative on its own), so 1e-4
    # of the output's scale; bfloat16: the output's rounding (2^-8
    # relative) on top
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert err <= tol * scale, (err, scale)


def test_kernel_rejects_mixed_devices(card):
    x = torch.zeros(1, 3, 3, 3, 3, 1, device=card)
    with pytest.raises(ValueError, match="device and dtype"):
        conv4d_fwd(x, torch.zeros(3, 3, 3, 3, 1, 1))
    with pytest.raises(ValueError, match="device and dtype"):
        conv4d_fwd(x, torch.zeros(3, 3, 3, 3, 1, 1, device=card,
                                  dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        conv4d_fwd(torch.zeros(1, 3, 3, 3, 3, 2, device=card).transpose(1, 2),
                   torch.zeros(3, 3, 3, 3, 2, 1, device=card))


BAND_CASES = [
    # (b, hA, wA, hB, wB, K, k, cin, cout, swapped)
    (2, 25, 25, 25, 25, 16, 5, 1, 16, False),  # the PF-Pascal band layers
    (2, 25, 25, 25, 25, 16, 5, 16, 16, True),
    (2, 25, 25, 25, 25, 16, 5, 16, 1, False),
    (1, 25, 25, 19, 25, 16, 5, 16, 16, True),  # A 25x25 against B 19x25
    (1, 4, 3, 3, 5, 4, 3, 3, 9, False),        # tiny grid, N = 48, cout 9
    (1, 6, 7, 6, 7, 42, 3, 4, 4, False),       # complete band
    (1, 6, 7, 6, 7, 42, 3, 4, 4, True),
    (2, 12, 12, 12, 12, 144, 5, 16, 16, True),  # complete band at 192 px
    (1, 12, 12, 9, 12, 108, 5, 1, 16, False),   # and 192 against 144 px
    (1, 25, 25, 19, 25, 16, 5, 16, 1, True),
    (2, 25, 25, 25, 25, 16, 5, 1, 16, True),
]


def _band_inputs(case, device):
    b, ha, wa, hb, wb, K, k, cin, cout, swapped = BAND_CASES[case]
    g = torch.Generator(device=device).manual_seed(case)
    scores = torch.randn(b, ha, wa, hb, wb, generator=g, device=device)
    _, idx = topk_band(scores, K, mutual=True)
    geom = BandGeometry(idx, (hb, wb), *(b_major_order(idx) if swapped else ()))
    n = ha * wa * K
    bound = (cin * k**4) ** -0.5
    x = torch.rand(b, n, cin, generator=g, device=device)
    w = (torch.rand(k, k, k, k, cin, cout, generator=g, device=device) * 2 - 1) * bound
    bias = (torch.rand(cout, generator=g, device=device) * 2 - 1) * bound
    return x, w, bias, geom


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(BAND_CASES)))
def test_band_kernel_matches_plain(card, case, dtype):
    dt = getattr(torch, dtype)
    x, w, bias, geom = _band_inputs(case, card)
    x, w = x.to(dt), w.to(dt)
    before = band_gemm_fwd.launches
    got = band_layer(x, w, bias, geom)
    torch.cuda.synchronize()
    assert band_gemm_fwd.launches == before + 1
    assert got.dtype == dt and got.shape == (*x.shape[:2], w.shape[5])
    want = band_layer_plain(x, w, bias, geom)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    # float32: two float32 sums of up to k^4*cin products in different
    # orders (the plain matmul's blocking); bfloat16: both round the
    # product and the biased sum to bfloat16 (2^-8 relative) from float32
    # sums in different orders
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert err <= tol * scale, (err, scale)
    # each row's taps are summed in a fixed order, no atomics
    assert torch.equal(band_layer(x, w, bias, geom), got)


def test_band_kernel_rejects_bad_inputs(card):
    x = torch.zeros(1, 4, 1, device=card)
    w = torch.zeros(3, 3, 3, 3, 1, 1, device=card)
    bias = torch.zeros(1, device=card)
    idx = torch.tensor([[[[0], [1]], [[2], [3]]]], dtype=torch.int32, device=card)
    inv = b_major_order(idx)[1].to(torch.int32)
    with pytest.raises(TypeError, match="int32"):
        band_gemm_fwd(x, w, bias, idx.long(), (2, 2))
    with pytest.raises(ValueError, match="device"):
        band_gemm_fwd(x, w, bias, idx.cpu(), (2, 2))
    with pytest.raises(ValueError, match="dtype"):
        band_gemm_fwd(x, w.to(torch.bfloat16), bias, idx, (2, 2))
    with pytest.raises(ValueError, match="contiguous"):
        band_gemm_fwd(torch.zeros(1, 8, 1, device=card)[:, ::2], w, bias, idx,
                      (2, 2))
    with pytest.raises(ValueError, match="1 to 16"):
        band_gemm_fwd(x, torch.zeros(3, 3, 3, 3, 1, 17, device=card),
                      torch.zeros(17, device=card), idx, (2, 2))
    with pytest.raises(ValueError, match="inv must be"):
        band_gemm_fwd(x, w, bias, idx, (2, 2), inv[:, :3].contiguous())
    with pytest.raises(ValueError, match="do not match"):
        band_gemm_fwd(x[:, :3], w, bias, idx, (2, 2))
    # on a 1x10 B grid the four cells' B cells 0, 3, 6, 9 are 3 apart: no
    # neighbour of a 3^4 window is on the band but the entry itself, so
    # every row reads its own entry at the centre tap and nothing else
    far = torch.tensor([[[[0], [3]], [[6], [9]]]], dtype=torch.int32, device=card)
    for order in ((), (b_major_order(far)[1].to(torch.int32),)):
        out = band_gemm_fwd(x + 1, w + 1, bias + 0.5, far, (1, 10), *order)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.full_like(out, 1.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dx_kernel_matches_plain(card, case, dtype):
    shape, k, cin, cout = CASES[case]
    dt = getattr(torch, dtype)
    _, w, _ = _inputs(shape, k, cin, cout, case, card)
    g = torch.randn(*shape, cout, generator=torch.Generator(device=card)
                    .manual_seed(100 + case), device=card)
    g, w = g.to(dt), w.to(dt)
    before = conv4d_dx.launches, conv4d_fwd.launches
    got = conv4d_dx(g, w)
    torch.cuda.synchronize()
    assert (conv4d_dx.launches, conv4d_fwd.launches) == (before[0] + 1, before[1])
    assert got.dtype == dt and got.shape == (*shape, cin)
    # dx is the forward on flip(w)^T: a cout -> cin layer
    assert conv4d_fwd.built_route(dt, cout, cin) == route(dt, cout, cin)
    want = conv4d_dx_plain(g.float(), w.float())
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    # the forward kernel's sums (see test_kernel_matches_plain): float32
    # 1e-4 of the scale, bfloat16 the output's rounding on top
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert err <= tol * scale, (err, scale)


DW_CASES = CASES + [
    # (x shape [b,i,j,k,l], k, cin, cout): shapes the float32 route before
    # split-TF32 refused (C4: more than 384 (tap, channel tile) units) ...
    ((2, 6, 7, 9, 11), 5, 16, 64),
    ((2, 7, 6, 11, 9), 5, 64, 16),
    ((2, 6, 5, 9, 10), 7, 32, 16),
    ((1, 5, 6, 12, 13), 11, 16, 16),
    # ... the synthetic convergence run's layers ...
    ((16, 8, 8, 8, 8), 3, 1, 16),
    ((16, 8, 8, 8, 8), 3, 16, 1),
    # ... 1,009 rows (a prime): every chunk plan leaves a ragged last
    # chunk, in the channel mode and in the taps mode ...
    ((1, 1, 1009, 4, 5), 5, 16, 16),
    ((1, 1009, 1, 5, 4), 5, 1, 16),
    # ... a row too wide for two staged windows (one buffer) ...
    ((1, 2, 3, 3, 150), 5, 16, 16),
    # ... one input channel at an odd count of positions (the float32 x
    # copy's float2 rounded up to even, so the g copy after it is 16-byte
    # aligned for cp.async) ...
    ((1, 5, 5, 5, 5), 5, 1, 16),
    ((1, 25, 25, 25, 25), 5, 1, 16),
    ((3, 3, 5, 7, 3), 3, 1, 2),
    # ... and a batch cut into groups of samples (the float32 route splits
    # at most 1 GiB of x and g copies at a time; 100 MB a sample here):
    # 11 samples in groups of 6 and 5
    ((11, 25, 25, 25, 25), 5, 16, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(DW_CASES)))
def test_dw_kernel_matches_plain(card, case, dtype):
    shape, k, cin, cout = DW_CASES[case]
    dt = getattr(torch, dtype)
    x, _, _ = _inputs(shape, k, cin, cout, case, card)
    g = torch.randn(*shape, cout, generator=torch.Generator(device=card)
                    .manual_seed(200 + case), device=card)
    x, g = x.to(dt), g.to(dt)
    before = conv4d_dw.launches
    got = conv4d_dw(x, g, k)
    torch.cuda.synchronize()
    assert conv4d_dw.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (k,) * 4 + (cin, cout)
    want = conv4d_dw_plain(x, g, k)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # sums of up to b*i*j*k*l = 4,296,875 positions in other orders. In
    # bfloat16 both sum the same float32 products (the inputs are exact in
    # float32), and neither rounds its result to bfloat16. In float32 the
    # kernel's terms are split-TF32 products (lo*hi + hi*lo + hi*hi, the
    # lo*lo part, about 2^-22 relative, dropped), summed in the tensor
    # cores and drained into float32 every DW_PARTIAL_K8 k8 steps, so its
    # terms are not the plain version's float32 products
    assert bool(torch.isfinite(got).all())
    assert err <= 1e-4 * scale, (err, scale)
    # no atomics: a second launch is bitwise the first
    assert torch.equal(conv4d_dw(x, g, k), got)


DW_WIDE_CASES = [
    # (x shape [b,i,j,k,l], cin, cout, dtype): 768 px grids, and the 16->16
    # layer just past the grids a whole-grid staging fitted (40x40 bf16,
    # 41x41 f32); 5^4 kernels
    ((1, 48, 48, 48, 48), 1, 16, "float32"),
    ((1, 48, 48, 48, 48), 16, 16, "float32"),
    ((1, 48, 48, 48, 48), 16, 1, "float32"),
    ((1, 48, 48, 48, 48), 1, 16, "bfloat16"),
    ((1, 48, 48, 48, 48), 16, 16, "bfloat16"),
    ((1, 48, 48, 48, 48), 16, 1, "bfloat16"),
    ((1, 40, 40, 40, 40), 16, 16, "bfloat16"),
    ((1, 41, 41, 41, 41), 16, 16, "float32"),
]


@pytest.mark.parametrize("case", range(len(DW_WIDE_CASES)))
def test_dw_kernel_matches_plain_on_wide_grids(card, case):
    """dw stages a window of k-rows, so its shared memory does not grow
    with the grid: grids past a whole-grid footprint run and agree."""
    shape, cin, cout, dtype = DW_WIDE_CASES[case]
    x, _, _ = _inputs(shape, 5, cin, cout, 500 + case, card)
    g = torch.randn(*shape, cout, generator=torch.Generator(device=card)
                    .manual_seed(600 + case), device=card)
    x, g = x.to(getattr(torch, dtype)), g.to(getattr(torch, dtype))
    got = conv4d_dw(x, g, 5)
    again = conv4d_dw(x, g, 5)
    torch.cuda.synchronize()
    want = conv4d_dw_plain(x, g, 5)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # the same float32 products summed in other orders (as above)
    assert err <= 1e-4 * scale, (err, scale)
    assert torch.equal(got, again)


def test_dw_kernel_rejects_bad_inputs(card):
    x = torch.zeros(1, 3, 3, 3, 3, 2, device=card)
    with pytest.raises(ValueError, match="device and dtype"):
        conv4d_dw(x, torch.zeros(1, 3, 3, 3, 3, 1, device=card,
                                 dtype=torch.bfloat16), 3)
    with pytest.raises(ValueError, match="one grid"):
        conv4d_dw(x, torch.zeros(1, 3, 3, 3, 4, 1, device=card), 3)
    with pytest.raises(ValueError, match="odd"):
        conv4d_dw(x, torch.zeros(1, 3, 3, 3, 3, 1, device=card), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv4d_dw(x.half(), torch.zeros(1, 3, 3, 3, 3, 1, device=card).half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        conv4d_dw(x.transpose(1, 2), torch.zeros(1, 3, 3, 3, 3, 1, device=card), 3)


BF16_CASES = [
    # the bfloat16 route's edges: (x shape [b,i,j,k,l], k, cin, cout)
    ((2, 5, 4, 6, 7), 3, 1, 1),        # C = 1 and O = 1
    ((2, 6, 5, 7, 9), 5, 9, 1),        # O = 1, C not a multiple of 8
    ((2, 5, 6, 7, 5), 3, 1, 9),        # C = 1, O not a multiple of 8
    ((1, 5, 4, 30, 3), 5, 16, 1),      # O = 1 on a narrow row (L = 3)
    ((2, 25, 25, 25, 25), 3, 1, 16),   # the InLoc/IVD layers (ks = 3)
    ((2, 25, 25, 25, 25), 3, 16, 1),
    ((1, 6, 5, 41, 17), 5, 16, 16),    # K*L = 697: two position tiles
    ((1, 25, 25, 19, 25), 5, 16, 1),   # A 25x25 against B 19x25
    ((1, 3, 4, 3, 5), 5, 32, 16),      # two 16-channel groups
    ((2, 3, 4, 3, 3), 5, 16, 16),      # grid smaller than the kernel
]


@pytest.mark.parametrize("case", range(len(BF16_CASES)))
def test_bf16_route_edges_match_plain_and_repeat(card, case):
    shape, k, cin, cout = BF16_CASES[case]
    x, w, b = _inputs(shape, k, cin, cout, 300 + case, card)
    g = torch.randn(*shape, cout, generator=torch.Generator(device=card)
                    .manual_seed(400 + case), device=card)
    x, w, g = x.bfloat16(), w.bfloat16(), g.bfloat16()
    runs = [
        ("fwd", lambda: conv4d_fwd(x, w, b),
         lambda: conv4d_plain(x.float(), w.float(), b), 1e-2),
        ("dx", lambda: conv4d_dx(g, w),
         lambda: conv4d_dx_plain(g.float(), w.float()), 1e-2),
        # exact products, float32 sums in another order (as the float32 dw)
        ("dw", lambda: conv4d_dw(x, g, k), lambda: conv4d_dw_plain(x, g, k),
         1e-4),
    ]
    for name, kern, plain, tol in runs:
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        want = plain()
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
        assert err <= tol * scale, (name, err, scale)
        # one thread sums each output in a fixed order, no atomics
        assert torch.equal(got, again), name


F32_CASES = BF16_CASES + [
    # the float32 route's own edges: channels staged with plain loads
    # (C or O not a multiple of 4) or in part of a 16-channel group
    ((2, 25, 25, 19, 25), 5, 16, 16),  # A 25x25 against B 19x25
    ((2, 5, 6, 7, 5), 3, 6, 9),        # C and O not multiples of 4
    ((1, 4, 5, 6, 7), 5, 12, 12),      # C, O multiples of 4, not of 16
    ((1, 5, 4, 9, 11), 3, 20, 6),      # two groups, the second part-full
    ((1, 2, 3, 2, 2), 5, 2, 2),        # tiny grid, two channels
    # rows too wide for 5 m16 tiles a warp in shared memory: 2 (1024 px
    # images give L = 64) and 1
    ((1, 2, 2, 12, 64), 5, 16, 16),
    ((1, 1, 2, 4, 150), 5, 16, 16),
]


@pytest.mark.parametrize("case", range(len(F32_CASES)))
def test_f32_route_edges_match_plain_and_repeat(card, case):
    """The float32 route at its edges: forward and dx against the plain
    version (TOL 1e-4 of the scale, as test_kernel_matches_plain), and a
    second call bitwise equal to the first."""
    shape, k, cin, cout = F32_CASES[case]
    x, w, b = _inputs(shape, k, cin, cout, 700 + case, card)
    g = torch.randn(*shape, cout, generator=torch.Generator(device=card)
                    .manual_seed(800 + case), device=card)
    runs = [
        ("fwd", lambda: conv4d_fwd(x, w, b), lambda: conv4d_plain(x, w, b)),
        ("dx", lambda: conv4d_dx(g, w), lambda: conv4d_dx_plain(g, w)),
    ]
    for name, kern, plain in runs:
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        want = plain()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
        # one thread sums each output in a fixed order, no atomics
        assert torch.equal(got, again), name


# the float32 FFMA route (one input or one output channel) against the
# chain oracle, bit for bit: (x shape [b,i,j,k,l], k, cin, cout)
FFMA_CASES = [
    ((2, 25, 25, 25, 25), 5, 1, 16),   # the PF-Pascal layers (dx: 16->1's)
    ((2, 25, 25, 25, 25), 5, 16, 1),
    ((16, 8, 8, 8, 8), 3, 1, 16),      # the synthetic run's
    ((16, 8, 8, 8, 8), 3, 16, 1),
]
FFMA_CASES += [case for case in dict.fromkeys(BF16_CASES + F32_CASES + CASES)
               if 1 in case[2:] and case not in FFMA_CASES]


@pytest.mark.parametrize("case", range(len(FFMA_CASES)))
def test_ffma_route_bitwise_to_chain_oracle(card, case):
    """Each output of the two FFMA kernels is one fmaf chain in (di, dj,
    dk, dl, c) order from +0, the bias last: the naive chain oracle's
    bits exactly, forward and dx (a cout -> cin layer on flip(w)^T, also
    on the FFMA route), beside the plain version's 1e-4 of the scale."""
    from ncnet_tpu_torch.kernels.conv4d import flip_transpose

    shape, k, cin, cout = FFMA_CASES[case]
    x, w, b = _inputs(shape, k, cin, cout, 900 + case, card)
    g = torch.randn(*shape, cout, generator=torch.Generator(device=card)
                    .manual_seed(950 + case), device=card)
    runs = [
        ("fwd", (cin, cout), lambda: conv4d_fwd(x, w, b),
         lambda: conv4d_fwd.chain_oracle(x, w, b), lambda: conv4d_plain(x, w, b)),
        ("dx", (cout, cin), lambda: conv4d_dx(g, w),
         lambda: conv4d_fwd.chain_oracle(g, flip_transpose(w)),
         lambda: conv4d_dx_plain(g, w)),
    ]
    for name, (ci, co), kern, oracle, plain in runs:
        assert route(torch.float32, ci, co) == "ffma"
        got = kern()
        want = oracle()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, float((got - want).abs().max()))
        ref = plain()
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (name, err)


def test_ffma_plan_matches_the_python_mirror(card):
    """The launcher's FFMA plan (``conv4d_fwd_ffma_plan``) is
    ``kernels/conv4d.py::ffma_plan``, which the CPU tests walk."""
    from ncnet_tpu_torch.kernels.conv4d import ffma_plan

    shapes = {(shape, k, cin, cout) for shape, k, cin, cout in FFMA_CASES}
    shapes |= {((8, 25, 25, 25, 25), 5, 1, 16), ((8, 25, 25, 25, 25), 5, 16, 1),
               ((1, 2, 2, 48, 48), 5, 16, 1), ((1, 2, 2, 150, 150), 5, 16, 1),
               ((1, 2, 2, 40, 400), 5, 1, 16), ((1, 3, 4, 3, 5), 5, 33, 1),
               ((1, 3, 3, 9, 4), 7, 6, 1), ((1, 3, 3, 4, 9), 7, 1, 5)}
    def plan(fn, *args):
        try:
            return fn(*args)
        except ValueError:  # no tile fits: both refuse
            return "refused"

    for shape, k, cin, cout in sorted(shapes):
        for ci, co in {(cin, cout), (cout, cin)}:
            args = (shape, k, ci, co)
            assert plan(conv4d_fwd.ffma_plan, *args) == plan(ffma_plan, *args), args


def test_dw_bf16_bitwise_repeat_at_pf_pascal(card):
    """The 16->16 layer's dw at 2 samples: the plan's chunks and the
    second pass sum in a fixed order, so two calls agree bit for bit."""
    x, _, _ = _inputs((2, 25, 25, 25, 25), 5, 16, 16, 7, card)
    g = torch.randn(2, 25, 25, 25, 25, 16, generator=torch.Generator(
        device=card).manual_seed(8), device=card)
    x, g = x.bfloat16(), g.bfloat16()
    first = conv4d_dw(x, g, 5)
    assert all(torch.equal(conv4d_dw(x, g, 5), first) for _ in range(3))


def test_bf16_routes_hold_tensor_core_instructions(card):
    from ncnet_tpu_torch.kernels._build import tensor_core_summary

    for kernel in (conv4d_fwd, conv4d_dw):
        counts = kernel.tensor_core_counts()
        if counts is None:
            pytest.skip("cuobjdump is not installed: the SASS is not readable")
        summary = tensor_core_summary(counts)
        # forward: 4 instantiations (2 output widths x channels/taps, and
        # O = 1); dw: channels, taps (2 output widths each) and O = 1
        assert summary["bf16_route_functions"] >= 4, counts
        assert summary["bf16_route_min_mma"] > 0, counts
        # the forward's float32 split-TF32 functions hold HMMA too; the
        # CUDA-core (FFMA) functions hold none
        if kernel is conv4d_fwd:
            assert summary["tf32x3_route_functions"] >= 2, counts
            assert summary["tf32x3_route_min_mma"] > 0, counts
        assert summary["other_mma"] == 0, counts


def test_built_route_rule_matches_the_port(card):
    """The launcher's (dtype, C, O) rule and `route` agree on every shape
    class."""
    for dtype in (torch.float32, torch.bfloat16):
        for cin in (1, 2, 3, 16, 33):
            for cout in (1, 2, 9, 16):
                assert conv4d_fwd.built_route(dtype, cin, cout) == route(
                    dtype, cin, cout), (dtype, cin, cout)


def _nc_grads(corr, params, conv, dtype):
    """NC gradients of a scalar loss through ``conv`` on ``corr``."""
    from ncnet_tpu_torch.models.neigh_consensus import neigh_consensus_apply

    leaves = [t for p in params for t in (p["kernel"], p["bias"])]
    for t in leaves:
        t.grad = None
    out = neigh_consensus_apply(params, corr.to(dtype), conv=conv)
    loss = (out.float() * torch.linspace(-1, 1, out.numel(), device=out.device)
            .reshape(out.shape)).sum()
    loss.backward()
    return [t.grad.clone() for t in leaves]


def test_nc_gradients_through_kernels_match_plain(card):
    from ncnet_tpu_torch.models.neigh_consensus import init_neigh_consensus
    from ncnet_tpu_torch.ops.conv4d import Conv4dFunction

    params = [{k: v.to(card).requires_grad_(True) for k, v in p.items()}
              for p in init_neigh_consensus((3, 3, 3), (4, 4, 1))]
    corr = torch.rand(2, 6, 5, 6, 5, generator=torch.Generator(device=card)
                      .manual_seed(3), device=card)

    class Plain(Conv4dFunction):
        """The same Function with every pass on the plain versions."""

        @staticmethod
        def forward(ctx, x, w, bias):
            ctx.save_for_backward(x, w)
            ctx.bias_dtype = None if bias is None else bias.dtype
            return conv4d_plain(x, w, bias)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            g = g.contiguous()
            dx = conv4d_dx_plain(g, w) if ctx.needs_input_grad[0] else None
            dw = conv4d_dw_plain(x, g, w.shape[0]).to(w.dtype)
            db = g.sum(dim=(0, 1, 2, 3, 4), dtype=torch.float32).to(ctx.bias_dtype)
            return dx, dw, db

    before = conv4d_fwd.launches, conv4d_dx.launches, conv4d_dw.launches
    got = _nc_grads(corr, params, conv4d, torch.float32)
    torch.cuda.synchronize()
    after = conv4d_fwd.launches, conv4d_dx.launches, conv4d_dw.launches
    # one symmetric-batched pass: 3 forward launches, dx for layers 2 and 3
    # only (the correlation needs no gradient), dw for all three
    assert tuple(a - b for a, b in zip(after, before)) == (3, 2, 3)
    want = _nc_grads(corr, params, Plain.apply, torch.float32)
    for gk, gp in zip(got, want):
        scale = float(gp.abs().max())
        # float32 sums in other orders through three layers and back
        assert float((gk - gp).abs().max()) <= 1e-4 * scale


INLOC_CASES = [
    # the InLoc NC layers (3^4, bfloat16) at the pooled grid of a 3200 px
    # pair (a 4032x3024 query against a 1600x1200 pano, k_size 2) and its
    # transpose: 56.25 M cells, 0.9 G activations at 16 channels
    ((1, 100, 75, 75, 100), 3, 1, 16),
    ((1, 100, 75, 75, 100), 3, 16, 1),
    ((1, 75, 100, 100, 75), 3, 1, 16),
    ((1, 75, 100, 100, 75), 3, 16, 1),
]


@pytest.mark.parametrize("case", range(len(INLOC_CASES)))
def test_bf16_forward_at_inloc_pooled_grid(card, case):
    """The forward at the InLoc grid: against the plain version in float32
    on the same bfloat16 inputs (1e-2 of the scale, the bfloat16 output's
    rounding) and bitwise over two calls."""
    shape, k, cin, cout = INLOC_CASES[case]
    x, w, b = _inputs(shape, k, cin, cout, 900 + case, card)
    x, w = x.bfloat16(), w.bfloat16()
    got = conv4d_fwd(x, w, b)
    again = conv4d_fwd(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    del again
    want = conv4d_plain(x.float(), w.float(), b)
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    assert bool(torch.isfinite(got).all()) and err <= 1e-2 * scale, (err, scale)


@pytest.mark.parametrize("tgt_hw", [(128, 128), (96, 160)])
def test_relocalization_forward_through_kernels(card, tgt_hw):
    """match_pipeline with relocalization_k_size 2 (fused correlation +
    4D max-pool, NC in bfloat16 through the kernel) against the same
    forward through the plain conv4d: equal offsets (the pooling runs
    before NC) and the correlation within 3e-2 of its scale (two bfloat16
    layers at 1e-2, tripled by the post-NC mutual matching)."""
    from ncnet_tpu_torch.models.immatchnet import (
        ImMatchNet,
        ImMatchNetConfig,
        immatchnet_apply,
    )

    cfg = ImMatchNetConfig(feature_extraction_cnn="patch16",
                           ncons_kernel_sizes=(3, 3), ncons_channels=(16, 1),
                           half_precision=True, relocalization_k_size=2)
    model = ImMatchNet(cfg, device=card, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=card).manual_seed(5)
    src = torch.randn(1, 128, 192, 3, generator=g, device=card)
    tgt = torch.randn(1, *tgt_hw, 3, generator=g, device=card)
    before = conv4d_fwd.launches
    with torch.inference_mode():
        corr_k, delta_k = immatchnet_apply(model, cfg, src, tgt)
        assert conv4d_fwd.launches == before + 4  # 2 layers x 2 directions
        model.neigh_consensus.conv = conv4d_plain
        corr_p, delta_p = immatchnet_apply(model, cfg, src, tgt)
    assert corr_k.shape == (1, 4, 6, tgt_hw[0] // 32, tgt_hw[1] // 32)
    for a, b in zip(delta_k, delta_p):
        assert torch.equal(a, b)
    err = float((corr_k - corr_p).abs().max())
    assert err <= 3e-2 * float(corr_p.abs().max())


BAND_GRAD_CASES = [
    # (b, hA, wA, hB, wB, K, k, cin, cout, swapped): the band-training
    # layers at 25x25 (K = 50 is the slice's band: 1,250 candidates a cell,
    # past the kernels' 1,024-candidate tile), K = 1 and 16, the complete
    # band at 192 px, a rectangular B grid
    (2, 25, 25, 25, 25, 50, 5, 16, 16, False),
    (2, 25, 25, 25, 25, 50, 5, 16, 16, True),
    (2, 25, 25, 25, 25, 50, 5, 16, 1, True),
    (2, 25, 25, 25, 25, 50, 5, 1, 16, False),
    (2, 25, 25, 25, 25, 16, 5, 16, 16, True),
    (2, 25, 25, 25, 25, 1, 5, 16, 1, False),
    (2, 25, 25, 25, 25, 1, 5, 1, 16, True),
    (2, 12, 12, 12, 12, 144, 5, 16, 16, False),
    (2, 12, 12, 12, 12, 144, 5, 16, 16, True),
    (1, 25, 25, 19, 25, 50, 5, 16, 16, True),
    (1, 25, 25, 19, 25, 16, 5, 1, 16, False),
    (1, 4, 3, 3, 5, 4, 3, 3, 9, True),  # tiny grid, cout not 1/4/16
]


def _band_grad_inputs(case, dtype, device):
    b, ha, wa, hb, wb, K, k, cin, cout, swapped = BAND_GRAD_CASES[case]
    g = torch.Generator(device=device).manual_seed(300 + case)
    scores = torch.randn(b, ha, wa, hb, wb, generator=g, device=device)
    _, idx = topk_band(scores, K, mutual=True)
    geom = BandGeometry(idx, (hb, wb), *(b_major_order(idx) if swapped else ()))
    n = ha * wa * K
    bound = (cin * k**4) ** -0.5
    x = torch.rand(b, n, cin, generator=g, device=device)
    w = (torch.rand(k, k, k, k, cin, cout, generator=g, device=device) * 2 - 1) * bound
    # a ReLU-masked cotangent: about half its entries are zero
    gp = torch.randn(b, n, cout, generator=g, device=device)
    gp = gp * (torch.rand(b, n, cout, generator=g, device=device) > 0.5)
    return x.to(dtype), w.to(dtype), gp.to(dtype), geom


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(BAND_GRAD_CASES)))
def test_band_dx_kernel_matches_plain(card, case, dtype):
    dt = getattr(torch, dtype)
    x, w, gp, geom = _band_grad_inputs(case, dt, card)
    hits = geom.hits(tuple(w.shape[:4]))
    before = band_gemm_dx.launches, band_gemm_fwd.launches
    got = band_gemm_dx(gp, w, hits)
    torch.cuda.synchronize()
    assert (band_gemm_dx.launches, band_gemm_fwd.launches) == (before[0] + 1,
                                                               before[1])
    assert got.dtype == dt and got.shape == x.shape
    want = band_dx_plain(gp.float(), w.float(), geom)
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    # float32 sums of up to k^4*cout products in other orders; bfloat16
    # rounds the sum once (2^-8 relative) where the plain float32
    # reference does not
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert err <= tol * scale, (err, scale)
    # each row's taps are summed in a fixed order, no atomics
    assert torch.equal(band_gemm_dx(gp, w, hits), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(BAND_GRAD_CASES)))
def test_band_dw_kernel_matches_plain(card, case, dtype):
    dt = getattr(torch, dtype)
    x, w, gp, geom = _band_grad_inputs(case, dt, card)
    kernel = tuple(w.shape[:4])
    hits = geom.hits(kernel)
    # the hit list is the plain derivation's, element for element, its
    # offsets too
    want_hits = band_hits_plain(geom.indices, geom.grid_b, kernel, geom.inv)
    for name in ("tap_start", "n", "m", "block_start", "inv", "perm"):
        got_t, want_t = getattr(hits, name), getattr(want_hits, name)
        assert (got_t is None and want_t is None) or torch.equal(got_t, want_t), name
    assert hits.tap_start.dtype == hits.block_start.dtype == torch.int64
    before = band_gemm_dw.launches
    got = band_gemm_dw(x, gp, hits)
    torch.cuda.synchronize()
    assert band_gemm_dw.launches == before + 1
    assert got.dtype == dt and got.shape == w.shape
    want = band_dw_plain(x, gp, geom, kernel)
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    # float32 sums of up to a tap's hits (at most b*N) in other orders;
    # bfloat16 rounds each once (2^-8 relative) where the reference keeps
    # float32
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert err <= tol * scale, (err, scale)
    # the list and the sums have a fixed order, no atomics on floats
    again = band_gemm_dw.hit_list(geom.indices, geom.grid_b, kernel, geom.inv)
    assert all(torch.equal(getattr(again, f), getattr(hits, f))
               for f in ("tap_start", "n", "m", "block_start"))
    assert torch.equal(band_gemm_dw(x, gp, again), got)


def test_band_layer_on_card_gives_weight_gradients(card):
    """A band forward on the card with trainable weights is differentiable:
    its gradients run through the kernels and equal autograd's through
    the plain layer."""
    x, w, gp, geom = _band_grad_inputs(1, torch.float32, card)
    bias = torch.linspace(-0.05, 0.05, w.shape[5], device=card)
    x.requires_grad_(True)
    w.requires_grad_(True)
    bias.requires_grad_(True)
    before = (band_gemm_fwd.launches, band_gemm_dx.launches,
              band_gemm_dw.launches)
    out = band_layer(x, w, bias, geom)
    assert out.grad_fn is not None
    (out * gp).sum().backward()
    torch.cuda.synchronize()
    after = (band_gemm_fwd.launches, band_gemm_dx.launches,
             band_gemm_dw.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    got = [t.grad.clone() for t in (x, w, bias)]
    for t in (x, w, bias):
        t.grad = None
    (band_layer_plain(x, w, bias, geom) * gp).sum().backward()
    for gk, gr in zip(got, (x.grad, w.grad, bias.grad)):
        scale = float(gr.abs().max())
        assert scale > 0
        # float32 sums in other orders
        assert float((gk - gr).abs().max()) <= 1e-4 * scale


def test_band_nc_gradients_through_kernels_match_plain(card):
    """The band NC stack's parameter gradients (both passes, three layers)
    through the kernels against autograd through the plain layer; layer
    1's input gradient is never launched (the band values need none)."""
    from ncnet_tpu_torch.models.neigh_consensus import init_neigh_consensus
    from ncnet_tpu_torch.sparse import sparse_neigh_consensus_apply

    params = [{k: v.to(card).requires_grad_(True) for k, v in p.items()}
              for p in init_neigh_consensus((5, 5, 5), (16, 16, 1))]
    g = torch.Generator(device=card).manual_seed(7)
    scores = torch.rand(2, 12, 12, 12, 12, generator=g, device=card)
    values, idx = topk_band(scores, 50, mutual=True)

    def grads(layer):
        for p in params:
            p["kernel"].grad = p["bias"].grad = None
        out = sparse_neigh_consensus_apply(params, values, idx, (12, 12),
                                           layer=layer)
        (out * torch.linspace(-1, 1, out.numel(), device=card)
         .reshape(out.shape)).sum().backward()
        return [t.grad.clone() for p in params for t in (p["kernel"], p["bias"])]

    before = (band_gemm_fwd.launches, band_gemm_dx.launches,
              band_gemm_dw.launches)
    got = grads(band_layer)
    torch.cuda.synchronize()
    after = (band_gemm_fwd.launches, band_gemm_dx.launches,
             band_gemm_dw.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 4, 6)
    want = grads(band_layer_plain)
    for gk, gr in zip(got, want):
        scale = float(gr.abs().max())
        # float32 sums in other orders through three layers and back
        assert float((gk - gr).abs().max()) <= 1e-4 * scale, (gk, gr)


# the band training shape: the K = 50 mutual band, batch 16, 25x25 grids,
# 5^4, both passes; the layers whose dx the step runs (16 -> 16, 16 -> 1)
TRAIN_BAND_LAYERS = [(16, 16), (16, 1)]


@pytest.fixture(scope="module")
def train_band():
    """The K = 50 mutual band of 16 random 25x25 correlations, and one
    `BandGeometry` a sample of each pass (for the plain versions, whose
    pointer tables are about 1 GB a sample at this width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the band kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(11)
    scores = torch.randn(16, 25, 25, 25, 25, generator=g, device="cuda")
    _, idx = topk_band(scores, 50, mutual=True)
    passes = {}
    for swapped in (False, True):
        geom = BandGeometry(idx, (25, 25), *(b_major_order(idx) if swapped else ()))
        order = ((lambda i: (geom.perm[i:i + 1], geom.inv[i:i + 1]))
                 if swapped else (lambda i: ()))
        passes[swapped] = (geom, [BandGeometry(idx[i:i + 1], (25, 25), *order(i))
                                  for i in range(16)])
    return passes


@pytest.mark.parametrize("layer", range(len(TRAIN_BAND_LAYERS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swapped", [False, True])
def test_band_backward_kernels_at_training_shape(card, train_band, swapped,
                                                 dtype, layer):
    """dx and dw over one pass's hit list at band training's shape against
    the plain versions, sample by sample, with bitwise repeats and their
    launch counters; dx against the plain form of its own order of work."""
    dt = getattr(torch, dtype)
    cin, cout = TRAIN_BAND_LAYERS[layer]
    geom, subs = train_band[swapped]
    hits = geom.hits((5,) * 4)
    g = torch.Generator(device=card).manual_seed(40 + layer)
    n = geom.indices[0].numel()
    x = torch.rand(16, n, cin, generator=g, device=card).to(dt)
    w = ((torch.rand(5, 5, 5, 5, cin, cout, generator=g, device=card) * 2 - 1)
         * (cin * 625) ** -0.5).to(dt)
    gp = torch.randn(16, n, cout, generator=g, device=card)
    gp = (gp * (torch.rand(gp.shape, generator=g, device=card) > 0.5)).to(dt)
    before = band_gemm_dx.launches, band_gemm_dw.launches
    dx, dw = band_gemm_dx(gp, w, hits), band_gemm_dw(x, gp, hits)
    torch.cuda.synchronize()
    assert (band_gemm_dx.launches, band_gemm_dw.launches) == (before[0] + 1,
                                                              before[1] + 1)
    want_dx = torch.cat([band_dx_plain(gp[i:i + 1].float(), w.float(), sub)
                         for i, sub in enumerate(subs)])
    want_dw = sum(band_dw_plain(x[i:i + 1], gp[i:i + 1], sub, (5,) * 4)
                  for i, sub in enumerate(subs))
    # float32 sums in other orders; bfloat16 rounds each result once
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((dx, want_dx), (dw, want_dw)):
        scale = float(want.abs().max())
        assert float((got.float() - want).abs().max()) <= tol * scale
    if dtype == "float32" and layer == 0:  # the kernel's own order of work
        assert float((dx - band_dx_hits_plain(gp.cpu(), w.cpu(), _cpu(hits))
                      .to(card)).abs().max()) <= 1e-5 * float(want_dx.abs().max())
    assert torch.equal(band_gemm_dx(gp, w, hits), dx)
    assert torch.equal(band_gemm_dw(x, gp, hits), dw)


def _cpu(hits):
    return hits._replace(**{f: None if getattr(hits, f) is None
                            else getattr(hits, f).cpu()
                            for f in ("tap_start", "n", "m", "block_start",
                                      "inv", "perm")})


def _complete_band(b, grid=25):
    """The complete band of a grid x grid / grid x grid pair: every A cell
    holds every B cell, in order."""
    nb = grid * grid
    return (torch.arange(nb, dtype=torch.int32, device="cuda")
            .expand(b, grid, grid, nb).contiguous())


def test_band_hit_list_past_int32_on_the_complete_band(card):
    """The complete 400 px band (25x25 / 25x25, K = 625) at batch 11 with a
    5^4 kernel holds 11 x 14,161^2 hits (each 1-D axis gives 25 * 5 - 6 =
    119 valid (position, offset) pairs), past 2^31: the list's int64
    offsets count them exactly, and the 16 -> 16 bfloat16 dw over it
    matches the plain version sample by sample."""
    idx = _complete_band(11)
    hits = band_gemm_dw.hit_list(idx, (25, 25), (5,) * 4)
    want = 11 * 14161**2
    assert want == 2_205_873_131 > 2**31
    assert hits.count == want and int(hits.tap_start[-1]) == want
    assert int(hits.block_start[-1]) == want
    g = torch.Generator(device=card).manual_seed(5)
    n = idx[0].numel()
    x = torch.rand(11, n, 16, generator=g, device=card).to(torch.bfloat16)
    gp = torch.randn(11, n, 16, generator=g, device=card).to(torch.bfloat16)
    got = band_gemm_dw(x, gp, hits)
    del hits
    torch.cuda.empty_cache()
    plain = None
    for i in range(11):
        geom = BandGeometry(idx[i:i + 1], (25, 25))
        one = band_dw_plain(x[i:i + 1], gp[i:i + 1], geom, (5,) * 4)
        plain = one if plain is None else plain + one
        del geom
        torch.cuda.empty_cache()
    scale = float(plain.abs().max())
    # float32 sums of up to 11 x 390,625 products a tap in other orders;
    # bfloat16 rounds each sum once
    assert float((got.float() - plain).abs().max()) <= 1e-2 * scale


def test_band_training_step_on_the_complete_band_past_int32(card):
    """One bfloat16 training step of the PF-Pascal config (ResNet-101, 400
    px, NC 5-5-5 / 16-16-1) on the complete band (K = 625) at batch 9,
    whose hits may number 9 x 625^3 > 2^31 a pass: it runs, with a finite
    loss. Prints its peak memory."""
    import json

    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.train.step import (
        create_train_state,
        device_batch,
        make_train_step,
    )

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), symmetric_mode=True,
        half_precision=True, nc_topk=625)
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    ds = SyntheticPairDataset(n=9, output_size=(400, 400), seed=3)
    batch = device_batch(collate([ds[i] for i in range(9)]), "cuda")
    state = create_train_state(model, 5e-4)
    before = band_gemm_dx.launches, band_gemm_dw.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, loss = make_train_step(config)(state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert (band_gemm_dx.launches - before[0], band_gemm_dw.launches - before[1]) == (8, 12)
    print(json.dumps({"test": "complete_band_step", "batch": 9, "k": 625,
                      "loss": float(loss),
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "card": torch.cuda.get_device_name(0)}))


# -- trunk fine-tuning: the first NC layer's input gradient ----------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_layer_dx_at_finetune_shape(card, dtype):
    """The 1->16 layer's dx (a 16->1 contraction: bfloat16 on the O = 1
    tensor-core route, float32 on ``conv4d_fwd_ffma_o1``) at a fine-tuning
    step's pipeline call, 32 samples on 25^4 with 5^4 taps: against the
    plain version and bitwise on repeat."""
    dt = getattr(torch, dtype)
    shape = (32, 25, 25, 25, 25)
    _, w, _ = _inputs((1, 1, 1, 1, 1), 5, 1, 16, 400, card)
    g = torch.randn(*shape, 16, generator=torch.Generator(device=card)
                    .manual_seed(401), device=card).to(dt)
    w = w.to(dt)
    got = conv4d_dx(g, w)
    assert got.dtype == dt and got.shape == (*shape, 1)
    assert torch.equal(conv4d_dx(g, w), got)
    want = conv4d_dx_plain(g.float(), w.float())
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == "float32" else 1e-2  # test_dx_kernel_matches_plain's
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("swapped", [False, True])
def test_band_first_layer_dx_at_finetune_shape(card, swapped):
    """The first band layer's dx (16 cotangent channels into 1) on K = 50
    bands of 16 samples on 25x25 grids, bfloat16, both passes: against
    `band_dx_plain` and bitwise on repeat."""
    g = torch.Generator(device=card).manual_seed(402)
    scores = torch.randn(16, 25, 25, 25, 25, generator=g, device=card)
    _, idx = topk_band(scores, 50, mutual=True)
    del scores
    geom = BandGeometry(idx, (25, 25), *(b_major_order(idx) if swapped else ()))
    n = 25 * 25 * 50
    w = ((torch.rand(5, 5, 5, 5, 1, 16, generator=g, device=card) * 2 - 1)
         * 625 ** -0.5).to(torch.bfloat16)
    gp = torch.randn(16, n, 16, generator=g, device=card)
    gp = (gp * (torch.rand(16, n, 16, generator=g, device=card) > 0.5)).to(torch.bfloat16)
    hits = geom.hits((5, 5, 5, 5))
    got = band_gemm_dx(gp, w, hits)
    assert got.dtype == torch.bfloat16 and got.shape == (16, n, 1)
    assert torch.equal(band_gemm_dx(gp, w, hits), got)
    want = torch.cat([band_dx_plain(gp[i:i + 1].float(), w.float(), BandGeometry(
        idx[i:i + 1], (25, 25), *(b_major_order(idx[i:i + 1]) if swapped else ())))
        for i in range(16)])
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    assert err <= 1e-2 * scale, (err, scale)  # test_band_dx_kernel_matches_plain's


@pytest.mark.parametrize("nc_topk", [0, 8])
def test_trunk_training_step_launches_first_layer_dx(card, nc_topk):
    """A step that trains the trunk (patch16, ``train_fe``) makes the first
    NC layer's dx launches a frozen step does not: dense 2 more conv4d dx
    a step (one a pipeline call), band 4 more band dx (both passes)."""
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    cfg = ImMatchNetConfig(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
                           ncons_channels=(4, 1), nc_topk=nc_topk)
    rng = torch.Generator().manual_seed(5)
    batch = {k: torch.randn(2, 64, 64, 3, generator=rng)
             for k in ("source_image", "target_image")}
    counts = []
    for train_fe in (False, True):
        model = ImMatchNet(cfg, device=card, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, 1e-3, train_fe=train_fe)
        kern = band_gemm_dx if nc_topk else conv4d_dx
        before = kern.launches
        state, loss = make_train_step(cfg, train_fe=train_fe)(state, batch)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        counts.append(kern.launches - before)
    assert counts == ([4, 8] if nc_topk else [2, 4]), counts


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("tile", [128, 96])
def test_stream_band_on_card_matches_dense_band(card, mutual, tile):
    """The streamed band on the card at band training's shape (16 pairs of
    25x25 grids, c = 1024, K = 50): bitwise the band of the correlation
    built from the same slabs, and against ``correlation_4d``'s band
    values at rtol 1e-5 / atol 1e-6 with every index swap a near tie
    (`band_index_swaps`); a bitwise repeat."""
    from ncnet_tpu_torch.ops.corr_stream import (
        band_index_swaps,
        corr_stream_band,
        slab_correlation,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.norm import feature_l2norm

    g = torch.Generator(device=card).manual_seed(3)
    fa, fb = (feature_l2norm(torch.randn(16, 25, 25, 1024, generator=g, device=card))
              for _ in range(2))
    got_v, got_i = corr_stream_band(fa, fb, 50, mutual=mutual, tile=tile)
    again = corr_stream_band(fa, fb, 50, mutual=mutual, tile=tile)
    assert torch.equal(got_v, again[0]) and torch.equal(got_i, again[1])
    corr_s = slab_correlation(fa, fb, tile)
    want_v, want_i = topk_band(corr_s, 50, values_from=mutual_matching(corr_s),
                               mutual=mutual)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    corr = correlation_4d(fa, fb)
    dense_v, dense_i = topk_band(corr, 50, values_from=mutual_matching(corr),
                                 mutual=mutual)
    swaps = band_index_swaps(corr, corr_s, got_i, dense_i)
    assert swaps["near_ties"] == swaps["entries"], swaps
    same = (got_i == dense_i).all(-1, keepdim=True).expand_as(got_i)
    torch.testing.assert_close(got_v[same], dense_v[same], rtol=1e-5, atol=1e-6)


def test_refine_factor1_on_card_is_the_band(card):
    """Factor 1, radius 0 through the band kernels on the card: the refined
    band is the K band bit for bit (a one-entry window's softmax is 1.0)."""
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.refine import refine_match_pipeline
    from ncnet_tpu_torch.sparse.pipeline import sparse_match_pipeline

    cfg = ImMatchNetConfig(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
                           ncons_channels=(4, 1))
    nc = ImMatchNet(cfg, device=card,
                    generator=torch.Generator().manual_seed(0)).neigh_consensus
    g = torch.Generator(device=card).manual_seed(4)
    fa, fb = (torch.randn(2, 10, 10, 256, generator=g, device=card) for _ in range(2))
    before = band_gemm_fwd.launches
    for impl in ("dense", "stream"):
        c = cfg.replace(corr_impl=impl, corr_stream_tile=32)
        got = refine_match_pipeline(nc.params(), c.replace(refine_factor=1,
                                                           refine_topk=8),
                                    fa, fb, layer=nc.band_layer)
        want = sparse_match_pipeline(nc.params(), c.replace(nc_topk=8), fa, fb,
                                     layer=nc.band_layer)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert band_gemm_fwd.launches - before == 16  # 2 layers x 2 passes x 4 calls
