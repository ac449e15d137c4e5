"""The hand-written Hopper kernels (conv4d forward, dx and dw, band GEMM)
against their plain versions, on a card.

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""

import pytest
import torch

from ncnet_tpu_torch.kernels.band_gemm import band_gemm_fwd
from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd, route
from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw
from ncnet_tpu_torch.ops.band import (
    BandGeometry,
    b_major_order,
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dw_kernel_matches_plain(card, case, dtype):
    shape, k, cin, cout = CASES[case]
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
    # both sum the same float32 products (bfloat16 inputs are exact in
    # float32) of up to b*i*j*k*l = 781,250 positions in other orders;
    # neither rounds its result to bfloat16
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
