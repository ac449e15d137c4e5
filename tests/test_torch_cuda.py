"""The hand-written Hopper kernels against their plain versions, on a card.

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""

import pytest
import torch

from ncnet_tpu_torch.kernels.conv4d import conv4d_fwd
from ncnet_tpu_torch.ops.conv4d import conv4d, conv4d_plain

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
