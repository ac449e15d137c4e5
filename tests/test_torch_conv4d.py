"""The port's 4D convolution: the plain PyTorch version against the JAX
package (its Pallas kernel in interpret mode and its XLA lowering), the
device dispatch and the kernel wrapper's input checks. The hand kernel
itself is held against the plain version in tests/test_torch_cuda.py,
which needs a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.ops.conv4d import conv4d as jax_conv4d
from ncnet_tpu_torch.kernels.conv4d import Conv4dForwardKernel, conv4d_fwd
from ncnet_tpu_torch.ops.conv4d import conv4d, conv4d_plain

# float32 sums of at most k^4*cin = 1875 products in another order than
# XLA's: the issue's starting tolerance holds
RTOL, ATOL = 1e-5, 1e-6

CASES = [
    # (x shape [b,i,j,k,l], k, cin, cout)
    ((2, 4, 5, 4, 6), 3, 1, 3),
    ((1, 5, 5, 5, 5), 5, 3, 3),
    ((2, 4, 3, 5, 6), 3, 3, 1),  # rectangular grid
    ((1, 2, 3, 2, 4), 5, 1, 3),  # grid smaller than the kernel
    ((2, 3, 3, 3, 3), 5, 3, 1),
]


def _inputs(shape, k, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = rng.randn(k, k, k, k, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_conv4d_matches_jax(case, impl, with_bias):
    shape, k, cin, cout = CASES[case]
    x, w, b = _inputs(shape, k, cin, cout, seed=case)
    bias = b if with_bias else None
    kw = {"interpret": True} if impl == "pallas" else {}
    want = jax_conv4d(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias), impl=impl, **kw,
    )
    got = conv4d_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias),
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_dispatch_takes_plain_path_on_cpu():
    x, w, b = _inputs((1, 3, 3, 3, 3), 3, 2, 2, seed=7)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    before = conv4d_fwd.launches
    out = conv4d(tx, tw, tb)
    assert conv4d_fwd.launches == before  # the kernel never ran
    assert torch.equal(out, conv4d_plain(tx, tw, tb))


def test_plain_conv4d_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        conv4d_plain(torch.zeros(1, 3, 3, 3, 3, 1), torch.zeros(2, 2, 2, 2, 1, 1))


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


def test_kernel_wrapper_rejects_cpu_tensor():
    x = torch.zeros(1, 3, 3, 3, 3, 1)
    w = torch.zeros(3, 3, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv4d_fwd(x, w)


@pytest.mark.parametrize(
    "x_shape,w_shape,dtype,match",
    [
        ((1, 3, 3, 3, 3, 1), (3, 3, 3, 3, 1, 1), torch.float16, "float32 or bfloat16"),
        ((1, 3, 3, 3, 3, 1), (2, 2, 2, 2, 1, 1), torch.float32, "odd hypercubic"),
        ((1, 3, 3, 3, 3, 1), (3, 3, 5, 3, 1, 1), torch.float32, "odd hypercubic"),
        ((1, 3, 3, 3, 3, 2), (3, 3, 3, 3, 1, 1), torch.float32, "cin"),
        ((1, 3, 3, 3, 3), (3, 3, 3, 3, 1, 1), torch.float32, r"\[b,i,j,k,l,cin\]"),
    ],
)
def test_kernel_wrapper_rejects_shapes_and_dtypes(x_shape, w_shape, dtype, match):
    x = _FakeCudaTensor(torch.zeros(x_shape), dtype)
    w = _FakeCudaTensor(torch.zeros(w_shape), dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        Conv4dForwardKernel.check(x, w, None)


def test_kernel_wrapper_rejects_non_contiguous():
    t = torch.zeros(1, 3, 3, 3, 3, 2).transpose(1, 2)
    x = _FakeCudaTensor(t)
    w = _FakeCudaTensor(torch.zeros(3, 3, 3, 3, 2, 1))
    with pytest.raises(ValueError, match="contiguous"):
        Conv4dForwardKernel.check(x, w, None)

