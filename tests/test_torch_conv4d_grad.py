"""The port's differentiable 4D convolution against ``jax.vjp`` of the JAX
package's ``conv4d`` (its Pallas kernel in interpret mode, whose custom VJP
computes dx with the same kernel on flipped filters and dw with
``_dw_scan``, and its XLA lowering): the plain dx and dw, and the
gradients of the autograd Function. The dx and dw kernels are held
against the plain versions in tests/test_torch_cuda.py, on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.ops.conv4d import conv4d as jax_conv4d
from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd
from ncnet_tpu_torch.kernels.conv4d_dw import Conv4dWeightGradKernel, conv4d_dw
from ncnet_tpu_torch.ops import conv4d as ops_conv4d
from ncnet_tpu_torch.ops.conv4d import (
    conv4d,
    conv4d_dw_plain,
    conv4d_dx_plain,
    conv4d_plain,
)

# float32 sums of at most b*i*j*k*l = 960 products (dw) or k^4*c = 40,000
# (dx: the 16->64 case) in another order than XLA's: the starting
# tolerance holds, the absolute part relative to the gradient's scale
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs, restored after: the suite
    runs several test processes on the CPU at once, and torch's default of
    one OpenMP thread per core then oversubscribes it, so small convolutions
    wait on each other's spinning threads (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [
    # (x shape [b,i,j,k,l], k, cin, cout)
    ((2, 4, 5, 4, 6), 3, 1, 4),
    ((1, 5, 5, 5, 5), 5, 4, 4),
    ((2, 4, 3, 5, 6), 3, 4, 1),  # rectangular grid
    ((1, 3, 4, 3, 4), 5, 4, 1),  # grid smaller than the kernel
    ((2, 3, 3, 4, 3), 5, 1, 4),
    # C4: shapes the float32 dw kernel once refused (more than 384 (tap,
    # channel tile) units); the reference computes them
    ((1, 3, 4, 3, 4), 5, 16, 64),
    ((1, 3, 3, 4, 3), 7, 32, 16),
]


def _inputs(case):
    shape, k, cin, cout = CASES[case]
    rng = np.random.RandomState(10 + case)
    x = rng.rand(*shape, cin).astype(np.float32)
    w = rng.randn(k, k, k, k, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    g = rng.randn(*shape, cout).astype(np.float32)
    return x, w, b, g


def _jax_vjp(x, w, b, g, impl):
    kw = {"interpret": True} if impl == "pallas" else {}

    def f(x, w, b):
        return jax_conv4d(x, w, b, impl=impl, **kw)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def vjps():
    """JAX's (dx, dw, db) per (case, impl), computed once."""
    return {}


def _want(vjps, case, impl):
    if (case, impl) not in vjps:
        vjps[case, impl] = _jax_vjp(*_inputs(case), impl)
    return vjps[case, impl]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dx_plain_matches_jax_vjp(vjps, case, impl):
    x, w, _, g = _inputs(case)
    dx = conv4d_dx_plain(torch.from_numpy(g), torch.from_numpy(w))
    assert dx.shape == x.shape
    _close(dx.numpy(), _want(vjps, case, impl)[0])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dw_plain_matches_jax_vjp(vjps, case, impl):
    x, w, _, g = _inputs(case)
    dw = conv4d_dw_plain(torch.from_numpy(x), torch.from_numpy(g), w.shape[0])
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    _close(dw.numpy(), _want(vjps, case, impl)[1])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_autograd_gradients_match_jax_vjp(vjps, case, impl):
    x, w, b, g = _inputs(case)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    launches = conv4d_fwd.launches, conv4d_dx.launches, conv4d_dw.launches
    out = conv4d(tx, tw, tb)
    out.backward(torch.from_numpy(g))
    # CPU tensors never reach a kernel
    assert (conv4d_fwd.launches, conv4d_dx.launches, conv4d_dw.launches) == launches
    want = _want(vjps, case, impl)
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        assert got.dtype == torch.float32
        _close(got.numpy(), ref)


def test_dx_skipped_when_input_needs_no_gradient(monkeypatch):
    x, w, b, g = _inputs(1)
    calls = []
    monkeypatch.setattr(ops_conv4d, "conv4d_dx_plain",
                        lambda *a: calls.append(a) or conv4d_dx_plain(*a))
    tw = torch.from_numpy(w).requires_grad_(True)
    out = conv4d(torch.from_numpy(x), tw, torch.from_numpy(b))
    out.backward(torch.from_numpy(g))
    assert calls == [] and tw.grad is not None
    tx = torch.from_numpy(x).requires_grad_(True)
    conv4d(tx, torch.from_numpy(w), None).backward(torch.from_numpy(g))
    assert len(calls) == 1
    np.testing.assert_array_equal(
        tx.grad.numpy(),
        conv4d_dx_plain(torch.from_numpy(g), torch.from_numpy(w)).numpy())


def test_bfloat16_gradients_round_once():
    """bf16: dw and db are float32 sums rounded once to bf16, dx is the
    flipped-filter convolution in bf16, each in its input's dtype."""
    x, w, b, g = _inputs(2)
    bf = torch.bfloat16
    tx, tw, tb = (torch.from_numpy(a).to(bf).requires_grad_(True)
                  for a in (x, w, b))
    tg = torch.from_numpy(g).to(bf)
    out = conv4d(tx, tw, tb)
    assert out.dtype == bf
    out.backward(tg)
    assert tx.grad.dtype == tw.grad.dtype == tb.grad.dtype == bf
    dw = conv4d_dw_plain(tx.detach(), tg, w.shape[0])
    assert torch.equal(tw.grad, dw.to(bf))
    assert torch.equal(tb.grad, tg.float().sum(dim=(0, 1, 2, 3, 4)).to(bf))
    assert torch.equal(tx.grad, conv4d_dx_plain(tg, tw.detach()))


def test_gradcheck_float64():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(1, 3, 4, 3, 4, 2)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(3, 3, 3, 3, 2, 3)).requires_grad_(True)
    b = torch.from_numpy(rng.randn(3)).requires_grad_(True)
    # dw is a float32 sum (as JAX's preferred_element_type): gradcheck's
    # float64 finite differences hold it to about 1e-6
    assert torch.autograd.gradcheck(conv4d, (x, w, b), atol=1e-5, rtol=1e-4)


def test_inference_mode_builds_no_graph():
    x, w, b, _ = _inputs(0)
    tw = torch.from_numpy(w).requires_grad_(True)
    with torch.inference_mode():
        out = conv4d(torch.from_numpy(x), tw, torch.from_numpy(b))
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, conv4d_plain(torch.from_numpy(x), tw.detach(),
                                         torch.from_numpy(b)))


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


def test_dw_wrapper_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv4d_dw(torch.zeros(1, 3, 3, 3, 3, 1), torch.zeros(1, 3, 3, 3, 3, 1), 3)


def test_dx_wrapper_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv4d_dx(torch.zeros(1, 3, 3, 3, 3, 1), torch.zeros(3, 3, 3, 3, 2, 1))


@pytest.mark.parametrize(
    "x_shape,g_shape,ks,dtype,match",
    [
        ((1, 3, 3, 3, 3, 1), (1, 3, 3, 3, 3, 2), 3, torch.float16, "float32 or bfloat16"),
        ((1, 3, 3, 3, 3, 1), (1, 3, 3, 3, 3, 2), 4, torch.float32, "odd"),
        ((1, 3, 3, 3, 3, 1), (1, 3, 3, 3, 4, 2), 3, torch.float32, "one grid"),
        ((1, 3, 3, 3, 3), (1, 3, 3, 3, 3, 2), 3, torch.float32, "one grid"),
    ],
)
def test_dw_wrapper_rejects_shapes_and_dtypes(x_shape, g_shape, ks, dtype, match):
    x = _FakeCudaTensor(torch.zeros(x_shape), dtype)
    g = _FakeCudaTensor(torch.zeros(g_shape), dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        Conv4dWeightGradKernel.check(x, g, ks)
