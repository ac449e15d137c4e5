"""The port's 4D convolution: the plain PyTorch version against the JAX
package (its Pallas kernel in interpret mode and its XLA lowering), the
device dispatch and the kernel wrapper's input checks. The hand kernel
itself is held against the plain version in tests/test_torch_cuda.py,
which needs a card."""

import os

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



SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118conv4d_fwd_bf16_tcILi2ELi0EEEvPK13__nv_bfloat16
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0a30*/                   HMMA.16816.F32.BF16 R24, R40, R36, R24 ;
        /*0a40*/                   HMMA.16816.F32.BF16 R28, R40, R38, R28 ;
\t\tFunction : _ZN12_GLOBAL__N_118conv4d_fwd_bf16_tcILi1ELi2EEEvPK13__nv_bfloat16
        /*0b00*/                   HGMMA.64x16x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0b10*/                   LDSM.16.MT88.4 R4, [R2] ;
\t\tFunction : _ZN12_GLOBAL__N_117conv4d_fwd_kernelIfLi16EEEvPKT_
        /*0a30*/                   FFMA R1, R2, R3, R1 ;
"""


def test_sass_tensor_core_counts_per_function():
    from ncnet_tpu_torch.kernels._build import sass_tensor_core_counts

    counts = sass_tensor_core_counts(SASS)
    assert list(counts.values()) == [2, 1, 0]
    assert all(fn.startswith("_ZN12_GLOBAL__N_1") for fn in counts)


_NO_TF32 = {"tf32x3_route_functions": 0, "tf32x3_route_mma": 0,
            "tf32x3_route_min_mma": 0}


@pytest.mark.parametrize(
    "counts,want",
    [
        ({"a_bf16_tc_1": 2, "b_bf16_tc_2": 5, "f32": 0},
         {"bf16_route_functions": 2, "bf16_route_mma": 7,
          "bf16_route_min_mma": 2, **_NO_TF32, "other_mma": 0}),
        # one bfloat16 function without a tensor-core instruction shows
        ({"a_bf16_tc_1": 0, "b_bf16_tc_2": 5, "f32": 3},
         {"bf16_route_functions": 2, "bf16_route_mma": 5,
          "bf16_route_min_mma": 0, **_NO_TF32, "other_mma": 3}),
        ({"f32": 0},
         {"bf16_route_functions": 0, "bf16_route_mma": 0,
          "bf16_route_min_mma": 0, **_NO_TF32, "other_mma": 0}),
        # the split-TF32 functions are counted apart from the FFMA ones
        ({"a_bf16_tc_1": 4, "c_tf32x3_tc_1": 6, "d_tf32x3_tc_2": 12,
          "ffma": 0},
         {"bf16_route_functions": 1, "bf16_route_mma": 4,
          "bf16_route_min_mma": 4, "tf32x3_route_functions": 2,
          "tf32x3_route_mma": 18, "tf32x3_route_min_mma": 6,
          "other_mma": 0}),
        ({"c_tf32x3_tc_1": 0, "ffma": 2},
         {"bf16_route_functions": 0, "bf16_route_mma": 0,
          "bf16_route_min_mma": 0, "tf32x3_route_functions": 1,
          "tf32x3_route_mma": 0, "tf32x3_route_min_mma": 0,
          "other_mma": 2}),
    ],
)
def test_tensor_core_summary(counts, want):
    from ncnet_tpu_torch.kernels._build import tensor_core_summary

    assert tensor_core_summary(counts) == want


def test_build_key_covers_shared_headers(tmp_path):
    """A change to a csrc header rebuilds every library that includes it."""
    from ncnet_tpu_torch.kernels._build import CSRC, source_digest

    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = source_digest(str(src), str(tmp_path))
    assert source_digest(str(src), str(tmp_path)) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert source_digest(str(src), str(tmp_path)) != first
    # the package's sources include its header, which the key reads
    assert "mma_bf16.cuh" in sorted(os.listdir(CSRC))


def test_tensor_core_counts_none_without_cuobjdump(monkeypatch):
    from ncnet_tpu_torch.kernels import _build

    lib = _build.KernelLibrary("k.cu", "k", "k", [])
    monkeypatch.setattr(lib, "load", lambda: "")
    monkeypatch.setattr(_build, "find_cuobjdump", lambda: None)
    assert lib.tensor_core_counts() is None
