"""Wrapper of the hand-written Hopper 4D-convolution forward.

Replaces the TPU kernel ``ncnet_tpu/kernels/conv4d_pallas.py::_fwd_kernel``
(public ``conv4d_packed_pallas``) with ``csrc/conv4d_fwd.cu``, a CUDA C++
kernel for ``sm_90a`` built by ``nvcc`` from the repository's source on
first use and bound through ``ctypes`` (no PyTorch headers, so the build
takes seconds).

What bounds it on the card: operations. The three NC layers of the 400 px
PF-Pascal config do about 281 GFLOP per served pair against well under
0.1 GB moved, thousands of FLOP per byte. One block per ``(b, i, j)``
output row stages the zero-padded halo of each contributing input row and
the matching weight slice in shared memory and folds the remaining taps
into one contraction (see the source's header). Each dtype has its route:

* bfloat16 (training: the forward and dx) runs on the tensor cores,
  ``mma.sync`` m16n8k16 bf16 x bf16 -> float32, with the halo and weights
  staged in bfloat16 by ``cp.async`` and double-buffered across rows;
* float32 (serving, the gradient check) takes the route `float32_route`
  names, by ``(cin, cout)`` alone: split-TF32 ("3xTF32") on the tensor
  cores, ``mma.sync`` m16n8k8 .tf32 with each operand split into a TF32
  high part and a TF32 residual and three products a term, which keeps
  about 2e-6 of the scale on a 10,000-term NC sum (one TF32 product keeps
  about 4e-4, short of the 1e-4 the serving check holds the card to); or
  register-blocked FFMA on the CUDA cores, for the layers the rule keeps
  there (one input or one output channel; the source's ``f32_route`` says
  why).

The kernel functions of the tensor-core routes carry ``bf16_tc`` or
``tf32x3`` in their names; ``tensor_core_counts`` counts their ``HMMA``
instructions in the built library.

The input gradient of the convolution is the same kernel on spatially
flipped, channel-transposed filters, ``dx = conv4d(g, flip(w)^T)`` (the
JAX package's ``_vjp_bwd``): `conv4d_dx` is a second wrapper over the same
built library, with its own launch count.

The wrappers take CUDA tensors only: `ncnet_tpu_torch.ops.conv4d` routes
CPU tensors to the plain PyTorch versions, and nothing here falls back to
them.
"""

import ctypes
import os

import torch

from ncnet_tpu_torch.kernels import _build

SOURCE = os.path.join(_build.CSRC, "conv4d_fwd.cu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the launcher's route codes (``conv4d_fwd_route``)
ROUTES = ("ffma", "tf32x3", "bf16_tc")


def float32_route(cin, cout):
    """The float32 route of a ``cin -> cout`` layer: ``"tf32x3"``
    (split-TF32 on the tensor cores) or ``"ffma"`` (the CUDA cores).

    Mirrors ``f32_route`` in ``csrc/conv4d_fwd.cu``, which alone decides:
    a shape rule, never a retry after a failed build or launch.
    """
    return "tf32x3" if cin >= 2 and cout >= 2 else "ffma"


def route(dtype, cin, cout):
    """The route the kernel takes for a ``cin -> cout`` layer in ``dtype``
    (float32 or bfloat16)."""
    return "bf16_tc" if dtype == torch.bfloat16 else float32_route(cin, cout)


class Conv4dForwardKernel:
    """Callable wrapper: ``kernel(x, w, bias) -> out``.

    ``x``: CUDA ``[b, i, j, k, l, cin]`` float32 or bfloat16, contiguous.
    ``w``: ``[ks, ks, ks, ks, cin, cout]`` of x's dtype and device, odd ks.
    ``bias``: ``[cout]`` (any float dtype, used in float32) or None.
    Returns ``[b, i, j, k, l, cout]`` in x's dtype.

    ``launches`` counts the kernel launches this wrapper made, and nothing
    else adds to it.
    """

    def __init__(self):
        self.launches = 0
        self._lib = _build.KernelLibrary(
            SOURCE, "conv4d", "conv4d_fwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        )

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        return self._lib.load()

    def built_route(self, dtype, cin, cout):
        """The route the built library's launcher takes for a ``cin ->
        cout`` layer in ``dtype`` (its own rule, ``conv4d_fwd_route``)."""
        self.load()
        fn = ctypes.CDLL(self._lib.path).conv4d_fwd_route
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return ROUTES[fn(_DTYPE_CODES[dtype], cin, cout)]

    def tensor_core_counts(self):
        """``{kernel function: HMMA/HGMMA count}`` of the built library, or
        None without ``cuobjdump``."""
        return self._lib.tensor_core_counts()

    @staticmethod
    def check(x, w, bias):
        """Raise ValueError/TypeError on inputs the kernel does not take."""
        if not x.is_cuda:
            raise ValueError(
                "conv4d kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.conv4d.conv4d (the plain version)"
            )
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"conv4d kernel takes float32 or bfloat16, got {x.dtype}"
            )
        if x.dim() != 6 or w.dim() != 6:
            raise ValueError(
                f"conv4d kernel takes x [b,i,j,k,l,cin] and w "
                f"[k,k,k,k,cin,cout]; got {tuple(x.shape)} and "
                f"{tuple(w.shape)}"
            )
        ks = w.shape[0]
        if len(set(w.shape[:4])) != 1 or ks % 2 == 0:
            raise ValueError(
                f"conv4d kernel takes an odd hypercubic kernel, got "
                f"{tuple(w.shape[:4])}"
            )
        if w.shape[4] != x.shape[5]:
            raise ValueError(
                f"weight cin {w.shape[4]} != activation channels {x.shape[5]}"
            )
        if w.device != x.device or w.dtype != x.dtype:
            raise ValueError(
                f"weight must share x's device and dtype ({x.device}, "
                f"{x.dtype}); got ({w.device}, {w.dtype})"
            )
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("conv4d kernel takes contiguous x and w")
        if bias is not None and (
            bias.shape != (w.shape[5],) or bias.device != x.device
        ):
            raise ValueError(
                f"bias must be [{w.shape[5]}] on {x.device}, got "
                f"{tuple(bias.shape)} on {bias.device}"
            )
        if max(x.shape) >= 2**31:
            raise ValueError(f"shape {tuple(x.shape)} exceeds int32 dims")

    def __call__(self, x, w, bias=None):
        out = self.run(x, w, bias)
        self.launches += 1
        return out

    def run(self, x, w, bias=None):
        """One launch, not counted here: `__call__` and `conv4d_dx` count
        their own."""
        self.check(x, w, bias)
        b, i, j, k, l, cin = x.shape
        cout = w.shape[5]
        if bias is None:
            bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
        bias = bias.to(torch.float32).contiguous()
        out = torch.empty(
            (b, i, j, k, l, cout), dtype=x.dtype, device=x.device
        )
        if out.numel() == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code, msg = self._lib.launch(
                x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[x.dtype], b, i, j, k, l, cin, cout, w.shape[0],
                stream,
            )
        if code != 0:
            raise RuntimeError(
                f"conv4d kernel launch failed (code {code}): {msg}; "
                f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}"
            )
        return out


def flip_transpose(w):
    """``[ki,kj,kk,kl,cin,cout]`` -> the input-gradient filters
    ``flip(w, taps)^T``, ``[ki,kj,kk,kl,cout,cin]``, contiguous."""
    return w.flip((0, 1, 2, 3)).transpose(4, 5).contiguous()


class Conv4dInputGradKernel:
    """Callable wrapper: ``kernel(g, w) -> dx``, the input gradient of
    ``conv4d(x, w, bias)`` for the output cotangent ``g``.

    ``g``: CUDA ``[b, i, j, k, l, cout]``; ``w``: the forward's
    ``[ks, ks, ks, ks, cin, cout]`` of g's dtype. Returns ``[b, i, j, k, l,
    cin]`` in g's dtype: the forward kernel on ``flip(w)^T`` (prepared
    here with plain torch, contiguous) with a zero bias. Odd ``ks`` with
    symmetric padding make the identity exact; the forward's check
    refuses even kernels. ``launches`` counts this wrapper's launches.
    """

    def __init__(self, forward):
        self.launches = 0
        self._forward = forward

    def load(self):
        """Build (first use) and load the forward's library."""
        return self._forward.load()

    def __call__(self, g, w):
        if w.dim() != 6:
            raise ValueError(
                f"conv4d dx takes w [k,k,k,k,cin,cout], got {tuple(w.shape)}"
            )
        out = self._forward.run(g, flip_transpose(w), None)
        self.launches += 1
        return out


#: The one wrapper the port launches the forward kernel through.
conv4d_fwd = Conv4dForwardKernel()
#: The input gradient: the same library, counted apart.
conv4d_dx = Conv4dInputGradKernel(conv4d_fwd)
