"""Wrapper of the hand-written Hopper sparse-band NC layer (forward).

Replaces the TPU kernel ``ncnet_tpu/kernels/band_gemm_pallas.py:83``
``_fused_kernel`` (public ``band_conv_bias_relu_pallas``) with
``csrc/band_gemm_fwd.cu``: one fused gather + GEMM + bias + ReLU per band
NC layer, ``relu(bias + sum_t x[ptr[n, t]] @ w[t])``, built by ``nvcc``
from the repository's source on first use and bound through ``ctypes``.

What bounds it on the card: bytes. At the 400 px PF-Pascal config with a
K = 16 band, the pointer table is 25 MB per layer pass and sample, and a
served pair is 7.2 GFLOP over both symmetric passes counting every tap
(most taps are null), against 281 GFLOP for the dense NC stack. The
kernel reads each pointer once, coalesced, into shared memory; skips null
taps with no FLOP and no read; gathers only the non-null neighbours' rows
from the L2-resident entry list; and writes each output row once, so the
gathered ``[N, T*c]`` block of the plain version never exists (see the
source's header).

The wrapper takes CUDA tensors only: `ncnet_tpu_torch.ops.band.
band_conv_bias_relu` routes CPU tensors to the plain PyTorch version, and
nothing here falls back to it.
"""

import ctypes
import math
import os

import torch

from ncnet_tpu_torch.kernels import _build

SOURCE = os.path.join(_build.CSRC, "band_gemm_fwd.cu")
MAX_COUT = 16  # the instantiations take 1..16 output channels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class BandGemmForwardKernel:
    """Callable wrapper: ``kernel(x, w, bias, ptr) -> out``.

    ``x``: CUDA ``[b, N, cin]`` float32 or bfloat16 entry list, contiguous.
    ``w``: ``[k1, k2, k3, k4, cin, cout]`` of x's dtype and device.
    ``bias``: ``[cout]`` on x's device, rounded to x's dtype as the
    reference casts it.
    ``ptr``: ``[b, N, T]`` int32, ``T = k1*k2*k3*k4``; ``N`` is the null slot.
    Returns ``[b, N, cout]`` in x's dtype, after bias and ReLU.

    ``launches`` counts the kernel launches this wrapper made, and nothing
    else adds to it.
    """

    def __init__(self):
        self.launches = 0
        self._lib = _build.KernelLibrary(
            SOURCE, "band_gemm", "band_gemm_fwd",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        )

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        return self._lib.load()

    def tensor_core_counts(self):
        """``{kernel function: HMMA/HGMMA count}`` of the built library, or
        None without ``cuobjdump``."""
        return self._lib.tensor_core_counts()

    @staticmethod
    def check(x, w, bias, ptr):
        """Raise ValueError/TypeError on inputs the kernel does not take."""
        if not x.is_cuda:
            raise ValueError(
                "band kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.band.band_conv_bias_relu (the plain "
                "version)"
            )
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"band kernel takes float32 or bfloat16, got {x.dtype}"
            )
        if x.dim() != 3 or w.dim() != 6 or ptr.dim() != 3:
            raise ValueError(
                f"band kernel takes x [b,N,cin], w [k,k,k,k,cin,cout] and ptr "
                f"[b,N,T]; got {tuple(x.shape)}, {tuple(w.shape)} and "
                f"{tuple(ptr.shape)}"
            )
        if ptr.dtype != torch.int32:
            raise TypeError(f"band kernel takes int32 pointers, got {ptr.dtype}")
        taps = math.prod(w.shape[:4])
        if tuple(ptr.shape) != (x.shape[0], x.shape[1], taps):
            raise ValueError(
                f"ptr {tuple(ptr.shape)} does not match x {tuple(x.shape)} "
                f"and the kernel's {taps} taps"
            )
        if w.shape[4] != x.shape[2]:
            raise ValueError(
                f"weight cin {w.shape[4]} != entry channels {x.shape[2]}"
            )
        if not 1 <= w.shape[5] <= MAX_COUT:
            raise ValueError(
                f"band kernel takes 1 to {MAX_COUT} output channels, got "
                f"cout {w.shape[5]}"
            )
        for name, t in (("weight", w), ("ptr", ptr)):
            if t.device != x.device:
                raise ValueError(
                    f"{name} must be on x's device {x.device}, got {t.device}"
                )
        if w.dtype != x.dtype:
            raise ValueError(
                f"weight must share x's dtype {x.dtype}, got {w.dtype}"
            )
        if not (x.is_contiguous() and w.is_contiguous() and ptr.is_contiguous()):
            raise ValueError("band kernel takes contiguous x, w and ptr")
        if bias.shape != (w.shape[5],) or bias.device != x.device:
            raise ValueError(
                f"bias must be [{w.shape[5]}] on {x.device}, got "
                f"{tuple(bias.shape)} on {bias.device}"
            )
        if x.shape[0] > 65535 or x.shape[1] >= 2**31 - 1:
            raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")

    def __call__(self, x, w, bias, ptr):
        self.check(x, w, bias, ptr)
        b, n, cin = x.shape
        cout = w.shape[5]
        # the reference adds the bias in the activation dtype
        bias = bias.to(x.dtype).to(torch.float32).contiguous()
        out = torch.empty((b, n, cout), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code, msg = self._lib.launch(
                x.data_ptr(), ptr.data_ptr(), w.data_ptr(), bias.data_ptr(),
                out.data_ptr(), _DTYPE_CODES[x.dtype], b, n, ptr.shape[2],
                cin, cout, stream,
            )
        if code != 0:
            raise RuntimeError(
                f"band kernel launch failed (code {code}): {msg}; "
                f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}"
            )
        self.launches += 1
        return out


#: The one wrapper the port launches the kernel through.
band_gemm_fwd = BandGemmForwardKernel()
