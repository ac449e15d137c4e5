"""Wrappers of the hand-written Hopper sparse-band NC layer: the forward and,
through the same kernel in its linear mode, the input gradient.

Replaces the TPU kernel ``ncnet_tpu/kernels/band_gemm_pallas.py:83``
``_fused_kernel`` (public ``band_conv_bias_relu_pallas``) with
``csrc/band_gemm_fwd.cu``: one fused neighbour gather + GEMM + bias + ReLU
per band NC layer, ``relu(bias + sum_t x[nbr(n, t)] @ w[t])``, built by
``nvcc`` from the repository's source on first use and bound through
``ctypes``.

The kernel finds each entry's neighbours from the band itself (its sorted
B-indices), not from a pointer table: no ``[b, N, T]`` table exists on the
card. What bounds it there: operations, if anything (at the 400 px
PF-Pascal config with a K = 16 band about 2.3% of the 625 taps are on the
band, 0.3 GFLOP a 16->16 layer at 4 samples, against a few MB of entries,
indices and weights); in practice the tap derivation and the gathers from
L2 (see the source's header).

The input gradient of the layer is the same contraction of the
ReLU-masked output cotangent with the spatially flipped, channel-transposed
kernel over the same band, with no bias and no ReLU (the JAX package's
``band_gemm_pallas.py::_bwd``): `band_gemm_dx` launches the forward's
library in its linear mode, with its own launch count.

The wrappers take CUDA tensors only: `ncnet_tpu_torch.ops.band.band_layer`
routes CPU tensors to the plain PyTorch versions, and nothing here falls
back to them.
"""

import ctypes
import os

import torch

from ncnet_tpu_torch.kernels import _build
from ncnet_tpu_torch.kernels.conv4d import flip_transpose

SOURCE = os.path.join(_build.CSRC, "band_gemm_fwd.cu")
MAX_COUT = 16  # the instantiations take 1..16 output channels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class BandGemmForwardKernel:
    """Callable wrapper: ``kernel(x, w, bias, indices, grid_b, inv=None) -> out``.

    ``x``: CUDA ``[b, N, cin]`` float32 or bfloat16 entry list, contiguous,
    ``N = hA*wA*K``.
    ``w``: ``[k1, k2, k3, k4, cin, cout]`` of x's dtype and device.
    ``bias``: ``[cout]`` on x's device, rounded to x's dtype as the
    reference casts it; None runs the linear mode (`run`).
    ``indices``: ``[b, hA, wA, K]`` int32, the band's B-indices sorted
    ascending per A cell (`ncnet_tpu_torch.ops.band.topk_band`).
    ``grid_b``: ``(hB, wB)``.
    ``inv``: ``[b, N]`` int32, the inverse of the B-major order
    (`ncnet_tpu_torch.ops.band.b_major_order`), a permutation of
    ``[0, N)``: given, the symmetric pass over the B-major entries (swapped
    taps; entry e's row is ``inv[e]``); absent, the plain pass.
    Returns ``[b, N, cout]`` in x's dtype, after bias and ReLU.

    ``launches`` counts the kernel launches this wrapper made, and nothing
    else adds to it.
    """

    def __init__(self):
        self.launches = 0
        self._lib = _build.KernelLibrary(
            SOURCE, "band_gemm", "band_gemm_fwd",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
        )

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        return self._lib.load()

    def tensor_core_counts(self):
        """``{kernel function: HMMA/HGMMA count}`` of the built library, or
        None without ``cuobjdump``."""
        return self._lib.tensor_core_counts()

    @staticmethod
    def check(x, w, bias, indices, grid_b, inv=None):
        """Raise ValueError/TypeError on inputs the kernel does not take."""
        if not x.is_cuda:
            raise ValueError(
                "band kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.band.band_layer (the plain version)"
            )
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"band kernel takes float32 or bfloat16, got {x.dtype}"
            )
        if x.dim() != 3 or w.dim() != 6 or indices.dim() != 4:
            raise ValueError(
                f"band kernel takes x [b,N,cin], w [k,k,k,k,cin,cout] and "
                f"indices [b,hA,wA,K]; got {tuple(x.shape)}, "
                f"{tuple(w.shape)} and {tuple(indices.shape)}"
            )
        int_inputs = (("indices", indices),) + (
            () if inv is None else (("inv", inv),))
        for name, t in int_inputs:
            if t.dtype != torch.int32:
                raise TypeError(f"band kernel takes int32 {name}, got {t.dtype}")
        b, n = x.shape[:2]
        ha, wa, k = indices.shape[1:]
        hb, wb = (int(d) for d in grid_b)
        if indices.shape[0] != b or ha * wa * k != n:
            raise ValueError(
                f"indices {tuple(indices.shape)} do not match x "
                f"{tuple(x.shape)}: the grids must give N = hA*wA*K entries"
            )
        if not 1 <= k <= hb * wb:
            raise ValueError(
                f"band width K={k} must be in [1, hB*wB] for the B grid "
                f"{hb}x{wb}"
            )
        if hb >= 2**15 or wb >= 2**16:
            raise ValueError(f"B grid {hb}x{wb} exceeds the kernel's 16-bit "
                             "cell coordinates")
        if inv is not None and tuple(inv.shape) != (b, n):
            raise ValueError(f"inv must be [{b}, {n}], got {tuple(inv.shape)}")
        if w.shape[4] != x.shape[2]:
            raise ValueError(
                f"weight cin {w.shape[4]} != entry channels {x.shape[2]}"
            )
        if not 1 <= w.shape[5] <= MAX_COUT:
            raise ValueError(
                f"band kernel takes 1 to {MAX_COUT} output channels, got "
                f"cout {w.shape[5]}"
            )
        for name, t in (("weight", w),) + int_inputs:
            if t.device != x.device:
                raise ValueError(
                    f"{name} must be on x's device {x.device}, got {t.device}"
                )
        if w.dtype != x.dtype:
            raise ValueError(
                f"weight must share x's dtype {x.dtype}, got {w.dtype}"
            )
        if not all(t.is_contiguous() for _, t in (("x", x), ("w", w)) + int_inputs):
            raise ValueError("band kernel takes contiguous x, w, indices and inv")
        if bias is not None and (bias.shape != (w.shape[5],)
                                 or bias.device != x.device):
            raise ValueError(
                f"bias must be [{w.shape[5]}] on {x.device}, got "
                f"{tuple(bias.shape)} on {bias.device}"
            )
        if b > 65535 or n >= 2**31 - 1:
            raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")

    def __call__(self, x, w, bias, indices, grid_b, inv=None):
        if bias is None:
            raise ValueError("the band forward takes a bias; band_gemm_dx "
                             "runs the kernel's linear mode")
        out = self.run(x, w, bias, indices, grid_b, inv)
        self.launches += 1
        return out

    def run(self, x, w, bias, indices, grid_b, inv=None):
        """One launch, not counted here: `__call__` and `band_gemm_dx` count
        their own. ``bias=None`` runs the linear mode (no bias, no ReLU)."""
        self.check(x, w, bias, indices, grid_b, inv)
        linear = bias is None
        b, n, cin = x.shape
        _, ha, wa, k = indices.shape
        hb, wb = (int(d) for d in grid_b)
        cout = w.shape[5]
        if not linear:
            # the reference adds the bias in the activation dtype
            bias = bias.to(x.dtype).to(torch.float32).contiguous()
        out = torch.empty((b, n, cout), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code, msg = self._lib.launch(
                x.data_ptr(), indices.data_ptr(),
                None if inv is None else inv.data_ptr(),
                w.data_ptr(), None if linear else bias.data_ptr(),
                out.data_ptr(), _DTYPE_CODES[x.dtype], int(linear),
                b, ha, wa, hb, wb, k, cin, cout, *w.shape[:4], stream,
            )
        if code != 0:
            raise RuntimeError(
                f"band kernel launch failed (code {code}): {msg}; "
                f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}, "
                f"indices {tuple(indices.shape)}, grid_b {(hb, wb)}, "
                f"linear {linear}"
            )
        return out


class BandGemmInputGradKernel:
    """Callable wrapper: ``kernel(gp, w, indices, grid_b, inv=None) -> dx``,
    the input gradient of one band NC layer for its ReLU-masked output
    cotangent ``gp``.

    ``gp``: CUDA ``[b, N, cout]``; ``w``: the forward's ``[k1, k2, k3, k4,
    cin, cout]`` (odd sizes) of gp's dtype; ``indices``, ``grid_b`` and
    ``inv``: the pass's band, as the forward took them. Returns ``[b, N,
    cin]`` in gp's dtype: the forward kernel in its linear mode on
    ``flip(w)^T`` (prepared here with plain torch), the float32 sum rounded
    once. ``launches`` counts this wrapper's launches.
    """

    def __init__(self, forward):
        self.launches = 0
        self._forward = forward

    def load(self):
        """Build (first use) and load the forward's library."""
        return self._forward.load()

    def __call__(self, gp, w, indices, grid_b, inv=None):
        if w.dim() != 6 or any(k % 2 == 0 for k in w.shape[:4]):
            raise ValueError(
                "band dx takes w [k1,k2,k3,k4,cin,cout] with odd sizes (the "
                f"flipped-kernel identity), got {tuple(w.shape)}"
            )
        out = self._forward.run(gp, flip_transpose(w), None, indices, grid_b,
                                inv)
        self.launches += 1
        return out


#: The one wrapper the port launches the forward kernel through.
band_gemm_fwd = BandGemmForwardKernel()
#: The input gradient: the same library in its linear mode, counted apart.
band_gemm_dx = BandGemmInputGradKernel(band_gemm_fwd)
