"""Wrappers of the hand-written Hopper kernels of the sparse-band NC layer:
the forward and the input gradient.

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

The input gradient (the dx half of the JAX package's
``band_gemm_pallas.py::_bwd``) is a kernel of its own,
``csrc/band_gemm_dx.cu``: it reads the pass's hit list, which the weight
gradient's kernel builds (`ncnet_tpu_torch.kernels.band_gemm_dw`), and
sums each input row's hits, tap by tap, ``gp[n] @ w[t]^T`` (bfloat16 at
16 input channels on the tensor cores, the rest on FFMA; see the source's
header).

The wrappers take CUDA tensors only: `ncnet_tpu_torch.ops.band.band_layer`
routes CPU tensors to the plain PyTorch versions, and nothing here falls
back to them.
"""

import ctypes
import os

import torch

from ncnet_tpu_torch.kernels import _build
from ncnet_tpu_torch.kernels.band_gemm_dw import aligned, cell_major, pass_order

SOURCE = os.path.join(_build.CSRC, "band_gemm_fwd.cu")
DX_SOURCE = os.path.join(_build.CSRC, "band_gemm_dx.cu")
MAX_COUT = 16  # the instantiations take 1..16 output channels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class BandGemmForwardKernel:
    """Callable wrapper: ``kernel(x, w, bias, indices, grid_b, inv=None) -> out``.

    ``x``: CUDA ``[b, N, cin]`` float32 or bfloat16 entry list, contiguous,
    ``N = hA*wA*K``.
    ``w``: ``[k1, k2, k3, k4, cin, cout]`` of x's dtype and device.
    ``bias``: ``[cout]`` on x's device, rounded to x's dtype as the
    reference casts it.
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
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
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
        if bias.shape != (w.shape[5],) or bias.device != x.device:
            raise ValueError(
                f"bias must be [{w.shape[5]}] on {x.device}, got "
                f"{tuple(bias.shape)} on {bias.device}"
            )
        if b > 65535 or n >= 2**31 - 1:
            raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")

    def __call__(self, x, w, bias, indices, grid_b, inv=None):
        if bias is None:
            raise ValueError("the band forward takes a bias")
        self.check(x, w, bias, indices, grid_b, inv)
        b, n, cin = x.shape
        _, ha, wa, k = indices.shape
        hb, wb = (int(d) for d in grid_b)
        cout = w.shape[5]
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
                w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[x.dtype], b, ha, wa, hb, wb, k, cin, cout,
                *w.shape[:4], stream,
            )
        if code != 0:
            raise RuntimeError(
                f"band kernel launch failed (code {code}): {msg}; "
                f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}, "
                f"indices {tuple(indices.shape)}, grid_b {(hb, wb)}"
            )
        self.launches += 1
        return out


class BandGemmInputGradKernel:
    """Callable wrapper: ``kernel(gp, w, hits) -> dx``, the input gradient
    of one band NC layer for its ReLU-masked output cotangent ``gp``.

    ``gp``: CUDA ``[b, N, cout]`` float32 or bfloat16, contiguous, in the
    pass's entry order; ``w``: the forward's ``[k1, k2, k3, k4, cin,
    cout]`` (odd sizes, not flipped) of gp's dtype; ``hits``: the pass's
    `ncnet_tpu_torch.kernels.band_gemm_dw.BandHits` for w's kernel size,
    which the layer's dw reads too. Returns ``[b, N, cin]`` in gp's dtype
    and the pass's order, each float32 sum rounded once (on the symmetric
    pass the kernel runs in cell-major order: gp is gathered into it and
    dx out of it). ``launches`` counts this wrapper's launches, and
    nothing else adds to it.
    """

    def __init__(self):
        self.launches = 0
        self._lib = _build.KernelLibrary(
            DX_SOURCE, "band_gemm_dx", "band_gemm_dx",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
        )

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        return self._lib.load()

    def tensor_core_counts(self):
        """``{kernel function: HMMA/HGMMA count}`` of the built library, or
        None without ``cuobjdump``."""
        return self._lib.tensor_core_counts()

    @staticmethod
    def check(gp, w, hits):
        """Raise ValueError/TypeError on inputs the kernel does not take."""
        if w.dim() != 6 or any(k % 2 == 0 for k in w.shape[:4]):
            raise ValueError(
                "band dx takes w [k1,k2,k3,k4,cin,cout] with odd sizes, got "
                f"{tuple(w.shape)}"
            )
        if not gp.is_cuda:
            raise ValueError(
                "band dx kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.band.band_dx_plain"
            )
        if gp.dtype not in _DTYPE_CODES:
            raise TypeError(f"band dx kernel takes float32 or bfloat16, got {gp.dtype}")
        if w.dtype != gp.dtype or w.device != gp.device:
            raise ValueError(
                f"w must share gp's dtype and device ({gp.dtype}, {gp.device}); "
                f"got ({w.dtype}, {w.device})"
            )
        if tuple(w.shape[:4]) != hits.kernel:
            raise ValueError(f"the hit list is for kernel {hits.kernel}, w is "
                             f"{tuple(w.shape)}")
        b, ha, wa, k = hits.band
        if gp.dim() != 3 or tuple(gp.shape[:2]) != (b, ha * wa * k):
            raise ValueError(
                f"band dx kernel takes gp [b,N,cout] over the hit list's "
                f"{b} x {ha * wa * k} entries; got {tuple(gp.shape)}"
            )
        if gp.shape[2] != w.shape[5]:
            raise ValueError(f"gp has {gp.shape[2]} channels, w's cout is {w.shape[5]}")
        if not (1 <= w.shape[4] <= MAX_COUT and 1 <= w.shape[5] <= MAX_COUT):
            raise ValueError(
                f"band dx kernel takes 1 to {MAX_COUT} channels in and out, "
                f"got {tuple(w.shape[4:])}"
            )
        if not (gp.is_contiguous() and w.is_contiguous()):
            raise ValueError("band dx kernel takes contiguous gp and w")
        if hits.block_start.device != gp.device:
            raise ValueError(f"the hit list is on {hits.block_start.device}, "
                             f"gp on {gp.device}")

    def __call__(self, gp, w, hits):
        self.check(gp, w, hits)
        gp, w = aligned(cell_major(gp, hits)), aligned(w)
        b, ha, wa, k = hits.band
        cin, cout = w.shape[4:]
        dx = torch.empty((b, ha * wa * k, cin), dtype=gp.dtype, device=gp.device)
        with torch.cuda.device(gp.device):
            stream = torch.cuda.current_stream(gp.device).cuda_stream
            code, msg = self._lib.launch(
                gp.data_ptr(), w.data_ptr(), hits.block_start.data_ptr(),
                hits.n.data_ptr(), hits.m.data_ptr(), dx.data_ptr(),
                _DTYPE_CODES[gp.dtype], int(hits.inv is not None), b, ha, wa,
                k, cin, cout, *hits.kernel, stream,
            )
        if code != 0:
            raise RuntimeError(
                f"band dx kernel launch failed (code {code}): {msg}; gp "
                f"{tuple(gp.shape)} {gp.dtype}, w {tuple(w.shape)}, band "
                f"{hits.band}"
            )
        self.launches += 1
        return pass_order(dx, hits)


#: The one wrapper the port launches the forward kernel through.
band_gemm_fwd = BandGemmForwardKernel()
#: The one wrapper the port launches the input-gradient kernel through.
band_gemm_dx = BandGemmInputGradKernel()
