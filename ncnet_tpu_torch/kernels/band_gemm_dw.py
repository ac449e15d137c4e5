"""Wrapper of the hand-written Hopper kernel for the sparse-band NC layer's
weight gradient.

Replaces the dw half of ``ncnet_tpu/kernels/band_gemm_pallas.py::_bwd``
(the custom VJP of the TPU kernel ``_fused_kernel``, where dw is the
linear transpose of the gather-GEMM over a ``[b, N, T]`` pointer table)
with ``csrc/band_gemm_dw.cu``, CUDA C++ for ``sm_90a`` built by ``nvcc``
from the repository's source on first use and bound through ``ctypes``:

    dw[t, c, o] = sum over the hits (b, n, m) of tap t of x[b, m, c] * gp[b, n, o]

The kernel derives the hits from the band's indices as the forward kernel
does; no pointer table exists. `BandGemmWeightGradKernel.hit_list` lists
them by tap once per pass geometry (a counting sort: counts, prefix sums,
fill, all in a fixed order; 8 bytes a hit) and cuts each tap's run into
segments of at most `SEGMENT` hits; each layer's dw sums every segment in
a block, then each tap's segments in order, float32 sums rounded once to
the activation dtype: two calls are bitwise equal. What bounds it on the
card: the hits' derivation and the gathers of the hit rows, not the FLOPs
(see the source's header).

The wrapper takes CUDA tensors only: `ncnet_tpu_torch.ops.band` routes CPU
tensors to the plain PyTorch version (`band_dw_plain`), and nothing here
falls back to it.
"""

import ctypes
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ncnet_tpu_torch.kernels import _build

SOURCE = os.path.join(_build.CSRC, "band_gemm_dw.cu")
MAX_CHANNELS = 16  # cin and cout
MAX_TAPS = 9**4
#: the most hits one block of the dw kernel sums (a tap's run is cut into
#: segments of this length, so the centre tap's B*N hits spread over many
#: blocks)
SEGMENT = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class BandHits(NamedTuple):
    """The hits of one pass geometry for one kernel size, by tap.

    ``tap_start`` ``[T + 1]`` int32: tap t's hits are ``[tap_start[t],
    tap_start[t + 1])``; ``n`` and ``m`` ``[H]`` int32: the output row and
    the input row of each hit, flattened over the batch (``b * N + row``,
    rows in the pass's entry order); ``kernel`` ``(k1, k2, k3, k4)``;
    ``rows`` ``b * N``; ``segments`` the dw kernel's cut of the list
    (`segments`), None where no kernel will read it.
    """

    tap_start: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    kernel: tuple
    rows: int
    segments: Optional[tuple] = None

    @property
    def count(self):
        return int(self.n.numel())


def segments(tap_start, device, length=SEGMENT):
    """The dw kernel's cut of a hit list: ``(lo, hi, first)`` int32 tensors
    on ``device``, segment s holding the hits ``[lo[s], hi[s])`` of one
    tap, at most ``length`` of them, and tap t's segments ``[first[t],
    first[t + 1])``, in tap order. ``tap_start`` is the list's ``[T + 1]``
    offsets as numpy."""
    start = np.asarray(tap_start, dtype=np.int64)
    count = np.diff(start)
    n_seg = -(-count // length)
    first = np.concatenate([[0], np.cumsum(n_seg)])
    tap = np.repeat(np.arange(count.size), n_seg)
    lo = start[tap] + (np.arange(first[-1]) - first[tap]) * length
    hi = np.minimum(lo + length, start[tap + 1])
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (lo, hi, first))


class BandGemmWeightGradKernel:
    """Callable wrapper: ``kernel(x, gp, hits) -> dw``.

    ``x``: CUDA ``[b, N, cin]`` float32 or bfloat16, the layer's input
    entries; ``gp``: ``[b, N, cout]`` of x's dtype, the ReLU-masked output
    cotangent; both contiguous, in the pass's entry order. ``hits``: the
    pass's `BandHits` (`hit_list`). Returns ``[k1, k2, k3, k4, cin, cout]``
    in x's dtype, each float32 sum rounded once.

    ``launches`` counts the dw launches; ``hit_builds`` the hit lists built
    (each three launches of counting and one of filling).
    """

    def __init__(self):
        self.launches = 0
        self.hit_builds = 0
        self._lib = _build.KernelLibrary(
            SOURCE, "band_gemm_dw", "band_gemm_dw",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        )
        self._hits = _build.KernelLibrary(
            SOURCE, "band_gemm_dw", "band_hits",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
        )

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        log = self._lib.load()
        self._hits.load()
        return log

    def tensor_core_counts(self):
        """``{kernel function: HMMA/HGMMA count}`` of the built library, or
        None without ``cuobjdump``."""
        return self._lib.tensor_core_counts()

    @staticmethod
    def check_band(indices, grid_b, kernel, inv=None):
        """Raise ValueError/TypeError on a band the hit list does not take
        (the device last, so the sizes can be checked on any device)."""
        if indices.dim() != 4 or indices.dtype != torch.int32:
            raise TypeError(
                f"band dw kernel takes int32 indices [b,hA,wA,K], got "
                f"{tuple(indices.shape)} {indices.dtype}"
            )
        b, ha, wa, k = indices.shape
        hb, wb = (int(d) for d in grid_b)
        if len(kernel) != 4 or any(int(d) < 1 or int(d) % 2 == 0 for d in kernel):
            raise ValueError(f"band dw kernel takes odd kernel sizes, got {kernel}")
        taps = math.prod(int(d) for d in kernel)
        if taps > MAX_TAPS:
            raise ValueError(f"band dw kernel takes at most {MAX_TAPS} taps, got {taps}")
        if not 1 <= k <= hb * wb or hb >= 2**15 or wb >= 2**16:
            raise ValueError(
                f"band width K={k} must be in [1, hB*wB] for the B grid "
                f"{hb}x{wb} (hB < 2^15, wB < 2^16)"
            )
        if inv is not None and (tuple(inv.shape) != (b, ha * wa * k)
                                or inv.dtype != torch.int32
                                or inv.device != indices.device):
            raise ValueError(
                f"inv must be int32 [{b}, {ha * wa * k}] on {indices.device}, "
                f"got {tuple(inv.shape)} {inv.dtype} on {inv.device}"
            )
        if not (indices.is_contiguous() and (inv is None or inv.is_contiguous())):
            raise ValueError("band dw kernel takes contiguous indices and inv")
        nblk = b * ha * wa
        if b > 65535 or nblk * k >= 2**31 or taps * nblk >= 2**31:
            raise ValueError(f"band {tuple(indices.shape)} exceeds the launch grid")
        # the hit list's offsets are int32: an entry has at most one hit a tap
        if nblk * k * taps >= 2**31:
            raise ValueError(
                f"band {tuple(indices.shape)} with {taps} taps may hold "
                f"{nblk * k * taps} hits, past the hit list's int32 offsets"
            )
        if not indices.is_cuda:
            raise ValueError(
                "band dw kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.band.band_dw_plain"
            )

    def hit_list(self, indices, grid_b, kernel, inv=None):
        """The pass's `BandHits` for ``kernel``: the plain pass without
        ``inv``, the symmetric pass (B-major rows) with it. One host sync
        reads the number of hits before the list is allocated."""
        kernel = tuple(int(d) for d in kernel)
        self.check_band(indices, grid_b, kernel, inv)
        b, ha, wa, k = indices.shape
        hb, wb = (int(d) for d in grid_b)
        taps = math.prod(kernel)
        dev = indices.device
        counts = torch.empty(taps * b * ha * wa, dtype=torch.int32, device=dev)
        tap_start = torch.empty(taps + 1, dtype=torch.int32, device=dev)
        args = (b, ha, wa, hb, wb, k, *kernel)
        inv_ptr = None if inv is None else inv.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code, msg = self._hits.launch(
                indices.data_ptr(), inv_ptr, counts.data_ptr(),
                tap_start.data_ptr(), None, None, 0, *args, stream)
            if code == 0:
                start = tap_start.cpu().numpy()
                total = int(start[taps])
                hit_n = torch.empty(total, dtype=torch.int32, device=dev)
                hit_m = torch.empty(total, dtype=torch.int32, device=dev)
                if total:
                    code, msg = self._hits.launch(
                        indices.data_ptr(), inv_ptr, counts.data_ptr(),
                        tap_start.data_ptr(), hit_n.data_ptr(),
                        hit_m.data_ptr(), 1, *args, stream)
        if code != 0:
            raise RuntimeError(
                f"band hit-list launch failed (code {code}): {msg}; indices "
                f"{tuple(indices.shape)}, grid_b {(hb, wb)}, kernel {kernel}"
            )
        self.hit_builds += 1
        return BandHits(tap_start, hit_n, hit_m, kernel, b * ha * wa * k,
                        segments(start, dev))

    @staticmethod
    def check(x, gp, hits):
        """Raise ValueError/TypeError on inputs the kernel does not take."""
        if not x.is_cuda:
            raise ValueError(
                "band dw kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.band.band_dw_plain"
            )
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"band dw kernel takes float32 or bfloat16, got {x.dtype}")
        if x.dim() != 3 or gp.dim() != 3 or x.shape[:2] != gp.shape[:2]:
            raise ValueError(
                f"band dw kernel takes x [b,N,cin] and gp [b,N,cout] over one "
                f"entry list; got {tuple(x.shape)} and {tuple(gp.shape)}"
            )
        if x.shape[0] * x.shape[1] != hits.rows:
            raise ValueError(
                f"the hit list covers {hits.rows} rows, x {tuple(x.shape)} "
                f"holds {x.shape[0] * x.shape[1]}"
            )
        if gp.dtype != x.dtype or gp.device != x.device:
            raise ValueError(
                f"gp must share x's dtype and device ({x.dtype}, {x.device}); "
                f"got ({gp.dtype}, {gp.device})"
            )
        if not (1 <= x.shape[2] <= MAX_CHANNELS and 1 <= gp.shape[2] <= MAX_CHANNELS):
            raise ValueError(
                f"band dw kernel takes 1 to {MAX_CHANNELS} channels in and out, "
                f"got cin {x.shape[2]}, cout {gp.shape[2]}"
            )
        if not (x.is_contiguous() and gp.is_contiguous()):
            raise ValueError("band dw kernel takes contiguous x and gp")
        if hits.tap_start.device != x.device:
            raise ValueError(f"the hit list is on {hits.tap_start.device}, x on {x.device}")
        if hits.segments is None:
            raise ValueError("the hit list has no segments: build it with "
                             "band_gemm_dw.hit_list")

    def __call__(self, x, gp, hits):
        self.check(x, gp, hits)
        cin, cout = x.shape[2], gp.shape[2]
        taps = math.prod(hits.kernel)
        lo, hi, first = hits.segments
        dw = torch.empty((*hits.kernel, cin, cout), dtype=x.dtype, device=x.device)
        partial = torch.empty((lo.numel(), cin * cout), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code, msg = self._lib.launch(
                x.data_ptr(), gp.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                first.data_ptr(), hits.n.data_ptr(), hits.m.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), _DTYPE_CODES[x.dtype],
                lo.numel(), taps, cin, cout, stream,
            )
        if code != 0:
            raise RuntimeError(
                f"band dw kernel launch failed (code {code}): {msg}; x "
                f"{tuple(x.shape)} {x.dtype}, gp {tuple(gp.shape)}, kernel "
                f"{hits.kernel}"
            )
        self.launches += 1
        return dw


#: The one wrapper the port launches the kernel through.
band_gemm_dw = BandGemmWeightGradKernel()
