"""Wrapper of the hand-written Hopper kernels for the sparse-band NC layer's
weight gradient, and of the hit list that it and the layer's input
gradient (`ncnet_tpu_torch.kernels.band_gemm.band_gemm_dx`) read.

Replaces the dw half of ``ncnet_tpu/kernels/band_gemm_pallas.py::_bwd``
(the custom VJP of the TPU kernel ``_fused_kernel``, where dw is the
linear transpose of the gather-GEMM over a ``[b, N, T]`` pointer table)
with ``csrc/band_gemm_dw.cu``, CUDA C++ for ``sm_90a`` built by ``nvcc``
from the repository's source on first use and bound through ``ctypes``:

    dw[t, c, o] = sum over the hits (b, n, m) of tap t of x[b, m, c] * gp[b, n, o]

The kernel derives the hits from the band's indices as the forward kernel
does, through a bitmap of the band's cells; no pointer table exists.
`BandGemmWeightGradKernel.hit_list` lists them once per pass geometry by
tap, then output A cell (block), then slot (a counting sort: counts,
prefix sums, fill, all in a fixed order; 8 bytes a hit; every offset into
the list int64), and keeps the offsets of every (tap, block) run, which
dx reads. dw cuts the list evenly into
segments of `SEGMENT` hits on the device, sums each tap's piece of a
segment in a block, then each tap's pieces in order: float32 sums rounded
once to the activation dtype, two calls bitwise equal. Routes: bfloat16 at
16 -> 16 channels on the tensor cores (``mma.sync``), float32 and the
narrow layers on FFMA (see the source's header).

The wrapper takes CUDA tensors only: `ncnet_tpu_torch.ops.band` routes CPU
tensors to the plain PyTorch version (`band_dw_plain`), and nothing here
falls back to it.
"""

import ctypes
import math
import os
from typing import NamedTuple, Optional

import torch

from ncnet_tpu_torch.kernels import _build

SOURCE = os.path.join(_build.CSRC, "band_gemm_dw.cu")
MAX_CHANNELS = 16  # cin and cout
MAX_OFFSETS = 9 * 9  # offsets in each grid: k1 * k2 and k3 * k4
#: the hits one block of the dw kernel sums: the list is cut evenly into
#: segments of this length, whatever taps they span
SEGMENT = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class BandHits(NamedTuple):
    """The hits of one pass geometry for one kernel size, by tap, then
    output A cell (block ``b * hA * wA + a``), then slot.

    ``tap_start`` ``[T + 1]`` int64: tap t's hits are ``[tap_start[t],
    tap_start[t + 1])``; ``n`` and ``m`` ``[H]`` int32: the output entry
    and the input entry of each hit, cell-major on both passes and
    flattened over the batch (``b * N + a * K + slot``); ``kernel`` ``(k1,
    k2, k3, k4)``; ``block_start`` ``[T * b*hA*wA + 1]`` int64: run (tap t, block blk) is ``[block_start[t * nblk + blk],
    block_start[t * nblk + blk + 1])``; ``band`` ``(b, hA, wA, K)``;
    ``inv`` and ``perm`` the symmetric pass's B-major order
    (`ncnet_tpu_torch.ops.band.b_major_order`, int32 ``[b, N]``: the pass's
    row of entry e is ``inv[e]``), None on the plain pass. The kernels take
    cell-major rows; `cell_major` and `pass_order` move a tensor between
    the pass's order and theirs.
    """

    tap_start: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    kernel: tuple
    block_start: torch.Tensor
    band: tuple
    inv: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None

    @property
    def count(self):
        return int(self.n.numel())

    @property
    def rows(self):
        """``b * N``: the entries of the band."""
        return math.prod(self.band)


def cell_major(t, hits):
    """``t`` ``[b, N, c]`` in the pass's entry order, in cell-major order:
    itself on the plain pass, gathered through ``inv`` on the symmetric
    pass."""
    if hits.inv is None:
        return t
    return torch.gather(t, 1, hits.inv.long()[..., None].expand(-1, -1, t.shape[2]))


def pass_order(t, hits):
    """The inverse of `cell_major`: cell-major ``t`` in the pass's order."""
    if hits.perm is None:
        return t
    return torch.gather(t, 1, hits.perm.long()[..., None].expand(-1, -1, t.shape[2]))


def segments(tap_start, length=SEGMENT):
    """The dw kernel's cut of a hit list, in plain PyTorch: ``(lo, hi,
    tap, piece)`` int64 ``[P]``, one row a piece (the hits ``[lo, hi)`` of
    tap ``tap`` within segment ``s = lo // length``, whose sum goes to
    partial row ``piece = s + tap``), in list order. ``tap_start`` is the
    list's ``[T + 1]`` offsets."""
    start = torch.as_tensor(tap_start, dtype=torch.int64)
    first, last = start[:-1], start[1:]
    live = torch.nonzero(last > first).flatten()
    s0 = torch.div(first[live], length, rounding_mode="floor")
    s1 = torch.div(last[live] - 1, length, rounding_mode="floor")
    per_tap = s1 - s0 + 1
    tap = torch.repeat_interleave(live, per_tap)
    seg = (torch.repeat_interleave(s0 - (per_tap.cumsum(0) - per_tap), per_tap)
           + torch.arange(tap.numel()))
    lo = torch.maximum(seg * length, start[tap])
    hi = torch.minimum((seg + 1) * length, start[tap + 1])
    return lo, hi, tap, seg + tap


class BandGemmWeightGradKernel:
    """Callable wrapper: ``kernel(x, gp, hits) -> dw``.

    ``x``: CUDA ``[b, N, cin]`` float32 or bfloat16, the layer's input
    entries; ``gp``: ``[b, N, cout]`` of x's dtype, the ReLU-masked output
    cotangent; both contiguous, in the pass's entry order (on the symmetric
    pass they are gathered into the kernel's cell-major order first).
    ``hits``: the pass's `BandHits` (`hit_list`). Returns ``[k1, k2, k3,
    k4, cin, cout]`` in x's dtype, each float32 sum rounded once.

    ``launches`` counts the dw launches; ``hit_builds`` the hit lists built
    (each four launches of counting and offsets, then one of filling).
    """

    def __init__(self):
        self.launches = 0
        self.hit_builds = 0
        self._lib = _build.KernelLibrary(
            SOURCE, "band_gemm_dw", "band_gemm_dw",
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        )
        self._hits = _build.KernelLibrary(
            SOURCE, "band_gemm_dw", "band_hits",
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
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
        (the device last, so the sizes can be checked on any device). The
        number of hits is bounded by memory alone: the list's offsets are
        int64, and its length is read back before it is allocated."""
        if indices.dim() != 4 or indices.dtype != torch.int32:
            raise TypeError(
                f"band dw kernel takes int32 indices [b,hA,wA,K], got "
                f"{tuple(indices.shape)} {indices.dtype}"
            )
        b, ha, wa, k = indices.shape
        hb, wb = (int(d) for d in grid_b)
        if len(kernel) != 4 or any(int(d) < 1 or int(d) % 2 == 0 for d in kernel):
            raise ValueError(f"band dw kernel takes odd kernel sizes, got {kernel}")
        k1, k2, k3, k4 = (int(d) for d in kernel)
        taps = k1 * k2 * k3 * k4
        if k1 * k2 > MAX_OFFSETS or k3 * k4 > MAX_OFFSETS:
            raise ValueError(
                f"band dw kernel takes at most {MAX_OFFSETS} offsets in each "
                f"grid (k1*k2, k3*k4), got kernel {kernel}")
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
        # hit rows b * N + row stay int32
        nblk = b * ha * wa
        if b > 65535 or nblk * k >= 2**31 or taps * nblk >= 2**31:
            raise ValueError(f"band {tuple(indices.shape)} exceeds the launch grid")
        if not indices.is_cuda:
            raise ValueError(
                "band dw kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.band.band_dw_plain"
            )

    def hit_list(self, indices, grid_b, kernel, inv=None):
        """The pass's `BandHits` for ``kernel``: the plain pass without
        ``inv``, the symmetric pass (B-major rows) with it. ``indices``
        must be strictly ascending per A cell, as `ncnet_tpu_torch.ops.
        band.topk_band` gives them. One host sync reads the number of hits
        before the list is allocated."""
        kernel = tuple(int(d) for d in kernel)
        self.check_band(indices, grid_b, kernel, inv)
        b, ha, wa, k = indices.shape
        hb, wb = (int(d) for d in grid_b)
        taps = math.prod(kernel)
        dev = indices.device
        # the band's bitmap and its ranks, a row of ceil(hB*wB / 32) words
        # a cell
        words = b * ha * wa * (-(-hb * wb // 32))
        bits = torch.empty(words, dtype=torch.int32, device=dev)
        rank = torch.empty(words, dtype=torch.int32, device=dev)
        offsets = torch.empty(taps * b * ha * wa + 1, dtype=torch.int64, device=dev)
        # [T + 1] offsets, then a flag the kernel sets on an unsorted band
        tap_start = torch.empty(taps + 2, dtype=torch.int64, device=dev)
        args = (int(inv is not None), b, ha, wa, hb, wb, k, *kernel)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code, msg = self._hits.launch(
                indices.data_ptr(), bits.data_ptr(), rank.data_ptr(),
                offsets.data_ptr(), tap_start.data_ptr(), None, None, 0,
                *args, stream)
            if code == 0:
                total, unsorted = tap_start[taps:].tolist()
                if unsorted:
                    raise ValueError(
                        f"band indices {tuple(indices.shape)} must be strictly "
                        f"ascending in [0, {hb * wb}) per A cell")
                # 8 bytes a hit: past memory the allocator raises, naming it
                hit_n = torch.empty(total, dtype=torch.int32, device=dev)
                hit_m = torch.empty(total, dtype=torch.int32, device=dev)
                if total:
                    code, msg = self._hits.launch(
                        indices.data_ptr(), bits.data_ptr(), rank.data_ptr(),
                        offsets.data_ptr(), tap_start.data_ptr(),
                        hit_n.data_ptr(), hit_m.data_ptr(), 1, *args, stream)
        if code != 0:
            raise RuntimeError(
                f"band hit-list launch failed (code {code}): {msg}; indices "
                f"{tuple(indices.shape)}, grid_b {(hb, wb)}, kernel {kernel}"
            )
        perm = None
        if inv is not None:
            n = ha * wa * k
            perm = torch.empty_like(inv).scatter_(
                1, inv.long(), torch.arange(n, dtype=torch.int32,
                                            device=dev).expand(b, n))
        self.hit_builds += 1
        return BandHits(tap_start[:taps + 1], hit_n, hit_m, kernel, offsets,
                        (b, ha, wa, k), inv, perm)

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
        b, ha, wa, k = hits.band
        if tuple(x.shape[:2]) != (b, ha * wa * k):
            raise ValueError(f"the hit list is for a band {hits.band}, x is "
                             f"{tuple(x.shape)}")

    def __call__(self, x, gp, hits):
        self.check(x, gp, hits)
        x, gp = aligned(cell_major(x, hits)), aligned(cell_major(gp, hits))
        cin, cout = x.shape[2], gp.shape[2]
        taps = math.prod(hits.kernel)
        n_seg = -(-hits.count // SEGMENT)
        dw = torch.empty((*hits.kernel, cin, cout), dtype=x.dtype, device=x.device)
        partial = torch.empty((n_seg + taps, cin * cout), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code, msg = self._lib.launch(
                x.data_ptr(), gp.data_ptr(), hits.tap_start.data_ptr(),
                hits.n.data_ptr(), hits.m.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), _DTYPE_CODES[x.dtype], n_seg, taps, cin, cout,
                SEGMENT, stream,
            )
        if code != 0:
            raise RuntimeError(
                f"band dw kernel launch failed (code {code}): {msg}; x "
                f"{tuple(x.shape)} {x.dtype}, gp {tuple(gp.shape)}, kernel "
                f"{hits.kernel}"
            )
        self.launches += 1
        return dw


def aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (a view into a larger tensor): the kernels read whole rows as
    16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


#: The one wrapper the port launches the kernel through.
band_gemm_dw = BandGemmWeightGradKernel()
