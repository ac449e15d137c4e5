"""Wrapper of the hand-written Hopper kernel for the 4D convolution's weight
gradient.

Replaces ``ncnet_tpu/kernels/conv4d_pallas.py::_dw_scan`` (the dw half of
the Pallas kernel's custom VJP, an XLA scan of per-tap einsums there) with
``csrc/conv4d_dw.cu``, CUDA C++ for ``sm_90a`` built by ``nvcc`` from the
repository's source on first use and bound through ``ctypes``.

What bounds it on the card: operations (the 16->16 layer's dw at the
training batch is about 3.3 TFLOP on the grid against under 2 GB of
inputs). The kernel is the folded GEMM of ``_dw_fold``: per ``(b, i, j)``
row and ``(di, dj)`` tap pair one ``[ks*ks*C, K*L] @ [K*L, O]`` product,
with a deterministic two-pass reduction across rows (no atomics; see the
source's header). bfloat16 (the training path) runs it on the tensor
cores (``mma.sync`` m16n8k16 bf16 x bf16 -> float32, the halo and g row
staged in bfloat16 by ``cp.async``, double-buffered; functions named
``bf16_tc``); float32 runs split-TF32 on the tensor cores (``mma.sync``
m16n8k8 .tf32, three products a term, x and g split once a call; the
function named ``tf32x3``), with the MMAs' sums drained into float32
registers every `DW_PARTIAL_K8` k8 step. Both stage a row in windows of
k-rows, so the shared memory does not grow with the grid: only a single
k-row too wide for a block is refused. Every odd ``ks`` and every channel
count is taken.

The wrapper takes CUDA tensors only: `ncnet_tpu_torch.ops.conv4d` routes
CPU tensors to the plain version, and nothing here falls back to it.
"""

import ctypes
import os

import torch

from ncnet_tpu_torch.kernels import _build

SOURCE = os.path.join(_build.CSRC, "conv4d_dw.cu")
#: k8 steps the float32 route's MMAs sum (rounding toward zero) before the
#: sum is added into its float32 accumulators, rounded to nearest:
#: ``kDrainK8`` in the source (each k-step's three products go into a zeroed
#: partial), the cadence ``tests/test_torch_tf32_split.py`` emulates
DW_PARTIAL_K8 = 1
#: bytes of split float32 copies (a float2 (hi, lo) a value, channel counts
#: past 1 padded to even) of x and g the float32 route holds at once:
#: ``kSplitBytes`` in the source. The batch is cut into groups of whole
#: samples under it (one at least), each split and run through pass 1 in
#: turn, so the workspace does not grow with the batch
DW_SPLIT_BYTES = 1 << 30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Conv4dWeightGradKernel:
    """Callable wrapper: ``kernel(x, g, ks) -> dw``.

    ``x``: CUDA ``[b, i, j, k, l, cin]`` float32 or bfloat16, contiguous;
    ``g``: ``[b, i, j, k, l, cout]`` of x's dtype, device and grid.
    Returns float32 ``[ks, ks, ks, ks, cin, cout]`` (odd ``ks``).

    ``launches`` counts the wrapper's launches (each runs the kernel's
    passes: for float32 the split, pass 1 and pass 2), and nothing else adds
    to it; ``launches_by_dtype`` counts the same launches by input dtype;
    ``pass1_launches`` the launches of pass 1 they made, as the library
    reports them (float32 runs the split and pass 1 once a group of
    samples, `DW_SPLIT_BYTES`; a library that reports none made one).
    """

    def __init__(self, source=SOURCE):
        self.launches = 0
        self.launches_by_dtype = {"float32": 0, "bfloat16": 0}
        self.pass1_launches = 0
        self._lib = _build.KernelLibrary(
            source, "conv4d_dw", "conv4d_dw",
            [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        )

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        return self._lib.load()

    def tensor_core_counts(self):
        """``{kernel function: HMMA/HGMMA count}`` of the built library, or
        None without ``cuobjdump``."""
        return self._lib.tensor_core_counts()

    @staticmethod
    def check(x, g, ks):
        """Raise ValueError/TypeError on inputs the kernel does not take."""
        if not x.is_cuda:
            raise ValueError(
                "conv4d dw kernel takes CUDA tensors; CPU tensors go through "
                "ncnet_tpu_torch.ops.conv4d.conv4d_dw_plain"
            )
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"conv4d dw kernel takes float32 or bfloat16, got {x.dtype}"
            )
        if x.dim() != 6 or g.dim() != 6 or x.shape[:5] != g.shape[:5]:
            raise ValueError(
                f"conv4d dw kernel takes x [b,i,j,k,l,cin] and g "
                f"[b,i,j,k,l,cout] on one grid; got {tuple(x.shape)} and "
                f"{tuple(g.shape)}"
            )
        if ks < 1 or ks % 2 == 0:
            raise ValueError(f"conv4d dw kernel takes an odd kernel size, got {ks}")
        if g.device != x.device or g.dtype != x.dtype:
            raise ValueError(
                f"g must share x's device and dtype ({x.device}, {x.dtype}); "
                f"got ({g.device}, {g.dtype})"
            )
        if not (x.is_contiguous() and g.is_contiguous()):
            raise ValueError("conv4d dw kernel takes contiguous x and g")
        if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
            raise ValueError(f"shape {tuple(x.shape)} exceeds int32 rows")

    def __call__(self, x, g, ks):
        self.check(x, g, ks)
        b, i, j, k, l, cin = x.shape
        cout = g.shape[5]
        dw = torch.empty((ks, ks, ks, ks, cin, cout), dtype=torch.float32,
                         device=x.device)
        args = (_DTYPE_CODES[x.dtype], b, i, j, k, l, cin, cout, ks)
        # [the partial buffer's floats, pass 1's launches]
        size = (ctypes.c_longlong * 2)(0, 1)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code, msg = self._lib.launch(
                x.data_ptr(), g.data_ptr(), None, dw.data_ptr(),
                size, *args, stream,
            )
            if code == 0:
                partial = torch.empty(size[0], dtype=torch.float32,
                                      device=x.device)
                code, msg = self._lib.launch(
                    x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), size, *args, stream,
                )
        if code != 0:
            raise RuntimeError(
                f"conv4d dw kernel launch failed (code {code}): {msg}; "
                f"x {tuple(x.shape)} {x.dtype}, g {tuple(g.shape)}, ks {ks}"
            )
        self.launches += 1
        self.launches_by_dtype[str(x.dtype).split(".")[1]] += 1
        self.pass1_launches += size[1]
        return dw


#: The one wrapper the port launches the kernel through.
conv4d_dw = Conv4dWeightGradKernel()
