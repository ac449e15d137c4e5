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
  FFMA on the CUDA cores for the layers the rule keeps there (one input or
  one output channel; the source's ``f32_route`` says why), in two
  kernels: ``conv4d_fwd_ffma_c1`` (``cin == 1``: a thread owns 4 or 5
  outputs along ``l`` x 16 output channels, its input window in
  registers) and ``conv4d_fwd_ffma_o1`` (``cout == 1``: a thread owns 4
  or 5 outputs along ``l`` and a kernel row's weights in registers, and
  reads each staged activation once for every output it is a tap of).
  `ffma_plan` mirrors their tile plan.

The FFMA kernels keep each output's chain: one thread sums one ``fmaf``
chain from +0 in ``(di, dj, dk, dl, c)`` order over the taps whose input
row lies on the grid, and adds the bias last. Terms whose input lies in the
zero halo (or in a zero-padded channel) add ``+0 * w`` and leave the sum's
bits as they are, so the kernels are bitwise equal to `chain_oracle`, a
naive CUDA function (one thread an output, every tap) that the tests hold
them to and that nothing on the main path launches.

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
#: shared memory a block may opt into on an H100 (sm_90)
H100_BLOCK_SMEM = 232448
#: the FFMA plan's constants (``csrc/conv4d_fwd.cu``)
FFMA_MAX_THREADS = 256
FFMA_GROUP_TARGET = 128
#: `ffma_plan`'s keys, in the order ``conv4d_fwd_ffma_plan`` fills them
FFMA_PLAN_KEYS = ("o1", "KS", "R", "W", "rec", "C4p", "tile", "n_tiles", "S",
                  "G", "n_seg", "OT", "x_floats", "w_floats", "threads",
                  "blocks", "smem", "n_items")


def float32_route(cin, cout):
    """The float32 route of a ``cin -> cout`` layer: ``"tf32x3"``
    (split-TF32 on the tensor cores) or ``"ffma"`` (the CUDA cores).

    Mirrors ``f32_route`` in ``csrc/conv4d_fwd.cu``, which alone decides:
    a shape rule, never a retry after a failed build or launch.
    """
    return "tf32x3" if cin >= 2 and cout >= 2 else "ffma"


def _ceil(a, b):
    return -(-a // b)


def ffma_plan(shape, ks, cin, cout, max_smem=H100_BLOCK_SMEM):
    """The FFMA route's plan of a float32 ``cin -> cout`` layer on ``x``
    of ``shape`` ``[b, i, j, k, l]`` (``cin == 1`` or ``cout == 1``), as
    ``plan_ffma`` in ``csrc/conv4d_fwd.cu`` makes it: a dict of
    `FFMA_PLAN_KEYS`, or ValueError where a block's ``max_smem`` bytes of
    shared memory cannot hold a tile.

    ``o1``: the kernel (1: ``conv4d_fwd_ffma_o1``, ``cout == 1``; 0:
    ``conv4d_fwd_ffma_c1``); ``KS``: its unrolled kernel size (0: any);
    ``R``: outputs a thread along ``l``, ``n_seg`` segments of ``R`` a k
    row; ``W`` and ``rec``: columns and floats a position of a staged halo
    row (o1: ``rec = 4 * C4p`` channels, zero-padded); ``tile``: k rows a
    group's tile, ``n_tiles`` a ``(b, i, j)`` row; ``S``: threads a group,
    ``G`` groups a block; ``OT``: output channels a block (c1);
    ``x_floats``, ``w_floats``: a group's halo buffer and a weight slice
    (c1 double-buffers both, o1 stages one of each); ``threads``,
    ``blocks``, ``smem`` (bytes) of the launch; ``n_items``: groups in all.
    """
    if float32_route(cin, cout) != "ffma":
        raise ValueError(f"{cin} -> {cout} is not on the FFMA route")
    b, ni, nj, nk, nl = shape
    p, taps = ks // 2, ks * ks
    unrolled = ks in (3, 5)
    plan = dict.fromkeys(FFMA_PLAN_KEYS, 0)
    # R = 5 or 4 outputs a thread along l, whichever pads the row less (5
    # on a tie); W odd, so lanes down k read distinct banks
    r = 5 if _ceil(nl, 5) * 5 <= _ceil(nl, 4) * 4 else 4
    plan.update(o1=int(cin >= 2), R=r, n_seg=_ceil(nl, r))
    if plan["n_seg"] > FFMA_MAX_THREADS:
        raise ValueError("the staged halo and weights exceed the block's "
                         "shared memory")
    plan["W"] = (plan["n_seg"] * r + 2 * p) | 1
    # C == 1 double-buffers its rows and weights, O == 1 stages one of each
    buffers = 1 if plan["o1"] else 2
    if cin == 1:
        plan.update(KS=ks if unrolled else 0, OT=4 if cout <= 4 else
                    8 if cout <= 8 else 16, rec=1)
    else:
        reg = unrolled and cin <= 16
        c4p = 4 if reg else _ceil(_ceil(cin, 4), 4) * 4
        plan.update(KS=ks if reg else 0, C4p=c4p, rec=4 * c4p, OT=1)
    plan["w_floats"] = _ceil(taps * plan["OT"] * plan["rec"], 4) * 4

    def x_floats(rows):
        return _ceil((rows + 2 * p) * plan["W"] * plan["rec"], 4) * 4

    # k rows a tile: as many as the block's threads and shared memory take
    tile = min(nk, FFMA_MAX_THREADS // plan["n_seg"])
    while (tile > 0 and 4 * buffers * (x_floats(tile) + plan["w_floats"])
           > max_smem):
        tile -= 1
    if tile == 0:
        raise ValueError("the staged halo and weights exceed the block's "
                         "shared memory")
    n_tiles = _ceil(nk, tile)
    tile = _ceil(nk, n_tiles)
    plan.update(tile=tile, n_tiles=n_tiles, x_floats=x_floats(tile),
                S=tile * plan["n_seg"])
    plan["n_items"] = b * ni * nj * plan["n_tiles"]
    group_bytes = 4 * buffers * plan["x_floats"]
    w_bytes = 4 * buffers * plan["w_floats"]
    g = max(1, min(FFMA_GROUP_TARGET // plan["S"], plan["n_items"]))
    while g > 1 and w_bytes + g * group_bytes > max_smem:
        g -= 1
    plan.update(G=g, smem=w_bytes + g * group_bytes,
                threads=_ceil(g * plan["S"], 32) * 32,
                blocks=_ceil(plan["n_items"], g))
    return plan


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
    else adds to it. ``source``: the ``.cu`` file to build (another
    revision of ``csrc/conv4d_fwd.cu``, to compare two builds).
    """

    def __init__(self, source=SOURCE):
        self.launches = 0
        self._lib = _build.KernelLibrary(
            source, "conv4d", "conv4d_fwd",
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

    def ffma_plan(self, shape, ks, cin, cout, max_smem=H100_BLOCK_SMEM):
        """The built launcher's FFMA plan (``conv4d_fwd_ffma_plan``) as a
        dict of `FFMA_PLAN_KEYS`; `ffma_plan` is its Python mirror."""
        self.load()
        fn = ctypes.CDLL(self._lib.path).conv4d_fwd_ffma_plan
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * len(FFMA_PLAN_KEYS))()
        code = fn(*shape, cin, cout, ks, max_smem, ctypes.addressof(out))
        if code != 0:
            raise ValueError(f"no FFMA plan (code {code}) for {cin} -> {cout}"
                             f" on {tuple(shape)}, ks {ks}")
        return dict(zip(FFMA_PLAN_KEYS, out))

    def chain_oracle(self, x, w, bias=None):
        """The test-only chain oracle (``conv4d_fwd_chain_oracle``): one
        CUDA thread an output sums every ``(di, dj, dk, dl, c)`` tap with
        ``fmaf`` from +0 (0 where the input lies off the grid), then adds
        the bias. float32 only; not counted in `launches`, and nothing on
        the main path calls it."""
        self.check(x, w, bias)
        if x.dtype != torch.float32:
            raise TypeError(f"the chain oracle takes float32, got {x.dtype}")
        self.load()
        fn = ctypes.CDLL(self._lib.path).conv4d_fwd_chain_oracle
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        b, i, j, k, l, cin = x.shape
        cout = w.shape[5]
        if bias is None:
            bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
        bias = bias.to(torch.float32).contiguous()
        out = torch.empty((b, i, j, k, l, cout), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                      out.data_ptr(), b, i, j, k, l, cin, cout, w.shape[0],
                      stream)
        if code != 0:
            raise RuntimeError(f"chain oracle launch failed (code {code})")
        return out

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
