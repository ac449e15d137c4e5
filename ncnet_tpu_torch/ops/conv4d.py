"""SAME, stride-1 4D convolution (semantics of ``ncnet_tpu/ops/conv4d.py``),
differentiable.

Each of its three functions has two versions:

* forward — `conv4d_plain` (a sum over the ``ki`` leading taps of
  ``F.conv3d`` over (j, k, l), as in the reference ``lib/conv4d.py``) and
  the hand kernel `ncnet_tpu_torch.kernels.conv4d.conv4d_fwd`;
* input gradient — `conv4d_dx_plain` (``conv4d_plain(g, flip(w)^T)``) and
  `ncnet_tpu_torch.kernels.conv4d.conv4d_dx` (the forward kernel on the
  same flipped, transposed filters);
* weight gradient — `conv4d_dw_plain` (the per-tap einsum of the JAX
  package's ``_dw_scan``) and the hand kernel
  `ncnet_tpu_torch.kernels.conv4d_dw.conv4d_dw`.

`conv4d` is a ``torch.autograd.Function`` that dispatches each of them on
the tensor's device only: CPU tensors take the plain versions, CUDA
tensors the kernels (which raise on what they do not take; nothing falls
back). The JAX package's many XLA lowerings (``conv4d_impl``) all compute
this same function, so the port keeps none of them.
"""

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd, flip_transpose
from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw


def _check(x, w):
    if x.dim() != 6 or w.dim() != 6:
        raise ValueError(
            f"conv4d takes x [b,i,j,k,l,cin] and w [ki,kj,kk,kl,cin,cout]; "
            f"got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if any(k % 2 == 0 for k in w.shape[:4]):
        raise ValueError(f"conv4d needs odd kernel sizes, got {tuple(w.shape[:4])}")
    if w.shape[4] != x.shape[5]:
        raise ValueError(
            f"weight cin {w.shape[4]} != activation channels {x.shape[5]}"
        )


def conv4d_plain(x, w, bias=None):
    """Plain PyTorch 4D convolution; same contract as `conv4d`.

    For each leading tap ``di`` one ``conv3d`` (SAME over j, k, l) of every
    input row ``ii`` gives its contribution to output row ``ii - di + p``;
    the shifted slabs are summed, and the bias is added once.
    """
    _check(x, w)
    b, ni, nj, nk, nl, cin = x.shape
    ki, kj, kk, kl, _, cout = w.shape
    p = ki // 2
    # [b*i, cin, j, k, l] for conv3d; weights [ki][cout, cin, kj, kk, kl]
    x3 = x.permute(0, 1, 5, 2, 3, 4).reshape(b * ni, cin, nj, nk, nl)
    w3 = w.permute(0, 5, 4, 1, 2, 3)
    out = torch.zeros((b, ni, cout, nj, nk, nl), dtype=x.dtype, device=x.device)
    for di in range(ki):
        s = di - p  # output row i reads input row i + s
        lo, hi = max(0, -s), min(ni, ni - s)
        if lo >= hi:
            continue
        y = F.conv3d(x3, w3[di], padding=(kj // 2, kk // 2, kl // 2))
        y = y.reshape(b, ni, cout, nj, nk, nl)
        out[:, lo:hi] += y[:, lo + s:hi + s]
    out = out.permute(0, 1, 3, 4, 5, 2)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


def conv4d_dx_plain(g, w):
    """Input gradient of `conv4d_plain` for the output cotangent ``g``:
    ``conv4d_plain(g, flip(w)^T)`` (exact for odd kernels with symmetric
    padding), in g's dtype."""
    return conv4d_plain(g, flip_transpose(w))


def conv4d_dw_plain(x, g, ks):
    """Weight gradient, float32 ``[ks,ks,ks,ks,cin,cout]``: for each tap the
    einsum ``bijklc,bijklo->co`` of the shifted zero-padded ``x`` with
    ``g``, products and sums in float32 (JAX's ``_dw_scan`` with
    ``preferred_element_type=float32``)."""
    if x.dim() != 6 or g.dim() != 6 or x.shape[:5] != g.shape[:5]:
        raise ValueError(
            f"conv4d dw takes x [b,i,j,k,l,cin] and g [b,i,j,k,l,cout] on "
            f"one grid; got {tuple(x.shape)} and {tuple(g.shape)}"
        )
    if ks % 2 == 0:
        raise ValueError(f"conv4d needs odd kernel sizes, got {ks}")
    b, ni, nj, nk, nl, cin = x.shape
    cout = g.shape[5]
    p = ks // 2
    xpad = F.pad(x.float(), (0, 0) + (p, p) * 4)
    gf = g.float().reshape(-1, cout)
    dw = torch.empty((ks, ks, ks, ks, cin, cout), dtype=torch.float32,
                     device=x.device)
    for di in range(ks):
        for dj in range(ks):
            for dk in range(ks):
                for dl in range(ks):
                    xs = xpad[:, di:di + ni, dj:dj + nj, dk:dk + nk, dl:dl + nl]
                    dw[di, dj, dk, dl] = xs.reshape(-1, cin).t() @ gf
    return dw


def _on(x, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.is_cuda:
        return kernel
    raise ValueError(f"conv4d runs on cpu or cuda tensors, got {x.device}")


class Conv4dFunction(torch.autograd.Function):
    """`conv4d` with its gradients: dx only where the input needs one (the
    correlation fed to the first NC layer depends on no parameter), dw in
    float32 rounded once to the weight's dtype, db the float32 sum of
    ``g`` (``jnp.sum(..., dtype=float32)`` in ``_vjp_bwd``) in the bias's
    dtype."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _on(x, conv4d_plain, conv4d_fwd)(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _on(g, conv4d_dx_plain, conv4d_dx)(g, w)
        if ctx.needs_input_grad[1]:
            dw = _on(x, conv4d_dw_plain, conv4d_dw)(x, g, w.shape[0]).to(w.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2, 3, 4), dtype=torch.float32)
            db = db.to(ctx.bias_dtype)
        return dx, dw, db


def conv4d(x, w, bias=None):
    """SAME, stride-1 4D convolution, differentiable in all three inputs.

    Args:
      x: ``[b, i, j, k, l, c_in]`` (channels-last: the same memory as the
        JAX package's packed ``[b, i, j, k*l*c_in]``).
      w: ``[ki, kj, kk, kl, c_in, c_out]`` (odd sizes; the kernel takes
        hypercubic ones).
      bias: optional ``[c_out]``, added once.

    Returns:
      ``[b, i, j, k, l, c_out]``.
    """
    _check(x, w)
    return Conv4dFunction.apply(x, w, bias)
