"""SAME, stride-1 4D convolution (semantics of ``ncnet_tpu/ops/conv4d.py``).

Two versions of one function:

* `conv4d_plain` — plain PyTorch: a sum over the ``ki`` leading taps of
  ``F.conv3d`` over (j, k, l), as in the reference ``lib/conv4d.py``. The
  CPU path, and the version the hand kernel is held against on the card.
* the hand-written Hopper kernel (`ncnet_tpu_torch.kernels.conv4d`).

`conv4d` dispatches on the tensor's device only: a CPU tensor takes the
plain version, a CUDA tensor takes the kernel (which raises on what it does
not take; nothing falls back). The JAX package's many XLA lowerings
(``conv4d_impl``) all compute this same function, so the port keeps none of
them.
"""

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.kernels.conv4d import conv4d_fwd


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


def conv4d(x, w, bias=None):
    """SAME, stride-1 4D convolution.

    Args:
      x: ``[b, i, j, k, l, c_in]`` (channels-last: the same memory as the
        JAX package's packed ``[b, i, j, k*l*c_in]``).
      w: ``[ki, kj, kk, kl, c_in, c_out]`` (odd sizes; the kernel takes
        hypercubic ones).
      bias: optional ``[c_out]``, added once.

    Returns:
      ``[b, i, j, k, l, c_out]``.
    """
    if x.device.type == "cpu":
        return conv4d_plain(x, w, bias)
    if x.is_cuda:
        return conv4d_fwd(x, w, bias)
    raise ValueError(f"conv4d runs on cpu or cuda tensors, got {x.device}")
