"""Submanifold neighbourhood consensus on a top-K correlation band
(``ncnet_tpu/sparse/nc.py``, forward).

Each layer is one fused gather + GEMM + bias + ReLU over the band's flat
entry list (`ncnet_tpu_torch.ops.band.band_conv_bias_relu`: the hand
kernel on the card). The symmetric term ``T(net(T(x)))`` runs the same
kernels over the swapped-tap pointer table, on the entries enumerated
B-major (a stable argsort of the B-indices), so no B-major band is built.
The pointer tables depend only on the band and each layer's kernel size:
they are built once per ``(kernel, swapped)`` and shared by the layers.
"""

import math

import torch

from ncnet_tpu_torch.ops.band import band_conv_bias_relu, band_neighbor_pointers

#: accepted ``band_impl`` values: both compute the same function here (a
#: CPU tensor takes the plain version, a CUDA tensor the kernel)
BAND_IMPLS = ("xla", "pallas")


def b_major_order(indices):
    """``(perm, inv)`` ``[b, N]``: the band's entries enumerated B-major (a
    stable argsort of the B-indices, so entries of one B-cell keep their
    A-major order) and the inverse permutation."""
    b = indices.shape[0]
    perm = torch.argsort(indices.reshape(b, -1), dim=-1, stable=True)
    return perm, torch.argsort(perm, dim=-1, stable=True)


def plain_pointers(indices, grid_b, kernel):
    """``[b, N, T]`` table of the plain pass, over the cell-major entries."""
    ptr = band_neighbor_pointers(indices, grid_b, kernel)
    return ptr.reshape(indices.shape[0], -1, math.prod(kernel))


def swapped_pointers(indices, grid_b, kernel, perm, inv):
    """``[b, N, T]`` table of the symmetric pass over the B-major entries
    ``perm``: the swapped-tap table's rows permuted, and its values (which
    address the cell-major list) remapped through ``inv``; the null slot
    ``N`` stays ``N``."""
    b, n = perm.shape
    ptr = band_neighbor_pointers(indices, grid_b, kernel, swapped=True)
    rows = ptr.reshape(b, n, -1).gather(
        1, perm[..., None].expand(-1, -1, math.prod(kernel)))
    remap = torch.cat(
        [inv.to(torch.int32),
         torch.full((b, 1), n, dtype=torch.int32, device=inv.device)], 1
    )
    return remap.gather(1, rows.reshape(b, -1).long()).reshape(rows.shape)


def sparse_neigh_consensus_apply(params, values, indices, grid_b,
                                 symmetric=True, band_impl="xla",
                                 layer=band_conv_bias_relu):
    """Filter a correlation band with the NC stack.

    Args:
      params: ``[{'kernel': [k,k,k,k,cin,cout], 'bias': [cout]}, ...]``,
        the dense stack's params, cast to the activation dtype.
      values: ``[b, hA, wA, K]`` band values.
      indices: ``[b, hA, wA, K]`` int32 sorted B-indices (`topk_band`).
      grid_b: ``(hB, wB)``.
      symmetric: add the transposed-pass term.
      band_impl: ``'xla'`` or ``'pallas'`` (the JAX package's two
        backends; the same function here). Anything else raises.
      layer: the band NC layer ``(x, w, bias, ptr) -> out`` (the
        dispatching `band_conv_bias_relu` by default; a check may pass the
        plain version to hold the kernel path against it).

    Returns:
      ``[b, hA, wA, K]`` filtered band on the same support.
    """
    if band_impl not in BAND_IMPLS:
        raise ValueError(f"band_impl={band_impl!r}: expected 'xla' or 'pallas'")
    dtype = values.dtype
    b, ha, wa, k = values.shape
    n = ha * wa * k
    tables = {}  # (kernel, swapped) -> [b, N, T], shared by the layers

    def net(x, swapped, table):
        for p in params:
            w = p["kernel"].to(dtype).contiguous()
            kernel = tuple(w.shape[:4])
            if (kernel, swapped) not in tables:
                tables[kernel, swapped] = table(kernel)
            x = layer(x, w, p["bias"].to(dtype), tables[kernel, swapped])
        return x

    x = values.reshape(b, n, 1).contiguous()
    out = net(x, False, lambda kern: plain_pointers(indices, grid_b, kern))

    if symmetric:
        perm, inv = b_major_order(indices)
        out2 = net(
            x.gather(1, perm[..., None]).contiguous(), True,
            lambda kern: swapped_pointers(indices, grid_b, kern, perm, inv),
        )
        out = out + out2.gather(1, inv[..., None].expand(-1, -1, out2.shape[2]))

    if out.shape[-1] != 1:
        raise ValueError("last NeighConsensus layer must have 1 output channel")
    return out[..., 0].reshape(b, ha, wa, k)
