"""Submanifold neighbourhood consensus on a top-K correlation band
(``ncnet_tpu/sparse/nc.py``, forward).

Each layer is one fused neighbour gather + GEMM + bias + ReLU over the
band's flat entry list (`ncnet_tpu_torch.ops.band.band_layer`: the hand
kernel on the card). The symmetric term ``T(net(T(x)))`` runs the same
layers with the A/B tap roles swapped, on the entries enumerated B-major
(a stable argsort of the B-indices), so no B-major band is built. Each
pass hands its layers a `BandGeometry` (the band's indices, the B grid,
and on the symmetric pass the B-major order): the card's kernel derives
each entry's neighbours from it, and the plain version builds its pointer
tables from it once per kernel size.
"""

from ncnet_tpu_torch.ops.band import BandGeometry, b_major_order, band_layer

#: accepted ``band_impl`` values: both compute the same function here (a
#: CPU tensor takes the plain version, a CUDA tensor the kernel)
BAND_IMPLS = ("xla", "pallas")


def sparse_neigh_consensus_apply(params, values, indices, grid_b,
                                 symmetric=True, band_impl="xla",
                                 layer=band_layer):
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
      layer: the band NC layer ``(x, w, bias, geom) -> out`` (the
        dispatching `band_layer` by default; a check may pass the plain
        version to hold the kernel path against it).

    Returns:
      ``[b, hA, wA, K]`` filtered band on the same support.
    """
    if band_impl not in BAND_IMPLS:
        raise ValueError(f"band_impl={band_impl!r}: expected 'xla' or 'pallas'")
    dtype = values.dtype
    b, ha, wa, k = values.shape
    n = ha * wa * k

    def net(x, geom):
        for p in params:
            x = layer(x, p["kernel"].to(dtype).contiguous(),
                      p["bias"].to(dtype), geom)
        return x

    x = values.reshape(b, n, 1).contiguous()
    out = net(x, BandGeometry(indices, grid_b))

    if symmetric:
        perm, inv = b_major_order(indices)
        out2 = net(x.gather(1, perm[..., None]).contiguous(),
                   BandGeometry(indices, grid_b, perm, inv))
        out = out + out2.gather(1, inv[..., None].expand(-1, -1, out2.shape[2]))

    if out.shape[-1] != 1:
        raise ValueError("last NeighConsensus layer must have 1 output channel")
    return out[..., 0].reshape(b, ha, wa, k)
