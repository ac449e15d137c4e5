"""Top-K correlation band: selection, neighbour pointers, gathers, and the
band NC layer (semantics of ``ncnet_tpu/ops/band.py``).

Representation, as in the JAX package:

  values  ``[b, hA, wA, K]``        band entry values
  indices ``[b, hA, wA, K]`` int32  flattened B-grid index ``iB * wB + jB``,
                                    sorted ascending per A-cell

At ``K = hB*wB`` the band is the dense correlation row in row-major order.
Neighbour reads that fall off the A grid, off the B grid or off the band
resolve to the null slot ``N = hA*wA*K`` and read exact zeros.

The band NC layer ``relu(bias + sum_t x[nbr(n, t)] @ w[t])`` and each of
its gradients have two versions over a `BandGeometry`, as
`ncnet_tpu_torch.ops.conv4d` has:

* forward — `band_layer_plain` (the neighbour pointer table,
  `band_neighbor_pointers`, built once per kernel size and cached on the
  geometry, then gather and ``torch.matmul``) and the hand-written Hopper
  kernel `ncnet_tpu_torch.kernels.band_gemm.band_gemm_fwd`, which derives
  each entry's neighbours from the band's indices and builds no table
  (`band_taps` mirrors its derivation in plain PyTorch for the tests);
* input gradient — `band_dx_plain` (the same gather-GEMM of the masked
  cotangent with ``flip(w)^T`` over the same table) and
  `ncnet_tpu_torch.kernels.band_gemm.band_gemm_dx` over the geometry's
  hit list (`band_dx_hits_plain` mirrors its order of work for the
  tests);
* weight gradient — `band_dw_plain` (a per-tap gather and product over the
  table, float32) and `ncnet_tpu_torch.kernels.band_gemm_dw.band_gemm_dw`
  over the same hit list (`band_hits_plain` mirrors it for the tests).

`band_layer` is `BandLayerFunction`, which dispatches each of them on the
tensor's device only: a CPU tensor takes the plain versions, a CUDA tensor
the kernels (which raise on what they do not take; nothing falls back).
"""

import math

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.kernels.band_gemm import band_gemm_dx, band_gemm_fwd
from ncnet_tpu_torch.kernels.band_gemm_dw import (
    BandHits,
    band_gemm_dw,
    cell_major,
    pass_order,
)
from ncnet_tpu_torch.kernels.conv4d import flip_transpose

#: the largest B grid the mutual rank key ``min(ra, rb) * nb + ra`` takes
#: in int32 (the JAX package's guard)
MUTUAL_MAX_NB = 46340


def _ranks_descending(x):
    """Per-row dense ranks along the last axis (0 = largest); ties rank in
    index order (the JAX package's stable ``argsort``)."""
    order = torch.argsort(-x, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def topk_band(scores, k, values_from=None, mutual=False):
    """Select the per-A-cell top-K band from a dense correlation.

    ``scores`` ``[b, hA, wA, hB, wB]`` are the selection scores;
    ``values_from`` (default ``scores``) the tensor the band values are
    read from. ``mutual=False``: the plain per-A top-K, ties to the lower
    B-index (as ``lax.top_k``). ``mutual=True``: the key is the symmetric
    rank ``min(rank within the A-row, rank within the B-column)``, ties
    broken by the within-row rank. Returns ``(values, indices int32)``,
    indices sorted ascending per A-cell.
    """
    b, ha, wa, hb, wb = scores.shape
    nb = hb * wb
    k = int(k)
    if not 1 <= k <= nb:
        raise ValueError(
            f"band width k={k} must be in [1, hB*wB={nb}] "
            f"for a {hb}x{wb} B grid"
        )
    flat = scores.reshape(b, ha, wa, nb)
    if mutual:
        if nb > MUTUAL_MAX_NB:
            raise ValueError(
                f"mutual band selection needs nb=hB*wB <= {MUTUAL_MAX_NB} "
                f"(int32 rank key), got {nb}; use mutual=False at this grid "
                "size"
            )
        rank_a = _ranks_descending(flat)
        cols = scores.reshape(b, ha * wa, nb).transpose(1, 2)
        rank_b = _ranks_descending(cols).transpose(1, 2).reshape(b, ha, wa, nb)
        # unique per row (rank_a is a permutation), so the k smallest keys
        # are one set whatever the sort does with ties
        key = torch.minimum(rank_a, rank_b) * nb + rank_a
        idx = torch.argsort(key, dim=-1, stable=True)[..., :k]
    else:
        idx = torch.argsort(flat, dim=-1, descending=True, stable=True)[..., :k]
    idx = torch.sort(idx, dim=-1).values
    source = flat if values_from is None else values_from.reshape(b, ha, wa, nb)
    return source.gather(-1, idx), idx.to(torch.int32)


def band_to_dense(values, indices, grid_b, fill=0.0):
    """The band as the dense ``[b, hA, wA, hB, wB]`` tensor; off-band cells
    read ``fill``."""
    b, ha, wa, k = values.shape
    hb, wb = grid_b
    dense = torch.full((b, ha * wa, hb * wb), fill, dtype=values.dtype,
                       device=values.device)
    dense.scatter_(2, indices.reshape(b, ha * wa, k).long(),
                   values.reshape(b, ha * wa, k))
    return dense.reshape(b, ha, wa, hb, wb)


def band_coverage(indices, grid_b):
    """Bool ``[b, hB, wB]``: the B cells some band entry lands on (every
    cell at ``K = hB*wB``)."""
    b = indices.shape[0]
    hb, wb = grid_b
    covered = torch.zeros((b, hb * wb), dtype=torch.bool, device=indices.device)
    covered.scatter_(1, indices.reshape(b, -1).long(), True)
    return covered.reshape(b, hb, wb)


def band_neighbor_pointers(indices, grid_b, kernel, swapped=False):
    """Flat gather pointers from each band entry to its 4D-conv neighbours:
    ``[b, hA, wA, K, T]`` int32, ``T = k1*k2*k3*k4``, taps row-major over
    ``kernel``; a read off the A grid, off the B grid or off the band is
    the null slot ``hA*wA*K``.

    ``swapped=False`` offsets A by ``(d1, d2)`` and B by ``(d3, d4)``;
    ``swapped=True`` inverts the roles, so the same flattened kernel over
    this table computes the transposed term of the symmetric pass.

    Membership of each neighbour B-index in the neighbouring A-cell's
    sorted band row is one ``searchsorted`` over all A-taps at once (the
    JAX package broadcasts an equality test instead; the tables are
    equal). Its transient is ``[b, hA, wA, kA, K*kB]`` int64.
    """
    k1, k2, k3, k4 = (int(s) for s in kernel)
    b, ha, wa, kslots = indices.shape
    hb, wb = grid_b
    null = ha * wa * kslots
    if swapped:
        ka_i, ka_j, kb_i, kb_j = k3, k4, k1, k2
    else:
        ka_i, ka_j, kb_i, kb_j = k1, k2, k3, k4
    pa_i, pa_j = ka_i // 2, ka_j // 2
    pb_i, pb_j = kb_i // 2, kb_j // 2
    ka, kb = ka_i * ka_j, kb_i * kb_j
    dev = indices.device
    idx = indices.long()

    # B targets of every band entry: [b, hA, wA, K, kB]
    ib, jb = idx // wb, idx % wb
    tb_i = ib[..., None, None] + (torch.arange(kb_i, device=dev) - pb_i)[:, None]
    tb_j = jb[..., None, None] + (torch.arange(kb_j, device=dev) - pb_j)[None, :]
    valid_b = ((tb_i >= 0) & (tb_i < hb) & (tb_j >= 0) & (tb_j < wb))
    target = (tb_i * wb + tb_j).reshape(b, ha, wa, 1, kslots * kb)
    valid_b = valid_b.reshape(b, ha, wa, 1, kslots * kb)

    # the band row of every A-neighbour: [b, hA, wA, kA, K]; off the A grid
    # the row is -1, which no target (>= 0 where valid) matches
    idx_pad = F.pad(idx, (0, 0, pa_j, pa_j, pa_i, pa_i), value=-1)
    nbr = idx_pad.unfold(1, ka_i, 1).unfold(2, ka_j, 1)  # [b,hA,wA,K,ka_i,ka_j]
    nbr = nbr.permute(0, 1, 2, 4, 5, 3).reshape(b, ha, wa, ka, kslots)

    target = target.expand(b, ha, wa, ka, kslots * kb).contiguous()
    slot = torch.searchsorted(nbr.contiguous(), target).clamp_(max=kslots - 1)
    found = nbr.gather(-1, slot) == target

    ia = torch.arange(ha, device=dev)[:, None, None, None]
    ja = torch.arange(wa, device=dev)[None, :, None, None]
    ni = ia + (torch.arange(ka_i, device=dev) - pa_i)[:, None]  # [hA,1,ka_i,1]
    nj = ja + (torch.arange(ka_j, device=dev) - pa_j)[None, :]  # [1,wA,1,ka_j]
    valid_a = ((ni >= 0) & (ni < ha) & (nj >= 0) & (nj < wa)).reshape(ha, wa, ka, 1)
    base = ((ni * wa + nj) * kslots).reshape(ha, wa, ka, 1)
    ptr = torch.where(found & valid_b & valid_a, base + slot, null)
    ptr = ptr.reshape(b, ha, wa, ka, kslots, kb).permute(0, 1, 2, 4, 3, 5)
    if swapped:
        # assembled A-offset-major; the tap order is (d1..d4) row-major,
        # which is B-offset-major here
        ptr = ptr.transpose(4, 5)
    return ptr.reshape(b, ha, wa, kslots, k1 * k2 * k3 * k4).to(torch.int32)


def band_gather_neighbors(x_entries, ptr):
    """``[b, N, c]`` entries and ``[b, N, T]`` pointers -> ``[b, N, T*c]``
    (tap-major, channel-minor: the rows of ``w.reshape(T*c, cout)``); the
    null pointer ``N`` reads zeros."""
    b, n, c = x_entries.shape
    t = ptr.shape[-1]
    x_pad = torch.cat([x_entries, x_entries.new_zeros(b, 1, c)], dim=1)
    rows = torch.arange(b, device=ptr.device)[:, None]
    return x_pad[rows, ptr.reshape(b, n * t).long()].reshape(b, n, t * c)


def band_conv_gemm(x_entries, w, ptr):
    """One submanifold conv pass: neighbour gather + one GEMM, no bias; the
    product in the activation dtype."""
    cout = w.shape[-1]
    g = band_gather_neighbors(x_entries, ptr)
    return torch.matmul(g, w.reshape(-1, cout).to(x_entries.dtype))


def band_conv_bias_relu_plain(x_entries, w, bias, ptr):
    """Plain PyTorch band NC layer over a pointer table ``ptr`` ``[b, N,
    T]`` int32 (null pointer N): ``relu(gather(x, ptr) @ w_flat + bias)``,
    bias added in the activation dtype."""
    y = band_conv_gemm(x_entries, w, ptr)
    return torch.relu(y + bias.to(x_entries.dtype))


def b_major_order(indices):
    """``(perm, inv)`` ``[b, N]`` int64: the band's entries enumerated
    B-major (a stable argsort of the B-indices, so entries of one B-cell
    keep their A-major order) and the inverse permutation."""
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
        1, perm.long()[..., None].expand(-1, -1, math.prod(kernel)))
    remap = torch.cat(
        [inv.to(torch.int32),
         torch.full((b, 1), n, dtype=torch.int32, device=inv.device)], 1
    )
    return remap.gather(1, rows.reshape(b, -1).long()).reshape(rows.shape)


def band_taps(indices, grid_b, kernel, swapped=False):
    """The band kernel's tap derivation in plain PyTorch: every neighbour
    read of the pass that lands on the band, as ``(batch, entry, tap,
    slot)`` int64 ``[nnz]`` each, in the kernel's order (by entry, then
    A-offset, then the neighbour cell's slot).

    Entry ``e = (a, s)`` with B cell ``beta = indices[a, s]`` reads, at tap
    ``t`` (row-major over ``kernel``), slot ``s'`` of A cell ``a + dA``
    when that slot's B cell lies at ``beta + dB``; ``swapped`` takes dA
    from ``(d3, d4)`` and dB from ``(d1, d2)``. Entries and slots are
    cell-major; the symmetric pass relabels them through `b_major_order`
    (row ``n`` is entry ``perm[n]``, slot ``m`` is read at ``inv[m]``).
    These are exactly the non-null entries of `band_neighbor_pointers`.
    The transient is ``[b, hA, wA, K, kA, K]``.

    A test oracle: no path of the port runs it. The tests hold it bitwise
    against JAX's pointer tables; the card's tests hold the kernel itself
    against `band_layer_plain`.
    """
    k1, k2, k3, k4 = (int(s) for s in kernel)
    b, ha, wa, k = indices.shape
    wb = int(grid_b[1])
    ka_i, ka_j, kb_i, kb_j = (k3, k4, k1, k2) if swapped else (k1, k2, k3, k4)
    dev = indices.device
    idx = indices.long()
    # the band rows of every A-neighbour: [b, hA, wA, kA, K]; -1 off the grid
    pad = F.pad(idx, (0, 0, ka_j // 2, ka_j // 2, ka_i // 2, ka_i // 2), value=-1)
    nbr = pad.unfold(1, ka_i, 1).unfold(2, ka_j, 1)  # [b, hA, wA, K, ka_i, ka_j]
    nbr = nbr.permute(0, 1, 2, 4, 5, 3).reshape(b, ha, wa, 1, ka_i * ka_j, k)
    # the B offset of each neighbour slot against each entry: [.., K, kA, K]
    me = idx[..., None, None]
    dbi = torch.div(nbr, wb, rounding_mode="floor") - me // wb + kb_i // 2
    dbj = nbr % wb - me % wb + kb_j // 2
    hit = ((nbr >= 0) & (dbi >= 0) & (dbi < kb_i) & (dbj >= 0) & (dbj < kb_j))
    bi, ia, ja, s, da, slot = hit.nonzero(as_tuple=True)
    dbi, dbj = dbi[hit], dbj[hit]
    dai, daj = da // ka_j, da % ka_j
    if swapped:
        tap = ((dbi * kb_j + dbj) * ka_i + dai) * ka_j + daj
    else:
        tap = ((dai * ka_j + daj) * kb_i + dbi) * kb_j + dbj
    cell = ((ia + dai - ka_i // 2) * wa + ja + daj - ka_j // 2) * k + slot
    return bi, (ia * wa + ja) * k + s, tap, cell


def band_hits_plain(indices, grid_b, kernel, inv=None):
    """The hit list of the backward kernels in plain PyTorch (a test
    oracle, no path runs it): `band_taps` of the pass (the symmetric pass
    with ``inv`` given) sorted stably by tap (so by output block, then
    slot, within a tap), entries cell-major and flattened over the batch;
    with int64 offsets of every tap and every (tap, block) run. Equal,
    element for element, to `BandGemmWeightGradKernel.hit_list`."""
    kernel = tuple(int(d) for d in kernel)
    b, ha, wa, k = indices.shape
    n = ha * wa * k
    taps, nblk = math.prod(kernel), b * ha * wa
    bi, entry, tap, cell = band_taps(indices, grid_b, kernel,
                                     swapped=inv is not None)
    runs = torch.bincount(tap * nblk + bi * (ha * wa) + entry // k,
                          minlength=taps * nblk)
    block_start = torch.cat([runs.new_zeros(1), runs.cumsum(0)])
    perm = None
    if inv is not None:
        inv = inv.to(torch.int32)
        perm = torch.argsort(inv.long(), dim=1).to(torch.int32)
    order = torch.argsort(tap, stable=True)
    return BandHits(block_start[::nblk].clone(),
                    (bi * n + entry)[order].to(torch.int32),
                    (bi * n + cell)[order].to(torch.int32), kernel,
                    block_start, (b, ha, wa, k), inv, perm)


def tap_a_shifts(kernel, swapped=False):
    """``[T, 2]`` int64: the A-grid shift ``(di, dj)`` of each tap of the
    pass (row-major over ``kernel``; the A offsets are ``(d1, d2)``, or
    ``(d3, d4)`` on the symmetric pass, less the kernel's half-width). The
    hits of tap t from output A cell a read input rows of A cell a +
    shift."""
    kernel = tuple(int(d) for d in kernel)
    d = torch.stack(torch.meshgrid(*(torch.arange(s) for s in kernel),
                                   indexing="ij"), -1).reshape(-1, 4)
    a = slice(2, 4) if swapped else slice(0, 2)
    return d[:, a] - torch.tensor(kernel[a]) // 2


def band_dx_hits_plain(gp, w, hits):
    """The input-gradient kernel's order of work in plain PyTorch (a test
    oracle, no path runs it; `band_dx_plain` is the reference): ``gp`` in
    the pass's order, gathered cell-major (`cell_major`); for each input A
    cell a' of each sample, the taps in order, each tap's run (t, block a'
    - shift_A(t)) of ``hits`` (`band_hits_plain` or the card's list, read
    through its per-(tap, block) offsets) adds each hit's ``gp[n] @
    w[t]^T`` at the slot of its input entry m within cell a', in float32;
    every row of the cell is written once, rounded once to gp's dtype, and
    the result returned in the pass's order. Raises AssertionError where a
    run's input entries leave its cell."""
    b, ha, wa, k = hits.band
    n_rows = ha * wa * k
    taps, nblk = math.prod(hits.kernel), b * ha * wa
    cin, cout = w.shape[4:]
    wt = w.reshape(taps, cin, cout).float()
    g = cell_major(gp, hits).reshape(-1, cout).float()
    acc = torch.zeros(b, ha, wa, k, cin)  # [b, a', slot, c]
    shifts = tap_a_shifts(hits.kernel, hits.inv is not None)
    ia1 = torch.arange(ha)[:, None].expand(ha, wa)
    ja1 = torch.arange(wa)[None, :].expand(ha, wa)
    local = torch.arange(b * n_rows) % n_rows  # entries are cell-major
    for t in range(taps):
        ia, ja = ia1 - shifts[t, 0], ja1 - shifts[t, 1]
        on = (ia >= 0) & (ia < ha) & (ja >= 0) & (ja < wa)
        cells = torch.nonzero(on)  # output cells a' whose run exists
        if not len(cells):
            continue
        bb = torch.arange(b).repeat_interleave(len(cells))
        ci, cj = cells[:, 0].repeat(b), cells[:, 1].repeat(b)
        blk = t * nblk + bb * (ha * wa) + (ci - shifts[t, 0]) * wa + cj - shifts[t, 1]
        lo, hi = hits.block_start[blk], hits.block_start[blk + 1]
        size = hi - lo
        which = torch.repeat_interleave(torch.arange(len(blk)), size)
        h = (torch.repeat_interleave(lo - (size.cumsum(0) - size), size)
             + torch.arange(int(size.sum())))
        m, nn = hits.m[h].long(), hits.n[h].long()
        slot = local[m] - (ci * wa + cj)[which] * k
        assert bool(((slot >= 0) & (slot < k)).all()), "a run left its cell"
        acc[bb[which], ci[which], cj[which], slot] += g[nn] @ wt[t].t()
    return pass_order(acc.reshape(b, n_rows, cin).to(gp.dtype), hits)


class BandGeometry:
    """What one pass of the band NC stack reads besides its entries: the
    band's sorted B-indices ``[b, hA, wA, K]`` int32 and the B grid, and
    for the symmetric pass the B-major order (``perm``, ``inv`` from
    `b_major_order`; kept as int32, the kernel's index type).

    The plain versions' pointer tables and the backward kernels' hit lists
    are built on first use, once per kernel size, and cached here; the
    card's forward kernel builds neither.
    """

    def __init__(self, indices, grid_b, perm=None, inv=None):
        if (perm is None) != (inv is None):
            raise ValueError("a band pass takes perm and inv together or neither")
        self.indices = indices
        self.grid_b = (int(grid_b[0]), int(grid_b[1]))
        self.perm = None if perm is None else perm.to(torch.int32).contiguous()
        self.inv = None if inv is None else inv.to(torch.int32).contiguous()
        self._tables = {}
        self._hits = {}

    @property
    def swapped(self):
        """True on the symmetric pass (swapped taps, B-major entries)."""
        return self.perm is not None

    def pointers(self, kernel):
        """The pass's ``[b, N, T]`` int32 pointer table for ``kernel``
        (``(k1, k2, k3, k4)``); the null pointer is N."""
        kernel = tuple(int(d) for d in kernel)
        if kernel not in self._tables:
            self._tables[kernel] = (
                swapped_pointers(self.indices, self.grid_b, kernel,
                                 self.perm, self.inv)
                if self.swapped
                else plain_pointers(self.indices, self.grid_b, kernel))
        return self._tables[kernel]

    def hits(self, kernel):
        """The pass's `BandHits` for ``kernel`` from the card's hit-list
        kernel (`BandGemmWeightGradKernel.hit_list`), shared by the dx and
        dw of every layer of that kernel size."""
        kernel = tuple(int(d) for d in kernel)
        if kernel not in self._hits:
            self._hits[kernel] = band_gemm_dw.hit_list(
                self.indices, self.grid_b, kernel, self.inv)
        return self._hits[kernel]


def band_layer_plain(x_entries, w, bias, geom):
    """Plain PyTorch band NC layer over the geometry's (cached) pointer
    table; same contract as `band_layer`."""
    return band_conv_bias_relu_plain(x_entries, w, bias,
                                     geom.pointers(w.shape[:4]))


def band_dx_plain(gp, w, geom):
    """Input gradient of a band NC layer for its ReLU-masked output
    cotangent ``gp`` ``[b, N, c_out]``: the gather-GEMM of ``gp`` with
    ``flip(w)^T`` over the same pointer table (the neighbour relation is
    symmetric within a pass; odd kernels only), in gp's dtype."""
    return band_conv_gemm(gp, flip_transpose(w), geom.pointers(w.shape[:4]))


def band_dw_plain(x_entries, gp, geom, kernel):
    """Weight gradient of a band NC layer, float32 ``[k1, k2, k3, k4, c_in,
    c_out]``: for each tap the entries' neighbours at that tap (zeros off
    the band) gathered through the pointer table, times ``gp``, products
    and sums in float32. One tap at a time, so no ``[b, N, T*c_in]``
    gather exists."""
    kernel = tuple(int(d) for d in kernel)
    ptr = geom.pointers(kernel)
    b, n, cin = x_entries.shape
    cout = gp.shape[2]
    x_pad = torch.cat([x_entries.float(), x_entries.new_zeros(b, 1, cin,
                                                               dtype=torch.float32)], 1)
    g = gp.float().reshape(b * n, cout)
    rows = torch.arange(b, device=ptr.device)[:, None]
    dw = torch.empty((ptr.shape[2], cin, cout), dtype=torch.float32,
                     device=x_entries.device)
    for t in range(ptr.shape[2]):
        dw[t] = x_pad[rows, ptr[:, :, t].long()].reshape(b * n, cin).t() @ g
    return dw.reshape(*kernel, cin, cout)


def _on_card(x):
    """True for a CUDA tensor (the kernels), False for a CPU tensor (the
    plain versions); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band layer runs on cpu or cuda tensors, got {x.device}")
    return x.is_cuda


class BandLayerFunction(torch.autograd.Function):
    """`band_layer` with its gradients (the JAX package's
    ``band_gemm_pallas.py::_bwd``): the ReLU mask from the saved output,
    ``gp = gy * (out > 0)``; dx only where the entries need one (layer 1
    reads the band values, which depend on no parameter); dw rounded once
    to w's dtype; db the float32 sum of ``gp`` in the bias's dtype."""

    @staticmethod
    def forward(ctx, x_entries, w, bias, geom):
        if _on_card(x_entries):
            out = band_gemm_fwd(x_entries, w, bias, geom.indices, geom.grid_b,
                                geom.inv)
        else:
            out = band_layer_plain(x_entries, w, bias, geom)
        ctx.save_for_backward(x_entries, w, out)
        ctx.geom = geom
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w, out = ctx.saved_tensors
        geom = ctx.geom
        # the cotangent may arrive as a gather's or an expand's view
        gp = torch.where(out > 0, gy, 0).contiguous()
        dx = dw = db = None
        card = _on_card(gp)
        # the pass's hit list, built once before the first of dx and dw
        hits = (geom.hits(w.shape[:4])
                if card and any(ctx.needs_input_grad[:2]) else None)
        if ctx.needs_input_grad[0]:
            dx = (band_gemm_dx(gp, w, hits) if card
                  else band_dx_plain(gp, w, geom))
        if ctx.needs_input_grad[1]:
            dw = (band_gemm_dw(x, gp, hits) if card
                  else band_dw_plain(x, gp, geom, w.shape[:4]).to(w.dtype))
        if ctx.needs_input_grad[2]:
            db = gp.sum(dim=(0, 1), dtype=torch.float32).to(ctx.bias_dtype)
        return dx, dw, db, None


def band_layer(x_entries, w, bias, geom):
    """One band NC layer: ``relu(bias + sum_t x[nbr(n, t)] @ w[t])``,
    differentiable in ``x_entries``, ``w`` and ``bias``.

    Args:
      x_entries: ``[b, N, c_in]`` band activations, flat entry list (the
        B-major list on the symmetric pass), contiguous.
      w: ``[k1, k2, k3, k4, c_in, c_out]`` in the activation dtype (odd
        sizes for the input gradient).
      bias: ``[c_out]``, added in the activation dtype.
      geom: the pass's `BandGeometry`.

    Returns:
      ``[b, N, c_out]`` in the activation dtype.
    """
    return BandLayerFunction.apply(x_entries, w, bias, geom)
