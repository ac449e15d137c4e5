"""Streamed correlation -> top-K band (``ncnet_tpu/ops/corr_stream.py``,
``corr_impl='stream'``).

The band of `ncnet_tpu_torch.sparse.pipeline.sparse_match_pipeline`
without the dense ``[b, hA, wA, hB, wB]`` correlation: B's flattened grid
is cut into tiles, each ``[b, hA*wA, tile]`` slab is one batched GEMM, and
the slab is folded into a running per-A-cell top-K together with the
running row maxima and the column maxima (complete within the tile that
owns the column) that the soft mutual-matching gate needs. Peak memory is
O(nA * (K + tile)) for the plain band, plus O(nB * K) column tables and an
O(nA * K^2) membership transient with ``mutual=True``, and no nA*nB term.

Exactness: the band equals

    corr  = the same slabs, concatenated
    topk_band(corr, k, values_from=mutual_matching(corr), mutual=mutual)

bit for bit, values and indices. Against ``correlation_4d``'s volume it is
bitwise where the backend's slab GEMM is bitwise the matching columns of
the full GEMM; elsewhere the values agree to rounding and near-tied
entries at the band's edge may swap (the tests count them). The order is
``(value desc, index asc)``, the order `topk_band`'s stable sorts give:

* the row merge is one stable descending sort of ``[kept list, slab]``:
  the kept list is already in that order and every index in it is below
  every index of the slab, so a stable sort keeps both tie rules;
* the column top-Kc tables and the two 4-key sorts of `_mutual_select`
  are built from successive stable sorts, last key first;
* ``torch.sort`` compares ``-0.0`` equal to ``0.0``, as `topk_band`'s
  sorts do (and ``lax.sort``, which canonicalizes both zeros to one key).

Mutual selection streams through a candidate-superset theorem (the JAX
module's docstring): every entry of the dense mutual band has
``min(rank_a, rank_b) < K``, so it is in its row's top-K or its column's
top-Kc (``Kc = min(K, nA)``); row candidates carry their exact rank_a,
rank_b comes from the column's table, and column-only candidates order by
``(rank_b, value desc, column asc)``.

The backward (`CorrStreamBand.backward`) is the JAX custom VJP's routing:
each selected value ``v = c^3 / ((rm + eps)(cm + eps))`` sends its
cotangent to its own dot product, to the row maximum's first argmax and to
the column maximum's first argmax (the dense ``amax`` VJP splits a tied
maximum evenly instead). The correlation's cotangent is built one B-tile
at a time, each position written once (no scatter-add of colliding
entries), and ``d feat_a`` / ``d feat_b`` are its two GEMMs, so the
backward is deterministic and never holds nA*nB either.
"""

import torch

#: the mutual-matching gate's epsilon (`ops.matching.mutual_matching`)
EPS = 1e-5


def resolve_corr_tile(tile, nb):
    """The B-grid tile clamped to ``[1, nb]``; a tile <= 0 raises."""
    t = int(tile)
    if t <= 0:
        raise ValueError(
            f"corr stream tile={t} must be positive (it is the B-grid slab "
            "width of the streaming GEMM)"
        )
    return min(t, int(nb))


def check_band_width(k, nb):
    if not 1 <= k <= nb:
        raise ValueError(
            f"band width k={k} must be in [1, hB*wB={nb}] for the streamed "
            "correlation band"
        )


def _tiles(nb, tile):
    return [(t0, min(t0 + tile, nb)) for t0 in range(0, nb, tile)]


def slab(fa_flat, fb_flat, t0, t1):
    """``[b, nA, t1 - t0]``: the correlation's columns ``t0:t1``, one GEMM
    (the same einsum `correlation_4d` runs, on a slice of B)."""
    return torch.einsum("bnc,btc->bnt", fa_flat, fb_flat[:, t0:t1])


def _sort_by(keys, order):
    """Apply one permutation ``order`` (along the last axis) to ``keys``."""
    return [k.gather(-1, order) for k in keys]


def _lexsort(keys, last_sorted=False):
    """Ascending lexicographic order of ``keys`` (first key primary) along
    the last axis, by stable sorts from the last key to the first (the
    last one skipped when the keys already ascend in it); the keys come
    back permuted."""
    for i in range(len(keys) - 1 - int(last_sorted), -1, -1):
        order = torch.sort(keys[i], dim=-1, stable=True).indices
        keys = _sort_by(keys, order)
    return keys


def stream_scan(fa_flat, fb_flat, k, mutual, tile):
    """One pass over B's tiles.

    Returns the row top-K ``(vals, idx)`` of the raw correlation in
    ``(value desc, index asc)`` order (position = rank_a), the row maxima
    and first argmaxima ``(rm, argrm)`` ``[b, nA]``, the column maxima and
    first argmaxima ``(cm, argcm)`` ``[b, nB]``, and with ``mutual`` the
    per-column top-Kc tables ``(ctab_v, ctab_a)`` ``[b, nB, Kc]`` (position
    = rank_b), else None.
    """
    b, na, _ = fa_flat.shape
    nb = fb_flat.shape[1]
    dev, dt = fa_flat.device, fa_flat.dtype
    kc = min(k, na)
    vals = torch.full((b, na, k), float("-inf"), dtype=dt, device=dev)
    idx = torch.full((b, na, k), nb, dtype=torch.int64, device=dev)
    rm = torch.full((b, na), float("-inf"), dtype=dt, device=dev)
    argrm = torch.zeros((b, na), dtype=torch.int64, device=dev)
    cms, argcms, tabs_v, tabs_a = [], [], [], []
    for t0, t1 in _tiles(nb, tile):
        s = slab(fa_flat, fb_flat, t0, t1)
        cols = torch.arange(t0, t1, device=dev).expand(b, na, t1 - t0)
        # kept list first: its indices are all below the slab's, and it is
        # already in (value desc, index asc) order, so one stable
        # descending sort yields that order for the union
        cand_v = torch.cat([vals, s], dim=-1)
        cand_i = torch.cat([idx, cols], dim=-1)
        order = torch.sort(cand_v, dim=-1, descending=True, stable=True).indices
        order = order[..., :k]
        vals, idx = cand_v.gather(-1, order), cand_i.gather(-1, order)
        # running row maximum; strict > keeps the first argmax (the
        # backward's routing; the forward reads only rm)
        tmax, targ = torch.max(s, dim=-1)
        argrm = torch.where(tmax > rm, targ + t0, argrm)
        rm = torch.maximum(rm, tmax)
        # the column statistics are complete within the owning tile
        cmax, carg = torch.max(s, dim=1)
        cms.append(cmax)
        argcms.append(carg)
        if mutual:
            st = s.transpose(1, 2)  # [b, t, nA]
            order = torch.sort(st, dim=-1, descending=True, stable=True)
            # copies: a slice would keep each tile's whole sort alive
            tabs_v.append(order.values[..., :kc].clone())
            tabs_a.append(order.indices[..., :kc].to(torch.int32))
    ctab = (torch.cat(tabs_v, dim=1), torch.cat(tabs_a, dim=1)) if mutual else None
    return vals, idx, rm, argrm, torch.cat(cms, 1), torch.cat(argcms, 1), ctab


def mutual_select(vals, idx, ctab_v, ctab_a, k):
    """The ``mutual=True`` band from the streamed candidates: the dense key
    ``(min(rank_a, rank_b), rank_a)`` ordered on the candidate superset
    (row top-K ``vals``/``idx`` by rank_a, column tables by rank_b).
    Returns ``(vals, idx)`` ``[b, nA, K]`` in key order."""
    b, na, _ = vals.shape
    nb, kc = ctab_v.shape[1], ctab_v.shape[2]
    dev = vals.device
    bi = torch.arange(b, device=dev)

    # rank_b of each row candidate: its position in its column's table
    # (absent: rank_b >= Kc, where min(rank_a, rank_b) = rank_a already)
    calist = ctab_a[bi[:, None, None], idx]  # [b, nA, K, Kc] int32
    hit = (calist == torch.arange(na, dtype=torch.int32, device=dev)
           [None, :, None, None]).to(torch.uint8)
    del calist
    p = torch.arange(k, device=dev).expand(b, na, k)
    # a row is in a column's table at most once: its first hit is its rank
    rb_row = torch.where(hit.amax(-1) > 0, hit.argmax(-1), k)
    k1_row = torch.minimum(p, rb_row)

    # column-only candidates: the tables as one entry list (column-major,
    # rank_b minor), entries already in their row's list dropped, grouped
    # by row under (row, rank_b, value desc, column), the best K per row
    e = nb * kc
    a_e = ctab_a.reshape(b, e).long()
    neg_e = -ctab_v.reshape(b, e)
    j_e = torch.arange(nb, device=dev).repeat_interleave(kc).expand(b, e)
    rb_e = torch.arange(kc, device=dev).repeat(nb).expand(b, e)
    in_row = (idx[bi[:, None], a_e] == j_e[..., None]).any(-1)
    a_key = torch.where(in_row, na, a_e)
    # the list already ascends in the column: three stable sorts give the
    # 4-key order (a_key, rank_b, -value, column)
    a_s, rb_s, neg_s, j_s = _lexsort([a_key, rb_e, neg_e, j_e], last_sorted=True)
    eids = torch.arange(e, device=dev).expand(b, e)
    first = torch.ones((b, e), dtype=torch.bool, device=dev)
    first[:, 1:] = a_s[:, 1:] != a_s[:, :-1]
    pos = eids - torch.cummax(torch.where(first, eids, 0), dim=1).values
    keep = (pos < k) & (a_s < na)
    # row-grouped buffers; a kept (row, pos) is written once, every other
    # entry lands in the trash row na, which is sliced off
    a_scat = torch.where(keep, a_s, na)
    pos_scat = torch.where(keep, pos, 0)
    where = (bi[:, None].expand(b, e), a_scat, pos_scat)

    def scattered(fill, src):
        buf = torch.full((b, na + 1, k), fill, dtype=src.dtype, device=dev)
        buf[where] = src
        return buf[:, :na]

    c3_k1 = scattered(k, rb_s)
    c3_nv = scattered(0, neg_s)
    c3_j = scattered(nb, j_s)

    # final per-row merge of the 2K candidates under the dense order
    # (min-rank, rank_a or K, value desc, column)
    m = _lexsort([
        torch.cat([k1_row, c3_k1], -1),
        torch.cat([p, torch.full_like(p, k)], -1),
        torch.cat([-vals, c3_nv], -1),
        torch.cat([idx, c3_j], -1),
    ])
    return -m[2][..., :k], m[3][..., :k]


def gate(vraw, rm, cm_sel, eps=EPS):
    """The mutual-matching gate on band entries, grouped as
    `ops.matching.mutual_matching` groups it."""
    ratio_a = vraw / (rm + eps)
    ratio_b = vraw / (cm_sel + eps)
    return vraw * (ratio_a * ratio_b)


def _forward(feat_a, feat_b, k, mutual, tile, eps):
    b, ha, wa, c = feat_a.shape
    _, hb, wb, _ = feat_b.shape
    na = ha * wa
    fa_flat = feat_a.reshape(b, na, c)
    fb_flat = feat_b.reshape(b, hb * wb, c)
    vals, idx, rm, argrm, cm, argcm, ctab = stream_scan(
        fa_flat, fb_flat, k, mutual, tile)
    if mutual:
        vals, idx = mutual_select(vals, idx, ctab[0], ctab[1], k)
    # the band's order: indices ascending per A cell (unique, so any sort
    # is the same permutation)
    idx, order = torch.sort(idx, dim=-1)
    vraw = vals.gather(-1, order)
    cm_sel = cm.gather(1, idx.reshape(b, na * k)).reshape(b, na, k)
    values = gate(vraw, rm[..., None], cm_sel, eps)
    return values, idx, (vraw, rm, argrm, cm, argcm)


class CorrStreamBand(torch.autograd.Function):
    """`corr_stream_band` with the JAX custom VJP's gather-only routing."""

    @staticmethod
    def forward(ctx, feat_a, feat_b, k, mutual, tile, eps):
        values, idx, (vraw, rm, argrm, cm, argcm) = _forward(
            feat_a, feat_b, k, mutual, tile, eps)
        ctx.save_for_backward(feat_a, feat_b, vraw, idx, rm, argrm, cm, argcm)
        ctx.tile, ctx.eps = tile, eps
        b, ha, wa, _ = feat_a.shape
        indices = idx.to(torch.int32).reshape(b, ha, wa, k)
        ctx.mark_non_differentiable(indices)
        return values.reshape(b, ha, wa, k), indices

    @staticmethod
    def backward(ctx, dval, _):
        feat_a, feat_b, vraw, idx, rm, argrm, cm, argcm = ctx.saved_tensors
        dfa, dfb = corr_stream_band_bwd(
            feat_a, feat_b, vraw, idx, rm, argrm, cm, argcm, dval,
            ctx.tile, ctx.eps)
        return dfa, dfb, None, None, None, None


def corr_stream_band_bwd(feat_a, feat_b, vraw, idx, rm, argrm, cm, argcm,
                         dval, tile, eps=EPS):
    """``(d feat_a, d feat_b)`` of the streamed band's values.

    The correlation's cotangent has three parts: ``g_c = dv * 3 v^2 /
    ((rm + eps)(cm + eps))`` at each selected entry, ``d_rm`` (the sum of
    a row's ``-dv * v / (rm + eps)``) at the row's first argmax, and
    ``d_cm`` (a column's sum of ``-dv * v / (cm + eps)`` over the entries
    that select it) at the column's first argmax. Each tile's ``[b, nA,
    tile]`` block of it is built by writes to distinct positions and two
    additions, then ``d feat_a += W @ fb_tile`` and ``d feat_b[tile] =
    W^T @ fa``; column sums are plain reductions over A. Deterministic.
    """
    b, ha, wa, c = feat_a.shape
    _, hb, wb, _ = feat_b.shape
    na, nb = ha * wa, hb * wb
    k = idx.shape[-1]
    fa_flat = feat_a.reshape(b, na, c)
    fb_flat = feat_b.reshape(b, nb, c)
    dv = dval.reshape(b, na, k).to(vraw.dtype)
    dev = vraw.device

    rmx = rm[..., None] + eps
    cms = cm.gather(1, idx.reshape(b, na * k)).reshape(b, na, k) + eps
    val = vraw * ((vraw / rmx) * (vraw / cms))
    g_c = dv * (3.0 * vraw * vraw) / (rmx * cms)
    cm_terms = dv * (-val / cms)
    d_rm = (dv * (-val / rmx)).sum(-1)

    dfa = torch.zeros_like(fa_flat)
    dfb = torch.empty_like(fb_flat)
    rows = torch.arange(na, device=dev)
    for t0, t1 in _tiles(nb, tile):
        t = t1 - t0
        # the selected entries of this tile; out-of-tile ones land in the
        # extra column t, which is dropped
        local = torch.where((idx >= t0) & (idx < t1), idx - t0, t)
        w = torch.zeros((b, na, t + 1), dtype=vraw.dtype, device=dev)
        w.scatter_(2, local, g_c)
        cmw = torch.zeros_like(w)
        cmw.scatter_(2, local, cm_terms)
        d_cm = cmw[..., :t].sum(1)  # [b, t]: each column's cm cotangent
        # the row-max entry: one a row, into the row's own position
        r_in = (argrm >= t0) & (argrm < t1)
        r_local = torch.where(r_in, argrm - t0, t)
        w.scatter_add_(2, r_local[..., None],
                       torch.where(r_in, d_rm, 0)[..., None])
        w = w[..., :t]
        # the column-max entry: one a column, into the column's own position
        acm = argcm[:, t0:t1]
        w = w + (acm[:, None, :] == rows[None, :, None]) * d_cm[:, None, :]
        dfa = dfa + torch.bmm(w, fb_flat[:, t0:t1])
        dfb[:, t0:t1] = torch.bmm(w.transpose(1, 2), fa_flat)
    return dfa.reshape(feat_a.shape), dfb.reshape(feat_b.shape)


def corr_stream_band(feat_a, feat_b, k, mutual=False, tile=128, eps=EPS):
    """The top-K correlation band of ``feat_a`` ``[b, hA, wA, c]`` against
    ``feat_b`` ``[b, hB, wB, c]`` without the correlation volume: equal to
    ``topk_band(corr, k, values_from=mutual_matching(corr, eps),
    mutual=mutual)`` over the slabs' correlation (module docstring).
    ``tile`` is the B-grid slab width (clamped to hB*wB); the mutual band
    has no int32 rank key, so it takes any B grid. Returns ``(values [b,
    hA, wA, K], indices int32)``, indices ascending per A cell;
    differentiable in both feature maps."""
    nb = feat_b.shape[1] * feat_b.shape[2]
    k = int(k)
    check_band_width(k, nb)
    t = resolve_corr_tile(tile, nb)
    return CorrStreamBand.apply(feat_a, feat_b, k, bool(mutual), t, float(eps))


def slab_correlation(feat_a, feat_b, tile):
    """``[b, hA, wA, hB, wB]``: the correlation `corr_stream_band` sees, its
    ``tile``-wide slabs concatenated (the bitwise reference of the band;
    for tests and checks, it holds the whole volume)."""
    b, ha, wa, c = feat_a.shape
    _, hb, wb, _ = feat_b.shape
    nb = hb * wb
    fa_flat = feat_a.reshape(b, ha * wa, c)
    fb_flat = feat_b.reshape(b, nb, c)
    tile = resolve_corr_tile(tile, nb)
    return torch.cat([slab(fa_flat, fb_flat, t0, t1)
                      for t0, t1 in _tiles(nb, tile)], -1).reshape(
                          b, ha, wa, hb, wb)


def band_index_swaps(corr, corr_other, idx_1, idx_2):
    """How two bands selected from ``corr`` and from ``corr_other`` (the same
    correlation up to rounding) differ: ``{'rows': A cells whose index sets
    differ, 'entries': entries in one set only, 'near_ties': those of them
    whose correlation lies within twice the two volumes' largest difference
    of another entry of their row or column, 'delta': that difference}``.
    A swap that is not a near tie is a selection fault."""
    b, ha, wa, hb, wb = corr.shape
    na, nb = ha * wa, hb * wb
    c = corr.reshape(b, na, nb).float()
    delta = float((c - corr_other.reshape(b, na, nb).float()).abs().max())

    def member(idx):
        m = torch.zeros((b, na, nb), dtype=torch.bool, device=c.device)
        return m.scatter_(2, idx.reshape(b, na, -1).long(), True)

    diff = member(idx_1) ^ member(idx_2)
    where = diff.nonzero()
    near = 0
    for chunk in where.split(1024):  # [n, 3] (sample, A cell, B cell)
        bi, a, j = chunk.unbind(1)
        v = c[bi, a, j][:, None]
        row = (c[bi, a] - v).abs()  # [n, nB]
        col = (c[bi, :, j] - v).abs()  # [n, nA]
        n = torch.arange(len(chunk), device=c.device)
        row[n, j] = float("inf")
        col[n, a] = float("inf")
        gap = torch.minimum(row.amin(1), col.amin(1))
        near += int((gap <= 2 * delta).sum())
    return {"rows": int(diff.any(-1).sum()), "entries": int(diff.sum()),
            "near_ties": near, "delta": delta}
