"""The band NC layer over a band's geometry (`BandGeometry`) against the
JAX package: the plain layer (both passes, the PF-Pascal layer shapes,
square and rectangular grids, a K = 16 band and the complete band) against
``band_conv_gemm`` + bias + ReLU on JAX-built pointers; the band NC stack
against JAX's; the kernel's tap derivation (`band_taps`) against the
non-null entries of JAX's pointer tables, bitwise; and the plain version's
table cache. Inputs are numpy from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.ops import band as jband
from ncnet_tpu.sparse.nc import sparse_neigh_consensus_apply as jax_sparse_nc
from ncnet_tpu_torch.ops import band
from ncnet_tpu_torch.sparse import sparse_neigh_consensus_apply

# float32, the round's starting tolerance; integer sets are exact
RTOL, ATOL = 1e-5, 1e-6

GEOMETRIES = {
    # name: (hA, wA, hB, wB, K, kernel size)
    "25x25 K16": (25, 25, 25, 25, 16, 3),
    "25x25/19x25 K16": (25, 25, 19, 25, 16, 3),
    # the complete band (K = hB*wB) at a grid whose [N, T*c] gather stays
    # small on the CPU (at 25x25 it would be 390,625 rows)
    "6x7 complete": (6, 7, 6, 7, 42, 5),
    # a 3^4 kernel wider than the 1-wide grids: its taps leave them on
    # both sides at once
    "3x1/1x3 K2": (3, 1, 1, 3, 2, 3),
}
LAYER_GEOMETRIES = ["25x25 K16", "25x25/19x25 K16", "6x7 complete"]
LAYERS = [(1, 16), (16, 16), (16, 1)]  # the PF-Pascal NC layers (cin, cout)
# JAX compiles its eager pointer build once per grid, kernel and pass
# (seconds each at 5^4); the stack runs on the layer tests' grids, so it
# reuses their builds
STACK_GEOMETRIES = ["6x7 complete", "25x25/19x25 K16"]
# the reference layer's GEMM compiled as one program per shape and dtype
# (eagerly JAX compiles each of its ops); bias and ReLU stay eager, so the
# bfloat16 product is rounded before the bias as in the reference
_jax_gemm = jax.jit(jband.band_conv_gemm)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the tier-1 run has several."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scores(rng, shape, ties):
    """Correlation-like scores; with ``ties`` drawn from a few levels, so
    many entries tie at the band's edge (the K-th largest)."""
    if ties:
        return rng.randint(0, 4, shape).astype(np.float32) / 4
    return rng.randn(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _band(name, ties=False):
    """``(indices, perm, inv)`` numpy of one mutual band of ``name``'s
    geometry (JAX's `topk_band`), and its B-major order."""
    ha, wa, hb, wb, k, _ = GEOMETRIES[name]
    rng = np.random.RandomState(sum(map(ord, name)) + ties)
    # mutual selection over tied scores: many ties at the K-th place
    scores = _scores(rng, (1, ha, wa, hb, wb), ties)
    _, idx = jband.topk_band(jnp.asarray(scores), k, mutual=True)
    idx = np.array(idx)
    perm = np.argsort(idx.reshape(1, -1), axis=-1, kind="stable")
    return idx, perm, np.argsort(perm, axis=-1, kind="stable")


@functools.lru_cache(maxsize=None)
def _jax_table(name, swapped):
    """JAX's ``[1, N, T]`` table of the pass, over the pass's rows: on the
    symmetric pass permuted B-major and remapped as JAX's sparse/nc.py
    does."""
    ha, wa, hb, wb, k, ks = GEOMETRIES[name]
    idx, perm, inv = _band(name)
    n = ha * wa * k
    ptr = np.array(jband.band_neighbor_pointers(
        jnp.asarray(idx), (hb, wb), (ks,) * 4, swapped=swapped)).reshape(1, n, -1)
    if swapped:
        rows = np.take_along_axis(ptr, perm[..., None], axis=1)
        remap = np.concatenate([inv, np.full((1, 1), n)], axis=1).astype(np.int32)
        ptr = np.take_along_axis(remap, rows.reshape(1, -1), axis=1).reshape(rows.shape)
    return ptr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", LAYERS)
@pytest.mark.parametrize("name", LAYER_GEOMETRIES)
@pytest.mark.parametrize("swapped", [False, True])
def test_band_layer_plain_matches_jax(swapped, name, cin, cout, dtype):
    ha, wa, hb, wb, k, ks = GEOMETRIES[name]
    idx, perm, inv = _band(name)
    n = ha * wa * k
    rng = np.random.RandomState(cin + 3 * cout + 7 * swapped)
    x = rng.rand(1, n, cin).astype(np.float32)
    w = ((rng.rand(ks, ks, ks, ks, cin, cout) * 2 - 1)
         * (cin * ks**4) ** -0.5).astype(np.float32)
    bias = ((rng.rand(cout) * 2 - 1) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.nn.relu(
        _jax_gemm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(_jax_table(name, swapped)))
        + jnp.asarray(bias).astype(jdt))
    want = np.asarray(want.astype(jnp.float32))
    order = (torch.from_numpy(perm), torch.from_numpy(inv)) if swapped else ()
    geom = band.BandGeometry(torch.from_numpy(idx), (hb, wb), *order)
    got = band.band_layer_plain(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w).to(tdt),
                                torch.from_numpy(bias), geom)
    assert got.dtype == tdt and got.shape == (1, n, cout)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        # both round the product and then the biased sum to bfloat16, but
        # the float32 sums feeding the first rounding differ in order:
        # one bfloat16 ulp (2^-8 relative) of the output's scale
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                                   atol=2**-8 * scale)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("name", STACK_GEOMETRIES)
def test_band_stack_matches_jax(name, symmetric):
    """The whole band NC stack at the PF-Pascal widths (16-16-1), float32,
    against JAX's XLA band path: 5^4 kernels on the complete band, 3^4 on
    a K = 16 band of a rectangular pair."""
    ha, wa, hb, wb, k, ks = GEOMETRIES[name]
    rng = np.random.RandomState(ha + hb)
    scores = rng.randn(1, ha, wa, hb, wb).astype(np.float32)
    values, idx = jband.topk_band(jnp.asarray(scores), k, mutual=True)
    values, idx = np.array(values), np.array(idx)
    # the reference init's range, drawn with numpy for both
    params = [{"kernel": ((rng.rand(ks, ks, ks, ks, cin, cout) * 2 - 1)
                          * (cin * ks**4) ** -0.5).astype(np.float32),
               "bias": ((rng.rand(cout) * 2 - 1) * 0.1).astype(np.float32)}
              for cin, cout in LAYERS]
    want = jax_sparse_nc(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        jnp.asarray(values), jnp.asarray(idx), (hb, wb),
        symmetric=symmetric, band_impl="xla")
    got = sparse_neigh_consensus_apply(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in params],
        torch.from_numpy(values), torch.from_numpy(idx), (hb, wb),
        symmetric=symmetric, band_impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_band_taps_equal_jax_pointers_bitwise(name, swapped, ties):
    """The kernel's tap derivation, mirrored in plain PyTorch, finds
    exactly the non-null entries of JAX's pointer table: the same (entry,
    tap) pairs, each pointing at the same slot."""
    ha, wa, hb, wb, k, ks = GEOMETRIES[name]
    idx = _band(name, ties)[0]
    n = ha * wa * k
    want = np.array(jband.band_neighbor_pointers(
        jnp.asarray(idx), (hb, wb), (ks,) * 4, swapped=swapped)).reshape(1, n, -1)
    bi, e, t, slot = band.band_taps(torch.from_numpy(idx), (hb, wb), (ks,) * 4,
                                    swapped=swapped)
    got = np.full_like(want, n)
    got[bi.numpy(), e.numpy(), t.numpy()] = slot.numpy()
    np.testing.assert_array_equal(got, want)
    # every non-null entry is found exactly once
    assert len(bi) == int((want != n).sum())
    # in the kernel's order: by batch and entry
    key = bi * n + e
    assert bool((key[1:] >= key[:-1]).all())


def test_plain_layer_builds_each_table_once(monkeypatch):
    """The band stack builds one pointer table per (kernel size, pass) on
    the CPU, shared by its layers."""
    calls = []
    real = band.band_neighbor_pointers

    def counted(*args, **kwargs):
        calls.append(kwargs.get("swapped", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(band, "band_neighbor_pointers", counted)
    rng = np.random.RandomState(5)
    scores = torch.from_numpy(rng.randn(1, 4, 4, 4, 4).astype(np.float32))
    values, idx = band.topk_band(scores, 5, mutual=True)
    params = [{"kernel": torch.from_numpy(
                   rng.randn(3, 3, 3, 3, cin, cout).astype(np.float32) * 0.1),
               "bias": torch.zeros(cout)}
              for cin, cout in ((1, 4), (4, 4), (4, 1))]
    sparse_neigh_consensus_apply(params, values, idx, (4, 4), symmetric=True)
    assert sorted(calls) == [False, True]
