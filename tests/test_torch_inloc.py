"""The port's relocalization and InLoc dump against the JAX package on the
CPU: `maxpool4d` with planted ties, the fused `correlation_maxpool4d`,
the ``delta4d`` readout, `match_pipeline` at k = 2 on square and
rectangular grids, `match_pair`, and `dump_matches`' ``.mat`` (contract,
values, resume, stale temporary files), plus the CLI at toy size.

Weights are made by the JAX init and carried over by
`ncnet_tpu_torch.bridge`; inputs are numpy from the seeds in each test.
float32 parity: rtol 1e-5 / atol 1e-6; pooled offsets exactly, where the
planted ties are exact (integer-valued inputs) or absent."""

import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.eval import inloc as jinloc
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.models.immatchnet import match_pipeline as jax_match_pipeline
from ncnet_tpu.ops.correlation import correlation_maxpool4d as jax_corr_pool
from ncnet_tpu.ops.matches import corr_to_matches as jax_corr_to_matches
from ncnet_tpu.ops.matching import maxpool4d as jax_maxpool4d
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.eval import inloc
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig, match_pipeline
from ncnet_tpu_torch.ops.correlation import correlation_4d, correlation_maxpool4d
from ncnet_tpu_torch.ops.matches import corr_to_matches
from ncnet_tpu_torch.ops.matching import maxpool4d
from ncnet_tpu_torch.ops.norm import feature_l2norm

RTOL, ATOL = 1e-5, 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def small():
    jcfg = JaxConfig(**SMALL, relocalization_k_size=2)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(0), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return jcfg, tree, cfg, bridge.from_jax_params(tree, cfg, device="cpu")


# -- maxpool4d and the fused correlation + pool ----------------------------


@pytest.mark.parametrize("shape,k", [((2, 4, 4, 4, 4), 2), ((1, 6, 4, 2, 8), 2),
                                     ((1, 3, 6, 3, 3), 3)])
def test_maxpool4d_matches_jax_with_planted_ties(shape, k):
    # 3 integer levels: most cells hold several tied maxima, and the
    # first in the reference's enumeration must win
    corr = np.random.RandomState(0).randint(0, 3, shape).astype(np.float32)
    pooled, offsets = maxpool4d(torch.from_numpy(corr), k)
    jpooled, joffsets = jax_maxpool4d(jnp.asarray(corr), k)
    _equal(pooled, jpooled)
    for got, want in zip(offsets, joffsets):
        assert got.dtype == torch.int32
        _equal(got, want)
    # every offset points at its cell's maximum, the first one on ties
    b, d1, d2, d3, d4 = pooled.shape
    di, dj, dk, dl = (o.numpy() for o in offsets)
    for idx in np.ndindex(b, d1, d2, d3, d4):
        n, i, j, u, v = idx
        cell = corr[n, i * k:(i + 1) * k, j * k:(j + 1) * k,
                    u * k:(u + 1) * k, v * k:(v + 1) * k]
        first = np.unravel_index(np.argmax(cell), cell.shape)
        assert (di[idx], dj[idx], dk[idx], dl[idx]) == tuple(first)


def test_maxpool4d_integer_and_negative_inputs():
    corr = -np.arange(16, dtype=np.int64).reshape(1, 2, 2, 2, 2)
    pooled, offsets = maxpool4d(torch.from_numpy(corr), 2)
    assert int(pooled) == 0 and all(int(o) == 0 for o in offsets)
    pooled, _ = maxpool4d(torch.full((1, 2, 2, 2, 2), -1e30), 2)
    assert float(pooled) == float(np.float32(-1e30))  # not the -inf start


@pytest.mark.parametrize("grids,k", [(((4, 4), (4, 4)), 2),
                                     (((6, 4), (2, 8)), 2),
                                     (((3, 6), (6, 3)), 3)])
def test_correlation_maxpool4d(grids, k):
    rng = np.random.RandomState(1)
    (ha, wa), (hb, wb) = grids
    # small integers: every product and sum is exact, so the fused form
    # and maxpool4d(correlation_4d) see the same values and ties
    fa = rng.randint(-2, 3, (2, ha, wa, 5)).astype(np.float32)
    fb = rng.randint(-2, 3, (2, hb, wb, 5)).astype(np.float32)
    tfa, tfb = torch.from_numpy(fa), torch.from_numpy(fb)
    fused, offsets = correlation_maxpool4d(tfa, tfb, k)
    pooled, ref_offsets = maxpool4d(correlation_4d(tfa, tfb), k)
    _equal(fused, pooled.numpy())
    for got, want in zip(offsets, ref_offsets):
        _equal(got, want.numpy())
    jfused, joffsets = jax_corr_pool(jnp.asarray(fa), jnp.asarray(fb), k)
    _equal(fused, jfused)
    for got, want in zip(offsets, joffsets):
        _equal(got, want)
    # random float features against the JAX package's fused form
    fa = rng.randn(1, ha, wa, 16).astype(np.float32)
    fb = rng.randn(1, hb, wb, 16).astype(np.float32)
    fused, offsets = correlation_maxpool4d(torch.from_numpy(fa),
                                           torch.from_numpy(fb), k)
    jfused, joffsets = jax_corr_pool(jnp.asarray(fa), jnp.asarray(fb), k)
    _close(fused, jfused)
    for got, want in zip(offsets, joffsets):
        _equal(got, want)


# -- the delta4d readout ---------------------------------------------------


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("softmax", [False, True])
def test_delta4d_readout_matches_jax(invert, softmax):
    rng = np.random.RandomState(2)
    fa = rng.randn(2, 6, 4, 8).astype(np.float32)
    fb = rng.randn(2, 4, 8, 8).astype(np.float32)
    corr, delta = correlation_maxpool4d(torch.from_numpy(fa), torch.from_numpy(fb), 2)
    jcorr, jdelta = jax_corr_pool(jnp.asarray(fa), jnp.asarray(fb), 2)
    kw = dict(k_size=2, do_softmax=softmax, scale="positive",
              invert_matching_direction=invert, return_indices=True)
    got = corr_to_matches(corr, delta4d=delta, **kw)
    want = jax_corr_to_matches(jcorr, delta4d=jdelta, **kw)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)
    for g, w in zip(got[5:], want[5:]):  # fine-grid indices
        _equal(g, w)
    # the fine indices lie on the unpooled grids
    i_a, j_a, i_b, j_b = (t.numpy() for t in got[5:])
    assert i_a.max() < 6 and j_a.max() < 4 and i_b.max() < 4 and j_b.max() < 8


# -- relocalization through the model --------------------------------------


@pytest.mark.parametrize("grid_b", [(8, 8), (6, 10)])
def test_match_pipeline_relocalization_matches_jax(small, grid_b):
    jcfg, tree, cfg, model = small
    rng = np.random.RandomState(3)
    fa = rng.randn(1, 8, 8, 256).astype(np.float32)
    fb = rng.randn(1, *grid_b, 256).astype(np.float32)
    fa, fb = (feature_l2norm(torch.from_numpy(f)).numpy() for f in (fa, fb))
    corr, delta = match_pipeline(model.neigh_consensus, cfg,
                                 torch.from_numpy(fa), torch.from_numpy(fb))
    jcorr, jdelta = jax_match_pipeline(tree["neigh_consensus"], jcfg,
                                       jnp.asarray(fa), jnp.asarray(fb))
    assert corr.shape == (1, 4, 4, grid_b[0] // 2, grid_b[1] // 2)
    assert corr.dtype == torch.float32
    _close(corr, jcorr)
    for got, want in zip(delta, jdelta):
        _equal(got, want)


# -- match_pair and the dump -----------------------------------------------


def _row_set(xa, ya, xb, yb, score):
    """The rows of one pair's matches, sorted by their coordinates (the
    dedup's unique order; a near-tie of scores may reorder the sort)."""
    rows = np.stack([xa, ya, xb, yb, score], axis=1).astype(np.float64)
    return rows[np.lexsort(rows[:, :4].T[::-1])]


@pytest.mark.parametrize("k", [0, 2])
def test_match_pair_matches_jax(small, k):
    jcfg, tree, cfg, model = small
    jcfg, cfg = (c.replace(relocalization_k_size=k) for c in (jcfg, cfg))
    rng = np.random.RandomState(4)
    src = rng.randn(1, 64, 96, 3).astype(np.float32)
    tgt = rng.randn(1, 96, 64, 3).astype(np.float32)
    got = inloc.match_pair(inloc.make_match_fn(cfg), model, torch.from_numpy(src),
                           torch.from_numpy(tgt), k_size=k)
    want = jinloc.match_pair(jax.jit(jinloc.make_match_fn(jcfg)), tree,
                             jnp.asarray(src), jnp.asarray(tgt), k_size=k)
    assert len(got[0]) == len(want[0])
    _close(_row_set(*got), _row_set(*want))
    # one direction, and the concatenated form
    for flip in (False, True):
        one = inloc.match_pair(inloc.make_match_fn(cfg), model, torch.from_numpy(src),
                               torch.from_numpy(tgt), k, both_directions=False,
                               flip_direction=flip)
        jone = jinloc.match_pair(jinloc.make_match_fn(jcfg), tree, jnp.asarray(src),
                                 jnp.asarray(tgt), k, both_directions=False,
                                 flip_direction=flip)
        for g, w in zip(one, jone):
            _close(g, w)
    fn = inloc.make_match_fn(cfg, concat_directions=True)
    cat = inloc.match_pair(fn, model, torch.from_numpy(src), torch.from_numpy(tgt), k)
    for g, w in zip(cat, got):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="both_directions"):
        inloc.match_pair(fn, model, torch.from_numpy(src), torch.from_numpy(tgt),
                         k, both_directions=False)


def test_helpers_match_jax():
    for args in ((4032, 3024, 3200, 2), (1200, 1600, 3200, 2), (80, 60, 128, 2),
                 (1600, 1200, 3200, 1), (64, 96, 128, 2, 4)):
        assert inloc.quantized_resize_shape(*args) == jinloc.quantized_resize_shape(*args)
    for args in ((3200, 2, True), (3200, 2, False), (128, 2, True), (1600, 1, True)):
        assert inloc.n_match_slots(*args) == jinloc.n_match_slots(*args)
    assert inloc.n_match_slots(3200, 2, True) == 15000
    c = np.linspace(0, 1, 7, dtype=np.float32)
    np.testing.assert_array_equal(inloc.recenter(c, 7), jinloc.recenter(c, 7))


@pytest.fixture(scope="module")
def inloc_data(tmp_path_factory):
    """Two queries (80x60) with two panos each (64x96), and the shortlist
    ``.mat`` in the schema the dump parses."""
    from PIL import Image
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("inloc")
    qdir, pdir = root / "query", root / "pano"
    qdir.mkdir()
    pdir.mkdir()
    rng = np.random.RandomState(5)
    queries = []
    for q in range(2):
        Image.fromarray(rng.randint(0, 255, (80, 60, 3), np.uint8)).save(qdir / f"q{q}.png")
        panos = [f"p{q}_{j}.png" for j in range(2)]
        for name in panos:
            Image.fromarray(rng.randint(0, 255, (64, 96, 3), np.uint8)).save(pdir / name)
        queries.append((f"q{q}.png", panos))
    dt = np.dtype([("queryname", object), ("topN", object)])
    entries = np.zeros((1, len(queries)), dt)
    for q, (qname, panos) in enumerate(queries):
        entries[0, q] = (np.array([qname], object), np.array([[p] for p in panos], object))
    savemat(root / "shortlist.mat", {"ImgList": entries})
    return root


def _dump_kw(root, out):
    return dict(shortlist_path=str(root / "shortlist.mat"),
                query_path=str(root / "query"), pano_path=str(root / "pano"),
                output_dir=str(out), image_size=128, n_queries=2, n_panos=2,
                verbose=False)


def _assert_same_mat(got_path, want_path):
    from scipy.io import loadmat

    got, want = loadmat(got_path), loadmat(want_path)
    assert got["matches"].shape == want["matches"].shape == (1, 2, 24, 5)
    assert str(got["query_fn"][0]) == str(want["query_fn"][0])
    np.testing.assert_array_equal(got["pano_fn"], want["pano_fn"])
    for p in range(2):
        g, w = got["matches"][0, p], want["matches"][0, p]
        filled = np.abs(w).sum(axis=1) > 0
        np.testing.assert_array_equal(np.abs(g).sum(axis=1) > 0, filled)
        _close(_row_set(*g[filled].T), _row_set(*w[filled].T))


def test_dump_matches_matches_jax(small, inloc_data, tmp_path):
    jcfg, tree, cfg, model = small
    done = inloc.dump_matches(model, cfg, **_dump_kw(inloc_data, tmp_path / "port"))
    assert done == {"written": [1, 2], "skipped": [], "pairs": 4}
    jinloc.dump_matches(tree, jcfg, **_dump_kw(inloc_data, tmp_path / "jax"))
    for q in (1, 2):
        _assert_same_mat(tmp_path / "port" / f"{q}.mat", tmp_path / "jax" / f"{q}.mat")


def test_dump_matches_resume_and_stale_temps(small, inloc_data, tmp_path):
    _, _, cfg, model = small
    out = tmp_path / "out"
    kw = _dump_kw(inloc_data, out)
    out.mkdir()
    dead = subprocess.Popen(["true"])
    dead.wait()
    stale = out / f"2.mat.tmp.{dead.pid}"  # a killed run's torn file
    live = out / f"2.mat.tmp.{os.getpid()}"  # a running dump's file
    stale.write_bytes(b"torn")
    live.write_bytes(b"in flight")
    first = inloc.dump_matches(model, cfg, **dict(kw, n_queries=1))
    assert first["written"] == [1] and not stale.exists() and live.exists()
    live.unlink()
    mtime = os.path.getmtime(out / "1.mat")
    done = inloc.dump_matches(model, cfg, **kw)  # resume: query 1 is done
    assert done == {"written": [2], "skipped": [1], "pairs": 2}
    assert os.path.getmtime(out / "1.mat") == mtime
    assert sorted(os.listdir(out)) == ["1.mat", "2.mat"]


def test_not_ported_options_raise(small, inloc_data, tmp_path):
    # the gallery feature store (A11) is ported: tests/test_torch_features.py
    _, _, cfg, model = small
    with pytest.raises(NotImplementedError, match="A13"):
        inloc.make_match_fn(cfg, mesh=object())


def test_inloc_cli(small, inloc_data, tmp_path, capsys):
    from ncnet_tpu_torch.train.checkpoint import save_checkpoint
    from ncnet_tpu_torch.train.step import create_train_state

    jcfg, tree, cfg, _ = small
    ck = str(tmp_path / "tiny.npz")
    save_checkpoint(ck, create_train_state(bridge.from_jax_params(tree, cfg, device="cpu")),
                    cfg.replace(relocalization_k_size=0), epoch=0)
    argv = ["--checkpoint", ck, "--inloc_shortlist", str(inloc_data / "shortlist.mat"),
            "--query_path", str(inloc_data / "query"), "--pano_path",
            str(inloc_data / "pano"), "--output_root", str(tmp_path / "matches"),
            "--image_size", "128", "--n_queries", "2", "--n_panos", "2",
            "--no-bf16", "--device", "cpu"]
    report = inloc.main(argv)
    out = capsys.readouterr().out
    exp = "shortlist_SZ_NEW_128_K_2_BOTHDIRS_SOFTMAX_CHECKPOINT_tiny"
    assert f"Output matches folder: {tmp_path / 'matches' / exp}" in out
    assert json.loads(out.strip().splitlines()[-1])["written"] == [1, 2]
    assert report["n_slots"] == 24
    jinloc.dump_matches(tree, jcfg, **_dump_kw(inloc_data, tmp_path / "jax"))
    for q in (1, 2):
        _assert_same_mat(tmp_path / "matches" / exp / f"{q}.mat",
                         tmp_path / "jax" / f"{q}.mat")
    for extra, error, item in (
            (["--spatial_shards", "2"], NotImplementedError, "A13"),
            # refinement is ported (ROADMAP A10) and needs --k_size 1
            (["--refine", "2"], SystemExit, "requires --k_size 1")):
        with pytest.raises(error, match=item):
            inloc.main(argv + extra)
    # the gallery feature store (ROADMAP A11, once refused): the same .mat
    store = ["--output_root", str(tmp_path / "store"), "--feature-store",
             str(tmp_path / "gallery")]
    assert inloc.main(argv + store)["panos_extracted"] == 4
    for q in (1, 2):
        _assert_same_mat(tmp_path / "store" / exp / f"{q}.mat",
                         tmp_path / "jax" / f"{q}.mat")
    # device preprocessing (ROADMAP A7b, once refused): the .mat of the
    # JAX package's dump on the same route, row for row
    with pytest.raises(ValueError, match="requires --device_preprocess"):
        inloc.main(argv + ["--device_resize", "true"])
    dev = ["--output_root", str(tmp_path / "dev"), "--device_preprocess", "true"]
    inloc.main(argv + dev)
    jinloc.dump_matches(tree, jcfg, device_preprocess=True, device_resize=True,
                        **_dump_kw(inloc_data, tmp_path / "jax_dev"))
    for q in (1, 2):
        _assert_same_mat(tmp_path / "dev" / exp / f"{q}.mat",
                         tmp_path / "jax_dev" / f"{q}.mat")
