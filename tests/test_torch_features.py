"""The port's frozen-trunk feature cache against the JAX package on the CPU:
`trunk_digest` (the msgpack bytes flax writes, then the config JSON), the
stores' bytes on disk (shards, manifests, sidecars; float32 and bfloat16),
stores written by either package read by the other, bitrot and stale
stores refused, the lazy fill, the feature loader (pinned and unpinned),
the weak loss and one Adam step from a store against JAX's eager
``make_train_step(from_features=True)``, the gallery and multi-resolution
stores, the extraction CLI, serving from a gallery store and the cached
InLoc dump.

One module-scoped JAX store (patch16, NC 3-3 / 4-1, 64 px, 8 pairs) is
shared; weights come from the JAX init through `ncnet_tpu_torch.bridge`.
float32 parity: rtol 1e-5 / atol 1e-6 of the compared quantity's scale."""

import os

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from ncnet_tpu.data.pairs import SyntheticPairDataset as JaxSyntheticPairDataset
from ncnet_tpu.eval import inloc as jinloc
from ncnet_tpu.features import FeatureStore as JaxFeatureStore
from ncnet_tpu.features import GalleryFeatureStore as JaxGalleryFeatureStore
from ncnet_tpu.features import MultiResFeatureStore as JaxMultiResFeatureStore
from ncnet_tpu.features import populate_store as jax_populate_store
from ncnet_tpu.features import populate_store_multires as jax_populate_multires
from ncnet_tpu.features import pooled_digest as jax_pooled_digest
from ncnet_tpu.features import trunk_digest as jax_trunk_digest
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.train import loss as jax_loss
from ncnet_tpu.train import step as jax_step
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.data.features_loader import FeatureBatchLoader
from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
from ncnet_tpu_torch.eval import inloc
from ncnet_tpu_torch.features import (
    FeatureCacheMismatch,
    FeatureStore,
    GalleryFeatureStore,
    MultiResFeatureStore,
    pooled_digest,
    populate_store,
    populate_store_multires,
    trunk_digest,
)
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.resilience.durable import IntegrityError
from ncnet_tpu_torch.train import loss as port_loss
from ncnet_tpu_torch.train.jax_checkpoint import msgpack_serialize, packb
from ncnet_tpu_torch.train.step import create_train_state, make_train_step

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))
SIZE = (64, 64)
N_PAIRS = 8
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the suite runs several test
    processes on the CPU at once; more threads oversubscribe it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jcfg, tree):
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return cfg, bridge.from_jax_params(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The JAX side's populated float32 store, its weights and dataset, and
    the port's model and dataset on the same weights and seeds."""
    jcfg = JaxConfig(**SMALL)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(0), jcfg))
    jds = JaxSyntheticPairDataset(n=N_PAIRS, output_size=SIZE, seed=3)
    digest = jax_trunk_digest(tree["feature_extraction"], jcfg, SIZE)
    root = tmp_path_factory.mktemp("jax_store")
    store = JaxFeatureStore.open_or_create(str(root), digest, jcfg, SIZE, N_PAIRS)
    assert jax_populate_store(store, tree, jcfg, jds, batch_size=4) == N_PAIRS
    cfg, model = _port(jcfg, tree)
    ds = SyntheticPairDataset(n=N_PAIRS, output_size=SIZE, seed=3)
    return dict(jcfg=jcfg, tree=tree, digest=digest, jstore=store, cfg=cfg,
                model=model, ds=ds, jds=jds)


def _trunk(model):
    return bridge.to_jax_params(model)["feature_extraction"]


def _bits(x):
    """Raw bits of a tensor or array, for bitwise comparison (bfloat16 as
    its 2-byte words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _to_jax_array(t):
    """A port shard as the array the JAX package stores (ml_dtypes bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# -- the digest -------------------------------------------------------------


def test_msgpack_writer_gives_flax_bytes():
    objs = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
            -1, -32, -33, -129, -40000, -2 ** 33, 1.5, "a" * 31, "b" * 32,
            "c" * 300, b"x", b"y" * 300, {str(i): i for i in range(20)},
            np.float32(3), np.zeros((2, 3), np.float32), np.zeros(0, np.int64),
            np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2],
            np.ones((17,), np.float32)]
    for obj in objs:
        want = msgpack.packb(obj, default=serialization._msgpack_ext_pack,
                             strict_types=True)
        assert packb(obj) == want, obj
    tree = {"b": [np.ones((2, 2), np.float32)] * 11, "a": {"z": np.zeros(3),
                                                           "y": np.ones(1)}}
    want = serialization.msgpack_serialize(serialization.to_state_dict(
        jax.tree.map(np.asarray, tree)))
    assert msgpack_serialize(tree) == want  # '10' sorts before '2'


@pytest.mark.parametrize("cnn", ["resnet101", "vgg", "densenet201"])
def test_trunk_digest_equals_jax(cnn):
    """The port's trunk tree (a random port model's) hashes as the JAX
    package hashes the same tree (patch16 from a JAX init: the next test)."""
    cfg = ImMatchNetConfig(**dict(SMALL, feature_extraction_cnn=cnn),
                           half_precision=True)
    model = ImMatchNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    fe = _trunk(model)
    jcfg = JaxConfig(**cfg.to_dict())
    for size in (SIZE, None):
        assert trunk_digest(fe, cfg, size) == jax_trunk_digest(fe, jcfg, size)


def test_trunk_digest_moves_with_weights_and_config(cache):
    cfg, model = cache["cfg"], cache["model"]
    fe = _trunk(model)
    base = trunk_digest(fe, cfg, SIZE)
    assert base == cache["digest"]
    moved = jax.tree.map(np.copy, fe)
    moved["kernel"][0, 0, 0, 0] += 1e-3
    other_cnn = ImMatchNetConfig(feature_extraction_cnn="resnet101")
    for digest in (trunk_digest(moved, cfg, SIZE),
                   trunk_digest(fe, other_cnn, SIZE),
                   trunk_digest(fe, cfg, (64, 48)),
                   trunk_digest(fe, cfg.replace(half_precision=True), SIZE),
                   trunk_digest(fe, cfg.replace(center_features=True), SIZE),
                   trunk_digest(fe, cfg.replace(normalize_features=False), SIZE)):
        assert digest != base
    assert trunk_digest(fe, cfg, SIZE) == base  # deterministic


# -- bytes on disk and cross-package reads ----------------------------------


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bfloat16"])
def test_store_bytes_equal_jax(cache, tmp_path, half):
    """Manifest, shards and sidecars byte for byte the JAX package's, for
    the pair store and the gallery store."""
    jcfg = cache["jcfg"].replace(half_precision=half)
    cfg = cache["cfg"].replace(half_precision=half)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(3, 3, 7).astype(np.float32))
    if half:
        feats = feats.to(torch.bfloat16)
    ours = FeatureStore.create(str(tmp_path / "port"), "d" * 64, cfg, SIZE, 2)
    theirs = JaxFeatureStore.create(str(tmp_path / "jax"), "d" * 64, jcfg, SIZE, 2)
    ours.put(1, feats, feats * 2)
    theirs.put(1, _to_jax_array(feats), _to_jax_array(feats * 2))
    assert _files(ours.root) == _files(theirs.root)
    assert ours.missing() == theirs.missing() == [0]
    gal = GalleryFeatureStore.create(str(tmp_path / "gport"), "e" * 64, cfg)
    jgal = JaxGalleryFeatureStore.create(str(tmp_path / "gjax"), "e" * 64, jcfg)
    gal.put("pano/a.jpg", feats[None])
    jgal.put("pano/a.jpg", _to_jax_array(feats[None]))
    assert gal.shard_path("pano/a.jpg").endswith(
        os.path.basename(jgal.shard_path("pano/a.jpg")))
    assert _files(gal.root) == _files(jgal.root)
    got = GalleryFeatureStore.open_store(jgal.root, expected_digest="e" * 64)
    np.testing.assert_array_equal(_bits(got.get("pano/a.jpg")),
                                  _bits(jgal.get("pano/a.jpg")))


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bfloat16"])
def test_stores_read_across_packages(cache, tmp_path, half):
    """A JAX-populated store opens in the port under the port's digest and
    reads bit for bit; a port-populated one opens in JAX, reads bit for bit
    and holds the JAX trunk's features (float32: rtol 1e-5; bfloat16:
    within one bfloat16 step, the rounding of float32 sums that differ in
    the last bits)."""
    jcfg = cache["jcfg"].replace(half_precision=half)
    cfg = cache["cfg"].replace(half_precision=half)
    tree, model = cache["tree"], cache["model"]
    jdigest = jax_trunk_digest(tree["feature_extraction"], jcfg, SIZE)
    assert trunk_digest(_trunk(model), cfg, SIZE) == jdigest
    jstore = JaxFeatureStore.open_or_create(str(tmp_path / "jax"), jdigest, jcfg,
                                            SIZE, N_PAIRS)
    jax_populate_store(jstore, tree, jcfg, cache["jds"], batch_size=4)
    read = FeatureStore.open_store(jstore.root, expected_digest=jdigest,
                                   num_items=N_PAIRS)
    assert read.complete()
    pstore = FeatureStore.open_or_create(str(tmp_path / "port"), jdigest, cfg,
                                         SIZE, N_PAIRS)
    assert populate_store(pstore, model, cfg, cache["ds"], batch_size=4) == N_PAIRS
    jread = JaxFeatureStore.open_store(pstore.root, expected_digest=jdigest,
                                       num_items=N_PAIRS)
    for i in (0, 5):
        for got, want in zip(read.get(i), jstore.get(i)):
            assert got.dtype == (torch.bfloat16 if half else torch.float32)
            np.testing.assert_array_equal(_bits(got), _bits(want))
        for got, want, jax_feat in zip(pstore.get(i), jread.get(i), jstore.get(i)):
            np.testing.assert_array_equal(_bits(got), _bits(want))
            ref = np.asarray(jax_feat, np.float32)
            tol = dict(rtol=2 ** -7, atol=2 ** -7) if half else dict(rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_durable_writes_and_walk_back_match_jax(tmp_path):
    """The port's durable writes give the JAX module's file and sidecar
    bytes; retention keeps the newest K step copies, and `latest_valid`
    walks back past a corrupt latest file as JAX's does."""
    from ncnet_tpu.resilience import durable as jax_durable
    from ncnet_tpu_torch.resilience import durable

    blob = np.random.RandomState(0).bytes(1000)
    ours = durable.durable_write_bytes(str(tmp_path / "port" / "a.bin"), blob)
    theirs = jax_durable.durable_write_bytes(str(tmp_path / "jax" / "a.bin"), blob)
    assert _files(os.path.dirname(ours)) == _files(os.path.dirname(theirs))
    path = str(tmp_path / "ck.bin")
    for step in range(4):
        durable.durable_write_bytes(path, bytes([step]) * 10)
        durable.retain(path, step, keep=2)
    assert durable.candidates(path) == jax_durable.candidates(path) == [
        path, durable.step_path(path, 3), durable.step_path(path, 2)]
    with open(path, "r+b") as f:  # a deliberate raw rewrite: bitrot
        f.write(b"x")
    with pytest.raises(IntegrityError):
        durable.read_verified_bytes(path)
    got = durable.latest_valid(path, lambda p: open(p, "rb").read())
    assert got == jax_durable.latest_valid(path, lambda p: open(p, "rb").read())
    # the newest history entry is a hardlink of the primary: the same bitrot
    assert got == (bytes([2]) * 10, durable.step_path(path, 2))


def test_bitrot_detected_and_stale_store_rejected(cache, tmp_path):
    jstore, digest = cache["jstore"], cache["digest"]
    store = FeatureStore.open_store(jstore.root, expected_digest=digest)
    stale = trunk_digest(_trunk(cache["model"]), cache["cfg"], (48, 48))
    with pytest.raises(FeatureCacheMismatch, match="digest"):
        FeatureStore.open_store(jstore.root, expected_digest=stale)
    with pytest.raises(FeatureCacheMismatch, match="items"):
        FeatureStore.open_store(jstore.root, expected_digest=digest,
                                num_items=N_PAIRS + 1)
    with pytest.raises(FeatureCacheMismatch):  # no fall-through to create
        FeatureStore.open_or_create(jstore.root, stale, cache["cfg"], SIZE, N_PAIRS)
    with pytest.raises(FeatureCacheMismatch, match="not a gallery"):
        GalleryFeatureStore.open_store(jstore.root)
    copy = FeatureStore.create(str(tmp_path), digest, cache["cfg"], SIZE, 1)
    copy.put(0, *store.get(0))
    path = copy.shard_path(0, "source")
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    with open(path, "wb") as f:  # a deliberate raw rewrite: bitrot
        f.write(bytes(blob))
    with pytest.raises(IntegrityError):
        copy.get(0)
    with pytest.raises(ValueError, match="does not match the store"):
        copy.put(0, torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2))


def test_populate_is_lazy_and_idempotent(cache, tmp_path):
    cfg, model, ds = cache["cfg"], cache["model"], cache["ds"]
    store = FeatureStore.open_or_create(str(tmp_path), cache["digest"], cfg, SIZE,
                                        N_PAIRS)
    assert populate_store(store, model, cfg, ds, batch_size=3) == N_PAIRS
    src = store.get(2)[0]
    assert src.dtype == torch.float32 and tuple(src.shape) == (4, 4, 256)
    assert populate_store(store, model, cfg, ds, batch_size=3) == 0
    os.remove(store.shard_path(6, "target"))
    assert store.missing() == [6]
    assert populate_store(store, model, cfg, ds, batch_size=3) == 1
    np.testing.assert_array_equal(store.get(2)[0].numpy(), src.numpy())
    with pytest.raises(ValueError, match="records 8"):
        populate_store(store, model, cfg, SyntheticPairDataset(
            n=3, output_size=SIZE, seed=3))


# -- the loader and the cached training step --------------------------------


def test_feature_loader_pinned_equals_unpinned(cache, tmp_path):
    store = FeatureStore.open_store(cache["jstore"].root)
    with FeatureBatchLoader(store, 3, shuffle=True, seed=7, num_workers=2) as ld, \
            FeatureBatchLoader(store, 3, shuffle=True, seed=7, num_workers=2,
                               pin_hbm=True, device="cpu") as pinned:
        assert len(ld) == len(pinned) == 3
        for epoch, skip in ((0, 0), (1, 0), (1, 2)):
            a = list(ld.iter_epoch(epoch, skip))
            b = list(pinned.iter_epoch(epoch, skip))
            assert len(a) == len(b) == 3 - skip
            for x, y in zip(a, b):
                for k in ("source_features", "target_features"):
                    assert torch.equal(x[k], y[k])
        assert pinned.pinned_nbytes() == N_PAIRS * store.shard_nbytes(0)
    incomplete = FeatureStore.create(str(tmp_path), cache["digest"], cache["cfg"],
                                     SIZE, 2)
    with pytest.raises(ValueError, match="missing 2 of 2"):
        FeatureBatchLoader(incomplete, 2)


def _jax_feature_batch(store, idx):
    pairs = [store.get(i) for i in idx]
    return {"source_features": np.stack([p[0] for p in pairs]),
            "target_features": np.stack([p[1] for p in pairs])}


@pytest.mark.parametrize("nc_topk", [0, 4], ids=["dense", "band"])
def test_loss_and_adam_step_from_store_match_jax(cache, nc_topk):
    """`weak_loss_from_features` and one Adam step from the JAX store's
    features against the JAX package's eager cached step; the port's
    cached step runs no trunk op."""
    jcfg = cache["jcfg"].replace(nc_topk=nc_topk)
    cfg = cache["cfg"].replace(nc_topk=nc_topk)
    idx = [3, 0, 6, 1]
    jbatch = _jax_feature_batch(cache["jstore"], idx)
    pstore = FeatureStore.open_store(cache["jstore"].root)
    pairs = [pstore.get(i) for i in idx]
    batch = {"source_features": torch.stack([p[0] for p in pairs]),
             "target_features": torch.stack([p[1] for p in pairs])}
    _, model = _port(jcfg, cache["tree"])
    with jax.disable_jit():
        want_loss = float(jax_loss.weak_loss_from_features(cache["tree"], jcfg, jbatch))
        opt = jax_step.make_optimizer(LR)
        jstate = jax_step.create_train_state(cache["tree"], opt)
        jstate, jl = jax_step.make_train_step(jcfg, opt, donate=False,
                                              from_features=True)(jstate, jbatch)
    with torch.no_grad():
        got_loss = float(port_loss.weak_loss_from_features(model, cfg, batch))
    scale = max(1.0, abs(want_loss))
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL, atol=ATOL * scale)
    calls = []
    hook = model.feature_extraction.register_forward_hook(lambda *a: calls.append(1))
    state, loss = make_train_step(cfg, from_features=True)(
        create_train_state(model, LR), batch)
    hook.remove()
    assert calls == [] and state.step == 1
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL * scale)
    got = bridge.to_jax_params(model)["neigh_consensus"]
    for g, w in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jstate.params["neigh_consensus"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(w).max())))
    with pytest.raises(ValueError, match="frozen"):
        make_train_step(cfg, fe_finetune_blocks=1, from_features=True)


# -- gallery and multi-resolution stores ------------------------------------


def test_multires_store_matches_jax(cache, tmp_path):
    cfg, jcfg, model, tree = cache["cfg"], cache["jcfg"], cache["model"], cache["tree"]
    digest = cache["digest"]
    assert pooled_digest(digest, 2) == jax_pooled_digest(digest, 2)
    ours = MultiResFeatureStore.open_or_create(str(tmp_path / "port"), digest, cfg,
                                               SIZE, N_PAIRS, 2)
    theirs = JaxMultiResFeatureStore.open_or_create(str(tmp_path / "jax"), digest,
                                                    jcfg, SIZE, N_PAIRS, 2)
    assert populate_store_multires(ours, model, cfg, cache["ds"], batch_size=4) == N_PAIRS
    jax_populate_multires(theirs, tree, jcfg, cache["jds"], batch_size=4)
    assert populate_store_multires(ours, model, cfg, cache["ds"], batch_size=4) == 0
    for i in (0, 7):
        for got_tier, want_tier in zip(ours.get(i), theirs.get(i)):
            for got, want in zip(got_tier, want_tier):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=RTOL, atol=ATOL)
    assert tuple(ours.get(0)[1][0].shape) == (2, 2, 256)
    reopened = JaxMultiResFeatureStore.open_store(ours.hi.root[:-3], 2,
                                                  expected_digest=digest)
    assert reopened.complete()
    with pytest.raises(FeatureCacheMismatch):
        MultiResFeatureStore.open_store(str(tmp_path / "jax"), 2,
                                        expected_digest="c" * 64)


# -- the extraction CLI, serving and InLoc from a store ---------------------


def test_extraction_cli_feeds_training(tmp_path, capsys):
    from ncnet_tpu_torch.features.__main__ import main as extract_main
    from ncnet_tpu_torch.train.__main__ import main as train_main

    cache_dir = str(tmp_path / "cache")
    common = ["--synthetic", "--allow_random_fe", "--device", "cpu",
              "--image_size", "64", "--seed", "2"]
    argv = ["--feature-cache", cache_dir, "--synthetic_n", "4", "--fe_arch",
            "patch16", "--bf16"] + common
    assert extract_main(argv) == 0
    assert extract_main(argv) == 0
    out = capsys.readouterr().out
    assert "train: extracted 4 pairs" in out and "train: already complete" in out
    train = common + [
        "--fe_arch", "patch16", "--ncons_kernel_sizes", "3", "3",
        "--ncons_channels", "4", "1", "--batch_size", "2", "--synthetic_pairs",
        "4", "--num_epochs", "1", "--num_workers", "1", "--feature-cache",
        cache_dir, "--result_model_dir", str(tmp_path / "run")]
    # dense pinned, the band streamed, refined: all from the same stores
    for extra in (["--pin-features"],
                  ["--nc_topk", "4", "--corr-impl", "stream", "--corr-tile", "5"],
                  ["--refine", "2", "--refine_topk", "4"]):
        report = train_main(train + extra)
        assert {s: r["extracted"] for s, r in report["feature_cache"].items()} == {
            "train": 0, "val": 0}
        assert report["steps"] == 2 and all(np.isfinite(report["step_losses"]))
    with pytest.raises(FeatureCacheMismatch):  # another trunk: another digest
        train_main(common[:-1] + ["3", "--fe_arch", "patch16",
                                  "--feature-cache", cache_dir,
                                  "--result_model_dir", str(tmp_path / "run2")])


def _serve(argv, results):
    from ncnet_tpu_torch.serve.__main__ import main as serve_main

    return serve_main(argv, results=results)


def test_serve_from_gallery_store_matches_image_path(tmp_path, capsys):
    """Served matches from a gallery store (cold, then warm) equal the image
    path's, on the standard and the degraded (band) programs."""
    argv = ["--synthetic", "4", "--image-size", "64", "--cnn", "patch16",
            "--ncons-kernel-sizes", "3", "3", "--ncons-channels", "4", "1",
            "--device", "cpu", "--max-batch", "1", "--concurrency", "1"]
    store = str(tmp_path / "gallery")
    for extra in ([], ["--nc-topk", "3"]):
        want, cold, warm = [], [], []
        _serve(argv + extra, want)
        _serve(argv + extra + ["--feature-store", store], cold)
        report = _serve(argv + extra + ["--feature-store", store], warm)
        assert report["completed"] == 4 and report["feature_store"] == store
        for w, c, h in zip(want, cold, warm):
            np.testing.assert_array_equal(c["matches"], w["matches"])
            np.testing.assert_array_equal(h["matches"], w["matches"])
    capsys.readouterr()
    assert len([f for f in os.listdir(store) if f.endswith(".feat")]) == 8


@pytest.fixture(scope="module")
def inloc_data(tmp_path_factory):
    """One query (80x60) against two panos (64x96), twice (two queries
    sharing their panos), and the shortlist ``.mat``."""
    from PIL import Image
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("inloc")
    for d in ("query", "pano"):
        (root / d).mkdir()
    rng = np.random.RandomState(5)
    panos = ["p0.png", "p1.png"]
    for name in panos:
        Image.fromarray(rng.randint(0, 255, (64, 96, 3), np.uint8)).save(root / "pano" / name)
    dt = np.dtype([("queryname", object), ("topN", object)])
    entries = np.zeros((1, 2), dt)
    for q in range(2):
        Image.fromarray(rng.randint(0, 255, (80, 60, 3), np.uint8)).save(
            root / "query" / f"q{q}.png")
        entries[0, q] = (np.array([f"q{q}.png"], object),
                         np.array([[p] for p in panos], object))
    savemat(root / "shortlist.mat", {"ImgList": entries})
    return root


def _mat(path):
    from scipy.io import loadmat

    return loadmat(path)["matches"]


def _same_rows(got, want):
    """Each pano's filled rows, as sets sorted by coordinates (the dedup's
    order; a near tie of scores may reorder the sort)."""
    assert got.shape == want.shape
    for p in range(got.shape[1]):
        g, w = got[0, p], want[0, p]
        filled = np.abs(w).sum(axis=1) > 0
        np.testing.assert_array_equal(np.abs(g).sum(axis=1) > 0, filled)
        g, w = g[filled], w[filled]
        g, w = (r[np.lexsort(r[:, :4].T[::-1])] for r in (g, w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_cached_inloc_dump_matches_jax(cache, inloc_data, tmp_path):
    jcfg = cache["jcfg"].replace(relocalization_k_size=2)
    cfg = cache["cfg"].replace(relocalization_k_size=2)
    model, tree = cache["model"], cache["tree"]
    kw = dict(shortlist_path=str(inloc_data / "shortlist.mat"),
              query_path=str(inloc_data / "query"),
              pano_path=str(inloc_data / "pano"), image_size=128, n_queries=2,
              n_panos=2, verbose=False)
    jinloc.dump_matches(tree, jcfg, output_dir=str(tmp_path / "jax"),
                        feature_store_dir=str(tmp_path / "jstore"), **kw)
    done = inloc.dump_matches(model, cfg, output_dir=str(tmp_path / "cold"),
                              feature_store_dir=str(tmp_path / "store"), **kw)
    # a pano's trunk runs on its first visit only: 2 panos, 4 pairs
    assert done == {"written": [1, 2], "skipped": [], "pairs": 4,
                    "panos_extracted": 2}
    warm = inloc.dump_matches(model, cfg, output_dir=str(tmp_path / "warm"),
                              feature_store_dir=str(tmp_path / "store"), **kw)
    assert warm["panos_extracted"] == 0
    # the JAX-written gallery store, read by the port
    cross = inloc.dump_matches(model, cfg, output_dir=str(tmp_path / "cross"),
                               feature_store_dir=str(tmp_path / "jstore"), **kw)
    assert cross["panos_extracted"] == 0
    inloc.dump_matches(model, cfg, output_dir=str(tmp_path / "images"), **kw)
    for q in (1, 2):
        want = _mat(tmp_path / "jax" / f"{q}.mat")
        for route in ("cold", "warm", "cross", "images"):
            _same_rows(_mat(tmp_path / route / f"{q}.mat"), want)
    with pytest.raises(ValueError, match="incompatible"):
        inloc.dump_matches(model, cfg, output_dir=str(tmp_path / "x"),
                           feature_store_dir=str(tmp_path / "store"),
                           device_preprocess=True, **kw)
    with pytest.raises(ValueError, match="feature maps"):
        inloc.make_match_fn(cfg, from_features=True, device_preprocess=True)
