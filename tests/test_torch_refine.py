"""Coarse-to-fine refinement of the port (``ncnet_tpu_torch/refine``, ROADMAP
A10) against the JAX package, its entry points, and the serving quality
ladder.

The gates: the pool, the window pointers, the rescore, the pipeline (dense
and streamed coarse band), the model's refined forward, the refined weak
loss and its NC gradients, and three Adam steps (each from JAX's own state,
read through the port's msgpack reader) agree with the JAX package at
float32's rtol 1e-5 / atol 1e-6 of each quantity's scale, indices equal;
factor 1 with radius 0 is the band bit for bit (values, indices, loss).
JAX's refinement sweep test fails on its own PCK figures, so the sweep is
held to the band-reduction contract and to JAX's `evaluate_synthetic` per
configuration. Both packages start from one JAX init (the bridge carries
the same NC parameters into the refined and streamed pipelines); inputs
are numpy from a seed.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.eval import inloc as jinloc
from ncnet_tpu.eval.pf_pascal import evaluate as jax_pf_evaluate
from ncnet_tpu.eval.synthetic import evaluate_synthetic as jax_evaluate_synthetic
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import immatchnet_apply as jax_apply
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.refine import pipeline as jpipe
from ncnet_tpu.refine import pool as jpool
from ncnet_tpu.refine import rescore as jrescore
from ncnet_tpu.train import checkpoint as jax_checkpoint
from ncnet_tpu.train import loss as jax_loss
from ncnet_tpu.train import step as jax_step
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.data.loader import collate
from ncnet_tpu_torch.data.pairs import PFPascalDataset, SyntheticPairDataset
from ncnet_tpu_torch.eval import inloc, pf_pascal, synthetic
from ncnet_tpu_torch.models.immatchnet import (
    ImMatchNet,
    ImMatchNetConfig,
    immatchnet_apply,
    match_pipeline,
)
from ncnet_tpu_torch.refine import (
    pool_features,
    refine_match_pipeline,
    refine_rescore,
    refine_window_indices,
)
from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
from ncnet_tpu_torch.serve.resilience import QualityLadder
from ncnet_tpu_torch.serve.step import make_serve_match_step
from ncnet_tpu_torch.sparse.pipeline import sparse_match_pipeline
from ncnet_tpu_torch.train import loss as port_loss
from ncnet_tpu_torch.train.checkpoint import load_checkpoint, restore, save_checkpoint
from ncnet_tpu_torch.train.step import create_train_state, make_train_step

# float32, the starting tolerance; the absolute part is relative to the
# compared quantity's scale
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3
PCK_ATOL = 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))
REFINE = dict(SMALL, refine_factor=2, refine_topk=4)
# the five fields a checkpoint carries for the stream and refinement
FIELDS = ("corr_impl", "corr_stream_tile", "refine_factor", "refine_topk",
          "refine_radius")


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _port(config_kw, seed=4):
    """(jax config, jax numpy tree, port config, port model on the CPU)."""
    jcfg = JaxConfig(**config_kw)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(seed), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return jcfg, tree, cfg, bridge.from_jax_params(tree, cfg, device="cpu")


def _feats(seed, b=2, h=8, w=8, c=256):
    """patch16-sized unit-norm features (a 128 px image's grid)."""
    x = np.random.RandomState(seed).randn(b, h, w, c).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _images(seed, b=2, hw=(128, 128)):
    rng = np.random.RandomState(seed)
    return {"source_image": rng.randn(b, 128, 128, 3).astype(np.float32),
            "target_image": rng.randn(b, *hw, 3).astype(np.float32)}


def _nc_leaves(tree_or_model):
    if isinstance(tree_or_model, dict):
        return [np.asarray(p[k]) for p in tree_or_model["neigh_consensus"]
                for k in ("kernel", "bias")]
    return [t.detach().numpy().copy()
            for p in tree_or_model.neigh_consensus.params()
            for t in (p["kernel"], p["bias"])]


# -- pool, window pointers, rescore ------------------------------------------


def test_pool_features_matches_jax():
    x = _feats(0, h=8, w=6)
    t = torch.from_numpy(x)
    assert pool_features(t, 1) is t  # the identity is the bitwise anchor
    for normalize in (True, False):
        _close(pool_features(t, 2, normalize=normalize),
               jpool.pool_features(jnp.asarray(x), 2, normalize=normalize))
    with pytest.raises(ValueError, match="does not divide"):
        pool_features(t, 4)  # 6 % 4
    with pytest.raises(ValueError, match=">= 1"):
        pool_features(t, 0)


@pytest.mark.parametrize("radius", [0, 1])
def test_refine_window_indices_match_jax(radius):
    idx = np.sort(np.random.RandomState(1).randint(0, 12, (2, 3, 4, 5)),
                  -1).astype(np.int32)
    widx, valid = refine_window_indices(torch.from_numpy(idx), (3, 4), (6, 8), 2,
                                        radius)
    jw, jv = jrescore.refine_window_indices(jnp.asarray(idx), (3, 4), (6, 8), 2,
                                            radius)
    assert widx.dtype == torch.int32 and widx.shape[-1] == (2 * (2 * radius + 1)) ** 2
    np.testing.assert_array_equal(widx.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="times the factor"):
        refine_window_indices(torch.from_numpy(idx), (3, 4), (6, 9), 2)


@pytest.mark.parametrize("radius", [0, 1])
def test_refine_rescore_matches_jax(radius):
    rng = np.random.RandomState(2)
    values = rng.rand(2, 3, 4, 5).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(12, 5, replace=False))
                    for _ in range(24)]).reshape(2, 3, 4, 5).astype(np.int32)
    fa, fb = _feats(3, h=6, w=8, c=16), _feats(4, h=6, w=8, c=16)
    got = refine_rescore(torch.from_numpy(values), torch.from_numpy(idx), (3, 4),
                         torch.from_numpy(fa), torch.from_numpy(fb), 2, radius)
    want = jrescore.refine_rescore(jnp.asarray(values), jnp.asarray(idx), (3, 4),
                                   jnp.asarray(fa), jnp.asarray(fb), 2, radius)
    assert got[2] == tuple(want[2]) == (6, 8)
    assert got[0].shape == (2, 6, 8, 5) and got[1].dtype == torch.int32
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -- the pipeline and the model -----------------------------------------------


@pytest.mark.parametrize("corr_impl", ["dense", "stream"])
@pytest.mark.parametrize("radius", [0, 1])
def test_refine_pipeline_matches_jax(corr_impl, radius):
    """patch16-sized features, NC 3-3 / 4-1, factor 2, the coarse band dense
    or streamed; the same JAX NC parameters drive both packages."""
    kw = dict(REFINE, refine_radius=radius, corr_impl=corr_impl,
              corr_stream_tile=5)
    jcfg, tree, cfg, model = _port(kw)
    fa, fb = _feats(5), _feats(6, h=8, w=6)
    got = refine_match_pipeline(model.neigh_consensus.params(), cfg,
                                torch.from_numpy(fa), torch.from_numpy(fb),
                                layer=model.neigh_consensus.band_layer)
    want = jpipe.refine_match_pipeline(tree["neigh_consensus"], jcfg,
                                       jnp.asarray(fa), jnp.asarray(fb))
    assert got[2] == tuple(want[2]) == (8, 6)
    assert got[0].shape == (2, 8, 8, 4)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("corr_impl", ["dense", "stream"])
def test_refine_factor1_is_the_band_bitwise(corr_impl):
    """Factor 1, radius 0: the pool is the identity and every window one
    entry, so the refined band, the refined forward and the refined loss
    are the K band's bit for bit."""
    _, _, cfg, model = _port(SMALL)
    cfg = cfg.replace(corr_impl=corr_impl, corr_stream_tile=5)
    ref = cfg.replace(refine_factor=1, refine_topk=5)
    band = cfg.replace(nc_topk=5)
    fa, fb = torch.from_numpy(_feats(7)), torch.from_numpy(_feats(8, h=6, w=8))
    nc = model.neigh_consensus
    got = refine_match_pipeline(nc.params(), ref, fa, fb, layer=nc.band_layer)
    want = sparse_match_pipeline(nc.params(), band, fa, fb, layer=nc.band_layer)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(match_pipeline(nc, ref, fa, fb), match_pipeline(nc, band, fa, fb))
    assert torch.equal(port_loss.weak_loss_core(nc, ref, fa, fb),
                       port_loss.weak_loss_core(nc, band, fa, fb))


def test_refine_full_k_chains_to_dense():
    """Factor 1, radius 0 at K = hB*wB is the complete band bit for bit, and
    through the band's own contract the dense pipeline (to float32's
    tolerance: the band NC layer and the dense conv4d sum in other
    orders, tests/test_torch_sparse.py)."""
    _, _, cfg, model = _port(SMALL)
    nc = model.neigh_consensus
    fa, fb = torch.from_numpy(_feats(9, h=4, w=4)), torch.from_numpy(_feats(10, h=4, w=3))
    ref = match_pipeline(nc, cfg.replace(refine_factor=1, refine_topk=12), fa, fb)
    assert torch.equal(ref, match_pipeline(nc, cfg.replace(nc_topk=12), fa, fb))
    _close(ref, match_pipeline(nc, cfg, fa, fb).numpy())


def test_refined_forward_and_weak_loss_match_jax():
    """A square source against a 96x128 target (JAX's side jitted: one
    compile instead of one an op)."""
    jcfg, tree, cfg, model = _port(REFINE)
    batch = _images(11, hw=(96, 128))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_side(nc):
        def f(nc):
            return jax_loss.weak_loss(dict(tree, neigh_consensus=nc), jcfg, jb)

        corr = jax_apply(dict(tree, neigh_consensus=nc), jcfg,
                         jb["source_image"], jb["target_image"])
        return corr, jax.value_and_grad(f)(nc)

    want, (want_l, want_g) = jax_side(tree["neigh_consensus"])
    got = immatchnet_apply(model, cfg, *(torch.from_numpy(batch[k])
                                         for k in ("source_image", "target_image")))
    assert got.shape == (2, 8, 8, 6, 8)
    _close(got, want)
    leaves = model.neigh_consensus.trainable()
    loss = port_loss.weak_loss(model, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    loss.backward()
    _close(loss, want_l)
    refs = _nc_leaves({"neigh_consensus": want_g})
    assert any(np.abs(r).max() > 0 for r in refs)
    for t, ref in zip(leaves, refs):
        _close(t.grad, ref)


@pytest.fixture(scope="module")
def jax_refine_run(tmp_path_factory):
    """JAX's make_train_step with refinement (factor 2, K 4, NC 3-3 / 4-1,
    128 px, batch 2, float32) over 3 batches: the state before each step
    as a msgpack file (JAX's writer), the losses and the NC params after
    each step."""
    jcfg, tree, _, _ = _port(dict(REFINE, half_precision=False,
                                  corr_impl="stream", corr_stream_tile=7))
    opt = jax_step.make_optimizer(LR)
    state = jax_step.create_train_state(jax.tree.map(jnp.asarray, tree), opt)
    step = jax_step.make_train_step(jcfg, opt, donate=False)
    root = tmp_path_factory.mktemp("jax_refine")
    batches = [_images(20 + i) for i in range(3)]
    paths, losses, params = [], [], []
    for k, b in enumerate(batches):
        path = str(root / f"step{k}.msgpack")
        jax_checkpoint.save_checkpoint(path, jax_checkpoint.CheckpointData(
            config=jcfg, params=state.params, opt_state=state.opt_state,
            step=int(state.step), epoch=0), keep=1)
        paths.append(path)
        state, loss = step(state, {n: jnp.asarray(v) for n, v in b.items()})
        losses.append(float(loss))
        params.append(_nc_leaves(jax.tree.map(np.asarray, state.params)))
    return dict(jcfg=jcfg, batches=batches, paths=paths, losses=losses,
                params=params)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_refined_train_step_from_jax_state_matches_jax(jax_refine_run, k):
    """Each step from JAX's state before it: the loss and the NC params
    after the step (Adam scales each update to about lr: where gradients
    nearly cancel, m / sqrt(v) magnifies their float32 differences, so 1%
    of lr absolute, as tests/test_torch_band_train.py holds its steps)."""
    ck = load_checkpoint(jax_refine_run["paths"][k])
    assert ck.step == k
    assert {f: getattr(ck.config, f) for f in FIELDS} == {
        f: getattr(jax_refine_run["jcfg"], f) for f in FIELDS}
    model = bridge.from_jax_params(ck.params, ck.config, device="cpu")
    state = restore(create_train_state(model, LR), ck)
    state, loss = make_train_step(ck.config)(state, jax_refine_run["batches"][k])
    _close(loss, jax_refine_run["losses"][k])
    for got, ref in zip(_nc_leaves(model), jax_refine_run["params"][k]):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-2 * LR)
    assert state.step == k + 1


def test_synthetic_pck_vs_refine_matches_jax():
    jcfg, tree, cfg, model = _port(SMALL)
    ds = SyntheticPairDataset(n=4, output_size=(64, 64), seed=5, return_shift=True)
    batch = collate([ds[i] for i in range(4)])
    got = synthetic.synthetic_pck_vs_refine(model, cfg, [batch], [0, 1, 2], [3],
                                            alpha=0.15)
    assert sorted(got) == [(0, 0), (1, 3), (2, 3)]
    band = synthetic.synthetic_pck_vs_topk(model, cfg, [batch], ks=[0, 3], alpha=0.15)
    assert got[(1, 3)] == band[3] and got[(0, 0)] == band[0]
    want = jax_evaluate_synthetic(tree, jcfg.replace(refine_factor=2, refine_topk=3),
                                  [batch], alpha=0.15)
    assert abs(got[(2, 3)] - want) <= PCK_ATOL


# -- checkpoints and the CLIs ---------------------------------------------------


def test_checkpoints_round_trip_the_stream_and_refine_fields(tmp_path):
    kw = dict(REFINE, refine_radius=1, corr_impl="stream", corr_stream_tile=96)
    jcfg, tree, cfg, model = _port(kw)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, create_train_state(model, LR), cfg, epoch=0)
    assert load_checkpoint(path).config == cfg
    jpath = str(tmp_path / "ck.msgpack")
    jax_checkpoint.save_checkpoint(jpath, jax_checkpoint.CheckpointData(
        config=jcfg, params=tree, opt_state=None, step=0, epoch=0), keep=1)
    got = load_checkpoint(jpath).config
    assert {f: getattr(got, f) for f in FIELDS} == {
        "corr_impl": "stream", "corr_stream_tile": 96, "refine_factor": 2,
        "refine_topk": 4, "refine_radius": 1}


TOY = ["--synthetic", "--allow_random_fe", "--device", "cpu", "--fe_arch",
       "patch16", "--image_size", "64", "--ncons_kernel_sizes", "3", "3",
       "--ncons_channels", "4", "1", "--batch_size", "2", "--synthetic_pairs",
       "8", "--num_workers", "1", "--num_epochs", "1"]


def test_train_cli_stream_and_refine_flags_and_resume(tmp_path):
    from ncnet_tpu_torch.train.__main__ import main as train_main

    out = str(tmp_path / "run")
    report = train_main(TOY + ["--refine", "2", "--refine_topk", "3",
                               "--refine_radius", "1", "--corr-impl", "stream",
                               "--corr-tile", "3", "--result_model_dir", out,
                               "--max-steps", "1"])
    want = {"corr_impl": "stream", "corr_stream_tile": 3, "refine_factor": 2,
            "refine_topk": 3, "refine_radius": 1}
    assert {f: report["config"][f] for f in FIELDS} == want
    assert report["steps"] == 1 and all(np.isfinite(report["step_losses"]))
    assert {f: getattr(load_checkpoint(report["checkpoint"]).config, f)
            for f in FIELDS} == want
    # unset keeps the checkpoint's values; a flag overrides either way
    kept = train_main(TOY + ["--result_model_dir", out, "--max-steps", "2",
                             "--checkpoint", report["checkpoint"]])
    assert {f: kept["config"][f] for f in FIELDS} == want and kept["steps"] == 2
    over = train_main(TOY + ["--result_model_dir", str(tmp_path / "o"),
                             "--max-steps", "3", "--checkpoint",
                             kept["checkpoint"], "--refine", "0",
                             "--nc_topk", "4", "--corr-impl", "dense"])
    assert over["config"]["refine_factor"] == 0
    assert over["config"]["corr_impl"] == "dense" and over["steps"] == 3


@pytest.mark.parametrize("argv,error,match", [
    # a 64 px image has a 4x4 feature grid (scripts/train.py's p.error)
    (["--refine", "3"], SystemExit, "2"),
    # the dense NC stack consumes the volume: nothing to stream
    (["--corr-impl", "stream"], ValueError, "requires a band path"),
    (["--refine", "2", "--refine_topk", "0"], ValueError, "positive band width"),
    (["--corr-impl", "tiled"], SystemExit, "2"),
])
def test_train_cli_refusals(tmp_path, argv, error, match):
    from ncnet_tpu_torch.train.__main__ import main as train_main

    with pytest.raises(error, match=match):
        train_main(TOY + ["--result_model_dir", str(tmp_path)] + argv)


@pytest.fixture(scope="module")
def pf_root(tmp_path_factory):
    """Two generated keypointed pairs in PF-Pascal's layout."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pf")
    (root / "image_pairs").mkdir()
    (root / "JPEGImages").mkdir()
    rng = np.random.RandomState(3)
    rows = []
    for i in range(2):
        cols = []
        names = []
        for side in "ab":
            name = f"JPEGImages/im{i}{side}.png"
            Image.fromarray(rng.randint(0, 255, (64, 56, 3), np.uint8)).save(root / name)
            names.append(name)
            cols.append(";".join(f"{v:.4f}" for v in rng.uniform(1, 56, 5)))
            cols.append(";".join(f"{v:.4f}" for v in rng.uniform(1, 64, 5)))
        rows.append(f"{names[0]},{names[1]},1," + ",".join(cols))
    (root / "image_pairs" / "test_pairs.csv").write_text(
        "source_image,target_image,class,XA,YA,XB,YB\n" + "\n".join(rows) + "\n")
    return root


def test_pf_pascal_cli_refine_matches_jax(pf_root, tmp_path, capsys):
    jcfg, tree, cfg, model = _port(SMALL)
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, create_train_state(model), cfg, epoch=0)
    argv = ["--checkpoint", ck, "--eval_dataset_path", str(pf_root),
            "--image_size", "64", "--batch_size", "2", "--num_workers", "1",
            "--device", "cpu"]
    report = pf_pascal.main(argv + ["--refine", "2", "--refine_topk", "3",
                                    "--refine_radius", "1"])
    capsys.readouterr()
    assert {f: report["config"][f] for f in FIELDS[2:]} == {
        "refine_factor": 2, "refine_topk": 3, "refine_radius": 1}
    ds = PFPascalDataset(str(pf_root / "image_pairs" / "test_pairs.csv"),
                         str(pf_root), output_size=(64, 64))
    want = jax_pf_evaluate(tree, jcfg.replace(refine_factor=2, refine_topk=3,
                                              refine_radius=1),
                           [collate([ds[0], ds[1]])], verbose=False)
    np.testing.assert_allclose(report["per_pair"], want["per_pair"], atol=PCK_ATOL)
    # factor 1, radius 0 is the K band
    one = pf_pascal.main(argv + ["--refine", "1", "--refine_topk", "3"])
    band = pf_pascal.evaluate(model, cfg.replace(nc_topk=3),
                              [pf_pascal.host_arrays(collate([ds[0], ds[1]]))],
                              verbose=False)
    assert one["per_pair"] == band["per_pair"]
    with pytest.raises(SystemExit, match="does not divide by --refine 3"):
        pf_pascal.main(argv + ["--refine", "3"])  # a 4x4 grid


@pytest.fixture(scope="module")
def inloc_root(tmp_path_factory):
    """One 96x128 query, two 128x96 panos (feature grids 6x8 and 8x6 at
    128 px, both even) and the shortlist .mat."""
    from PIL import Image
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("inloc_refine")
    (root / "query").mkdir()
    (root / "pano").mkdir()
    rng = np.random.RandomState(5)
    Image.fromarray(rng.randint(0, 255, (96, 128, 3), np.uint8)).save(root / "query" / "q0.png")
    panos = ["p0.png", "p1.png"]
    for name in panos:
        Image.fromarray(rng.randint(0, 255, (128, 96, 3), np.uint8)).save(root / "pano" / name)
    dt = np.dtype([("queryname", object), ("topN", object)])
    entries = np.zeros((1, 1), dt)
    entries[0, 0] = (np.array(["q0.png"], object), np.array([[p] for p in panos], object))
    savemat(root / "shortlist.mat", {"ImgList": entries})
    return root


def test_inloc_cli_refine_matches_jax(inloc_root, tmp_path, capsys):
    from scipy.io import loadmat

    jcfg, tree, cfg, model = _port(SMALL)
    ck = str(tmp_path / "tiny.npz")
    save_checkpoint(ck, create_train_state(model), cfg, epoch=0)
    argv = ["--checkpoint", ck, "--inloc_shortlist", str(inloc_root / "shortlist.mat"),
            "--query_path", str(inloc_root / "query"), "--pano_path",
            str(inloc_root / "pano"), "--output_root", str(tmp_path / "m"),
            "--image_size", "128", "--n_queries", "1", "--n_panos", "2",
            "--no-bf16", "--device", "cpu", "--refine", "2", "--refine_topk", "4"]
    with pytest.raises(SystemExit, match="requires --k_size 1"):
        inloc.main(argv + ["--k_size", "2"])
    report = inloc.main(argv + ["--k_size", "1"])
    capsys.readouterr()
    assert report["written"] == [1] and report["config"]["refine_factor"] == 2
    jinloc.dump_matches(tree, jcfg.replace(relocalization_k_size=1, refine_factor=2,
                                           refine_topk=4),
                        shortlist_path=str(inloc_root / "shortlist.mat"),
                        query_path=str(inloc_root / "query"),
                        pano_path=str(inloc_root / "pano"),
                        output_dir=str(tmp_path / "jax"), image_size=128,
                        n_queries=1, n_panos=2, verbose=False)
    got = loadmat(os.path.join(report["output_dir"], "1.mat"))["matches"]
    want = loadmat(str(tmp_path / "jax" / "1.mat"))["matches"]
    assert got.shape == want.shape
    for p in range(2):
        # the dump sorts rows by score: compare them as sets of rows
        g = got[0, p][np.abs(got[0, p]).sum(1) > 0]
        w = want[0, p][np.abs(want[0, p]).sum(1) > 0]
        assert len(g) == len(w) > 0
        _close(g[np.lexsort(g.T[::-1])], w[np.lexsort(w.T[::-1])])


# -- serving: the quality ladder and the refined rung ---------------------------


def test_quality_ladder_walks_one_rung_per_flip():
    ladder = QualityLadder(high=0.75, low=0.25, up_count=2, down_count=2)
    assert ladder.variant == "standard" and ladder.rung == 1
    seen = [ladder.update(p) for p in (0.9, 0.9, 0.9, 0.9, 0.9, 0.9)]
    # a sustained spike climbs one rung per up_count readings, then holds
    assert seen == ["standard", "degraded", "degraded", "degraded",
                    "degraded", "degraded"]
    assert ladder.degraded and ladder.flips == 1
    assert [ladder.update(p) for p in (0.1, 0.5, 0.1, 0.1, 0.1, 0.1)] == [
        "degraded", "degraded", "degraded", "standard", "standard", "refined"]
    assert ladder.flips == 3 and not ladder.degraded and ladder.rung == 0
    two = QualityLadder(rungs=("refined", "standard"), start="refined")
    for _ in range(10):
        two.update(1.0)
    assert two.variant == "standard" and not two.degraded  # named rungs


@pytest.mark.parametrize("kw,match", [
    (dict(rungs=("standard",)), ">= 2 rungs"),
    (dict(rungs=("standard", "standard")), "duplicate"),
    (dict(start="refined", rungs=("standard", "degraded")), "not in"),
    (dict(high=0.2, low=0.5), "low < high"),
    (dict(up_count=0), ">= 1"),
])
def test_quality_ladder_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        QualityLadder(**kw)


class _Pinned:
    """A quality controller that holds whatever rung the test sets."""

    def __init__(self):
        self.variant = "standard"
        self.degraded = False

    def update(self, pressure):
        return self.variant


def test_engine_serves_the_refined_rung():
    """An engine with all three programs: pinned requests run their rung's
    program (rows equal to that program alone), the refined batches are
    counted, and unpinned ones follow the controller's rung."""
    _, _, cfg, model = _port(SMALL)
    programs = {"standard": make_serve_match_step(cfg),
                "degraded": make_serve_match_step(cfg.replace(nc_topk=3)),
                "refined": make_serve_match_step(cfg.replace(refine_factor=2,
                                                             refine_topk=3))}
    rng = np.random.RandomState(9)
    payload = {"source_image": rng.randn(64, 64, 3).astype(np.float32),
               "target_image": rng.randn(64, 64, 3).astype(np.float32)}
    key = ((64, 64), (64, 64))
    ctrl = _Pinned()
    with ServeEngine(programs["standard"], model, device="cpu", max_batch=1,
                     degraded_apply_fn=programs["degraded"],
                     refined_apply_fn=programs["refined"],
                     quality_controller=ctrl) as engine:
        assert engine.warmup([(key, payload_spec(payload))]) == 3
        pinned = {v: engine.submit(key=key, payload=payload, variant=v)
                  for v in programs}
        results = {v: f.result(timeout=120) for v, f in pinned.items()}
        ctrl.variant = "refined"
        unpinned = engine.submit(key=key, payload=payload).result(timeout=120)
        report = engine.report()
    assert report["refined_batches"] == 2 and report["degraded_batches"] == 1
    assert report["variant"] == "refined" and report["failed"] == 0
    # (the engine's thread may sum the GEMMs in another blocking: float32
    # tolerance, as tests/test_torch_sparse.py holds its engine)
    batch = {k: torch.from_numpy(v[None]) for k, v in payload.items()}
    for v, res in results.items():
        with torch.inference_mode():
            want = programs[v](model, batch)["matches"][0].numpy()
        _close(res["matches"], want)
    _close(unpinned["matches"], results["refined"]["matches"])
    assert not np.array_equal(results["refined"]["matches"][4],
                              results["standard"]["matches"][4])


def test_engine_builds_a_ladder_and_clamps_what_it_cannot_serve():
    _, _, cfg, model = _port(SMALL)
    std = make_serve_match_step(cfg)
    with ServeEngine(std, model, device="cpu",
                     refined_apply_fn=make_serve_match_step(
                         cfg.replace(refine_factor=2, refine_topk=3))) as engine:
        assert isinstance(engine.controller, QualityLadder)
        assert engine.controller.rungs == ("refined", "standard")
        with pytest.raises(ValueError, match="no degraded program"):
            engine.submit(key=((64, 64), (64, 64)), payload={}, variant="degraded")
    ctrl = _Pinned()
    ctrl.variant = "refined"
    with ServeEngine(std, model, device="cpu", quality_controller=ctrl) as engine:
        assert engine._variant_now() == "standard"  # no refined program: clamped


def test_serve_cli_refined_ladder(capsys):
    from ncnet_tpu_torch.serve.__main__ import main as serve_main

    argv = ["--synthetic", "4", "--image-size", "64", "--cnn", "patch16",
            "--ncons-kernel-sizes", "3", "3", "--ncons-channels", "4", "1",
            "--device", "cpu", "--max-batch", "2"]
    report = serve_main(argv + ["--refine", "2", "--refine-topk", "3",
                                "--degrade", "3", "--corr-impl", "stream"])
    capsys.readouterr()
    assert report["completed"] == 4 and report["failed"] == 0
    assert report["refine_factor"] == 2 and report["corr_impl"] == "stream"
    # the standard program strips refinement and stays dense
    assert report["config"]["refine_factor"] == 0
    assert report["config"]["corr_impl"] == "dense"
    for bad, match in ((["--refine", "3"], "does not divide"),
                       (["--corr-impl", "stream"], "requires a band program")):
        with pytest.raises(SystemExit, match=match):
            serve_main(argv + bad)
