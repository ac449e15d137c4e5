"""The port's evaluation against the JAX package on the CPU: coordinates,
both keypoint transfers, PCK, PFPascalDataset (both L_pck procedures),
the PF-Pascal PCK step and `evaluate` per pair, the synthetic PCK, the
serving eval, the full-K band sweep and the two CLIs at toy size.

Weights are made by the JAX init functions and reach the port through
`ncnet_tpu_torch.bridge`; inputs are numpy from the seeds written in each
test. float32 parity: rtol 1e-5 / atol 1e-6; per-pair PCK, a count of
discrete hits, is compared to 1e-6 (equal unless a keypoint lies on the
threshold to within float32 rounding)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.data.pairs import PFPascalDataset as JaxPFPascalDataset
from ncnet_tpu.data.pairs import SyntheticPairDataset as JaxSyntheticPairDataset
from ncnet_tpu.eval.pf_pascal import evaluate as jax_evaluate
from ncnet_tpu.eval.pf_pascal import make_pck_step as jax_make_pck_step
from ncnet_tpu.eval.synthetic import evaluate_synthetic as jax_evaluate_synthetic
from ncnet_tpu.eval.synthetic import make_synthetic_pck_step as jax_synthetic_step
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.ops import coords as jcoords
from ncnet_tpu.ops import matches as jmatches
from ncnet_tpu.ops.metrics import pck as jax_pck
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.data.loader import collate
from ncnet_tpu_torch.data.pairs import (
    MAX_KEYPOINTS,
    PFPascalDataset,
    SyntheticPairDataset,
)
from ncnet_tpu_torch.eval import pf_pascal, synthetic
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.ops import coords, matches
from ncnet_tpu_torch.ops.metrics import pck

# float32, the port's starting tolerance
RTOL, ATOL = 1e-5, 1e-6
# per-pair PCK: equal hit counts
PCK_ATOL = 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def small():
    """(jax config, jax numpy tree, port config, port model) from one
    JAX init."""
    jcfg = JaxConfig(**SMALL)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(0), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return jcfg, tree, cfg, bridge.from_jax_params(tree, cfg, device="cpu")


# -- coordinates -----------------------------------------------------------


def test_coords_match_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(1, 300, (3, 2, 7)).astype(np.float32)
    size = np.array([[240, 320, 3], [100, 50, 3], [7, 9, 3]], np.float32)
    unit = coords.points_to_unit_coords(torch.from_numpy(pts), torch.from_numpy(size))
    _close(unit, jcoords.points_to_unit_coords(jnp.asarray(pts), jnp.asarray(size)))
    back = coords.points_to_pixel_coords(unit, torch.from_numpy(size))
    _close(back, jcoords.points_to_pixel_coords(jnp.asarray(unit.numpy()),
                                                jnp.asarray(size)))
    _close(back, pts, rtol=1e-5, atol=1e-4)  # the round trip
    # the 1-indexed convention: pixel 1 is -1, pixel L is +1
    assert coords.normalize_axis(1.0, 9) == -1.0
    assert coords.normalize_axis(9.0, 9) == 1.0
    assert coords.unnormalize_axis(0.0, 9) == 5.0


@pytest.mark.parametrize("out_hw", [(7, 11), (3, 4), (5, 6)])
def test_resize_align_corners_matches_jax(out_hw):
    from ncnet_tpu.ops.image import resize_bilinear_align_corners as jax_resize

    from ncnet_tpu_torch.data.images import resize_bilinear_np

    # the port's one align-corners resize, on the host, as the evals call it
    img = np.random.RandomState(6).uniform(0, 255, (2, 5, 6, 3)).astype(np.float32)
    got = np.stack([resize_bilinear_np(im, *out_hw) for im in img])
    # 0..255 pixels: float32 resolves 1.5e-5 at 255, so atol is 1e-4 here
    _close(got, jax_resize(jnp.asarray(img), *out_hw), atol=1e-4)


# -- keypoint transfer -----------------------------------------------------


def _grid_matches(rng, b, h, w):
    """Matches in `corr_to_matches`' default direction: B on its grid, A
    anywhere in [-1, 1]."""
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    x_b = np.broadcast_to(gx.ravel(), (b, h * w)).astype(np.float32)
    y_b = np.broadcast_to(gy.ravel(), (b, h * w)).astype(np.float32)
    x_a = rng.uniform(-1, 1, (b, h * w)).astype(np.float32)
    y_a = rng.uniform(-1, 1, (b, h * w)).astype(np.float32)
    return x_a, y_a, x_b, y_b


@pytest.mark.parametrize("grid", [(5, 5), (4, 6)])
def test_transfers_match_jax(grid):
    rng = np.random.RandomState(1)
    h, w = grid
    m = _grid_matches(rng, 2, h, w)
    # inside, on the grid's corners and edges, and off the grid
    inside = rng.uniform(-1, 1, (2, 2, 6))
    edges = np.array([[-1, 1, -1, 1, 0], [-1, -1, 1, 1, 1]], np.float64)
    off = rng.uniform(-1.4, 1.4, (2, 2, 5))
    t = np.concatenate([inside, np.broadcast_to(edges, (2, 2, 5)), off],
                       axis=2).astype(np.float32)
    tm = tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in m)
    jm = tuple(jnp.asarray(v) for v in m)
    shape = None if h == w else grid
    got = matches.bilinear_point_transfer(tm, torch.from_numpy(t), shape)
    want = jmatches.bilinear_point_transfer(jm, jnp.asarray(t), shape)
    _close(got, want)
    got = matches.nearest_point_transfer(tm, torch.from_numpy(t))
    _close(got, jmatches.nearest_point_transfer(jm, jnp.asarray(t)))


def test_bilinear_transfer_rejects_bad_grid():
    m = tuple(torch.zeros(1, 12) for _ in range(4))
    with pytest.raises(ValueError, match="not square"):
        matches.bilinear_point_transfer(m, torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="does not factor"):
        matches.bilinear_point_transfer(m, torch.zeros(1, 2, 3), (5, 5))


# -- PCK -------------------------------------------------------------------


def test_pck_matches_jax_with_padding_and_nan():
    rng = np.random.RandomState(2)
    src = rng.uniform(0, 100, (4, 2, MAX_KEYPOINTS)).astype(np.float32)
    src[0, :, 7:] = -1  # trailing padding
    src[1, :, :] = -1  # no valid keypoint: scores 0
    src[2, 0, 3] = -1  # one coordinate padded: still valid
    warped = src + rng.normal(0, 8, src.shape).astype(np.float32)
    warped[3, :, :4] = np.nan  # never correct
    l_pck = np.array([[100], [100], [50], [80]], np.float32)
    got = pck(torch.from_numpy(src), torch.from_numpy(warped), torch.from_numpy(l_pck))
    want = jax_pck(jnp.asarray(src), jnp.asarray(warped), jnp.asarray(l_pck))
    _close(got, want)
    assert float(got[1]) == 0.0


# -- PFPascalDataset -------------------------------------------------------


@pytest.fixture(scope="module")
def pf_dataset(tmp_path_factory):
    """Generated PNGs and a ``test_pairs.csv`` in the dataset's layout:
    4 pairs over 2 classes, 3-11 keypoints each, images 48-80 px."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pf")
    (root / "image_pairs").mkdir()
    (root / "JPEGImages").mkdir()
    rng = np.random.RandomState(3)
    rows = []
    for i in range(4):
        names = []
        for side in "ab":
            hw = (48 + 8 * i, 80 - 8 * i)
            name = f"JPEGImages/im{i}{side}.png"
            Image.fromarray(rng.randint(0, 255, hw + (3,), np.uint8)).save(root / name)
            names.append((name, hw))
        n = 3 + 2 * i + (i == 3) * 2
        cols = []
        for _, (h, w) in names:
            cols.append(";".join(f"{v:.4f}" for v in rng.uniform(1, w, n)))
            cols.append(";".join(f"{v:.4f}" for v in rng.uniform(1, h, n)))
        rows.append(f"{names[0][0]},{names[1][0]},{1 + i % 2}," + ",".join(cols))
    csv = root / "image_pairs" / "test_pairs.csv"
    csv.write_text("source_image,target_image,class,XA,YA,XB,YB\n"
                   + "\n".join(rows) + "\n")
    return root, csv


@pytest.mark.parametrize("procedure,category", [("scnet", None), ("pf", None),
                                                ("scnet", 2)])
def test_pf_pascal_dataset_matches_jax(pf_dataset, procedure, category):
    root, csv = pf_dataset
    kw = dict(output_size=(32, 48), category=category, pck_procedure=procedure)
    ds = PFPascalDataset(str(csv), str(root), **kw)
    jds = JaxPFPascalDataset(str(csv), str(root), **kw)
    assert len(ds) == len(jds) == (2 if category else 4)
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].shape == want[k].shape, k
            _close(got[k], want[k])
    n = len(ds.rows[0][3].split(";"))  # -1 padding past the row's points
    assert np.all(ds[0]["source_points"][:, n:] == -1)
    assert np.all(ds[0]["source_points"][:, :n] != -1)


def test_pf_pascal_dataset_rejects_unknown_procedure(pf_dataset):
    root, csv = pf_dataset
    ds = PFPascalDataset(str(csv), str(root), pck_procedure="nope")
    with pytest.raises(ValueError, match="unknown pck procedure"):
        ds[0]


# -- PF-Pascal PCK ---------------------------------------------------------


@pytest.fixture(scope="module")
def pf_batches(pf_dataset):
    """The 4 pairs at 64 px in batches of 2 (one numpy list for both
    packages)."""
    root, csv = pf_dataset
    ds = PFPascalDataset(str(csv), str(root), output_size=(64, 64))
    return [collate([ds[i] for i in range(j, j + 2)]) for j in (0, 2)]


def test_pck_step_and_evaluate_match_jax_per_pair(small, pf_batches):
    jcfg, tree, cfg, model = small
    step = pf_pascal.pck_step_fn(cfg)
    jstep = jax_make_pck_step(jcfg)
    for batch in pf_batches:
        arrs = pf_pascal.host_arrays(batch)
        with torch.inference_mode():
            got = step(model, {k: torch.from_numpy(v) for k, v in arrs.items()})
        want = jstep(tree, {k: jnp.asarray(v) for k, v in arrs.items()})
        _close(got, want, atol=PCK_ATOL)
    got = pf_pascal.evaluate(model, cfg, pf_batches, verbose=False)
    want = jax_evaluate(tree, jcfg, pf_batches, verbose=False)
    np.testing.assert_allclose(got["per_pair"], want["per_pair"], atol=PCK_ATOL)
    assert got["n_valid"] == want["n_valid"] == 4
    assert abs(got["pck"] - want["pck"]) <= PCK_ATOL


def test_evaluate_serving_equals_evaluate(small, pf_batches):
    _, _, cfg, model = small
    want = pf_pascal.evaluate(model, cfg, pf_batches, verbose=False)
    got = pf_pascal.evaluate_serving(model, cfg, pf_batches, max_batch=2,
                                     verbose=False)
    np.testing.assert_allclose(got["per_pair"], want["per_pair"], atol=PCK_ATOL)
    assert got["serve"]["completed"] == 4 and got["serve"]["failed"] == 0


def test_pck_vs_topk_full_band_equals_dense(small, pf_batches):
    _, _, cfg, model = small
    full = 4 * 4  # the 64 px target's 4x4 grid
    out = pf_pascal.pck_vs_topk(model, cfg, pf_batches, ks=[0, 5, full])
    assert sorted(out) == [0, 5, full]
    np.testing.assert_allclose(out[full]["per_pair"], out[0]["per_pair"],
                               atol=PCK_ATOL)
    assert all(len(r["per_pair"]) == 4 for r in out.values())


# -- synthetic PCK ---------------------------------------------------------


def test_synthetic_pck_matches_jax_per_pair(small):
    jcfg, tree, cfg, model = small
    ds = SyntheticPairDataset(n=4, output_size=(64, 64), seed=5, return_shift=True)
    jds = JaxSyntheticPairDataset(n=4, output_size=(64, 64), seed=5,
                                  return_shift=True)
    batch = collate([ds[i] for i in range(4)])
    for k in batch:  # the two packages generate the same pairs
        np.testing.assert_array_equal(batch[k], np.stack([jds[i][k] for i in range(4)]))
    tb = {k: torch.from_numpy(np.asarray(batch[k], np.float32))
          for k in ("source_image", "target_image", "shift")}
    with torch.inference_mode():
        got = synthetic.make_synthetic_pck_step(cfg, alpha=0.15)(model, tb)
    want = jax_synthetic_step(jcfg, alpha=0.15)(
        tree, {k: jnp.asarray(v.numpy()) for k, v in tb.items()})
    _close(got, want, atol=PCK_ATOL)
    mean = synthetic.evaluate_synthetic(model, cfg, [batch], alpha=0.15)
    assert abs(mean - jax_evaluate_synthetic(tree, jcfg, [batch], alpha=0.15)) <= PCK_ATOL
    sweep = synthetic.synthetic_pck_vs_topk(model, cfg, [batch], ks=[0, 16],
                                            alpha=0.15)
    assert abs(sweep[16] - sweep[0]) <= PCK_ATOL and abs(sweep[0] - mean) <= PCK_ATOL
    # refinement (ROADMAP A10, once refused): the factor-1, radius-0 row
    # is the band's PCK, the complete coarse band's the dense one
    refine = synthetic.synthetic_pck_vs_refine(model, cfg, [batch], [0, 1],
                                               [5, 16], alpha=0.15)
    assert sorted(refine) == [(0, 0), (1, 5), (1, 16)]
    band = synthetic.synthetic_pck_vs_topk(model, cfg, [batch], ks=[5],
                                           alpha=0.15)
    assert refine[(1, 5)] == band[5]
    assert refine[(1, 16)] == sweep[16] and refine[(0, 0)] == sweep[0]


# -- CLIs at toy size ------------------------------------------------------


def _npz_checkpoint(tmp_path, tree, cfg):
    """The port's training checkpoint holding ``tree``'s weights."""
    from ncnet_tpu_torch.train.checkpoint import save_checkpoint
    from ncnet_tpu_torch.train.step import create_train_state

    path = str(tmp_path / "tiny.npz")
    state = create_train_state(bridge.from_jax_params(tree, cfg, device="cpu"))
    save_checkpoint(path, state, cfg, epoch=0)
    return path


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("serve", [False, True])
def test_pf_pascal_cli(small, pf_dataset, tmp_path, capsys, serve):
    jcfg, tree, cfg, _ = small
    root, _ = pf_dataset
    ck = _npz_checkpoint(tmp_path, tree, cfg)
    argv = ["--checkpoint", ck, "--eval_dataset_path", str(root),
            "--image_size", "64", "--num_workers", "1", "--batch_size", "2",
            "--device", "cpu"] + (["--batch", "2"] if serve else [])
    report = pf_pascal.main(argv)
    out = capsys.readouterr().out
    assert "Total: 4" in out and "Valid: 4" in out and "PCK: " in out
    assert ("Serve: 4 pairs" in out) == serve
    assert _last_json(out)["n_valid"] == 4
    # the same per-pair PCK as the JAX package's eval on these weights
    ds = JaxPFPascalDataset(str(root / "image_pairs" / "test_pairs.csv"), str(root),
                            output_size=(64, 64))
    want = jax_evaluate(tree, jcfg, [collate([ds[i], ds[i + 1]]) for i in (0, 2)],
                        verbose=False)
    np.testing.assert_allclose(report["per_pair"], want["per_pair"], atol=PCK_ATOL)


@pytest.mark.parametrize("argv,error,item", [
    # refinement is ported (ROADMAP A10): a factor the 400 px grid (25
    # cells) does not divide is refused before the checkpoint is read
    (["--refine", "2"], SystemExit, "does not divide by --refine 2"),
    # the JAX package's checkpoints are read now (ROADMAP A6): a missing
    # one is a missing file, not a refusal
    (["--checkpoint", "ck.msgpack"], FileNotFoundError, "ck.msgpack"),
])
def test_pf_pascal_cli_not_ported(argv, error, item):
    base = ["--checkpoint", "ck.npz", "--device", "cpu"]
    with pytest.raises(error, match=item):
        pf_pascal.main(base + argv)


def test_synthetic_cli(capsys):
    with pytest.raises(SystemExit) as exit_:
        synthetic.main(["--image_size", "64", "--steps", "4", "--batch", "2",
                        "--n_pairs", "4", "--device", "cpu"])
    report = _last_json(capsys.readouterr().out)
    assert exit_.value.code == (0 if report["convergence_ok"] else 1)
    assert len(report["losses"]) == 4 and len(report["loss_deciles"]) == 4
    for k in ("pck_before", "pck_after", "pck_diagonal_baseline"):
        assert 0.0 <= report[k] <= 1.0
    assert report["config"]["nc_init"] == "identity"
    assert report["config"]["center_features"] is True
