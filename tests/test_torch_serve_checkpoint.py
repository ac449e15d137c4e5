"""Serving a trained checkpoint through the serve CLI's ``--checkpoint``
(the train CLI's ``.npz``, a JAX package ``.msgpack`` and a reference
``.pth.tar``): the config is the checkpoint's, the flags override it as
``scripts/serve.py``'s do, and the served matches equal `make_match_fn`'s
on `convert.load_model`'s model, bit for bit (one request a batch on both
sides). ``--params`` refuses a training checkpoint with a message."""

import argparse

import jax
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.train import checkpoint as jax_checkpoint
from ncnet_tpu_torch.convert import load_model
from ncnet_tpu_torch.data.images import normalize_image_np, resize_bilinear_np
from ncnet_tpu_torch.models.immatchnet import make_match_fn
from ncnet_tpu_torch.serve.__main__ import main as serve_main
from ncnet_tpu_torch.serve.__main__ import synthetic_pairs
from ncnet_tpu_torch.serve.buckets import BucketSpec
from ncnet_tpu_torch.train.__main__ import main as train_main
from test_torch_convert import _fake_resnet_state_dict, _nc_state_dict

SERVE = ["--synthetic", "3", "--image-size", "64", "--device", "cpu",
         "--max-batch", "1", "--concurrency", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkpoints")
    out = str(root / "run")
    train_main(["--synthetic", "--allow_random_fe", "--device", "cpu", "--fe_arch",
                "patch16", "--image_size", "64", "--ncons_kernel_sizes", "3", "3",
                "--ncons_channels", "4", "1", "--batch_size", "2",
                "--synthetic_pairs", "2", "--num_epochs", "1", "--num_workers",
                "1", "--max-steps", "1", "--refine", "2", "--refine_topk", "4",
                "--result_model_dir", out])
    jcfg = JaxConfig(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
                     ncons_channels=(4, 1), nc_topk=5)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(2), jcfg))
    msgpack = str(root / "jax.msgpack")
    jax_checkpoint.save_checkpoint(msgpack, jax_checkpoint.CheckpointData(
        config=jcfg, params=tree, step=3, epoch=1))
    ref = str(root / "ncnet_ref.pth.tar")
    sd = _fake_resnet_state_dict("FeatureExtraction.model.")
    sd.update(_nc_state_dict((3,), (1,)))
    torch.save({"epoch": 3, "state_dict": sd, "best_test_loss": 0.0,
                "args": argparse.Namespace(ncons_kernel_sizes=[3],
                                           ncons_channels=[1], fe_arch="resnet101")},
               ref)
    return {"npz": f"{out}/ncnet_tpu_torch.npz", "msgpack": msgpack, "pth.tar": ref}


def _expected(path, config):
    """Each synthetic request's matches by `make_match_fn` on the loaded
    model, one pair a call."""
    _, model = load_model(path, device="cpu")
    fn = make_match_fn(config, concat_directions=True)
    spec = BucketSpec(64)
    out = []
    for pair in synthetic_pairs(3, 0):
        src, tgt = (torch.from_numpy(normalize_image_np(resize_bilinear_np(
            img, *spec.bucket(*img.shape[:2]))).astype(np.float32))[None]
            for img in pair)
        with torch.inference_mode():
            out.append(fn(model, src, tgt)[:, 0].numpy())
    return out


@pytest.mark.parametrize("kind", ["npz", "msgpack", "pth.tar"])
def test_serve_cli_serves_a_checkpoint(checkpoints, kind, capsys):
    path = checkpoints[kind]
    ck_config, _ = load_model(path, device="cpu")
    results = []
    report = serve_main(SERVE + ["--checkpoint", path], results=results)
    capsys.readouterr()
    assert report["weights"] == path
    assert report["completed"] == 3 and report["failed"] == 0
    config = ck_config.replace(refine_factor=0)  # a rung, not the program
    config = config if config.nc_topk else config.replace(corr_impl="dense")
    assert report["config"] == config.to_dict()
    for got, want in zip(results, _expected(path, config)):
        np.testing.assert_array_equal(got["matches"], want)


def test_serve_cli_checkpoint_overrides_and_refusals(checkpoints, capsys):
    npz = checkpoints["npz"]
    ck_config, _ = load_model(npz, device="cpu")
    assert ck_config.refine_factor == 2 and ck_config.half_precision
    report = serve_main(SERVE + ["--checkpoint", npz, "--no-bf16", "--nc-topk", "3",
                                 "--refine", "2", "--refine-topk", "3"])
    assert report["config"]["half_precision"] is False
    assert report["config"]["nc_topk"] == 3 and report["refine_factor"] == 2
    assert report["completed"] == 3
    assert serve_main(SERVE + ["--checkpoint", npz])["config"]["half_precision"]
    capsys.readouterr()
    for extra in (["--cnn", "patch16"], ["--ncons-channels", "4", "1"]):
        with pytest.raises(SystemExit, match="architecture is the checkpoint's"):
            serve_main(SERVE + ["--checkpoint", npz] + extra)
    with pytest.raises(SystemExit, match="training checkpoint.*--checkpoint"):
        serve_main(SERVE + ["--cnn", "patch16", "--params", npz])
    random = serve_main(SERVE + ["--cnn", "patch16", "--ncons-kernel-sizes", "3",
                                 "--ncons-channels", "1", "--seed", "4"])
    assert random["weights"] == "random (seed 4)"
