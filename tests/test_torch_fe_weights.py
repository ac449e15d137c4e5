"""Pretrained trunk weights in training (`convert.load_trunk_weights`, the
train CLI's ``--fe_weights``, ``--checkpoint X.pth.tar`` and
``--device_normalize``) against the JAX package on the CPU.

torchvision is not installed here, so the tests build torchvision-keyed
state dicts themselves (ResNet-101, VGG-16 and DenseNet-201 at their real
shapes, with keys past the trunk: ``layer4``, ``fc``, ``classifier``,
VGG's convs past pool4, ``num_batches_tracked``) and write them as a raw
``.pth``, as a reference ``.pth.tar`` (Sequential-index keys under
``FeatureExtraction.model.``) and as a JAX ``.msgpack``. Trunk trees must
equal the JAX package's exactly; losses hold at rtol 1e-5."""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.train import checkpoint as jax_checkpoint
from ncnet_tpu.utils import convert_torch as jconvert
from ncnet_tpu_torch import bridge, convert
from ncnet_tpu_torch.data.images import normalize_image_np
from ncnet_tpu_torch.data.loader import DataLoader, collate
from ncnet_tpu_torch.data.pairs import ImagePairDataset
from ncnet_tpu_torch.models.densenet import TRUNK_BLOCKS
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.models.resnet import EXPANSION, RESNET101_STAGES
from ncnet_tpu_torch.models.vgg import VGG16_TO_POOL4
from ncnet_tpu_torch.train.__main__ import main as train_main
from ncnet_tpu_torch.train.checkpoint import load_checkpoint
from ncnet_tpu_torch.train.loss import weak_loss

RTOL, ATOL = 1e-5, 1e-6
NC = dict(ncons_kernel_sizes=(3,), ncons_channels=(1,))
TOY = ["--synthetic", "--device", "cpu", "--image_size", "64",
       "--ncons_kernel_sizes", "3", "--ncons_channels", "1", "--batch_size", "2",
       "--synthetic_pairs", "2", "--num_epochs", "1", "--num_workers", "1",
       "--max-steps", "1", "--no-bf16"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Maker:
    """Random torchvision-shaped tensors, small enough to keep 30 random
    blocks' activations finite."""

    def __init__(self, seed):
        self.g = torch.Generator().manual_seed(seed)
        self.sd = {}

    def conv(self, name, cout, cin, k, bias=False):
        self.sd[name + ".weight"] = torch.randn(cout, cin, k, k, generator=self.g) * (
            1.0 / (cin * k * k)) ** 0.5
        if bias:
            self.sd[name + ".bias"] = 0.1 * torch.randn(cout, generator=self.g)

    def bn(self, name, c):
        self.sd[name + ".weight"] = 0.5 + 0.5 * torch.rand(c, generator=self.g)
        self.sd[name + ".bias"] = 0.1 * torch.randn(c, generator=self.g)
        self.sd[name + ".running_mean"] = 0.1 * torch.randn(c, generator=self.g)
        self.sd[name + ".running_var"] = torch.rand(c, generator=self.g) + 0.5
        self.sd[name + ".num_batches_tracked"] = torch.tensor(7)


def resnet101_torchvision():
    m = _Maker(0)
    m.conv("conv1", 64, 3, 7)
    m.bn("bn1", 64)
    cin = 64
    stages = RESNET101_STAGES + ((3, 512, 2),)  # layer4: past the trunk
    for si, (n_blocks, planes, _) in enumerate(stages):
        for bi in range(n_blocks if si < 3 else 1):
            p = f"layer{si + 1}.{bi}."
            m.conv(p + "conv1", planes, cin, 1)
            m.bn(p + "bn1", planes)
            m.conv(p + "conv2", planes, planes, 3)
            m.bn(p + "bn2", planes)
            m.conv(p + "conv3", planes * EXPANSION, planes, 1)
            m.bn(p + "bn3", planes * EXPANSION)
            if bi == 0:
                m.conv(p + "downsample.0", planes * EXPANSION, cin, 1)
                m.bn(p + "downsample.1", planes * EXPANSION)
            cin = planes * EXPANSION
    m.sd["fc.weight"] = torch.zeros(1000, 2048)
    m.sd["fc.bias"] = torch.zeros(1000)
    return m.sd


def vgg16_torchvision():
    """``features`` to the last conv (three convs past pool4) and a piece of
    the classifier."""
    m, cin, idx = _Maker(1), 3, 0
    for c in VGG16_TO_POOL4 + (512, 512, 512, "M"):
        if c == "M":
            idx += 1
            continue
        m.conv(f"features.{idx}", c, cin, 3, bias=True)
        cin, idx = c, idx + 2  # conv, relu
    m.sd["classifier.6.weight"] = torch.zeros(1000, 4096)
    m.sd["classifier.6.bias"] = torch.zeros(1000)
    return m.sd


def densenet201_torchvision():
    m = _Maker(2)
    m.conv("features.conv0", 64, 3, 7)
    m.bn("features.norm0", 64)
    cin = 64
    for bi, n in enumerate(TRUNK_BLOCKS):
        for li in range(n):
            p = f"features.denseblock{bi + 1}.denselayer{li + 1}."
            m.bn(p + "norm1", cin)
            m.conv(p + "conv1", 128, cin, 1)
            m.bn(p + "norm2", 128)
            m.conv(p + "conv2", 32, 128, 3)
            cin += 32
        m.bn(f"features.transition{bi + 1}.norm", cin)
        m.conv(f"features.transition{bi + 1}.conv", cin // 2, cin, 1)
        cin //= 2
    m.bn("features.denseblock3.denselayer1.norm1", cin)  # past the trunk
    m.bn("features.norm5", 1920)
    m.sd["classifier.weight"] = torch.zeros(1000, 1920)
    return m.sd


BUILDERS = {"resnet101": resnet101_torchvision, "vgg": vgg16_torchvision,
            "densenet201": densenet201_torchvision}
SEQUENTIAL = {"resnet101": convert.RESNET_SEQUENTIAL,
              "densenet201": convert.DENSENET_SEQUENTIAL}


def reference_keys(sd, cnn):
    """The trunk's keys as a reference checkpoint holds them: Sequential
    indices under ``FeatureExtraction.model.`` (a VGG's under the legacy
    ``FeatureExtraction.vgg.``)."""
    if cnn == "vgg":
        n_convs = sum(c != "M" for c in VGG16_TO_POOL4)
        convs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("features.")})
        keep = set(convs[:n_convs])
        return {"FeatureExtraction.vgg." + k[len("features."):]: v for k, v in sd.items()
                if k.startswith("features.") and int(k.split(".")[1]) in keep}
    index = {name: i for i, name in SEQUENTIAL[cnn].items()}
    out = {}
    for k, v in sd.items():
        k = k[len("features."):] if k.startswith("features.") else k
        head, _, rest = k.partition(".")
        if head in index:
            out[f"FeatureExtraction.model.{index[head]}.{rest}"] = v
    return out


def nc_state_dict():
    g = torch.Generator().manual_seed(3)
    w = 0.1 * torch.randn(3, 1, 1, 3, 3, 3, generator=g)  # [k1, cout, cin, ...]
    return {"NeighConsensus.conv.0.weight": w,
            "NeighConsensus.conv.0.bias": 0.1 * torch.randn(1, generator=g)}


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """``{cnn: {'pth', 'pth.tar', 'msgpack': path}}``."""
    root = tmp_path_factory.mktemp("weights")
    files = {}
    for cnn, build in BUILDERS.items():
        sd = build()
        paths = {fmt: str(root / f"{cnn}.{fmt}") for fmt in ("pth", "pth.tar", "msgpack")}
        torch.save(sd, paths["pth"])
        torch.save({"epoch": 3, "state_dict": {**reference_keys(sd, cnn),
                                               **nc_state_dict()},
                    "args": argparse.Namespace(fe_arch=cnn, ncons_kernel_sizes=[3],
                                               ncons_channels=[1])},
                   paths["pth.tar"])
        params = {"feature_extraction": jconvert.load_trunk_weights(paths["pth"], cnn),
                  "neigh_consensus": convert.convert_neigh_consensus(nc_state_dict())}
        jax_checkpoint.save_checkpoint(paths["msgpack"], jax_checkpoint.CheckpointData(
            config=JaxConfig(feature_extraction_cnn=cnn, **NC), params=params,
            step=2, epoch=1))
        files[cnn] = paths
    return files


def _assert_same_tree(got, want):
    gl, gt = jax.tree.flatten(got)
    wl, wt = jax.tree.flatten(want)
    assert gt == wt
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fmt", ["pth", "pth.tar", "msgpack"])
@pytest.mark.parametrize("cnn", ["resnet101", "vgg", "densenet201"])
def test_load_trunk_weights_equals_jax(weight_files, cnn, fmt):
    path = weight_files[cnn][fmt]
    got = convert.load_trunk_weights(path, cnn)
    want = jconvert.load_trunk_weights(path, cnn)
    if cnn == "vgg" and fmt != "pth.tar":
        # the JAX converter keeps torchvision's three convs past pool4,
        # which its trunk never reads; the port keeps the trunk's ten
        assert len(want) == len(got) + 3
        want = want[:len(got)]
    _assert_same_tree(got, want)
    # the tree fits the port's trunk as it is
    cfg = ImMatchNetConfig(feature_extraction_cnn=cnn, **NC)
    model = ImMatchNet(cfg, device="cpu")
    bridge.load_jax_params(model, dict(bridge.to_jax_params(model),
                                       feature_extraction=got))


def test_fe_weights_run_starts_from_them(weight_files, tmp_path, capsys):
    """``--fe_weights`` (a raw torchvision ResNet-101 ``.pth``) with no
    other opt-in: the run trains on that trunk, frozen."""
    out = str(tmp_path / "run")
    argv = [a for a in TOY if a != "--synthetic"]
    with pytest.raises(SystemExit):  # no trunk at all: refused
        train_main(argv + ["--result_model_dir", out])
    assert "pass --fe_weights" in capsys.readouterr().err
    report = train_main(TOY + ["--fe_weights", weight_files["resnet101"]["pth"],
                               "--result_model_dir", out])
    assert report["steps"] == 1 and np.isfinite(report["step_losses"][0])
    assert weight_files["resnet101"]["pth"] in report["weights"]
    ck = load_checkpoint(os.path.join(out, "ncnet_tpu_torch.npz"))
    _assert_same_tree(ck.params["feature_extraction"],
                      jconvert.load_trunk_weights(weight_files["resnet101"]["pth"],
                                                  "resnet101"))


def test_checkpoint_pth_tar_trains_and_raw_pth_is_refused(weight_files, tmp_path,
                                                          capsys):
    files = weight_files["resnet101"]
    with pytest.raises(SystemExit):
        train_main(TOY + ["--checkpoint", files["pth"],
                          "--result_model_dir", str(tmp_path / "raw")])
    err = capsys.readouterr().err
    assert "not a full reference training checkpoint" in err and "--fe_weights" in err
    out = str(tmp_path / "ref")
    report = train_main(TOY + ["--checkpoint", files["pth.tar"], "--result_model_dir",
                               out])
    assert report["steps"] == 1 and report["weights"] == files["pth.tar"]
    assert report["config"]["ncons_kernel_sizes"] == [3]
    assert report["config"]["half_precision"] is False  # --no-bf16 as given
    _, jparams = jconvert.convert_checkpoint(files["pth.tar"])
    ck = load_checkpoint(os.path.join(out, "ncnet_tpu_torch.npz"))
    _assert_same_tree(ck.params["feature_extraction"], jparams["feature_extraction"])
    assert ck.opt_state is not None  # a fresh Adam took one step


@pytest.fixture(scope="module")
def pair_dataset(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (50 + i, 61, 3), np.uint8)).save(
            root / f"{i}.png")
    rows = "".join(f"{i}.png,{(i + 1) % 4}.png,1,{i % 2}\n" for i in range(4))
    for split in ("train", "val"):
        (root / f"{split}_pairs.csv").write_text(
            "source_image,target_image,class,flip\n" + rows)
    return root


def test_device_normalize_gives_the_float_paths_loss(pair_dataset, tmp_path):
    """``--device_normalize`` ships uint8 and normalizes on the device: the
    step's loss is the float path's on the same integer pixels (rtol 1e-5),
    and it differs from the float path's, which keeps the resize's
    fractions, only by that rounding (at most half a gray level a pixel)."""
    argv = [a for a in TOY if a != "--synthetic"] + [
        "--fe_arch", "patch16", "--allow_random_fe", "--synthetic_pairs", "4",
        "--dataset_image_path", str(pair_dataset), "--dataset_csv_path",
        str(pair_dataset)]
    u8 = train_main(argv + ["--device_normalize", "--result_model_dir",
                            str(tmp_path / "u8")])
    fl = train_main(argv + ["--result_model_dir", str(tmp_path / "f32")])
    cfg = ImMatchNetConfig.from_dict(u8["config"])
    model = ImMatchNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    ds = ImagePairDataset(str(pair_dataset / "train_pairs.csv"), str(pair_dataset),
                          output_size=(64, 64), seed=1, uint8_output=True)
    (idx,) = DataLoader(ds, 2, shuffle=True, seed=1, drop_last=True)._epoch_batches(0)[:1]
    batch = collate([ds[int(i)] for i in idx])
    assert batch["source_image"].dtype == np.uint8
    host = {k: torch.from_numpy(normalize_image_np(v.astype(np.float32)).astype(
        np.float32)) for k, v in batch.items() if k.endswith("_image")}
    with torch.no_grad():
        want = float(weak_loss(model, cfg, host))
    np.testing.assert_allclose(u8["step_losses"][0], want, rtol=RTOL, atol=ATOL)
    assert abs(u8["step_losses"][0] - fl["step_losses"][0]) < 1e-3
