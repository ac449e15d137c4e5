"""Reference ``.pth.tar`` checkpoints into the port, against the JAX
package's converter: a fake checkpoint in the reference's schema
(torchvision Sequential-index ResNet-101, VGG-16 or DenseNet-201 keys,
pre-permuted Conv4d weights, an ``args`` Namespace) gives the same config,
the same param tree and the same forward through both. float32 forward parity: rtol 1e-5 /
atol 1e-6 of the correlation."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import immatchnet_apply as jax_immatchnet_apply
from ncnet_tpu.utils import convert_torch as jconvert
from ncnet_tpu_torch import bridge, convert
from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
from ncnet_tpu_torch.models.resnet import EXPANSION, RESNET101_STAGES

RTOL, ATOL = 1e-5, 1e-6


def _fake_resnet_state_dict(prefix, sequential=True):
    """A ResNet-101 trunk state dict with torchvision's shapes; keys with
    the reference's Sequential indices or torchvision's attribute names.
    Small weights keep 30 random blocks' activations finite."""
    g = torch.Generator().manual_seed(0)
    sd = {}
    names = ({"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
              "layer3": "6"} if sequential else {})

    def key(name):
        head, _, rest = name.partition(".")
        return prefix + names.get(head, head) + ("." + rest if rest else "")

    def conv(name, cout, cin, k):
        std = (1.0 / (cin * k * k)) ** 0.5
        sd[key(name) + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * std

    def bn(name, c):
        sd[key(name) + ".weight"] = 0.5 + 0.5 * torch.rand(c, generator=g)
        sd[key(name) + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[key(name) + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[key(name) + ".running_var"] = torch.rand(c, generator=g) + 0.5
        sd[key(name) + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for si, (n_blocks, planes, _) in enumerate(RESNET101_STAGES):
        for bi in range(n_blocks):
            p = f"layer{si + 1}.{bi}."
            conv(p + "conv1", planes, cin, 1)
            bn(p + "bn1", planes)
            conv(p + "conv2", planes, planes, 3)
            bn(p + "bn2", planes)
            conv(p + "conv3", planes * EXPANSION, planes, 1)
            bn(p + "bn3", planes * EXPANSION)
            if bi == 0:
                conv(p + "downsample.0", planes * EXPANSION, cin, 1)
                bn(p + "downsample.1", planes * EXPANSION)
            cin = planes * EXPANSION
    return sd


def _nc_state_dict(sizes, channels, pre_permuted=True):
    """The reference NeighConsensus Conv4d stack (``conv.<2i>``, the ReLUs
    between)."""
    g = torch.Generator().manual_seed(1)
    sd, cin = {}, 1
    for i, (k, cout) in enumerate(zip(sizes, channels)):
        w = 0.1 * torch.randn(cout, cin, k, k, k, k, generator=g)
        if pre_permuted:  # the reference constructor's [k1, cout, cin, ...]
            w = w.permute(2, 0, 1, 3, 4, 5).contiguous()
        sd[f"NeighConsensus.conv.{2 * i}.weight"] = w
        sd[f"NeighConsensus.conv.{2 * i}.bias"] = 0.1 * torch.randn(cout, generator=g)
        cin = cout
    return sd


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    sd = _fake_resnet_state_dict("FeatureExtraction.model.")
    sd.update(_nc_state_dict((3, 3), (4, 1)))
    args = argparse.Namespace(ncons_kernel_sizes=[3, 3], ncons_channels=[4, 1],
                              fe_arch="resnet101")
    path = str(tmp_path_factory.mktemp("ck") / "ncnet_ref.pth.tar")
    torch.save({"epoch": 3, "args": args, "state_dict": sd,
                "best_test_loss": 0.0}, path)
    return path


def _assert_same_tree(got, want):
    gl, gt = jax.tree.flatten(got)
    wl, wt = jax.tree.flatten(want)
    assert gt == wt
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_convert_checkpoint_matches_jax(reference_checkpoint):
    config, params = convert.convert_checkpoint(reference_checkpoint)
    jconfig, jparams = jconvert.convert_checkpoint(reference_checkpoint)
    assert config.to_dict() == jconfig.to_dict()
    assert config.ncons_kernel_sizes == (3, 3) and config.ncons_channels == (4, 1)
    _assert_same_tree(params, jparams)


def test_reference_checkpoint_forward_matches_jax(reference_checkpoint):
    config, model = convert.load_model(reference_checkpoint, device="cpu")
    jconfig, jparams = jconvert.convert_checkpoint(reference_checkpoint)
    rng = np.random.RandomState(2)
    src = rng.randn(1, 64, 64, 3).astype(np.float32)
    tgt = rng.randn(1, 64, 48, 3).astype(np.float32)
    with torch.inference_mode():
        got = immatchnet_apply(model, config, torch.from_numpy(src),
                               torch.from_numpy(tgt))
    want = jax_immatchnet_apply(jparams, jconfig, jnp.asarray(src), jnp.asarray(tgt))
    assert got.shape == (1, 4, 4, 4, 3)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * scale)


def test_trunk_keys_and_nc_layouts_match_jax():
    seq = _fake_resnet_state_dict("FeatureExtraction.model.")
    attr = _fake_resnet_state_dict("", sequential=False)
    _assert_same_tree(convert.convert_resnet101_trunk(seq),
                      jconvert.convert_resnet101_trunk(seq))
    _assert_same_tree(convert.convert_resnet101_trunk(attr, prefix=""),
                      convert.convert_resnet101_trunk(seq))
    for pre in (True, False):
        sd = _nc_state_dict((3, 5), (2, 1), pre_permuted=pre)
        _assert_same_tree(convert.convert_neigh_consensus(sd, pre_permuted=pre),
                          jconvert.convert_neigh_consensus(sd, pre_permuted=pre))
    # both layouts of the same weights convert to the same kernels
    _assert_same_tree(
        convert.convert_neigh_consensus(_nc_state_dict((3,), (2,), True)),
        convert.convert_neigh_consensus(_nc_state_dict((3,), (2,), False),
                                        pre_permuted=False))


def _fake_vgg_state_dict(prefix):
    """torchvision ``vgg16.features`` up to pool4: conv weights and biases at
    their Sequential indices (the ReLUs and pools between hold none)."""
    g = torch.Generator().manual_seed(2)
    sd, cin, idx = {}, 3, 0
    for c in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M"):
        if c == "M":
            idx += 1
            continue
        sd[f"{prefix}{idx}.weight"] = torch.randn(c, cin, 3, 3, generator=g) * (
            1.0 / (9 * cin)) ** 0.5
        sd[f"{prefix}{idx}.bias"] = 0.1 * torch.randn(c, generator=g)
        cin, idx = c, idx + 2  # conv, relu
    return sd


def _fake_densenet_state_dict(prefix, legacy=False):
    """torchvision DenseNet-201 up to transition2 with the reference's
    Sequential indices (0 conv0, 1 norm0, 4..7); ``legacy``: the old zoo
    file's ``denselayer<i>.norm.1`` / ``conv.2`` names."""
    g = torch.Generator().manual_seed(3)
    seq = {"conv0": "0", "norm0": "1", "denseblock1": "4", "transition1": "5",
           "denseblock2": "6", "transition2": "7"}
    sd = {}

    def key(name):
        head, _, rest = name.partition(".")
        return prefix + seq[head] + ("." + rest if rest else "")

    def conv(name, cout, cin, k):
        sd[key(name) + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * (
            1.0 / (cin * k * k)) ** 0.5

    def bn(name, c):
        sd[key(name) + ".weight"] = 0.5 + 0.5 * torch.rand(c, generator=g)
        sd[key(name) + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[key(name) + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[key(name) + ".running_var"] = torch.rand(c, generator=g) + 0.5

    conv("conv0", 64, 3, 7)
    bn("norm0", 64)
    cin = 64
    for bi, n in enumerate((6, 12)):
        for li in range(n):
            p = f"denseblock{bi + 1}.denselayer{li + 1}."
            n1, c1, n2, c2 = (("norm.1", "conv.1", "norm.2", "conv.2") if legacy
                              else ("norm1", "conv1", "norm2", "conv2"))
            bn(p + n1, cin)
            conv(p + c1, 128, cin, 1)
            bn(p + n2, 128)
            conv(p + c2, 32, 128, 3)
            cin += 32
        bn(f"transition{bi + 1}.norm", cin)
        conv(f"transition{bi + 1}.conv", cin // 2, cin, 1)
        cin //= 2
    return sd


@pytest.mark.parametrize("cnn", ["vgg", "densenet201"])
def test_unported_checkpoint_trunks_raise(tmp_path, cnn):
    """The VGG-16 and DenseNet-201 reference checkpoints (ROADMAP A4, once
    refused here) convert as the JAX package converts them, the legacy
    ``vgg`` key prefix included, and their forwards agree."""
    prefix = "FeatureExtraction.vgg." if cnn == "vgg" else "FeatureExtraction.model."
    sd = (_fake_vgg_state_dict(prefix) if cnn == "vgg"
          else _fake_densenet_state_dict(prefix, legacy=True))
    sd.update(_nc_state_dict((3,), (1,)))
    path = str(tmp_path / "ck.pth.tar")
    torch.save({"state_dict": sd,
                "args": argparse.Namespace(ncons_kernel_sizes=[3],
                                           ncons_channels=[1],
                                           feature_extraction_cnn=cnn)}, path)
    config, params = convert.convert_checkpoint(path)
    jconfig, jparams = jconvert.convert_checkpoint(path)
    assert config.to_dict() == jconfig.to_dict()
    _assert_same_tree(params, jparams)
    _, model = convert.load_model(path, device="cpu")
    src = np.random.RandomState(4).randn(1, 64, 48, 3).astype(np.float32)
    with torch.inference_mode():
        got = immatchnet_apply(model, config, torch.from_numpy(src),
                               torch.from_numpy(src[:, ::-1].copy()))
    want = jax_immatchnet_apply(jparams, jconfig, jnp.asarray(src),
                                jnp.asarray(src[:, ::-1].copy()))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * scale)


def test_load_model_dispatch(tmp_path):
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.train.checkpoint import save_checkpoint
    from ncnet_tpu_torch.train.step import create_train_state

    cfg = ImMatchNetConfig(feature_extraction_cnn="patch16",
                           ncons_kernel_sizes=(3,), ncons_channels=(1,))
    model = ImMatchNet(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "head.npz")
    save_checkpoint(path, create_train_state(model), cfg, epoch=1)
    config, loaded = convert.load_model(path, device="cpu")
    assert config == cfg
    _assert_same_tree(bridge.to_jax_params(loaded), bridge.to_jax_params(model))
    # a JAX package checkpoint, through the port's msgpack reader
    import jax.numpy as jnp_  # noqa: F401  (the JAX side writes it)
    from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
    from ncnet_tpu.train import checkpoint as jax_checkpoint

    jtree = bridge.to_jax_params(model)
    mp = str(tmp_path / "jax.msgpack")
    jax_checkpoint.save_checkpoint(mp, jax_checkpoint.CheckpointData(
        config=JaxConfig(**cfg.to_dict()), params=jtree, step=4, epoch=1))
    config, loaded = convert.load_model(mp, device="cpu")
    assert config == cfg
    _assert_same_tree(bridge.to_jax_params(loaded), jtree)
    with pytest.raises(FileNotFoundError):
        convert.load_model(str(tmp_path / "missing.msgpack"), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.load_model(str(tmp_path / "weights.bin"), device="cpu")
