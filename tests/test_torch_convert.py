"""Reference ``.pth.tar`` checkpoints into the port, against the JAX
package's converter: a fake checkpoint in the reference's schema
(torchvision Sequential-index ResNet-101 keys, pre-permuted Conv4d
weights, an ``args`` Namespace) gives the same config, the same param tree
and the same forward through both. float32 forward parity: rtol 1e-5 /
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


@pytest.mark.parametrize("cnn", ["vgg", "densenet201"])
def test_unported_checkpoint_trunks_raise(tmp_path, cnn):
    path = str(tmp_path / "ck.pth.tar")
    torch.save({"state_dict": _nc_state_dict((3,), (1,)),
                "args": argparse.Namespace(ncons_kernel_sizes=[3],
                                           ncons_channels=[1],
                                           feature_extraction_cnn=cnn)}, path)
    with pytest.raises(NotImplementedError, match="A4"):
        convert.convert_checkpoint(path)


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
    with pytest.raises(NotImplementedError, match="A6"):
        convert.load_model(str(tmp_path / "jax.msgpack"), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.load_model(str(tmp_path / "weights.bin"), device="cpu")
