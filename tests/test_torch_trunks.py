"""The VGG-16 and DenseNet-201 trunks, their torchvision converters and the
trainable subsets of all three trunks, against the JAX package on the CPU.

Weights come from the JAX init through `ncnet_tpu_torch.bridge`; the
converters read synthesized torchvision state dicts (attribute keys, as
a raw ``.pth`` holds them). float32: rtol 1e-5 / atol 1e-6 of the scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.feature_extraction import feature_extraction_apply as jax_fe
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.train import step as jax_step
from ncnet_tpu.utils import convert_torch as jconvert
from ncnet_tpu_torch import bridge, convert
from ncnet_tpu_torch.models.feature_extraction import feature_extraction_apply
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.train.step import merge_trainable, trainable_subset

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_tree(cnn):
    jcfg = JaxConfig(feature_extraction_cnn=cnn, ncons_kernel_sizes=(3,),
                     ncons_channels=(1,), half_precision=False)
    init = jax.jit(init_immatchnet, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))


def _port(cnn):
    jcfg = JaxConfig(feature_extraction_cnn=cnn, ncons_kernel_sizes=(3,),
                     ncons_channels=(1,), half_precision=False)
    tree = _jax_tree(cnn)
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return jcfg, tree, cfg, bridge.from_jax_params(tree, cfg, device="cpu")


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def _same_tree(got, want):
    fg, fw = bridge.flatten(got), bridge.flatten(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        np.testing.assert_array_equal(fg[k], np.asarray(fw[k]), err_msg=k)


@pytest.mark.parametrize("cnn,channels", [("vgg", 512), ("densenet201", 256)])
@pytest.mark.parametrize("normalize", [False, True])
def test_trunk_forward_matches_jax(cnn, channels, normalize):
    _, tree, _, model = _port(cnn)
    back = bridge.to_jax_params(model)
    _same_tree(back, tree)  # the bridge both ways, bitwise
    x = np.random.RandomState(1).randn(2, 48, 64, 3).astype(np.float32)
    want = jax.jit(functools.partial(jax_fe, cnn=cnn, normalize=normalize))(
        tree["feature_extraction"], jnp.asarray(x))
    with torch.no_grad():
        got = feature_extraction_apply(model.feature_extraction, torch.from_numpy(x),
                                       normalize=normalize)
    assert got.shape == (2, 3, 4, channels)
    _close(got, want)


def _torchvision_vgg(g):
    sd, cin, idx = {}, 3, 0
    for c in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M"):
        if c == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn(c, cin, 3, 3, generator=g)
        sd[f"features.{idx}.bias"] = torch.randn(c, generator=g)
        cin, idx = c, idx + 2
    return sd


def _torchvision_densenet(g):
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"features.{name}.weight"] = torch.randn(cout, cin, k, k, generator=g)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"features.{name}.{leaf}"] = torch.rand(c, generator=g) + 0.5

    conv("conv0", 64, 3, 7)
    bn("norm0", 64)
    cin = 64
    for bi, n in enumerate((6, 12)):
        for li in range(n):
            p = f"denseblock{bi + 1}.denselayer{li + 1}."
            bn(p + "norm1", cin)
            conv(p + "conv1", 128, cin, 1)
            bn(p + "norm2", 128)
            conv(p + "conv2", 32, 128, 3)
            cin += 32
        bn(f"transition{bi + 1}.norm", cin)
        conv(f"transition{bi + 1}.conv", cin // 2, cin, 1)
        cin //= 2
    return sd


@pytest.mark.parametrize("cnn", ["vgg", "densenet201"])
def test_torchvision_converters_match_jax(cnn):
    g = torch.Generator().manual_seed(5)
    if cnn == "vgg":
        sd = _torchvision_vgg(g)
        got = convert.convert_vgg16_trunk(sd, prefix="features.")
        want = jconvert.convert_vgg16_trunk(sd, prefix="features.")
    else:
        sd = _torchvision_densenet(g)
        got = convert.convert_densenet201_trunk(sd, prefix="features.")
        want = jconvert.convert_densenet201_trunk(sd, prefix="features.")
    _same_tree(got, want)
    # and the converted tree loads into the port's trunk
    _, tree, cfg, model = _port(cnn)
    bridge.load_jax_params(model, dict(tree, feature_extraction=got))
    _same_tree(bridge.to_jax_params(model)["feature_extraction"], want)


@pytest.mark.parametrize("cnn,blocks", [("resnet101", 1), ("resnet101", 23),
                                        ("vgg", 1), ("vgg", 10),
                                        ("densenet201", 1), ("densenet201", 13)])
def test_trainable_subset_and_merge_match_jax(cnn, blocks):
    """JAX's unit rules: layer3's bottlenecks, VGG's flat conv list,
    denseblock2's layers then transition2; past the count raises. The
    weights are the port's own init (the rules read only the tree's
    structure)."""
    cfg = ImMatchNetConfig(feature_extraction_cnn=cnn, ncons_kernel_sizes=(3,),
                           ncons_channels=(1,), half_precision=False)
    model = ImMatchNet(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    tree = bridge.to_jax_params(model)
    want = jax_step.trainable_subset(tree, fe_finetune_blocks=blocks, cnn=cnn)
    _same_tree(trainable_subset(model, fe_finetune_blocks=blocks), want)
    # merge: JAX's own merge of a perturbed subset, written into the port
    moved = jax.tree.map(lambda a: np.asarray(a) + 0.5, want)
    merge_trainable(model, moved)
    _same_tree(bridge.to_jax_params(model),
               jax.tree.map(np.asarray, jax_step.merge_trainable(tree, moved, cnn)))
    with pytest.raises(ValueError, match="exceeds"):
        jax_step.trainable_subset(tree, fe_finetune_blocks=blocks + 100, cnn=cnn)
    with pytest.raises(ValueError, match="exceeds"):
        trainable_subset(model, fe_finetune_blocks=blocks + 100)
