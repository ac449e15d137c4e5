"""The port's models against the JAX package: the NC stack, the ResNet-101
and patch16 trunks, and immatchnet_apply end to end. Weights are made by
the JAX init functions and reach the port only through
`ncnet_tpu_torch.bridge.from_jax_params`; inputs are numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.feature_extraction import feature_extraction_apply
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import immatchnet_apply as jax_immatchnet_apply
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.models.neigh_consensus import neigh_consensus_apply
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.models.immatchnet import (
    ImMatchNet,
    ImMatchNetConfig,
    extract_features,
    immatchnet_apply,
)

# float32, the issue's starting tolerance
RTOL, ATOL = 1e-5, 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))


def _jax_tree(config, seed=0):
    params = init_immatchnet(jax.random.PRNGKey(seed), config)
    return jax.tree.map(np.asarray, params)


def _port(config_kw, seed=0):
    """(jax config, jax numpy tree, port model) built from one JAX init."""
    jcfg = JaxConfig(**config_kw)
    tree = _jax_tree(jcfg, seed)
    model = bridge.from_jax_params(
        tree, ImMatchNetConfig.from_dict(jcfg.to_dict()), device="cpu"
    )
    return jcfg, tree, model


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "grid_b,symmetric,symmetric_batch",
    [
        ((4, 5), True, True),   # square grids: one batched symmetric pass
        ((3, 5), True, True),   # rectangular: the net runs twice
        ((4, 5), True, False),  # square, sequential passes
        ((3, 5), False, True),  # one direction only
    ],
)
def test_neigh_consensus_matches_jax(grid_b, symmetric, symmetric_batch):
    kw = dict(SMALL, symmetric_mode=symmetric, symmetric_batch=symmetric_batch)
    _, tree, model = _port(kw)
    corr = np.random.RandomState(0).rand(2, 4, 5, *grid_b).astype(np.float32)
    want = neigh_consensus_apply(
        tree["neigh_consensus"], jnp.asarray(corr), symmetric=symmetric,
        symmetric_batch=symmetric_batch,
    )
    got = model.neigh_consensus(torch.from_numpy(corr))
    assert got.shape == corr.shape
    _close(got, want)


def test_neigh_consensus_rejects_multichannel_last_layer():
    from ncnet_tpu_torch.models.neigh_consensus import NeighConsensus

    nc = NeighConsensus((3,), (2,), device="cpu")
    with pytest.raises(ValueError, match="1 output channel"):
        nc(torch.rand(1, 3, 3, 3, 3))


@pytest.fixture(scope="module")
def resnet_port():
    return _port(dict(feature_extraction_cnn="resnet101",
                      ncons_kernel_sizes=(3,), ncons_channels=(1,)))


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)])
def test_resnet101_trunk_matches_jax(resnet_port, hw):
    _, tree, model = resnet_port
    img = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    want = feature_extraction_apply(
        tree["feature_extraction"], jnp.asarray(img), cnn="resnet101",
        normalize=False,
    )
    got = model.feature_extraction(torch.from_numpy(img))
    assert got.shape == (1, hw[0] // 16, hw[1] // 16, 1024)
    # 33 conv layers (30 bottleneck blocks) of float32 sums, each ordered
    # differently by XLA and oneDNN, on He-initialized activations that
    # grow with depth: the error is relative to the output's scale
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_patch16_trunk_matches_jax():
    jcfg, tree, model = _port(SMALL)
    img = np.random.RandomState(2).randn(2, 48, 64, 3).astype(np.float32)
    for normalize in (False, True):
        want = feature_extraction_apply(
            tree["feature_extraction"], jnp.asarray(img), cnn="patch16",
            normalize=normalize,
        )
        cfg = model.config.replace(normalize_features=normalize)
        _close(extract_features(model, cfg, torch.from_numpy(img)), want)


@pytest.mark.parametrize("tgt_hw", [(64, 64), (48, 64)])
def test_immatchnet_apply_matches_jax(tgt_hw):
    jcfg, tree, model = _port(SMALL, seed=3)
    rng = np.random.RandomState(4)
    src = rng.randn(2, 64, 64, 3).astype(np.float32)
    tgt = rng.randn(2, *tgt_hw, 3).astype(np.float32)
    want = jax_immatchnet_apply(tree, jcfg, jnp.asarray(src), jnp.asarray(tgt))
    got = immatchnet_apply(model, model.config, torch.from_numpy(src),
                           torch.from_numpy(tgt))
    assert got.dtype == torch.float32
    assert got.shape == (2, 4, 4, tgt_hw[0] // 16, tgt_hw[1] // 16)
    _close(got, want)


def test_config_dict_round_trip():
    jcfg = JaxConfig(ncons_kernel_sizes=(5, 5, 5), ncons_channels=(16, 16, 1),
                     half_precision=True, conv4d_impl="tlc,btl4,tlc")
    d = jcfg.to_dict()
    cfg = ImMatchNetConfig.from_dict(d)
    assert cfg.to_dict() == d
    assert JaxConfig.from_dict(cfg.to_dict()) == jcfg


@pytest.mark.parametrize(
    "override,item",
    [
        # the streamed band and refinement are ported (ROADMAP A9/A10,
        # tests/test_torch_corr_stream.py, tests/test_torch_refine.py):
        # these configs build, and what the JAX package refuses raises
        (dict(nc_topk=8, corr_impl="stream"), "stream"),
        (dict(refine_factor=2), "refine_factor"),
        (dict(nc_topk=8, corr_impl="stream", nc_topk_mutual=False), "stream"),
        (dict(refine_factor=2, corr_impl="stream"), "refine_factor"),
    ],
)
def test_unported_configs_raise(override, item):
    cfg = ImMatchNetConfig(**dict(SMALL, **override))
    assert ImMatchNet(cfg, device="cpu").config == cfg
    refused = {"stream": dict(corr_stream_tile=0, nc_topk=0),
               "refine_factor": dict(relocalization_k_size=2)}[item]
    with pytest.raises(ValueError):
        ImMatchNet(cfg.replace(**refused), device="cpu")


@pytest.mark.parametrize("cnn,channels,units", [("vgg", 512, 10),
                                                ("densenet201", 256, 13)])
def test_vgg_and_densenet_trunks_build(cnn, channels, units):
    """The trunks ROADMAP A4 once refused build at stride 16 with their
    channel counts and tail units (forward parity with JAX:
    tests/test_torch_trunks.py)."""
    model = ImMatchNet(ImMatchNetConfig(**dict(SMALL, feature_extraction_cnn=cnn)),
                       device="cpu")
    trunk = model.feature_extraction
    assert (trunk.stride, trunk.channels, len(trunk.tail_units())) == (16, channels, units)
    with torch.no_grad():
        feats = trunk(torch.zeros(1, 32, 48, 3))
    assert feats.shape == (1, 2, 3, channels)
    assert not any(p.requires_grad for p in trunk.parameters())


def test_bridge_flatten_round_trip(tmp_path):
    jcfg = JaxConfig(**SMALL)
    tree = _jax_tree(jcfg)
    path = tmp_path / "params.npz"
    np.savez(path, **bridge.flatten(tree))
    back = bridge.load_npz(str(path))
    assert bridge.flatten(back).keys() == bridge.flatten(tree).keys()
    model = bridge.load_jax_params(
        ImMatchNet(ImMatchNetConfig(**SMALL), device="cpu"), back
    )
    np.testing.assert_array_equal(
        model.neigh_consensus.layers[0].kernel.numpy(),
        tree["neigh_consensus"][0]["kernel"],
    )
    bad = dict(tree, neigh_consensus=tree["neigh_consensus"][:1])
    with pytest.raises(ValueError, match="does not match"):
        bridge.load_jax_params(ImMatchNet(ImMatchNetConfig(**SMALL), device="cpu"), bad)
