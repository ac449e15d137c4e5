"""The port's image ops, ``correlation_3d`` and the InLoc dump's device
preprocessing against the JAX package on the CPU.

Tolerances: float32 rtol 1e-5 / atol 1e-6 of the compared quantity's
scale. The resize's sample positions are XLA's (`ops.image._linspace`
mirrors its folded constants), so the uint8 device resize equals the JAX
package's jitted one to at most 1 gray level (float rounding at ``.5``;
``tests/test_eval.py``'s own bound), and the two InLoc routes agree on
the image to the same gray level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.eval import inloc as jinloc
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.ops import correlation as jcorr
from ncnet_tpu.ops import image as jimage
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.eval import inloc
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.ops import correlation, image

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("in_hw,out_hw", [((13, 17), (29, 31)), ((40, 30), (9, 7)),
                                          ((8, 8), (8, 15)), ((5, 6), (1, 1))])
def test_resize_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(0).rand(2, *in_hw, 3).astype(np.float32) * 255
    want = jax.jit(jimage.resize_bilinear_align_corners,
                   static_argnums=(1, 2))(jnp.asarray(x), *out_hw)
    _close(image.resize_bilinear_align_corners(torch.from_numpy(x), *out_hw), want)


@pytest.mark.parametrize("out_hw", [(7, 9), (12, 5)])
def test_affine_grid_sample_and_transform_match_jax(out_hw):
    rng = np.random.RandomState(1)
    img = rng.rand(2, 10, 12, 3).astype(np.float32)
    # an identity, a zoom with a shift past the edge (zeros padding)
    theta = np.array([[[1, 0, 0], [0, 1, 0]],
                      [[0.7, 0.2, 0.4], [-0.1, 1.3, -0.5]]], np.float32)
    _close(image.affine_grid(torch.from_numpy(theta), *out_hw),
           jimage.affine_grid(jnp.asarray(theta), *out_hw))
    grid = rng.uniform(-1.3, 1.3, (2, *out_hw, 2)).astype(np.float32)
    _close(image.grid_sample(torch.from_numpy(img), torch.from_numpy(grid)),
           jimage.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = image.affine_transform(torch.from_numpy(img), torch.from_numpy(theta), *out_hw)
    _close(got, jimage.affine_transform(jnp.asarray(img), jnp.asarray(theta), *out_hw))
    # the identity theta is the align-corners resize
    _close(got[0], image.resize_bilinear_align_corners(torch.from_numpy(img[0]), *out_hw))


def test_imagenet_normalize_round_trip_matches_jax():
    x = np.random.RandomState(2).randint(0, 256, (2, 5, 4, 3)).astype(np.float32)
    got = image.imagenet_normalize(torch.from_numpy(x))
    _close(got, jimage.imagenet_normalize(jnp.asarray(x)))
    _close(image.imagenet_unnormalize(got),
           jimage.imagenet_unnormalize(jimage.imagenet_normalize(jnp.asarray(x))))
    u8 = torch.from_numpy(x.astype(np.uint8))
    _close(image.device_normalize(u8), jimage.imagenet_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("normalization,relu", [(True, True), (True, False),
                                                (False, True)])
def test_correlation_3d_matches_jax(normalization, relu):
    rng = np.random.RandomState(3)
    fa = rng.randn(2, 3, 5, 8).astype(np.float32)
    fb = rng.randn(2, 3, 5, 8).astype(np.float32)
    got = correlation.correlation_3d(torch.from_numpy(fa), torch.from_numpy(fb),
                                     normalization, relu)
    _close(got, jcorr.correlation_3d(jnp.asarray(fa), jnp.asarray(fb),
                                     normalization, relu))
    if not normalization:  # channel iA + hA*jA of B cell (iB, jB)
        assert np.isclose(float(got[1, 2, 4, 1 + 3 * 3]), float(fa[1, 1, 3] @ fb[1, 2, 4]),
                          rtol=1e-5)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """An image that the quantized resize upscales (64x48 -> 128x96) and
    one it downscales (300x200 -> 128x80), as ``.npy`` files."""
    root = tmp_path_factory.mktemp("img")
    rng = np.random.RandomState(4)
    paths = {}
    for name, hw in (("up", (64, 48)), ("down", (300, 200))):
        paths[name] = str(root / f"{name}.npy")
        np.save(paths[name], rng.randint(0, 256, (*hw, 3)).astype(np.float32))
    return paths


@pytest.mark.parametrize("which", ["up", "down"])
@pytest.mark.parametrize("mode", ["host", "normalize", "resize"])
def test_load_and_preprocess_contract_matches_jax(images, monkeypatch, which, mode):
    path = images[which]
    monkeypatch.setattr(jinloc, "load_image", np.load)
    kw = dict(device_normalize=mode != "host", device_resize=mode == "resize")
    got = inloc.load_and_preprocess(path, 128, 2, read_image=np.load, **kw)
    want = jinloc.load_and_preprocess(path, 128, 2, **kw)
    if mode == "resize":
        (got, got_hw), (want, want_hw) = got, want
        assert got_hw == want_hw == ((128, 96) if which == "up" else None)
    assert type(got) is type(want) and got.shape == want.shape
    if mode == "host":
        # float32, as the JAX package's float64 becomes on its device
        assert got.dtype == np.float32
        _close(got, want.astype(np.float32))
    else:
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="requires device_normalize"):
        inloc.load_and_preprocess(path, 128, 2, device_resize=True, read_image=np.load)


@pytest.mark.parametrize("out_hw", [(128, 96), (96, 130), (37, 29)])
def test_device_resize_uint8_matches_jax(out_hw):
    img = np.random.RandomState(5).randint(0, 256, (1, 64, 48, 3)).astype(np.uint8)
    got = inloc.device_resize_uint8(torch.from_numpy(img), *out_hw)
    want = np.asarray(jinloc.device_resize_uint8(jnp.asarray(img), *out_hw))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    # tests/test_eval.py::test_device_resize_matches_host_resize's bounds
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    # and against the host route's uint8 of its own resize
    from ncnet_tpu_torch.data.images import resize_bilinear_np, to_uint8_image

    host = to_uint8_image(resize_bilinear_np(img[0].astype(np.float32), *out_hw))
    assert np.abs(got.numpy()[0].astype(int) - host.astype(int)).max() <= 1


def test_make_match_fn_device_preprocess_matches_host_route():
    """uint8 images normalized on the device give the host route's matches
    (the same float32 normalize), and JAX's device route's."""
    jcfg = JaxConfig(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3,),
                     ncons_channels=(1,), relocalization_k_size=2)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(0), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    model = bridge.from_jax_params(tree, cfg, device="cpu")
    rng = np.random.RandomState(6)
    src, tgt = (rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8) for _ in range(2))
    dev = inloc.make_match_fn(cfg, device_preprocess=True, concat_directions=True)
    host = inloc.make_match_fn(cfg, concat_directions=True)
    with torch.inference_mode():
        got = dev(model, torch.from_numpy(src), torch.from_numpy(tgt))
        norm = [image.imagenet_normalize(torch.from_numpy(x).float()) for x in (src, tgt)]
        want = host(model, *norm)
    assert torch.equal(got, want)
    jfn = jinloc.make_match_fn(jcfg, device_preprocess=True, concat_directions=True)
    _close(got, jfn(tree, jnp.asarray(src), jnp.asarray(tgt)))
