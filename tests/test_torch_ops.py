"""The port's ops against the JAX package on the same numpy inputs:
feature_l2norm, correlation_4d, mutual_matching and corr_to_matches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.ops.correlation import correlation_4d as jax_correlation_4d
from ncnet_tpu.ops.matches import corr_to_matches as jax_corr_to_matches
from ncnet_tpu.ops.matching import mutual_matching as jax_mutual_matching
from ncnet_tpu.ops.norm import feature_l2norm as jax_feature_l2norm
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.matches import corr_to_matches
from ncnet_tpu_torch.ops.matching import mutual_matching
from ncnet_tpu_torch.ops.norm import feature_l2norm

# float32, the issue's starting tolerance
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol,
    )


def test_feature_l2norm_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 4, 16).astype(np.float32)
    x[0, 0, 0] = 0.0  # eps inside the sqrt keeps a zero vector finite
    _close(feature_l2norm(torch.from_numpy(x)), jax_feature_l2norm(jnp.asarray(x)))


@pytest.mark.parametrize("normalization", [False, True])
def test_correlation_4d_matches_jax(normalization):
    rng = np.random.RandomState(1)
    fa = rng.randn(2, 3, 4, 8).astype(np.float32)
    fb = rng.randn(2, 5, 2, 8).astype(np.float32)
    want = jax_correlation_4d(jnp.asarray(fa), jnp.asarray(fb), normalization)
    got = correlation_4d(torch.from_numpy(fa), torch.from_numpy(fb), normalization)
    assert got.shape == (2, 3, 4, 5, 2)
    _close(got, want)


def test_mutual_matching_matches_jax():
    corr = np.random.RandomState(2).rand(2, 3, 4, 5, 2).astype(np.float32)
    _close(mutual_matching(torch.from_numpy(corr)),
           jax_mutual_matching(jnp.asarray(corr)))


def _planted_ties(seed):
    """Correlation with exact ties planted in both readout directions."""
    rng = np.random.RandomState(seed)
    corr = rng.rand(2, 3, 4, 5, 2).astype(np.float32)
    flat = corr.reshape(2, 12, 10)
    flat[:, 3, 1] = flat[:, 7, 1] = 2.0  # B cell 1: A cells 3 and 7 tie
    flat[:, 5, 4] = flat[:, 5, 8] = 3.0  # A cell 5: B cells 4 and 8 tie
    return corr


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("do_softmax", [False, True])
@pytest.mark.parametrize("scale", ["positive", "centered"])
def test_corr_to_matches_matches_jax(invert, do_softmax, scale):
    corr = _planted_ties(seed=3)
    kw = dict(do_softmax=do_softmax, scale=scale,
              invert_matching_direction=invert, return_indices=True)
    want = jax_corr_to_matches(jnp.asarray(corr), **kw)
    got = corr_to_matches(torch.from_numpy(corr), **kw)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)
    for g, w in zip(got[5:], want[5:]):  # indices: ties take the first max
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_corr_to_matches_ties_take_first_maximum():
    corr = _planted_ties(seed=4)
    _, _, _, _, _, i_a, j_a, _, _ = corr_to_matches(
        torch.from_numpy(corr), return_indices=True
    )
    assert (i_a[:, 1] * 4 + j_a[:, 1]).tolist() == [3, 3]
    _, _, _, _, _, _, _, i_b, j_b = corr_to_matches(
        torch.from_numpy(corr), invert_matching_direction=True,
        return_indices=True,
    )
    assert (i_b[:, 5] * 2 + j_b[:, 5]).tolist() == [4, 4]
