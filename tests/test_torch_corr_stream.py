"""The port's streamed correlation band (``ncnet_tpu_torch/ops/corr_stream.py``,
ROADMAP A9) against its own dense band and against the JAX package.

Two gates (the band of `topk_band` is the reference):

(a) bit for bit, values and indices, against ``topk_band(corr_s, k,
    values_from=mutual_matching(corr_s), mutual=...)`` with ``corr_s`` the
    correlation built from the same slabs (`slab_correlation`): this holds
    the merge, the tie order and the mutual theorem exact;
(b) against the band of ``correlation_4d``'s volume: values at rtol 1e-5 /
    atol 1e-6 (float32's parity tolerance), indices equal up
    to near ties at the band's edge, counted by `band_index_swaps`; where
    the backend's GEMM gives slabs bitwise the volume's columns, bitwise.

The nA < K mutual shape ``(2, 3, 2, 7, 5, 12)`` is held to the port's own
dense band: JAX's stream fails its own bitwise test there, so the JAX
comparison runs on the shapes where that test passes. Inputs are numpy
from a seed; the NC weights come from the JAX init through the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.neigh_consensus import init_neigh_consensus
from ncnet_tpu.ops.corr_stream import corr_stream_band as jax_corr_stream_band
from ncnet_tpu.sparse.pipeline import sparse_match_pipeline as jax_sparse_pipeline
from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.ops.band import topk_band
from ncnet_tpu_torch.ops.corr_stream import (
    band_index_swaps,
    corr_stream_band,
    resolve_corr_tile,
    slab_correlation,
)
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.matching import mutual_matching
from ncnet_tpu_torch.sparse.pipeline import resolve_corr_impl, sparse_match_pipeline
from ncnet_tpu_torch.train.step import create_train_state, make_train_step

# float32: the port's parity tolerance against rounding in another sum order
RTOL, ATOL = 1e-5, 1e-6
# the gradient of v = c^3 / ((rm + eps)(cm + eps)) sums three routes in
# another order than jax.vjp's one-hot einsums and the dense autograd's
# scatter: 2e-5 of the gradient's scale (the JAX package's own stream-vs-
# dense gradient test allows rtol 2e-4)
GRAD_RTOL = 2e-5

SHAPES = [
    (2, 5, 7, 6, 9, 16),  # rectangular, hA*wA != hB*wB
    (1, 4, 4, 4, 4, 8),  # square
    (2, 3, 2, 7, 5, 12),  # nA = 6 < K for K = nb
]
# where the JAX package's own stream passes its bitwise test
JAX_CASES = [(SHAPES[0], False), (SHAPES[0], True), (SHAPES[1], False),
             (SHAPES[1], True), (SHAPES[2], False)]


def _feats(seed, b, h, w, c, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)


def _band(corr, k, mutual):
    return topk_band(corr, k, values_from=mutual_matching(corr), mutual=mutual)


def _bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    view = {2: torch.int16, 4: torch.int32}[got.element_size()]
    assert torch.equal(got.view(view), want.view(view))


def _gate_b(fa, fb, k, mutual, got_v, got_i, tile):
    """Gate (b) against `correlation_4d`'s band; returns the swap count."""
    corr = correlation_4d(fa, fb)
    want_v, want_i = _band(corr, k, mutual)
    swaps = band_index_swaps(corr, slab_correlation(fa, fb, tile), got_i, want_i)
    assert swaps["near_ties"] == swaps["entries"], swaps
    same = (got_i == want_i).all(-1, keepdim=True).expand_as(got_i)
    np.testing.assert_allclose(got_v[same].float().numpy(),
                               want_v[same].float().numpy(), rtol=RTOL, atol=ATOL)
    if swaps["delta"] == 0.0:  # slabs bitwise the volume: so is the band
        _bitwise(got_v, want_v)
        assert torch.equal(got_i, want_i)
    return swaps


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_stream_band_matches_dense_band(shape, mutual):
    b, ha, wa, hb, wb, c = shape
    nb = hb * wb
    fa, fb = _feats(0, b, ha, wa, c), _feats(1, b, hb, wb, c)
    for k in (1, 3, nb):
        for tile in (5, nb):  # 5 divides none of 54, 16, 35
            got_v, got_i = corr_stream_band(fa, fb, k, mutual=mutual, tile=tile)
            assert got_i.dtype == torch.int32 and got_v.shape == (b, ha, wa, k)
            want_v, want_i = _band(slab_correlation(fa, fb, tile), k, mutual)
            assert torch.equal(got_i, want_i)
            _bitwise(got_v, want_v)
            _gate_b(fa, fb, k, mutual, got_v, got_i, tile)


@pytest.mark.parametrize("mutual", [False, True])
def test_stream_band_bitwise_bf16(mutual):
    fa = _feats(2, 2, 4, 5, 8, torch.bfloat16)
    fb = _feats(3, 2, 3, 6, 8, torch.bfloat16)
    got_v, got_i = corr_stream_band(fa, fb, 4, mutual=mutual, tile=7)
    assert got_v.dtype == torch.bfloat16
    want_v, want_i = _band(slab_correlation(fa, fb, 7), 4, mutual)
    assert torch.equal(got_i, want_i)
    _bitwise(got_v, want_v)


@pytest.mark.parametrize("mutual", [False, True])
def test_stream_band_ties_bitwise(mutual):
    """Small-integer features: many dot products collide exactly (and every
    order of summation gives them), so the tie order is load-bearing."""
    rng = np.random.RandomState(11)
    fa = torch.from_numpy(rng.randint(-1, 2, (2, 3, 4, 6)).astype(np.float32))
    fb = torch.from_numpy(rng.randint(-1, 2, (2, 4, 3, 6)).astype(np.float32))
    want_v, want_i = _band(correlation_4d(fa, fb), 5, mutual)
    got_v, got_i = corr_stream_band(fa, fb, 5, mutual=mutual, tile=4)
    assert torch.equal(got_i, want_i)
    _bitwise(got_v, want_v)


def test_stream_band_signed_zeros():
    """Orthogonal one-hot features: most correlations are +0.0 or -0.0;
    both sorts compare them equal, so the index order decides."""
    fa = torch.zeros(1, 3, 3, 9)
    fb = torch.zeros(1, 3, 3, 9)
    fa[0].view(9, 9)[torch.arange(9), torch.arange(9)] = 1.0
    fb[0].view(9, 9)[torch.arange(9), (torch.arange(9) + 4) % 9] = -1.0
    fb[0, 0, 0, 0] = 2.0
    for mutual in (False, True):
        want_v, want_i = _band(correlation_4d(fa, fb), 4, mutual)
        got_v, got_i = corr_stream_band(fa, fb, 4, mutual=mutual, tile=2)
        assert torch.equal(got_i, want_i)
        _bitwise(got_v, want_v)


@pytest.mark.parametrize("mutual", [False, True])
def test_stream_band_complete_band_chains_to_dense(mutual):
    fa, fb = _feats(4, 1, 3, 3, 8), _feats(5, 1, 3, 3, 8)
    got_v, got_i = corr_stream_band(fa, fb, 9, mutual=mutual, tile=2)
    want_v, want_i = _band(slab_correlation(fa, fb, 2), 9, mutual)
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)
    # the complete band in row-major order is the gated volume itself
    dense = mutual_matching(slab_correlation(fa, fb, 2)).reshape(1, 3, 3, 9)
    assert torch.equal(got_i, torch.arange(9, dtype=torch.int32).expand(1, 3, 3, 9))
    assert torch.equal(got_v, dense)


@pytest.mark.parametrize("shape,mutual", JAX_CASES)
def test_stream_band_matches_jax(shape, mutual):
    b, ha, wa, hb, wb, c = shape
    nb = hb * wb
    fa, fb = _feats(0, b, ha, wa, c), _feats(1, b, hb, wb, c)
    for k in (3, nb):
        jv, ji = jax_corr_stream_band(jnp.asarray(fa.numpy()),
                                      jnp.asarray(fb.numpy()), k,
                                      mutual=mutual, tile=5)
        got_v, got_i = corr_stream_band(fa, fb, k, mutual=mutual, tile=5)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(jv), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mutual", [False, True])
def test_stream_band_grad_matches_jax_and_dense(mutual):
    """The backward against ``jax.vjp`` of JAX's `corr_stream_band` (the
    same routing) and against the port's autograd through the dense band
    (random features: no tied maxima, where the routings would differ)."""
    fa, fb = _feats(8, 2, 3, 4, 8), _feats(9, 2, 4, 3, 8)
    ct = np.random.RandomState(10).randn(2, 3, 4, 5).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_corr_stream_band(a, b, 5, mutual=mutual,
                                                       tile=5)[0],
                     jnp.asarray(fa.numpy()), jnp.asarray(fb.numpy()))
    want = vjp(jnp.asarray(ct))

    def grads(band_fn):
        a, b = fa.clone().requires_grad_(), fb.clone().requires_grad_()
        values, _ = band_fn(a, b)
        (values * torch.from_numpy(ct)).sum().backward()
        return a.grad, b.grad

    got = grads(lambda a, b: corr_stream_band(a, b, 5, mutual=mutual, tile=5))
    dense = grads(lambda a, b: _band(correlation_4d(a, b), 5, mutual))
    for g, w, d in zip(got, want, dense):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_RTOL * scale)
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale)


def test_stream_band_backward_is_deterministic():
    fa, fb = _feats(12, 2, 5, 4, 16), _feats(13, 2, 4, 6, 16)
    outs = []
    for _ in range(2):
        a, b = fa.clone().requires_grad_(), fb.clone().requires_grad_()
        values, _ = corr_stream_band(a, b, 6, mutual=True, tile=7)
        (values ** 2).sum().backward()
        outs.append((a.grad, b.grad))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_stream_band_validation():
    f = _feats(10, 1, 2, 2, 4)
    with pytest.raises(ValueError, match="tile"):
        resolve_corr_tile(0, 4)
    assert resolve_corr_tile(128, 4) == 4  # clamped to nb
    with pytest.raises(ValueError, match="tile"):
        corr_stream_band(f, f, 2, tile=0)
    for k in (0, 5):  # k outside [1, hB*wB]
        with pytest.raises(ValueError, match="band width"):
            corr_stream_band(f, f, k)
    with pytest.raises(ValueError, match="corr_impl"):
        resolve_corr_impl(ImMatchNetConfig(corr_impl="tiled"))
    with pytest.raises(ValueError, match="band path"):
        ImMatchNet(ImMatchNetConfig(feature_extraction_cnn="patch16",
                                    corr_impl="stream"), device="cpu")


def _nc_params(seed):
    jp = jax.tree.map(np.asarray, init_neigh_consensus(
        jax.random.PRNGKey(seed), (3,), (1,)))
    return jp, [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                for layer in jp]


@pytest.mark.parametrize("mutual", [True, False])
def test_sparse_pipeline_stream_equals_dense_and_jax(mutual):
    """`sparse_match_pipeline` with ``corr_impl='stream'`` against the dense
    one (the same band up to gate (b), so the same NC output) and against
    the JAX package's streamed pipeline."""
    base = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3,),
                ncons_channels=(1,), nc_topk=5, nc_topk_mutual=mutual)
    cfg_d = ImMatchNetConfig(**base)
    cfg_s = cfg_d.replace(corr_impl="stream", corr_stream_tile=6)
    jp, tp = _nc_params(0)
    fa, fb = _feats(12, 2, 3, 4, 256), _feats(13, 2, 4, 3, 256)
    vd, id_, gd = sparse_match_pipeline(tp, cfg_d, fa, fb)
    vs, is_, gs = sparse_match_pipeline(tp, cfg_s, fa, fb)
    assert gd == gs and torch.equal(is_, id_)
    np.testing.assert_allclose(vs.numpy(), vd.numpy(), rtol=RTOL, atol=ATOL)
    if torch.equal(slab_correlation(fa, fb, 6), correlation_4d(fa, fb)):
        assert torch.equal(vs, vd)
    jv, ji, jg = jax_sparse_pipeline(
        jp, JaxConfig(**base, corr_impl="stream", corr_stream_tile=6),
        jnp.asarray(fa.numpy()), jnp.asarray(fb.numpy()))
    assert tuple(jg) == gs
    np.testing.assert_array_equal(is_.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vs.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)


def _train(cfg, batches, train_fe, seed=0):
    model = ImMatchNet(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, train_fe=train_fe)
    step = make_train_step(cfg, train_fe=train_fe,
                           from_features=not train_fe)
    losses = []
    for batch in batches:
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, [p.detach().clone() for p in state.optimizer.param_groups[0]["params"]]


def test_training_three_steps_stream_equals_dense():
    """3 Adam steps, dense against stream (tile 6 does not divide nb = 12):
    from cached features (frozen trunk: the band's forward alone decides,
    held at float32's tolerance) and with the patch16 trunk trained (the
    stream's backward runs into the trunk, against the dense band's
    autograd). Trained trunk tensors are held to 0.1 lr after the steps:
    Adam moves an element by about lr * g / |g|, so a gradient within
    rounding of zero may move differently (tests/test_torch_finetune.py's
    reasoning)."""
    cfg_d = ImMatchNetConfig(feature_extraction_cnn="patch16",
                             ncons_kernel_sizes=(3,), ncons_channels=(1,),
                             nc_topk=5, half_precision=False)
    cfg_s = cfg_d.replace(corr_impl="stream", corr_stream_tile=6)
    rng = np.random.RandomState(21)
    feats = [{"source_features": rng.randn(2, 3, 4, 256).astype(np.float32),
              "target_features": rng.randn(2, 3, 4, 256).astype(np.float32)}
             for _ in range(3)]
    images = [{"source_image": rng.randn(2, 48, 64, 3).astype(np.float32),
               "target_image": rng.randn(2, 48, 64, 3).astype(np.float32)}
              for _ in range(3)]
    for batches, train_fe in ((feats, False), (images, True)):
        losses_d, params_d = _train(cfg_d, batches, train_fe)
        losses_s, params_s = _train(cfg_s, batches, train_fe)
        np.testing.assert_allclose(losses_s, losses_d, rtol=RTOL, atol=ATOL)
        assert len(params_s) == len(params_d) > (2 if train_fe else 0)
        atol = 0.1 * 5e-4 if train_fe else ATOL
        for ps, pd in zip(params_s, params_d):
            np.testing.assert_allclose(ps.numpy(), pd.numpy(), rtol=RTOL,
                                       atol=atol)


def test_band_index_swaps_tells_near_ties_from_faults():
    """Gate (b)'s counter: a swap between entries within the volumes'
    difference of each other is a near tie, any other swap is not."""
    corr = torch.tensor([1.0, 2.0, 2.0 + 1e-7, 0.5]).reshape(1, 1, 1, 1, 4)
    other = corr.clone()
    other[..., 1] += 2e-7
    band = torch.tensor([2], dtype=torch.int32).reshape(1, 1, 1, 1)
    tie = band_index_swaps(corr, other, band, band - 1)
    assert tie["entries"] == tie["near_ties"] == 2 and tie["rows"] == 1
    fault = band_index_swaps(corr, other, band, band + 1)
    assert fault["entries"] == 2 and fault["near_ties"] == 1
    same = band_index_swaps(corr, corr, band, band)
    assert same == {"rows": 0, "entries": 0, "near_ties": 0, "delta": 0.0}
