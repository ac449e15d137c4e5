"""Sparse-band training (``nc_topk > 0``) of the port against the JAX package
on the CPU: the band coverage, the band match score and its gradient, the
band NC layer's VJP (dx, dw, db) against ``jax.vjp`` of the XLA path
(``sparse/nc.py::_band_conv`` + bias + ReLU) on both passes, the band NC
stack's gradients, the weak loss and three Adam steps with a band, the
port's full-K band training against its dense training, and the CLI. Both
sides start from one JAX init (`ncnet_tpu_torch.bridge.from_jax_params`);
inputs are numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.models.neigh_consensus import init_neigh_consensus
from ncnet_tpu.ops import band as jband
from ncnet_tpu.sparse import nc as jnc
from ncnet_tpu.sparse.score import (
    band_match_score_per_sample as jax_band_score,
)
from ncnet_tpu.train import loss as jax_loss
from ncnet_tpu.train import step as jax_step
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.kernels.band_gemm_dw import cell_major
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.ops import band
from ncnet_tpu_torch.sparse import sparse_neigh_consensus_apply
from ncnet_tpu_torch.sparse.score import band_match_score_per_sample
from ncnet_tpu_torch.train import loss as port_loss
from ncnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ncnet_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

# float32, the starting tolerance; the absolute part is relative to the
# compared quantity's scale
RTOL, ATOL = 1e-5, 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))
LR = 1e-3
# a JAX init whose NC ReLUs are partly live on these inputs (seed 1's last
# layer is dead on nearly every band entry, so its gradients are zero)
SEED = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the suite runs several test
    processes on the CPU at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _band(rng, b, ha, wa, hb, wb, k, mutual=True):
    """(values, indices) of a JAX top-K band over random scores; values are
    positive, like the post-mutual-matching band the score reads."""
    scores = rng.randn(b, ha, wa, hb, wb).astype(np.float32)
    values, idx = jband.topk_band(jnp.asarray(scores), k, mutual=mutual)
    return np.abs(np.array(values)) + 0.1, np.array(idx)


@pytest.mark.parametrize(
    "grids,k",
    [((2, 3, 4, 4, 3), 1), ((2, 4, 4, 4, 4), 5), ((1, 3, 5, 4, 2), 8)],
)
def test_band_coverage_equals_jax_bitwise(grids, k):
    b, ha, wa, hb, wb = grids
    _, idx = _band(np.random.RandomState(0), b, ha, wa, hb, wb, k)
    got = band.band_coverage(torch.from_numpy(idx), (hb, wb))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jband.band_coverage(jnp.asarray(idx), (hb, wb))))


SCORE_CASES = [
    # (b, hA, wA, hB, wB, K): K = 1 covers at most 12 of the 25 B cells
    (2, 3, 4, 5, 5, 1),
    (2, 4, 4, 4, 3, 5),
    (2, 3, 3, 4, 4, 16),  # full K: every B cell covered
]


@pytest.mark.parametrize("normalization", ["softmax", "l1", "none"])
@pytest.mark.parametrize("case", range(len(SCORE_CASES)))
def test_band_match_score_and_gradient_match_jax(case, normalization):
    b, ha, wa, hb, wb, k = SCORE_CASES[case]
    values, idx = _band(np.random.RandomState(case), b, ha, wa, hb, wb, k)
    weights = np.array([0.7, -1.3], np.float32)

    def jax_obj(v):
        return jnp.sum(jax_band_score(v, jnp.asarray(idx), (hb, wb),
                                      normalization) * weights)

    want_v, want_g = jax.value_and_grad(jax_obj)(jnp.asarray(values))
    tv = torch.from_numpy(values).requires_grad_(True)
    got = band_match_score_per_sample(tv, torch.from_numpy(idx), (hb, wb),
                                      normalization)
    assert got.shape == (b,) and bool(torch.isfinite(got).all())
    (got * torch.from_numpy(weights)).sum().backward()
    _close(got @ torch.from_numpy(weights), want_v)
    # uncovered B columns are NaN under softmax; none of it reaches values
    assert bool(torch.isfinite(tv.grad).all())
    assert np.isfinite(np.asarray(want_g)).all()
    _close(tv.grad, want_g)


def _jax_pointers(idx, grid_b, kernel, swapped):
    """JAX's pointer table of one pass, as ``sparse/nc.py`` builds it (the
    symmetric pass's rows permuted B-major and remapped)."""
    b = idx.shape[0]
    n = idx[0].size
    ptr = jband.band_neighbor_pointers(jnp.asarray(idx), grid_b, kernel,
                                       swapped=swapped).reshape(b, n, -1)
    if not swapped:
        return ptr
    perm = jnp.argsort(jnp.asarray(idx).reshape(b, n), axis=-1, stable=True)
    inv = jnp.argsort(perm, axis=-1, stable=True)
    rows = jnp.take_along_axis(ptr, perm[..., None], axis=1)
    remap = jnp.concatenate([inv.astype(jnp.int32),
                             jnp.full((b, 1), n, jnp.int32)], axis=1)
    return jnp.take_along_axis(remap, rows.reshape(b, -1),
                               axis=1).reshape(rows.shape)


LAYER_CASES = [
    # (b, hA, wA, hB, wB, K, ksize, cin, cout)
    (2, 4, 4, 4, 4, 5, 3, 4, 4),
    (1, 3, 5, 4, 2, 3, 3, 1, 4),   # rectangular A and B grids
    (1, 4, 3, 3, 4, 12, 3, 4, 1),  # complete band
    (1, 5, 4, 3, 5, 4, 5, 3, 2),   # kernel wider than a grid
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_band_layer_vjp_matches_jax(case, swapped, dtype):
    b, ha, wa, hb, wb, k, ks, cin, cout = LAYER_CASES[case]
    rng = np.random.RandomState(10 + case)
    _, idx = _band(rng, b, ha, wa, hb, wb, k)
    n = ha * wa * k
    kernel = (ks,) * 4
    x = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(*kernel, cin, cout) * 0.2).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    gy = rng.randn(b, n, cout).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ptr = _jax_pointers(idx, (hb, wb), kernel, swapped)

    def jax_layer(xx, ww, bb):
        y = jnc._band_conv(xx, ww, ptr) + bb.astype(xx.dtype)
        return jax.nn.relu(y)

    jx, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, w, bias))
    want, vjp = jax.vjp(jax_layer, jx, jw, jb)
    want_dx, want_dw, want_db = vjp(jnp.asarray(gy).astype(jdt))

    tdt = getattr(torch, dtype)
    tidx = torch.from_numpy(idx)
    geom = band.BandGeometry(tidx, (hb, wb),
                             *(band.b_major_order(tidx) if swapped else ()))
    tx, tw, tb = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (x, w, bias))
    out = band.band_layer(tx, tw, tb, geom)
    out.backward(torch.from_numpy(gy).to(tdt))
    assert out.dtype == tdt and tx.grad.dtype == tdt and tw.grad.dtype == tdt
    # float32: the starting tolerance. bfloat16: both sides round the
    # forward's product and biased sum, dx and dw to bfloat16 from float32
    # sums in other orders (2^-8 relative each, up to two steps apart
    # where a sum lies at a rounding boundary), and the ReLU mask can flip
    # where a bfloat16 output rounds to 0 on one side only
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-2)
    if dtype == "bfloat16":
        # JAX's db in bfloat16 is a sum accumulated in bfloat16 (its
        # reduce runs in the activation dtype: 35% off on 144 terms), the
        # port's a float32 sum rounded once, as its dense path's: held to
        # the float32 sum of JAX's own masked cotangent instead
        want_db = jnp.sum(jnp.where(want > 0, jnp.asarray(gy).astype(jdt), 0)
                          .astype(jnp.float32), axis=(0, 1))
    for got_t, want_t in ((out, want), (tx.grad, want_dx), (tw.grad, want_dw),
                          (tb.grad, want_db)):
        _close(got_t, np.asarray(want_t.astype(jnp.float32)), rtol, atol)


def test_band_layer_gradients_are_the_plain_versions():
    """The Function's CPU backward: dw is `band_dw_plain` and dx
    `band_dx_plain` of the ReLU-masked cotangent, equal to autograd's
    gradients of the plain layer; `band_dw_plain` is the hit list's
    contraction (`band_hits_plain`, the card kernel's oracle)."""
    rng = np.random.RandomState(3)
    for swapped in (False, True):
        _, idx = _band(rng, 2, 4, 3, 3, 5, 4)
        tidx = torch.from_numpy(idx)
        geom = band.BandGeometry(tidx, (3, 5),
                                 *(band.b_major_order(tidx) if swapped else ()))
        x = torch.from_numpy(rng.randn(2, 48, 3).astype(np.float32))
        gy = torch.from_numpy(rng.randn(2, 48, 5).astype(np.float32))
        w = torch.from_numpy((rng.randn(3, 3, 3, 3, 3, 5) * 0.2).astype(np.float32))
        tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        tb = torch.zeros(5, requires_grad=True)
        out = band.band_layer_plain(tx, tw, tb, geom)
        out.backward(gy)
        gp = gy * (out > 0)
        dw = band.band_dw_plain(x, gp, geom, (3, 3, 3, 3))
        _close(dw, tw.grad.numpy())
        _close(band.band_dx_plain(gp, w, geom), tx.grad.numpy())
        hits = band.band_hits_plain(tidx, (3, 5), (3, 3, 3, 3), geom.inv)
        counts = hits.tap_start[1:] - hits.tap_start[:-1]
        assert int(counts.sum()) == int((geom.pointers((3,) * 4) != 48).sum())
        tap = torch.repeat_interleave(torch.arange(81), counts.long())
        # the list's entries are cell-major: the pass's rows gathered so
        xc, gc = (cell_major(t, hits).reshape(-1, t.shape[2]) for t in (x, gp))
        prods = xc[hits.m.long()][:, :, None] * gc[hits.n.long()][:, None, :]
        from_hits = torch.zeros(81, 3, 5).index_add_(0, tap, prods)
        _close(from_hits.reshape(dw.shape), dw.numpy())
        # the Function, on a cotangent that arrives as an expanded view
        fx, fw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        fb = torch.zeros(5, requires_grad=True)
        band.band_layer(fx, fw, fb, geom).backward(gy[:, :1].expand(-1, 48, -1))
        out_e = band.band_layer_plain(x, w, torch.zeros(5), geom)
        gp_e = gy[:, :1].expand(-1, 48, -1) * (out_e > 0)
        _close(fw.grad, band.band_dw_plain(x, gp_e, geom, (3,) * 4).numpy())
        _close(fb.grad, gp_e.sum(dim=(0, 1)).numpy())


def test_band_layer_skips_dx_for_entries_without_grad(monkeypatch):
    calls = []
    real = band.band_dx_plain
    monkeypatch.setattr(band, "band_dx_plain",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(4)
    _, idx = _band(rng, 1, 3, 3, 3, 3, 4)
    geom = band.BandGeometry(torch.from_numpy(idx), (3, 3))
    x = torch.from_numpy(rng.rand(1, 36, 1).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 3, 1, 2).astype(np.float32))
    w.requires_grad_(True)
    band.band_layer(x, w, torch.zeros(2), geom).sum().backward()
    assert calls == [] and w.grad is not None
    x.requires_grad_(True)
    band.band_layer(x, w, torch.zeros(2), geom).sum().backward()
    assert calls == [1] and x.grad is not None


def _nc_params(seed, kernel_sizes=(3, 3), channels=(4, 1)):
    jp = jax.tree.map(np.asarray, init_neigh_consensus(
        jax.random.PRNGKey(seed), kernel_sizes, channels))
    tp = [{k: torch.from_numpy(np.array(v)).requires_grad_(True)
           for k, v in layer.items()} for layer in jp]
    return jp, tp


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("grids,k", [((4, 4, 4, 4), 5), ((3, 5, 4, 3), 4),
                                     ((3, 3, 3, 3), 1)])
def test_sparse_nc_gradients_match_jax(grids, k, symmetric):
    """The NC stack's gradients in its parameters and in the band values
    (which exercises layer 1's dx and the symmetric pass's permutations)."""
    ha, wa, hb, wb = grids
    rng = np.random.RandomState(5)
    values, idx = _band(rng, 2, ha, wa, hb, wb, k)
    r = rng.randn(*values.shape).astype(np.float32)
    jp, tp = _nc_params(2, channels=(4, 1))

    def jax_obj(params, v):
        out = jnc.sparse_neigh_consensus_apply(
            params, v, jnp.asarray(idx), (hb, wb), symmetric=symmetric)
        return jnp.sum(out * r)

    want, (want_gp, want_gv) = jax.value_and_grad(jax_obj, argnums=(0, 1))(
        jp, jnp.asarray(values))
    tv = torch.from_numpy(values).requires_grad_(True)
    out = sparse_neigh_consensus_apply(tp, tv, torch.from_numpy(idx), (hb, wb),
                                       symmetric=symmetric)
    got = (out * torch.from_numpy(r)).sum()
    got.backward()
    _close(got, want)
    _close(tv.grad, want_gv)
    for p, jpg in zip(tp, want_gp):
        for name in ("kernel", "bias"):
            _close(p[name].grad, jpg[name])


def _port(config_kw, seed=SEED):
    """(jax config, jax numpy tree, port config, port model on the CPU)."""
    jcfg = JaxConfig(**config_kw)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(seed), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return jcfg, tree, cfg, bridge.from_jax_params(tree, cfg, device="cpu")


def _batch(seed, b=2, tgt_hw=(64, 64)):
    rng = np.random.RandomState(seed)
    return {"source_image": rng.randn(b, 64, 64, 3).astype(np.float32),
            "target_image": rng.randn(b, *tgt_hw, 3).astype(np.float32)}


def _nc_leaves(tree_or_model):
    if isinstance(tree_or_model, dict):
        return [np.asarray(p[k]) for p in tree_or_model["neigh_consensus"]
                for k in ("kernel", "bias")]
    return [t.detach().numpy().copy()
            for p in tree_or_model.neigh_consensus.params()
            for t in (p["kernel"], p["bias"])]


@pytest.mark.parametrize("k", [5, 1])
@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("tgt_hw", [(64, 64), (48, 64)])
def test_weak_loss_band_and_nc_gradients_match_jax(tgt_hw, mutual, k):
    jcfg, tree, cfg, model = _port(dict(SMALL, nc_topk=k, nc_topk_mutual=mutual))
    batch = _batch(2, tgt_hw=tgt_hw)

    def f(nc):
        return jax_loss.weak_loss(dict(tree, neigh_consensus=nc), jcfg,
                                  {key: jnp.asarray(v) for key, v in batch.items()})

    want, want_g = jax.value_and_grad(f)(tree["neigh_consensus"])
    leaves = model.neigh_consensus.trainable()
    got = port_loss.weak_loss(model, cfg,
                              {key: torch.from_numpy(v) for key, v in batch.items()})
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)
    refs = _nc_leaves({"neigh_consensus": want_g})
    assert any(np.abs(ref).max() > 0 for ref in refs)  # live gradients
    for t, ref in zip(leaves, refs):
        assert bool(torch.isfinite(t.grad).all())  # K = 1: partial coverage
        _close(t.grad, ref)


@pytest.fixture(scope="module")
def jax_band_three_steps():
    """JAX's make_train_step with a K = 5 mutual band: per-step losses,
    step-1 NC gradients and NC params after each of 3 steps (f32, patch16,
    64 px, batch 4)."""
    jcfg, tree, _, _ = _port(dict(SMALL, nc_topk=5))
    batches = [_batch(10 + i, b=4) for i in range(3)]
    opt = jax_step.make_optimizer(LR)
    state = jax_step.create_train_state(tree, opt)
    step = jax_step.make_train_step(jcfg, opt, donate=False)

    def f(nc):
        return jax_loss.weak_loss(dict(tree, neigh_consensus=nc), jcfg,
                                  {k: jnp.asarray(v) for k, v in batches[0].items()})

    grads = _nc_leaves({"neigh_consensus": jax.grad(f)(tree["neigh_consensus"])})
    losses, params = [], []
    for b in batches:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
        params.append(_nc_leaves(jax.tree.map(np.asarray, state.params)))
    return batches, grads, losses, params


def test_three_band_train_steps_match_jax(jax_band_three_steps):
    batches, want_grads, want_losses, want_params = jax_band_three_steps
    _, _, cfg, model = _port(dict(SMALL, nc_topk=5))
    trunk = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    state = create_train_state(model, LR)
    step = make_train_step(cfg)
    for i, b in enumerate(batches):
        state, loss = step(state, b)
        if i == 0:
            for t, ref in zip(state.optimizer.param_groups[0]["params"], want_grads):
                _close(t.grad, ref)
        assert loss.dtype == torch.float32
        _close(loss, want_losses[i])
        for got, ref in zip(_nc_leaves(model), want_params[i]):
            # Adam scales each update to about +-lr, and where a
            # parameter's gradients nearly cancel across steps m / sqrt(v)
            # magnifies their float32 differences: 1% of lr absolute (a
            # gradient of the wrong sign would move it by about 2 lr)
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-2 * LR)
    assert state.step == 3
    for k, v in model.feature_extraction.state_dict().items():
        assert torch.equal(v, trunk[k]), k  # the trunk is frozen


@pytest.mark.parametrize("tgt_hw", [(64, 64), (48, 64)])
def test_full_k_band_training_equals_dense_training(tgt_hw):
    """K = hB*wB is the complete band: three band steps equal three dense
    steps of the port (losses and NC params; float32 sums in other
    orders, so to the tolerances of the JAX comparison)."""
    nb = (tgt_hw[0] // 16) * (tgt_hw[1] // 16)
    batches = [_batch(30 + i, tgt_hw=tgt_hw) for i in range(3)]
    runs = []
    for k in (0, nb):
        _, _, cfg, model = _port(dict(SMALL, nc_topk=k))
        state = create_train_state(model, LR)
        step = make_train_step(cfg)
        losses = [step(state, b)[1] for b in batches]
        runs.append((losses, _nc_leaves(model)))
    (dense_l, dense_p), (band_l, band_p) = runs
    for a, b in zip(band_l, dense_l):
        _close(a, b.numpy())
    for a, b in zip(band_p, dense_p):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-2 * LR)


def test_band_eval_step_matches_weak_loss_without_gradient():
    _, _, cfg, model = _port(dict(SMALL, nc_topk=5))
    model.neigh_consensus.trainable()
    batch = _batch(4)
    got = make_eval_step(cfg)(model, batch)
    assert got.grad_fn is None
    want = port_loss.weak_loss(model, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    assert torch.equal(got, want.detach())


def test_checkpoint_keeps_the_band_config(tmp_path):
    _, _, cfg, model = _port(dict(SMALL, nc_topk=5, nc_topk_mutual=False))
    state = create_train_state(model, LR)
    make_train_step(cfg)(state, _batch(7))
    path = str(tmp_path / "band.npz")
    save_checkpoint(path, state, cfg, epoch=0)
    ck = load_checkpoint(path)
    assert ck.config == cfg
    assert ck.config.nc_topk == 5 and ck.config.nc_topk_mutual is False


TOY = ["--synthetic", "--allow_random_fe", "--device", "cpu", "--fe_arch",
       "patch16", "--image_size", "64", "--ncons_kernel_sizes", "3", "3",
       "--ncons_channels", "4", "1", "--batch_size", "2", "--synthetic_pairs",
       "8", "--num_workers", "2", "--lr", "1e-3", "--num_epochs", "1"]


def test_cli_band_training_resumes_with_the_band_kept(tmp_path):
    from ncnet_tpu_torch.train.__main__ import main as train_main

    out = str(tmp_path / "run")
    report = train_main(TOY + ["--nc_topk", "4", "--result_model_dir", out,
                               "--max-steps", "2"])
    assert report["steps"] == 2 and all(np.isfinite(report["step_losses"]))
    assert report["config"]["nc_topk"] == 4
    assert report["config"]["nc_topk_mutual"] is True
    assert set(report["kernel_launches"]) >= {"band_gemm_fwd", "band_gemm_dx",
                                               "band_gemm_dw"}
    assert not any(report["kernel_launches"].values())  # CPU: plain versions
    ck = load_checkpoint(report["checkpoint"])
    assert ck.config.nc_topk == 4 and ck.config.nc_topk_mutual is True
    # unset keeps the checkpoint's band; a flag overrides it either way
    kept = train_main(TOY + ["--result_model_dir", out, "--max-steps", "3",
                             "--checkpoint", report["checkpoint"]])
    assert kept["config"]["nc_topk"] == 4 and kept["steps"] == 3
    over = train_main(TOY + ["--result_model_dir", str(tmp_path / "o"),
                             "--max-steps", "4", "--checkpoint",
                             kept["checkpoint"], "--nc_topk", "0",
                             "--no-nc_topk_mutual"])
    assert over["config"]["nc_topk"] == 0
    assert over["config"]["nc_topk_mutual"] is False and over["steps"] == 4


def test_dw_segments_cut_each_tap_in_order():
    """The dw kernel's blocks: the list cut evenly into segments of
    `SEGMENT` hits, each segment's piece of each tap summed apart into
    partial row segment + tap; each tap's pieces cover its run in order, a
    tap without hits has none, and no two pieces share a partial row."""
    from ncnet_tpu_torch.kernels.band_gemm_dw import segments

    start = torch.tensor([0, 5, 5, 13, 20, 20])
    lo, hi, tap, piece = segments(start, length=4)
    assert lo.dtype == hi.dtype == tap.dtype == piece.dtype == torch.int64
    assert lo.tolist() == [0, 4, 5, 8, 12, 13, 16]
    assert hi.tolist() == [4, 5, 8, 12, 13, 16, 20]
    assert tap.tolist() == [0, 0, 2, 2, 2, 3, 3]
    assert piece.tolist() == [0, 1, 3, 4, 5, 6, 7]
    assert bool((hi - lo <= 4).all()) and len(set(piece.tolist())) == len(piece)
    for t in range(len(start) - 1):
        covered = [h for a, b in zip(lo[tap == t].tolist(), hi[tap == t].tolist())
                   for h in range(a, b)]
        assert covered == list(range(start[t], start[t + 1]))


def test_dw_segments_are_exact_past_int32():
    """A list past 2^32 hits: every piece's bounds are exact int64, and
    the pieces tile the list."""
    from ncnet_tpu_torch.kernels.band_gemm_dw import SEGMENT, segments

    per_tap = torch.tensor([2**31 - 5, 0, 7, 3 * 2**30 + 1], dtype=torch.int64)
    start = torch.cat([per_tap.new_zeros(1), per_tap.cumsum(0)])
    assert int(start[-1]) > 2**32
    lo, hi, tap, piece = segments(start)
    assert lo.dtype == torch.int64 and int(lo[0]) == 0
    assert int(hi[-1]) == int(start[-1]) == 2**31 - 5 + 7 + 3 * 2**30 + 1
    assert torch.equal(lo[1:], hi[:-1])  # contiguous, in list order
    assert bool((hi > lo).all()) and bool((hi - lo <= SEGMENT).all())
    # each piece lies in its tap and in its segment; the tap of 7 hits
    # straddles the boundary at 2^31 - 5 + 7 and is cut nowhere else
    assert bool((lo >= start[tap]).all()) and bool((hi <= start[tap + 1]).all())
    seg = torch.div(lo, SEGMENT, rounding_mode="floor")
    assert torch.equal(seg, torch.div(hi - 1, SEGMENT, rounding_mode="floor"))
    assert torch.equal(piece, seg + tap)
    assert lo[tap == 2].tolist() == [2**31 - 5, 2**31]
    assert hi[tap == 2].tolist() == [2**31, 2**31 + 2]
    assert 1 not in tap.tolist()


def test_band_gradient_wrappers_refuse_what_they_do_not_take():
    from ncnet_tpu_torch.kernels.band_gemm import band_gemm_dx, band_gemm_fwd
    from ncnet_tpu_torch.kernels.band_gemm_dw import band_gemm_dw

    idx = torch.tensor([[[[0], [1]], [[2], [3]]]], dtype=torch.int32)
    x, w = torch.zeros(1, 4, 1), torch.zeros(3, 3, 3, 3, 1, 1)
    hits = band.band_hits_plain(idx, (2, 2), (3, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        band_gemm_dx(x, w, hits)
    with pytest.raises(ValueError, match="odd sizes"):
        band_gemm_dx(x, torch.zeros(2, 3, 3, 3, 1, 1), hits)
    with pytest.raises(ValueError, match="takes a bias"):
        band_gemm_fwd(x, w, None, idx, (2, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        band_gemm_dw.hit_list(idx, (2, 2), (3, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        band_gemm_dw(x, x, hits)


@pytest.mark.parametrize("b, k", [
    (16, 50),   # band training's band: 312.5 M hits at most
    (16, 625),  # the complete band at 400 px: 3.9e9, past int32
    (24, 625),  # 5.9e9, which int32 offsets would wrap back to positive
])
def test_band_dw_hit_list_takes_bands_past_int32_offsets(b, k):
    """The hit list's offsets are int64: no band is refused for the number
    of hits it may hold (memory bounds it, read back before the list is
    allocated). Meta tensors carry the shapes without their memory; each
    band passes the size checks and reaches the device check."""
    from ncnet_tpu_torch.kernels.band_gemm_dw import band_gemm_dw

    idx = torch.empty(b, 25, 25, k, dtype=torch.int32, device="meta")
    assert b * 625 * k * 625 > 2**31 or k == 50
    with pytest.raises(ValueError, match="CUDA tensors"):
        band_gemm_dw.hit_list(idx, (25, 25), (5, 5, 5, 5))


HIT_CASES = [
    # (b, hA, wA, hB, wB, K, ksize)
    (2, 4, 4, 4, 4, 5, 3),
    (1, 3, 5, 4, 2, 3, 3),
    (1, 4, 3, 3, 4, 12, 3),  # complete band
    (1, 5, 4, 3, 5, 4, 5),   # kernel wider than a grid
]


@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("case", range(len(HIT_CASES)))
def test_band_hits_plain_offsets_are_int64_and_count_jax_pointers(case, swapped):
    """`band_hits_plain`: int64 offsets of every tap and every (tap, output
    block) run, each run's length the non-null pointers of JAX's table at
    that tap from that A cell; the hits are that table's (entries
    cell-major), listed by tap, then block, then slot; and every run reads
    one A cell, its block's shifted by the tap's A offset (the run
    property dx is built on)."""
    b, ha, wa, hb, wb, k, ks = HIT_CASES[case]
    _, idx = _band(np.random.RandomState(30 + case), b, ha, wa, hb, wb, k)
    kernel = (ks,) * 4
    taps, nblk, n = ks**4, b * ha * wa, ha * wa * k
    tidx = torch.from_numpy(idx)
    geom = band.BandGeometry(tidx, (hb, wb),
                             *(band.b_major_order(tidx) if swapped else ()))
    hits = band.band_hits_plain(tidx, (hb, wb), kernel, geom.inv)
    assert hits.tap_start.dtype == hits.block_start.dtype == torch.int64
    assert hits.block_start.shape == (taps * nblk + 1,)
    assert torch.equal(hits.block_start[::nblk], hits.tap_start)
    # JAX's table over the pass's rows: [b, N, T], null N; on the symmetric
    # pass row r is cell-major entry perm[r], of A cell perm[r] // K
    ptr = np.array(_jax_pointers(idx, (hb, wb), kernel, swapped))
    cell_of_row = (geom.perm.long().numpy() if swapped
                   else np.broadcast_to(np.arange(n), (b, n))) // k
    runs = np.zeros((taps, b, ha * wa), np.int64)
    for bi in range(b):
        for t in range(taps):
            live = ptr[bi, :, t] != n
            np.add.at(runs[t, bi], cell_of_row[bi][live], 1)
    np.testing.assert_array_equal(np.diff(hits.block_start.numpy()), runs.reshape(-1))
    # the hits: (n, m) of every non-null pointer, entries cell-major and
    # flattened over the batch; the table's rows are the pass's (row of
    # entry e: inv[e] on the symmetric pass)
    ent_n, ent_m = hits.n.long().numpy(), hits.m.long().numpy()
    assert ent_n.size == int((ptr != n).sum())
    row_of = (geom.inv.long().numpy() if swapped
              else np.broadcast_to(np.arange(n), (b, n)))
    tap = torch.repeat_interleave(torch.arange(taps), torch.diff(hits.tap_start)).numpy()
    got = set(zip((ent_n // n * n + row_of.reshape(-1)[ent_n]).tolist(),
                  (ent_m // n * n + row_of.reshape(-1)[ent_m]).tolist(), tap.tolist()))
    bi_, r_, t_ = np.nonzero(ptr != n)
    want = set(zip((bi_ * n + r_).tolist(), (bi_ * n + ptr[bi_, r_, t_]).tolist(),
                   t_.tolist()))
    assert got == want
    # the run property, and slot order within a run
    shifts = band.tap_a_shifts(kernel, swapped).numpy()
    starts = hits.block_start.numpy()
    for r in np.nonzero(np.diff(starts))[0]:
        t, blk = divmod(int(r), nblk)
        a = blk % (ha * wa)
        h = slice(starts[r], starts[r + 1])
        assert (ent_n[h] % n // k == a).all()
        want_cell = (a // wa + shifts[t, 0]) * wa + a % wa + shifts[t, 1]
        assert (ent_m[h] % n // k == want_cell).all()
        assert (np.diff(ent_n[h]) > 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_band_dx_over_the_hit_list_matches_jax(case, swapped, dtype):
    """The dx kernel's order of work (`band_dx_hits_plain`: per output A
    cell, the taps in order, each tap's run of the hit list read through
    the per-(tap, block) offsets) against ``jax.vjp`` of the JAX band
    layer's input gradient."""
    b, ha, wa, hb, wb, k, ks, cin, cout = LAYER_CASES[case]
    rng = np.random.RandomState(10 + case)
    _, idx = _band(rng, b, ha, wa, hb, wb, k)
    n = ha * wa * k
    kernel = (ks,) * 4
    x = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(*kernel, cin, cout) * 0.2).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    gy = rng.randn(b, n, cout).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ptr = _jax_pointers(idx, (hb, wb), kernel, swapped)
    jw, jb = jnp.asarray(w).astype(jdt), jnp.asarray(bias).astype(jdt)

    def jax_layer(xx):
        return jax.nn.relu(jnc._band_conv(xx, jw, ptr) + jb.astype(xx.dtype))

    out, vjp = jax.vjp(jax_layer, jnp.asarray(x).astype(jdt))
    jgy = jnp.asarray(gy).astype(jdt)
    (want_dx,) = vjp(jgy)

    tdt = getattr(torch, dtype)
    tidx = torch.from_numpy(idx)
    geom = band.BandGeometry(tidx, (hb, wb),
                             *(band.b_major_order(tidx) if swapped else ()))
    hits = band.band_hits_plain(tidx, (hb, wb), kernel, geom.inv)
    gp = torch.from_numpy(np.array(jnp.where(out > 0, jgy, 0).astype(jnp.float32)))
    got = band.band_dx_hits_plain(gp.to(tdt), torch.from_numpy(w).to(tdt), hits)
    assert got.dtype == tdt and got.shape == (b, n, cin)
    # bfloat16: both round dx once from float32 sums in other orders
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-2)
    _close(got, np.asarray(want_dx.astype(jnp.float32)), rtol, atol)
