"""The port's training path against the JAX package on the CPU: the match
score (with planted ties), the weak loss and its NC gradients, three Adam
steps of ``make_train_step``, the bfloat16 drill, checkpoints, resume and
the loop. Both sides are built from one JAX init through
`ncnet_tpu_torch.bridge.from_jax_params`; inputs are numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.train import loss as jax_loss
from ncnet_tpu.train import step as jax_step
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.train import loss as port_loss
from ncnet_tpu_torch.train.checkpoint import (
    load_checkpoint,
    restore,
    save_checkpoint,
)
from ncnet_tpu_torch.train.loop import train
from ncnet_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    merge_trainable,
    trainable_subset,
)

# float32, the starting tolerance; the absolute part is relative to the
# compared quantity's scale
RTOL, ATOL = 1e-5, 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs, restored after: the suite
    runs several test processes on the CPU at once, and torch's default of
    one OpenMP thread per core then oversubscribes it, so small convolutions
    wait on each other's spinning threads (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(config_kw, seed=0):
    """(jax config, jax numpy tree, port config, port model on the CPU)."""
    jcfg = JaxConfig(**config_kw)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(seed), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    return jcfg, tree, cfg, bridge.from_jax_params(tree, cfg, device="cpu")


def _batch(seed, b=4, hw=64):
    rng = np.random.RandomState(seed)
    return {"source_image": rng.randn(b, hw, hw, 3).astype(np.float32),
            "target_image": rng.randn(b, hw, hw, 3).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _nc_leaves(tree_or_model):
    if isinstance(tree_or_model, dict):
        return [np.asarray(p[k]) for p in tree_or_model["neigh_consensus"]
                for k in ("kernel", "bias")]
    return [t.detach().numpy().copy()
            for p in tree_or_model.neigh_consensus.params()
            for t in (p["kernel"], p["bias"])]


def _planted_ties(seed):
    """A correlation whose max over A (and over B) is tied at several
    cells, planted after a random fill."""
    rng = np.random.RandomState(seed)
    corr = rng.rand(2, 3, 4, 4, 3).astype(np.float32)
    corr[0, 0, 0, 1, 1] = corr[0, 2, 3, 1, 1] = 3.0  # tie over A at B (1, 1)
    corr[0, 1, 1, 0, 0] = corr[0, 1, 1, 3, 2] = 3.0  # tie over B at A (1, 1)
    corr[1] = np.round(corr[1] * 2) / 2              # many ties everywhere
    return corr


@pytest.mark.parametrize("normalization", ["softmax", "l1", "none"])
def test_match_score_with_ties_matches_jax(normalization):
    corr = _planted_ties(0)
    weights = np.array([0.7, -1.3], np.float32)

    def jax_obj(c):
        return jnp.sum(jax_loss.match_score_per_sample(c, normalization) * weights)

    want_v, want_g = jax.value_and_grad(jax_obj)(jnp.asarray(corr))
    tc = torch.from_numpy(corr).requires_grad_(True)
    got_v = (port_loss.match_score_per_sample(tc, normalization)
             * torch.from_numpy(weights)).sum()
    got_v.backward()
    _close(got_v, want_v)
    # JAX splits a max's gradient evenly among ties; torch.amax does too
    _close(tc.grad, want_g)
    _close(port_loss.match_score(torch.from_numpy(corr), normalization),
           jax_loss.match_score(jnp.asarray(corr), normalization))


@pytest.mark.parametrize("uint8", [False, True])
def test_weak_loss_and_nc_gradients_match_jax(uint8):
    jcfg, tree, cfg, model = _port(SMALL, seed=1)
    batch = _batch(2)
    if uint8:
        batch = {k: np.clip(v * 40 + 128, 0, 255).astype(np.uint8)
                 for k, v in batch.items()}

    def f(nc):
        return jax_loss.weak_loss(dict(tree, neigh_consensus=nc), jcfg,
                                  {k: jnp.asarray(v) for k, v in batch.items()})

    want, want_g = jax.value_and_grad(f)(tree["neigh_consensus"])
    leaves = model.neigh_consensus.trainable()
    got = port_loss.weak_loss(model, cfg, _torch_batch(batch))
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)
    for g, ref in zip([t.grad for t in leaves], _nc_leaves({"neigh_consensus": want_g})):
        _close(g, ref)


def test_weak_loss_from_features_matches_weak_loss():
    _, _, cfg, model = _port(SMALL, seed=1)
    batch = _torch_batch(_batch(3))
    from ncnet_tpu_torch.models.immatchnet import extract_features

    feats = {"source_features": extract_features(model, cfg, batch["source_image"]),
             "target_features": extract_features(model, cfg, batch["target_image"])}
    assert torch.equal(port_loss.weak_loss_from_features(model, cfg, feats),
                       port_loss.weak_loss(model, cfg, batch))


@pytest.mark.parametrize(
    "override,error,item",
    [
        (dict(nc_topk=8, corr_impl="stream"), NotImplementedError, "A9"),
        (dict(refine_factor=2), NotImplementedError, "A10"),
        (dict(relocalization_k_size=2), ValueError, "relocalization"),
    ],
)
def test_weak_loss_core_raises_for_unported(override, error, item):
    _, _, cfg, model = _port(SMALL)
    f = torch.rand(2, 4, 4, 256)
    with pytest.raises(error, match=item):
        port_loss.weak_loss_core(model.neigh_consensus, cfg.replace(**override), f, f)


@pytest.mark.parametrize("kw", [dict(train_fe=True), dict(fe_finetune_blocks=1)])
def test_trunk_training_modes(kw):
    """Trunk training on patch16 (ROADMAP A6, once refused): ``train_fe``
    trains the projection with the head; patch16 has no tail units, so
    ``fe_finetune_blocks`` raises as the JAX package's unit rule does; a
    step made for another mode than the state's refuses it."""
    _, _, cfg, model = _port(SMALL)
    if "fe_finetune_blocks" in kw:
        with pytest.raises(ValueError, match="no finetune tail"):
            create_train_state(model, **kw)
        with pytest.raises(ValueError, match="no finetune tail"):
            trainable_subset(model, **kw)
        return
    before = model.feature_extraction.weight.detach().clone()
    state = create_train_state(model, LR, **kw)
    assert state.paths[-1] == ("feature_extraction", "kernel")
    with pytest.raises(ValueError, match="made for"):
        make_train_step(cfg)(state, _batch(1))
    state, loss = make_train_step(cfg, **kw)(state, _batch(1))
    assert torch.isfinite(loss)
    assert not torch.equal(model.feature_extraction.weight, before)


def test_from_features_with_trunk_training_raises():
    from ncnet_tpu_torch.train.step import check_from_features_frozen

    with pytest.raises(ValueError, match="frozen"):
        check_from_features_frozen(True, 0)
    check_from_features_frozen(False, 0)


@pytest.fixture(scope="module")
def jax_three_steps():
    """JAX's make_train_step: per-step losses, step-1 NC gradients and NC
    params after each of 3 steps (f32, patch16, 64 px, batch 4)."""
    jcfg, tree, _, _ = _port(SMALL, seed=5)
    batches = [_batch(10 + i) for i in range(3)]
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


def test_three_train_steps_match_jax(jax_three_steps):
    batches, want_grads, want_losses, want_params = jax_three_steps
    _, _, cfg, model = _port(SMALL, seed=5)
    trunk = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    state = create_train_state(model, LR)
    step = make_train_step(cfg)
    for i, b in enumerate(batches):
        state, loss = step(state, b)
        if i == 0:
            # the gradients themselves, so a wrong gradient of the right
            # sign cannot hide behind Adam's +-lr updates
            for t, ref in zip(state.optimizer.param_groups[0]["params"], want_grads):
                _close(t.grad, ref)
        assert loss.dtype == torch.float32
        _close(loss, want_losses[i])
        for got, ref in zip(_nc_leaves(model), want_params[i]):
            # Adam scales each update to about +-lr; where a parameter's
            # gradients nearly cancel across steps, m / sqrt(v) magnifies
            # their float32 differences (held to 1e-5 above), so the
            # absolute part is 1% of lr: a gradient of the wrong sign
            # would move a parameter by about 2 lr
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-2 * LR)
    assert state.step == 3
    for k, v in model.feature_extraction.state_dict().items():
        assert torch.equal(v, trunk[k]), k  # the trunk is frozen


def test_bf16_three_step_drill_f32_master_params():
    """The mixed-precision contract: 3 bfloat16 steps give finite float32
    losses; the master params and the Adam state stay float32; the NC
    params move; the trunk does not."""
    _, _, cfg, model = _port(dict(SMALL, half_precision=True), seed=3)
    before = _nc_leaves(model)
    trunk = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    state = create_train_state(model, LR)
    step = make_train_step(cfg)
    batch = _batch(3)
    for i in range(3):
        state, loss = step(state, batch)
        assert loss.dtype == torch.float32 and torch.isfinite(loss), i
    for t in state.optimizer.param_groups[0]["params"]:
        assert t.dtype == torch.float32 and t.grad.dtype == torch.float32
        st = state.optimizer.state[t]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert any(not np.allclose(a, b) for a, b in zip(before, _nc_leaves(model)))
    for k, v in model.feature_extraction.state_dict().items():
        assert torch.equal(v, trunk[k]), k


def test_eval_step_matches_weak_loss_without_gradient():
    _, _, cfg, model = _port(SMALL, seed=2)
    model.neigh_consensus.trainable()
    batch = _batch(4)
    got = make_eval_step(cfg)(model, batch)
    assert got.grad_fn is None
    assert torch.equal(got, port_loss.weak_loss(model, cfg, _torch_batch(batch)).detach())


def test_trainable_subset_and_merge_round_trip():
    _, tree, cfg, model = _port(SMALL, seed=2)
    sub = trainable_subset(model)
    assert [set(p) for p in sub["neigh_consensus"]] == [{"kernel", "bias"}] * 2
    _, tree2, _, _ = _port(SMALL, seed=7)
    merge_trainable(model, {"neigh_consensus": tree2["neigh_consensus"]})
    for got, ref in zip(_nc_leaves(model), _nc_leaves(tree2)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="NC layers"):
        merge_trainable(model, {"neigh_consensus": tree2["neigh_consensus"][:1]})


def test_to_jax_params_round_trip_and_jax_forward():
    """A head trained in the port goes back to JAX bitwise, and the JAX
    forward on it equals the port's."""
    from ncnet_tpu.models.immatchnet import immatchnet_apply as jax_apply
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply

    jcfg, tree, cfg, model = _port(SMALL, seed=4)
    state = create_train_state(model, LR)
    make_train_step(cfg)(state, _batch(5))
    back = bridge.to_jax_params(model)
    fa, fb = bridge.flatten(tree), bridge.flatten(back)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fb[k].dtype == np.float32
        if k.startswith("feature_extraction"):
            np.testing.assert_array_equal(fb[k], fa[k])
    img = _batch(6, b=1)
    want = jax_apply(back, jcfg, jnp.asarray(img["source_image"]),
                     jnp.asarray(img["target_image"]))
    with torch.no_grad():
        got = immatchnet_apply(model, cfg, torch.from_numpy(img["source_image"]),
                               torch.from_numpy(img["target_image"]))
    _close(got, want)


def test_checkpoint_round_trip(tmp_path):
    _, _, cfg, model = _port(SMALL, seed=2)
    state = create_train_state(model, LR)
    make_train_step(cfg)(state, _batch(7))
    cursor = {"epoch": 1, "batch_index": 3, "shuffle_seed": 1,
              "epoch_losses": [0.1, -2.5e-4]}
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, state, cfg, epoch=1, train_loss=[0.5],
                    val_loss=[float("nan")], cursor=cursor, is_best=True)
    assert (tmp_path / "best_c.npz").exists()
    ck = load_checkpoint(path)
    assert ck.config == cfg and ck.step == 1 and ck.epoch == 1
    assert ck.cursor == cursor and ck.train_loss == [0.5]
    assert np.isnan(ck.val_loss[0]) and ck.best_val_loss == float("inf")
    assert ck.optimizer["lr"] == LR and len(ck.opt_state) == 4
    _, _, _, other = _port(SMALL, seed=9)
    state2 = restore(create_train_state(other, LR), ck)
    for a, b in zip(_nc_leaves(model), _nc_leaves(other)):
        np.testing.assert_array_equal(a, b)
    for t1, t2 in zip(state.optimizer.param_groups[0]["params"],
                      state2.optimizer.param_groups[0]["params"]):
        s1, s2 = state.optimizer.state[t1], state2.optimizer.state[t2]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[key], s2[key]), key
    assert state2.step == 1


def test_checkpoint_rejects_other_files(tmp_path):
    path = tmp_path / "x.npz"
    np.savez(path, meta=np.asarray('{"format": "other"}'))
    with pytest.raises(ValueError, match="not a"):
        load_checkpoint(str(path))


def test_resume_two_plus_one_equals_three_bitwise(tmp_path):
    batches = [_batch(20 + i) for i in range(3)]
    _, _, cfg, straight = _port(SMALL, seed=6)
    s = create_train_state(straight, LR)
    step = make_train_step(cfg)
    want = [float(step(s, b)[1]) for b in batches]

    _, _, _, model = _port(SMALL, seed=6)
    s = create_train_state(model, LR)
    got = [float(step(s, b)[1]) for b in batches[:2]]
    path = str(tmp_path / "r.npz")
    save_checkpoint(path, s, cfg, epoch=0)
    _, _, _, fresh = _port(SMALL, seed=8)
    s2 = restore(create_train_state(fresh, LR), load_checkpoint(path))
    got.append(float(step(s2, batches[2])[1]))
    assert got == want and s2.step == 3
    for a, b in zip(_nc_leaves(fresh), _nc_leaves(straight)):
        np.testing.assert_array_equal(a, b)


def test_loop_resume_replays_the_same_batches(tmp_path):
    """`train` stopped at max_steps and resumed from its cursor checkpoint
    gives the uninterrupted run's losses and weights bitwise."""
    from ncnet_tpu_torch.data.loader import DataLoader
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset

    def loaders():
        ds = SyntheticPairDataset(n=8, output_size=(64, 64), seed=1)
        val = SyntheticPairDataset(n=4, output_size=(64, 64), seed=2)
        return (DataLoader(ds, 2, shuffle=True, seed=1, num_workers=2, drop_last=True),
                DataLoader(val, 2, num_workers=1, drop_last=True))

    _, _, cfg, straight = _port(SMALL, seed=6)
    _, h_all = train(cfg, straight, *loaders(), num_epochs=2, learning_rate=LR,
                     checkpoint_dir=str(tmp_path / "a"), log=lambda *_: None)
    _, _, _, first = _port(SMALL, seed=6)
    _, h1 = train(cfg, first, *loaders(), num_epochs=2, learning_rate=LR,
                  checkpoint_dir=str(tmp_path / "b"), max_steps=5,
                  log=lambda *_: None)
    assert h1["stopped_at_max_steps"] and len(h1["step_losses"]) == 5
    ck = load_checkpoint(str(tmp_path / "b" / "ncnet_tpu_torch.npz"))
    assert ck.cursor["epoch"] == 1 and ck.cursor["batch_index"] == 1
    _, _, _, second = _port(SMALL, seed=8)
    _, h2 = train(cfg, second, *loaders(), num_epochs=2, learning_rate=LR,
                  checkpoint_dir=str(tmp_path / "b"), resume=ck,
                  log=lambda *_: None)
    assert h1["step_losses"] + h2["step_losses"] == h_all["step_losses"]
    assert h2["train_loss"] == h_all["train_loss"]
    assert h2["val_loss"] == h_all["val_loss"]
    for a, b in zip(_nc_leaves(second), _nc_leaves(straight)):
        np.testing.assert_array_equal(a, b)
    lines = (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and (tmp_path / "a" / "best_ncnet_tpu_torch.npz").exists()


def test_device_batch_makes_float64_float32_like_jnp_asarray():
    from ncnet_tpu_torch.train.step import device_batch

    rng = np.random.RandomState(0)
    batch = {"source_image": rng.rand(1, 4, 4, 3),  # float64, as the resize
             "target_image": rng.randint(0, 255, (1, 4, 4, 3)).astype(np.uint8),
             "set_class": np.zeros(1, np.float32)}
    out = device_batch(batch, torch.device("cpu"))
    assert set(out) == {"source_image", "target_image"}
    assert out["source_image"].dtype == torch.float32
    assert out["target_image"].dtype == torch.uint8
    np.testing.assert_array_equal(out["source_image"].numpy(),
                                  np.asarray(jnp.asarray(batch["source_image"])))
