"""Trunk fine-tuning and the JAX package's msgpack checkpoints, against the
JAX package on the CPU.

Three Adam steps with ``fe_finetune_blocks=1`` (ResNet-101's last layer3
bottleneck and the NC head; dense, and on a K = 4 band) from one JAX init.
Each step is taken from JAX's state before it, written by the JAX
package's ``save_checkpoint`` and read back by the port's msgpack reader,
so every step's parameters, BN ``mean`` and ``var`` included, are held
against JAX's next state, and the reader is held on the way.

Tolerances, and why not float32's rtol 1e-5 / atol 1e-6: the weak loss of
a random ResNet-101 on noise images is a 1e-3 difference of match scores
near 3e-2, through 104 float32 convolutions whose sums the two libraries
order differently; JAX's own jitted and eager steps disagree by 3e-5 of
the loss here. So a step's loss is held to rtol 1e-4 (1e-3 once the free
run's parameters have parted, below), its gradients to 1e-3 of each
tensor's scale. A ReLU input within float error of zero may be masked on
one side and not on the other, which moves a unit's gradient by one
position's term (seen: 15-22% of the scale of the first conv's and BN
offset's gradients on 0.2% of their elements, band step 2); so at most
1% of a tensor's elements may miss the gradient bound. Adam turns a
gradient into an update of about lr (``g / (|g| + eps)``): an element
whose gradient is within that error of zero may move by up to 2 lr either
way, so after a step the parameters are held to 0.1 lr on all but 1% of
each tensor's elements, and to 2 lr everywhere (a gradient of the wrong
sign moves a parameter by about 2 lr).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import immatchnet_apply as jax_apply
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.train import checkpoint as jax_checkpoint
from ncnet_tpu.train import step as jax_step
from ncnet_tpu_torch import bridge, convert
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig, immatchnet_apply
from ncnet_tpu_torch.train.checkpoint import load_checkpoint, restore
from ncnet_tpu_torch.train.jax_checkpoint import IntegrityError, unpackb
from ncnet_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
    trainable_subset,
)

LR = 1e-3
LOSS_RTOL = 1e-4
FREE_LOSS_RTOL = 1e-3  # steps 2 and 3 of the free run
GRAD_ATOL = 1e-3  # of each tensor's scale
PARAM_ATOL = 0.1 * LR
MISS_FRACTION = 0.01  # of a tensor's elements (ReLU masks at zero)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config(nc_topk):
    # centred features and the identity NC init keep the weak loss of a
    # random trunk off zero (eval/synthetic.py's reasoning)
    return JaxConfig(feature_extraction_cnn="resnet101", ncons_kernel_sizes=(3, 3),
                     ncons_channels=(4, 1), half_precision=False,
                     center_features=True, nc_init="identity", nc_topk=nc_topk)


def _batches(seed):
    """Three batches of 2 noise pairs at 64 px, each target its source
    with a little noise (so the positives score above the negatives)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        a = rng.randn(2, 64, 64, 3).astype(np.float32)
        out.append({"source_image": a,
                    "target_image": (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)})
    return out


@pytest.fixture(scope="module", params=[0, 4], ids=["dense", "band"])
def jax_run(request, tmp_path_factory):
    """JAX's make_train_step over 3 batches from one init: the states
    before and after each step (msgpack files) and the losses."""
    jcfg = _config(request.param)
    tree = jax.tree.map(np.asarray, jax.jit(init_immatchnet, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    opt = jax_step.make_optimizer(LR)
    state = jax_step.create_train_state(jax.tree.map(jnp.asarray, tree), opt,
                                        fe_finetune_blocks=1)
    step = jax_step.make_train_step(jcfg, opt, donate=False, fe_finetune_blocks=1)
    root = tmp_path_factory.mktemp("jax_ckpt")
    batches = _batches(1)
    paths, losses, subsets = [], [], []

    def save(k, st):
        path = str(root / f"step{k}.msgpack")
        jax_checkpoint.save_checkpoint(path, jax_checkpoint.CheckpointData(
            config=jcfg, params=st.params, opt_state=st.opt_state, step=int(st.step),
            epoch=0, train_fe=False, fe_finetune_blocks=1,
            cursor={"epoch": 0, "batch_index": k, "shuffle_seed": 3,
                    "epoch_losses": list(losses)}), keep=1)
        paths.append(path)
        subsets.append(bridge.flatten(jax_step.trainable_subset(
            jax.tree.map(np.asarray, st.params), fe_finetune_blocks=1)))

    save(0, state)
    for k, b in enumerate(batches):
        state, loss = step(state, {n: jnp.asarray(v) for n, v in b.items()})
        losses.append(float(loss))
        save(k + 1, state)
    mus = [bridge.flatten(jax.tree.map(np.asarray, state_mu(p))) for p in paths]
    # each step's gradient from Adam's first moment: mu' = 0.9 mu + 0.1 g
    grads = [{k: (after[k] - 0.9 * before[k]) / 0.1 for k in after}
             for before, after in zip(mus, mus[1:])]
    return dict(jcfg=jcfg, tree=tree, batches=batches, paths=paths, losses=losses,
                subsets=subsets, grads=grads)


def state_mu(path):
    """Adam's first moment of a JAX checkpoint (JAX's own reader)."""
    ck = jax_checkpoint.load_checkpoint(path)
    return jax_checkpoint._relistify(ck.opt_state["0"]["mu"])


def _port_model(run):
    cfg = ImMatchNetConfig.from_dict(run["jcfg"].to_dict())
    return cfg, bridge.from_jax_params(run["tree"], cfg, device="cpu")


def _close_tree(got, want, atol_of, bound_of=None):
    """Every tensor within ``atol_of(want)`` on all but MISS_FRACTION of its
    elements, and within ``bound_of(want)`` (if given) on all of them."""
    assert got.keys() == want.keys()
    for k in want:
        d = np.abs(np.asarray(got[k]) - np.asarray(want[k]))
        miss = float((d > atol_of(want[k])).mean())
        assert miss <= MISS_FRACTION, (k, miss, float(d.max()))
        if bound_of is not None:
            assert float(d.max()) <= bound_of(want[k]), (k, float(d.max()))


def _grads(state):
    """The trainable tensors' gradients in the JAX layout, by path."""
    return {"/".join(map(str, p)): bridge.to_jax_layout(t.grad.numpy())
            if p[0] != "neigh_consensus" else t.grad.numpy()
            for p, t in zip(state.paths, state.optimizer.param_groups[0]["params"])}


def test_finetune_three_steps_match_jax(jax_run):
    """Free-running: the port's 3 steps from the init, its losses and its
    first gradients (every trainable tensor) against JAX's."""
    cfg, model = _port_model(jax_run)
    state = create_train_state(model, LR, fe_finetune_blocks=1)
    step = make_train_step(cfg, fe_finetune_blocks=1)
    assert [p[0] for p in state.paths].count("fe_tail") == 15  # 3 convs, 3 BN x 4
    trunk0 = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    for k, b in enumerate(jax_run["batches"]):
        state, loss = step(state, b)
        np.testing.assert_allclose(float(loss), jax_run["losses"][k],
                                   rtol=LOSS_RTOL if k == 0 else FREE_LOSS_RTOL)
        if k == 0:
            _close_tree(_grads(state), jax_run["grads"][0],
                        lambda w: GRAD_ATOL * float(np.abs(w).max()))
    assert state.step == 3
    # the tail unit moved, BN statistics included; the rest of the trunk did not
    for name, v in model.feature_extraction.state_dict().items():
        if name.startswith("layer3.22."):
            assert not torch.equal(v, trunk0[name]), name
        else:
            assert torch.equal(v, trunk0[name]), name


@pytest.mark.parametrize("k", [0, 1, 2])
def test_finetune_step_resumed_from_jax_checkpoint_matches_jax(jax_run, k):
    """Each step from JAX's state before it (its msgpack through the port's
    reader): the loss and every trainable tensor after the step against
    JAX's next state."""
    cfg, model = _port_model(jax_run)
    ck = load_checkpoint(jax_run["paths"][k])
    assert (ck.train_fe, ck.fe_finetune_blocks, ck.step) == (False, 1, k)
    assert ck.cursor["batch_index"] == k and ck.cursor["shuffle_seed"] == 3
    assert ck.cursor["epoch_losses"] == jax_run["losses"][:k]
    state = restore(create_train_state(model, LR, fe_finetune_blocks=1), ck)
    state, loss = make_train_step(cfg, fe_finetune_blocks=1)(state, jax_run["batches"][k])
    np.testing.assert_allclose(float(loss), jax_run["losses"][k], rtol=LOSS_RTOL)
    _close_tree(_grads(state), jax_run["grads"][k],
                lambda w: GRAD_ATOL * float(np.abs(w).max()))
    got = bridge.flatten(trainable_subset(model, fe_finetune_blocks=1))
    _close_tree(got, jax_run["subsets"][k + 1], lambda w: PARAM_ATOL,
                lambda w: 2 * LR)
    assert state.step == k + 1


# the dense run's checkpoints serve the next two tests: the band run's
# hold the same tree and reader paths
@pytest.mark.parametrize("jax_run", [0], indirect=True, ids=["dense"])
def test_jax_checkpoint_forward_matches_jax(jax_run):
    """``load_model`` on a JAX-written ``.msgpack``: the fine-tuned weights
    and the forward."""
    path = jax_run["paths"][-1]
    config, model = convert.load_model(path, device="cpu")
    assert config.to_dict() == jax_run["jcfg"].to_dict()
    jck = jax_checkpoint.load_checkpoint(path)
    fj, fp = bridge.flatten(jck.params), bridge.flatten(bridge.to_jax_params(model))
    assert fj.keys() == fp.keys()
    for key in fj:
        np.testing.assert_array_equal(fp[key], np.asarray(fj[key]), err_msg=key)
    x = jax_run["batches"][0]["source_image"][:1]
    y = jax_run["batches"][0]["target_image"][:1]
    want = np.asarray(jax_apply(jck.params, jck.config, jnp.asarray(x), jnp.asarray(y)))
    with torch.inference_mode():
        got = immatchnet_apply(model, config, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_msgpack_reader_decodes_flax(tmp_path):
    """The reader against flax's own encoder: every type the payload uses,
    bfloat16 and scalar ext records, chunked arrays, and the digest."""
    from flax import serialization

    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.int32(7), np.float64(-2.5), True, None, "txt", b"raw"],
            "c": {"0": np.ones((3,), jnp.bfloat16), "big": -(2 ** 40), "n": -3,
                  "f": 0.25, "u": 2 ** 63 + 5},
            "e": np.zeros((0, 4), np.int64)}
    got = unpackb(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["b"][:1] == [7] and got["b"][1:] == [-2.5, True, None, "txt", b"raw"]
    assert got["c"]["0"].dtype == np.float32 and (got["c"]["0"] == 1).all()
    assert (got["c"]["big"], got["c"]["n"], got["c"]["f"], got["c"]["u"]) == (
        -(2 ** 40), -3, 0.25, 2 ** 63 + 5)
    assert got["e"].shape == (0, 4)
    # an array past flax's chunk size comes back whole
    from ncnet_tpu_torch.train import jax_checkpoint as reader

    old = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 64
    try:
        blob = serialization.msgpack_serialize({"w": np.arange(100, dtype=np.float32)})
    finally:
        serialization.MAX_CHUNK_SIZE = old
    path = str(tmp_path / "x.msgpack")
    with open(path, "wb") as f:
        f.write(blob)
    np.testing.assert_array_equal(reader.read_payload(path)["w"], np.arange(100))
    with open(path + ".sha256", "w") as f:
        f.write("0" * 64)
    with pytest.raises(IntegrityError):
        reader.read_payload(path)


@pytest.mark.parametrize("jax_run", [0], indirect=True, ids=["dense"])
def test_train_cli_finetune_and_resume_from_msgpack(jax_run, tmp_path, capsys):
    """``--fe_finetune_params 1`` and ``--fe_arch vgg`` at toy size, and a
    resume from a JAX ``.msgpack`` that keeps its trunk-training mode."""
    from ncnet_tpu_torch.train.__main__ import main

    base = ["--synthetic", "--allow_random_fe", "--device", "cpu",
            "--image_size", "64", "--ncons_kernel_sizes", "3", "3",
            "--ncons_channels", "4", "1", "--batch_size", "2",
            "--synthetic_pairs", "4", "--num_epochs", "1", "--num_workers", "1",
            "--no-bf16"]
    for extra in (["--fe_finetune_params", "1"], ["--fe_arch", "vgg",
                                                 "--fe_finetune_params", "2"]):
        out = str(tmp_path / extra[1])
        report = main(base + extra + ["--result_model_dir", out])
        assert report["fe_finetune_blocks"] == int(extra[-1]) and report["steps"] == 2
        assert all(np.isfinite(report["step_losses"]))
        ck = load_checkpoint(os.path.join(out, "ncnet_tpu_torch.npz"))
        assert (ck.train_fe, ck.fe_finetune_blocks) == (False, int(extra[-1]))
    resumed = main(base + ["--checkpoint", jax_run["paths"][1], "--max-steps", "3",
                           "--num_epochs", "2",
                           "--result_model_dir", str(tmp_path / "resumed")])
    assert resumed["fe_finetune_blocks"] == 1 and resumed["steps"] == 3
    assert resumed["config"]["nc_topk"] == jax_run["jcfg"].nc_topk
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["steps"] == 3
    assert any("resuming from" in line for line in lines)
    with pytest.raises(SystemExit):
        main(base + ["--fe_finetune_params", "1", "--feature-cache", str(tmp_path)])
