"""The port stands alone: importing it loads neither JAX nor the JAX
package, no file of it (or chip_smoke.py) imports them (the feature cache,
the durable writes and the loaders among them), and its entry points
refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ncnet_tpu_torch")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or name == "ncnet_tpu" \
        or name.startswith("ncnet_tpu.")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ncnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "ncnet_tpu_torch.__path__, 'ncnet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'ncnet_tpu' or "
        "m.startswith('ncnet_tpu.'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def _entry_points():
    from ncnet_tpu_torch import bridge
    from ncnet_tpu_torch.eval.inloc import main as inloc_main
    from ncnet_tpu_torch.eval.pf_pascal import main as pf_pascal_main
    from ncnet_tpu_torch.eval.synthetic import main as synthetic_main
    from ncnet_tpu_torch.features.__main__ import main as features_main
    from ncnet_tpu_torch.models.densenet import DenseNet201Trunk
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.models.neigh_consensus import NeighConsensus
    from ncnet_tpu_torch.models.patch import PatchTrunk
    from ncnet_tpu_torch.models.resnet import ResNet101Trunk
    from ncnet_tpu_torch.models.vgg import VGG16Trunk
    from ncnet_tpu_torch.serve.__main__ import main as serve_main
    from ncnet_tpu_torch.serve.engine import ServeEngine
    from ncnet_tpu_torch.train.__main__ import main as train_main

    small = ImMatchNetConfig(feature_extraction_cnn="patch16",
                             ncons_kernel_sizes=(3,), ncons_channels=(1,))
    return {
        "ImMatchNet": lambda: ImMatchNet(small),
        "NeighConsensus": lambda: NeighConsensus((3,), (1,)),
        "PatchTrunk": PatchTrunk,
        "ResNet101Trunk": ResNet101Trunk,
        "VGG16Trunk": VGG16Trunk,
        "DenseNet201Trunk": DenseNet201Trunk,
        "ImMatchNet(vgg)": lambda: ImMatchNet(small.replace(feature_extraction_cnn="vgg")),
        "ServeEngine": lambda: ServeEngine(lambda m, b: b, None),
        "bridge.from_jax_params": lambda: bridge.from_jax_params({}, small),
        "python -m ncnet_tpu_torch.serve": lambda: serve_main(
            ["--synthetic", "1", "--cnn", "patch16"]),
        "python -m ncnet_tpu_torch.serve --degrade": lambda: serve_main(
            ["--synthetic", "1", "--cnn", "patch16", "--degrade", "16"]),
        "ImMatchNet(nc_topk)": lambda: ImMatchNet(small.replace(nc_topk=16)),
        "python -m ncnet_tpu_torch.train": lambda: train_main(
            ["--synthetic", "--allow_random_fe", "--fe_arch", "patch16"]),
        "python -m ncnet_tpu_torch.train --fe_finetune_params": lambda: train_main(
            ["--synthetic", "--allow_random_fe", "--fe_arch", "densenet201",
             "--fe_finetune_params", "1"]),
        "python -m ncnet_tpu_torch.eval.pf_pascal": lambda: pf_pascal_main(
            ["--checkpoint", "head.npz"]),
        "python -m ncnet_tpu_torch.eval.synthetic": lambda: synthetic_main(
            ["--steps", "1"]),
        "python -m ncnet_tpu_torch.eval.inloc": lambda: inloc_main(
            ["--checkpoint", "head.npz"]),
        "python -m ncnet_tpu_torch.features": lambda: features_main(
            ["--feature-cache", "cache", "--synthetic"]),
        "python -m ncnet_tpu_torch.serve --checkpoint": lambda: serve_main(
            ["--synthetic", "1", "--checkpoint", "head.npz"]),
        "python -m ncnet_tpu_torch.train --feature-cache": lambda: train_main(
            ["--synthetic", "--allow_random_fe", "--fe_arch", "patch16",
             "--feature-cache", "cache"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


@pytest.mark.parametrize("entry", ["train.loop.train", "make_train_step"])
def test_trainer_follows_the_model_device(entry, tmp_path):
    """The trainer takes no device of its own: it runs where the model
    lives, so a model built on the CPU trains there without touching CUDA
    (on a default-device model it is `ImMatchNet` that raises, above)."""
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.train.loop import train
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    config = ImMatchNetConfig(feature_extraction_cnn="patch16",
                              ncons_kernel_sizes=(3,), ncons_channels=(1,),
                              half_precision=False)
    model = ImMatchNet(config, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {k: rng.randn(2, 32, 32, 3).astype(np.float32)
             for k in ("source_image", "target_image")}
    before = [t.detach().clone() for t in model.neigh_consensus.trainable()]
    if entry == "make_train_step":
        state, loss = make_train_step(config)(create_train_state(model), batch)
    else:
        state, history = train(config, model, [batch], num_epochs=1,
                               checkpoint_dir=str(tmp_path), log=lambda *a: None)
        loss = torch.tensor(history["step_losses"][-1])
    after = model.neigh_consensus.trainable()
    assert state.step == 1 and bool(torch.isfinite(loss))
    assert loss.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    assert not torch.cuda.is_initialized()
