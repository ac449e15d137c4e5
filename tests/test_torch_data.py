"""The port's training data and CLI against the JAX package on the CPU:
the synthetic and CSV pair datasets (bitwise), the loader's batch order,
its retries, skip budget, host shards and process backend, and ``python
-m ncnet_tpu_torch.train`` at toy size."""

import json
import os

import numpy as np
import pytest
import torch

from ncnet_tpu.data import loader as jax_loader
from ncnet_tpu.data.loader import DataLoader as JaxDataLoader
from ncnet_tpu.data.pairs import ImagePairDataset as JaxImagePairDataset
from ncnet_tpu.data.pairs import SyntheticPairDataset as JaxSyntheticPairDataset
from ncnet_tpu_torch.data import loader as port_loader
from ncnet_tpu_torch.data.loader import DataLoader, collate
from ncnet_tpu_torch.data.pairs import ImagePairDataset, SyntheticPairDataset
from ncnet_tpu_torch.train.__main__ import main as train_main
from ncnet_tpu_torch.train.checkpoint import load_checkpoint


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


def _assert_same_sample(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("size,seed,granularity",
                         [((64, 64), 1, 8), ((400, 400), 3, 8), ((48, 80), 0, 32)])
def test_synthetic_pairs_bitwise_equal_to_jax(size, seed, granularity):
    kw = dict(n=5, output_size=size, seed=seed, return_shift=True,
              granularity=granularity)
    ours, theirs = SyntheticPairDataset(**kw), JaxSyntheticPairDataset(**kw)
    assert len(ours) == len(theirs) == 5
    for idx in (0, 4):
        _assert_same_sample(ours[idx], theirs[idx])


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(0)
    for name, shape in (("a.png", (50, 40, 3)), ("b.png", (37, 61, 3)),
                        ("c.png", (44, 44))):
        Image.fromarray(rng.randint(0, 255, shape, np.uint8)).save(root / name)
    (root / "pairs.csv").write_text(
        "source_image,target_image,class,flip\n"
        "a.png,b.png,1,0\nb.png,c.png,3,1\nc.png,a.png,2,0\n")
    return root


@pytest.mark.parametrize("kw", [
    dict(),
    dict(random_crop=True, seed=4),
    dict(uint8_output=True),
    dict(normalize=False, output_size=(24, 40)),
])
def test_image_pairs_equal_to_jax(pair_files, kw):
    kw = dict(dict(output_size=(32, 32)), **kw)
    args = (str(pair_files / "pairs.csv"), str(pair_files))
    ours, theirs = ImagePairDataset(*args, **kw), JaxImagePairDataset(*args, **kw)
    assert len(ours) == len(theirs) == 3
    for idx in range(3):
        _assert_same_sample(ours[idx], theirs[idx])


class _Indexed:
    """A dataset whose samples name their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {"idx": np.int64(idx), "x": np.full((2,), idx, np.float32)}


@pytest.mark.parametrize("shuffle,drop_last,batch,seed",
                         [(True, True, 3, 1), (True, False, 4, 7), (False, True, 5, 0)])
def test_loader_batch_order_equals_jax(shuffle, drop_last, batch, seed):
    ds = _Indexed(17)
    kw = dict(shuffle=shuffle, seed=seed, num_workers=3, drop_last=drop_last)
    ours = DataLoader(ds, batch, **kw)
    theirs = JaxDataLoader(ds, batch, **kw)
    assert len(ours) == len(theirs)
    for epoch in (0, 2):
        for skip in (0, 1):
            got = [b["idx"].tolist() for b in ours.iter_epoch(epoch, skip)]
            want = [b["idx"].tolist() for b in theirs.iter_epoch(epoch, skip)]
            assert got == want and got
    # auto-advancing iteration walks epochs 0, 1, ...
    assert [b["idx"].tolist() for b in ours] == \
        [b["idx"].tolist() for b in theirs.iter_epoch(0)]


def test_loader_surfaces_worker_errors():
    class Broken(_Indexed):
        def __getitem__(self, idx):
            if idx == 5:
                raise OSError("unreadable sample")
            return super().__getitem__(idx)

    with pytest.raises(RuntimeError, match="unreadable sample"):
        list(DataLoader(Broken(8), 2, num_workers=2).iter_epoch(0))


def test_collate_stacks_and_keeps_dtypes():
    out = collate([_Indexed(3)[i] for i in range(3)])
    assert out["idx"].dtype == np.int64 and out["x"].shape == (3, 2)
    np.testing.assert_array_equal(out["idx"], [0, 1, 2])


TOY = ["--synthetic", "--allow_random_fe", "--device", "cpu", "--fe_arch",
       "patch16", "--image_size", "64", "--ncons_kernel_sizes", "3", "3",
       "--ncons_channels", "4", "1", "--batch_size", "2", "--synthetic_pairs",
       "8", "--num_workers", "2", "--lr", "1e-3"]


def test_cli_trains_at_toy_size_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "run")
    report = train_main(TOY + ["--num_epochs", "2", "--result_model_dir", out,
                               "--max-steps", "3"])
    assert report["steps"] == 3 and report["stopped_at_max_steps"]
    assert all(np.isfinite(report["step_losses"]))
    assert report["kernel_launches"] == {  # CPU: plain versions
        "conv4d_fwd": 0, "conv4d_dx": 0, "conv4d_dw": 0, "band_gemm_fwd": 0,
        "band_gemm_dx": 0, "band_gemm_dw": 0}
    assert report["config"]["half_precision"] is True  # --bf16 by default
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["steps"] == 3
    ck = load_checkpoint(report["checkpoint"])
    assert ck.step == 3 and ck.cursor == {
        "epoch": 0, "batch_index": 3, "shuffle_seed": 1,
        "epoch_losses": report["step_losses"]}
    # resume: the rest of the two epochs (4 steps each)
    report2 = train_main(TOY + ["--num_epochs", "2", "--result_model_dir", out,
                                "--checkpoint", report["checkpoint"]])
    assert report2["steps"] == 8 and report2["steps_this_run"] == 5
    assert len(report2["train_loss"]) == 2 and len(report2["val_loss"]) == 2
    assert os.path.exists(os.path.join(out, "best_ncnet_tpu_torch.npz"))
    assert len(open(os.path.join(out, "metrics.jsonl")).read().splitlines()) == 2


def test_cli_refuses_a_random_trunk_unless_asked(capsys):
    with pytest.raises(SystemExit):
        train_main(["--device", "cpu"])
    assert "no pretrained trunk" in capsys.readouterr().err


class _Flaky:
    """Index ``i`` fails its first ``fails.get(i, 0)`` reads (a flaky
    mount), and the ``bad`` indices always (bitrot). Module-level: the
    process backend's spawned workers pickle it."""

    def __init__(self, n=8, fails=None, bad=()):
        self.n, self.fails, self.bad = n, dict(fails or {}), set(bad)
        self.reads = {}

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        self.reads[idx] = self.reads.get(idx, 0) + 1
        if idx in self.bad or self.reads[idx] <= self.fails.get(idx, 0):
            raise OSError(f"read failure on {idx}")
        return {"x": np.full((2,), float(idx), np.float32)}


@pytest.mark.parametrize("retries,fails", [(0, 0), (2, 2), (2, 3), (1, 0)])
def test_retry_call_equals_jax(retries, fails):
    outcomes = []
    for mod in (port_loader, jax_loader):
        ds = _Flaky(fails={0: fails})
        try:
            got = mod.retry_call(lambda: ds[0], retries, 0.0)["x"].tolist()
        except OSError as e:
            got = str(e)
        outcomes.append((got, ds.reads[0]))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("bad,budget", [((2,), 2), ((2, 3), 2), ((2, 6), 1),
                                        ((7,), 1), ((), 0)])
def test_build_batch_skip_budget_equals_jax(bad, budget):
    """A corrupt sample is replaced by the next loadable index (wrapping),
    past the budget the sample's error propagates: the JAX loader's rule."""
    for idx in ([1, 2, 3], [6, 7], [2]):
        outcomes = []
        for mod in (port_loader, jax_loader):
            try:
                batch, skipped = mod.build_batch(_Flaky(bad=bad), idx, 0, 0.0, budget)
                outcomes.append((batch["x"].tolist(), skipped))
            except OSError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("n,hosts", [(10, 2), (17, 3), (5, 5), (4, 1)])
def test_shard_indices_equal_jax(n, hosts):
    for host in range(hosts):
        np.testing.assert_array_equal(port_loader.shard_indices(n, host, hosts),
                                      jax_loader.shard_indices(n, host, hosts))


def test_loader_skip_budget_and_sharding_equal_jax():
    kw = dict(num_workers=2, sample_retries=0, skip_budget=2, shuffle=True, seed=5,
              host_id=1, n_hosts=2)
    ours = DataLoader(_Flaky(16, bad=(9, 12)), 3, **kw)
    theirs = JaxDataLoader(_Flaky(16, bad=(9, 12)), 3, **kw)
    got = [b["x"][:, 0].tolist() for b in ours.iter_epoch(1)]
    assert got == [b["x"][:, 0].tolist() for b in theirs.iter_epoch(1)]
    assert sorted(ours.skipped) == sorted(theirs.skipped) == [9, 12]
    with pytest.raises(RuntimeError, match="skip budget exhausted"):
        list(DataLoader(_Flaky(8, bad=(2, 5)), 2, num_workers=1, sample_retries=0,
                        skip_budget=1))


def test_process_backend_batches_bitwise_the_thread_backends():
    ds = SyntheticPairDataset(n=6, output_size=(32, 32), seed=2)
    thread = DataLoader(ds, 2, shuffle=True, seed=3, num_workers=2)
    with DataLoader(ds, 2, shuffle=True, seed=3, num_workers=2,
                    backend="process") as proc:
        for epoch in (0, 1):  # the pool is reused
            bt, bp = list(thread.iter_epoch(epoch)), list(proc.iter_epoch(epoch))
            assert len(bt) == len(bp) == 3
            for a, b in zip(bt, bp):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    assert proc._pool is None  # the context manager shut the pool down
    # a failing sample surfaces through the pool with its message
    with DataLoader(_Flaky(4, bad=(2,)), 2, num_workers=1, backend="process",
                    sample_retries=0) as broken:
        with pytest.raises(RuntimeError, match="read failure on 2"):
            list(broken.iter_epoch(0))
    with pytest.raises(ValueError, match="unknown loader backend"):
        DataLoader(ds, 2, backend="fiber")
