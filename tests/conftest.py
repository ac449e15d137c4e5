"""Test environment: 8 virtual CPU devices (standard way to test
pjit/shard_map sharding without a TPU pod — SURVEY.md §4)."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import re  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

# The env var JAX_PLATFORMS is ignored when a TPU plugin is present in this
# image; the config update reliably forces the CPU backend for tests.
jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def multiprocess_cpu_supported():
    """Whether THIS jaxlib can run a real multi-process CPU cluster (gloo
    collectives present and wireable). Multi-process tests skip at
    collection time when it can't, instead of failing inside a child."""
    from ncnet_tpu.parallel.mesh import multiprocess_cpu_collectives_available

    return multiprocess_cpu_collectives_available()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_cpu_cluster(script, n_procs=2, local_devices=2, timeout=280,
                      extra_env=None, per_proc_env=None, args=()):
    """Spawn ``n_procs`` child interpreters forming a 2-phase-commit-capable
    ``jax.distributed`` CPU cluster and wait for all of them.

    Each child runs ``script`` with ``JAX_PLATFORMS=cpu``,
    ``local_devices`` virtual CPU devices, and the coordinator wiring in
    ``_NCNET_MH_COORD`` / ``_NCNET_MH_PID`` / ``_NCNET_MH_NPROCS`` — the
    child is expected to call `initialize_multihost` with them (which also
    selects gloo CPU collectives). ``per_proc_env`` ({pid: {VAR: val}})
    targets one process, e.g. an ``NCNET_FAULTS`` kill drill on a single
    host. Returns ``[(returncode, combined_output), ...]`` in pid order; a
    child that outlives ``timeout`` (e.g. blocked on a barrier its killed
    peer will never reach) is killed and reports returncode None or -9.
    """
    port = free_port()
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+",
        "",
        os.environ.get("XLA_FLAGS", ""),
    ).strip()
    procs = []
    for pid in range(n_procs):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                flags
                + f" --xla_force_host_platform_device_count={local_devices}"
            ).strip(),
            _NCNET_MH_COORD=f"localhost:{port}",
            _NCNET_MH_PID=str(pid),
            _NCNET_MH_NPROCS=str(n_procs),
        )
        if extra_env:
            env.update(extra_env)
        if per_proc_env and pid in per_proc_env:
            env.update(per_proc_env[pid])
        procs.append(
            subprocess.Popen(
                [sys.executable, script, *args],
                cwd=REPO,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out = (out or "") + "\n[spawn_cpu_cluster] child timed out"
        results.append((p.returncode, out))
    return results


@pytest.fixture(scope="session")
def uninterrupted_run(tmp_path_factory):
    """ONE uninterrupted run of the kill-drill training schedule, shared
    session-wide (the tier-1 suite-budget lever, PR 17): before it,
    tests/test_resilience.py and tests/test_distributed_ckpt.py each
    paid this IDENTICAL 2-epoch compile+train in their own module-scoped
    fixture. Schedule and seeds are pinned here; both modules' ``_run``
    helpers must keep matching them (their bitwise comparisons fail
    loudly on drift). Saves use the sharded (distributed_checkpoints)
    format — the richer artifact: the distributed tests inspect the
    save directories, while the resilience tests compare only loaded
    VALUES, which test_sharded_training_matches_legacy_bitwise pins as
    bitwise-equal across formats.

    Returns ``(ck, metrics_lines, ckdir)``.
    """
    import json

    from ncnet_tpu.data.loader import DataLoader
    from ncnet_tpu.data.pairs import SyntheticPairDataset
    from ncnet_tpu.models.immatchnet import (
        ImMatchNetConfig,
        init_immatchnet,
    )
    from ncnet_tpu.train.checkpoint import load_latest_valid_any
    from ncnet_tpu.train.loop import train

    cfg = ImMatchNetConfig(ncons_kernel_sizes=(3,), ncons_channels=(1,))
    ds = SyntheticPairDataset(n=8, output_size=(32, 32), seed=11)
    loader = DataLoader(
        ds, 2, shuffle=True, seed=5, drop_last=True,
        num_workers=1, prefetch=0,
    )
    params = init_immatchnet(jax.random.PRNGKey(0), cfg)
    ckdir = tmp_path_factory.mktemp("uninterrupted_shared")
    train(
        cfg, params, loader, None,
        num_epochs=2, checkpoint_dir=str(ckdir), data_parallel=False,
        log_every=100, save_every_steps=2, keep_checkpoints=4,
        distributed_checkpoints=True,
    )
    ck, _ = load_latest_valid_any(
        os.path.join(str(ckdir), "ncnet_tpu.msgpack")
    )
    lines = [
        json.loads(line)
        for line in open(os.path.join(str(ckdir), "metrics.jsonl"))
    ]
    return ck, lines, ckdir


@pytest.fixture(scope="session")
def legacy_format_run(tmp_path_factory):
    """ONE legacy-format (monolithic msgpack) run of the SAME pinned
    schedule as `uninterrupted_run`, shared session-wide (the tier-1
    budget lever, PR 18): the save-format parity drill
    (tests/test_distributed_ckpt.py::
    test_sharded_training_matches_legacy_bitwise) compares the two
    fixtures instead of paying its own 2-epoch legacy training arm.
    Schedule and seeds MUST stay identical to `uninterrupted_run` above
    — the bitwise comparison fails loudly on drift, so the drill is not
    weakened, only de-duplicated.

    Returns ``(ck, metrics_lines, ckdir)`` with ``ck`` read through the
    legacy single-file loader (the format under test).
    """
    import json

    from ncnet_tpu.data.loader import DataLoader
    from ncnet_tpu.data.pairs import SyntheticPairDataset
    from ncnet_tpu.models.immatchnet import (
        ImMatchNetConfig,
        init_immatchnet,
    )
    from ncnet_tpu.train.checkpoint import load_checkpoint
    from ncnet_tpu.train.loop import train

    cfg = ImMatchNetConfig(ncons_kernel_sizes=(3,), ncons_channels=(1,))
    ds = SyntheticPairDataset(n=8, output_size=(32, 32), seed=11)
    loader = DataLoader(
        ds, 2, shuffle=True, seed=5, drop_last=True,
        num_workers=1, prefetch=0,
    )
    params = init_immatchnet(jax.random.PRNGKey(0), cfg)
    ckdir = tmp_path_factory.mktemp("legacy_shared")
    train(
        cfg, params, loader, None,
        num_epochs=2, checkpoint_dir=str(ckdir), data_parallel=False,
        log_every=100, save_every_steps=2, keep_checkpoints=4,
        distributed_checkpoints=False,
    )
    ck = load_checkpoint(os.path.join(str(ckdir), "ncnet_tpu.msgpack"))
    lines = [
        json.loads(line)
        for line in open(os.path.join(str(ckdir), "metrics.jsonl"))
    ]
    return ck, lines, ckdir


@pytest.fixture(scope="session")
def multihost_oracle_loss():
    """The single-process reference arm of the 2-process cluster drill
    (tests/test_multihost.py), shared session-wide (the tier-1 budget
    lever, PR 18): one data-parallel train step of the PINNED multihost
    geometry — config ``(3, 3)/(4, 1)``, the seed-7 global batch of four
    32x32 pairs, ``PRNGKey(0)`` init — on a 4-device mesh in THIS
    process. The constants here must stay identical to the child script
    in tests/test_multihost.py; the drill's allclose against the
    cluster's psum-reduced loss fails loudly on drift.

    Returns the oracle loss as a Python float.
    """
    import numpy as np

    from ncnet_tpu.models.immatchnet import (
        ImMatchNetConfig,
        init_immatchnet,
    )
    from ncnet_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from ncnet_tpu.train.step import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    grid_devices, image = 4, 32  # 2 processes x 2 local devices
    config = ImMatchNetConfig(
        ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1)
    )
    rng = np.random.RandomState(7)
    batch_np = {
        "source_image": rng.randn(grid_devices, image, image, 3).astype(
            np.float32
        ),
        "target_image": rng.randn(grid_devices, image, image, 3).astype(
            np.float32
        ),
    }
    mesh = make_mesh(devices=jax.devices()[:grid_devices])
    params = init_immatchnet(jax.random.PRNGKey(0), config)
    optimizer = make_optimizer()
    state = create_train_state(replicate(mesh, params), optimizer)
    state = state._replace(opt_state=replicate(mesh, state.opt_state))
    batch = shard_batch(mesh, batch_np)
    _, loss = make_train_step(config, optimizer, donate=False)(state, batch)
    return float(loss)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand kernels); skips "
        "with a reason where there is none",
    )
