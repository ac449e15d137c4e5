"""The port's sparse top-K band path against the JAX package: the band NC
stack, `immatchnet_apply` with ``nc_topk > 0``, the full-K == dense
contract, the config checks, the hysteresis controller, and the
ServeEngine with a dense standard and a band degraded program. Weights
are made by the JAX init functions and reach the port through
`ncnet_tpu_torch.bridge`; inputs are numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import immatchnet_apply as jax_immatchnet_apply
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.models.neigh_consensus import init_neigh_consensus
from ncnet_tpu.ops.band import topk_band as jax_topk_band
from ncnet_tpu.sparse.nc import sparse_neigh_consensus_apply as jax_sparse_nc
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.models.immatchnet import (
    ImMatchNet,
    ImMatchNetConfig,
    immatchnet_apply,
)
from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
from ncnet_tpu_torch.serve.resilience import HysteresisController
from ncnet_tpu_torch.serve.step import make_serve_match_step
from ncnet_tpu_torch.sparse import sparse_neigh_consensus_apply

# float32, the issue's starting tolerance
RTOL, ATOL = 1e-5, 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))
SQUARE = ((64, 64), (64, 64))
RECT = ((64, 64), (48, 64))


def _nc_params(seed, kernel_sizes=(3, 3), channels=(4, 1)):
    jp = jax.tree.map(np.asarray, init_neigh_consensus(
        jax.random.PRNGKey(seed), kernel_sizes, channels))
    tp = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
          for layer in jp]
    return jp, tp


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("grids", [(4, 4, 4, 4), (3, 5, 4, 3)])
def test_sparse_nc_matches_jax(grids, symmetric):
    ha, wa, hb, wb = grids
    rng = np.random.RandomState(0)
    scores = rng.randn(2, ha, wa, hb, wb).astype(np.float32)
    values, indices = jax_topk_band(jnp.asarray(scores), 5, mutual=True)
    values, idx = np.array(values), np.array(indices)
    jp, tp = _nc_params(1)
    want = jax_sparse_nc(jp, jnp.asarray(values), jnp.asarray(idx), (hb, wb),
                         symmetric=symmetric, band_impl="xla")
    got = sparse_neigh_consensus_apply(
        tp, torch.from_numpy(values), torch.from_numpy(idx), (hb, wb),
        symmetric=symmetric,
    )
    assert got.shape == values.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # 'pallas' names the other JAX backend: the same function here
    again = sparse_neigh_consensus_apply(
        tp, torch.from_numpy(values), torch.from_numpy(idx), (hb, wb),
        symmetric=symmetric, band_impl="pallas",
    )
    assert torch.equal(again, got)


def test_sparse_nc_rejects_bad_impl_and_multichannel_last_layer():
    values = torch.rand(1, 3, 3, 4)
    indices = torch.sort(torch.randperm(9)[:4]).values.to(torch.int32)
    indices = indices.expand(1, 3, 3, 4).contiguous()
    _, tp = _nc_params(2)
    with pytest.raises(ValueError, match="band_impl"):
        sparse_neigh_consensus_apply(tp, values, indices, (3, 3),
                                     band_impl="triton")
    _, tp2 = _nc_params(2, kernel_sizes=(3,), channels=(2,))
    with pytest.raises(ValueError, match="1 output channel"):
        sparse_neigh_consensus_apply(tp2, values, indices, (3, 3))


def _port(config_kw, seed=0):
    jcfg = JaxConfig(**config_kw)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(seed), jcfg))
    model = bridge.from_jax_params(
        tree, ImMatchNetConfig.from_dict(jcfg.to_dict()), device="cpu"
    )
    return jcfg, tree, model


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("tgt_hw", [(64, 64), (48, 64)])
def test_immatchnet_band_matches_jax(tgt_hw, mutual):
    jcfg, tree, model = _port(dict(SMALL, nc_topk=5, nc_topk_mutual=mutual),
                              seed=3)
    rng = np.random.RandomState(4)
    src = rng.randn(2, 64, 64, 3).astype(np.float32)
    tgt = rng.randn(2, *tgt_hw, 3).astype(np.float32)
    want = jax_immatchnet_apply(tree, jcfg, jnp.asarray(src), jnp.asarray(tgt))
    got = immatchnet_apply(model, model.config, torch.from_numpy(src),
                           torch.from_numpy(tgt))
    assert got.dtype == torch.float32
    assert got.shape == (2, 4, 4, tgt_hw[0] // 16, tgt_hw[1] // 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the band keeps K entries per A-cell, the rest are exact zeros
    assert int((got != 0).sum(dim=(3, 4)).max()) <= 5


@pytest.mark.parametrize("tgt_hw", [(64, 64), (48, 64)])
def test_full_k_band_equals_dense(tgt_hw):
    model = ImMatchNet(ImMatchNetConfig(**SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(5))
    rng = np.random.RandomState(6)
    src = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    tgt = torch.from_numpy(rng.randn(2, *tgt_hw, 3).astype(np.float32))
    dense = immatchnet_apply(model, model.config, src, tgt)
    nb = (tgt_hw[0] // 16) * (tgt_hw[1] // 16)
    # K above hB*wB is clamped to the complete band
    for k in (nb, nb + 3):
        band = immatchnet_apply(model, model.config.replace(nc_topk=k), src, tgt)
        np.testing.assert_allclose(band.numpy(), dense.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize(
    "override,error,match",
    [
        (dict(nc_topk=-1), ValueError, "negative"),
        (dict(nc_topk=8, relocalization_k_size=2), ValueError, "relocalization"),
        (dict(corr_impl="stream"), ValueError, "requires a band path"),
        (dict(corr_impl="tiled"), ValueError, "not one of"),
        # the streamed band is ported (ROADMAP A9); a refinement the JAX
        # package refuses raises here too
        (dict(nc_topk=8, refine_factor=2, refine_radius=-1), ValueError,
         "negative"),
    ],
)
def test_sparse_config_checks(override, error, match):
    cfg = ImMatchNetConfig(**dict(SMALL, **override))
    with pytest.raises(error, match=match):
        ImMatchNet(cfg, device="cpu")
    with pytest.raises(error, match=match):
        make_serve_match_step(cfg)


def test_band_configs_build():
    for band_impl in ("xla", "pallas"):
        cfg = ImMatchNetConfig(**dict(SMALL, nc_topk=16, band_impl=band_impl))
        assert ImMatchNet(cfg, device="cpu").config.nc_topk == 16


def test_hysteresis_controller_dwell_and_dead_band():
    c = HysteresisController(high=0.75, low=0.25, up_count=2, down_count=2)
    assert not c.update(0.9)  # one high reading is not enough
    assert c.update(0.5) is False  # dead band resets the streak
    assert not c.update(0.9)
    assert c.update(0.9) is True  # 2 consecutive highs: flip up
    assert c.flips == 1
    assert c.update(0.1) is True  # one low reading is not enough
    assert c.update(0.5) is True  # dead band keeps the mode
    c.update(0.1)
    assert c.update(0.1) is False  # 2 consecutive lows: flip back
    assert c.flips == 2
    assert c.last_pressure == 0.1
    with pytest.raises(ValueError):
        HysteresisController(high=0.2, low=0.5)
    with pytest.raises(ValueError):
        HysteresisController(up_count=0)


def test_hysteresis_controller_default_counts():
    c = HysteresisController()
    assert [c.update(0.8) for _ in range(2)] == [False, True]
    assert [c.update(0.2) for _ in range(4)] == [True, True, True, False]
    assert c.flips == 2


# -- the engine with a dense standard and a band degraded program ----------


@pytest.fixture(scope="module")
def programs():
    _, _, model = _port(SMALL, seed=7)
    standard = make_serve_match_step(model.config)
    degraded = make_serve_match_step(model.config.replace(nc_topk=5))
    return model, standard, degraded


def _payload(rng, bucket):
    (hs, ws), (ht, wt) = bucket
    return {
        "source_image": rng.randn(hs, ws, 3).astype(np.float32),
        "target_image": rng.randn(ht, wt, 3).astype(np.float32),
    }


def _step(apply, model, payloads):
    batch = {k: torch.from_numpy(np.stack([p[k] for p in payloads]))
             for k in payloads[0]}
    with torch.inference_mode():
        return apply(model, batch)["matches"].numpy()


def _recording(apply, name, log):
    def fn(m, batch):
        log.append((name, tuple(batch["target_image"].shape[1:3]),
                    batch["source_image"].shape[0]))
        return apply(m, batch)
    return fn


def test_engine_serves_pinned_degraded_requests_with_the_band(programs):
    model, standard, degraded = programs
    log = []
    rng = np.random.RandomState(8)
    reqs = [(SQUARE, _payload(rng, SQUARE), "degraded") for _ in range(3)]
    reqs += [(RECT, _payload(rng, RECT), "degraded") for _ in range(2)]
    reqs += [(SQUARE, _payload(rng, SQUARE), None) for _ in range(2)]
    with ServeEngine(_recording(standard, "standard", log), model,
                     device="cpu", max_batch=4, max_wait=0.05,
                     degraded_apply_fn=_recording(degraded, "degraded", log)
                     ) as engine:
        # both programs run per bucket and batch size
        assert engine.warmup([(SQUARE, payload_spec(reqs[0][1])),
                              (RECT, payload_spec(reqs[3][1]))]) \
            == 2 * 2 * len(engine.batch_sizes)
        log.clear()
        futures = [engine.submit(key=k, payload=p, variant=v)
                   for k, p, v in reqs]
        results = [f.result(timeout=60) for f in futures]
    report = engine.report()
    assert report["completed"] == len(reqs) and report["failed"] == 0
    # standard and degraded requests of one bucket never share a batch
    degraded_rows = sum(bs for name, _, bs in log if name == "degraded")
    assert {name for name, _, _ in log} == {"standard", "degraded"}
    assert degraded_rows >= 5
    assert report["degraded_batches"] == sum(1 for n, _, _ in log if n == "degraded")
    assert report["degraded_mode"] is False and report["degrade_flips"] == 0
    for (key, payload, variant), res in zip(reqs, results):
        apply = degraded if variant == "degraded" else standard
        want = _step(apply, model, [payload])[0]
        np.testing.assert_allclose(res["matches"], want, rtol=RTOL, atol=ATOL)
    # the band program differs from the dense one on these pairs
    assert not np.allclose(_step(standard, model, [reqs[0][1]]),
                           _step(degraded, model, [reqs[0][1]]))


def test_engine_rejects_a_pin_it_cannot_serve(programs):
    model, standard, _ = programs
    with ServeEngine(standard, model, device="cpu") as engine:
        with pytest.raises(ValueError, match="no degraded program"):
            engine.submit(key=SQUARE, payload={}, variant="degraded")
        with pytest.raises(ValueError, match="no refined program"):
            engine.submit(key=SQUARE, payload={}, variant="refined")
        with pytest.raises(ValueError, match="unknown quality variant"):
            engine.submit(key=SQUARE, payload={}, variant="ultra")
    assert engine.report()["submitted"] == 0


def test_forced_controller_flips_dispatch_to_the_band(programs):
    model, standard, degraded = programs
    rng = np.random.RandomState(9)
    payload = _payload(rng, SQUARE)
    # every reading (>= 0) is overload: flips on the first observation
    forced = HysteresisController(high=0.0, low=-1.0, up_count=1)
    with ServeEngine(standard, model, device="cpu", max_batch=1,
                     degraded_apply_fn=degraded,
                     degrade_controller=forced) as engine:
        got = engine.submit(key=SQUARE, payload=payload).result(timeout=60)
        pinned = engine.submit(key=SQUARE, payload=payload,
                               variant="standard").result(timeout=60)
    report = engine.report()
    np.testing.assert_allclose(got["matches"],
                               _step(degraded, model, [payload])[0],
                               rtol=RTOL, atol=ATOL)
    # a pinned request bypasses the controller
    np.testing.assert_allclose(pinned["matches"],
                               _step(standard, model, [payload])[0],
                               rtol=RTOL, atol=ATOL)
    assert report["degraded_mode"] is True
    assert report["degraded_batches"] == 1
    assert report["degrade_flips"] >= 1


@pytest.mark.parametrize("flags,topk,degrade", [
    (["--nc-topk", "5"], 5, -1),
    (["--degrade", "5", "--degrade-high", "0.5", "--degrade-low", "0.1"], 0, 5),
])
def test_serve_cli_band_flags_on_cpu(flags, topk, degrade):
    from ncnet_tpu_torch.serve.__main__ import main

    report = main([
        "--synthetic", "3", "--image-size", "64", "--cnn", "patch16",
        "--ncons-kernel-sizes", "3", "--ncons-channels", "1",
        "--max-batch", "2", "--device", "cpu", *flags,
    ])
    assert report["nc_topk"] == topk and report["degrade_topk"] == degrade
    assert report["config"]["nc_topk"] == topk
    assert report["completed"] == 3 and report["failed"] == 0
    assert report["degraded_batches"] == 0  # idle traffic never flips
