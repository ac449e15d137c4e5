"""The port's serving path on the CPU: the serve step against the JAX
package's, and the ServeEngine (every future resolves with the per-pair
result, buckets batch separately, padding never changes a real row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ncnet_tpu.models.immatchnet import ImMatchNetConfig as JaxConfig
from ncnet_tpu.models.immatchnet import init_immatchnet
from ncnet_tpu.serve.engine import make_serve_match_step as jax_serve_step
from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.serve.batcher import MicroBatcher, Request
from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
from ncnet_tpu_torch.serve.step import make_serve_match_step

# float32, the issue's starting tolerance
RTOL, ATOL = 1e-5, 1e-6

SMALL = dict(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3, 3),
             ncons_channels=(4, 1))
SQUARE = ((64, 64), (64, 64))
RECT = ((64, 64), (48, 64))


@pytest.fixture(scope="module")
def served():
    jcfg = JaxConfig(**SMALL)
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(0), jcfg))
    cfg = ImMatchNetConfig.from_dict(jcfg.to_dict())
    model = bridge.from_jax_params(tree, cfg, device="cpu")
    return jcfg, tree, cfg, model


def _payload(rng, bucket):
    (hs, ws), (ht, wt) = bucket
    return {
        "source_image": rng.randn(hs, ws, 3).astype(np.float32),
        "target_image": rng.randn(ht, wt, 3).astype(np.float32),
    }


def _step(apply, model, payloads):
    batch = {
        k: torch.from_numpy(np.stack([p[k] for p in payloads]))
        for k in payloads[0]
    }
    with torch.inference_mode():
        return apply(model, batch)["matches"].numpy()


@pytest.mark.parametrize("bucket", [SQUARE, RECT])
def test_serve_step_matches_jax(served, bucket):
    jcfg, tree, cfg, model = served
    rng = np.random.RandomState(1)
    payloads = [_payload(rng, bucket) for _ in range(2)]
    got = _step(make_serve_match_step(cfg), model, payloads)
    want = np.asarray(jax_serve_step(jcfg)(
        tree, {k: jnp.asarray(np.stack([p[k] for p in payloads]))
               for k in payloads[0]},
    )["matches"])
    n = 16 + (bucket[1][0] // 16) * (bucket[1][1] // 16)
    assert got.shape == want.shape == (2, 5, n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_engine_resolves_every_request_with_the_per_pair_result(served):
    _, _, cfg, model = served
    apply = make_serve_match_step(cfg)
    seen_batches = []

    def recording_apply(m, batch):
        seen_batches.append(
            (tuple(batch["target_image"].shape[1:3]), batch["source_image"].shape[0])
        )
        return apply(m, batch)

    rng = np.random.RandomState(2)
    requests = [(SQUARE, _payload(rng, SQUARE)) for _ in range(5)]
    requests += [(RECT, _payload(rng, RECT)) for _ in range(3)]
    with ServeEngine(recording_apply, model, device="cpu", max_batch=4,
                     max_wait=0.05, host_workers=2) as engine:
        assert engine.warmup(
            [(SQUARE, payload_spec(requests[0][1])),
             (RECT, payload_spec(requests[-1][1]))]
        ) == 2 * len(engine.batch_sizes)
        seen_batches.clear()
        futures = [engine.submit(key=k, payload=p) for k, p in requests]
        results = [f.result(timeout=60) for f in futures]
    report = engine.report()
    assert report["completed"] == len(requests) and report["failed"] == 0
    assert report["real_samples"] == len(requests)
    # every batch holds one bucket only; both buckets were served
    assert {shape for shape, _ in seen_batches} == {(64, 64), (48, 64)}
    assert sum(1 for shape, _ in seen_batches if shape == (48, 64)) >= 1
    for (key, payload), res in zip(requests, results):
        want = _step(apply, model, [payload])[0]
        assert res["matches"].shape == want.shape
        # batch size changes the CPU conv's blocking, not the math
        np.testing.assert_allclose(res["matches"], want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(report["latency_p50_ms"])
    assert 0 < report["mean_occupancy"] <= 1


def test_padding_never_changes_a_real_row(served):
    _, _, cfg, model = served
    apply = make_serve_match_step(cfg)
    rng = np.random.RandomState(3)
    payloads = [_payload(rng, SQUARE) for _ in range(3)]
    with ServeEngine(apply, model, device="cpu", max_batch=4, max_wait=0.05,
                     host_workers=1) as engine:
        futures = [engine.submit(key=SQUARE, payload=p) for p in payloads]
        results = [f.result(timeout=60)["matches"] for f in futures]
    report = engine.report()
    assert report["padded_samples"] == 4 and report["real_samples"] == 3
    # the padded batch of 4 against the same 3 rows run unpadded
    want = _step(apply, model, payloads)
    np.testing.assert_allclose(np.stack(results), want, rtol=RTOL, atol=ATOL)


def test_failed_batch_fails_its_futures_only(served):
    _, _, cfg, model = served
    apply = make_serve_match_step(cfg)

    def flaky(m, batch):
        if batch["target_image"].shape[1] == 48:
            raise RuntimeError("injected device fault")
        return apply(m, batch)

    rng = np.random.RandomState(4)
    with ServeEngine(flaky, model, device="cpu", max_batch=2,
                     max_wait=0.01) as engine:
        ok = engine.submit(key=SQUARE, payload=_payload(rng, SQUARE))
        bad = engine.submit(key=RECT, payload=_payload(rng, RECT))
        assert ok.result(timeout=60)["matches"].shape == (5, 32)
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=60)
    assert engine.report()["failed"] == 1


def test_batcher_flushes_on_cap_and_deadline():
    now = [0.0]
    b = MicroBatcher(max_batch=2, max_wait=1.0, clock=lambda: now[0])
    assert b.add(Request("a", {}, None, 0.0)) is None
    full = b.add(Request("a", {}, None, 0.0))
    assert full is not None and full.pad_to == 2
    assert b.add(Request("b", {}, None, 0.0)) is None
    assert b.ready() == []
    now[0] = 1.0
    (late,) = b.ready()
    assert late.key == "b" and late.pad_to == 1 and late.occupancy == 1.0



def test_serve_cli_on_cpu(tmp_path, capsys):
    from ncnet_tpu_torch.serve.__main__ import main

    jcfg = JaxConfig(feature_extraction_cnn="patch16", ncons_kernel_sizes=(3,),
                     ncons_channels=(1,))
    tree = jax.tree.map(np.asarray, init_immatchnet(jax.random.PRNGKey(1), jcfg))
    params = tmp_path / "params.npz"
    np.savez(params, **bridge.flatten(tree))
    report = main([
        "--synthetic", "4", "--image-size", "64", "--cnn", "patch16",
        "--ncons-kernel-sizes", "3", "--ncons-channels", "1",
        "--max-batch", "2", "--device", "cpu", "--params", str(params),
    ])
    # every fourth target is 304x400 -> 48x64: two buckets
    assert report["buckets"] == 2
    assert report["completed"] == 4 and report["failed"] == 0
    assert '"pairs_per_s"' in capsys.readouterr().out
