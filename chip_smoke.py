"""Chip smoke of the PyTorch/CUDA port: drives ``ncnet_tpu_torch`` on one
NVIDIA GPU and fails unless every phase holds.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — CUDA must be present; the card's name and power limit.
2. build   — the hand kernel is built with nvcc from the repository's
             sources (ptxas's register/spill report).
3. kernels — the conv4d kernel against its plain PyTorch version (TF32
             off) at the PF-Pascal NC layer shapes (batch 2x2 on the 25^4
             grid), a rectangular and a tiny grid, float32 and bfloat16;
             then each layer timed with CUDA events at the serving path's
             square-batch shape, beside its plain version and its bound.
4. serve   — ImMatchNet at the PF-Pascal config (ResNet-101, NC 5-5-5 /
             16-16-1, 400 px) with random weights from a seed behind the
             port's ServeEngine: 8 requests at the 400x400 bucket and 4 at
             400x400 against 304x400. Every future must resolve with
             finite matches; the kernel's launch count over the served
             batches must be 3 per square batch and 6 per rectangular one;
             one request must agree with the forward through the plain
             conv4d on the card.
Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Needs one card; exits non-zero without CUDA.
"""

import json
import subprocess
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): FP32 on the CUDA
# cores, BF16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

SEED = 0
MAX_BATCH = 4
N_SQUARE, N_RECT = 8, 4
SQUARE_HW, RECT_HW = (400, 400), (304, 400)
# PF-Pascal NC layers at 400 px: 25^4 grid, 5^4 kernels, (cin, cout)
NC_LAYERS = ((1, 16), (16, 16), (16, 1))
GRID, KSIZE = 25, 5
# kernel vs plain on the card: float32 sums of up to 10,000 products in
# two orders (cuDNN may use Winograd/FFT for the plain conv3d); bfloat16
# adds the output's rounding (2^-8 relative). Relative to max |plain|.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# served corr, kernel vs plain forward, relative to max |corr|
SERVE_TOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(conv4d_fwd):
    t0 = time.perf_counter()
    log = conv4d_fwd.load()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def nc_inputs(shape, cin, cout, dtype, seed):
    """Post-ReLU-like activations in [0, 1) and reference-init weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = (cin * KSIZE**4) ** -0.5
    x = torch.rand(*shape, cin, generator=g, device="cuda")
    w = (torch.rand(KSIZE, KSIZE, KSIZE, KSIZE, cin, cout, generator=g,
                    device="cuda") * 2 - 1) * bound
    b = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
    return x.to(dtype), w.to(dtype), b


def valid_taps(n, k):
    """Sum over n positions of the taps of a size-k SAME window that land
    on the grid (the zero-padding taps need no work)."""
    p = k // 2
    return sum(min(n, i + p + 1) - max(0, i - p) for i in range(n))


def bound_ms(shape, cin, cout, dtype):
    b, dims = shape[0], shape[1:]
    flops = 2.0 * b * cin * cout * np.prod([valid_taps(n, KSIZE) for n in dims])
    elt = torch.finfo(dtype).bits // 8
    nbytes = (np.prod(shape) * (cin + cout) + KSIZE**4 * cin * cout) * elt + 4 * cout
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def time_ms(fn, reps):
    fn()  # warm up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(smi, conv4d_fwd, conv4d_plain):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = GRID
    cases = [((4, g, g, g, g), cin, cout) for cin, cout in NC_LAYERS]
    cases += [((4, g, g, 19, g), 16, 16), ((2, 3, 2, 4, 3), 1, 16),
              ((2, 3, 2, 4, 3), 16, 1)]
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (shape, cin, cout) in enumerate(cases):
            x, w, b = nc_inputs(shape, cin, cout, dtype, seed=ci)
            got = conv4d_fwd(x, w, b).float()
            want = conv4d_plain(x.float(), w.float(), b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype] * scale
            checks.append({"shape": list(shape), "cin": cin, "cout": cout,
                           "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "max_rel_err": err / scale,
                           "tol_rel": TOL[dtype], "ok": ok})
            if not ok:
                emit({"phase": "kernels", "checks": checks})
                raise AssertionError(f"conv4d kernel disagrees: {checks[-1]}")

    # per-layer times at the serving path's square batch: MAX_BATCH pairs,
    # both symmetric directions batched
    layers = []
    shape = (2 * MAX_BATCH, g, g, g, g)
    for li, (cin, cout) in enumerate(NC_LAYERS):
        x, w, b = nc_inputs(shape, cin, cout, torch.float32, seed=10 + li)
        ms = time_ms(lambda: conv4d_fwd(x, w, b), reps=3)
        plain_ms = time_ms(lambda: conv4d_plain(x, w, b), reps=3)
        err = float((conv4d_fwd(x, w, b) - conv4d_plain(x, w, b)).abs().max())
        bms, by, flops = bound_ms(shape, cin, cout, torch.float32)
        layers.append({"layer": li, "shape": list(shape), "cin": cin,
                       "cout": cout, "dtype": "float32", "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
                       "max_abs_err": err})
    emit({"phase": "kernels", "card": smi,
          "checks": checks, "timed": layers})
    return layers


def phase_serve(smi, conv4d_fwd, conv4d_plain):
    """Serve the PF-Pascal config; returns the kernel's launches over the
    served batches."""
    from ncnet_tpu_torch.data.images import normalize_image_np
    from ncnet_tpu_torch.models.immatchnet import (
        ImMatchNet,
        ImMatchNetConfig,
        immatchnet_apply,
    )
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
    from ncnet_tpu_torch.serve.step import make_match_fn, make_serve_match_step

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), symmetric_mode=True,
    )
    t0 = time.perf_counter()
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    apply = make_serve_match_step(config)
    served_keys = []

    def counted_apply(m, batch):
        served_keys.append((tuple(batch["source_image"].shape[1:3]),
                            tuple(batch["target_image"].shape[1:3])))
        return apply(m, batch)

    rng = np.random.RandomState(SEED)

    def image(hw):
        return normalize_image_np(
            rng.uniform(0, 255, hw + (3,)).astype(np.float32)
        ).astype(np.float32)

    requests = [(SQUARE_HW, SQUARE_HW)] * N_SQUARE + [(SQUARE_HW, RECT_HW)] * N_RECT
    payloads = [{"source_image": image(s), "target_image": image(t)}
                for s, t in requests]
    with ServeEngine(counted_apply, model, device="cuda", max_batch=MAX_BATCH,
                     max_wait=0.05) as engine:
        t_warm = time.perf_counter()
        engine.warmup([((SQUARE_HW, SQUARE_HW), payload_spec(payloads[0])),
                       ((SQUARE_HW, RECT_HW), payload_spec(payloads[-1]))])
        warmup_s = time.perf_counter() - t_warm
        served_keys.clear()
        conv4d_fwd.launches = 0
        t_serve = time.perf_counter()
        futures = [None] * len(requests)

        def client(idx):
            for i in idx:
                futures[i] = engine.submit(key=requests[i], payload=payloads[i])

        clients = [threading.Thread(target=client, args=(range(c, len(requests), 4),))
                   for c in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        results = [f.result(timeout=600) for f in futures]  # raises on a failed future
        serve_s = time.perf_counter() - t_serve
    launches = conv4d_fwd.launches
    report = engine.report()

    n_sq = sum(1 for k in served_keys if k == (SQUARE_HW, SQUARE_HW))
    n_rect = len(served_keys) - n_sq
    expected = 3 * n_sq + 6 * n_rect
    for (src, tgt), res in zip(requests, results):
        m = res["matches"]
        # one match per B cell (forward) and per A cell (reverse)
        n = (tgt[0] // 16) * (tgt[1] // 16) + (src[0] // 16) * (src[1] // 16)
        if m.shape != (5, n) or not np.isfinite(m).all():
            raise AssertionError(f"bad matches {m.shape} (want (5, {n})) or non-finite")
    if report["failed"] or report["completed"] != len(requests):
        raise AssertionError(f"serving failed: {report}")
    if launches != expected or n_sq == 0 or n_rect == 0:
        raise AssertionError(
            f"conv4d launches {launches} != 3 x {n_sq} square + 6 x {n_rect} "
            "rectangular batches"
        )

    # one request of each bucket: the forward with the kernel against the
    # same forward with the plain conv4d, on the card
    agree = []
    match_fn = make_match_fn(config)
    for idx in (0, len(requests) - 1):
        src = torch.from_numpy(payloads[idx]["source_image"][None]).cuda()
        tgt = torch.from_numpy(payloads[idx]["target_image"][None]).cuda()
        with torch.inference_mode():
            # the served row is the same forward as this lone request
            lone = match_fn(model, src, tgt)[:, 0].cpu().numpy()
            served = results[idx]["matches"]
            served_err = float(np.abs(served[4] - lone[4]).max())
            served_ok = served_err <= SERVE_TOL * float(np.abs(lone[4]).max())
            corr_k = immatchnet_apply(model, config, src, tgt)
            conv = model.neigh_consensus.conv
            model.neigh_consensus.conv = conv4d_plain
            try:
                corr_p = immatchnet_apply(model, config, src, tgt)
            finally:
                model.neigh_consensus.conv = conv
            scale = float(corr_p.abs().max())
            corr_err = float((corr_k - corr_p).abs().max())
            flat_p = corr_p.reshape(1, corr_p.shape[1] * corr_p.shape[2], -1)
            idx_ok = True
            for dim, invert in ((1, False), (2, True)):
                sm = torch.softmax(flat_p, dim=dim)
                i_k = corr_to_matches(corr_k, do_softmax=True, scale="positive",
                                      invert_matching_direction=invert,
                                      return_indices=True)
                ia, ja, ib, jb = i_k[5:]
                a_idx = ia * corr_p.shape[2] + ja
                b_idx = ib * corr_p.shape[4] + jb
                picked = sm[0, a_idx[0], b_idx[0]]
                best = sm.amax(dim=dim)[0]
                # equal argmax, allowing for (near-)ties in the plain scores
                idx_ok &= bool((picked >= best - SERVE_TOL * float(best.max())).all())
            ok = corr_err <= SERVE_TOL * scale and idx_ok and served_ok
        agree.append({"request": idx, "bucket": [list(requests[idx][0]), list(requests[idx][1])],
                      "served_vs_lone_score_err": served_err,
                      "corr_max_abs_err": corr_err, "corr_scale": scale,
                      "argmax_agree": idx_ok, "ok": ok})
        if not ok:
            raise AssertionError(f"kernel path disagrees with the plain path: {agree[-1]}")
    emit({"phase": "serve", "card": smi, "config": config.to_dict(),
          "requests": len(requests), "square_batches": n_sq,
          "rect_batches": n_rect, "conv4d_launches": launches,
          "expected_launches": expected, "setup_s": t_warm - t0,
          "warmup_s": warmup_s, "serve_s": serve_s,
          "pairs_per_s": report["pairs_per_s"],
          "latency_p50_ms": report["latency_p50_ms"],
          "latency_p95_ms": report["latency_p95_ms"],
          "mean_occupancy": report["mean_occupancy"], "agreement": agree,
          "stages_ms": stage_breakdown(model, config, payloads[:MAX_BATCH])})
    return launches


def stage_breakdown(model, config, payloads, reps=3):
    """CUDA-event times of the serving forward's stages on one square batch
    (``len(payloads)`` pairs), each timed alone after a warm-up."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.serve.step import make_serve_match_step

    batch = {k: torch.from_numpy(np.stack([p[k] for p in payloads])).cuda()
             for k in payloads[0]}
    apply = make_serve_match_step(config)
    with torch.inference_mode():
        fa = extract_features(model, config, batch["source_image"])
        fb = extract_features(model, config, batch["target_image"])
        corr = mutual_matching(correlation_4d(fa, fb))
        filtered = model.neigh_consensus(corr)

        def readout():
            c = mutual_matching(filtered).float()
            kw = dict(scale="positive", do_softmax=True)
            return torch.cat([torch.stack(corr_to_matches(c, **kw)),
                              torch.stack(corr_to_matches(
                                  c, invert_matching_direction=True, **kw))], 2)

        return {
            "pairs": len(payloads),
            "trunk": time_ms(lambda: (
                extract_features(model, config, batch["source_image"]),
                extract_features(model, config, batch["target_image"])), reps),
            "correlation_mm": time_ms(
                lambda: mutual_matching(correlation_4d(fa, fb)), reps),
            "neigh_consensus": time_ms(lambda: model.neigh_consensus(corr), reps),
            "mm_readout": time_ms(readout, reps),
            "forward": time_ms(lambda: apply(model, batch), reps),
        }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs a card")
    # the port itself: this fails where chip_smoke.py stands without it
    from ncnet_tpu_torch.kernels.conv4d import conv4d_fwd
    from ncnet_tpu_torch.ops.conv4d import conv4d_plain

    smi = phase_device()
    phase_build(conv4d_fwd)
    layers = phase_kernels(smi, conv4d_fwd, conv4d_plain)
    launches = phase_serve(smi, conv4d_fwd, conv4d_plain)
    emit({"kernels": [{
        "name": "conv4d_fwd",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/conv4d_fwd.cu",
        "replaces": "ncnet_tpu/kernels/conv4d_pallas.py:65",
        "launches": launches,
        "max_abs_err": max(layer["max_abs_err"] for layer in layers),
        "ms": sum(layer["ms"] for layer in layers),
        "plain_ms": sum(layer["plain_ms"] for layer in layers),
        "bound_ms": sum(layer["bound_ms"] for layer in layers),
        "bound_by": "operations",
        "library_ms": None,
        "work": "the three NC layers of one square serving batch "
                f"({MAX_BATCH} pairs x 2 directions), float32",
        "card": smi,
        "layers": layers,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
