"""Chip smoke of the PyTorch/CUDA port: drives ``ncnet_tpu_torch`` on one
NVIDIA GPU and fails unless every phase holds.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — CUDA must be present; the card's name and power limit.
2. build   — the three kernel libraries (conv4d forward, which dx reuses;
             conv4d dw; band GEMM) are built with nvcc from the
             repository's sources, one nvcc each, started together
             (seconds and ptxas's register/spill report); then each
             library's HMMA/HGMMA (tensor-core) instructions per kernel
             function, from ``cuobjdump -sass``: the bfloat16 routes of
             conv4d forward and dw (functions named ``bf16_tc``) and the
             forward's float32 split-TF32 route (``tf32x3``) must have
             some in every function, and their CUDA-core (FFMA) functions
             none, or the phase fails; without cuobjdump the phase says
             so.
3. kernels — the conv4d kernel against its plain PyTorch version (TF32
             off) at the PF-Pascal NC layer shapes (batch 2x2 on the 25^4
             grid), a rectangular and a tiny grid, float32 and bfloat16;
             then each layer timed with CUDA events at the serving path's
             square-batch shape, beside its plain version and its bound
             (float32-accurate work at the split-TF32 rate, 495/3 TFLOP/s),
             with its route (split-TF32 tensor cores or FFMA, by the
             kernel's shape rule), held to TOL and to a bitwise repeat.
4. band_kernels — the band kernel, which derives each entry's neighbours
             from the band's indices, against its plain version (pointer
             table, gather, matmul, TF32 off) on real K = 16 mutual bands
             built by the port from random features on 25x25 grids (the
             three PF-Pascal layer shapes, both passes), a 25x25 against
             19x25 band, K = 50, the complete band at 192 px (12x12, K =
             144; 12x12 against 9x12, K = 108), a tiny grid; float32 and
             bfloat16; then each layer and pass timed at the served square
             batch (4 pairs; CUDA events around the wrapper's calls, the
             kernel's own device time from ``torch.profiler``, and the
             host's time to issue one call), beside
             the plain version, the non-null tap share and the bound, held
             to its tolerance and to a bitwise repeat.
5. serve   — ImMatchNet at the PF-Pascal config (ResNet-101, NC 5-5-5 /
             16-16-1, 400 px) with random weights from a seed behind the
             port's ServeEngine: 8 requests at the 400x400 bucket and 4 at
             400x400 against 304x400. Every future must resolve with
             finite matches; the kernel's launch count over the served
             batches must be 3 per square batch and 6 per rectangular one;
             one request must agree with the forward through the plain
             conv4d on the card.
6. serve_band — the same model behind a ServeEngine whose standard program
             is dense and whose degraded program is the K = 16 band
             (``make_serve_match_step(config.replace(nc_topk=16))``), both
             warmed on both buckets: 8 requests pinned ``degraded`` (square
             and rectangular) and 2 unpinned. Every future must resolve
             with finite matches; the band kernel must launch exactly 6
             times per degraded batch and conv4d 3 per standard square
             batch (6 per rectangular); one degraded request per bucket
             must agree with the band forward through the plain band layer
             on the card; no pointer table may be built while serving (a
             call counter on ``band_neighbor_pointers``). Then the band
             forward's stage times, again with no table built.
7. full_k  — at 192 px (12x12 grids, K = 144 = hB*wB, and 12x9 with K =
             108) the band forward through the band kernel equals the
             dense forward through the conv4d kernel.
8. train_kernels — the conv4d backward kernels against their plain
             versions (TF32 off) at every training layer shape (dx: the
             16->16 and 16->1 layers, whose inputs need a gradient; dw:
             all three) at 2 samples on the 25^4 grid, float32 and
             bfloat16; then the forward, dx and dw timed at the training
             batch (16 pairs x 2 symmetric directions = 32 samples per
             pipeline call, the bfloat16 of the training path) beside
             their plain versions and bounds, each timed launch held to
             its tolerance, and the forward and dw called twice on the
             same inputs: the two results must be bitwise equal. Then dw
             on the 48x48 grid of 768 px (past the grids whose whole halo
             fitted a block), all three layers, float32 and bfloat16, at 1
             sample against the plain version with a bitwise repeat, and
             timed in bfloat16 at the 4 samples of a 768 px pipeline call.
9. train   — (a) the NC gradients at the PF-Pascal width (ResNet-101,
             400 px, 5-5-5 / 16-16-1), 2 pairs, of a random linear
             functional of the NC output and of the weak loss's positive
             term, float32 through the kernels, against the same model
             with the plain differentiable conv4d (cuDNN's conv3d and its
             autograd) on float64 correlations: within 4x the same plain
             version's own float32 error (see GRAD_RATIO);
             (b) 3 Adam steps of the trainer API (create_train_state /
             make_train_step) at batch 16, bfloat16, on SyntheticPairDataset:
             finite float32 losses, float32 masters and Adam state, every
             NC kernel moved, trunk bitwise unchanged, and exactly 6 conv4d
             forward, 4 dx and 6 dw launches per step; then one step's
             stage times and the peak memory; (c) one step at 768 px
             (48x48 grids), batch 2: a finite loss and 6 / 4 / 6 launches;
             (d) ``python -m
             ncnet_tpu_torch.train --synthetic --allow_random_fe
             --max-steps 2`` in a subprocess: its report comes back and its
             checkpoint loads.
10. eval   — (a) the synthetic convergence run (``ncnet_tpu_torch.eval.
             synthetic.run``) at its defaults (patch16, identity NC init,
             centred features, NC 3-3 / 16-1, 128 px, lr 5e-4, 400 steps,
             PCK@0.15), in float32 and in bfloat16, through the kernels:
             the loss must fall and PCK after training must clear both
             PCK before and the degenerate diagonal's by SYNTH_MARGIN;
             (b) PF-Pascal PCK at the PF-Pascal config (centred features)
             on PF_PAIRS generated keypointed pairs
             (``pf_pascal_sample``, 'scnet'):
             ``evaluate`` (3 conv4d launches a batch), ``evaluate_serving``
             and ``pck_vs_topk`` at K = BAND_K (6 band launches a batch),
             each pair's PCK equal to the plain kernels' path, or where it
             differs, the kernel's readout the plain one up to ties.
11. inloc  — ``dump_matches`` at the reference's InLoc settings (3200 px,
             k_size 2, NC 3-3 / 16-1, bfloat16, both directions, softmax)
             on one generated 4032x3024 query and two 1600x1200 panos
             (.npy files and a shortlist .mat): the .mat is [1, 2, 15000,
             5] with finite coordinates in [0, 1] and 4 conv4d launches a
             pair; one pair's readout holds against the forward through
             the plain conv4d (float32 sums of the same bfloat16 inputs,
             rounded to bfloat16): offsets equal, correlation and scores
             within INLOC_TOL, each differing pick short of the plain best
             by no more than the two correlations differ (a tie at their
             error); the pair's stage times; each conv4d
             layer at the pooled [1, 100, 75, 75, 100] grid and its
             transpose against its plain version (TOL), repeated bitwise,
             timed beside its plain version and bound.
Then the ``{"kernels": [...]}`` line (``launches_by_path`` per kernel:
serve, serve_band, train, eval, inloc), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Needs one card; exits non-zero without CUDA.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): BF16 and TF32 on
# the tensor cores, HBM3 bandwidth. Work held to float32 accuracy is
# bounded at the split-TF32 rate: the TF32 peak over the three MMAs a
# product of the conv4d kernel's float32 route (csrc/mma_tf32.cuh), faster
# than FP32 FFMA on the CUDA cores (67 TFLOP/s).
SPLIT_TF32_FLOPS = 495e12 / 3
PEAK_FLOPS = {torch.float32: SPLIT_TF32_FLOPS, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

SEED = 0
BAND_K = 16  # the degraded program's band width (scripts/serve.py --degrade 16)
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
# band kernel vs plain on the card: float32 sums of at most 10,000
# products in two orders; bfloat16 adds the rounding of the product and of
# the biased sum (2^-8 relative each). Relative to max |plain|.
BAND_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# served corr, kernel vs plain forward, relative to max |corr|
SERVE_TOL = 1e-4
# dx kernel vs plain: the forward kernel's sums and rounding (as TOL); dw
# kernel vs plain: float32 sums of up to 781,250 products (2 samples) in
# other orders, bfloat16 held to 1e-2 of max |dw| as the forward's TOL
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# NC gradients, float32 through the kernels vs the plain conv4d in
# float64, relative to the max |g| of each layer's parameters. A float32
# forward flips some ReLUs against float64 and the backward sums of 1.56 M
# products cancel heavily, so the plain version in float32 (cuDNN) is
# itself up to 1.7e-3 (linear objective) and 8e-5 (score) of the scale off
# the float64 answer on an H100: the kernels are held to GRAD_RATIO times
# the plain float32 version's own error, or GRAD_TOL of the scale where
# that is larger. A wrong gradient is off by its own size.
GRAD_TOL = 1e-4
GRAD_RATIO = 4.0
TRAIN_BATCH = 16  # scripts/train.py --batch_size default
TRAIN_SAMPLES = 2 * TRAIN_BATCH  # one pipeline call, both directions batched
TRAIN_STEPS = 3
# 768 px: the 48x48 grid on which dw stages windows of k-rows
WIDE_HW, WIDE_GRID = (768, 768), 48
# the libraries whose bfloat16 route runs on the tensor cores, and the one
# whose float32 route does (split-TF32) where its shape rule says so
BF16_TC_ROUTES = ("conv4d_fwd", "conv4d_dw")
TF32X3_ROUTES = ("conv4d_fwd",)
# eval: synthetic convergence at its defaults (128 px, patch16, identity NC
# init, NC 3-3 / 16-1, 400 steps): PCK@0.15 after training must clear PCK
# before and the degenerate diagonal's by SYNTH_MARGIN (a model collapsed
# onto the diagonal scores the baseline exactly; 0.1 is 26 of the 256
# query points)
SYNTH_MARGIN = 0.10
# the kernels' shapes in that run: a pipeline call of its 8-pair batch
# (training and scoring alike) batches both directions, 16 samples of the
# 8x8 grid of 128 px, NC 3-3 / 16-1; layer 1's input is the correlation,
# so dx runs for the 16 -> 1 layer only
SYNTH_SHAPE, SYNTH_KS = (16, 8, 8, 8, 8), 3
SYNTH_LAYERS = ((1, 16), (16, 1))
PF_PAIRS = 8  # generated keypointed PF-Pascal pairs, two batches of MAX_BATCH
# inloc: the reference's settings (eval_inloc.py: 3200 px, k_size 2, NC
# 3-3 / 16-1, bfloat16); an iPhone 7 query against 1600x1200 panos
INLOC_SIZE, INLOC_K = 3200, 2
QUERY_HW, PANO_HW = (4032, 3024), (1200, 1600)
INLOC_SLOTS = 15000  # n_match_slots(3200, 2, both directions)
INLOC_LAYERS = ((1, 16), (16, 1))
# the bfloat16 forward through the kernel vs the same forward through the
# plain conv4d in float32 on the same bfloat16 inputs, rounded to
# bfloat16 as the kernel rounds its float32 sums; relative to the scale
# of the plain correlation (and the softmax scores to theirs). The two
# sums differ in order only, so a layer's outputs differ by at most one
# bfloat16 step (2^-8 of the scale) where a sum lies at a rounding
# boundary; the post-NC mutual matching, a product of three factors in
# bfloat16, triples that and adds its own roundings
INLOC_TOL = 3e-2


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


def phase_build(kernels):
    """Build every kernel, one nvcc each, all started together; count each
    library's tensor-core instructions."""
    from ncnet_tpu_torch.kernels._build import tensor_core_summary

    t0 = time.perf_counter()
    done, errors = {}, {}

    def one(name, kernel):
        try:
            log = kernel.load()
            done[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln],
            }
        except Exception as exc:  # reported below, then the run fails
            errors[name] = repr(exc)
            return
        counts = kernel.tensor_core_counts()
        if counts is None:
            done[name]["tensor_cores"] = "cuobjdump absent: not counted"
            return
        summary = tensor_core_summary(counts)
        done[name]["tensor_cores"] = {**summary, "per_function": counts}
        if name in BF16_TC_ROUTES and summary["bf16_route_min_mma"] == 0:
            errors[name] = (f"the bfloat16 route has no tensor-core "
                            f"instruction in some function: {counts}")
        if name in TF32X3_ROUTES and (summary["tf32x3_route_functions"] == 0
                                      or summary["tf32x3_route_min_mma"] == 0):
            errors[name] = (f"the split-TF32 route has no tensor-core "
                            f"instruction in some function: {counts}")
        if name in BF16_TC_ROUTES and summary["other_mma"] != 0:
            errors[name] = (f"a CUDA-core (FFMA) function holds tensor-core "
                            f"instructions: {counts}")

    threads = [threading.Thread(target=one, args=item) for item in kernels.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": done, "errors": errors})
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")


def nc_inputs(shape, cin, cout, dtype, seed, ks=KSIZE):
    """Post-ReLU-like activations in [0, 1) and reference-init weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = (cin * ks**4) ** -0.5
    x = torch.rand(*shape, cin, generator=g, device="cuda")
    w = (torch.rand(ks, ks, ks, ks, cin, cout, generator=g,
                    device="cuda") * 2 - 1) * bound
    b = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
    return x.to(dtype), w.to(dtype), b


def valid_taps(n, k):
    """Sum over n positions of the taps of a size-k SAME window that land
    on the grid (the zero-padding taps need no work)."""
    p = k // 2
    return sum(min(n, i + p + 1) - max(0, i - p) for i in range(n))


def bound_ms(shape, cin, cout, dtype, ks=KSIZE):
    b, dims = shape[0], shape[1:]
    flops = 2.0 * b * cin * cout * np.prod([valid_taps(n, ks) for n in dims])
    elt = torch.finfo(dtype).bits // 8
    nbytes = (np.prod(shape) * (cin + cout) + ks**4 * cin * cout) * elt + 4 * cout
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def dw_bound_ms(shape, cin, cout, dtype, ks=KSIZE):
    """`bound_ms` of the weight gradient: the forward's operations; reads x
    and g, writes a float32 dw."""
    _, _, flops = bound_ms(shape, cin, cout, dtype, ks)
    elt = torch.finfo(dtype).bits // 8
    nbytes = np.prod(shape) * (cin + cout) * elt + ks**4 * cin * cout * 4
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


def host_ms(fn, reps):
    """Mean host time of one call of ``fn``: the wall time of ``reps``
    calls issued back to back, before the card is waited for. Where it
    exceeds the device time, the card idles between the launches."""
    fn()  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return 1e3 * host


def device_ms(fn, key, reps):
    """Mean device time of the kernels whose name holds ``key`` over
    ``reps`` calls of ``fn``, from ``torch.profiler``'s CUDA trace, or
    None where the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if key in e.key)
    return total / reps / 1e3 if total > 0 else None


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
    # both symmetric directions batched; each timed layer also held to TOL
    # against the plain version and to a bitwise repeat, with its route
    from ncnet_tpu_torch.kernels.conv4d import route

    layers = []
    shape = (2 * MAX_BATCH, g, g, g, g)
    for li, (cin, cout) in enumerate(NC_LAYERS):
        x, w, b = nc_inputs(shape, cin, cout, torch.float32, seed=10 + li)
        ms = time_ms(lambda: conv4d_fwd(x, w, b), reps=3)
        plain_ms = time_ms(lambda: conv4d_plain(x, w, b), reps=3)
        got, again = conv4d_fwd(x, w, b), conv4d_fwd(x, w, b)
        want = conv4d_plain(x, w, b)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        bitwise = bool(torch.equal(got, again))
        built = conv4d_fwd.built_route(torch.float32, cin, cout)
        bms, by, flops = bound_ms(shape, cin, cout, torch.float32)
        layers.append({"layer": li, "shape": list(shape), "cin": cin,
                       "cout": cout, "dtype": "float32", "route": built,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "gflop": flops / 1e9,
                       "tflops": flops / ms / 1e9, "max_abs_err": err,
                       "max_rel_err": err / scale, "tol_rel": TOL[torch.float32],
                       "bitwise_repeat": bitwise})
        if not (bitwise and err <= TOL[torch.float32] * scale
                and built == route(torch.float32, cin, cout)):
            emit({"phase": "kernels", "checks": checks, "timed": layers})
            raise AssertionError(f"timed float32 layer fails: {layers[-1]}")
    emit({"phase": "kernels", "card": smi,
          "checks": checks, "timed": layers})
    return layers


def build_model():
    """ImMatchNet at the PF-Pascal config, random weights from `SEED`."""
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), symmetric_mode=True,
    )
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    return model, config


def image_maker(seed):
    """``image(hw)``: a random ImageNet-normalized ``[h, w, 3]`` image."""
    from ncnet_tpu_torch.data.images import normalize_image_np

    rng = np.random.RandomState(seed)

    def image(hw):
        return normalize_image_np(
            rng.uniform(0, 255, hw + (3,)).astype(np.float32)
        ).astype(np.float32)

    return image


def argmax_agrees(corr_k, corr_p):
    """Both readout directions of ``corr_k`` pick, on the plain forward's
    softmax, a score within SERVE_TOL of the plain best: equal argmax,
    allowing for (near-)ties in the plain scores."""
    from ncnet_tpu_torch.ops.matches import corr_to_matches

    flat_p = corr_p.reshape(1, corr_p.shape[1] * corr_p.shape[2], -1)
    ok = True
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
        ok &= bool((picked >= best - SERVE_TOL * float(best.max())).all())
    return ok


def run_clients(engine, requests, payloads, variants=None):
    """Submit every request from 4 client threads; returns the futures."""
    futures = [None] * len(requests)

    def client(idx):
        for i in idx:
            futures[i] = engine.submit(
                key=requests[i], payload=payloads[i],
                **({} if variants is None else {"variant": variants[i]}),
            )

    clients = [threading.Thread(target=client, args=(range(c, len(requests), 4),))
               for c in range(4)]
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    return futures


def check_matches(requests, results):
    for (src, tgt), res in zip(requests, results):
        m = res["matches"]
        # one match per B cell (forward) and per A cell (reverse)
        n = (tgt[0] // 16) * (tgt[1] // 16) + (src[0] // 16) * (src[1] // 16)
        if m.shape != (5, n) or not np.isfinite(m).all():
            raise AssertionError(f"bad matches {m.shape} (want (5, {n})) or non-finite")


def phase_serve(smi, model, config, conv4d_fwd, conv4d_plain):
    """Serve the PF-Pascal config; returns the kernel's launches over the
    served batches."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
    from ncnet_tpu_torch.serve.step import make_match_fn, make_serve_match_step

    t0 = time.perf_counter()
    apply = make_serve_match_step(config)
    served_keys = []

    def counted_apply(m, batch):
        served_keys.append((tuple(batch["source_image"].shape[1:3]),
                            tuple(batch["target_image"].shape[1:3])))
        return apply(m, batch)

    image = image_maker(SEED)
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
        futures = run_clients(engine, requests, payloads)
        results = [f.result(timeout=600) for f in futures]  # raises on a failed future
        serve_s = time.perf_counter() - t_serve
    launches = conv4d_fwd.launches
    report = engine.report()

    n_sq = sum(1 for k in served_keys if k == (SQUARE_HW, SQUARE_HW))
    n_rect = len(served_keys) - n_sq
    expected = 3 * n_sq + 6 * n_rect
    check_matches(requests, results)
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
            idx_ok = argmax_agrees(corr_k, corr_p)
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


def real_band(b, grid_a, grid_b, k, seed):
    """A mutual top-``k`` band as the serving path builds one: L2-normalized
    non-negative random features, correlation, mutual matching, `topk_band`.
    Returns ``(values, indices)``."""
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.norm import feature_l2norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    fa = feature_l2norm(torch.rand(b, *grid_a, 1024, generator=g, device="cuda"))
    fb = feature_l2norm(torch.rand(b, *grid_b, 1024, generator=g, device="cuda"))
    corr = correlation_4d(fa, fb)
    return topk_band(corr, k, values_from=mutual_matching(corr), mutual=True)


def band_geometries(indices, grid_b):
    """The two passes' geometries of one band (the plain pass's, and the
    symmetric pass's over the B-major entries), as the NC stack makes them."""
    from ncnet_tpu_torch.ops.band import BandGeometry, b_major_order

    return {"plain": BandGeometry(indices, grid_b),
            "swapped": BandGeometry(indices, grid_b, *b_major_order(indices))}


@contextlib.contextmanager
def counting_pointer_builds():
    """Count the calls of ``ops.band.band_neighbor_pointers`` (every pointer
    table the port builds) inside the block: ``with ... as calls``,
    ``calls[0]`` after it."""
    from ncnet_tpu_torch.ops import band

    real, calls = band.band_neighbor_pointers, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    band.band_neighbor_pointers = counted
    try:
        yield calls
    finally:
        band.band_neighbor_pointers = real


def band_layer_inputs(b, n, cin, cout, dtype, seed):
    """Entries in [0, 1) and reference-init weights of one band layer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = (cin * KSIZE**4) ** -0.5
    x = torch.rand(b, n, cin, generator=g, device="cuda")
    w = (torch.rand(KSIZE, KSIZE, KSIZE, KSIZE, cin, cout, generator=g,
                    device="cuda") * 2 - 1) * bound
    bias = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
    return x.to(dtype), w.to(dtype), bias


def band_bound_ms(geom, cin, cout, dtype):
    """The least time of one band layer on the card: the FLOPs of the taps
    on the band (this band's, counted from the plain version's pointer
    table) over the peak of ``dtype``, against the bytes the kernel must
    move (entries, indices, ``inv`` on the symmetric pass, weights, bias,
    output, each once) over HBM bandwidth. No pointer table: the kernel
    builds none, and reads no ``perm`` (the entries arrive permuted)."""
    b, ha, wa, k = geom.indices.shape
    n = ha * wa * k
    taps = KSIZE**4
    nnz = int((geom.pointers((KSIZE,) * 4) != n).sum())
    elt = torch.finfo(dtype).bits // 8
    flops = 2.0 * nnz * cin * cout
    nbytes = (b * n * (cin + cout) * elt + b * n * 4 * (2 if geom.swapped else 1)
              + taps * cin * cout * elt + 4 * cout)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "nonnull_share": nnz / (b * n * taps),
            "gflop_nonnull": flops / 1e9,
            "gflop_all_taps": 2.0 * b * n * taps * cin * cout / 1e9,
            "mbytes": nbytes / 1e6}


def band_kernel_call(band_gemm_fwd, x, w, b, geom):
    """The band kernel's wrapper on one layer of a pass."""
    return band_gemm_fwd(x, w, b, geom.indices, geom.grid_b, geom.inv)


def phase_band_kernels(smi, band_gemm_fwd, band_plain):
    """The band kernel against its plain version on real bands; then each
    layer and pass timed at the served square batch."""
    g = GRID
    cases = []  # (label, geometry, cin, cout)
    _, idx = real_band(2, (g, g), (g, g), BAND_K, seed=20)
    for name, geom in band_geometries(idx, (g, g)).items():
        for cin, cout in NC_LAYERS:
            cases.append((f"25x25/25x25 K{BAND_K} {name}", geom, cin, cout))
    _, idx = real_band(2, (g, g), (19, g), BAND_K, seed=21)
    cases.append((f"25x25/19x25 K{BAND_K} swapped",
                  band_geometries(idx, (19, g))["swapped"], 16, 16))
    _, idx = real_band(2, (g, g), (g, g), 50, seed=22)
    cases.append(("25x25/25x25 K50 plain", band_geometries(idx, (g, g))["plain"],
                  16, 16))
    # the complete band of phase full_k's 192 px grids
    _, idx = real_band(2, (12, 12), (12, 12), 144, seed=24)
    for name, geom in band_geometries(idx, (12, 12)).items():
        cases.append((f"12x12/12x12 K144 {name}", geom, 16, 16))
    _, idx = real_band(2, (12, 12), (9, 12), 108, seed=25)
    cases.append(("12x12/9x12 K108 swapped",
                  band_geometries(idx, (9, 12))["swapped"], 1, 16))
    _, idx = real_band(2, (3, 2), (4, 3), 5, seed=23)
    tiny = band_geometries(idx, (4, 3))
    cases += [("3x2/4x3 K5 plain", tiny["plain"], 1, 16),
              ("3x2/4x3 K5 swapped", tiny["swapped"], 16, 1)]
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (label, geom, cin, cout) in enumerate(cases):
            n = geom.indices[0].numel()
            x, w, b = band_layer_inputs(geom.indices.shape[0], n, cin, cout,
                                        dtype, seed=ci)
            got = band_kernel_call(band_gemm_fwd, x, w, b, geom).float()
            want = band_plain(x.float(), w.float(), b.to(dtype).float(), geom)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= BAND_TOL[dtype] * scale
            checks.append({"case": label, "n": n, "cin": cin,
                           "cout": cout, "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "max_rel_err": err / scale,
                           "tol_rel": BAND_TOL[dtype], "ok": ok})
            if not ok:
                emit({"phase": "band_kernels", "checks": checks})
                raise AssertionError(f"band kernel disagrees: {checks[-1]}")

    # per-layer, per-pass times at the served square batch (MAX_BATCH
    # pairs; the band runs its two symmetric passes one after the other)
    _, idx = real_band(MAX_BATCH, (g, g), (g, g), BAND_K, seed=30)
    geoms = band_geometries(idx, (g, g))
    layers = []
    for li, (cin, cout) in enumerate(NC_LAYERS):
        for name, geom in geoms.items():
            x, w, b = band_layer_inputs(MAX_BATCH, geom.indices[0].numel(), cin,
                                        cout, torch.float32, seed=40 + li)
            ms = time_ms(lambda: band_kernel_call(band_gemm_fwd, x, w, b, geom),
                         reps=20)
            dev_ms = device_ms(
                lambda: band_kernel_call(band_gemm_fwd, x, w, b, geom),
                "band_nc_fwd", reps=20)
            call_ms = host_ms(
                lambda: band_kernel_call(band_gemm_fwd, x, w, b, geom), reps=20)
            plain_ms = time_ms(lambda: band_plain(x, w, b, geom), reps=3)
            got = band_kernel_call(band_gemm_fwd, x, w, b, geom)
            bitwise = bool(torch.equal(
                band_kernel_call(band_gemm_fwd, x, w, b, geom), got))
            want = band_plain(x, w, b, geom)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = err <= BAND_TOL[torch.float32] * scale and bitwise
            layers.append({"layer": li, "pass": name, "shape": list(x.shape),
                           "cin": cin, "cout": cout, "dtype": "float32",
                           "ms": ms, "device_ms": dev_ms, "host_ms": call_ms,
                           "plain_ms": plain_ms,
                           "max_abs_err": err, "max_rel_err": err / scale,
                           "bitwise_repeat": bitwise,
                           "ok": ok, **band_bound_ms(geom, cin, cout, torch.float32)})
            if not ok:
                emit({"phase": "band_kernels", "checks": checks, "timed": layers})
                raise AssertionError(
                    f"band kernel disagrees at the served batch: {layers[-1]}")
    emit({"phase": "band_kernels", "card": smi, "checks": checks,
          "timed": layers})
    return layers


def phase_serve_band(smi, model, config, conv4d_fwd, band_gemm_fwd, band_plain):
    """Serve with a dense standard and a K-band degraded program; returns
    the band kernel's launches over the served batches."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
    from ncnet_tpu_torch.serve.step import make_match_fn, make_serve_match_step

    band_config = config.replace(nc_topk=BAND_K)
    served = []  # (program, key, first pixel of each row) per batch run

    def recording(apply, name):
        def fn(m, batch):
            src = batch["source_image"]
            served.append((name, (tuple(src.shape[1:3]),
                                  tuple(batch["target_image"].shape[1:3])),
                           src[:, 0, 0, 0].clone()))
            return apply(m, batch)
        return fn

    image = image_maker(SEED + 1)
    requests = [(SQUARE_HW, SQUARE_HW)] * 5 + [(SQUARE_HW, RECT_HW)] * 3 \
        + [(SQUARE_HW, SQUARE_HW)] * 2
    variants = ["degraded"] * 8 + [None] * 2
    payloads = [{"source_image": image(s), "target_image": image(t)}
                for s, t in requests]
    with ServeEngine(recording(make_serve_match_step(config), "standard"), model,
                     device="cuda", max_batch=MAX_BATCH, max_wait=0.05,
                     degraded_apply_fn=recording(
                         make_serve_match_step(band_config), "degraded"),
                     ) as engine:
        t_warm = time.perf_counter()
        engine.warmup([((SQUARE_HW, SQUARE_HW), payload_spec(payloads[0])),
                       ((SQUARE_HW, RECT_HW), payload_spec(payloads[5]))])
        warmup_s = time.perf_counter() - t_warm
        served.clear()
        with counting_pointer_builds() as tables:
            conv4d_fwd.launches = band_gemm_fwd.launches = 0
            t_serve = time.perf_counter()
            futures = run_clients(engine, requests, payloads, variants)
            results = [f.result(timeout=600) for f in futures]  # raises on a failed future
            serve_s = time.perf_counter() - t_serve
            band_launches, conv_launches = band_gemm_fwd.launches, conv4d_fwd.launches
    report = engine.report()

    check_matches(requests, results)
    n_deg = sum(1 for name, _, _ in served if name == "degraded")
    n_std_sq = sum(1 for name, key, _ in served
                   if name == "standard" and key == (SQUARE_HW, SQUARE_HW))
    n_std_rect = len(served) - n_deg - n_std_sq
    if report["failed"] or report["completed"] != len(requests):
        raise AssertionError(f"serving failed: {report}")
    if n_deg == 0 or report["degraded_batches"] != n_deg:
        raise AssertionError(f"degraded batches {n_deg}, report {report}")
    if band_launches != 6 * n_deg:
        raise AssertionError(
            f"band launches {band_launches} != 6 x {n_deg} degraded batches")
    if tables[0] != 0:
        raise AssertionError(
            f"the served band batches built {tables[0]} pointer tables; the "
            "kernel derives its taps from the band and needs none")
    if conv_launches != 3 * n_std_sq + 6 * n_std_rect:
        raise AssertionError(
            f"conv4d launches {conv_launches} != 3 x {n_std_sq} square + 6 x "
            f"{n_std_rect} rectangular standard batches")

    # one degraded request of each bucket: the served row against the same
    # request's band forward at the served batch's padded size (the trunk's
    # float32 sums change with the batch size at the ulp level, which can
    # swap near-tied entries at the band's edge), and the band forward with
    # the kernel against the same forward with the plain band layer
    agree = []
    match_fn = make_match_fn(band_config)
    for idx in (0, 5):
        pixel = float(payloads[idx]["source_image"][0, 0, 0])
        (bs,) = [len(rows) for name, _, rows in served if name == "degraded"
                 and bool((rows == pixel).any())]
        src = torch.from_numpy(payloads[idx]["source_image"][None]).cuda()
        tgt = torch.from_numpy(payloads[idx]["target_image"][None]).cuda()
        with torch.inference_mode():
            lone = match_fn(model, src.repeat(bs, 1, 1, 1),
                            tgt.repeat(bs, 1, 1, 1))[:, 0].cpu().numpy()
            served_err = float(np.abs(results[idx]["matches"][4] - lone[4]).max())
            served_ok = served_err <= SERVE_TOL * float(np.abs(lone[4]).max())
            corr_k = immatchnet_apply(model, band_config, src, tgt)
            layer = model.neigh_consensus.band_layer
            model.neigh_consensus.band_layer = band_plain
            try:
                corr_p = immatchnet_apply(model, band_config, src, tgt)
            finally:
                model.neigh_consensus.band_layer = layer
            scale = float(corr_p.abs().max())
            corr_err = float((corr_k - corr_p).abs().max())
            idx_ok = argmax_agrees(corr_k, corr_p)
            ok = corr_err <= SERVE_TOL * scale and idx_ok and served_ok
        agree.append({"request": idx, "bucket": [list(requests[idx][0]),
                                                 list(requests[idx][1])],
                      "served_batch": bs, "served_vs_same_batch_score_err": served_err,
                      "corr_max_abs_err": corr_err, "corr_scale": scale,
                      "argmax_agree": idx_ok, "ok": ok})
        if not ok:
            raise AssertionError(f"band kernel path disagrees with the plain path: {agree[-1]}")
    emit({"phase": "serve_band", "card": smi, "config": band_config.to_dict(),
          "requests": len(requests), "pinned_degraded": variants.count("degraded"),
          "degraded_batches": n_deg, "standard_square_batches": n_std_sq,
          "standard_rect_batches": n_std_rect, "band_launches": band_launches,
          "pointer_tables_built": tables[0],
          "conv4d_launches": conv_launches, "warmup_s": warmup_s,
          "serve_s": serve_s, "pairs_per_s": report["pairs_per_s"],
          "latency_p50_ms": report["latency_p50_ms"],
          "latency_p95_ms": report["latency_p95_ms"],
          "degrade_flips": report["degrade_flips"], "agreement": agree,
          "stages_ms": band_stage_breakdown(model, band_config,
                                            payloads[:MAX_BATCH])})
    return band_launches


def band_stage_breakdown(model, config, payloads, reps=3):
    """CUDA-event times of the band serving forward's stages on one square
    batch (``len(payloads)`` pairs), each timed alone after a warm-up. The
    NC stage builds no pointer table (its kernel derives the taps from the
    band): the stages are timed under a call counter on
    ``band_neighbor_pointers``, which must read 0."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.serve.step import make_serve_match_step
    from ncnet_tpu_torch.sparse import (
        band_mutual_matching,
        resolve_band_width,
        sparse_corr_to_dense,
        sparse_neigh_consensus_apply,
    )

    batch = {k: torch.from_numpy(np.stack([p[k] for p in payloads])).cuda()
             for k in payloads[0]}
    apply = make_serve_match_step(config)
    params = model.neigh_consensus.params()
    with torch.inference_mode():
        fa = extract_features(model, config, batch["source_image"])
        fb = extract_features(model, config, batch["target_image"])
        grid_b = (fb.shape[1], fb.shape[2])
        k = resolve_band_width(config.nc_topk, grid_b)

        def select():
            corr = correlation_4d(fa, fb)
            return topk_band(corr, k, values_from=mutual_matching(corr),
                             mutual=config.nc_topk_mutual)

        values, indices = select()

        def nc():
            return sparse_neigh_consensus_apply(
                params, values, indices, grid_b, symmetric=config.symmetric_mode)

        band = nc()

        def readout():
            c = sparse_corr_to_dense(
                band_mutual_matching(band, indices, grid_b).float(), indices, grid_b)
            kw = dict(scale="positive", do_softmax=True)
            return torch.cat([torch.stack(corr_to_matches(c, **kw)),
                              torch.stack(corr_to_matches(
                                  c, invert_matching_direction=True, **kw))], 2)

        with counting_pointer_builds() as tables:
            stages = {
                "pairs": len(payloads),
                "trunk": time_ms(lambda: (
                    extract_features(model, config, batch["source_image"]),
                    extract_features(model, config, batch["target_image"])), reps),
                "corr_mm_topk": time_ms(select, reps),
                "neigh_consensus": time_ms(nc, reps),
                "band_mm_readout": time_ms(readout, reps),
                "forward": time_ms(lambda: apply(model, batch), reps),
            }
    if tables[0] != 0:
        raise AssertionError(f"the band forward built {tables[0]} pointer tables")
    return {**stages, "pointer_tables_built": tables[0]}


def phase_full_k(smi, model, config, conv4d_fwd, band_gemm_fwd):
    """At 192 px the complete band (K = hB*wB) through the band kernel
    equals the dense forward through the conv4d kernel."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply

    image = image_maker(SEED + 2)
    checks = []
    for tgt_hw in ((192, 192), (144, 192)):
        src = torch.from_numpy(np.stack([image((192, 192)) for _ in range(2)])).cuda()
        tgt = torch.from_numpy(np.stack([image(tgt_hw) for _ in range(2)])).cuda()
        k = (tgt_hw[0] // 16) * (tgt_hw[1] // 16)
        conv0, band0 = conv4d_fwd.launches, band_gemm_fwd.launches
        with torch.inference_mode():
            dense = immatchnet_apply(model, config, src, tgt)
            band = immatchnet_apply(model, config.replace(nc_topk=k), src, tgt)
        scale = float(dense.abs().max())
        err = float((band - dense).abs().max())
        launched = (conv4d_fwd.launches - conv0, band_gemm_fwd.launches - band0)
        ok = err <= SERVE_TOL * scale and launched[1] == 6 and launched[0] > 0
        checks.append({"source_hw": [192, 192], "target_hw": list(tgt_hw),
                       "k": k, "max_abs_err": err, "scale": scale,
                       "conv4d_launches": launched[0],
                       "band_launches": launched[1], "ok": ok})
        if not ok:
            emit({"phase": "full_k", "checks": checks})
            raise AssertionError(f"full-K band != dense: {checks[-1]}")
    emit({"phase": "full_k", "card": smi, "tol_rel": SERVE_TOL, "checks": checks})


def phase_train_kernels(smi, kernels, fwd_plain, dx_plain, dw_plain):
    """The dx and dw kernels against their plain versions at every training
    layer shape, float32 and bfloat16; then the forward, dx and dw timed at
    the training batch, each held to its tolerance, the forward and dw to
    a bitwise repeat. Returns ``(fwd_layers, dx_layers, dw_layers)`` of
    timed records."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = GRID
    dx_layers = NC_LAYERS[1:]  # layer 1's input is the correlation: no dx
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for li, (cin, cout) in enumerate(NC_LAYERS):
            shape = (2, g, g, g, g)
            x, w, _ = nc_inputs(shape, cin, cout, dtype, seed=50 + li)
            gr = torch.randn(*shape, cout, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(60 + li)).to(dtype)
            results = [("dw", kernels["conv4d_dw"](x, gr, KSIZE),
                        dw_plain(x, gr, KSIZE), DW_TOL[dtype])]
            if (cin, cout) in dx_layers:
                results.append(("dx", kernels["conv4d_dx"](gr, w).float(),
                                dx_plain(gr.float(), w.float()), TOL[dtype]))
            torch.cuda.synchronize()
            for name, got, want, tol in results:
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= tol * scale
                checks.append({"kernel": name, "layer": li, "cin": cin,
                               "cout": cout, "dtype": str(dtype).split(".")[1],
                               "max_abs_err": err, "max_rel_err": err / scale,
                               "tol_rel": tol, "ok": ok})
                if not ok:
                    emit({"phase": "train_kernels", "checks": checks})
                    raise AssertionError(f"conv4d {name} kernel disagrees: {checks[-1]}")

    # per-layer times at the training batch, in the training path's dtype
    dtype = torch.bfloat16
    shape = (TRAIN_SAMPLES, g, g, g, g)
    timed = {"fwd": [], "dx": [], "dw": []}
    for li, (cin, cout) in enumerate(NC_LAYERS):
        x, w, b = nc_inputs(shape, cin, cout, dtype, seed=70 + li)
        gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(80 + li)).to(dtype)
        # (name, kernel, plain version as timed, reference as in the
        # 2-sample checks, tolerance of the reference's scale)
        runs = [("fwd", lambda: kernels["conv4d_fwd"](x, w, b),
                 lambda: fwd_plain(x, w, b),
                 lambda: fwd_plain(x.float(), w.float(), b), TOL[dtype]),
                ("dw", lambda: kernels["conv4d_dw"](x, gr, KSIZE),
                 lambda: dw_plain(x, gr, KSIZE), lambda: dw_plain(x, gr, KSIZE),
                 DW_TOL[dtype])]
        if (cin, cout) in dx_layers:
            runs.append(("dx", lambda: kernels["conv4d_dx"](gr, w),
                         lambda: dx_plain(gr, w),
                         lambda: dx_plain(gr.float(), w.float()), TOL[dtype]))
        for name, kern, plain, reference, tol in runs:
            ms = time_ms(kern, reps=3)
            plain_ms = time_ms(plain, reps=1)
            # at this batch the dw kernel runs another chunk and reduction
            # plan than at 2 samples, so it is held to its tolerance here too
            got, again = kern(), kern()
            # one thread sums each output in a fixed order, no atomics
            bitwise = bool(torch.equal(got, again))
            del again
            got, want = got.float(), reference().float()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = (bool(torch.isfinite(got).all()) and err <= tol * scale
                  and (bitwise or name == "dx"))
            del got, want
            # dx is a convolution of g (cout channels) into cin channels:
            # the same multiply-adds on the grid as the forward
            bms, by, flops = (dw_bound_ms if name == "dw" else bound_ms)(
                shape, cin, cout, dtype)
            timed[name].append({
                "layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "gflop": flops / 1e9,
                "tflops": flops / ms / 1e9, "max_abs_err": err,
                "max_rel_err": err / scale, "tol_rel": tol,
                "bitwise_repeat": bitwise, "ok": ok})
            torch.cuda.empty_cache()
            if not ok:
                emit({"phase": "train_kernels", "checks": checks, "timed": timed})
                raise AssertionError(
                    f"conv4d {name} kernel disagrees at the training batch: "
                    f"{timed[name][-1]}")
    wide = dw_wide_grid(kernels["conv4d_dw"], dw_plain)
    emit({"phase": "train_kernels", "card": smi, "checks": checks,
          "timed": timed, "dw_48x48": wide})
    return timed["fwd"], timed["dx"], timed["dw"]


def dw_wide_grid(conv4d_dw, dw_plain):
    """dw on the 48x48 grid of 768 px, where a block stages a window of
    k-rows (a whole-grid staging no longer fits): each layer and dtype at
    1 sample against the plain version (DW_TOL of max |dw|) with a bitwise
    repeat, and the bfloat16 kernel timed at the 4 samples of one 768 px
    pipeline call (2 pairs x 2 directions)."""
    g = WIDE_GRID
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for li, (cin, cout) in enumerate(NC_LAYERS):
            shape = (1, g, g, g, g)
            x, _, _ = nc_inputs(shape, cin, cout, dtype, seed=90 + li)
            gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(95 + li)).to(dtype)
            got, again = conv4d_dw(x, gr, KSIZE), conv4d_dw(x, gr, KSIZE)
            want = dw_plain(x, gr, KSIZE)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            bitwise = bool(torch.equal(got, again))
            ok = (bool(torch.isfinite(got).all()) and err <= DW_TOL[dtype] * scale
                  and bitwise)
            rec = {"layer": li, "cin": cin, "cout": cout, "grid": g,
                   "dtype": str(dtype).split(".")[1], "max_abs_err": err,
                   "max_rel_err": err / scale, "tol_rel": DW_TOL[dtype],
                   "bitwise_repeat": bitwise, "ok": ok}
            del x, gr, got, again, want
            if dtype == torch.bfloat16:
                shape = (4, g, g, g, g)
                x, _, _ = nc_inputs(shape, cin, cout, dtype, seed=97 + li)
                gr = torch.randn(*shape, cout, device="cuda").to(dtype)
                rec["ms_4_samples"] = time_ms(lambda: conv4d_dw(x, gr, KSIZE), reps=3)
                del x, gr
            records.append(rec)
            torch.cuda.empty_cache()
            if not ok:
                emit({"phase": "train_kernels", "dw_48x48": records})
                raise AssertionError(f"conv4d dw disagrees on the 48x48 grid: {rec}")
    return records


def phase_synthetic_kernels(smi, kernels, fwd_plain, dx_plain, dw_plain):
    """The forward, dx and dw kernels at the synthetic convergence run's
    own shapes (`SYNTH_SHAPE`, 3^4), float32 and bfloat16 as it trains in
    both: each against its plain version on the same inputs (forward and
    dx in float32, TOL; dw, DW_TOL) with a bitwise repeat, timed beside the
    plain version in the kernel's dtype and the bound. Returns ``{"fwd",
    "dx", "dw"}`` lists of records."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, ks = SYNTH_SHAPE, SYNTH_KS
    timed = {"fwd": [], "dx": [], "dw": []}
    for dtype in (torch.float32, torch.bfloat16):
        for li, (cin, cout) in enumerate(SYNTH_LAYERS):
            x, w, b = nc_inputs(shape, cin, cout, dtype, seed=120 + li, ks=ks)
            gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(125 + li)).to(dtype)
            # (name, kernel, plain version as timed, reference, tolerance
            # of the reference's scale, bound)
            runs = [("fwd", lambda: kernels["conv4d_fwd"](x, w, b),
                     lambda: fwd_plain(x, w, b),
                     lambda: fwd_plain(x.float(), w.float(), b), TOL[dtype], bound_ms),
                    ("dw", lambda: kernels["conv4d_dw"](x, gr, ks),
                     lambda: dw_plain(x, gr, ks), lambda: dw_plain(x, gr, ks),
                     DW_TOL[dtype], dw_bound_ms)]
            if li > 0:
                runs.append(("dx", lambda: kernels["conv4d_dx"](gr, w),
                             lambda: dx_plain(gr, w),
                             lambda: dx_plain(gr.float(), w.float()), TOL[dtype],
                             bound_ms))
            for name, kern, plain, reference, tol, bound in runs:
                ms = time_ms(kern, reps=5)
                plain_ms = time_ms(plain, reps=5)
                got, again = kern(), kern()
                bitwise = bool(torch.equal(got, again))
                got, want = got.float(), reference().float()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= tol * scale and bitwise
                bms, by, flops = bound(shape, cin, cout, dtype, ks)
                timed[name].append({
                    "layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                    "ks": ks, "dtype": str(dtype).split(".")[1], "path": "eval",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "gflop": flops / 1e9,
                    "tflops": flops / ms / 1e9, "max_abs_err": err,
                    "max_rel_err": err / scale, "tol_rel": tol,
                    "bitwise_repeat": bitwise, "ok": ok})
                if not ok:
                    emit({"phase": "synthetic_kernels", "timed": timed})
                    raise AssertionError(
                        f"conv4d {name} kernel disagrees at the synthetic run's "
                        f"shape: {timed[name][-1]}")
    emit({"phase": "synthetic_kernels", "card": smi, "timed": timed})
    return timed


def nc_grads(model, config, batch, objective, dtype=None):
    """An objective and its NC gradients for ``batch``; with ``dtype`` the
    correlation and the NC stack run in it.

    ``objective``: ``"score"``, the positive term of the weak loss,
    ``-match_score(corr_pos)`` (the weak loss itself is no test: on a
    random trunk its two terms cancel to about 1e-8 against scores of
    about 1.6e-3, so its gradient is float32 rounding); or a fixed random
    ``[b, 25, 25, 25, 25]`` tensor dotted with the NC stack's output,
    which holds the stack's gradients without the softmax and max."""
    from ncnet_tpu_torch.models.immatchnet import extract_features, match_pipeline
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.train.loss import match_score

    leaves = model.neigh_consensus.trainable()
    for t in leaves:
        t.grad = None
    fa = extract_features(model, config, batch["source_image"])
    fb = extract_features(model, config, batch["target_image"])
    if dtype is not None:
        fa, fb = fa.to(dtype), fb.to(dtype)
    if objective == "score":
        loss = -match_score(match_pipeline(model.neigh_consensus, config, fa, fb))
    else:
        out = model.neigh_consensus(mutual_matching(correlation_4d(fa, fb)))
        r = torch.randn(out.shape, device=out.device, generator=torch.Generator(
            device=out.device).manual_seed(SEED + 5))
        loss = (out * r.to(out.dtype)).sum() / out.numel()
    loss.backward()
    return float(loss.detach()), [t.grad.clone() for t in leaves]


def synthetic_batch(n, seed, hw=SQUARE_HW):
    """``n`` pairs of `SyntheticPairDataset` at ``hw``, on the card."""
    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.train.step import device_batch

    ds = SyntheticPairDataset(n=n, output_size=hw, seed=seed)
    return device_batch(collate([ds[i] for i in range(n)]), "cuda")


def train_stage_breakdown(model, config, batch, optimizer):
    """CUDA-event times of one training step's stages, in order, on one
    batch: trunk (both images), correlation + MM (both pipelines), NC
    forward (both pipelines), post-NC MM + scores + loss, backward,
    optimizer; and the whole step."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.train.loss import match_score_per_sample

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    dtype = torch.bfloat16 if config.half_precision else torch.float32
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ev[0].record()
    fa = extract_features(model, config, batch["source_image"])
    fb = extract_features(model, config, batch["target_image"])
    ev[1].record()
    corrs = [mutual_matching(correlation_4d(a, fb)).to(dtype)
             for a in (fa, torch.roll(fa, -1, 0))]
    ev[2].record()
    filtered = [model.neigh_consensus(c) for c in corrs]
    ev[3].record()
    pos, neg = (match_score_per_sample(mutual_matching(c).float()) for c in filtered)
    loss = neg.mean() - pos.mean()
    ev[4].record()
    loss.backward()
    ev[5].record()
    optimizer.step()
    ev[6].record()
    ev[6].synchronize()
    names = ("trunk", "correlation_mm", "neigh_consensus_forward",
             "mm_score_loss", "backward", "optimizer")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["step"] = ev[0].elapsed_time(ev[6])
    return out


def phase_train(smi, model, config, kernels, conv4d_plain):
    """Gradient check, 3 trainer steps at the PF-Pascal config, the CLI;
    returns the launches of the 3 steps per kernel."""
    from ncnet_tpu_torch.data.loader import DataLoader
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet
    from ncnet_tpu_torch.train.checkpoint import load_checkpoint, restore
    from ncnet_tpu_torch.train.step import (
        create_train_state,
        device_batch,
        make_train_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # (a) NC gradients at full width, 2 pairs, float32 through the kernels
    # against the plain differentiable conv4d (cuDNN conv3d + autograd) in
    # float64; the same plain version in float32 is reported beside it
    f32 = config.replace(half_precision=False)
    batch = synthetic_batch(2, SEED + 3)
    grad_check = []
    for objective in ("linear", "score"):
        loss_k, grads_k = nc_grads(model, f32, batch, objective)
        conv = model.neigh_consensus.conv
        model.neigh_consensus.conv = conv4d_plain
        try:
            loss_p, grads_p = nc_grads(model, f32, batch, objective, torch.float64)
            _, grads_p32 = nc_grads(model, f32, batch, objective)
        finally:
            model.neigh_consensus.conv = conv
        for i, (gk, gp, g32) in enumerate(zip(grads_k, grads_p, grads_p32)):
            # the scale is the layer's (kernel and bias together): the last
            # layer's bias gradient is a sum over every output position
            # that nearly cancels, so its own max is no scale for rounding
            layer = grads_p[i - i % 2:i - i % 2 + 2]
            scale = max(float(t.abs().max()) for t in layer)
            err = float((gk - gp).abs().max())
            err32 = float((g32 - gp).abs().max())
            grad_check.append({
                "objective": objective,
                "tensor": f"layer{i // 2}.{('kernel', 'bias')[i % 2]}",
                "max_abs_err": err, "scale": scale,
                "plain_f32_max_abs_err": err32, "loss": [loss_k, loss_p],
                "ok": (bool(torch.isfinite(gk).all())
                       and err <= max(GRAD_RATIO * err32, GRAD_TOL * scale)
                       and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p))})
    if not all(c["ok"] for c in grad_check):
        emit({"phase": "train", "grad_check": grad_check})
        raise AssertionError(f"NC gradients through the kernels disagree: {grad_check}")
    for t in model.neigh_consensus.trainable():
        t.grad = None

    # (b) 3 trainer steps at the full configuration, bfloat16
    bf16 = config.replace(half_precision=True)
    ds = SyntheticPairDataset(n=TRAIN_BATCH * (TRAIN_STEPS + 1),
                              output_size=SQUARE_HW, seed=SEED + 4)
    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True, seed=SEED, num_workers=4,
                        drop_last=True)
    batches = [device_batch(b, "cuda") for b in loader.iter_epoch(0)]
    trunk0 = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    nc0 = [t.detach().clone() for t in model.neigh_consensus.trainable()]
    state = create_train_state(model, 5e-4)
    step = make_train_step(bf16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for name in kernels:
        kernels[name].launches = 0
    for b in batches[:TRAIN_STEPS]:
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({n: k.launches - before[n] for n, k in kernels.items()})
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {"conv4d_fwd": 6, "conv4d_dx": 4, "conv4d_dw": 6, "band_gemm_fwd": 0}
    problems = []
    if any(p != want for p in per_step):
        problems.append(f"launches per step {per_step} != {want}")
    if not all(l.dtype == torch.float32 and l.shape == () and bool(torch.isfinite(l))
               for l in losses):
        problems.append(f"losses not finite float32 scalars: {losses}")
    for t in state.optimizer.param_groups[0]["params"]:
        st = state.optimizer.state[t]
        if not (t.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32):
            problems.append("master weights or Adam state not float32")
    moved = [float((t.detach() - t0).abs().max()) for t, t0 in
             zip(state.optimizer.param_groups[0]["params"], nc0)]
    # every NC tensor must move but the last layer's bias: its gradient is
    # one sum over every output position, and on a random trunk the weak
    # loss's positive and negative terms cancel in it below bfloat16's
    # resolution once each is rounded to the bias's dtype (as in the JAX
    # package), so it can be exactly zero
    if not all(m > 0 for m in moved[:-1]):
        problems.append(f"NC tensors other than layer 3's bias did not move: {moved}")
    if not all(torch.equal(v, trunk0[k])
               for k, v in model.feature_extraction.state_dict().items()):
        problems.append("the trunk changed")
    stages = train_stage_breakdown(model, bf16, batches[TRAIN_STEPS], state.optimizer)
    if problems:
        emit({"phase": "train", "problems": problems})
        raise AssertionError("; ".join(problems))

    # (c) one step at 768 px (48x48 grids), batch 2: dw stages windows
    wide_batch = synthetic_batch(2, SEED + 6, WIDE_HW)
    torch.cuda.synchronize()
    before = {n: k.launches for n, k in kernels.items()}
    t0 = time.perf_counter()
    state, wide_loss = step(state, wide_batch)
    torch.cuda.synchronize()
    wide = {"hw": list(WIDE_HW), "batch": 2, "loss": float(wide_loss),
            "step_ms": (time.perf_counter() - t0) * 1e3,
            "launches": {n: k.launches - before[n] for n, k in kernels.items()}}
    del wide_batch
    torch.cuda.empty_cache()
    if wide["launches"] != want or not bool(torch.isfinite(wide_loss)):
        emit({"phase": "train", "wide_step": wide})
        raise AssertionError(f"the 768 px step failed: {wide}")

    # (d) the CLI in a subprocess; its checkpoint must load
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "ncnet_tpu_torch.train", "--synthetic",
             "--allow_random_fe", "--max-steps", "2", "--result_model_dir", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if proc.returncode != 0:
            raise AssertionError(f"training CLI failed (rc {proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        ck = load_checkpoint(report["checkpoint"])
        cli_model = ImMatchNet(ck.config, device="cuda")
        restore(create_train_state(cli_model), ck)
        restored = all(np.array_equal(t.detach().cpu().numpy(), np.asarray(ref))
                       for p, ref_p in zip(cli_model.neigh_consensus.params(),
                                           ck.params["neigh_consensus"])
                       for t, ref in ((p["kernel"], ref_p["kernel"]),
                                      (p["bias"], ref_p["bias"])))
        cli = {k: report[k] for k in ("steps", "step_losses", "step_ms",
                                      "peak_memory_bytes", "kernel_launches")}
        cli["checkpoint_bytes"] = os.path.getsize(report["checkpoint"])
    if not (report["steps"] == 2 and ck.step == 2 and restored
            and report["kernel_launches"] == {"conv4d_fwd": 12, "conv4d_dx": 8,
                                              "conv4d_dw": 12}):
        raise AssertionError(f"training CLI report or checkpoint wrong: {cli}")
    emit({"phase": "train", "card": smi, "config": bf16.to_dict(),
          "batch": TRAIN_BATCH, "grad_check": grad_check, "losses": [float(l) for l in losses],
          "step_ms": step_ms, "launches_per_step": per_step,
          "launches": launches, "nc_param_max_move": moved,
          "peak_memory_bytes": peak, "stages_ms": stages, "wide_step": wide,
          "cli": cli})
    return launches


def pf_pascal_pairs(n, seed):
    """``n`` generated PF-Pascal samples (`pf_pascal_sample`, 'scnet'
    procedure, 400 px): a smooth random texture of a PF-Pascal image size
    as the source, the source rolled right by a known shift as the target,
    and 6-12 keypoints in the target's right half with their source
    positions, written in the CSV's ``x1;x2;...`` columns."""
    from ncnet_tpu_torch.data.images import resize_bilinear_np
    from ncnet_tpu_torch.data.pairs import pf_pascal_sample

    rng = np.random.RandomState(seed)
    sizes = ((300, 500), (375, 500), (500, 333), (400, 400))
    samples = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        base = rng.rand(h // 8, w // 8, 3).astype(np.float32) * 255.0
        src = resize_bilinear_np(base, h, w)
        shift = rng.randint(0, w // 4)
        tgt = np.roll(src, shift, axis=1)
        m = rng.randint(6, 13)
        xb = rng.uniform(0.55 * w, 0.95 * w, m)
        yb = rng.uniform(0.1 * h, 0.9 * h, m)

        def col(v):
            return ";".join(f"{x:.4f}" for x in v)

        row = [f"src{i}.jpg", f"tgt{i}.jpg", str(1 + i % 20), col(xb - shift),
               col(yb), col(xb), col(yb)]
        samples.append(pf_pascal_sample(src, tgt, row, output_size=SQUARE_HW))
    return samples


def pair_tensors(batch, j):
    """Pair ``j`` of a collated numpy batch as ``[1, h, w, 3]`` CUDA tensors."""
    return tuple(torch.from_numpy(np.asarray(batch[k][j:j + 1], np.float32)).cuda()
                 for k in ("source_image", "target_image"))


def pair_readouts(model, config, batches, conv_attr, plain):
    """Every pair of ``batches`` through the forward with the kernels and
    again with ``plain`` as the NC head's ``conv_attr``: per pair, whether
    the kernel's readout agrees with the plain one up to ties
    (`argmax_agrees`) and whether its picks are identical."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
    from ncnet_tpu_torch.ops.matches import corr_to_matches

    nc = model.neigh_consensus
    agree, identical = [], []
    for batch in batches:
        for j in range(len(batch["source_image"])):
            src, tgt = pair_tensors(batch, j)
            with torch.inference_mode():
                corr_k = immatchnet_apply(model, config, src, tgt)
                kept = getattr(nc, conv_attr)
                setattr(nc, conv_attr, plain)
                try:
                    corr_p = immatchnet_apply(model, config, src, tgt)
                finally:
                    setattr(nc, conv_attr, kept)
                agree.append(argmax_agrees(corr_k, corr_p))
                same = True
                for invert in (False, True):
                    picks = [torch.stack(corr_to_matches(
                        c, do_softmax=True, scale="positive",
                        invert_matching_direction=invert, return_indices=True)[5:])
                        for c in (corr_k, corr_p)]
                    same &= bool(torch.equal(*picks))
                identical.append(same)
    return agree, identical


def pck_readout_problems(label, results, agree, identical):
    """A pair's readout must agree with the plain one up to ties, and its
    PCK (over ``results``, lists over the same pairs) may differ only
    where a tie went the other way (picks not identical). Returns the
    problems and the pairs whose PCK differs."""
    ref = np.asarray(results[0])
    differ = sorted({int(i) for r in results[1:] for i in
                     np.flatnonzero(np.abs(np.asarray(r) - ref) > 1e-6)})
    problems = [f"{label} pair {i}: the kernel's readout is not the plain one "
                "up to ties" for i, ok in enumerate(agree) if not ok]
    problems += [f"{label} pair {i}: PCK differs ({[r[i] for r in results]}) "
                 "with identical readout picks" for i in differ if identical[i]]
    return problems, differ


def phase_eval(smi, config, kernels, conv4d_plain, band_plain):
    """(a) The synthetic convergence run at its defaults, float32 and
    bfloat16, through the kernels; (b) PF-Pascal PCK at the PF-Pascal config
    on generated keypointed pairs through `evaluate`, `evaluate_serving` and
    `pck_vs_topk` at K = BAND_K: every pair's readout, dense and on the
    band, agrees with the plain kernels' up to ties, and its PCK equals
    theirs unless a tie went the other way. Returns the launches of the
    main path's run."""
    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.eval import pf_pascal, synthetic
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet

    for k in kernels.values():
        k.launches = 0
    convergence = {}
    for name, half in (("float32", False), ("bfloat16", True)):
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        out = synthetic.run(device="cuda", half_precision=half, verbose=False)
        rec = {k: out[k] for k in ("loss_first", "loss_last", "loss_deciles",
                                   "pck_before", "pck_after",
                                   "pck_diagonal_baseline")}
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = {n: k.launches - before[n] for n, k in kernels.items()}
        rec["ok"] = (out["loss_last"] < out["loss_first"]
                     and out["pck_after"] >= out["pck_before"] + SYNTH_MARGIN
                     and out["pck_after"] >= out["pck_diagonal_baseline"] + SYNTH_MARGIN
                     and all(rec["launches"][n] > 0 for n in
                             ("conv4d_fwd", "conv4d_dx", "conv4d_dw")))
        convergence[name] = rec
        del out
    if not all(r["ok"] for r in convergence.values()):
        emit({"phase": "eval", "synthetic": convergence})
        raise AssertionError(f"synthetic convergence not shown: {convergence}")

    # centred features (as the synthetic convergence): the random trunk's
    # uncentred features correlate almost uniformly, and the dense readout
    # then matched no keypoint of any pair (with the identity NC init
    # too), which could not show a readout flip
    config = config.replace(center_features=True)
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    samples = pf_pascal_pairs(PF_PAIRS, SEED + 7)
    batches = [collate(samples[i:i + MAX_BATCH])
               for i in range(0, PF_PAIRS, MAX_BATCH)]
    conv0, band0 = kernels["conv4d_fwd"].launches, kernels["band_gemm_fwd"].launches
    res_k = pf_pascal.evaluate(model, config, batches, verbose=False)
    pf_launches = kernels["conv4d_fwd"].launches - conv0
    t0 = time.perf_counter()  # a second, warm pass: the batch time
    pf_pascal.evaluate(model, config, batches, verbose=False)
    eval_s = time.perf_counter() - t0
    res_s = pf_pascal.evaluate_serving(model, config, batches,
                                       max_batch=MAX_BATCH, verbose=False)
    res_b = pf_pascal.pck_vs_topk(model, config, batches, ks=[BAND_K])[BAND_K]
    band_launches = kernels["band_gemm_fwd"].launches - band0
    launches = {n: k.launches for n, k in kernels.items()}

    # the same evals with the plain versions of the kernels
    nc = model.neigh_consensus
    conv, layer = nc.conv, nc.band_layer
    nc.conv, nc.band_layer = conv4d_plain, band_plain
    try:
        res_p = pf_pascal.evaluate(model, config, batches, verbose=False)
        res_bp = pf_pascal.pck_vs_topk(model, config, batches, ks=[BAND_K])[BAND_K]
    finally:
        nc.conv, nc.band_layer = conv, layer
    agree, identical = pair_readouts(model, config, batches, "conv", conv4d_plain)
    problems, differ = pck_readout_problems(
        "dense", [res_p["per_pair"], res_k["per_pair"], res_s["per_pair"]],
        agree, identical)
    band_agree, band_identical = pair_readouts(
        model, config.replace(nc_topk=BAND_K), batches, "band_layer", band_plain)
    band_problems, band_differ = pck_readout_problems(
        f"K = {BAND_K}", [res_bp["per_pair"], res_b["per_pair"]],
        band_agree, band_identical)
    problems += band_problems
    n_batches = len(batches)
    if pf_launches != 3 * n_batches:
        problems.append(f"evaluate launched conv4d {pf_launches} times, not "
                        f"3 x {n_batches} square batches")
    if band_launches != 6 * n_batches:
        problems.append(f"pck_vs_topk launched the band kernel {band_launches} "
                        f"times, not 6 x {n_batches} batches")
    if res_s["serve"]["completed"] != PF_PAIRS or res_s["serve"]["failed"]:
        problems.append(f"evaluate_serving: {res_s['serve']}")
    if not (res_k["n_valid"] == res_p["n_valid"] == PF_PAIRS
            and all(np.isfinite(res_k["per_pair"]))):
        problems.append("PCK not valid for every pair")
    record = {"phase": "eval", "card": smi, "synthetic": convergence,
              "synthetic_margin": SYNTH_MARGIN,
              "pf_pascal": {
                  "config": config.to_dict(), "pairs": PF_PAIRS,
                  "batch": MAX_BATCH, "pck": res_k["pck"],
                  "per_pair": res_k["per_pair"],
                  "per_pair_plain": res_p["per_pair"],
                  "per_pair_served": res_s["per_pair"],
                  "readout_agrees": agree, "readout_identical": identical,
                  "pck_differing_pairs": differ,
                  "warm_eval_s": eval_s,
                  "ms_per_batch": 1e3 * eval_s / n_batches,
                  "serve": {k: res_s["serve"][k] for k in (
                      "batches", "mean_occupancy", "pairs_per_s",
                      "latency_p50_ms", "latency_p95_ms")},
                  "conv4d_launches": pf_launches},
              "pck_vs_topk": {"k": BAND_K, "pck": res_b["pck"],
                              "per_pair": res_b["per_pair"],
                              "per_pair_plain": res_bp["per_pair"],
                              "readout_agrees": band_agree,
                              "readout_identical": band_identical,
                              "pck_differing_pairs": band_differ,
                              "band_launches": band_launches},
              "launches": launches}
    emit(record)
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def texture(rng, hw, cell):
    """A smooth random uint8 RGB image of size ``hw``: noise on a grid of
    ``cell``-pixel cells, bilinearly upsampled."""
    from ncnet_tpu_torch.data.images import resize_bilinear_np, to_uint8_image

    h, w = hw
    base = rng.rand(h // cell, w // cell, 3).astype(np.float32) * 255.0
    return to_uint8_image(resize_bilinear_np(base, h, w))


def write_shortlist(path, queries):
    """An InLoc shortlist ``.mat`` (``ImgList[0, q]``: the query's file at
    field 0, its panos at field 1) for ``[(query, [panos])]``."""
    from scipy.io import savemat

    dt = np.dtype([("queryname", object), ("topN", object)])
    entries = np.zeros((1, len(queries)), dt)
    for q, (qname, panos) in enumerate(queries):
        entries[0, q] = (np.array([qname], object),
                         np.array([[p] for p in panos], object))
    savemat(path, {"ImgList": entries})


def inloc_readout_check(corr_k, corr_p):
    """The readout picks of the pooled ``corr_k`` (both directions) on the
    plain forward's ``corr_p``: returns the share of picks that differ
    from the plain ones and the largest shortfall of a pick below the
    plain best, relative to the plain scale. Where the two correlations
    differ by at most e, a pick can fall short by at most 2e: a larger
    shortfall is a readout fault, not a tie."""
    b, fs1, fs2, fs3, fs4 = corr_p.shape
    flat_k = corr_k.reshape(b, fs1 * fs2, fs3 * fs4)
    flat_p = corr_p.reshape(b, fs1 * fs2, fs3 * fs4)
    scale = float(corr_p.abs().max())
    differ, worst = 0, 0.0
    for dim in (1, 2):
        idx_k = flat_k.argmax(dim=dim, keepdim=True)
        idx_p = flat_p.argmax(dim=dim, keepdim=True)
        picked = torch.gather(flat_p, dim, idx_k)
        best = torch.gather(flat_p, dim, idx_p)
        differ += int((idx_k != idx_p).sum())
        worst = max(worst, float((best - picked).max()) / scale)
    return differ / (fs1 * fs2 + fs3 * fs4), worst


def phase_inloc(smi, kernels, conv4d_plain):
    """One generated query (4032x3024) against two generated panos
    (1600x1200) through `dump_matches` at the reference's InLoc settings;
    the .mat's contract; one pair's readout against the plain forward;
    the pair's stage times and each conv4d layer at the pooled grid
    against its plain version and bound. Returns ``(launches, layers)``."""
    from scipy.io import loadmat

    from ncnet_tpu_torch.data.images import resize_bilinear_np, to_uint8_image
    from ncnet_tpu_torch.eval import inloc
    from ncnet_tpu_torch.models.immatchnet import (
        ImMatchNet,
        ImMatchNetConfig,
        extract_features,
        immatchnet_apply,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_maxpool4d
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.ops.matching import mutual_matching

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(3, 3),
        ncons_channels=(16, 1), half_precision=True,
        relocalization_k_size=INLOC_K,
    )
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED + 8)
    query = texture(rng, QUERY_HW, 24)
    # pano 0 sees a part of the query's scene, pano 1 another scene
    qh, qw = QUERY_HW
    panos = [to_uint8_image(resize_bilinear_np(
                 query[int(0.3 * qh):int(0.67 * qh), int(0.17 * qw):int(0.83 * qw)],
                 *PANO_HW)),
             texture(rng, PANO_HW, 8)]
    n_slots = inloc.n_match_slots(INLOC_SIZE, INLOC_K, True)
    with tempfile.TemporaryDirectory() as root:
        np.save(os.path.join(root, "query.npy"), query)
        names = []
        for i, pano in enumerate(panos):
            names.append(f"pano{i}.npy")
            np.save(os.path.join(root, names[-1]), pano)
        shortlist = os.path.join(root, "shortlist.mat")
        write_shortlist(shortlist, [("query.npy", names)])
        out_dir = os.path.join(root, "matches")
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = inloc.dump_matches(
            model, config, shortlist, root, root, out_dir,
            image_size=INLOC_SIZE, n_queries=1, n_panos=len(panos),
            verbose=False, read_image=lambda p: np.load(p).astype(np.float32))
        dump_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        mat = loadmat(os.path.join(out_dir, "1.mat"))
    m = mat["matches"]
    filled = [int((np.abs(m[0, p]).sum(axis=1) > 0).sum()) for p in range(len(panos))]
    problems = []
    if m.shape != (1, len(panos), INLOC_SLOTS, 5) or n_slots != INLOC_SLOTS:
        problems.append(f".mat matches {m.shape}, want (1, 2, {INLOC_SLOTS}, 5)")
    if not (np.isfinite(m).all() and (m[..., :4] >= 0).all() and (m[..., :4] <= 1).all()):
        problems.append("non-finite or out-of-range matches")
    if not all(0 < f <= n_slots for f in filled):
        problems.append(f"filled slots {filled}")
    # a rectangular pair runs the NC net twice: 2 layers x 2 directions
    if launches["conv4d_fwd"] != 4 * len(panos) or done["pairs"] != len(panos):
        problems.append(f"conv4d launches {launches['conv4d_fwd']} != 4 x "
                        f"{len(panos)} pairs")

    # one pair: readout against the plain forward, and its stage times
    t0 = time.perf_counter()
    src = inloc.preprocess_image(query, INLOC_SIZE, INLOC_K)
    t1 = time.perf_counter()
    tgt = inloc.preprocess_image(panos[0], INLOC_SIZE, INLOC_K)
    prep_ms = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
    src, tgt = torch.from_numpy(src).cuda(), torch.from_numpy(tgt).cuda()
    nc = model.neigh_consensus

    def plain_bf16(x, w, b=None):
        return conv4d_plain(x.float(), w.float(), b).to(x.dtype)

    with torch.inference_mode():
        corr_k, delta_k = immatchnet_apply(model, config, src, tgt)
        conv = nc.conv
        nc.conv = plain_bf16
        try:
            corr_p, delta_p = immatchnet_apply(model, config, src, tgt)
        finally:
            nc.conv = conv
        differ_share, shortfall = inloc_readout_check(corr_k, corr_p)
        corr_err = float((corr_k - corr_p).abs().max() / corr_p.abs().max())
        kw = dict(scale="positive", do_softmax=True, k_size=INLOC_K)
        score_err = 0.0
        for invert in (False, True):
            s_k = corr_to_matches(corr_k, delta4d=delta_k,
                                  invert_matching_direction=invert, **kw)[4]
            s_p = corr_to_matches(corr_p, delta4d=delta_p,
                                  invert_matching_direction=invert, **kw)[4]
            score_err = max(score_err, float((s_k - s_p).abs().max() / s_p.abs().max()))
        deltas_equal = all(torch.equal(a, b) for a, b in zip(delta_k, delta_p))
    readout = {"pooled_grid": list(corr_k.shape), "corr_max_rel_err": corr_err,
               "picks_differing": differ_share, "max_shortfall_rel": shortfall,
               "score_max_rel_err": score_err, "deltas_equal": deltas_equal,
               "tol_rel": INLOC_TOL}
    if not (deltas_equal and corr_err <= INLOC_TOL
            and shortfall <= 2 * corr_err + 1e-6 and score_err <= INLOC_TOL
            and bool(torch.isfinite(corr_k).all())):
        problems.append(f"readout disagrees with the plain forward: {readout}")
    del corr_p, delta_p

    match_fn = inloc.make_match_fn(config, concat_directions=True)
    kw = dict(scale="positive", do_softmax=True, delta4d=delta_k, k_size=INLOC_K)
    with torch.inference_mode():
        fa = extract_features(model, config, src)
        fb = extract_features(model, config, tgt)
        pooled, _ = correlation_maxpool4d(fa, fb, INLOC_K)
        mm = mutual_matching(pooled)
        filtered = nc(mm)

        def post_nc_readout():
            c = mutual_matching(filtered).float()
            return torch.cat([torch.stack(corr_to_matches(c, **kw)),
                              torch.stack(corr_to_matches(
                                  c, invert_matching_direction=True, **kw))], 2)

        out = post_nc_readout()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = inloc.match_pair(None, None, None, None, INLOC_K, precomputed=out,
                                shapes=(src.shape, tgt.shape))
        host_ms = 1e3 * (time.perf_counter() - t0)
        stages = {
            "host_resize_normalize_query": prep_ms[0],
            "host_resize_normalize_pano": prep_ms[1],
            "trunk_query": time_ms(lambda: extract_features(model, config, src), 2),
            "trunk_pano": time_ms(lambda: extract_features(model, config, tgt), 2),
            "correlation_maxpool": time_ms(
                lambda: correlation_maxpool4d(fa, fb, INLOC_K), 2),
            "mutual_matching_pre": time_ms(lambda: mutual_matching(pooled), 2),
            "neigh_consensus": time_ms(lambda: nc(mm), 2),
            "mm_post_readout": time_ms(post_nc_readout, 2),
            "host_copy_sort_dedup_recenter": host_ms,
            "matches_after_dedup": len(rows[0]),
            "forward_and_readout": time_ms(lambda: match_fn(model, src, tgt), 2),
            "dump_ms_per_pair": 1e3 * dump_s / len(panos),
        }
        del fa, fb, pooled, mm, filtered, out
    torch.cuda.empty_cache()
    layers = inloc_layers(kernels["conv4d_fwd"], conv4d_plain, tuple(corr_k.shape[1:]))
    emit({"phase": "inloc", "card": smi, "config": config.to_dict(),
          "query_hw": list(QUERY_HW), "pano_hw": list(PANO_HW),
          "image_size": INLOC_SIZE, "k_size": INLOC_K,
          "src_shape": list(src.shape), "tgt_shape": list(tgt.shape),
          "mat_shape": list(m.shape), "filled_slots": filled,
          "written": done["written"], "launches": launches,
          "readout": readout, "stages_ms": stages, "layers": layers})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches, layers


def inloc_layers(conv4d_fwd, conv4d_plain, grid):
    """Each NC layer of the InLoc config, bfloat16, at the pooled grid and
    its transpose (a rectangular pair runs the net once in each
    direction): the kernel against its plain version in float32 on the
    same inputs (TOL), a bitwise repeat, and its time beside the plain
    version's in bfloat16 and the bound."""
    fs1, fs2, fs3, fs4 = grid
    dtype, ks = torch.bfloat16, 3
    records = []
    for shape in ((1, fs1, fs2, fs3, fs4), (1, fs3, fs4, fs1, fs2)):
        for li, (cin, cout) in enumerate(INLOC_LAYERS):
            g = torch.Generator(device="cuda").manual_seed(110 + li)
            bound = (cin * ks**4) ** -0.5
            x = torch.rand(*shape, cin, generator=g, device="cuda").to(dtype)
            w = ((torch.rand(ks, ks, ks, ks, cin, cout, generator=g, device="cuda")
                  * 2 - 1) * bound).to(dtype)
            b = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
            ms = time_ms(lambda: conv4d_fwd(x, w, b), reps=3)
            plain_ms = time_ms(lambda: conv4d_plain(x, w, b), reps=1)
            got, again = conv4d_fwd(x, w, b), conv4d_fwd(x, w, b)
            bitwise = bool(torch.equal(got, again))
            del again
            want = conv4d_plain(x.float(), w.float(), b)
            err = float((got.float() - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            del got, want, x
            torch.cuda.empty_cache()
            bms, by, flops = bound_ms(shape, cin, cout, dtype, ks=ks)
            rec = {"layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                   "ks": ks, "dtype": "bfloat16", "path": "inloc", "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
                   "max_abs_err": err, "max_rel_err": err / scale,
                   "tol_rel": TOL[dtype], "bitwise_repeat": bitwise}
            records.append(rec)
            if not (finite and bitwise and err <= TOL[dtype] * scale):
                emit({"phase": "inloc", "layers": records})
                raise AssertionError(f"conv4d kernel disagrees at the InLoc grid: {rec}")
    return records


def kernel_line(name, source, replaces, launches, layers, work, smi,
                launches_by_path=None):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max(layer["max_abs_err"] for layer in layers),
        # relative to the reference's scale where the timed run checks it
        "max_rel_err": (max(layer["max_rel_err"] for layer in layers)
                        if all("max_rel_err" in layer for layer in layers)
                        else None),
        "ms": sum(layer["ms"] for layer in layers),
        "plain_ms": sum(layer["plain_ms"] for layer in layers),
        "bound_ms": sum(layer["bound_ms"] for layer in layers),
        "bound_by": max(layers, key=lambda la: la["bound_ms"])["bound_by"],
        "library_ms": None,
        "work": work,
        "card": smi,
        "layers": layers,
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs a card")
    # the port itself: this fails where chip_smoke.py stands without it
    from ncnet_tpu_torch.kernels.band_gemm import band_gemm_fwd
    from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd
    from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw
    from ncnet_tpu_torch.ops.band import band_layer_plain
    from ncnet_tpu_torch.ops.conv4d import (
        conv4d_dw_plain,
        conv4d_dx_plain,
        conv4d_plain,
    )

    kernels = {"conv4d_fwd": conv4d_fwd, "conv4d_dx": conv4d_dx,
               "conv4d_dw": conv4d_dw, "band_gemm_fwd": band_gemm_fwd}
    smi = phase_device()
    # conv4d_dx launches conv4d_fwd's library: three builds
    phase_build({"conv4d_fwd": conv4d_fwd, "band_gemm_fwd": band_gemm_fwd,
                 "conv4d_dw": conv4d_dw})
    layers = phase_kernels(smi, conv4d_fwd, conv4d_plain)
    fwd_train_layers, dx_layers, dw_layers = phase_train_kernels(
        smi, kernels, conv4d_plain, conv4d_dx_plain, conv4d_dw_plain)
    synth_layers = phase_synthetic_kernels(
        smi, kernels, conv4d_plain, conv4d_dx_plain, conv4d_dw_plain)
    band_layers = phase_band_kernels(smi, band_gemm_fwd, band_layer_plain)
    model, config = build_model()
    launches = phase_serve(smi, model, config, conv4d_fwd, conv4d_plain)
    band_launches = phase_serve_band(smi, model, config, conv4d_fwd,
                                     band_gemm_fwd, band_layer_plain)
    phase_full_k(smi, model, config, conv4d_fwd, band_gemm_fwd)
    train_launches = phase_train(smi, model, config, kernels, conv4d_plain)
    eval_launches = phase_eval(smi, config, kernels, conv4d_plain,
                               band_layer_plain)
    inloc_launches, inloc_layers_ = phase_inloc(smi, kernels, conv4d_plain)
    fwd_by_path = {"serve": launches, "train": train_launches["conv4d_fwd"],
                   "eval": eval_launches["conv4d_fwd"],
                   "inloc": inloc_launches["conv4d_fwd"]}
    band_by_path = {"serve_band": band_launches,
                    "eval": eval_launches["band_gemm_fwd"]}

    def grad_by_path(name):
        return {"train": train_launches[name], "eval": eval_launches[name]}

    emit({"kernels": [
        kernel_line("conv4d_fwd", "ncnet_tpu_torch/csrc/conv4d_fwd.cu",
                    "ncnet_tpu/kernels/conv4d_pallas.py:65",
                    sum(fwd_by_path.values()),
                    [{**la, "path": "serve"} for la in layers]
                    + [{**la, "path": "train"} for la in fwd_train_layers]
                    + synth_layers["fwd"] + inloc_layers_,
                    "the three NC layers of one square serving batch "
                    f"({MAX_BATCH} pairs x 2 directions), float32; of one "
                    f"pipeline call of a training step ({TRAIN_BATCH} pairs x "
                    "2 directions), bfloat16; the two NC layers (3^4) of a "
                    "synthetic convergence call (8 pairs x 2 directions, 8x8 "
                    "grid), float32 and bfloat16; and the two InLoc NC layers "
                    "(3^4, bfloat16) at the pooled grid of a 3200 px pair in "
                    "both directions. Launches: the served batches', "
                    f"{TRAIN_STEPS} training steps', the eval phase's "
                    "(synthetic convergence, PF-Pascal evaluate and "
                    "evaluate_serving) and the InLoc dump's",
                    smi, fwd_by_path),
        kernel_line("band_gemm_fwd", "ncnet_tpu_torch/csrc/band_gemm_fwd.cu",
                    "ncnet_tpu/kernels/band_gemm_pallas.py:83",
                    sum(band_by_path.values()), band_layers,
                    "the three band NC layers x 2 symmetric passes of one "
                    f"square degraded batch ({MAX_BATCH} pairs, K = {BAND_K}),"
                    " float32; taps derived from the band's indices, no "
                    "pointer table. Launches: the degraded batches' and "
                    f"pck_vs_topk's at K = {BAND_K}", smi, band_by_path),
        kernel_line("conv4d_dx", "ncnet_tpu_torch/csrc/conv4d_fwd.cu",
                    "ncnet_tpu/kernels/conv4d_pallas.py:190",
                    sum(grad_by_path("conv4d_dx").values()),
                    [{**la, "path": "train"} for la in dx_layers] + synth_layers["dx"],
                    "the input gradients of NC layers 2 and 3 of one pipeline "
                    f"call of a training step ({TRAIN_BATCH} pairs x 2 "
                    "directions), bfloat16, and of the 16 -> 1 layer (3^4) of "
                    "a synthetic convergence call, float32 and bfloat16; "
                    f"launches over {TRAIN_STEPS} steps and the synthetic "
                    "convergence runs", smi,
                    grad_by_path("conv4d_dx")),
        kernel_line("conv4d_dw", "ncnet_tpu_torch/csrc/conv4d_dw.cu",
                    "ncnet_tpu/kernels/conv4d_pallas.py:211",
                    sum(grad_by_path("conv4d_dw").values()),
                    [{**la, "path": "train"} for la in dw_layers] + synth_layers["dw"],
                    "the weight gradients of the three NC layers of one "
                    f"pipeline call of a training step ({TRAIN_BATCH} pairs x "
                    "2 directions), bfloat16, and of the two NC layers (3^4) "
                    "of a synthetic convergence call, float32 and bfloat16; "
                    f"launches over {TRAIN_STEPS} steps and the synthetic "
                    "convergence runs", smi,
                    grad_by_path("conv4d_dw")),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
