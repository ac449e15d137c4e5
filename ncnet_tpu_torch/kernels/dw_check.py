"""The conv4d weight-gradient kernel on a card: checks and times.

    python -m ncnet_tpu_torch.kernels.dw_check [--against DIR ...] [--reps N]
        [--only SUBSTRING ...] [--steps N]

For each case (the synthetic run's layers, the PF-Pascal layers at 2 and 32
samples on 25^4, the 48x48 grid of 768 px, and shapes at the edges of the
float32 route's plan), the kernel's dw is held to 1e-4 of its scale against
``conv4d_dw_plain`` (float32) and to a bitwise repeat. With ``--against
DIR`` (a checkout of another revision, for example unpacked by ``git
archive``; repeatable), that revision's ``csrc/conv4d_dw.cu`` is built
beside this one (one nvcc a build, started together): its bfloat16 dw must
be bitwise this one's, and the timed cases run in turns (the others, this,
this, the others in reverse). A time is the mean of ``--reps`` calls between
two CUDA events, and the device time of each pass from ``torch.profiler``
(`measure.dw_passes_ms`: the split, pass 1 and pass 2, from a trace that
holds every launch). Each record has the bound and the FFMA ceiling
(`measure.dw_bound_ms`, `measure.ffma_bound_ms`, as ``chip_smoke.py``). A
revision that refuses a shape is recorded, and fails the run only where it
is this one. With ``--steps N``, N float32 training steps (``train
--no-bf16``: the PF-Pascal config, random weights from seed 0, batch 16 at
400 px) are timed by events through each build's dw in turns, from the
same weights, after one warm-up step each, with the peak memory allocated.
Prints one JSON line a case, then a summary line; exits 1 if a check of
this revision fails. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ncnet_tpu_torch.kernels.conv4d_dw import Conv4dWeightGradKernel
from ncnet_tpu_torch.kernels.measure import (
    dw_bound_ms,
    dw_passes_ms,
    ffma_bound_ms,
    time_ms,
)
from ncnet_tpu_torch.ops.conv4d import conv4d_dw_plain

DW_TOL = 1e-4

F32, BF16 = torch.float32, torch.bfloat16
#: (name, [b, i, j, k, l], ks, cin, cout, dtype, timed)
CASES = [
    ("synthetic 1->16", (16, 8, 8, 8, 8), 3, 1, 16, F32, True),
    ("synthetic 16->1", (16, 8, 8, 8, 8), 3, 16, 1, F32, True),
    ("25^4 x2 1->16", (2, 25, 25, 25, 25), 5, 1, 16, F32, True),
    ("25^4 x2 16->16", (2, 25, 25, 25, 25), 5, 16, 16, F32, True),
    ("25^4 x2 16->1", (2, 25, 25, 25, 25), 5, 16, 1, F32, True),
    ("25^4 x32 1->16", (32, 25, 25, 25, 25), 5, 1, 16, F32, True),
    ("25^4 x32 16->16", (32, 25, 25, 25, 25), 5, 16, 16, F32, True),
    ("25^4 x32 16->1", (32, 25, 25, 25, 25), 5, 16, 1, F32, True),
    ("48^4 x1 1->16", (1, 48, 48, 48, 48), 5, 1, 16, F32, True),
    ("48^4 x1 16->16", (1, 48, 48, 48, 48), 5, 16, 16, F32, True),
    ("48^4 x1 16->1", (1, 48, 48, 48, 48), 5, 16, 1, F32, True),
    ("bf16 25^4 x2 16->16", (2, 25, 25, 25, 25), 5, 16, 16, BF16, False),
    ("bf16 25^4 x32 1->16", (32, 25, 25, 25, 25), 5, 1, 16, BF16, True),
    ("bf16 25^4 x32 16->16", (32, 25, 25, 25, 25), 5, 16, 16, BF16, True),
    ("bf16 25^4 x32 16->1", (32, 25, 25, 25, 25), 5, 16, 1, BF16, True),
    ("bf16 synthetic 16->1", (16, 8, 8, 8, 8), 3, 16, 1, BF16, False),
    ("edge 5^4 16->64", (2, 6, 7, 9, 11), 5, 16, 64, F32, False),
    ("edge 5^4 64->16", (2, 7, 6, 11, 9), 5, 64, 16, F32, False),
    ("edge 7^4 32->16", (2, 6, 5, 9, 10), 7, 32, 16, F32, False),
    ("edge 11^4 16->16", (1, 5, 6, 12, 13), 11, 16, 16, F32, False),
    ("edge ragged chunk", (3, 7, 11, 6, 9), 5, 16, 16, F32, False),
    ("edge C=3 O=5", (2, 4, 5, 6, 7), 3, 3, 5, F32, False),
    ("edge C=9 O=1", (2, 5, 4, 7, 6), 5, 9, 1, F32, False),
    ("edge C=1 O=3", (2, 5, 4, 7, 6), 5, 1, 3, F32, False),
    ("edge C=O=1", (3, 4, 5, 6, 7), 3, 1, 1, F32, False),
    ("edge ks 1", (2, 5, 4, 7, 6), 1, 8, 8, F32, False),
    ("edge wide row", (1, 2, 3, 3, 150), 5, 16, 16, F32, False),
    ("edge small grid", (1, 2, 3, 2, 4), 5, 16, 16, F32, False),
    ("edge odd positions 1->16", (1, 5, 5, 5, 5), 5, 1, 16, F32, False),
    ("edge odd positions 25^4 1->16", (1, 25, 25, 25, 25), 5, 1, 16, F32, False),
]


def time_steps(builds, order, n):
    """Mean ms of ``n`` float32 training steps through each build's dw
    (patched into ``ncnet_tpu_torch.ops.conv4d``), each from the same NC
    weights and optimizer state, one warm-up step first, and the peak
    memory allocated over those steps: ``({name: [ms of each turn]},
    {name: [bytes of each turn]})``."""
    import copy

    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.ops import conv4d as ops_conv4d
    from ncnet_tpu_torch.train.step import (
        create_train_state,
        device_batch,
        make_train_step,
    )

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), symmetric_mode=True, half_precision=False)
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    ds = SyntheticPairDataset(n=16, output_size=(400, 400), seed=0)
    batch = device_batch(collate([ds[i] for i in range(16)]), "cuda")
    state = create_train_state(model, 5e-4)
    step = make_train_step(config)
    params = model.neigh_consensus.trainable()
    saved = [t.detach().clone() for t in params]
    saved_opt = copy.deepcopy(state.optimizer.state_dict())
    kept = ops_conv4d.conv4d_dw
    out, peak = {}, {}
    try:
        for name in order:
            ops_conv4d.conv4d_dw = builds[name]
            with torch.no_grad():
                for t, t0 in zip(params, saved):
                    t.copy_(t0)
            state.optimizer.load_state_dict(saved_opt)
            torch.cuda.reset_peak_memory_stats()
            state, _ = step(state, batch)  # warm up
            out.setdefault(name, []).append(time_ms(lambda: step(state, batch), n))
            peak.setdefault(name, []).append(torch.cuda.max_memory_allocated())
    finally:
        ops_conv4d.conv4d_dw = kept
    return out, peak


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="a checkout of another revision (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", action="append", default=[],
                    help="run the cases whose name holds this (repeatable)")
    ap.add_argument("--steps", type=int, default=0,
                    help="also time this many float32 training steps a build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_check needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    builds = {"this": Conv4dWeightGradKernel()}
    for path in args.against:
        builds[os.path.basename(os.path.normpath(path))] = Conv4dWeightGradKernel(
            os.path.join(path, "ncnet_tpu_torch", "csrc", "conv4d_dw.cu"))
    others = [name for name in builds if name != "this"]
    with ThreadPoolExecutor(len(builds)) as pool:
        logs = dict(zip(builds, pool.map(lambda k: k.load(), builds.values())))
    for name, log in logs.items():
        print(json.dumps({"build": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}),
            flush=True)
    failed = []
    cases = [c for c in CASES if not args.only or any(s in c[0] for s in args.only)]
    for seed, (name, shape, ks, cin, cout, dtype, timed) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.rand(*shape, cin, generator=g, device="cuda").to(dtype)
        gr = torch.randn(*shape, cout, generator=g, device="cuda").to(dtype)
        bms, by, flops = dw_bound_ms(shape, cin, cout, dtype, ks)
        ffma_ms = ffma_bound_ms(flops)
        rec = {"case": name, "shape": list(shape), "ks": ks,
               "layer": f"{cin}->{cout}", "dtype": str(dtype).split(".")[1],
               "bound_ms": bms, "bound_by": by, "ffma_bound_ms": ffma_ms,
               "gflop": flops / 1e9}
        runs, errors = {}, {}
        for n, k in builds.items():
            try:
                k(x, gr, ks)
                runs[n] = lambda k=k: k(x, gr, ks)
            except RuntimeError as exc:
                errors[n] = str(exc)[:300]
        rec["refused"] = errors
        ok = "this" in runs
        if ok:
            got = runs["this"]()
            rec["repeat_bitwise"] = bool(torch.equal(got, runs["this"]()))
            ok = rec["repeat_bitwise"] and bool(torch.isfinite(got).all())
            if dtype == F32:
                want = conv4d_dw_plain(x, gr, ks)
                scale = float(want.abs().max())
                rec["max_rel_err_plain"] = float((got - want).abs().max()) / scale
                ok = ok and rec["max_rel_err_plain"] <= DW_TOL
                del want
            rec["others_bitwise"] = {n: bool(torch.equal(got, runs[n]()))
                                     for n in others if n in runs}
            if dtype == BF16:
                ok = ok and all(rec["others_bitwise"].values())
            del got
        if timed and runs:
            order = [n for n in others + ["this", "this"] + others[::-1] if n in runs]
            reps = max(1, min(args.reps, int(2000 / max(ffma_ms, 1e-3))))
            rec["ms"], rec["device_ms"] = {}, {}
            for n in order:
                rec["ms"].setdefault(n, []).append(time_ms(runs[n], reps))
                rec["device_ms"].setdefault(n, []).append(
                    dw_passes_ms(builds[n], runs[n], reps))
        rec["ok"] = ok
        print(json.dumps(rec), flush=True)
        if not ok:
            failed.append(name)
        del x, gr, runs
        torch.cuda.empty_cache()
    if args.steps:
        order = others + ["this", "this"] + others[::-1]
        ms, peak = time_steps(builds, order, args.steps)
        print(json.dumps({"train_step_float32_ms": ms, "peak_memory_bytes": peak,
                          "steps": args.steps, "batch": 16, "hw": [400, 400]}),
              flush=True)
    print(json.dumps({"card": smi, "cases": len(cases), "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
