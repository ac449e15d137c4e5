"""The float32 FFMA conv4d layers on a card: bitwise checks and times.

    python -m ncnet_tpu_torch.kernels.ffma_check [--against DIR ...] [--reps N]

For the layers the float32 route keeps on the CUDA cores (one input or one
output channel) at the serving, gradient-check and synthetic shapes and at
the route's edges, each kernel output (forward, and dx through
``conv4d_dx``) is held bit for bit against the chain oracle
(`Conv4dForwardKernel.chain_oracle`) and to 1e-4 of its scale against the
plain version. With ``--against DIR`` (a checkout of another revision, for
example unpacked by ``git archive``; repeatable), the outputs are also held
bit for bit against that revision's ``ncnet_tpu_torch/csrc/conv4d_fwd.cu``,
built beside this one (one nvcc a build, started together), and the
serving and synthetic layers are timed in turns (the others, this, this,
the others in reverse) by CUDA events. Prints one JSON line a check, then
a summary line; exits 1 if any output differs. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ncnet_tpu_torch.kernels.conv4d import (
    Conv4dForwardKernel,
    Conv4dInputGradKernel,
    flip_transpose,
)
from ncnet_tpu_torch.kernels.measure import time_ms
from ncnet_tpu_torch.ops.conv4d import conv4d_plain

#: (name, x shape [b, i, j, k, l], ks, cin, cout, pass): "fwd" runs the
#: layer, "dx" its input gradient (a cout -> cin layer on flip(w)^T)
CASES = [
    ("serve 1->16", (8, 25, 25, 25, 25), 5, 1, 16, "fwd"),
    ("serve 16->1", (8, 25, 25, 25, 25), 5, 16, 1, "fwd"),
    ("serve 16->1 dx", (8, 25, 25, 25, 25), 5, 16, 1, "dx"),
    ("grad check 16->1 dx", (4, 25, 25, 25, 25), 5, 16, 1, "dx"),
    ("rectangle 16->1", (4, 25, 25, 19, 25), 5, 16, 1, "fwd"),
    ("rectangle 1->16", (4, 19, 25, 25, 25), 5, 1, 16, "fwd"),
    ("synthetic 1->16", (16, 8, 8, 8, 8), 3, 1, 16, "fwd"),
    ("synthetic 16->1", (16, 8, 8, 8, 8), 3, 16, 1, "fwd"),
    ("synthetic 16->1 dx", (16, 8, 8, 8, 8), 3, 16, 1, "dx"),
    ("edge C=O=1", (2, 5, 4, 6, 7), 3, 1, 1, "fwd"),
    ("edge C=9", (2, 6, 5, 7, 9), 5, 9, 1, "fwd"),
    ("edge O=9", (2, 5, 6, 7, 5), 3, 1, 9, "fwd"),
    ("edge L=3", (1, 5, 4, 30, 3), 5, 16, 1, "fwd"),
    ("edge C=3", (2, 4, 3, 5, 6), 3, 3, 1, "fwd"),
    ("edge small grid", (1, 2, 3, 2, 4), 5, 1, 3, "fwd"),
    ("edge wide row", (1, 1, 2, 4, 150), 5, 1, 16, "fwd"),
    ("edge C=33", (1, 3, 4, 3, 5), 5, 33, 1, "fwd"),
    ("edge ks 7", (1, 3, 3, 4, 9), 7, 1, 5, "fwd"),
    ("edge ks 7 O=1", (1, 3, 3, 9, 4), 7, 6, 1, "fwd"),
    ("edge 768 px 16->1", (1, 4, 4, 48, 48), 5, 16, 1, "fwd"),
]
#: the cases timed in turns
TIMED = ("serve 1->16", "serve 16->1", "serve 16->1 dx", "synthetic 1->16",
         "synthetic 16->1", "synthetic 16->1 dx")


def inputs(shape, ks, cin, cout, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = (cin * ks**4) ** -0.5
    x = torch.rand(*shape, cin, generator=g, device="cuda")
    w = (torch.rand(ks, ks, ks, ks, cin, cout, generator=g, device="cuda")
         * 2 - 1) * bound
    b = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
    gr = torch.randn(*shape, cout, generator=g, device="cuda")
    return x, w, b, gr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="a checkout of another revision (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ffma_check needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    this = Conv4dForwardKernel()
    builds = {"this": this}
    for path in args.against:
        builds[os.path.basename(os.path.normpath(path))] = Conv4dForwardKernel(
            os.path.join(path, "ncnet_tpu_torch", "csrc", "conv4d_fwd.cu"))
    others = [name for name in builds if name != "this"]
    with ThreadPoolExecutor(len(builds)) as pool:
        logs = dict(zip(builds, pool.map(lambda k: k.load(), builds.values())))
    for name, log in logs.items():
        print(json.dumps({"build": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}),
            flush=True)
    dx = {name: Conv4dInputGradKernel(k) for name, k in builds.items()}
    failed = []
    for seed, (name, shape, ks, cin, cout, kind) in enumerate(CASES):
        x, w, b, gr = inputs(shape, ks, cin, cout, seed)
        if kind == "fwd":
            runs = {n: (lambda k=k: k.run(x, w, b)) for n, k in builds.items()}
            oracle = this.chain_oracle(x, w, b)
            plain = conv4d_plain(x, w, b)
        else:
            runs = {n: (lambda k=k: k(gr, w)) for n, k in dx.items()}
            oracle = this.chain_oracle(gr, flip_transpose(w))
            plain = conv4d_plain(gr, flip_transpose(w))
        got = runs["this"]()
        torch.cuda.synchronize()
        scale = float(plain.abs().max())
        rec = {"case": name, "shape": list(shape), "ks": ks,
               "layer": f"{cout}->{cin}" if kind == "dx" else f"{cin}->{cout}",
               "pass": kind,
               "plan": this.ffma_plan(shape, ks, *((cout, cin) if kind == "dx"
                                                   else (cin, cout))),
               "oracle_bitwise": bool(torch.equal(got, oracle)),
               "max_rel_err_plain": float((got - plain).abs().max()) / scale,
               "repeat_bitwise": bool(torch.equal(got, runs["this"]()))}
        rec["others_bitwise"] = {n: bool(torch.equal(got, runs[n]()))
                                 for n in others}
        ok = (rec["oracle_bitwise"] and rec["repeat_bitwise"]
              and all(rec["others_bitwise"].values())
              and rec["max_rel_err_plain"] <= 1e-4)
        if name in TIMED:
            order = others + ["this", "this"] + others[::-1]
            rec["ms"] = {}
            for n in order:
                rec["ms"].setdefault(n, []).append(time_ms(runs[n], args.reps))
        rec["ok"] = ok
        print(json.dumps(rec), flush=True)
        if not ok:
            failed.append(name)
        del x, w, b, gr, got, oracle, plain
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "cases": len(CASES), "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
