"""Measurements of the conv4d kernels on a card, shared by ``chip_smoke.py``,
``kernels/ffma_check.py`` and ``kernels/dw_check.py``: the H100's peak
rates, a layer's bound, CUDA-event times, and the dw kernel's device time
by pass from ``torch.profiler``.

A bound is the larger of two times: the on-grid multiply-adds over the
peak rate of their type (float32-accurate work at split-TF32's rate, TF32
over three MMAs a product; bfloat16 at its dense rate) and the bytes over
the memory rate (each input read once, each output written once). The FFMA
ceiling is the same operations over the CUDA cores' float32 rate.
"""

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet)
SPLIT_TF32_FLOPS = 495e12 / 3
FFMA_FLOPS = 67e12
PEAK_FLOPS = {torch.float32: SPLIT_TF32_FLOPS, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
#: traces of one measurement taken before it is given up as lacking a launch
TRACE_TRIES = 3


def valid_taps(n, k):
    """Sum over n positions of the taps of a size-k SAME window that land
    on the grid (the zero-padding taps need no work)."""
    p = k // 2
    return sum(min(n, i + p + 1) - max(0, i - p) for i in range(n))


def _verdict(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def bound_ms(shape, cin, cout, dtype, ks):
    """(ms, what bounds it, FLOPs) of the ks^4 SAME convolution of x
    ``[*shape, cin]`` into ``cout`` channels: reads x and w, writes the
    output and reads the bias."""
    b, dims = shape[0], shape[1:]
    flops = 2.0 * b * cin * cout * np.prod([valid_taps(n, ks) for n in dims])
    elt = torch.finfo(dtype).bits // 8
    nbytes = (np.prod(shape) * (cin + cout) + ks**4 * cin * cout) * elt + 4 * cout
    return _verdict(flops, nbytes, dtype)


def dw_bound_ms(shape, cin, cout, dtype, ks):
    """`bound_ms` of the weight gradient: the forward's operations; reads x
    and g, writes a float32 dw."""
    _, _, flops = bound_ms(shape, cin, cout, dtype, ks)
    elt = torch.finfo(dtype).bits // 8
    nbytes = np.prod(shape) * (cin + cout) * elt + ks**4 * cin * cout * 4
    return _verdict(flops, nbytes, dtype)


def ffma_bound_ms(flops):
    """The least time of ``flops`` of exact float32 work on the CUDA
    cores (FFMA, 67 TFLOP/s)."""
    return 1e3 * flops / FFMA_FLOPS


def time_ms(fn, reps):
    """Mean ms of ``reps`` calls of ``fn`` between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def dw_trace(prof, calls, pass1):
    """The dw kernel's device time in a finished ``torch.profiler`` trace of
    ``calls`` calls of the dw wrapper that launched pass 1 ``pass1`` times
    (the wrapper's ``pass1_launches``): ``{"split", "pass1", "pass2"}`` in
    ms a call (float32 splits x and g first, twice a pass-1 launch; pass 2,
    the function named ``reduce``, once a call), the kernel launches the
    trace holds of each, and whether it holds them all. A trace short of a
    launch would read too little: it is not ``complete``, and its times are
    None."""
    out = {"split": 0.0, "pass1": 0.0, "pass2": 0.0}
    launches = {"split": 0, "pass1": 0, "pass2": 0}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t <= 0 or "conv4d_dw" not in e.key:
            continue
        part = ("split" if "split" in e.key else
                "pass2" if "reduce" in e.key else "pass1")
        out[part] += t / calls / 1e3
        launches[part] += e.count
    out["launches"] = launches
    out["complete"] = (launches["pass2"] == calls and launches["pass1"] == pass1
                       and launches["split"] in (0, 2 * pass1))
    if not out["complete"]:
        out.update(split=None, pass1=None, pass2=None)
    return out


def dw_passes_ms(kernel, fn, reps):
    """`dw_trace` of ``reps`` calls of ``fn`` (one call of the dw wrapper
    ``kernel`` each) under ``torch.profiler``, after one warm-up call; a
    trace that is not complete is taken again, up to `TRACE_TRIES` traces
    in all (``"tries"``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_TRIES + 1):
        before = kernel.pass1_launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a throwaway kernel first: on an H100 traces lost one kernel
            # record, the first a call launches, in about half the cases
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = dw_trace(prof, reps, kernel.pass1_launches - before)
        out["tries"] = attempt
        if out["complete"]:
            break
    return out
