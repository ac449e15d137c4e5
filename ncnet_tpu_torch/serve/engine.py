"""Serving engine: a pipelined, micro-batched request path (the core of
``ncnet_tpu/serve/engine.py::ServeEngine``).

Three stages, each on its own thread(s), with queues between them:

1. **host prep** — ``host_workers`` threads pop raw requests from a
   BOUNDED submit queue (`submit` blocks, or raises ``queue.Full`` with a
   timeout), run ``prep_fn`` (decode / resize / normalize, or a feature
   store's lookup) and feed the `MicroBatcher`; a payload holds numpy
   arrays or CPU tensors;
2. **dispatch** — one thread drives the batcher (cap and max-wait
   flushes), stacks each flushed group into a batch padded by replicating
   the last real sample, copies it to the device, runs ``apply_fn`` and
   starts the copy of the result back to pinned host memory without
   waiting for it;
3. **readout** — one thread waits for that copy, slices out the REAL rows
   (padding is masked here, so it never reaches a caller) and resolves
   the per-request futures. The readout queue's depth lets the device
   compute batch i+1 while batch i is read out.

A failure while a batch is prepared, launched or read back fails exactly
that batch's futures with the exception; every accepted future resolves.

Overload degradation: with a ``degraded_apply_fn`` (the cheaper program,
e.g. the serving forward on an ``nc_topk`` band) a `HysteresisController`
fed the queued-work fraction on every dispatch loop flips dispatch to it
under sustained pressure and back when the pressure clears. With a
``refined_apply_fn`` (the richer program, coarse-to-fine refinement) a
`QualityLadder` walks ``refined <-> standard [<-> degraded]`` one rung a
flip instead. A request may pin its program with ``submit(variant=...)``.
Every program runs at `warmup`. Deadlines, the watchdog, fleet, HTTP and
telemetry of the JAX engine are not ported yet (ROADMAP A15/A16).
"""

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.serve.batcher import MicroBatcher, Request
from ncnet_tpu_torch.serve.resilience import HysteresisController, QualityLadder

_SENTINEL = object()
QUEUE_LIMIT = 64  # bounded submit queue: submit blocks beyond this
READOUT_DEPTH = 2  # batches in flight between dispatch and readout
VARIANTS = ("refined", "standard", "degraded")  # the programs a request may pin


def payload_spec(payload):
    """Per-sample ``{name: (shape, dtype)}`` of a payload dict — the warmup
    description of a bucket's arrays (a tensor's dtype is a torch dtype:
    the feature store's bfloat16 maps have no numpy dtype)."""
    return {
        name: ((tuple(arr.shape), arr.dtype) if isinstance(arr, torch.Tensor)
               else (tuple(np.shape(arr)), np.asarray(arr).dtype))
        for name, arr in payload.items()
    }


def _zeros(shape, dtype, device):
    if isinstance(dtype, torch.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.from_numpy(np.zeros(shape, dtype)).to(device)


def _stack(arrs):
    """One batch tensor of per-request arrays or tensors."""
    if isinstance(arrs[0], torch.Tensor):
        return torch.stack(arrs)
    return torch.from_numpy(np.stack([np.asarray(a) for a in arrs]))


def percentiles(samples, ps=(50, 95, 99)):
    """``{'p50': ..., ...}`` with linear interpolation; NaN when empty."""
    if len(samples) == 0:
        return {f"p{p}": float("nan") for p in ps}
    arr = np.asarray(samples, dtype=np.float64)
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


class ServeEngine:
    """Batched, overlapped serving of ``apply_fn(model, batch)``.

    ``apply_fn`` takes ``(model, {name: [b, ...] tensor})`` and returns a
    dict of tensors whose axis 0 is the batch. ``prep_fn(raw) ->
    (bucket_key, payload)`` runs on the host workers; without one,
    `submit` takes ``key=`` and ``payload=`` (``{name: per-sample
    array}``). Requests sharing a key are batched together, padded up to
    the next allowed batch size, and the padding rows are dropped at
    readout. ``device`` is where the batches run (None: the card).

    ``degraded_apply_fn`` is the cheaper program (same signature as
    ``apply_fn``) that ``degrade_controller`` (default: a
    `HysteresisController`) flips dispatch to under sustained queue
    pressure. ``refined_apply_fn`` is the richer program; with it the
    default controller is a `QualityLadder` over the rungs the engine has
    (``("refined", "standard", "degraded")`` or ``("refined",
    "standard")``), and ``quality_controller`` replaces that ladder (it
    wins over ``degrade_controller``). Requests pinned with
    ``submit(variant=)`` bypass the controller.

    Use as a context manager; `close` drains in-flight work, resolves
    every accepted future and joins all threads.
    """

    def __init__(
        self,
        apply_fn,
        model,
        *,
        device=None,
        max_batch=8,
        max_wait=0.005,
        host_workers=2,
        prep_fn=None,
        degraded_apply_fn=None,
        degrade_controller=None,
        refined_apply_fn=None,
        quality_controller=None,
    ):
        self.device = resolve_device(device)
        self._programs = {"standard": apply_fn}
        if refined_apply_fn is not None:
            self._programs["refined"] = refined_apply_fn
        if degraded_apply_fn is not None:
            self._programs["degraded"] = degraded_apply_fn
        # an injected quality controller wins, then an injected degrade
        # controller; else a refined program gets a ladder over exactly the
        # rungs this engine serves, a degraded-only engine the two-mode one
        if quality_controller is not None:
            self.controller = quality_controller
        elif degrade_controller is not None:
            self.controller = degrade_controller
        elif refined_apply_fn is not None:
            self.controller = QualityLadder(rungs=tuple(
                v for v in VARIANTS if v in self._programs))
        elif degraded_apply_fn is not None:
            self.controller = HysteresisController()
        else:
            self.controller = None
        self._model = model
        self._prep_fn = prep_fn
        self._batcher = MicroBatcher(max_batch=max_batch, max_wait=max_wait)
        self.batch_sizes = self._batcher.batch_sizes  # the padded sizes
        self._submit_q = queue.Queue(maxsize=QUEUE_LIMIT)
        self._batch_q = queue.Queue()
        self._readout_q = queue.Queue(maxsize=READOUT_DEPTH)
        self._stop_dispatch = threading.Event()
        self._close_lock = threading.Lock()
        self._closed = False

        # stats and the ledger of accepted, unresolved futures
        self._lock = threading.Lock()
        self._pending = set()
        self._stats = dict(submitted=0, completed=0, failed=0, batches=0,
                           real_samples=0, padded_samples=0,
                           degraded_batches=0, refined_batches=0,
                           degrade_flips=0)
        self._latencies = []
        self._t_first_submit = None
        self._t_last_done = None

        self._workers = [
            threading.Thread(target=self._prep_loop, name=f"serve-prep-{i}",
                             daemon=True)
            for i in range(host_workers)
        ]
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True
        )
        self._reader = threading.Thread(
            target=self._readout_loop, name="serve-readout", daemon=True
        )
        for t in (*self._workers, self._dispatcher, self._reader):
            t.start()

    # -- warmup ----------------------------------------------------------

    def warmup(self, bucket_specs):
        """Run every (bucket, allowed batch size) once on zeros through
        every program (standard, and refined / degraded when configured), so the
        kernels are built and the convolution algorithms chosen before
        the first request. ``bucket_specs``: iterable of ``(key,
        payload_spec)``. Returns the number of (shape, program) runs."""
        n = 0
        for _, pspec in bucket_specs:
            for bs in self.batch_sizes:
                batch = {name: _zeros((bs,) + tuple(shape), dtype, self.device)
                         for name, (shape, dtype) in pspec.items()}
                for apply_fn in self._programs.values():
                    with torch.inference_mode():
                        apply_fn(self._model, batch)
                    n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    # -- request path ----------------------------------------------------

    def _check_variant(self, variant):
        """A pin the engine cannot serve fails at submit, never mid-dispatch."""
        if variant not in VARIANTS:
            raise ValueError(
                f"unknown quality variant {variant!r} (expected one of "
                f"{sorted(VARIANTS)})"
            )
        if variant not in self._programs:
            raise ValueError(
                f"variant {variant!r} pinned but the engine has no "
                f"{variant} program configured"
            )

    def submit(self, raw=None, *, key=None, payload=None, timeout=None,
               variant=None):
        """Queue one request; returns a `concurrent.futures.Future` whose
        result is ``{name: per-request array}``. With a ``prep_fn`` pass
        ``raw``; without one pass ``key=`` and ``payload=``. The submit
        queue is bounded: when it is full this blocks, or raises
        ``queue.Full`` after ``timeout`` seconds. ``variant`` pins the
        program (``"refined"``, ``"standard"`` or ``"degraded"``): the request joins only
        batches of that program and bypasses the controller; a pin the
        engine has no program for raises `ValueError` here. None lets the
        controller choose."""
        if variant is not None:
            self._check_variant(variant)
        if self._closed:
            raise RuntimeError("submit on a closed ServeEngine")
        if raw is None:
            if key is None or payload is None:
                raise ValueError(
                    "submit needs either raw (with a prep_fn) or key= and "
                    "payload="
                )
            raw = (key, payload)
        fut = Future()
        now = time.monotonic()
        with self._lock:
            self._pending.add(fut)
            self._stats["submitted"] += 1
            if self._t_first_submit is None:
                self._t_first_submit = now
        try:
            self._submit_q.put((raw, fut, now, variant), timeout=timeout)
        except queue.Full:
            with self._lock:
                self._pending.discard(fut)
                self._stats["submitted"] -= 1
            raise
        return fut

    def _prep_loop(self):
        while True:
            item = self._submit_q.get()
            if item is _SENTINEL:
                return
            raw, fut, t_submit, variant = item
            try:
                if self._prep_fn is not None:
                    key, payload = self._prep_fn(raw)
                else:
                    key, payload = raw
            except Exception as exc:  # a failed request fails alone
                self._fail(fut, exc)
                continue
            batch = self._batcher.add(
                Request(key, payload, fut, t_submit, variant=variant)
            )
            if batch is not None:
                self._batch_q.put(batch)

    def _dispatch_loop(self):
        while True:
            self._update_degrade()
            stopping = self._stop_dispatch.is_set()
            nd = self._batcher.next_deadline()
            wait = 0.0 if stopping else min(
                0.05, max(0.0, nd) if nd is not None else 0.05
            )
            try:
                batch = self._batch_q.get(timeout=wait)
            except queue.Empty:
                batch = None
            if batch is not None:
                self._dispatch(batch)
            for b in self._batcher.ready():
                self._dispatch(b)
            if stopping and batch is None and self._batch_q.empty():
                # prep workers are joined: nothing new can arrive
                for b in self._batcher.drain():
                    self._dispatch(b)
                if self._batch_q.empty():
                    return

    def _dispatch(self, batch):
        # a pinned batch runs its members' program; else the controller's
        variant = batch.variant or self._variant_now()
        try:
            reqs = batch.requests
            tensors = {}
            for name in sorted(reqs[0].payload):
                arrs = [r.payload[name] for r in reqs]
                # pad by replicating the last REAL sample: the padded rows
                # run through the same forward and are dropped at readout
                arrs.extend([arrs[-1]] * (batch.pad_to - len(arrs)))
                tensors[name] = _stack(arrs).to(self.device)
            with torch.inference_mode():
                out = self._programs[variant](self._model, tensors)
                if self.device.type == "cuda":
                    host = {}
                    for name, val in out.items():
                        host[name] = torch.empty(
                            val.shape, dtype=val.dtype, pin_memory=True
                        )
                        host[name].copy_(val, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                else:
                    host, done = out, None
        except Exception as exc:  # the batch fails, the engine goes on
            for r in batch.requests:
                self._fail(r.future, exc)
            return
        self._readout_q.put((batch, host, done, variant))

    def _readout_loop(self):
        while True:
            item = self._readout_q.get()
            if item is _SENTINEL:
                return
            batch, host, done, variant = item
            try:
                if done is not None:
                    done.synchronize()
                arrays = {name: val.numpy() for name, val in host.items()}
            except Exception as exc:  # a device fault fails this batch
                for r in batch.requests:
                    self._fail(r.future, exc)
                continue
            now = time.monotonic()
            n = len(batch.requests)
            with self._lock:
                self._stats["batches"] += 1
                self._stats["real_samples"] += n
                self._stats["padded_samples"] += batch.pad_to
                if variant in ("degraded", "refined"):
                    self._stats[f"{variant}_batches"] += 1
            # padding masked here: only rows [0, n) are ever read
            for i, r in enumerate(batch.requests):
                result = {name: a[i].copy() for name, a in arrays.items()}
                if self._settle(r.future, result=result):
                    with self._lock:
                        self._stats["completed"] += 1
                        self._latencies.append(now - r.t_submit)
                        self._t_last_done = now

    # -- degradation controller -----------------------------------------

    def _variant_now(self):
        """The program dispatch uses for unpinned batches right now: the
        controller's rung (a ladder's ``variant``, a two-mode controller's
        ``degraded``), clamped to "standard" where the engine has no such
        program."""
        if self.controller is None:
            return "standard"
        variant = getattr(self.controller, "variant", None)
        if variant is None:  # the two-mode HysteresisController
            variant = "degraded" if self.controller.degraded else "standard"
        return variant if variant in self._programs else "standard"

    def _update_degrade(self):
        """Feed the controller the queued-work fraction (dispatch thread
        only); counts the rung changes."""
        if self.controller is None or len(self._programs) == 1:
            return
        pressure = (self._submit_q.qsize() + self._batcher.pending()
                    + self._batch_q.qsize()) / QUEUE_LIMIT
        was = self._controller_state()
        self.controller.update(pressure)
        if self._controller_state() != was:
            with self._lock:
                self._stats["degrade_flips"] += 1

    def _controller_state(self):
        return getattr(self.controller, "variant", None) or self.controller.degraded

    # -- settlement ------------------------------------------------------

    def _settle(self, fut, result=None, exc=None):
        with self._lock:
            self._pending.discard(fut)
        try:
            if exc is None:
                fut.set_result(result)
            else:
                fut.set_exception(exc)
            return True
        except InvalidStateError:
            return False

    def _fail(self, fut, exc):
        if self._settle(fut, exc=exc):
            with self._lock:
                self._stats["failed"] += 1

    # -- lifecycle -------------------------------------------------------

    def report(self):
        """Counts (``degraded_batches`` / ``refined_batches``: batches the
        degraded / refined program served; ``degrade_flips``: controller
        rung changes), ``degraded_mode``, ``variant`` (the unpinned rung), mean
        batch occupancy, pairs/s (completed requests over first submit to
        last completion) and latency percentiles."""
        with self._lock:
            s = dict(self._stats)
            lat = list(self._latencies)
            span = (
                self._t_last_done - self._t_first_submit
                if self._t_last_done is not None else None
            )
        s["device"] = str(self.device)
        s["variant"] = self._variant_now()
        s["degraded_mode"] = s["variant"] == "degraded"
        s["mean_occupancy"] = (
            s["real_samples"] / s["padded_samples"]
            if s["padded_samples"] else float("nan")
        )
        s["pairs_per_s"] = s["completed"] / span if span else float("nan")
        for p, v in percentiles(lat).items():
            s[f"latency_{p}_ms"] = v * 1e3
        return s

    def close(self):
        """Drain in-flight work (every accepted future resolves), then
        join all pipeline threads. Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._workers:
            self._submit_q.put(_SENTINEL)
        for t in self._workers:
            t.join()
        self._stop_dispatch.set()
        self._dispatcher.join()
        self._readout_q.put(_SENTINEL)
        self._reader.join()
        with self._lock:
            leftovers = list(self._pending)
        for fut in leftovers:
            self._fail(fut, RuntimeError("engine closed before this request resolved"))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
