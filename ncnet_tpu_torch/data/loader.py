"""Batching and prefetching loader (``ncnet_tpu/data/loader.py``, its
thread backend).

Worker threads build batches with a bounded prefetch window (at most
``PREFETCH + num_workers`` batches in flight or buffered). Epoch shuffles
are deterministic and addressable by absolute epoch
(``np.random.RandomState(seed + epoch).shuffle``, the JAX loader's order),
so a run of the port and a run of the JAX package see the same batches
and a resumed run replays the same sequence (`iter_epoch`). Sample
randomness derives from the sample index, so batches do not depend on the
worker count. Not carried over: the process backend, per-sample retries
and the corrupt-sample skip budget (a failing sample fails the epoch).
"""

import queue
import threading
import time
import traceback

import numpy as np

PREFETCH = 4  # batches buffered beyond those the workers hold in flight


def collate(samples):
    """Stack a list of numpy dicts into a batched dict."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals).astype(vals[0].dtype, copy=False)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 num_workers=4, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.indices = np.arange(len(dataset))
        self.epoch = 0

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_batches(self, epoch):
        idx = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        """Auto-advancing iteration: epoch 0, 1, 2, ... per call."""
        it = self.iter_epoch(self.epoch)
        self.epoch += 1
        return it

    def iter_epoch(self, epoch, skip_batches=0):
        """Iterate the batches of absolute ``epoch``, skipping the first
        ``skip_batches`` (a mid-epoch resume never builds them)."""
        return self._iter_thread(self._epoch_batches(epoch)[skip_batches:])

    def _iter_thread(self, batches):
        task_q = queue.Queue()
        for bi, b in enumerate(batches):
            task_q.put((bi, b))
        results = {}
        lock = threading.Lock()
        stop = threading.Event()
        # each in-flight or unconsumed batch holds one permit; workers take
        # tasks in order, so the oldest unconsumed batch is always buffered
        # or in flight
        inflight = threading.Semaphore(PREFETCH + self.num_workers)
        error = []

        def worker():
            while not stop.is_set():
                if not inflight.acquire(timeout=0.1):
                    continue
                try:
                    bi, b = task_q.get_nowait()
                except queue.Empty:
                    inflight.release()
                    return
                try:
                    batch = collate([self.dataset[int(i)] for i in b])
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    with lock:
                        if not error:
                            error.append((e, traceback.format_exc()))
                    stop.set()
                    return
                with lock:
                    results[bi] = batch

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def raise_worker_error():
            exc, tb = error[0]
            raise RuntimeError(
                f"data worker failed on batch construction:\n{tb}") from exc

        try:
            next_bi = 0
            while next_bi < len(batches):
                if error:
                    raise_worker_error()
                with lock:
                    batch = results.pop(next_bi, None)
                if batch is None:
                    if any(t.is_alive() for t in threads):
                        time.sleep(0.002)
                        continue
                    with lock:
                        batch = results.pop(next_bi, None)
                    if batch is None:
                        if error:
                            raise_worker_error()
                        raise RuntimeError(
                            "data workers exited before producing batch "
                            f"{next_bi}/{len(batches)}")
                yield batch
                inflight.release()
                next_bi += 1
        finally:
            stop.set()
