"""Batching and prefetching loader (``ncnet_tpu/data/loader.py``).

Two worker backends behind one API: worker threads with a bounded
prefetch window (at most ``PREFETCH + num_workers`` batches in flight or
buffered), and worker processes (``backend='process'``, a spawn-context
pool that receives the dataset once at start-up) for hosts where the GIL
caps the decode rate. Epoch shuffles are deterministic and addressable by
absolute epoch (``np.random.RandomState(seed + epoch).shuffle``, the JAX
loader's order), so a run of the port and a run of the JAX package see
the same batches and a resumed run replays the same sequence
(`iter_epoch`). Sample randomness derives from the sample index, so
batches do not depend on the worker count or the backend.

Graceful degradation, as in the JAX loader: each sample is retried with
exponential backoff (``sample_retries``, `retry_call`); a sample that
still fails is replaced by the next loadable index, which keeps the
batch's shape, until ``skip_budget`` substitutions over the loader's life
are spent, and then the loader fails loudly (`build_batch`). Hosts shard
the indices equally (`shard_indices`). The loader is a context manager
that shuts its process pool down on every exit path.
"""

import queue
import threading
import time
import traceback

import numpy as np
import torch

PREFETCH = 4  # batches buffered beyond those the workers hold in flight

# the process backend's worker state: the dataset, delivered once by the
# pool's initializer (pickling it a task would dominate small tasks)
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_build_batch(indices, retries, backoff, skip_budget):
    return build_batch(_WORKER_DATASET, indices, retries, backoff, skip_budget)


def collate(samples):
    """Stack a list of dicts of numpy arrays (or tensors: the feature
    store's shards) into a batched dict."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], torch.Tensor):
            out[key] = torch.stack(vals)
        else:
            out[key] = np.stack(vals).astype(vals[0].dtype, copy=False)
    return out


def retry_call(fn, retries=0, backoff=0.05):
    """Call ``fn()``, retrying up to ``retries`` times after a failure with
    exponential backoff (``backoff * 2**attempt`` seconds); the last
    failure propagates."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception:
            if attempt == retries:
                raise
            time.sleep(backoff * (2 ** attempt))


def build_batch(dataset, indices, retries=0, backoff=0.05, skip_budget=0):
    """Collate ``dataset[indices]`` with retries and bounded substitution.

    A sample that still fails after ``retries`` extra attempts is skipped
    and replaced by the next loadable index (deterministic: it depends
    only on the failing index, so batches are the same for any worker
    count or backend). Returns ``(batch, skipped)``, ``skipped`` the
    indices abandoned; past ``skip_budget`` substitutions in one call the
    sample's exception propagates. Shapes stay constant under
    substitution."""
    samples, skipped = [], []
    for idx in indices:
        cur = int(idx)
        while True:
            try:
                samples.append(retry_call(lambda i=cur: dataset[i], retries,
                                          backoff))
                break
            except Exception:
                skipped.append(cur)
                if len(skipped) > skip_budget:
                    raise
                print(f"[loader] skipping corrupt sample {cur} (substituting "
                      f"{(cur + 1) % len(dataset)}; {len(skipped)} skipped so "
                      "far)", flush=True)
                cur = (cur + 1) % len(dataset)
    return collate(samples), skipped


def shard_indices(n, host_id, n_hosts):
    """Host ``host_id``'s contiguous shard of ``range(n)``. Shards are equal
    (the ``n % n_hosts`` remainder is dropped): a host with an extra batch
    would wait forever in its step's collective."""
    per = n // n_hosts
    start = host_id * per
    return np.arange(start, start + per)


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 num_workers=4, drop_last=False, host_id=0, n_hosts=1,
                 backend="thread", sample_retries=2, retry_backoff=0.05,
                 skip_budget=0):
        """``sample_retries`` / ``retry_backoff``: extra attempts a sample
        for transient failures. ``skip_budget``: corrupt samples this
        loader may substitute over its life before it fails; 0 fails on
        the first."""
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown loader backend {backend!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.indices = shard_indices(len(dataset), host_id, n_hosts)
        self.epoch = 0
        self.backend = backend
        self.sample_retries = sample_retries
        self.retry_backoff = retry_backoff
        self.skip_budget = skip_budget
        self.skipped = []  # indices substituted so far (the loader's life)
        self._pool = None

    def _process_pool(self):
        # made on first use and kept across epochs (spawning takes ~1 s)
        if self._pool is None:
            import concurrent.futures
            import multiprocessing

            self._pool = concurrent.futures.ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(self.dataset,),
            )
        return self._pool

    def close(self):
        """Shut the process pool down (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

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
        batches = self._epoch_batches(epoch)[skip_batches:]
        if self.backend == "process":
            return self._iter_process(batches)
        return self._iter_thread(batches)

    def _account_skips(self, skipped, cause=None):
        """The lifetime skip budget: past it the loader fails."""
        if not skipped:
            return
        self.skipped.extend(skipped)
        if len(self.skipped) > self.skip_budget:
            raise RuntimeError(
                f"corrupt-sample skip budget exhausted: {len(self.skipped)} "
                f"samples skipped (budget {self.skip_budget}); first "
                f"failures: {self.skipped[:8]}") from cause

    def _iter_process(self, batches):
        import collections

        pool = self._process_pool()
        window = PREFETCH + self.num_workers
        futs = collections.deque()
        bi = 0
        while bi < len(batches) or futs:
            while bi < len(batches) and len(futs) < window:
                futs.append(pool.submit(
                    _process_build_batch, batches[bi], self.sample_retries,
                    self.retry_backoff, self.skip_budget))
                bi += 1
            # the thread backend's error contract; an abandoned iterator
            # leaves at most `window` futures to drain in the reused pool
            try:
                batch, skipped = futs.popleft().result()
            except Exception as e:
                raise RuntimeError(
                    f"data worker failed on batch construction: {e!r}") from e
            self._account_skips(skipped)
            yield batch

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
                    batch = build_batch(self.dataset, b, self.sample_retries,
                                        self.retry_backoff, self.skip_budget)
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
                    item = results.pop(next_bi, None)
                if item is None:
                    if any(t.is_alive() for t in threads):
                        time.sleep(0.002)
                        continue
                    with lock:
                        item = results.pop(next_bi, None)
                    if item is None:
                        if error:
                            raise_worker_error()
                        raise RuntimeError(
                            "data workers exited before producing batch "
                            f"{next_bi}/{len(batches)}")
                batch, skipped = item
                self._account_skips(skipped)
                yield batch
                inflight.release()
                next_bi += 1
        finally:
            stop.set()
