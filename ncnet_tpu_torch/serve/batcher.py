"""Dynamic micro-batching: coalesce concurrent requests per shape bucket
(copy of ``ncnet_tpu/serve/batcher.py`` on a plain ``threading.Lock``).

The batcher is PASSIVE — a lock-protected data structure with
``add() / ready() / drain()`` — and takes an injectable clock, so its
deadline behaviour is testable with a fake clock and no sleeps. The
engine's dispatcher thread drives it.

Policy:

* requests group by an opaque ``key`` (the `buckets.pair_bucket` of the
  request) and by their pinned quality ``variant``;
* a group flushes when it reaches ``max_batch`` (cap) or when its OLDEST
  request has waited ``max_wait`` seconds (deadline);
* with an ``estimate_fn``, a group also flushes early once its tightest
  member's remaining budget drops below ``max_wait`` plus the bucket's
  service estimate;
* each flushed group becomes a :class:`MicroBatch` padded UP to the
  smallest allowed batch size (powers of two by default). Padding
  replicates a real request's arrays and is masked at readout by the
  engine, so padding never perturbs real results.

Backpressure is the ENGINE's job (its bounded submit queue); the batcher
itself never blocks.
"""

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence


def default_batch_sizes(max_batch):
    """Powers of two up to and including ``max_batch`` (plus ``max_batch``
    itself when it is not a power of two): the allowed PADDED sizes."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def pad_size(n, batch_sizes):
    """Smallest allowed batch size >= ``n``."""
    for b in batch_sizes:
        if b >= n:
            return b
    raise ValueError(
        f"group of {n} exceeds the largest allowed batch size "
        f"{batch_sizes[-1]} (the batcher caps groups at max_batch)"
    )


class Request:
    """One queued request: a bucket key, named per-sample arrays, and the
    future its result resolves. ``t_submit`` feeds latency accounting;
    ``deadline`` is absolute on the engine clock (None = no SLO);
    ``variant`` pins a quality rung (None = the engine chooses)."""

    __slots__ = ("key", "payload", "future", "t_submit", "deadline", "variant")

    def __init__(self, key, payload, future, t_submit, deadline=None, variant=None):
        self.key = key
        self.payload = payload
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline
        self.variant = variant


@dataclasses.dataclass
class MicroBatch:
    """A flushed group: ``len(requests)`` real samples to be stacked and
    padded to ``pad_to`` rows."""

    key: object
    requests: List[Request]
    pad_to: int
    variant: Optional[str] = None

    @property
    def occupancy(self):
        """Real-sample fraction of the padded batch (1.0 = no padding)."""
        return len(self.requests) / self.pad_to


class _Group:
    """One open coalescing group: add time of the oldest member, the
    tightest member deadline (None: no member carries one), requests."""

    __slots__ = ("t0", "deadline", "requests")

    def __init__(self, t0, deadline, requests):
        self.t0 = t0
        self.deadline = deadline
        self.requests = requests


class MicroBatcher:
    """Per-(key, variant) request coalescing under a deadline and a cap.

    Thread-safe; all methods are non-blocking. ``clock`` is a monotonic
    ``() -> float`` (seconds). ``estimate_fn(bucket_key) -> Optional[float]``
    enables deadline-aware flushing; None is the fixed-wait policy.
    """

    def __init__(
        self,
        max_batch: int = 8,
        max_wait: float = 0.005,
        batch_sizes: Optional[Sequence[int]] = None,
        clock: Callable[[], float] = time.monotonic,
        estimate_fn: Optional[Callable[[object], Optional[float]]] = None,
    ):
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.batch_sizes = (
            tuple(sorted(batch_sizes))
            if batch_sizes is not None
            else default_batch_sizes(max_batch)
        )
        if self.batch_sizes[-1] < max_batch:
            raise ValueError(
                f"batch_sizes {self.batch_sizes} cannot hold a full "
                f"max_batch={max_batch} group"
            )
        self._clock = clock
        self._estimate_fn = estimate_fn
        self._lock = threading.Lock()
        # (key, variant) -> _Group; insertion-ordered so deadline scans
        # see oldest groups first
        self._groups = {}

    @property
    def deadline_aware(self):
        """Whether the deadline-aware early-flush policy is active."""
        return self._estimate_fn is not None

    def _make_batch(self, key, reqs, variant):
        return MicroBatch(
            key, reqs, pad_size(len(reqs), self.batch_sizes), variant
        )

    def _flush_at(self, key, grp):
        """Absolute time this group should flush: the fixed max_wait
        deadline, pulled earlier when the tightest member's remaining
        budget would drop below max_wait + the bucket's service estimate
        (only with an estimate_fn)."""
        at = grp.t0 + self.max_wait
        if grp.deadline is not None and self._estimate_fn is not None:
            est = self._estimate_fn(key)
            at = min(at, grp.deadline - self.max_wait - (est or 0.0))
        return at

    def add(self, request: Request) -> Optional[MicroBatch]:
        """Queue a request; returns a full MicroBatch if this add filled
        its group to ``max_batch``, else None."""
        gkey = (request.key, request.variant)
        with self._lock:
            grp = self._groups.get(gkey)
            if grp is None:
                if self.max_batch <= 1:
                    # a fresh group already AT the cap must flush now:
                    # parking it would let the next add grow the group
                    # past batch_sizes[-1]
                    return self._make_batch(
                        request.key, [request], request.variant
                    )
                self._groups[gkey] = _Group(
                    self._clock(), request.deadline, [request]
                )
                return None
            grp.requests.append(request)
            if request.deadline is not None and (
                grp.deadline is None or request.deadline < grp.deadline
            ):
                grp.deadline = request.deadline
            if len(grp.requests) >= self.max_batch:
                del self._groups[gkey]
                return self._make_batch(request.key, grp.requests, request.variant)
            return None

    def ready(self, now: Optional[float] = None) -> List[MicroBatch]:
        """Pop every group whose flush time has arrived. Full groups never
        sit here — `add` returns them immediately."""
        if now is None:
            now = self._clock()
        out = []
        with self._lock:
            expired = [
                gkey
                for gkey, grp in self._groups.items()
                if now >= self._flush_at(gkey[0], grp)
            ]
            for gkey in expired:
                grp = self._groups.pop(gkey)
                out.append(self._make_batch(gkey[0], grp.requests, gkey[1]))
        return out

    def drain(self) -> List[MicroBatch]:
        """Pop everything regardless of deadline (shutdown flush)."""
        out = []
        with self._lock:
            for gkey, grp in self._groups.items():
                out.append(self._make_batch(gkey[0], grp.requests, gkey[1]))
            self._groups.clear()
        return out

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the next pending group flushes (<= 0: already
        due), or None when empty — the dispatcher's wait timeout."""
        if now is None:
            now = self._clock()
        with self._lock:
            if not self._groups:
                return None
            at = min(
                self._flush_at(gkey[0], grp)
                for gkey, grp in self._groups.items()
            )
        return at - now

    def pending(self) -> int:
        """Number of queued (not yet flushed) requests."""
        with self._lock:
            return sum(len(grp.requests) for grp in self._groups.values())

    def keys(self):
        """Bucket keys with queued (not yet flushed) requests, deduplicated
        across variants."""
        with self._lock:
            return tuple(dict.fromkeys(gkey[0] for gkey in self._groups))
