"""Batching loader over a populated feature store
(``ncnet_tpu/data/features_loader.py``).

Feature batches ride the image batches' machinery: the store is adapted
into an indexable dataset (`FeaturePairDataset`) and batched by
`ncnet_tpu_torch.data.loader.DataLoader`, so retries, the skip budget,
both worker backends, host sharding, the absolute-epoch shuffle and
mid-epoch resume apply unchanged: a resumed run replays the same batch
sequence whether it reads images or cached features.

Pinning on the card (``pin_hbm=True``): the whole stacked ``[N, h, w, c]``
source and target tensors are copied to the device once, and each batch
is gathered there from the `DataLoader`'s own index plan, so pinned and
unpinned epochs are batch for batch the same, with no host read or
host-to-device copy in the steady-state step. The set must fit
``hbm_fit_fraction`` of the card's free memory
(``torch.cuda.mem_get_info``); a set that does not fit raises.
"""

import torch

from ncnet_tpu_torch.data.loader import DataLoader
from ncnet_tpu_torch.device import resolve_device


class FeaturePairDataset:
    """A populated feature store as an indexable pair dataset; shards are
    digest-checked at read, so bitrot reaches the loader's retry and skip
    machinery."""

    def __init__(self, store):
        self.store = store

    def __len__(self):
        return self.store.num_items

    def __getitem__(self, idx):
        src, tgt = self.store.get(int(idx))
        return {"source_features": src, "target_features": tgt}


class FeatureBatchLoader:
    """The loader surface the training loop drives (``__len__``,
    ``iter_epoch(epoch, skip_batches)``, ``__iter__``, ``seed``, ``close()``,
    context management), yielding ``source_features`` /
    ``target_features`` batches. ``device``: where ``pin_hbm`` pins the set
    (None: the card)."""

    def __init__(self, store, batch_size, shuffle=False, seed=0,
                 num_workers=2, drop_last=False, host_id=0, n_hosts=1,
                 backend="thread", sample_retries=2, retry_backoff=0.05,
                 skip_budget=0, pin_hbm=False, hbm_fit_fraction=0.6,
                 device=None):
        if not store.complete():
            raise ValueError(
                f"feature store at {store.root} is missing "
                f"{len(store.missing())} of {store.num_items} pairs; "
                "populate it first (python -m ncnet_tpu_torch.features or "
                "the train-time lazy fill)")
        self.store = store
        self.seed = seed
        self.batch_size = batch_size
        self.pin_hbm = pin_hbm
        self.hbm_fit_fraction = hbm_fit_fraction
        self.device = resolve_device(device) if pin_hbm else None
        self._pinned = None
        self._epoch = 0
        self._dl = DataLoader(
            FeaturePairDataset(store), batch_size, shuffle=shuffle, seed=seed,
            num_workers=num_workers, drop_last=drop_last, host_id=host_id,
            n_hosts=n_hosts, backend=backend, sample_retries=sample_retries,
            retry_backoff=retry_backoff, skip_budget=skip_budget)

    def __len__(self):
        return len(self._dl)

    def close(self):
        self._dl.close()
        self._pinned = None  # release the device copy too

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        it = self.iter_epoch(self._epoch)
        self._epoch += 1
        return it

    def iter_epoch(self, epoch, skip_batches=0):
        """Batches of absolute ``epoch``: the index sequence (shuffle, host
        shard, drop_last) of an image `DataLoader` with the same
        parameters."""
        if not self.pin_hbm:
            return self._dl.iter_epoch(epoch, skip_batches=skip_batches)
        return self._iter_pinned(epoch, skip_batches)

    def pinned_nbytes(self):
        """Bytes the pinned set takes on the device."""
        return self.store.num_items * self.store.shard_nbytes(0)

    def _ensure_pinned(self):
        if self._pinned is not None:
            return self._pinned
        n = self.store.num_items
        nbytes = self.pinned_nbytes()
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            if nbytes > self.hbm_fit_fraction * free:
                raise ValueError(
                    f"pin_hbm: the feature set is ~{nbytes / 1e9:.2f} GB but "
                    f"the card has {free / 1e9:.2f} GB free of "
                    f"{total / 1e9:.2f} GB (budget {self.hbm_fit_fraction:.0%}"
                    " of the free memory); run without pinning")
        pairs = [self.store.get(i) for i in range(n)]
        self._pinned = tuple(torch.stack([p[r] for p in pairs]).to(self.device)
                             for r in (0, 1))
        return self._pinned

    def _iter_pinned(self, epoch, skip_batches):
        src, tgt = self._ensure_pinned()
        # the DataLoader's own index plan (shuffle + shard + drop_last), so
        # pinned and unpinned epochs are batch for batch the same
        for idx in self._dl._epoch_batches(epoch)[skip_batches:]:
            gather = torch.as_tensor(idx, device=self.device)
            yield {"source_features": src[gather], "target_features": tgt[gather]}
