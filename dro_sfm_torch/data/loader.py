"""Batched, sharded, prefetching data loading (numpy batches).

The port's copy of `dro_sfm_tpu/data/loader.py`:

* each process sees a disjoint shard of the epoch's (shuffled) index list;
* workers are a thread pool (rendering and jitter are numpy, which releases
  the interpreter lock in its array loops), behind a bounded queue;
* training batches drop the remainder; evaluation batches pad the tail and
  carry a ``valid`` mask, which the metric sums honour.

`device_prefetch` keeps the next batches' host-to-device copies in flight
(pinned host memory and ``non_blocking`` copies on the card).
"""
from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dro_sfm_torch.data.base import Dataset, set_dataset_epoch

_ARRAY_KEYS = ("rgb", "rgb_original", "rgb_context", "rgb_context_original",
               "intrinsics", "depth", "pose_context")


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack sample dicts into a batch dict (+ ``idx`` [B] and ``filename``)."""
    batch: Dict[str, np.ndarray] = {}
    for key in _ARRAY_KEYS:
        if key in samples[0]:
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
    batch["idx"] = np.array([s["idx"] for s in samples], dtype=np.int64)
    batch["filename"] = [s["filename"] for s in samples]
    return batch


class RepeatedDataset:
    """A dataset repeated ``repeat`` times an epoch."""

    def __init__(self, dataset: Dataset, repeat: int):
        self.dataset = dataset
        self.repeat = repeat

    def __len__(self):
        return len(self.dataset) * self.repeat

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


class ConcatDataset:
    """Datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


class DataLoader:
    """Iterable over collated numpy batches.

    ``drop_last``: drop the final partial batch (training). When False it is
    padded by repeating its last sample, and every batch carries ``valid``
    [B] marking real entries. ``num_shards`` / ``shard_id``: this process's
    shard of each epoch.
    """

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True,
                 num_shards: int = 1, shard_id: int = 0, seed: int = 42,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch`` and refresh the per-sample augmentation
        streams."""
        self.epoch = epoch
        set_dataset_epoch(self.dataset, epoch)

    def _epoch_indices_and_validity(self):
        """This shard's sample indices, and a mask of the genuine ones.

        Shards are padded to equal size with the epoch's leading samples;
        those duplicates are marked invalid, so that an evaluation over all
        shards counts every sample once.
        """
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        per_shard = -(-n // self.num_shards)
        padded = np.concatenate([order, order[:per_shard * self.num_shards - n]])
        genuine = np.arange(len(padded)) < n
        sl = slice(self.shard_id, None, self.num_shards)
        return padded[sl], genuine[sl]

    def __len__(self) -> int:
        per_shard = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices, genuine = self._epoch_indices_and_validity()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone; True if queued."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
                        chunk = indices[sl]
                        valid = np.ones(self.batch_size, dtype=bool)
                        valid[:len(chunk)] = genuine[sl]
                        if len(chunk) < self.batch_size:
                            valid[len(chunk):] = False
                            chunk = np.concatenate(
                                [chunk, np.full(self.batch_size - len(chunk), chunk[-1])])
                        batch = collate(list(pool.map(self.dataset.__getitem__, chunk)))
                        batch["valid"] = valid
                        if not put(batch):
                            return
                put(None)
            except Exception as e:          # handed to the consumer, raised there
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=60)


def device_prefetch(iterable, place_fn, depth: int = 2):
    """Keep up to ``depth`` batches placed on the device ahead of the
    consumer. ``place_fn(batch) -> placed`` should return at once with its
    copies in flight (`to_device`). Yields ``(batch, placed)`` in order."""
    buf = deque()
    it = iter(iterable)
    try:
        while True:
            while len(buf) < depth:
                batch = next(it)
                buf.append((batch, place_fn(batch)))
            yield buf.popleft()
    except StopIteration:
        pass
    while buf:
        yield buf.popleft()


def to_device(batch: Dict, device: torch.device, keys) -> Dict[str, torch.Tensor]:
    """fp32 tensors of ``batch[keys]`` on ``device``; to the card from
    pinned host memory with ``non_blocking`` copies."""
    out = {}
    for k in keys:
        if k not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[k], dtype=np.float32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def make_loader(dataset: Dataset, batch_size: int, mode: str,
                num_workers: int = 4, seed: int = 42,
                num_shards: Optional[int] = None,
                shard_id: Optional[int] = None) -> DataLoader:
    """A loader for ``mode`` ("train" shuffles and drops the remainder).
    The shard is the caller's, else ``torch.distributed``'s rank among its
    world when a process group is initialised, else the whole dataset."""
    if num_shards is None or shard_id is None:
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            num_shards = torch.distributed.get_world_size()
            shard_id = torch.distributed.get_rank()
        else:
            num_shards, shard_id = 1, 0
    # More worker threads than cores is slower.
    num_workers = min(num_workers, os.cpu_count() or num_workers)
    return DataLoader(
        dataset, batch_size,
        shuffle=(mode == "train"),
        num_workers=num_workers,
        drop_last=(mode == "train"),
        num_shards=num_shards, shard_id=shard_id, seed=seed)
