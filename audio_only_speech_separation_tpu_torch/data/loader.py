"""Threaded prefetching batch loader (counterpart of
``audio_only_speech_separation_tpu/data/loader.py``).

Wav reads release the GIL, so a thread pool keeps IO busy without worker
processes, and a bounded prefetch queue keeps batches ready while the
device steps.  Yields ``(mixture [B, T], sources [B, n_src, T], keys:
list[str])`` numpy batches with static shapes (train/val); the trainer
moves them to the device.  Per-host sharding: pass shard_id/num_shards.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        pad_to_max: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.pad_to_max = pad_to_max  # right-pad variable-length items
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseed shuffling per epoch (deterministic across restarts)."""
        self.epoch = epoch
        # datasets with per-(epoch, item) RNG streams (random crops) follow
        # the same clock, keeping content independent of iteration order
        # and host layout
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # strided per-host shard: every item lands in exactly one shard
        # even when n % num_shards != 0 (eval must score the tail); for
        # train (drop_last) shards are trimmed to equal length so every
        # host takes the same number of steps — unequal step counts would
        # deadlock cross-host collectives
        if self.num_shards > 1:
            idx = idx[self.shard_id :: self.num_shards]
            if self.drop_last:
                idx = idx[: n // self.num_shards]
        return idx

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _collate(self, items) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        mixes, sources, keys = zip(*items)
        if self.pad_to_max:
            T = max(m.shape[-1] for m in mixes)
            mixes = [np.pad(m, (0, T - m.shape[-1])) for m in mixes]
            sources = [
                np.pad(s, ((0, 0), (0, T - s.shape[-1]))) for s in sources
            ]
        return (
            np.stack(mixes).astype(np.float32),
            np.stack(sources).astype(np.float32),
            list(keys),
        )

    def __iter__(self) -> Iterator:
        idx = self._indices()
        nb = len(self)
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, b))
                        # bounded put that aborts if the consumer went away,
                        # so abandoned iterators never leak a blocked thread
                        while not stop.is_set():
                            try:
                                q.put(self._collate(items), timeout=0.5)
                                break
                            except queue.Full:
                                continue
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                try:
                    q.put(e, timeout=1.0)
                except queue.Full:
                    pass

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
