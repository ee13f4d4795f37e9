"""Host-side input pipeline: batching + background prefetch (a copy of the
JAX package's numpy-only `data/pipeline.py`, which cannot be imported
without jax).

A thread-pool loader producing fixed-shape numpy batches, double-buffered
ahead of the device so the card never waits on pkl I/O.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


def collate(samples: Sequence[tuple]) -> tuple:
    """Stack reference 7-tuples into batched arrays."""
    return tuple(np.stack([s[i] for s in samples]) for i in range(len(samples[0])))


def collate_min_clip(samples: Sequence[tuple]) -> tuple:
    """PointDSC-style collate (reference datasets/dataloader.py:6-37): clip
    every per-point tensor in the batch to the MINIMUM correspondence count so
    ragged pairs stack — used when sampling produced variable-length pairs
    (e.g. num_node='all')."""
    n_min = min(s[2].shape[0] for s in samples)
    out = []
    for i in range(len(samples[0])):
        # per-point arrays clip to n_min; gt_pose [4,4] passes through
        fields = [np.asarray(s[i]) for s in samples]
        if fields[0].ndim >= 1 and fields[0].shape[0] != 4:
            fields = [a[:n_min] for a in fields]
        out.append(np.stack(fields))
    return tuple(out)


class PairLoader:
    """Iterates a dataset in shuffled fixed-size batches with prefetching.

    drop_last=True keeps shapes static across steps (one XLA compilation).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True,
                 process_shard: tuple[int, int] | None = None):
        """process_shard=(process_index, process_count): multi-host input
        sharding (parallel/distributed.py) — every process sees the SAME
        seeded shuffle but iterates only its interleaved slice, so each
        host loads 1/count of the data and the per-host batches concatenate
        to one coherent global batch via host_local_to_global()."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.process_shard = process_shard
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_shard is not None:
            n = n // self.process_shard[1]   # global-min slice (see below)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.process_shard is not None:
            idx, cnt = self.process_shard
            # truncate every process's interleaved slice to the GLOBAL
            # minimum length — otherwise some processes run one extra step
            # and the collective batch assembly deadlocks the pod
            order = order[idx::cnt][: len(self.dataset) // cnt]
        stop = (len(order) // self.batch_size * self.batch_size
                if self.drop_last else len(order))
        for i in range(0, stop, self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self) -> Iterator[tuple]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in self._batch_indices():
                        samples = list(pool.map(self.dataset.__getitem__, idx))
                        q.put(collate(samples))
            except BaseException as e:  # surface loader errors to the consumer
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
