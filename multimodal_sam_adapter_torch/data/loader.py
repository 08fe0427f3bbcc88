"""Data loader: threaded prefetch over the host pipeline, the counterpart of
multimodal_sam_adapter_tpu/data/loader.py.

- per-epoch shuffle from default_rng(seed + epoch);
- each sample's pipeline generator seeded from default_rng((seed, epoch,
  shard)), so the same seed and epoch give the same samples, whatever the
  threads' timing;
- a shard takes every num_shards-th index of the shuffled order
  (DistributedSampler's slice), then drop_last trims it to whole batches;
  with several shards and drop_last the order is first cut to a multiple
  of num_shards x batch_size (DistributedSampler(drop_last=True)'s cut),
  so that every shard yields `len(loader)` batches: data-parallel ranks
  then take the same number of steps, whose collectives pair up;
- `num_threads` threads run the pipeline ahead of the consumer, at most
  `prefetch` batches, and the batches come out in order;
- `_collate` stacks float32 NHWC `img` and int32 `gt` numpy arrays.
Moving a batch to the card is the runner's (engine/runner.py).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(self, dataset, pipeline: Optional[Callable] = None,
                 batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, num_shards: int = 1,
                 shard_index: int = 0, prefetch: int = 2,
                 num_threads: int = 2):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.drop_last and self.num_shards > 1:
            whole = self.num_shards * self.batch_size
            idx = idx[:len(idx) // whole * whole]
        idx = idx[self.shard_index::self.num_shards]
        if self.drop_last:
            idx = idx[:len(idx) // self.batch_size * self.batch_size]
        return idx

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        sample_seeds = np.random.default_rng(
            (self.seed, self.epoch, self.shard_index)).integers(
                0, 2**31, size=len(indices))

        def produce(i: int):
            sample = self.dataset[int(indices[i])]
            if self.pipeline is not None:
                rng = np.random.default_rng(int(sample_seeds[i]))
                try:
                    sample = self.pipeline(sample, rng)
                except TypeError:
                    sample = self.pipeline(sample)
            return sample

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        stop = threading.Event()
        errors = []

        def worker(start: int):
            try:
                for i in range(start, len(indices), self.num_threads):
                    if stop.is_set():
                        return
                    q.put((i, produce(i)))
            except Exception as e:  # raised again in the consumer
                errors.append(e)
                q.put((None, None))

        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(self.num_threads)]
        for t in threads:
            t.start()

        buf = {}
        try:
            batch = []
            for next_i in range(len(indices)):
                while next_i not in buf:
                    i, s = q.get()
                    if errors:
                        raise errors[0]
                    buf[i] = s
                batch.append(buf.pop(next_i))
                if len(batch) == self.batch_size:
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self._collate(batch)
        finally:
            stop.set()
            while True:       # unblock workers waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    @staticmethod
    def _collate(samples):
        imgs = np.stack([s["img"] for s in samples]).astype(np.float32)
        out = {"img": imgs, "meta": [s["meta"] for s in samples]}
        if samples[0].get("gt") is not None:
            out["gt"] = np.stack([s["gt"] for s in samples]).astype(np.int32)
        return out
