"""Input pipeline (unidefense_tpu/data/pipeline.py:27-222): epoch-sharded
sampling and threaded decode-ahead.

* `EpochSampler` reproduces DistributedSampler semantics: per-epoch
  shuffling with seed + epoch (set_epoch), padding to an even shard split,
  and batching. It draws the same numpy order as the JAX package, so both
  see the same batches step for step;
* `InfiniteBatcher` re-seeds the sampler each time it runs out, and can
  fast-forward a resumed run to the exact data stream;
* `BatchPrefetcher` runs decode + crop + resize (the host JPEG library
  releases the GIL) on a thread pool a few batches ahead of the card.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


class EpochSampler:
    """Shuffled, sharded, batched index stream with set_epoch re-seeding
    (DistributedSampler parity; engine/forgery_engine.py:243-248). Shards
    are ranks: the engines pass shard_id = rank, num_shards = world."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        pad_last: bool = False,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # pad_last: wrap the short final chunk around to the start of the
        # shard so EVERY yielded chunk is exactly batch_size. The train step
        # takes the real/fake split boundary as a fixed int, so a short batch
        # would mis-split the real and fake groups; FE pads instead (every
        # sample is still seen once per epoch).
        self.pad_last = pad_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        per_shard = -(-self.dataset_len // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.shuffle:
            if os.environ.get("UD_SAMPLER_TORCH_ORDER"):
                # torch's DistributedSampler order, bit for bit: the
                # reference shuffles with torch.randperm(n,
                # generator=manual_seed(seed + epoch)) (seed 0,
                # set_epoch(cur_step) each refresh,
                # engine/forgery_engine.py:243-248). Off by default: numpy's
                # permutation is the JAX package's order.
                g = torch.Generator()
                g.manual_seed(self.seed + self.epoch)
                order = torch.randperm(self.dataset_len, generator=g).numpy()
            else:
                g = np.random.default_rng(self.seed + self.epoch)
                order = g.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        # pad so every shard sees the same count (DistributedSampler behavior)
        per_shard = -(-len(order) // self.num_shards)
        total = per_shard * self.num_shards
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        shard = order[self.shard_id :: self.num_shards]
        n_batches = len(self)
        for b in range(n_batches):
            chunk = shard[b * self.batch_size : (b + 1) * self.batch_size]
            if len(chunk) == 0:
                return
            if self.pad_last and len(chunk) < self.batch_size:
                # wrap-around pad from this epoch's shuffled order (np.resize
                # cycles, so shards smaller than a batch also fill up)
                chunk = np.concatenate(
                    [chunk, np.resize(shard, self.batch_size - len(chunk))]
                )
            yield chunk


class InfiniteBatcher:
    """Step-driven batch stream over (dataset, sampler): re-seeds the sampler
    each time it is exhausted, mirroring the engines' iterator-refresh idiom
    (engine/forgery_engine.py:243-248 re-seeds with the current step).

    Split into two phases so the prefetcher can parallelize decode:
    `select(cur_step)` advances the sampler, resolves index -> item strings
    and plans the load (``dataset.plan_item``: the batch's margin, the host
    stage's draws, the header reads RandomResizedCrop needs); the
    prefetcher calls it serially in step order, so every draw falls as in
    a serial run. `load(selection)` reads, decodes, crops and resizes
    (``dataset.finish_item``: slow, draws nothing, safe on worker threads:
    the host JPEG library releases the GIL)."""

    def __init__(self, dataset, sampler: EpochSampler, load_kwargs: Optional[dict] = None):
        self.dataset = dataset
        self.sampler = sampler
        self.load_kwargs = load_kwargs or {}
        self._it = None
        self._count = 0

    def __len__(self):
        return len(self.sampler)

    def _indices(self, cur_step: int):
        if self._it is None or self._count >= len(self.sampler):
            self.sampler.set_epoch(cur_step)
            self._it = iter(self.sampler)
            self._count = 0
        self._count += 1
        return next(self._it)

    def select(self, cur_step: int):
        idx = self._indices(cur_step)
        # datasets may override __getitem__ (e.g. WildDeepfake joins root)
        items = [self.dataset[i][0] for i in idx]
        labels = np.asarray([self.dataset.targets[i] for i in idx], np.int64)
        return self.dataset.plan_item(items, labels, **self.load_kwargs), labels

    def load(self, selection):
        plan, labels = selection
        out = self.dataset.finish_item(plan)
        out["label"] = labels
        return out

    def next_batch(self, cur_step: int):
        return self.load(self.select(cur_step))

    def fast_forward(self, to_step: int, from_step: int = 1):
        """Replay (and discard) the sampler's selections for steps
        [from_step, to_step) so a RESUMED run continues the exact data
        stream an uninterrupted run would have seen at to_step. Index
        arithmetic only (~µs/step): no plan is drawn and no blob read, so
        the augmentation draws are not replayed (as in JAX)."""
        for s in range(from_step, to_step):
            self._indices(s)


class BatchPrefetcher:
    """Decode batches up to `depth` steps ahead on a pool of `workers`
    threads, yielding in step order.

    Two-phase API: `select(step)` runs serially in the consumer thread in
    ascending step order and makes every random draw of the step (the
    sampler's, and the engines' plans of their loads); `load(sel)` runs on
    the pool and draws nothing, so the batches are the same bit for bit
    whatever the number of workers. The single-callable form
    `produce(step)` is also accepted (select becomes the identity) — use it
    only with workers=1 unless produce is thread-safe."""

    def __init__(self, produce: Optional[Callable[[int], dict]] = None,
                 depth: int = 2, num_steps: int = 0, start_step: int = 1,
                 select: Optional[Callable] = None,
                 load: Optional[Callable] = None, workers: int = 1):
        if produce is not None:
            select, load = (lambda s: s), produce
        if select is None or load is None:
            raise ValueError("pass either produce or (select, load)")
        self.select = select
        self.load = load
        self.depth = max(1, depth)
        self.workers = max(1, workers)
        self.num_steps = num_steps
        self.start_step = start_step
        self._stop = threading.Event()

    def __iter__(self):
        pool = ThreadPoolExecutor(max_workers=self.workers)
        pending: dict[int, Any] = {}
        next_submit = self.start_step

        def submit_through(target: int):
            nonlocal next_submit
            while next_submit <= min(target, self.num_steps):
                sel = self.select(next_submit)
                pending[next_submit] = pool.submit(self.load, sel)
                next_submit += 1

        try:
            submit_through(self.start_step + self.depth)
            for step in range(self.start_step, self.num_steps + 1):
                if self._stop.is_set():
                    return
                batch = pending.pop(step).result()
                submit_through(step + 1 + self.depth)
                yield batch
        finally:
            self._stop.set()
            for f in pending.values():
                f.cancel()
            pool.shutdown(wait=False)

    def close(self):
        self._stop.set()
