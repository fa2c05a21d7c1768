"""Node dataloader: seed batching, block sampling and prefetch (the port's
``dgl1_tpu/dataloading/dataloader.py``).

The sampler runs on the host in worker threads (the C++ sampler releases
the interpreter lock), each batch from its own ``SeedSequence`` stream,
so the batch sequence does not depend on thread timing and equals the
reference's for the same seed. The last partial batch is padded to full
size with a seed mask. Each batch is moved to ``device`` (default
``cuda``) inside the worker, off the training thread; the copies go on
the default stream, so on the card they queue with the step's kernels.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from dgl1_tpu_torch import random as dgl_random
from dgl1_tpu_torch.graph import Graph, resolve_device

__all__ = ["NodeCollator", "NodeDataLoader", "DataLoader"]


class NodeCollator:
    """Collate a batch of seed nodes into (input_nodes, output_nodes,
    blocks, seed_mask), all on the host (numpy ids, CPU blocks)."""

    def __init__(self, g: Graph, sampler,
                 rng: Optional[np.random.Generator] = None):
        self.g = g
        self.sampler = sampler
        self.rng = rng or dgl_random.default_rng()

    def collate(self, seeds: np.ndarray, batch_size: int):
        seeds = np.asarray(seeds, dtype=np.int64)
        n_real = len(seeds)
        if n_real < batch_size:
            pad = np.full((batch_size - n_real,), seeds[-1], dtype=np.int64)
            seeds = np.concatenate([seeds, pad])
        mask = np.zeros((batch_size,), dtype=bool)
        mask[:n_real] = True
        input_nodes, output_nodes, blocks = self.sampler.sample_blocks(
            self.g, seeds, rng=self.rng, num_real=n_real)
        return input_nodes, output_nodes, blocks, mask


def _to_device(item, dev: torch.device):
    inp, out, blocks, mask = item
    return (torch.from_numpy(np.asarray(inp, np.int64)).to(dev),
            torch.from_numpy(np.asarray(out, np.int64)).to(dev),
            [b.to(dev) for b in blocks], torch.from_numpy(mask).to(dev))


class NodeDataLoader:
    """Iterates mini-batches ``(input_nodes, output_nodes, blocks, mask)``
    for the seed set ``nids``: int64 id tensors, blocks and the bool seed
    mask, all on ``device``.

    ``prefetch`` > 0 runs ``num_workers`` producer threads with bounded
    queues (strided over batches, consumed round-robin); 0 samples inline.
    ``sample_s`` collects, per batch, the host seconds its worker spent
    sampling and moving it (the loader's own cost, whatever the consumer
    does)."""

    def __init__(self, g, nids, sampler, batch_size: int = 1024,
                 shuffle: bool = True, drop_last: bool = False,
                 prefetch: int = 2, seed: Optional[int] = None,
                 num_workers: int = 1, device=None):
        self.g = g
        self.nids = np.asarray(nids, dtype=np.int64)
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(int(num_workers), 1)
        self.device = resolve_device(device)
        self.collator = NodeCollator(g, sampler, rng=self.rng)
        self.sample_s: list = []

    def __len__(self):
        n = len(self.nids)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = (self.rng.permutation(len(self.nids)) if self.shuffle
                 else np.arange(len(self.nids)))
        nids = self.nids[order]
        for i in range(len(self)):
            yield nids[i * self.batch_size:(i + 1) * self.batch_size]

    def _produce(self, coll: NodeCollator, seeds):
        t0 = time.perf_counter()
        item = _to_device(coll.collate(seeds, self.batch_size), self.device)
        self.sample_s.append(time.perf_counter() - t0)
        return item

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            for seeds in self._batches():
                yield self._produce(self.collator, seeds)
            return

        batches = list(self._batches())
        n_w = min(self.num_workers, max(len(batches), 1))
        # Independent, deterministic RNG stream per batch index.
        seeds_ss = np.random.SeedSequence(
            self.seed if self.seed is not None
            else int(self.rng.integers(1 << 62))).spawn(len(batches))
        stop = object()
        qs = [queue.Queue(maxsize=max(self.prefetch, 1)) for _ in range(n_w)]
        err: list = []
        cancel = threading.Event()

        def put(w, item) -> bool:
            while not cancel.is_set():
                try:
                    qs[w].put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(w: int):
            try:
                coll = NodeCollator(self.g, self.sampler)
                for i in range(w, len(batches), n_w):
                    if cancel.is_set():
                        return
                    coll.rng = np.random.default_rng(seeds_ss[i])
                    if not put(w, self._produce(coll, batches[i])):
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                put(w, stop)

        threads = [threading.Thread(target=producer, args=(w,), daemon=True)
                   for w in range(n_w)]
        for t in threads:
            t.start()
        try:
            done = [False] * n_w
            i = 0
            while not all(done):
                w = i % n_w
                i += 1
                if done[w]:
                    continue
                item = qs[w].get()
                if item is stop:
                    done[w] = True
                    continue
                yield item
            if err:
                raise err[0]
        finally:
            # Abandoned mid-iteration: unblock and reap the producers.
            cancel.set()
            for q_ in qs:
                while not q_.empty():
                    q_.get_nowait()
            for t in threads:
                t.join(timeout=5.0)


DataLoader = NodeDataLoader
