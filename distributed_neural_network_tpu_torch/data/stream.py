"""Host streaming: the train split stays in host RAM and each step's batch
is assembled there (counterpart of the JAX package's `data/stream.py`).

The split is kept as raw uint8 (a quarter of the float32 footprint) and a
batch is gathered and normalized in one pass by the native kernel
(`native.gather_normalize_u8`); a float32 split (already normalized) is only
gathered. `prefetch` runs the assembly on a background thread a few batches
ahead of the consumer, so the host builds batch t+1 while the device runs
batch t. The engine (`train/engine.py`, ``input_mode="stream"``) copies each
batch into the step program's static device buffers.

The shuffle is numpy's `default_rng(seed).permutation`, the JAX package's
own, so for the same seed (the engine passes (seed, epoch, worker)) both
packages yield the same batches.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .. import native
from .cifar10 import CIFAR10_MEAN, CIFAR10_STD
from .pipeline import plan_shape


def prefetch(gen, depth: int = 2):
    """Run the generator `gen` on a background thread, keeping up to `depth`
    items ready ahead of the consumer (double buffering at 2).

    An exception in the producer is raised at the consumer's next pull. The
    thread is a daemon: a consumer that stops early leaves it parked on the
    bounded queue until the process exits.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    done, failed = object(), object()

    def run():
        try:
            for item in gen:
                q.put((None, item))
            q.put((done, None))
        except BaseException as e:  # handed to the consumer, raised there
            q.put((failed, e))

    threading.Thread(target=run, daemon=True).start()
    while True:
        tag, item = q.get()
        if tag is done:
            return
        if tag is failed:
            raise item
        yield item


class HostStream:
    """A shuffled stream of batches over one worker's rows.

    images: (N, ...) uint8 (raw; gathered and normalized natively per batch)
    or float32 (normalized; gathered only); labels: (N,) integers. Each
    epoch yields (images float32, labels int32, weights float32) batches of
    exactly `batch_size` rows: the last partial batch is padded with row 0
    at weight 0, as the device plans pad (`data/pipeline.py`).
    """

    def __init__(self, images, labels, batch_size: int, *, mean: float = CIFAR10_MEAN,
                 std: float = CIFAR10_STD, seed=0):
        self.images = np.ascontiguousarray(images)
        if self.images.dtype not in (np.uint8, np.float32):
            raise TypeError("HostStream takes uint8 (raw) or float32 (normalized) images, "
                            f"got {self.images.dtype}")
        self.labels = np.asarray(labels)
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images vs {len(self.labels)} labels")
        self.batch_size = batch_size
        self.mean, self.std = mean, std
        self._rng = np.random.default_rng(seed)
        self.steps, _ = plan_shape(len(self.images), batch_size)

    def epoch(self, *, shuffle: bool = True):
        """Yield the epoch's (images (B, ...), labels (B,), weights (B,))."""
        n, bs = len(self.images), self.batch_size
        order = self._rng.permutation(n) if shuffle else np.arange(n)
        for step in range(self.steps):
            idx = order[step * bs:(step + 1) * bs]
            w = np.ones(bs, np.float32)
            if len(idx) < bs:
                w[len(idx):] = 0.0
                idx = np.concatenate([idx, np.zeros(bs - len(idx), np.int64)])
            if self.images.dtype == np.uint8:
                x = native.gather_normalize_u8(self.images, idx, self.mean, self.std)
            else:
                x = self.images[idx]
            yield x, self.labels[idx].astype(np.int32), w
