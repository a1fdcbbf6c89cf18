"""Host input pipeline (twin of ``outgridvit_tpu/data/pipeline.py``): a
deterministic, threaded array loader and a device prefetcher.

``ArrayDataLoader`` is the JAX package's loader, numpy for numpy: the same
seeded batch order per ``(seed, epoch)`` (``set_epoch``), the same per-image
generator ``(seed, epoch, index)`` for the host transform, so for the same
seed it yields the same batches, in the same order, bit for bit. It keeps
one process's view (the JAX multi-process rows are not ported).

``Prefetcher`` moves batches to the card ahead of the consumer: each numpy
array is pinned and copied on a copy stream of its own, the consumer's
stream waits on the copy's event, and each tensor handed over is marked
with ``record_stream`` so its memory is not reused while the consumer's
stream still reads it. ``[K, B, ...]`` superbatches pass through as they
are.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def peek_loader(loader):
    """``(first_batch, iterable)``: the first batch without losing it. The
    iterable is the loader itself when it is re-iterable, or the peeked
    batch chained back in front of a one-shot iterator."""
    it = iter(loader)
    first = next(it)
    if iter(loader) is it:  # one-shot iterator: re-queue the peeked batch
        return first, itertools.chain([first], it)
    return first, loader


class ArrayDataLoader:
    """Batches an in-memory (or lazily indexed) dataset with an optional
    per-image transform. With ``lookahead > 1`` a producer thread makes the
    batches; an exception there (a transform that raises) is raised in the
    consumer, where the JAX loader ends the epoch early instead.

    Args:
      images: array-like [N, H, W, C] uint8, or an object whose
        ``__getitem__`` returns one HWC uint8 image.
      labels: int array [N].
      transform: callable (img_uint8_hwc, np.random.Generator) -> HWC array.
      num_threads: transform worker threads (PIL and numpy release the GIL).
    """

    def __init__(self, images, labels: np.ndarray, batch_size: int,
                 shuffle: bool = False, transform: Optional[Callable] = None,
                 seed: int = 0, drop_last: bool = False, num_threads: int = 8,
                 lookahead: int = 4):
        self.images = images
        self.labels = np.asarray(labels)
        self.n = len(self.labels)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.transform = transform
        self.seed = int(seed)
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.lookahead = lookahead
        self.epoch = 0
        self._pool = None  # persistent transform pool, created lazily
        if self.n == 0:
            raise ValueError("empty dataset")

    def __del__(self):  # pragma: no cover
        try:
            if getattr(self, "_pool", None) is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass  # interpreter teardown: module globals may be gone

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n)
        return np.random.default_rng((self.seed, self.epoch)).permutation(
            self.n)

    def _make_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ys = self.labels[idxs].astype(np.int32)
        if self.transform is None:
            return np.stack([np.asarray(self.images[i]) for i in idxs]), ys

        def one(i):
            rng = np.random.default_rng((self.seed, self.epoch, int(i)))
            return self.transform(np.asarray(self.images[i]), rng)

        if self.num_threads > 1 and len(idxs) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.num_threads)
            xs = list(self._pool.map(one, idxs))
        else:
            xs = [one(i) for i in idxs]
        return np.stack(xs), ys

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._order()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.lookahead <= 1:
            for b in batches:
                yield self._make_batch(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.lookahead)
        stop = threading.Event()

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(b))
            except BaseException as e:  # re-raised in the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class Prefetcher:
    """Wraps an iterator of numpy ``(images, labels)`` batches and yields
    them as tensors on ``device``, ``depth`` batches ahead of the consumer.

    On a CUDA device a worker thread pins each array and copies it on a
    copy stream of its own; the consumer's current stream waits on the
    copy's event and each tensor gets ``record_stream`` on it. On the CPU
    the arrays are wrapped as they are (``torch.from_numpy``)."""

    def __init__(self, it, device="cuda", depth: int = 2):
        self.it = iter(it)
        self.device = torch.device(device)
        self.depth = max(1, int(depth))

    def __iter__(self):
        if self.device.type != "cuda":
            for x, y in self.it:
                yield torch.from_numpy(np.asarray(x)), torch.from_numpy(
                    np.asarray(y))
            return
        device = self.device
        copy_stream = torch.cuda.Stream(device)
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        stop = threading.Event()

        def safe_put(item) -> bool:
            # give up if the consumer left (stop is set) instead of
            # blocking forever with batches on the card
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                with torch.cuda.device(device), torch.cuda.stream(
                        copy_stream):
                    for x, y in self.it:
                        if stop.is_set():
                            return
                        pair = tuple(
                            torch.from_numpy(np.ascontiguousarray(a))
                            .pin_memory().to(device, non_blocking=True)
                            for a in (x, y))
                        event = torch.cuda.Event()
                        event.record(copy_stream)
                        if not safe_put((pair, event)):
                            return
                safe_put(done)
            except BaseException as e:  # surface in the consumer
                safe_put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                pair, event = item
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for a in pair:
                    a.record_stream(consumer)
                yield pair
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
