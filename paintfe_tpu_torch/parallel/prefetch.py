"""Prefetching loader and double buffer: overlap decode and staging with
device compute (the port's copies of paintfe_tpu.parallel.prefetch's
prefetch_images and DoubleBuffer).

The reference's CLI loads, processes, and encodes strictly serially
(cli.rs:155-216).  This loader decodes ahead on a thread pool (PIL
releases the GIL inside its C decoders) and hands the batch runner images
in order, a bounded number of files ahead of consumption.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple

import torch


def prefetch_images(paths: Iterable, load: Optional[Callable] = None,
                    depth: int = 4, workers: int = 4) -> Iterator[Tuple[object, object]]:
    """Yield (path, image-or-exception) in input order, decoding up to
    `depth` files ahead on `workers` threads.  Exceptions are delivered
    in-slot so the consumer keeps the CLI's keep-going semantics."""
    if load is None:
        from paintfe_tpu_torch.io import codecs

        load = codecs.load_image
    paths = list(paths)

    def safe_load(p):
        try:
            return load(p)
        except Exception as e:  # delivered to the consumer, not raised here
            return e

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        pending = {}
        for i in range(min(depth, len(paths))):
            pending[i] = pool.submit(safe_load, paths[i])
        submitted = min(depth, len(paths))
        for i in range(len(paths)):
            result = pending.pop(i).result()
            if submitted < len(paths):
                pending[submitted] = pool.submit(safe_load, paths[submitted])
                submitted += 1
            yield paths[i], result


def _record_on(item, stream):
    """Mark the CUDA tensors of `item` (a tensor, or a list, tuple or dict
    of them) as used on `stream`, so the caching allocator does not hand
    their memory out again while work queued there may still read it."""
    if isinstance(item, torch.Tensor):
        if item.is_cuda:
            item.record_stream(stream)
    elif isinstance(item, (list, tuple)):
        for x in item:
            _record_on(x, stream)
    elif isinstance(item, dict):
        for x in item.values():
            _record_on(x, stream)


class DoubleBuffer:
    """Two-slot pipeline: while the device crunches batch N, the host
    stages batch N+1 (the AsyncReadback ping-pong analogue,
    renderer.rs:33-197, pointed the other direction).

    `produce(i)` for i >= 1 runs on a staging thread; card work it queues
    goes to that thread's current stream.  An event recorded there after
    `produce` returns is waited on by the consumer's current stream before
    the item is yielded, so the consumer's kernels see the item complete
    and no host thread waits for the card."""

    def __init__(self, produce: Callable[[int], object], n: int):
        self._produce = produce
        self._n = n
        self._next = None
        self._next_ready = None  # the staging stream's event after produce
        self._next_exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _stage(self, j: int):
        """Make item j on the staging thread; the consumer joins this
        thread before it reads the slot."""
        try:
            self._next = self._produce(j)
            self._next_ready = None
            if torch.cuda.is_initialized():
                self._next_ready = torch.cuda.Event()
                self._next_ready.record()
            self._next_exc = None
        except BaseException as e:  # re-raised on the consumer
            self._next_exc = e

    def __iter__(self):
        for i in range(self._n):
            if self._thread is not None:
                self._thread.join()
                if self._next_exc is not None:
                    # a produce() failure on the staging thread must reach
                    # the consumer, not silently yield the stale previous
                    # slot
                    raise self._next_exc
                item = self._next
                if self._next_ready is not None:
                    stream = torch.cuda.current_stream()
                    stream.wait_event(self._next_ready)
                    _record_on(item, stream)
            else:
                item = self._produce(i)
            if i + 1 < self._n:
                self._thread = threading.Thread(target=self._stage, args=(i + 1,),
                                                daemon=True)
                self._thread.start()
            yield item
