"""Prefetching loader: overlap decode with device compute (the port's copy
of paintfe_tpu.parallel.prefetch.prefetch_images).

The reference's CLI loads, processes, and encodes strictly serially
(cli.rs:155-216).  This loader decodes ahead on a thread pool (PIL
releases the GIL inside its C decoders) and hands the batch runner images
in order, a bounded number of files ahead of consumption.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Iterable, Iterator, Optional, Tuple


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
