"""Ordered background decoding of dataset items for the training loop
(``physicedit_tpu/train/prefetch.py``).

``dataset[i]`` (the video decode and the PIL crops: C code that releases
the GIL) runs in a bounded pool of threads while the card runs the previous
step.  Threads, not processes: a decoded frame stack is large, and a
process would copy it back.  Only the decode runs there: preprocessing and
the noise draws stay on the caller's thread in index order, so the random
stream is the synchronous loop's, and no thread touches CUDA.

Items come back in index order (the resume position counts them), ``None``
items pass through, and a decode error is raised at its own index.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor


def prefetch_samples(dataset, indices, num_workers: int = 2, depth: int | None = None):
    """Yield ``(i, dataset[i])`` for ``indices`` in order, decoding ahead in
    ``num_workers`` threads (0 or less: synchronously).  ``depth`` bounds the
    items in flight (default twice the workers), so decoded frames do not
    pile up ahead of a slow consumer."""
    if num_workers <= 0:
        for i in indices:
            yield i, dataset[i]
        return
    if depth is None:
        depth = 2 * num_workers
    pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        queue: collections.deque = collections.deque()
        it = iter(indices)

        def fill():
            while len(queue) < depth:
                try:
                    i = next(it)
                except StopIteration:
                    return
                queue.append((i, pool.submit(dataset.__getitem__, i)))

        fill()
        while queue:
            i, fut = queue.popleft()
            sample = fut.result()       # a decode error surfaces here, at its index
            fill()
            yield i, sample
    finally:
        # a consumer that stops early waits only for the decodes in flight
        pool.shutdown(wait=True, cancel_futures=True)
