"""Background device prefetcher: overlaps host batch assembly + H2D transfer
with device compute (the reference blocks the train loop on python-side cv2
work every step — SURVEY.md §3 hot loops)."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import jax


class DevicePrefetcher:
    """Pulls batches from ``next_batch_fn`` on a worker thread, moves them to
    device (optionally with a sharding), and serves them with ``get()``.

    Depth-2 buffering is enough to hide host latency when the host is faster
    than the step; deeper queues only add RAM pressure.
    """

    def __init__(
        self,
        next_batch_fn: Callable[[], object],
        sharding=None,
        depth: int = 2,
    ):
        self._fn = next_batch_fn
        self._sharding = sharding
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._error: Optional[BaseException] = None
        self._thread.start()

    def _put_device(self, batch):
        if self._sharding is not None:
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(x, self._sharding), batch
            )
        return jax.tree_util.tree_map(jax.device_put, batch)

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._put_device(self._fn())
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on next get()
            self._error = e

    def get(self):
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                continue

    def __iter__(self) -> Iterator:
        while True:
            yield self.get()

    def close(self):
        """Stop the worker and wait until it is actually dead.

        The join is unbounded on purpose: the worker re-checks ``_stop``
        between batches and inside its bounded ``put`` retries, so it exits
        within one batch assembly — but that can exceed any fixed timeout on
        a contended host or a slow device, and returning while the worker
        still runs would let a successor prefetcher race it on the shared
        (stateful) loader. A wedged ``batch_fn`` (loader stuck on IO) would
        otherwise hang silently, so log a heartbeat while waiting."""
        self._stop.set()
        waited = 0.0
        while True:
            self._thread.join(timeout=60.0)
            if not self._thread.is_alive():
                return
            waited += 60.0
            print(
                f"prefetch worker still draining after {waited:.0f}s — "
                "batch_fn appears blocked (loader IO?); still waiting"
            )
