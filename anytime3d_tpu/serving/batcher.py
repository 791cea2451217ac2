"""Fixed-shape micro-batching inference server.

The reference serves predictions by looping ``sess.run`` per image in eager
test scripts (``/root/reference/test_modelnet_3D.py:104-143``,
``/root/reference/src/module/nolbo_test.py:81-130``) — one graph dispatch per
request, no batching. On an accelerator that shape of serving is doubly
wrong: per-call dispatch runs batch-1 matmuls, and variable request counts
would force one XLA compilation per distinct batch size.

``MicroBatcher`` fixes both:

- ONE static batch shape, compiled once. Incoming requests are coalesced by
  a background thread into groups of at most ``batch_size``; short groups are
  PADDED to the full batch (padding rows are computed and discarded; what
  padded rows cost on the GPU is not measured).
- ``submit`` returns a ``concurrent.futures.Future`` immediately; callers
  block only on their own result. The coalescing window (``max_wait_s``)
  trades p50 latency for occupancy.
- The compute function is anything with the exported signature
  ``fn(x, mask) -> dict`` — typically :func:`serving.export.load_infer`'s
  deserialized program, so the server process needs no model code.

Thread-safety: one dispatcher thread owns the device call and one
completion thread owns result fetching (``max_in_flight`` batches pipeline
between them); ``submit`` is safe from any number of threads.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, Optional

import numpy as np

import jax.numpy as jnp


class MicroBatcher:
    """Coalesce single-item requests into fixed-size device batches."""

    def __init__(
        self,
        infer_fn: Callable[..., Dict],
        batch_size: int,
        input_shape,
        mask_dim: int,
        max_wait_s: float = 0.005,
        input_dtype=np.float32,
        mask_dtype=np.float32,
        max_in_flight: int = 2,
    ):
        """``input_shape`` is the PER-ITEM shape (no batch dim), e.g.
        (64, 64, 64, 1). ``mask_dim`` is the latent-mask width z_cat_dim.

        ``max_in_flight`` device batches may be enqueued before their
        results have been fetched: jax dispatch is async (the call returns
        at enqueue), so batch k+1's host-side packing and device enqueue
        overlap batch k's device compute AND its device->host result fetch
        One completion
        thread fetches + distributes in FIFO order; ``max_in_flight=1``
        restores strict serial behavior."""
        self._fn = infer_fn
        self._b = int(batch_size)
        self._item_shape = tuple(input_shape)
        self._mask_dim = int(mask_dim)
        self._wait = float(max_wait_s)
        self._dtype = input_dtype
        # masks keep their own dtype: packed-IO programs take uint8 items
        # but still expect float observation masks
        self._mask_dtype = mask_dtype
        self._q: "queue.Queue" = queue.Queue()
        # dispatched-but-unfetched batches; bounded => backpressure on the
        # dispatcher so at most max_in_flight device batches are in flight
        self._pending: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_in_flight)))
        self._closed = threading.Event()
        self._submit_lock = threading.Lock()  # orders submit() vs close()
        self.batches_run = 0  # observability: compiled-shape dispatch count
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(target=self._complete, daemon=True)
        self._completer.start()

    # ---- client API ------------------------------------------------------
    def submit(self, x, mask: Optional[np.ndarray] = None) -> Future:
        """Enqueue one item (shape ``input_shape``); resolves to the per-item
        output dict (numpy leaves). ``mask`` marks observed latent dims
        (defaults to all-observed)."""
        x = np.asarray(x, self._dtype)
        if x.shape != self._item_shape:
            raise ValueError(f"item shape {x.shape} != {self._item_shape}")
        if mask is None:
            mask = np.ones((self._mask_dim,), self._mask_dtype)
        mask = np.asarray(mask, self._mask_dtype)
        if mask.shape != (self._mask_dim,):
            # validate HERE: a bad mask must fail the caller, not the worker
            raise ValueError(f"mask shape {mask.shape} != ({self._mask_dim},)")
        fut: Future = Future()
        # lock closes the submit-vs-close race: an item can never be enqueued
        # after the close sentinel (which would strand its future forever)
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((x, mask, fut))
        return fut

    def close(self):
        """Drain outstanding requests, then stop both threads."""
        with self._submit_lock:
            self._closed.set()
            self._q.put(None)  # wake the worker; nothing can enqueue after
        self._worker.join()
        self._pending.put(None)  # after the dispatcher: preserves FIFO drain
        self._completer.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker ----------------------------------------------------------
    def _collect(self):
        """Block for the first request, then coalesce up to batch_size more
        within the wait window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        group = [first]
        # single deadline from the first item — max added latency is
        # max_wait_s total, not (batch_size-1) * max_wait_s of per-item
        # timeouts under a trickling arrival pattern
        deadline = time.monotonic() + self._wait
        while len(group) < self._b:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            group.append(nxt)
        return group

    @staticmethod
    def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None):
        """Deliver a result without ever killing the worker: a future the
        client cancelled (e.g. after a result(timeout=...) expiry) raises
        InvalidStateError on set — its client is gone; drop it."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:
            pass

    def _run(self):
        """Dispatcher: coalesce -> pack -> enqueue the device call. The call
        returns at enqueue (async jax dispatch); fetching is the completion
        thread's job, so the next group's host packing overlaps this
        group's device compute and result transfer."""
        while True:
            group = self._collect()
            if not group:
                if self._closed.is_set() and self._q.empty():
                    return
                continue
            # dispatch is fenced: a failure HERE (bad input, dispatch error)
            # resolves this group's waiters instead of killing the worker
            # and deadlocking all future submits
            try:
                xs = np.zeros((self._b,) + self._item_shape, self._dtype)
                masks = np.ones((self._b, self._mask_dim), self._mask_dtype)
                for i, (x, m, _) in enumerate(group):
                    xs[i] = x
                    masks[i] = m
                out = self._fn(jnp.asarray(xs), jnp.asarray(masks))
            except Exception as e:
                for _, _, fut in group:
                    self._resolve(fut, exc=e)
                continue
            # blocks when max_in_flight batches are unfetched (backpressure)
            self._pending.put((group, out))

    def _complete(self):
        """Completion thread: fetch each dispatched batch's outputs
        (device->host) and distribute per-item results, in FIFO order."""
        while True:
            item = self._pending.get()
            if item is None:
                return
            group, out = item
            n = len(group)
            # fetch + distribution fenced for the same liveness reason: a
            # device error surfaces at fetch time under async dispatch, and
            # a bad output pytree (non-batched leaf) must fail the waiters,
            # not this thread
            resolved = 0
            try:
                out = {k: np.asarray(v) for k, v in out.items()}
                self.batches_run += 1
                for i in range(n):
                    self._resolve(group[i][2], {k: v[i] for k, v in out.items()})
                    resolved += 1
            except Exception as e:  # propagate to every unresolved waiter
                for _, _, fut in group[resolved:]:
                    self._resolve(fut, exc=e)
