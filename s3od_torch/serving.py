"""Dynamic-batching server for the port's predictor (its own copy of
`s3od_tpu/serving.py`).

Concurrent requests are queued; a background batcher gathers them into
padded batches (up to `max_batch` or `max_wait_ms`), runs ONE forward for
the whole batch through `remove_background_batch`, and hands each caller
its result. Throughput grows with the batch while tail latency stays
bounded.

Usage:
    server = InferenceServer(BackgroundRemoval(...), max_batch=16)
    server.start()
    result = server.submit(image)          # blocking, thread-safe
    futures = [server.submit_async(im) for im in imgs]
    ...
    server.stop()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np


class InferenceServer:
    def __init__(
        self,
        predictor,
        *,
        # 16: the batch API's chunk (BackgroundRemoval.BATCH_CHUNK).
        max_batch: int = 16,
        max_wait_ms: float = 10.0,
    ):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batch_size_sum": 0}

    # ------------------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # Fail any still-queued requests: their submit() callers block on
        # Future.result() forever otherwise. Taking the submit lock orders
        # this drain after any in-flight submit_async put.
        with self._submit_lock:
            while True:
                try:
                    _, _, fut = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(RuntimeError("server stopped"))

    def submit_async(self, image: np.ndarray, threshold: float = 0.5) -> Future:
        # Fast-fail after stop(): a request enqueued after (or racing with)
        # stop()'s drain would otherwise never complete and its caller would
        # block on Future.result() forever. The lock spans check+put so a
        # submit can't slip between stop()'s flag-set and its queue drain
        # (which takes the same lock). Submitting before start() stays legal
        # (requests queue up until the worker starts).
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("server stopped")
            fut: Future = Future()
            self._queue.put((image, threshold, fut))
        return fut

    def submit(self, image: np.ndarray, threshold: float = 0.5):
        return self.submit_async(image, threshold).result()

    # ------------------------------------------------------------------
    def _collect(self) -> List:
        """Block for the first request, then greedily batch within the
        wait budget."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self) -> None:
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            images = [it[0] for it in items]
            # Pad to the smallest power-of-two bucket that fits, so light
            # traffic runs small batches while the number of distinct
            # batch shapes stays O(log max_batch).
            n_real = len(images)
            bucket = 1
            while bucket < n_real:
                bucket *= 2
            bucket = min(bucket, self.max_batch)
            while len(images) < bucket:
                images.append(images[-1])
            try:
                results = self.predictor.remove_background_batch(images)[:n_real]
                for (_, _, fut), res in zip(items, results):
                    # A client may have cancelled its future (its own
                    # timeout); set_result would raise InvalidStateError and
                    # poison the rest of the batch.
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
            self.stats["requests"] += len(items)
            self.stats["batches"] += 1
            self.stats["batch_size_sum"] += len(items)

    @property
    def mean_batch_size(self) -> float:
        b = self.stats["batches"]
        return self.stats["batch_size_sum"] / b if b else 0.0
