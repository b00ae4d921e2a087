"""Request-coalescing batch queue for serving.

The reference serializes requests one-at-a-time through a Semaphore(1)
(server/services/task_manager.py) because one 4GB GPU holds one request.
The decode step is weight-bandwidth bound, so co-scheduling concurrent
requests into ONE ``engine.infer_batch`` call shares the GPT-2 weight
traffic — throughput scales with batch at nearly flat latency (batched
encode+decode at a fixed offered rate).

A background worker drains the queue: it waits up to ``max_wait_ms`` for
co-arriving requests (bounded added latency), then dispatches up to
``max_batch`` of them as one device program. One queue per resident engine
(engines are per-config, so batched requests always share a config).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Tuple

log = logging.getLogger(__name__)


class BatchingQueue:
    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[Tuple[str, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---- client API --------------------------------------------------------

    def submit(self, frames_dir: str) -> Future:
        fut: Future = Future()
        self._queue.put((frames_dir, fut))
        return fut

    def infer(self, frames_dir: str):
        """Blocking submit; raises whatever the engine raised."""
        return self.submit(frames_dir).result()

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(("", None))  # wake the worker
        self._worker.join(timeout=5)

    # ---- worker ------------------------------------------------------------

    def _collect(self) -> List[Tuple[str, Future]]:
        item = self._queue.get()
        if item[1] is None:
            return []
        batch = [item]
        # absolute deadline: total coalescing delay is bounded by max_wait_ms
        # regardless of arrival pattern (not reset per arriving request)
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt[1] is None:
                break
            batch.append(nxt)
        return batch

    @staticmethod
    def _bucket_size(n: int) -> int:
        """Next power of two >= n: every distinct batch size is a separately
        compiled XLA program, and a fresh compile under load stalls the whole
        queue for minutes — bucketing bounds the program count to log2(max)."""
        size = 1
        while size < n:
            size *= 2
        return size

    def _resolve(self, batch, handle, dirs) -> None:
        try:
            results = self.engine.infer_batch_collect(handle)[: len(dirs)]
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)
        except Exception as exc:
            # a bad frames_dir poisons the whole batch; fall back to
            # per-request execution so one 404 doesn't fail neighbors
            log.info("batched inference failed (%s); retrying per-request", exc)
            for d, fut in batch:
                try:
                    fut.set_result(self.engine.infer(d))
                except Exception as single_exc:
                    fut.set_exception(single_exc)

    def _run(self) -> None:
        # double-buffered under sustained load: dispatch batch N+1 (host JPEG
        # decode + upload + enqueue) before collecting batch N's results; when
        # the queue idles, resolve immediately so latency stays bounded
        pending = None
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                if pending is not None:
                    self._resolve(*pending)
                    pending = None
                continue
            dirs = [d for d, _ in batch]
            padded = dirs + [dirs[-1]] * (self._bucket_size(len(dirs)) - len(dirs))
            try:
                handle = self.engine.infer_batch_dispatch(padded)
            except Exception as exc:
                log.info("batch dispatch failed (%s); retrying per-request", exc)
                if pending is not None:
                    self._resolve(*pending)
                    pending = None
                for d, fut in batch:
                    try:
                        fut.set_result(self.engine.infer(d))
                    except Exception as single_exc:
                        fut.set_exception(single_exc)
                continue
            if pending is not None:
                self._resolve(*pending)
            pending = (batch, handle, dirs)
            if self._queue.empty():
                self._resolve(*pending)
                pending = None
        if pending is not None:  # drain on shutdown
            self._resolve(*pending)


_QUEUES = {}
_QUEUES_LOCK = threading.Lock()


def get_queue(engine, max_batch: int = 8, max_wait_ms: float = 5.0) -> BatchingQueue:
    """One coalescing queue per resident engine."""
    key = id(engine)
    with _QUEUES_LOCK:
        q = _QUEUES.get(key)
        if q is None:
            q = BatchingQueue(engine, max_batch, max_wait_ms)
            _QUEUES[key] = q
        return q
