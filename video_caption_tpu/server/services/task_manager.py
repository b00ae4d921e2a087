"""Device admission gate (reference: server/services/task_manager.py:10-22).

The reference serializes all GPU work with a Semaphore(1) because a 4GB card
can hold one request. The compiled executables are reentrant but we
keep the same admission-control contract (configurable concurrency; default
1 request on-device at a time) so latency is predictable under load and
OOMs cannot stack.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


class DeviceTaskManager:
    def __init__(self, max_concurrent_tasks: int = 1):
        self._sem = threading.Semaphore(max_concurrent_tasks)
        self.max_concurrent_tasks = max_concurrent_tasks

    @contextmanager
    def acquire(self):
        self._sem.acquire()
        try:
            yield
        finally:
            self._sem.release()


DEVICE_TASK_MANAGER = DeviceTaskManager(max_concurrent_tasks=1)
