"""Device-memory observability and OOM guard (reference: core/memory.py:19-46).

Under XLA there is no ``empty_cache``; recovery from an XLA RESOURCE_EXHAUSTED
error means deleting live buffers and letting the allocator reclaim. The
guard therefore reports + re-raises, and ``snapshot`` reads the runtime's
per-device memory stats when the backend exposes them.
"""
from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Optional

import jax

from video_caption_tpu.config import MemoryConfig

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class DeviceMemorySnapshot:
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    peak_bytes_in_use: Optional[int]

    @property
    def mb_in_use(self) -> Optional[float]:
        return None if self.bytes_in_use is None else self.bytes_in_use / 2**20


def is_oom_error(err: BaseException) -> bool:
    msg = str(err)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg or "out of memory" in msg


class MemoryManager:
    def __init__(self, config: MemoryConfig | None = None, device: Optional[jax.Device] = None):
        self.config = config or MemoryConfig()
        self.device = device or jax.devices()[0]

    def snapshot(self) -> DeviceMemorySnapshot:
        stats = {}
        try:
            stats = self.device.memory_stats() or {}
        except Exception:  # pragma: no cover - backend without memory_stats
            pass
        return DeviceMemorySnapshot(
            bytes_in_use=stats.get("bytes_in_use"),
            bytes_limit=stats.get("bytes_limit"),
            peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        )

    @contextlib.contextmanager
    def oom_guard(self):
        """Log a snapshot and re-raise on device OOM (reference: core/memory.py:40-46)."""
        try:
            yield
        except Exception as err:
            if is_oom_error(err):
                snap = self.snapshot()
                log.error("device OOM; in_use=%s limit=%s", snap.bytes_in_use, snap.bytes_limit)
            raise
