"""Reduce a ``jax.profiler`` trace to device metrics.

A trace directory holds ``plugins/profile/<run>/*.xplane.pb``. On a GPU the
device planes are named ``/device:GPU:<n>`` and their kernels sit on lines
named ``Stream #<id>(...)``; every event there is one kernel execution with
a start and a duration in nanoseconds. From those events:

- busy time is the union of the kernel intervals (overlapping kernels on
  several streams count once), and the idle share of a window is
  1 - busy / window;
- kernel time is the sum of the durations of the events with a given name.

The reduction lives here, beside the benchmark that uses it, so every run
computes these numbers the same way.
"""
from __future__ import annotations

import glob
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

Interval = Tuple[int, int]


def latest_xspace(trace_dir: str):
    """ProfileData of the newest ``.xplane.pb`` under ``trace_dir``."""
    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return ProfileData.from_file(max(files, key=os.path.getmtime))


def _device_lines(pd) -> Iterable:
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                yield line


def kernel_events(pd) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every kernel on every GPU stream."""
    return [(ev.name, int(ev.start_ns), int(ev.end_ns))
            for line in _device_lines(pd) for ev in line.events]


def union_ns(intervals: Iterable[Interval]) -> int:
    """Total length covered by the union of ``[start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_table(events: Iterable[Tuple[str, int, int]]) -> Dict[str, Dict[str, int]]:
    """{kernel name: {"count", "total_ns"}}, largest total first."""
    table: Dict[str, Dict[str, int]] = defaultdict(lambda: {"count": 0, "total_ns": 0})
    for name, s, e in events:
        table[name]["count"] += 1
        table[name]["total_ns"] += e - s
    return dict(sorted(table.items(), key=lambda kv: -kv[1]["total_ns"]))


def device_summary(events: List[Tuple[str, int, int]]) -> Dict[str, float]:
    """Busy time, window (first kernel start to last kernel end) and idle
    share of the window, from the kernel events of one traced window."""
    if not events:
        raise ValueError("trace holds no GPU kernel: nothing ran on the device")
    busy = union_ns((s, e) for _, s, e in events)
    window = max(e for _, _, e in events) - min(s for _, s, _ in events)
    return {"busy_ns": busy, "window_ns": window,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "kernels": len(events)}
