"""Trace reduction (bench/trace.py): busy time as a union of kernel
intervals, idle share of the window, per-kernel totals."""
import pytest

from video_caption_tpu.bench import trace as tr


def test_union_counts_overlaps_once():
    assert tr.union_ns([]) == 0
    assert tr.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert tr.union_ns([(20, 30), (0, 40), (1, 2)]) == 40
    assert tr.union_ns([(0, 10), (10, 20)]) == 20


def test_device_summary_idle_share():
    events = [("gemm", 0, 40), ("softmax", 30, 50), ("gemm", 80, 100)]
    s = tr.device_summary(events)
    assert s["busy_ns"] == 70 and s["window_ns"] == 100 and s["kernels"] == 3
    assert s["idle_share"] == pytest.approx(0.3)


def test_device_summary_refuses_empty_trace():
    with pytest.raises(ValueError, match="nothing ran on the device"):
        tr.device_summary([])


def test_kernel_table_sums_by_name():
    table = tr.kernel_table([("a", 0, 5), ("b", 0, 20), ("a", 10, 20)])
    assert list(table) == ["b", "a"]
    assert table["a"] == {"count": 2, "total_ns": 15}


def test_kernel_events_read_only_gpu_streams():
    class Ev:
        def __init__(self, name, s, e):
            self.name, self.start_ns, self.end_ns = name, s, e

    class Line:
        def __init__(self, name, events):
            self.name, self.events = name, events

    class Plane:
        def __init__(self, name, lines):
            self.name, self.lines = name, lines

    class PD:
        planes = [
            Plane("/host:CPU", [Line("Stream #1", [Ev("host", 0, 9)])]),
            Plane("/device:GPU:0", [Line("Stream #7(Compute)", [Ev("k", 1, 3)]),
                                    Line("XLA Ops", [Ev("fusion", 1, 3)])]),
        ]

    assert tr.kernel_events(PD()) == [("k", 1, 3)]
