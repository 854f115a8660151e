"""The yardstick's byte counts, the trace's reduction and the per-layer
readers, on synthetic events."""

import pytest
import torch

from bench import harness, yardstick


def test_alloc_bytes_match_the_kernel_table():
    # x read once, theta and chips written once: the bound of the kernel
    # table, 0.001146 ms at [192, 1000] f64; the theta pass at Fig 4's
    # [10, 500] 0.000024 ms.
    b = yardstick.alloc_launch_bytes(192, 1000, "float64", quantized=True)
    assert b == 192 * 1000 * 20
    assert round(b / yardstick.HBM_BYTES_PER_S * 1e3, 6) == 0.001146
    t = yardstick.alloc_launch_bytes(10, 500, "float64", quantized=False)
    assert round(t / yardstick.HBM_BYTES_PER_S * 1e3, 6) == 0.000024


def test_event_step_bytes():
    assert yardstick.event_step_bytes(3, 5, "float64", True) == 3 * 5 * (16 + 4)
    assert yardstick.event_step_bytes(3, 5, "float64", False) == 3 * 5 * 24
    assert yardstick.event_step_bytes(3, 5, "float32", False) == 3 * 5 * 12
    assert yardstick.roofline_share(3.35e12, 2.0) == pytest.approx(50.0)
    assert yardstick.roofline_share(0, 1.0) is None


class Ev:
    def __init__(self, name, start, dur, cuda=False, tid=1, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._tid, self._a = cuda, tid, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._a


def _events():
    # host: one unit span [0, 100]; aten ops a [0, 30] (with a nested op),
    # b [40, 50], c [60, 95]; device: k1 [10, 30], k2 [20, 35] overlapping,
    # a copy [70, 80], and the span's device shadow (not work).
    return [
        Ev(harness.UNIT_SPAN, 0, 100),
        Ev(harness.UNIT_SPAN, 0, 100, cuda=True, annotation=True),
        Ev("aten::a", 0, 30), Ev("aten::nested", 5, 10), Ev("aten::b", 40, 10),
        Ev("aten::c", 60, 35), Ev("cudaLaunchKernel", 12, 2),
        Ev("k1", 10, 20, cuda=True), Ev("k2", 20, 15, cuda=True),
        Ev("Memcpy DtoH", 70, 10, cuda=True),
    ]


def test_summarize_union_counts_and_gaps():
    s = harness.summarize(_events(), window_s=100e-9)
    assert s["busy_s"] == pytest.approx(35e-9)  # [10, 35] and [70, 80]
    assert s["kernels"] == 2 and s["host_ops"] == 3
    assert s["kernel_rows"]["k1"] == [1, pytest.approx(20e-9)]
    gaps = dict(s["idle_gaps"])
    # [0, 10] under a; [35, 70] mid 52.5, after b ended; [80, 100] mid 90 under c.
    assert gaps["aten::a"] == pytest.approx(10e-9)
    assert gaps["host outside aten ops"] == pytest.approx(35e-9)
    assert gaps["aten::c"] == pytest.approx(20e-9)


def test_readers():
    trace = harness.summarize(_events(), window_s=100e-9)
    ctx = {"trace": trace, "steps": 4, "loop_bytes": 3.35e12 * 10e-9,
           "alloc_launch_bytes": None, "peak_bytes": 2e9}

    def read(name, c=ctx):
        return harness.load_reader(name).read(c)

    assert read("host_ops_per_step") == pytest.approx(0.75)
    assert read("kernels_per_step") == pytest.approx(0.5)
    assert read("idle_share") == pytest.approx(65.0)
    assert read("loop_roofline") == pytest.approx(10.0)
    assert read("peak_gb") == pytest.approx(2.0)
    assert read("alloc_roofline") is None  # no kernel in this cell: nothing to read
    trace["kernel_rows"]["void hesrpt_alloc_kernel<double, 4>(...)"] = [2, 4e-9]
    with_alloc = {**ctx, "alloc_launch_bytes": 3.35e12 * 1e-9}
    assert read("alloc_roofline", with_alloc) == pytest.approx(50.0)
    assert read("host_ops_per_step", {**ctx, "trace": None}) is None


def test_per_layer_leaves_out_a_metric_with_nothing_to_read():
    cell = harness.load_cell("online-n256.fused")
    ctx = {"trace": harness.summarize(_events(), 100e-9), "steps": 4, "loop_bytes": 1.0,
           "alloc_launch_bytes": None, "peak_bytes": 3e9}
    got = harness.read_per_layer(cell, ctx)
    assert got["peak_gb"] == {"value": pytest.approx(3.0), "unit": "GB"}
    assert got["host_ops_per_step"]["value"] == pytest.approx(0.75)
    assert "alloc_roofline" not in got  # no kernel rows in the trace
