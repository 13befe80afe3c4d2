"""The trace reduction on a hand-made trace: spans, attribution of device
operations to the span they were launched in, busy time and idle gaps."""

import pytest

from benchmark.lib.trace import Trace, activity

STAGES = ("occ_subnet", "proposal_nms")


class Ev:
    def __init__(self, name, start, end, kind, corr=0, linked=0):
        self._n, self._s, self._e, self._k = name, start, end, kind
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def device_type(self):
        return "DeviceType.CUDA" if self._k.startswith(("kernel", "gpu")) else "DeviceType.CPU"


def _trace():
    ms = 1_000_000
    ev = [
        Ev("bench.batch.0", 0, 100 * ms, "user_annotation", 1),
        Ev("occ_subnet", 10 * ms, 40 * ms, "user_annotation", 2),
        Ev("aten::conv3d", 12 * ms, 13 * ms, "cpu_op", 3),
        Ev("proposal_nms", 50 * ms, 90 * ms, "user_annotation", 4),
        Ev("aten::sort", 55 * ms, 56 * ms, "cpu_op", 5),
        Ev("cudaLaunchKernel", 12 * ms, 13 * ms, "cuda_runtime", 3),   # a colliding id
        Ev("conv_kernel", 20 * ms, 30 * ms, "kernel", 900, 3),
        Ev("sparse_conv_mma_kernel<64>", 30 * ms, 35 * ms, "kernel", 901, 2),
        Ev("sort_kernel", 60 * ms, 70 * ms, "kernel", 902, 5),
        Ev("occ_subnet", 20 * ms, 30 * ms, "gpu_user_annotation", 2),
        Ev("bench.batch.1", 100 * ms, 200 * ms, "user_annotation", 6),
        Ev("Memcpy HtoD", 100 * ms, 110 * ms, "gpu_memcpy", 903, 6),
    ]
    return Trace(ev, STAGES)


def test_window_busy_and_idle():
    t = _trace()
    assert t.window_s == pytest.approx(0.2)
    assert t.busy_s() == pytest.approx(0.035)          # 20-35, 60-70, 100-110 ms


def test_device_time_goes_to_the_launching_span():
    t = _trace()
    assert t.stage_dev_ms(("occ_subnet",)) == pytest.approx(15 / 2)   # two batches
    assert t.stage_dev_ms(("proposal_nms",)) == pytest.approx(10 / 2)
    assert t.stage_host_ms(("occ_subnet",)) == pytest.approx(30 / 2)
    assert t.kernel_seconds_by_batch(("sparse_conv_mma_kernel",)) == {0: pytest.approx(0.005)}
    assert t.batches_by_entry() == {0: 1, 1: 1}


def test_idle_gaps_by_host_span():
    gaps = dict(_trace().idle_gaps())
    # a gap is named by the span the host was in when it began
    assert gaps["occ_subnet"] == pytest.approx(0.025)       # 35-60 ms
    assert gaps["proposal_nms"] == pytest.approx(0.030)     # 70-100 ms
    assert gaps["no span"] == pytest.approx(0.020 + 0.090)  # 0-20, 110-200 ms
    assert sum(gaps.values()) == pytest.approx(0.2 - 0.035)


def test_activity_without_activity_type():
    assert activity(Ev("occ_subnet", 0, 1, "user_annotation"), STAGES) == "user_annotation"
    assert activity(Ev("cudaLaunchKernel", 0, 1, "cuda_runtime"), STAGES) == "cuda_runtime"
    assert activity(Ev("aten::add", 0, 1, "cpu_op"), STAGES) == "cpu_op"
    assert activity(Ev("k", 0, 1, "kernel"), STAGES) == "kernel"
    assert activity(Ev("bench.h2d", 0, 1, "gpu_user_annotation"), STAGES) == \
        "gpu_user_annotation"
