"""The readers of the program's recorder on hand-made inputs: the share of
idle time after a read-back on a hand-made device trace and read-back
spans, the read-backs a batch by pool entry, the kept shares, and no
reading from a checkout whose program has no recorder."""

import sys

import numpy as np
import pytest

from benchmark.lib import recorder

MS = 1_000_000


def _share(dev, launch, spans, t0=0, t1=100 * MS):
    return recorder.sync_idle_share(sorted(dev), launch, sorted(spans), t0, t1)


def test_idle_after_a_read_back_is_the_read_back_share():
    # device: ops 0-10, 10-20 (overlapping 15-20), 40-50, 60-100 ms; idle 20-40, 50-60
    dev = [(0, 10 * MS, "a", 1), (5 * MS, 20 * MS, "copy", 2), (40 * MS, 50 * MS, "b", 3),
           (60 * MS, 100 * MS, "c", 4)]
    # the copy (the op that ended last before the first gap) was launched at 6 ms,
    # inside the read-back span 5-30 ms; "b" was launched outside any read-back
    launch = {1: 1 * MS, 2: 6 * MS, 3: 32 * MS, 4: 55 * MS}
    assert _share(dev, launch, [(5 * MS, 30 * MS)]) == pytest.approx(100 * 20 / 30)
    assert _share(dev, launch, []) == 0.0
    # a span that closes before the launch does not hold it
    assert _share(dev, launch, [(0, 5 * MS), (31 * MS, 33 * MS)]) == pytest.approx(100 * 10 / 30)


def test_idle_at_the_window_edges_and_none_without_idle():
    dev = [(10 * MS, 20 * MS, "a", 1)]
    launch = {1: 2 * MS}
    # 0-10 ms follows no op (launch-bound); 20-100 ms follows "a", launched in the span
    assert _share(dev, launch, [(1 * MS, 3 * MS)]) == pytest.approx(100 * 80 / 90)
    assert _share([(0, 100 * MS, "a", 1)], launch, [(1 * MS, 3 * MS)]) is None
    # an op whose launch the trace lacks counts as launch-bound
    assert _share(dev, {}, [(1 * MS, 3 * MS)]) == 0.0


class _Rec:
    def __init__(self, spans, tallies):
        self.spans, self.tallies = spans, tallies

    def tally(self, name):
        return np.sum(self.tallies[name], axis=0)


def test_readings_by_pool_entry_and_kept_shares():
    spans = [("bench.batch.0", 0, 100, -1, 0), ("sync.a", 10, 20, 0, 0),
             ("sync.b", 30, 40, 0, 0),
             ("bench.batch.1", 100, 200, -1, 3), ("stage", 110, 190, 3, 3),
             ("sync.a", 120, 150, 4, 3),
             ("bench.batch.0", 200, 300, -1, 6), ("sync.a", 210, 220, 6, 6),
             ("sync.b", 230, 240, 6, 6)]
    tallies = {"occ.merge.new_cells": [np.array([10, 20]), np.array([10, 0])],
               "occ.merge.new_rows": [np.array([5, 10]), np.array([5, 0])],
               "backbone.sites_wanted": [np.array([4, 4])],
               "backbone.sites_kept": [np.array([3, 3])]}
    r = recorder._readings(_Rec(spans, tallies))
    # entry 0: 2 read-backs in each of its 2 batches; entry 1: 1 in its one batch
    assert r["host_syncs"] == pytest.approx((2 + 1) / 2)
    assert r["sync_wait_ms"] == pytest.approx((10 + 10 + 30 + 10 + 10) * 1e-6 / 3)
    assert r["occ_merge_kept_pct"] == pytest.approx(50.0)
    assert r["backbone_sites_kept_pct"] == pytest.approx(75.0)
    assert recorder._readings(_Rec(spans, {}))["occ_merge_kept_pct"] is None


@pytest.mark.parametrize("argv, recorder_there", [
    (["run.py", "--workload", "car.eval_b8", "--seed", "3", "--seconds", "30", "--trace", "1"],
     False),                                        # the parent's program: no recorder
    (["pytest"], True),                             # not started by benchmark/run.py
])
def test_no_reading_without_the_recorder_or_the_run_line(monkeypatch, argv, recorder_there):
    class Layers:
        batch_s = 0.1

    def never(*a, **k):
        raise AssertionError("the windows ran")

    monkeypatch.setattr(recorder, "run_windows", never)
    monkeypatch.setattr(recorder, "_result", {})
    monkeypatch.setattr(sys, "argv", argv)
    if not recorder_there:
        monkeypatch.setattr(recorder.importlib.util, "find_spec", lambda name: None)
    assert recorder.result(Layers()) is None
