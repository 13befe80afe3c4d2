"""The recorder (`btcdet_tpu_torch.utils.trace`) on the micro config's eval
forward + post-processing, on the CPU: off it records nothing; on, it
records each stage once under the batch's root span, on the profiler's
clock, a read-back per NMS call as the greedy pass reads back, and the
backbone's and the merge's per-frame tallies equal counts made
independently from the keys each capped call saw."""

import numpy as np
import pytest
import torch

from btcdet_tpu_torch import weights
from btcdet_tpu_torch.datasets import make_synthetic_batch, mini_config
from btcdet_tpu_torch.models import build_network
from btcdet_tpu_torch.models.detectors import btcnet
from btcdet_tpu_torch.ops import iou3d, sparse, voxelizer
from btcdet_tpu_torch.ops.cuda_conv import INT32_MAX
from btcdet_tpu_torch.utils import trace


@pytest.fixture(scope="module")
def micro():
    data_cfg = mini_config.micro_data_cfg(with_occ=True)
    model_cfg = mini_config.micro_model_cfg(with_occ=True)
    # capacities small enough that the strided convs and the merge drop
    model_cfg.BACKBONE_3D.LEVEL_CAPACITIES = [60, 40, 20, 10]
    model_cfg.OCC.OCC_PNT_UPDATE.MERGED_CAP_EXTRA = 8
    net = build_network(model_cfg, data_cfg, ["Car"], device="cpu")
    net.load_state_dict(weights.synth_state_dict(net))       # occupancy points to merge
    batch = make_synthetic_batch(data_cfg, batch_size=2, num_points=2048, num_gt=3, seed=3,
                                 mode="test", device="cpu")
    return net, batch, model_cfg.POST_PROCESSING


def _forward_post(net, batch, post_cfg):
    return btcnet.post_processing(net(batch), post_cfg, 1, device="cpu")


def _independent_counts(monkeypatch):
    """Wrap the capped calls: per call, per frame, the distinct sites wanted
    and kept (from the candidate keys and the kept keys, as chip_smoke's
    frame_site_drops did), and the merge's new cells offered and kept."""
    sites, merges = [], []
    unique_capped, merge_plan = sparse._unique_capped, voxelizer._merge_plan

    def counted_unique(cand_keys, capacity, cells_per_batch, batch_size):
        keys, nnz = unique_capped(cand_keys, capacity, cells_per_batch, batch_size)
        s = torch.sort(cand_keys.long()).values
        first = s != INT32_MAX
        first[1:] &= s[1:] != s[:-1]
        kept = keys.long()[keys.long() != INT32_MAX]
        sites.append(tuple(torch.bincount((k // cells_per_batch).clamp(0, batch_size - 1),
                                          minlength=batch_size).tolist()
                           for k in (s[first], kept)))
        return keys, nnz

    def counted_merge(dkey, dnum, opts, ovalid, grid_size, lo, vs, extra, max_points):
        plan = merge_plan(dkey, dnum, opts, ovalid, grid_size, lo, vs, extra, max_points)
        nxd, nyd, nzd = (int(v) for v in grid_size)
        cell = torch.floor((opts[..., :3] - lo) / vs).long()
        cx, cy, cz = (cell[..., i].clamp(0, n - 1) for i, n in enumerate((nxd, nyd, nzd)))
        okey = (cz * nyd + cy) * nxd + cx
        offered = [len(set(okey[b][ovalid[b]].tolist()) - set(dkey[b].tolist()))
                   for b in range(ovalid.shape[0])]
        merges.append((offered, [min(n, int(extra)) for n in offered]))
        return plan

    monkeypatch.setattr(sparse, "_unique_capped", counted_unique)
    monkeypatch.setattr(voxelizer, "_merge_plan", counted_merge)
    return sites, merges


@pytest.fixture(scope="module")
def recorded(micro):
    """One forward + post under the profiler (CPU) with the recorder on,
    inside a root span, and the independent counts of its capped calls."""
    net, batch, post_cfg = micro
    mp = pytest.MonkeyPatch()
    try:
        sites, merges = _independent_counts(mp)
        trace.enable()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("batch"):
                _forward_post(net, batch, post_cfg)
        rec = trace.disable()
    finally:
        mp.undo()
    events = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name() in btcnet.STAGES]
    return rec, events, sites, merges


def test_off_records_nothing(micro):
    net, batch, post_cfg = micro
    before = dict(trace.COUNTS)

    def never():
        raise AssertionError("a tally's function ran with the recorder off")

    trace.tally("probe", never)
    _forward_post(net, batch, post_cfg)
    assert not trace._rec.on and trace._rec.spans == [] and trace._rec.kept == {}
    assert {k: v for k, v in trace.COUNTS.items() if before.get(k) != v} == {}
    assert trace.span("x") is trace.readback("x")     # the shared no-op


def test_each_stage_once_under_the_batch_root(recorded):
    rec = recorded[0]
    names = [s[0] for s in rec.spans]
    assert names[0] == "batch" and rec.spans[0][3:] == (-1, 0)
    assert [n for n in names if n in btcnet.STAGES] == list(btcnet.STAGES)
    for name, start, end, parent, root in rec.spans[1:]:
        assert root == 0 and 0 <= parent and start >= rec.spans[parent][1]
        assert end <= rec.spans[parent][2]
        if name in btcnet.STAGES:
            assert parent == 0
    # every stage but the last ends before the next one starts
    stages = [s for s in rec.spans if s[0] in btcnet.STAGES]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


def test_self_time_is_duration_less_children(recorded):
    rec = recorded[0]
    own = rec.self_ms()
    for i, (_, s, e, _, _) in enumerate(rec.spans):
        kids = sum(e2 - s2 for _, s2, e2, p, _ in rec.spans if p == i)
        assert own[i] == pytest.approx((e - s - kids) * 1e-6, abs=1e-9)
        assert own[i] >= 0
    assert rec.ms("occ_subnet") == pytest.approx(
        sum(e - s for n, s, e, _, _ in rec.spans if n == "occ_subnet") * 1e-6)


def test_stage_spans_start_on_the_profiler_clock(recorded):
    rec, events = recorded[:2]
    assert len(events) == len(btcnet.STAGES)
    starts = {n: s for n, s, _, _, _ in rec.spans}
    for name, t in events:
        assert abs(starts[name] - t) < 1_000_000, (name, starts[name] - t)


def test_tallies_equal_independent_counts(recorded):
    rec, _, sites, merges = recorded
    wanted, kept = rec.tallies["backbone.sites_wanted"], rec.tallies["backbone.sites_kept"]
    assert [(w.tolist(), k.tolist()) for w, k in zip(wanted, kept)] == [
        (list(w), list(k)) for w, k in sites]
    assert len(sites) >= 3 and sum(rec.tally("backbone.sites_kept")) < sum(
        rec.tally("backbone.sites_wanted"))                       # the capacities cut
    cells, rows = rec.tallies["occ.merge.new_cells"], rec.tallies["occ.merge.new_rows"]
    assert [(c.tolist(), r.tolist()) for c, r in zip(cells, rows)] == [
        (list(c), list(r)) for c, r in merges]
    assert len(merges) == 1 and sum(rec.tally("occ.merge.new_rows")) < sum(
        rec.tally("occ.merge.new_cells"))                         # the headroom binds
    assert rec.sync_counts()["sparse.kept_sites"] == len(sites)


def _boxes(n, spacing=3.0):
    """n cars on a line, none overlapping, scores falling with the index."""
    b = torch.zeros((n, 7))
    b[:, 0] = torch.arange(n) * spacing
    b[:, 3:6] = torch.tensor([2.0, 1.0, 1.5])
    return b, torch.linspace(1.0, 0.1, n)


@pytest.mark.parametrize("n_valid, post_max, want", [
    # every chunk read back, the survivors copied to the card before chunks 2 and 3
    (600, 1000, {"nms.valid": 1, "nms.chunk": 3, "nms.survivors": 2, "nms.kept": 1,
                 "nms.out": 1}),
    (600, 100, {"nms.valid": 1, "nms.chunk": 1, "nms.kept": 1, "nms.out": 1}),   # full at once
    (0, 100, {"nms.valid": 1, "nms.out": 1}),                                   # nothing valid
])
def test_nms_read_backs(n_valid, post_max, want):
    """A read-back of the candidates' validity, one a chunk read back, one
    copy of the survivors to the device before each later chunk, one read
    of the kept indices when any is kept, and one copy of the result."""
    boxes, scores = _boxes(600)
    valid = torch.arange(600) < n_valid
    trace.enable()
    idx, keep = iou3d.nms_rotated(boxes, scores, valid, thresh=0.1, pre_max_size=600,
                                  post_max_size=post_max)
    rec = trace.disable()
    assert rec.sync_counts() == want
    assert int(keep.sum()) == min(n_valid, post_max)
    assert sorted(s[0] for s in rec.spans) == sorted(f"sync.{k}" for k, n in want.items()
                                                    for _ in range(n))


def test_counters_and_switches():
    trace.reset_counts("probe.")
    trace.count("probe.a")
    trace.count("probe.a", 2)
    assert trace.counts("probe.") == {"a": 3}
    trace.enable(tallies=False)
    with pytest.raises(RuntimeError):
        trace.enable()
    trace.count("probe.b")
    trace.tally("probe.t", lambda: torch.ones(2))
    rec = trace.disable()
    assert rec.counts == {"probe.b": 1} and rec.tallies == {}
    with pytest.raises(RuntimeError):
        trace.disable()
    trace.enable(sync=True)         # no card: a span does not synchronise here
    with trace.span("a"), trace.span("b"):
        trace.tally("probe.t", lambda: torch.arange(3))
        trace.tally("probe.t", lambda: torch.ones(3, dtype=torch.int32))
    rec = trace.disable()
    assert [s[3:] for s in rec.spans] == [(-1, 0), (0, 0)]
    np.testing.assert_array_equal(rec.tally("probe.t"), [1, 2, 3])
    trace.reset_counts("probe.")
    assert trace.counts("probe.") == {}
