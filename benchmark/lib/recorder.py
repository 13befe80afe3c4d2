"""The program's own recorder (`btcdet_tpu_torch.utils.trace`) in a traced
eval run: what the per-layer metrics of read-backs and capacity drops read.

After the run's windows and the reference's check, a traced run makes the
cell's network, weights and pool again from the same seed and runs two
more windows, each after one warm-up pass of every pool batch:

1. the recorder window, `--seconds` long, with the recorder on (spans,
   counts and tallies) and no profiler: read-backs and their host wait a
   batch, and the tallies of sites and merged-table rows kept;
2. the sync window, a third as long, under the profiler (CPU + CUDA) with
   the recorder's spans on and its tallies off, so the program launches
   nothing it would not: the device's idle gaps that follow an operation
   launched inside a read-back span, as a share of all idle time.

Neither window is read by a metric that the benchmark had before them. A
checkout whose program has no recorder runs neither, and every metric
read here is then absent (`result` returns None).
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib.util
import sys
import time

# the sync window's length over the run's `--seconds`
SYNC_WINDOW_SHARE = 1 / 3

_result: dict = {}


def sync_idle_share(dev: list, launch: dict, spans: list, t0: int, t1: int) -> float | None:
    """Percent of the device's idle time in [t0, t1] that lies in gaps whose
    preceding operation (the one that ended last before the gap) was
    launched inside one of `spans`.

    dev: device operations (start, end, name, correlation id) sorted by
    start; launch: {correlation id: host start of the launching event};
    spans: sorted, non-overlapping (start, end) host spans; all times in ns
    on one clock. None when the device never idles."""
    idle = waited = 0
    end, last = t0, None
    for op in list(dev) + [(t1, t1, "", None)]:
        s = min(op[0], t1)
        if s > end:
            idle += s - end
            t = None if last is None else launch.get(last[3])
            if t is not None:
                i = bisect.bisect_right(spans, (t, float("inf"))) - 1
                if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                    waited += s - end
        if op[1] > end:
            end, last = op[1], op
    return None if idle == 0 else 100.0 * waited / idle


def _args():
    """The run's workload, seed and seconds, from `benchmark/run.py`'s
    command line; None when the process was started otherwise."""
    ap = argparse.ArgumentParser(add_help=False)
    for k, t in (("--workload", str), ("--seed", int), ("--seconds", float)):
        ap.add_argument(k, type=t)
    a, _ = ap.parse_known_args(sys.argv[1:])
    return None if None in (a.workload, a.seed, a.seconds) else a


def result(layers) -> dict | None:
    """The recorder windows' readings of this run, made on the first call."""
    if "value" not in _result:
        a = _args()
        have = importlib.util.find_spec("btcdet_tpu_torch.utils.trace") is not None
        _result["value"] = (run_windows(a.workload, a.seed, a.seconds, layers.batch_s)
                            if have and a is not None else None)
    return _result["value"]


def cell_runner(workload: str, seed: int, device: str = "cuda"):
    """The cell's network, weights and pool made from the seed as the run
    made them; returns (one, P): one(p) runs pool batch p (copy to the
    device, forward, final NMS, detections to the host) inside the
    profiler range and recorder span `bench.batch.<p>`, and P is the pool's
    size."""
    import torch
    from torch.profiler import record_function

    from btcdet_tpu_torch.config import EasyDict
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.utils import trace

    from ..traffic import generator
    from . import evalcell, weights
    from .spec import Cell, arch_module

    dev = torch.device(device)
    cell = Cell(workload)
    cfg_dict, traffic = cell.config(), cell.traffic()
    cfg = EasyDict(cfg_dict)
    arch = arch_module(cfg_dict)
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device=dev)
    net.load_state_dict(weights.make_state_dict(
        weights.shapes_of(net), generator.seed_of(traffic, "weight_seed", seed), dev))
    pool = [evalcell._host_batch(b, dev) for b in generator.make_pool(cfg_dict, traffic, seed)]

    def one(p):
        with record_function(f"bench.batch.{p}"), trace.span(f"bench.batch.{p}"):
            b = {k: v.to(dev, non_blocking=True) for k, v in pool[p].items()}
            post = arch.post_processing(net(b), cfg, dev)
            return {k: v.cpu() for k, v in post.items()}

    return one, len(pool)


def window(one, P: int, seconds: float) -> tuple:
    """(batches, seconds) of a closed loop over the pool for `seconds`."""
    n, w0 = 0, time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        one(n % P)
        n += 1
    return n, time.perf_counter() - w0


def run_windows(workload: str, seed: int, seconds: float, untraced_batch_s: float,
                device: str = "cuda") -> dict:
    import torch

    from btcdet_tpu_torch.utils import trace

    from .spec import Cell, arch_module
    from .trace import Trace

    t_start = time.perf_counter()
    # the run's trace and check are still held: keep the collector off them,
    # so the host runs these windows as it ran the run's untraced one
    gc.collect()
    gc.freeze()
    one, P = cell_runner(workload, seed, device)
    for p in range(P):
        one(p)
    t_setup = time.perf_counter() - t_start

    trace.enable()
    n, secs = window(one, P, seconds)
    rec = trace.disable()
    out = _readings(rec)
    out["ms_a_batch"] = secs * 1e3 / n

    trace.enable(tallies=False)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window(one, P, seconds * SYNC_WINDOW_SHARE)
    spans = sorted((s, e) for name, s, e, _, _ in trace.disable().spans
                   if name.startswith("sync."))
    stage_names = arch_module(Cell(workload).config()).STAGES
    t = Trace(prof.profiler.kineto_results.events(), stage_names)
    out["sync_idle_share"] = sync_idle_share(t.dev, t.launch, spans, t.t0, t.t1)
    del one, prof, t
    gc.unfreeze()
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"after the window: the recorder's windows {time.perf_counter() - t_start:.2f} s "
          f"(set-up {t_setup:.2f} s); recorder window {n} batches, {out['ms_a_batch']:.2f} ms a "
          f"batch against {untraced_batch_s * 1e3:.2f} untraced", file=sys.stderr)
    return out


def _readings(rec) -> dict:
    """Read-backs a batch (the mean over the pool's entries of each entry's
    mean, so a window's share of each entry does not move it), host ms a
    batch inside read-back spans, and the kept shares of the tallies."""
    syncs, wait, entry = {}, 0, {}
    for i, (name, s, e, _, root) in enumerate(rec.spans):
        if name.startswith("bench.batch."):
            entry[i] = name
            syncs.setdefault(name, {})[i] = 0
        elif name.startswith("sync."):
            syncs[entry[root]][root] += 1
            wait += e - s
    n = sum(len(v) for v in syncs.values())
    per_entry = [sum(v.values()) / len(v) for v in syncs.values()]

    def pct(kept, offered):
        tot = sum(rec.tally(offered)) if offered in rec.tallies else 0
        return None if tot == 0 else 100.0 * float(sum(rec.tally(kept))) / float(tot)

    return {"host_syncs": sum(per_entry) / len(per_entry), "sync_wait_ms": wait * 1e-6 / n,
            "occ_merge_kept_pct": pct("occ.merge.new_rows", "occ.merge.new_cells"),
            "backbone_sites_kept_pct": pct("backbone.sites_kept", "backbone.sites_wanted")}
