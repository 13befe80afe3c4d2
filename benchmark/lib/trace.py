"""Reduction of a torch.profiler trace of the measured window to the
numbers the per-layer metrics read.

Spans: the program's stage ranges (the architecture module's `STAGES`,
profiler `record_function` ranges) and the benchmark's own (`bench.*`, one
`bench.batch.<pool index>` around each batch). A device operation
(kernel, copy or fill) belongs to the span in which the host launched it,
found through the launch's correlation id. The traced window runs from
the first batch's start to the last batch's end.
"""

from __future__ import annotations

import bisect
import collections

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that carry the ids device operations link to (runtime calls
# carry the CUDA runtime's numbering, which may collide with these)
HOST_KINDS = ("cpu_op", "user_annotation", "python_function")


def _is_span(name: str, stages) -> bool:
    return name in stages or name.startswith("bench.")


def activity(e, stages) -> str:
    """The event's kind as the chrome trace names it, told apart by device
    and name (the CUDA builds of torch this runs on give `_KinetoEvent` no
    `activity_type`)."""
    name = e.name()
    if "CPU" not in str(e.device_type()):
        return "gpu_user_annotation" if _is_span(name, stages) else "kernel"
    if _is_span(name, stages):
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


class Trace:
    def __init__(self, events, stages):
        self.stages = tuple(stages)
        # host events by id: a device operation's linked id names the host
        # event it was launched under (the op, or the span of a direct launch)
        annots, host, dev = [], {}, []
        for e in events:
            kind = activity(e, self.stages)
            if kind in DEVICE_KINDS:
                dev.append((e.start_ns(), e.end_ns(), e.name(),
                            e.linked_correlation_id() or e.correlation_id()))
            elif kind in HOST_KINDS:
                host[e.correlation_id()] = e.start_ns()
                if kind == "user_annotation":
                    annots.append((e.start_ns(), e.end_ns(), e.name()))
        batches = sorted((a for a in annots if a[2].startswith("bench.batch.")))
        if not batches:
            raise RuntimeError("the trace holds no batch span")
        self.t0, self.t1 = batches[0][0], batches[-1][1]
        self.n_batches = len(batches)
        self.batch_spans = batches
        self.stage_spans = sorted(a for a in annots if a[2] in self.stages)
        self.bench_spans = sorted(a for a in annots if a[2].startswith("bench.")
                                  and not a[2].startswith("bench.batch."))
        self.dev = sorted(d for d in dev if d[1] > self.t0 and d[0] < self.t1)
        self.launch = host

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        busy, end = 0, self.t0
        for s, e, _, _ in self.dev:
            s, e = max(s, end), min(e, self.t1)
            if e > s:
                busy += e - s
                end = e
        return busy * 1e-9

    @staticmethod
    def _find(spans, t):
        """The span of a sorted, non-overlapping list that holds time t."""
        i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return spans[i]
        return None

    def _launched_in(self, d, spans):
        t = self.launch.get(d[3])
        return None if t is None else self._find(spans, t)

    def stage_host_ms(self, names) -> float:
        """Wall ms a batch of the host spans named `names`."""
        tot = sum(e - s for s, e, n in self.stage_spans if n in names and s >= self.t0)
        return tot * 1e-6 / self.n_batches

    def stage_dev_ms(self, names) -> float:
        """Device ms a batch of the operations launched inside `names`."""
        tot = 0
        for d in self.dev:
            sp = self._launched_in(d, self.stage_spans)
            if sp is not None and sp[2] in names:
                tot += d[1] - d[0]
        return tot * 1e-6 / self.n_batches

    def kernel_seconds_by_batch(self, match) -> dict:
        """{pool index: device seconds} of kernels whose name contains one
        of `match`, by the batch span they were launched in."""
        out = collections.Counter()
        for d in self.dev:
            if any(m in d[2] for m in match):
                sp = self._launched_in(d, self.batch_spans)
                if sp is not None:
                    out[int(sp[2].rsplit(".", 1)[1])] += (d[1] - d[0]) * 1e-9
        return dict(out)

    def batches_by_entry(self) -> dict:
        return dict(collections.Counter(int(n.rsplit(".", 1)[1]) for _, _, n in self.batch_spans))

    def device_ops(self, n: int = 10) -> list:
        """The n device operations (by name) that took most time: [name, s]."""
        tot = collections.Counter()
        for s, e, name, _ in self.dev:
            tot[name[:160]] += (e - s) * 1e-9
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds of the device by what the host was doing when each
        gap began (the innermost stage span, else the benchmark's span):
        the n largest, [name, s]."""
        tot = collections.Counter()
        end = self.t0
        for s, e, _, _ in self.dev + [(self.t1, self.t1, "", None)]:
            if s > end:
                sp = self._find(self.stage_spans, end) or self._find(self.bench_spans, end)
                tot[sp[2] if sp else "no span"] += (s - end) * 1e-9
            end = max(end, e)
        return [[k, v] for k, v in tot.most_common(n)]
