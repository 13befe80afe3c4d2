"""The port's one recorder: spans, counters and tallies, kept in memory.

    from btcdet_tpu_torch.utils import trace
    trace.enable()
    with trace.span("batch"):
        post_processing(net(batch), ...)
    rec = trace.disable()          # a Recording

- `span(name)` records the name, start and end on `time.time_ns()` (the
  clock torch.profiler stamps its host events with, so a recording joins
  a device trace of the same window), the index of the enclosing span
  and of the outermost one (its root: the spans of one batch share it).
  It is not a profiler range and launches nothing.
- `stage(name)` is the profiler range `name` (what `torch.profiler`
  traces and the benchmark reads) with a span of the same name inside.
- `readback(site)` wraps a statement that waits for the device (a copy
  to the host, a data-dependent shape): a span `sync.<site>` and a count
  `sync.<site>`.
- `count(name, n)` adds to a host integer counter. Counters are always
  on: the kernel wrappers count their launches as `launch.<kernel>`.
- `tally(name, fn)` keeps `fn()`, a per-frame (B,) integer tensor on the
  device, without waiting for it; a recording reads each tally once.

Off (the default), `span`, `stage`'s span and `readback` cost one flag
check and `tally` calls nothing. `enable(tallies=False)` records spans
and counts only, launching nothing the program would not;
`enable(sync=True)` synchronises the device around every span but the
read-backs, so a span's time is its stage's device time too (for stage
breakdowns, never for throughput); `enable(sync_debug="error")` sets
`torch.cuda.set_sync_debug_mode` for the recording and lifts it inside
each read-back, so any other synchronisation raises. One recording at a
time, on one thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

# always-on host counters, by name
COUNTS: dict = {}

_NULL = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.on = False
        self.tallies = self.sync = False
        self.sync_debug = None
        self.spans, self.stack, self.kept, self.counts0 = [], [], {}, {}


_rec = _State()


@dataclasses.dataclass
class Recording:
    """What one `enable()` ... `disable()` recorded."""
    spans: list     # (name, start_ns, end_ns, parent index or -1, root index), in open order
    counts: dict    # {name: what each counter added while on}
    tallies: dict   # {name: [one (B,) int64 array a call]}

    def ms(self, name: str) -> float:
        """Wall ms of the spans called `name`, summed."""
        return sum(e - s for n, s, e, _, _ in self.spans if n == name) * 1e-6

    def self_ms(self) -> list:
        """Each span's wall ms less the part its child spans cover."""
        out = [(e - s) * 1e-6 for _, s, e, _, _ in self.spans]
        for _, s, e, parent, _ in self.spans:
            if parent >= 0:
                out[parent] -= (e - s) * 1e-6
        return out

    def tally(self, name: str) -> np.ndarray:
        """A tally's per-frame sum over its calls."""
        return np.sum(self.tallies[name], axis=0)

    def sync_counts(self) -> dict:
        """{site: count} of the read-backs."""
        return {k[5:]: v for k, v in self.counts.items() if k.startswith("sync.")}


def enable(*, tallies: bool = True, sync: bool = False, sync_debug: str | None = None):
    """Start a recording (see the module's docstring for the switches)."""
    if _rec.on:
        raise RuntimeError("the recorder is already on")
    _rec.__init__()
    _rec.on, _rec.tallies, _rec.sync, _rec.sync_debug = True, tallies, sync, sync_debug
    _rec.counts0 = dict(COUNTS)
    if sync_debug is not None:
        torch.cuda.set_sync_debug_mode(sync_debug)


def disable() -> Recording:
    """End the recording and return it; the tallies are read here."""
    if not _rec.on:
        raise RuntimeError("the recorder is off")
    if _rec.sync_debug is not None:
        torch.cuda.set_sync_debug_mode(0)
    _rec.on = False
    counts = {k: v - _rec.counts0.get(k, 0) for k, v in COUNTS.items()
              if v != _rec.counts0.get(k, 0)}
    tallies = {k: [t.cpu().numpy() for t in v] for k, v in _rec.kept.items()}
    rec = Recording([tuple(s) for s in _rec.spans], counts, tallies)
    _rec.__init__()
    return rec


class _Span:
    __slots__ = ("i", "syncs")

    def __init__(self, name: str, syncs: bool):
        self.syncs = syncs
        if syncs:
            torch.cuda.synchronize()
        self.i = len(_rec.spans)
        parent = _rec.stack[-1] if _rec.stack else -1
        root = _rec.spans[parent][4] if parent >= 0 else self.i
        _rec.spans.append([name, time.time_ns(), 0, parent, root])
        _rec.stack.append(self.i)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.syncs:
            torch.cuda.synchronize()
        _rec.spans[self.i][2] = time.time_ns()
        _rec.stack.pop()
        return False


class _Readback(_Span):
    __slots__ = ()

    def __init__(self, site: str):
        count("sync." + site)
        if _rec.sync_debug is not None:
            torch.cuda.set_sync_debug_mode(0)
        super().__init__("sync." + site, False)

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if _rec.sync_debug is not None:
            torch.cuda.set_sync_debug_mode(_rec.sync_debug)
        return False


def span(name: str):
    """A recorded span (a context manager); a no-op while the recorder is off."""
    if not _rec.on:
        return _NULL
    return _Span(name, _rec.sync and torch.cuda.is_available())


@contextlib.contextmanager
def stage(name: str):
    """The profiler range `name` around a recorded span of the same name."""
    with record_function(name), span(name):
        yield


def readback(site: str):
    """A statement that waits for the device, as span and count `sync.<site>`."""
    if not _rec.on:
        return _NULL
    return _Readback(site)


def count(name: str, n: int = 1):
    COUNTS[name] = COUNTS.get(name, 0) + n


def counts(prefix: str) -> dict:
    """{name without the prefix: count} of the counters named `prefix...`."""
    return {k[len(prefix):]: v for k, v in COUNTS.items() if k.startswith(prefix)}


def reset_counts(prefix: str):
    for k in [k for k in COUNTS if k.startswith(prefix)]:
        del COUNTS[k]


def tally(name: str, fn):
    """Keep `fn()`, a (B,) integer tensor a frame, while the recorder is on
    with tallies; otherwise `fn` is not called."""
    if _rec.on and _rec.tallies:
        _rec.kept.setdefault(name, []).append(fn().to(torch.int64))
