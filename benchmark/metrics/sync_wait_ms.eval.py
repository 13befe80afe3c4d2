"""Host ms a batch inside the program's read-back spans (`sync.*`), in the
recorder window, which runs without the profiler."""

from benchmark.lib import recorder


def read(layers):
    r = recorder.result(layers)
    return None if r is None else r["sync_wait_ms"]
