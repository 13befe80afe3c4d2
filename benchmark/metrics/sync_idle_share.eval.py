"""Share of the device's idle time, in percent, in gaps whose preceding
operation was launched inside a read-back span (the sync window); the rest
of the idle time is the host launching too slowly."""

from benchmark.lib import recorder


def read(layers):
    r = recorder.result(layers)
    return None if r is None else r["sync_idle_share"]
