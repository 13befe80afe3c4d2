"""Read-backs a batch: the program's `sync.*` counters (`utils.trace.readback`)
in the recorder window, per batch of each pool entry, averaged over the entries."""

from benchmark.lib import recorder


def read(layers):
    r = recorder.result(layers)
    return None if r is None else r["host_syncs"]
