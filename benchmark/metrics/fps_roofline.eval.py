"""The FPS kernel's share of its roofline: the least time of the
reference's sampling (ops at float32's peak, bytes at HBM3's rate,
`work.pvrcnn.fps_work`) over the kernel's time in the last pool entry's
batches (`work.pvrcnn.fps_seconds_by_batch`), in percent. None where the
run's work recorder counts no sampling or the trace holds no FPS kernel."""

from benchmark.work import counts, pvrcnn


def read(layers):
    works = getattr(layers.rec, "fps", None)
    ktime = pvrcnn.fps_seconds_by_batch(layers.t).get(layers.last, 0.0)
    if not works or ktime <= 0:
        return None
    least = sum(counts.least_seconds(*pvrcnn.fps_work(*w), counts.PEAK_F32) for w in works)
    return 100.0 * layers.n_by_entry[layers.last] * least / ktime
