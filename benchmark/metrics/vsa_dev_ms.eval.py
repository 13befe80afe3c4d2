"""Device ms a batch of the program's `vsa` span (the FPS kernel, the ball
queries, the SA MLPs, the fusion): the operations launched inside it, the
FPS kernel found by time (`work.pvrcnn.fps_seconds_by_batch`: its launch
links to no host op)."""

from benchmark.work import pvrcnn


def read(layers):
    t = layers.t
    ns = 0
    for d in t.dev:
        if not pvrcnn.is_fps(d[2]):
            sp = t._launched_in(d, t.stage_spans)
            if sp is not None and sp[2] == "vsa":
                ns += d[1] - d[0]
    fps_s = sum(pvrcnn.fps_seconds_by_batch(t).values())
    return (ns * 1e-6 + fps_s * 1e3) / t.n_batches
