"""The benchmark's count of the work of PV-RCNN's furthest point sampling
kernel (`csrc/furthest_point_sample.cu`), beside `counts`' of K1 and the
model's FLOPs.

Counted from what the frozen reference (`reference.pvref`) samples on the
same batch: frames, keypoints and the valid points of each frame. Each of
the K - 1 steps lowers every valid point's running distance to its squared
distance from the last pick and compares it: 3 subtractions, 3
multiplications, 2 additions, a minimum and a comparison, 10 operations a
valid point a step. Bytes: the coordinates read once (float32) and the
keypoints' indices written once (int64).
"""

from __future__ import annotations

from . import counts

# the kernel by the names its CUDA functions carry (`fps_kernel<PER, SMEM>`,
# `fps_kernel_large`)
FPS_KERNELS = ("fps_kernel",)
OPS_PER_POINT_STEP = 10


def is_fps(name: str) -> bool:
    return any(k in name for k in FPS_KERNELS)


def fps_seconds_by_batch(t) -> dict:
    """{pool index: device seconds} of the FPS kernels of trace `t`
    (`lib.trace.Trace`), by the batch span in which each started. The
    kernel is launched through ctypes from a plain function, which the
    profiler links to no host op, so a link by id (`Trace._launched_in`)
    finds no batch or another one. Time finds it: each batch span ends
    with its detections' copy to the host, which waits for the device, so
    a kernel that starts inside a batch span ran in that batch."""
    out = {}
    for s, e, name, _ in t.dev:
        if is_fps(name):
            sp = t._find(t.batch_spans, s)
            if sp is not None:
                p = int(sp[2].rsplit(".", 1)[1])
                out[p] = out.get(p, 0.0) + (e - s) * 1e-9
    return out


def fps_work(frames: int, keypoints: int, valid_points: int, points: int) -> tuple:
    """(ops, bytes) of one call: `valid_points` summed over its `frames`,
    `points` the slots of every frame (B * N)."""
    ops = (keypoints - 1) * valid_points * OPS_PER_POINT_STEP
    nbytes = points * 3 * counts.F32 + frames * keypoints * 8
    return ops, nbytes


class WorkRecorder(counts.WorkRecorder):
    """`counts.WorkRecorder` that also records each furthest point
    sampling the reference runs (`fps`: (frames, keypoints, valid points,
    points) a call)."""

    def __init__(self):
        super().__init__()
        self.fps = []

    def __enter__(self):
        super().__enter__()
        from ..reference.btcref.ops import group_ops

        fn, rec = group_ops.furthest_point_sample, self

        def furthest_point_sample(xyz, mask, npoint):
            rec.fps.append((int(mask.shape[0]), int(npoint), int(mask.bool().sum().item()),
                            int(mask.numel())))
            return fn(xyz, mask, npoint)

        group_ops.furthest_point_sample = furthest_point_sample
        self._stack.callback(setattr, group_ops, "furthest_point_sample", fn)
        return self
