"""What the per-layer metrics read in a traced eval run: the trace of
the window (`trace.Trace`) and the reference's count of the work
(`work.counts`), joined by pool entry.

The profiler slows the host, not the device: the device's busy time a
batch comes from the trace, and the wall time a batch that the idle share
and the model FLOP rate are taken over from the run's untraced window."""

from __future__ import annotations

from ..work import counts
from .spec import arch_module
from .trace import Trace

# the port's kernels by the names their CUDA functions carry
K1_KERNELS = ("sparse_conv_mma_kernel", "sparse_conv_f32_kernel")
K4_KERNELS = ("trilinear_pool_kernel",)


class Layers:
    def __init__(self, tr: dict, stage_names, device):
        self.t = Trace(tr["prof"].profiler.kineto_results.events(), stage_names)
        self.rec = tr["work"]
        self.last = tr["last_entry"]
        self.batch_s = tr["untraced_batch_s"]
        self.n_by_entry = self.t.batches_by_entry()
        self._flops = self._entry_flops(tr, device)

    def _entry_flops(self, tr, device) -> dict:
        """Model FLOPs of one batch of each pool entry: the dense layers'
        (the same shapes in every batch) plus the entry's own sparse
        convs, counted by the architecture module's reference on what the
        traced run kept of the entry."""
        dense = self.rec.dense_flops
        out = {self.last: dense + self.rec.sparse_flops()}
        arch = arch_module(tr["cfg"])
        ref, _ = arch.reference_net(tr["cfg"], tr["sd"], device)
        for p, e in tr["entries"].items():
            if p not in out:
                out[p] = dense + arch.entry_flops(ref, e, tr["B"])
        return out

    def stage_host_ms(self, *names):
        return self.t.stage_host_ms(names)

    def stage_dev_ms(self, *names):
        return self.t.stage_dev_ms(names)

    def idle_pct(self):
        return 100.0 * (1.0 - self.t.busy_s() / self.t.n_batches / self.batch_s)

    def _roofline(self, kernels, works, peak, work_fn):
        ktime = self.t.kernel_seconds_by_batch(kernels).get(self.last, 0.0)
        if ktime <= 0 or not works:
            return None
        least = sum(counts.least_seconds(*work_fn(*w), peak) for w in works)
        return 100.0 * self.n_by_entry[self.last] * least / ktime

    def k1_roofline(self):
        return self._roofline(K1_KERNELS, self.rec.k1, counts.PEAK_BF16, counts.k1_work)

    def k4_roofline(self):
        return self._roofline(K4_KERNELS, self.rec.k4, counts.PEAK_F32, counts.k4_work)

    def mfu(self):
        if any(p not in self._flops for p in self.n_by_entry):
            return None
        total = sum(n * self._flops[p] for p, n in self.n_by_entry.items())
        return 100.0 * total / self.t.n_batches / self.batch_s / counts.PEAK_BF16

    def breakdown(self) -> dict:
        return {"device_ops": self.t.device_ops(), "idle_gaps": self.t.idle_gaps()}
