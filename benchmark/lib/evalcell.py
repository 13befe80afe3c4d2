"""An eval cell: the program's eval forward and its post-processing over
a pool of batches made from the seed, closed loop with one batch in
flight.

Set-up builds the program's network, makes the weights on the device,
makes the pool (pinned on the host) and runs every pool batch once. The
window then cycles the pool: each batch is copied to the device, runs
the forward and the final NMS, and its detections are read back to the
host, which ends it. After the window the peak memory is read and the
frozen reference checks what the window produced: every stage of the
last batch, each from what the program handed it, and the final NMS of
a sample of the window's batches drawn from the seed.

What this needs to know of the network (its hooks, its final NMS, its
comparison with the reference) comes from the configuration's
architecture module (`benchmark/arch/`, `spec.arch_module`).

A traced run first runs the window untraced, then once more under the
profiler: the profiler slows the host, so the untraced wall time a batch
is what the device's idle share and the model FLOP rate are taken over.
"""

from __future__ import annotations

import random
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..traffic import generator
from . import weights
from .spec import arch_module

# share of the window's batches whose final NMS the reference redoes
FINAL_SAMPLE = 1 / 8


def _host_batch(batch_np: dict, device) -> dict:
    ts = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch_np.items()}
    if device.type == "cuda":
        ts = {k: v.pin_memory() for k, v in ts.items()}
    return ts


def build_kernels():
    """The port's CUDA kernels, built in parallel when missing (the first
    run of a checkout); later runs load the built libraries."""
    from btcdet_tpu_torch.ops import kernel_build

    names = sorted(p.stem for p in kernel_build.CSRC.glob("*.cu"))
    kernel_build.build(names)
    for n in names:
        kernel_build.load(n)


def run(cfg_dict: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, limits: dict, control: bool = False) -> dict:
    """One run of the cell: set-up, the window, the comparison with the
    reference. `control` also reads the control's numbers (the reference
    in the control's precision in the program's place) on the same batch."""
    from btcdet_tpu_torch.config import EasyDict
    from btcdet_tpu_torch.models import build_network

    cuda = device.type == "cuda"
    cfg = EasyDict(cfg_dict)
    arch = arch_module(cfg_dict)
    marks = [("start", time.perf_counter())]
    if cuda:
        build_kernels()
    marks.append(("kernels", time.perf_counter()))
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device=device)
    marks.append(("network", time.perf_counter()))
    sd = weights.make_state_dict(weights.shapes_of(net),
                                 generator.seed_of(traffic, "weight_seed", seed), device)
    net.load_state_dict(sd)
    marks.append(("weights", time.perf_counter()))
    pool = [_host_batch(b, device) for b in generator.make_pool(cfg_dict, traffic, seed)]
    marks.append(("traffic", time.perf_counter()))
    P, B = len(pool), int(traffic["batch_size"])
    cap = arch.Capture(net, cfg)

    def one(p):
        with record_function(f"bench.batch.{p}"):
            t0 = time.perf_counter()
            with record_function("bench.h2d"):
                b = {k: v.to(device, non_blocking=True) for k, v in pool[p].items()}
            cap.clear()
            with record_function("bench.forward"):
                out = net(b)
            with record_function("bench.post"):
                post = arch.post_processing(out, cfg, device)
            with record_function("bench.to_host"):
                det = {k: v.cpu() for k, v in post.items()}
            return b, out, det, time.perf_counter() - t0

    for p in range(P):
        one(p)
    cap.clear()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", time.perf_counter()))
    print("set-up: imports %.2f s, " % (marks[0][1] - t_start) + ", ".join(
        f"{n} {t - marks[i][1]:.2f} s" for i, (n, t) in enumerate(marks[1:])), file=sys.stderr)

    untraced_batch_s = None
    if trace:
        u0, nu = time.perf_counter(), 0
        while time.perf_counter() - u0 < seconds:
            one(nu % P)
            nu += 1
        untraced_batch_s = (time.perf_counter() - u0) / nu
        cap.clear()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    pick = random.Random(int(seed))
    lat, sampled, entries = [], [], {}
    n = 0
    w0 = time.perf_counter()
    while True:
        p = n % P
        b, out, det, dt = one(p)
        lat.append(dt)
        n += 1
        done = time.perf_counter() - w0 >= seconds
        if done or pick.random() < FINAL_SAMPLE:
            sampled.append((arch.final_inputs(out), det))
        if trace:
            entries[p] = cap.entry()
        if done:
            break
        del b, out, det
    window_s = time.perf_counter() - w0
    if trace:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    last = dict(batch=b, out=out, entry=p, **cap.kept())
    cap.remove()
    del one, net, cap
    if cuda:
        torch.cuda.empty_cache()

    res = dict(setup_s=setup_s, window_s=window_s, frames=n * B, batches=n, lat=lat,
               peak=peak)
    q = statistics.quantiles(lat, n=4) if n >= 2 else [lat[0]] * 3
    half = n // 2
    print(f"window: {n} batches in {window_s:.2f} s; batch ms quartiles "
          f"{q[0] * 1e3:.1f} / {q[1] * 1e3:.1f} / {q[2] * 1e3:.1f}, max {max(lat) * 1e3:.1f}; "
          f"halves {sum(lat[:half]) * 1e3 / max(half, 1):.1f} / "
          f"{sum(lat[half:]) * 1e3 / max(n - half, 1):.1f} ms a batch", file=sys.stderr)
    res["eval_fps"] = n * B / window_s
    res["eval_batch_p90_ms"] = statistics.quantiles(lat, n=10)[8] * 1e3 if n >= 2 else lat[0] * 1e3
    res["peak_mem_mib"] = peak / 2**20
    t_check = time.perf_counter()
    checks, rec = arch.check(cfg_dict, sd, last, sampled, device, want_work=trace)
    print(f"after the window: the reference's check {time.perf_counter() - t_check:.2f} s "
          f"({len(sampled)} batches' final NMS)", file=sys.stderr)
    res["checks"], res["correct"] = judge(checks, limits)
    if control:
        res["control"] = arch.check(cfg_dict, sd, last, sampled, device, lowp=True)[0]
    if trace:
        res["trace"] = dict(prof=prof, work=rec, entries=entries, last_entry=last["entry"],
                            sd=sd, cfg=cfg_dict, B=B, untraced_batch_s=untraced_batch_s)
    return res


def judge(checks: dict, limits: dict) -> tuple:
    """({number: {value, limit}}, correct): correct when every number read
    is at or under its limit and every limit was read. A limit that the run
    did not read shows with the value None."""
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    unread = [k for k in limits if k not in checks]
    out.update({k: {"value": None, "limit": limits[k]} for k in unread})
    correct = not unread and all(k in limits and v <= limits[k] for k, v in checks.items())
    return out, correct
