#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`btcdet_tpu_torch`): the full
flagship BtcNet eval forward (occupancy subnet included) on one CUDA
card, its det-only variant as a second path, the det backbone's four
occ-code variants (`config.flagship_occ_variant`) as a third, and the
flagship training step (and the `fix` variant's) as a fourth.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `btcdet_tpu_torch/csrc` (one nvcc per
     source, started together) and print the build seconds;
  3. capture: one forward of the full flagship model at B=2 records the
     inputs its kernels see (these launches are not counted);
  4. kernel phase: each kernel against its plain PyTorch version on the
     captured inputs (K1's neighbour map bit for bit, its bf16 gather-GEMM
     to 1e-2 of the plain output's max and bit for bit on a repeat, K4 in
     bf16 within one bf16 ulp, K2 max bit for bit), with kernel (event and
     profiler kernel-alone) / plain / library times and the card's bound;
     a table of all 18 K1 launches of the eval forward over the maps it
     built (shape, matches, kernel-alone ms, bound) and their sum; the
     maps built per forward asserted equal to the distinct (input table,
     sites, geometry) pairs;
  5. main path: launch counts reset, the full forward + post-processing
     run once and every kernel (K1 map and GEMM, K2, K4) must have
     launched, the maps EVAL_MAPS times; occ points
     and merged det voxels per frame, nnz per level, detections, median
     forward ms over 5 runs after 2 warm-ups, peak memory, ms per stage,
     and one profiled step (device idle share, top kernels), the occ
     subnet identical from run to run and its stage ms with the occ
     backbone's scoped deterministic cuDNN and without it, the proposal
     NMS's chunked pass against the full-matrix greedy (same kept boxes,
     both timed); then the det-only flagship as the second path: counts
     reset, one run, its launches (K1 map and GEMM and K4), and its
     median; then the occ-code
     variants (`fix`, `avgpool`, `weight`, `maxpool`) as the third: the
     `fix` and `avgpool` forwards captured and K2 sum held bit for bit
     against its plain version on their calls (the three levels of `fix`,
     the k=2 call of `avgpool`), then for each variant counts reset, one
     run with its launches asserted, its outputs checked and nnz per
     level, and for `fix` its median and ms per stage;
  6. small-input checks: small full and det-only configs in float32 on
     the card against the plain path on the CPU, same weights and batch
     (full config: the occ subnets compared, run to run on the card as
     well, then the det paths on the card's occ outputs); the micro
     config's `fix` and `avgpool` variants the same way; the det backbone
     module alone at the flagship's widths for OUT_FEAT_TYPE `combine` and
     `big_combine`;
  7. train phase: the full flagship in `net.train()` at B=2 with the
     train caps. One captured step records its kernel calls; K3 (the
     weight gradient) is held against its plain version on five of them
     (bf16, to 1e-2 of the plain output's max, and bit for bit on a
     repeat), and at the step's own inputs K1's forward (conv1), its
     transpose-query df (a strided conv) and subm df, K2 and K4; then counts
     reset, one step where every kernel (K1 forward and df, K2, K3, K4)
     must launch, with its loss terms, per-partition gradient norms and
     moved parameters and BN statistics; 10 steps timed; and one step
     in float32 on the card against the CPU (loss terms
     to 1e-3, gradients to 1e-3 of each tensor's max) on the micro config;
     then the `fix` variant's train step: one counted step in which K1
     forward and df, K3, K2 sum and K4 launch and the attention blocks and
     conv1_combine get gradients, then 3 timed steps;
  8. a JSON line of per-kernel numbers, then the contract line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # float32 outside the tensor cores
TOL = 1e-2                     # kernel vs plain, relative to the plain output's max
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the eval path's kernels (K1 is the neighbour map and the gather-GEMM);
# a train step adds K1's df and K3
EVAL_KERNELS = ("neighbor_map", "sparse_conv", "sparse_pool", "trilinear_pool")
# neighbour maps a flagship-layout eval forward builds, one per distinct
# (input key table, output sites, geometry): subm1-4, spconv2, spconv3
# (conv3 and down2[0]), spconv4 (conv4, down2[1] and down3 all read the
# spconv3 table), spconv_down2, subm_down2; the occ-code variants add
# none (their convs pair like the trunk's)
EVAL_MAPS = 9


def kernel_modules():
    """{kernel wrapper name: (the ops module holding it, its launch counter)}."""
    from btcdet_tpu_torch.ops import cuda_conv, cuda_interp, cuda_pool

    return {"neighbor_map": (cuda_conv, "nbr_launches"), "sparse_conv": (cuda_conv, "launches"),
            "sparse_conv_df": (cuda_conv, "df_launches"),
            "sparse_conv_dw": (cuda_conv, "dw_launches"), "sparse_pool": (cuda_pool, "launches"),
            "sparse_sum_pool": (cuda_pool, "sum_launches"),
            "trilinear_pool": (cuda_interp, "launches")}


def reset_launches():
    for mod, counter in kernel_modules().values():
        setattr(mod, counter, 0)


def read_launches(names=None) -> dict:
    return {name: getattr(mod, counter) for name, (mod, counter) in kernel_modules().items()
            if names is None or name in names}


def capture_kernel_inputs(run):
    """Call run() with recording wrappers around the kernel entry points;
    returns the recorded calls (args, kwargs) of each, in order."""
    mods = kernel_modules()
    calls = {name: [] for name in mods}
    orig = {name: getattr(mod, name) for name, (mod, _) in mods.items()}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return orig[name](*args, **kw)
        return rec

    for name, (mod, _) in mods.items():
        setattr(mod, name, recorder(name))
    try:
        run()
    finally:
        for name, (mod, _) in mods.items():
            setattr(mod, name, orig[name])
    return calls


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels whose name holds `kernel` over
    `reps` calls of fn(), from torch.profiler: the kernel's own time, where
    `cuda_ms` of back-to-back calls also counts the gaps a slower host
    leaves between short launches. The profiler may miss a few of a
    session's launches; the mean is over those it saw, at least half."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    assert 2 * len(times) >= reps, f"the profiler saw {len(times)} {kernel} kernels of {reps}"
    return sum(times) / len(times) / 1e3


def k1_bound(feats, w, nbr):
    """(bytes, flops, bound seconds, bound_by) of K1's gather-GEMM over the
    map `nbr`: what this run's data needs. The input rows some tap
    matched, the map, the weights of taps that matched anything and the
    f32 output, each once; 2 * Cin * Cout flops a match at the bf16
    tensor-core rate, the rate of the TPU kernel it replaces."""
    found = nbr >= 0
    matches = int(found.sum())
    rows_read = int(nbr[found].unique().numel())
    taps_used = int(found.any(dim=1).sum())
    cin = feats.shape[1]
    K, M = nbr.shape
    cout = w.shape[2]
    nbytes = (rows_read * cin * feats.element_size() + K * M * 4
              + taps_used * cin * cout * w.element_size() + M * cout * 4)
    flops = 2.0 * cin * cout * matches
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    return nbytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbr_bound(keys, nbr):
    """(bytes, bound seconds) of a neighbour-map build: the output coords
    and the live keys the searches run over, read once, and the (K, M)
    int32 map written once."""
    K, M = nbr.shape
    live_keys = int((keys != 2**31 - 1).sum())
    nbytes = M * 16 + live_keys * 4 + K * M * 4
    return nbytes, nbytes / HBM_BYTES_PER_S


def k1_case(name, args, df: bool = False, transpose: bool = False):
    """Compare / time K1 on one captured call: the neighbour map (bit for
    bit against its plain version), then the gather-GEMM over it in bf16 (a
    forward, `sparse_conv`, or with `df` the df of a conv's backward,
    `sparse_conv_df`: a submanifold conv's over the same sites with
    tap-reversed weights, or with `transpose` a strided conv's in
    transpose-query mode, where the table is the output gradient keyed by
    the forward's output sites and the queries are its input sites),
    against its plain version to TOL and bit for bit on a repeat. Returns
    the entries of the map and of the GEMM."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    feats, keys, coords, w, shape, bsz, ksize, stride, pad = args[:9]
    feats, w = feats.detach().to(torch.bfloat16), w.detach().to(torch.bfloat16)
    cargs = (feats, keys, coords, w, shape, bsz, ksize, stride, pad)

    def build():
        return cuda_conv.neighbor_map(keys, coords, shape, bsz, ksize, stride, pad, transpose)

    nbr = build()
    nbr_ref = cuda_conv.neighbor_map_plain(keys, coords, shape, ksize, stride, pad, transpose)
    torch.cuda.synchronize()
    assert torch.equal(nbr, nbr_ref), f"K1 map {name}: kernel and plain version differ"
    if df:
        def kern():
            return cuda_conv.sparse_conv_df(*cargs, transpose=transpose, nbr=nbr)

        def plain():
            return cuda_conv.sparse_conv_plain(*cargs, transpose=transpose)
    else:
        def kern():
            return cuda_conv.sparse_conv(*cargs, nbr=nbr)

        def plain():
            return cuda_conv.sparse_conv_plain(*cargs)
    out, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"K1 {name}: two bf16 runs differ"
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= TOL * max(scale, 1e-6), f"K1 {name}: max err {err} vs plain max {scale}"
    nbytes, flops, bound_s, bound_by = k1_bound(feats, w, nbr)
    map_bytes, map_bound_s = nbr_bound(keys, nbr)
    ms = cuda_ms(kern, reps=20)
    kernel_ms = device_ms(kern, "sparse_conv_mma_kernel")
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    map_ms = cuda_ms(build, reps=20)
    map_kernel_ms = device_ms(build, "sparse_nbr_kernel")
    map_plain_ms = cuda_ms(lambda: cuda_conv.neighbor_map_plain(keys, coords, shape, ksize, stride,
                                                                pad, transpose), reps=5, warmup=1)
    N, cin = feats.shape
    K, M = nbr.shape
    cout = w.shape[2]
    log(f"K1 {name}: N={N} M={M} Cin={cin} Cout={cout} kernel={ksize} stride={stride} "
        f"matches={int((nbr >= 0).sum())} bytes={nbytes} flops={flops:.0f} max_abs_err={err:.3e} "
        f"(plain max {scale:.3e}, bitwise repeatable) ms={ms:.4f} (kernel alone, profiler: "
        f"{kernel_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={bound_s * 1e3:.4f}; map: bitwise "
        f"equal, ms={map_ms:.4f} (kernel alone {map_kernel_ms:.4f}) plain_ms={map_plain_ms:.4f} "
        f"bound_ms={map_bound_s * 1e3:.4f}")
    gemm = {"name": f"{'sparse_conv_df' if df else 'sparse_conv'}:{name}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_conv.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:511", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": None}
    nmap = {"name": f"neighbor_map:{name}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_nbr.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:511", "max_abs_err": 0.0, "ms": map_ms,
            "plain_ms": map_plain_ms, "bound_ms": map_bound_s * 1e3, "bound_by": "bytes",
            "library_ms": None}
    return [nmap, gemm]


def k1_eval_table(conv_calls, map_calls):
    """Every K1 launch of one eval forward, from its captured calls: each
    gather-GEMM over the map the forward built for it (shape, matches,
    kernel-alone ms from one profiler session, bound), their sum, and the
    forward's map builds with theirs."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    fns, rows = [], []
    for i, (a, kw) in enumerate(conv_calls):
        feats, keys, coords, w, shape, bsz, ksize, stride, pad = a[:9]
        nbr = kw["nbr"]
        fns.append(lambda a=a, nbr=nbr: cuda_conv.sparse_conv(*a[:9], nbr=nbr))
        _, flops, bound_s, by = k1_bound(feats, w, nbr)
        rows.append((i, tuple(feats.shape), coords.shape[0], w.shape[2], ksize, stride,
                     int((nbr >= 0).sum()), flops, bound_s, by))
    ms = [device_ms(fn, "sparse_conv_mma_kernel", reps=5) for fn in fns]
    log(f"K1 eval launches ({len(rows)}, bf16 gather-GEMM, kernel alone from the profiler, "
        "mean of 5 runs each):")
    for (i, fshape, M, cout, ksize, stride, matches, flops, bound_s, by), t in zip(rows, ms):
        log(f"  #{i:2d} N,Cin={fshape} M={M} Cout={cout} kernel={ksize} stride={stride} "
            f"matches={matches} ms={t:.4f} bound_ms={bound_s * 1e3:.4f} ({by}) "
            f"TFLOP/s={flops / (t * 1e-3) / 1e12:.1f}")
    maps = [lambda a=a, kw=kw: cuda_conv.neighbor_map(*a, **kw) for a, kw in map_calls]
    map_ms = [device_ms(fn, "sparse_nbr_kernel", reps=5) for fn in maps]
    log(f"K1 eval forward: {len(rows)} gather-GEMM launches {sum(ms):.4f} ms of kernel in all; "
        f"{len(maps)} map builds {sum(map_ms):.4f} ms ({[round(t, 4) for t in map_ms]})")
    torch.cuda.synchronize()


def k2_case(args, label: str = "", mode: str = "max"):
    """Compare (bit for bit) / time K2 on a captured occ-code pool: max mode
    (`sparse_pool`) or sum mode (`sparse_sum_pool`, FixedSparseConv3d).
    `label` names a call of another path than the eval forward."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv, cuda_pool

    kern_fn, plain_fn = ((cuda_pool.sparse_pool, cuda_pool.sparse_pool_plain) if mode == "max"
                         else (cuda_pool.sparse_sum_pool, cuda_pool.sparse_sum_pool_plain))
    feats, keys, coords, shape, bsz, ksize, stride, pad = args
    feats = feats.detach()
    args = (feats, keys, coords, shape, bsz, ksize, stride, pad)
    out = kern_fn(*args)
    ref = plain_fn(feats, keys, coords, shape, ksize, stride, pad)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), f"K2 {mode} {label}: kernel and plain version differ"
    err = float((out - ref).abs().max())
    # bound: the input rows some tap matched, the live keys the search runs
    # over, out_coords and the f32 output at capacity; one comparison per
    # match and channel
    idx, found = cuda_conv.conv_rulebook(keys, coords, shape, ksize, stride, pad)
    matches = int(found.sum())
    rows_read = int(idx[found].unique().numel())
    live_keys = int((keys != cuda_conv.INT32_MAX).sum())
    N, C = feats.shape
    M = coords.shape[0]
    nbytes = rows_read * C * 4 + live_keys * 4 + M * 16 + M * C * 4
    flops = float(matches * C)
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    ms = cuda_ms(lambda: kern_fn(*args), reps=20)
    kernel_ms = device_ms(lambda: kern_fn(*args), "sparse_pool_kernel")
    plain_ms = cuda_ms(lambda: plain_fn(feats, keys, coords, shape, ksize, stride, pad), reps=5,
                       warmup=1)
    log(f"K2 {kern_fn.__name__} ({mode}){' ' + label if label else ''}: N={N} M={M} C={C} "
        f"kernel={ksize} stride={stride} padding={pad} "
        f"matches={matches} rows_read={rows_read} live_keys={live_keys} "
        f"rows_with_a_match={int(found.any(0).sum())} bytes={nbytes} max_abs_err={err} "
        f"(bitwise equal) ms={ms:.4f} (kernel alone, profiler: {kernel_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_s * 1e3:.4f}")
    name = "sparse_pool" if mode == "max" else "sparse_pool_sum"
    return {"name": name + (f":{label}" if label else ""), "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_pool.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:511", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations", "library_ms": None}


def k4_reads(vol, zyx, roi_b, valid):
    """(distinct volume cells, corner reads) that the valid samples of this
    run need: in-volume corners only, since the others weigh 0 and are not
    read."""
    import torch

    B, D, H, W, _ = vol.shape
    ok = valid & ((roi_b >= 0) & (roi_b < B))[:, None]
    pts = zyx[ok]                                             # (n, 3)
    b = roi_b[:, None].expand(valid.shape)[ok].long()
    base = torch.floor(pts).long()
    cells = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                z, y, x = base[:, 0] + dz, base[:, 1] + dy, base[:, 2] + dx
                inb = (z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
                cells.append((((b * D + z) * H + y) * W + x)[inb])
    cells = torch.cat(cells)
    return int(cells.unique().numel()), int(cells.numel())


def k4_case(args, label: str = ""):
    """Compare / time K4 on the captured ConvHead call (`label` names a
    call of another path than the eval forward); grid_sample as the
    library yardstick."""
    import torch
    import torch.nn.functional as F

    from btcdet_tpu_torch.ops import cuda_interp

    vol, zyx, roi_b, valid = args
    vol = vol.detach().to(torch.bfloat16)      # the view ConvHead passes, read in place
    out = cuda_interp.trilinear_pool(vol, zyx, roi_b, valid)
    ref = cuda_interp.trilinear_pool_plain(vol, zyx, roi_b, valid)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.bfloat16
    # both add the 8 weighted corners in the same order in f32 and round
    # once: at most one bf16 ulp apart (bit for bit when no f32 step differs)
    diff = (out.float() - ref.float()).abs()
    mag = torch.maximum(out.float().abs(), ref.float().abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool((diff <= ulp).all()), f"K4: {float((diff / ulp).max())} bf16 ulps from plain"
    n_diff = int((diff > 0).sum())
    err = float(diff.max())
    scale = float(ref.float().abs().max())
    B, D, H, W, C = vol.shape
    R, S, _ = zyx.shape
    n_valid = int(valid.sum())
    # bound: the volume cells this run's samples touch, every point, flag
    # and roi index (the kernel reads them all), and the whole output in
    # its dtype
    n_cells, n_reads = k4_reads(vol, zyx, roi_b, valid)
    nbytes = (n_cells * C * vol.element_size() + R * S * 12 + R * S + R * 4
              + R * S * C * out.element_size())
    flops = 2.0 * C * n_reads
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    ms = cuda_ms(lambda: cuda_interp.trilinear_pool(vol, zyx, roi_b, valid), reps=20)
    kernel_ms = device_ms(lambda: cuda_interp.trilinear_pool(vol, zyx, roi_b, valid),
                          "trilinear_pool_kernel")
    plain_ms = cuda_ms(lambda: cuda_interp.trilinear_pool_plain(vol, zyx, roi_b, valid),
                       reps=5, warmup=1)
    # library yardstick: 5-D grid_sample (zeros padding, align_corners) on the
    # same volume; rois are batch-ordered, N per frame
    lib_ms, lib_err, lib_kernel_ms = None, None, None
    if R % B == 0 and bool((roi_b == torch.arange(B, device=roi_b.device)
                            .repeat_interleave(R // B)).all()):
        # f32 copy of the bf16 volume (same values): a bf16 grid would round
        # the sample positions themselves
        inp = vol.float().permute(0, 4, 1, 2, 3).contiguous()
        size = torch.tensor([W, H, D], dtype=torch.float32, device=zyx.device)
        grid = (2.0 * zyx.flip(-1) / (size - 1) - 1.0).reshape(B, (R // B) * S, 1, 1, 3)

        def lib():
            return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)
        got = lib().float().reshape(B, C, R // B * S).permute(0, 2, 1).reshape(R, S, C)
        lib_err = float((got - out.float())[valid].abs().max())
        lib_ms = cuda_ms(lib, reps=20)
        lib_kernel_ms = device_ms(lib, "grid_sampler_3d")
    log(f"K4 trilinear_pool{' ' + label if label else ''}: volume={tuple(vol.shape)} "
        f"strides={vol.stride()} out {out.dtype} R={R} S={S} valid={n_valid} "
        f"cells_read={n_cells} corner_reads={n_reads} bytes={nbytes} flops={flops:.0f} "
        f"max_abs_err={err:.3e} ({n_diff} of {out.numel()} elements differ, all within one "
        f"bf16 ulp; plain max {scale:.3e}) ms={ms:.4f} (kernel alone, profiler: "
        f"{kernel_ms:.4f}) plain_ms={plain_ms:.4f} grid_sample_ms={lib_ms} (kernel alone "
        f"{lib_kernel_ms}; max diff to kernel {lib_err}) bound_ms={bound_s * 1e3:.4f}")
    return {"name": "trilinear_pool" + (f":{label}" if label else ""), "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/trilinear_pool.cu",
            "replaces": "btcdet_tpu/ops/pallas_interp.py:150", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations", "library_ms": lib_ms}


def stage_times(net, batch, post_cfg) -> dict:
    """Wall ms per stage of one forward + post-processing, each stage
    between two device synchronisations."""
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing

    times = {}
    net.stage_ms = times
    try:
        post_processing(net(batch), post_cfg, 1, stage_ms=times)
    finally:
        net.stage_ms = None
    return {s: round(times[s], 3) for s in STAGES if s in times}


def stage_profile(net, batch, post_cfg):
    """Where the time goes in one forward + post-processing: wall ms per
    stage, then one step under torch.profiler for the device's idle share
    and its top kernels."""
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing

    log("stage ms (synchronised): " + json.dumps(stage_times(net, batch, post_cfg)))
    profile_step(lambda: post_processing(net(batch), post_cfg, 1), STAGES)


def occ_determinism(net, batch, post_cfg):
    """The occ subnet's probabilities must be the same from run to run (the
    occ backbone runs its convs under a scoped deterministic cuDNN), and
    what that costs: the `occ_subnet` stage ms with the scope and with it
    bypassed (cuDNN's default algorithms), median of 5 runs each, taken in
    turns."""
    bb = net.occ_modules.backbone_3d
    probs = [net.occ_modules(batch)["probs"] for _ in range(3)]
    spread = max(float((p - probs[0]).abs().max()) for p in probs)
    assert spread == 0.0, f"occ probabilities move by {spread} between runs"
    ms = {"scoped deterministic cuDNN": [], "cuDNN default algorithms": []}
    for i in range(10):
        bypass = i % 4 in (1, 2)
        if bypass:
            bb.forward = bb._forward
        try:
            ms["cuDNN default algorithms" if bypass else "scoped deterministic cuDNN"].append(
                stage_times(net, batch, post_cfg)["occ_subnet"])
        finally:
            if bypass:
                del bb.forward
    log("occ subnet, full flagship (B=2): probabilities identical over 3 runs; occ_subnet stage "
        "ms, median of 5: " + json.dumps({k: round(statistics.median(v), 3)
                                          for k, v in ms.items()})
        + " all " + json.dumps({k: [round(t, 3) for t in v] for k, v in ms.items()}))


def check_eval_outputs(net, batch, out, post):
    """Finite eval outputs of the expected shapes and finite detections;
    returns the detections per frame."""
    import torch

    B = batch["points"].shape[0]
    occ_grid = tuple(int(v) for v in net.occ_modules.spec.grid_size[::-1])
    n_anchor = net.det_modules.dense_head.anchors.shape[0]
    K = net.occ_modules.eval_max_occ_pnts
    expect = {"occ_probs": (B, *occ_grid), "occ_points": (B, K, 4),
              "rpn_box_preds": (B, n_anchor, 7), "batch_box_preds": (B, 100, 7),
              "batch_cls_preds": (B, 100, 1), "spatial_features_2d": (B, 200, 176, 256)}
    for k, shp in expect.items():
        assert tuple(out[k].shape) == shp, (k, tuple(out[k].shape), shp)
        assert torch.isfinite(out[k].float()).all(), k
    assert ((out["occ_probs"] >= 0) & (out["occ_probs"] <= 1)).all()
    assert torch.isfinite(post["pred_boxes"]).all() and torch.isfinite(post["pred_scores"]).all()
    return [int(v) for v in post["pred_valid"].sum(dim=1)]


def occ_variant_paths():
    """The third path: the full flagship with each of the det backbone's
    occ-code variants (`config.flagship_occ_variant`), eval forward +
    post-processing at B=2. K2 sum is held bit for bit against its plain
    version on the captured calls of `fix` (levels 1-3, k=3) and of
    `avgpool` (level 1, k=2); then per variant the launch counts are reset,
    one run's launches asserted and its outputs checked. Returns the K2 sum
    entries of the kernels line."""
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    entries = []
    for down in config.OCC_VARIANT_DOWNSAMPLERS:
        cfg = config.flagship_occ_variant(down)
        net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"])
        net.load_state_dict(weights.synth_state_dict(net))
        batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                     seed=0, mode="test")
        cases = []
        if down in ("fix", "avgpool"):
            calls = capture_kernel_inputs(lambda: net(batch))["sparse_sum_pool"]
            assert len(calls) == 3, (down, len(calls))
            for level, (args, _) in enumerate(calls[:3 if down == "fix" else 1], start=1):
                cases.append(k2_case(args, f"{down}_l{level}", mode="sum"))
            del calls
        reset_launches()
        out = net(batch)
        post = post_processing(out, cfg.MODEL.POST_PROCESSING, 1)
        torch.cuda.synchronize()
        launches = read_launches()
        want = {"neighbor_map": EVAL_MAPS, "sparse_conv": 23 if down == "weight" else 20,
                "sparse_conv_df": 0,
                "sparse_conv_dw": 0, "sparse_pool": 3 if down == "maxpool" else 0,
                "sparse_sum_pool": 3 if down in ("fix", "avgpool") else 0, "trilinear_pool": 1}
        log(f"occ variant {down!r} path launches: {json.dumps(launches)}")
        assert launches == want, (down, launches, want)
        for e in cases:
            e["launches"] = launches["sparse_sum_pool"]
        entries += cases
        n_det = check_eval_outputs(net, batch, out, post)
        log(f"occ variant {down!r}: nnz per level {json.dumps(out['nnz'])}; occ points per frame "
            f"{[int(v) for v in out['occ_points_mask'].sum(dim=1)]}; detections per frame {n_det}")
        if down == "fix":
            med, times = timed_median(lambda: forward_post(net, batch, cfg))
            log(f"forward+post ms, flagship occ variant 'fix' (B=2, 5 runs after 2 warm-ups): "
                f"median {med:.2f} all {[round(t, 2) for t in times]}")
            log(f"occ variant 'fix' max_memory_allocated: "
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
            log("occ variant 'fix' stage ms (synchronised): "
                + json.dumps(stage_times(net, batch, cfg.MODEL.POST_PROCESSING)))
        del net, batch, out, post
    return entries


def profile_step(fn, ranges=(), label: str = "step"):
    """One call of fn() under torch.profiler: wall ms, kernel time, the
    device's idle share and the top kernels (names in `ranges` are the
    profiler ranges of the stages, not kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(t for _, t in kernels.values())
    log(f"profiled {label}: wall {wall:.2f} ms (profiler on), kernel time {busy:.2f} ms, "
        f"device idle share {1 - busy / wall:.3f}")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"  {t:9.3f} ms  x{n:<5d} {name[:100]}")


def full_matrix_nms(boxes, scores, valid, *, thresh, pre_max_size, post_max_size):
    """Greedy rotated NMS over the whole (k, k) suppression matrix, one IoU
    row per kept box (the JAX package's eval NMS): the yardstick that the
    port's chunked pass is held to and timed against. Returns the kept
    input indices in order."""
    import numpy as np
    import torch

    from btcdet_tpu_torch.ops import iou3d

    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    k = min(pre_max_size, boxes.shape[0])
    top_scores, top_idx = torch.sort(s, descending=True, stable=True)
    top_idx, top_valid = top_idx[:k], top_scores[:k] > neg_inf
    tb = boxes[top_idx]
    iou = torch.cat([iou3d.boxes_iou_bev(tb[i:i + 256], tb) for i in range(0, k, 256)])
    suppress = (iou > thresh).cpu().numpy()
    alive = top_valid.cpu().numpy().copy()
    kept = []
    while len(kept) < post_max_size and alive.any():
        i = int(np.argmax(alive))
        kept.append(i)
        alive &= ~suppress[i]
        alive[i] = False
    return top_idx.cpu()[kept]


def proposal_nms_check(net, batch):
    """The eval proposal NMS's calls (one per frame, k = NMS_PRE_MAXSIZE)
    captured from one forward: the port's chunked pass keeps the same
    boxes as the full-matrix greedy, and both are timed (host clock, 5
    runs of every call after 2 warm-ups, median)."""
    import torch

    from btcdet_tpu_torch.ops import iou3d

    calls, orig = [], iou3d.nms_rotated

    def rec(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    iou3d.nms_rotated = rec
    try:
        net(batch)
    finally:
        iou3d.nms_rotated = orig
    for a, kw in calls:
        idx, ok = orig(*a, **kw)
        want = full_matrix_nms(*a, **kw)
        assert torch.equal(idx[ok].cpu(), want), "chunked and full-matrix NMS keep other boxes"

    def run(fn):
        def all_calls():
            for a, kw in calls:
                fn(*a, **kw)
            torch.cuda.synchronize()
        return timed_median(all_calls)[0]

    chunked, full = run(orig), run(full_matrix_nms)
    log(f"proposal NMS, {len(calls)} calls (k = {[min(kw['pre_max_size'], a[0].shape[0]) for a, kw in calls]}"
        f" -> {calls[0][1]['post_max_size']}, same kept sets): chunked {chunked:.3f} ms, "
        f"full matrix {full:.3f} ms (median of 5)")


def small_config(full: bool):
    """The flagship model at full widths on a 16 m scene: the full config
    (occ grid 29 x 41 x 9, every occ candidate kept) or its det-only
    variant."""
    from btcdet_tpu_torch import config

    cfg = config.flagship() if full else config.flagship_det_only()
    d = cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [0.0, -8.0, -3.0, 16.0, 8.0, 1.0]
    for proc in d.DATA_PROCESSOR:
        if proc.NAME == "det_transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.1, 0.1, 0.1]
            proc.MAX_NUMBER_OF_VOXELS = {"train": 4000, "test": 4000}
        if proc.NAME == "transform_points_to_sphere_voxels":
            proc.VOXEL_SIZE = [0.5, 2.0, 0.45]
            proc.MAX_POINTS_PER_VOXEL = 8
            proc.MAX_NUMBER_OF_VOXELS = {"train": 3000, "test": 3000}
    m = cfg.MODEL
    if full:
        d.OCC.VOXEL_SIZE = [0.5, 2.0, 0.45]
        d.OCC.POINT_CLOUD_RANGE = [2.0, -41.0, -2.6, 16.5, 41.0, 1.45]
        d.OCC.SUPPORT_SPHERE_RANGE = [2.0, -42.0, -16.6, 16.5, 42.0, 4.0, 2.0]
        m.OCC.PARAMS.EVAL_MAX_NUM_OCC_PNTS = 4096
        m.OCC.OCC_PNT_UPDATE.MERGED_CAP_EXTRA = 4096
    del m.BACKBONE_3D["LEVEL_CAPACITIES"]
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 256
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 32
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 32
    return cfg


def same_point_sets(a, am, b, bm, tol):
    """Per frame, the valid rows of a and b (xyz + prob) pair up one to one
    within `tol` (max abs difference), in whatever order. Returns the
    largest paired difference."""
    import torch

    worst = 0.0
    for f in range(a.shape[0]):
        pa, pb = a[f][am[f]], b[f][bm[f]]
        assert pa.shape == pb.shape, f"frame {f}: {pa.shape[0]} vs {pb.shape[0]} occ points"
        d = (pa[:, None, :] - pb[None, :, :]).abs().amax(-1)
        nearest = d.argmin(1)
        assert nearest.unique().numel() == pa.shape[0], f"frame {f}: occ points pair up twice"
        worst = max(worst, float(d.min(1).values.max()) if len(pa) else 0.0)
    assert worst <= tol, f"occ point sets differ by {worst}"
    return worst


@contextlib.contextmanager
def f32_everywhere():
    """Float32 activations in the port (`BTCDET_F32=1`) and no TF32 in
    cuBLAS or cuDNN, for the duration."""
    import torch

    old = os.environ.get("BTCDET_F32")
    os.environ["BTCDET_F32"] = "1"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if old is None:
            del os.environ["BTCDET_F32"]
        else:
            os.environ["BTCDET_F32"] = old


def micro_variant_config(down: str):
    """The micro config (`datasets.mini_config`, 8 channels on a 6.4 m scene)
    with the det backbone's occ-code variant `down`."""
    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import mini_config

    cfg = config.EasyDict({"DATA_CONFIG": mini_config.micro_data_cfg(with_occ=True),
                           "MODEL": mini_config.micro_model_cfg(with_occ=True, occ_down=down)})
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    return cfg


def small_input_check(cfg, label: str, spread: bool = False):
    """f32 on the card (kernels) against f32 on the CPU (plain versions).

    With the occupancy subnet (MODEL.OCC) the occ subnets of the two
    devices are compared first (probabilities, occ point sets, merged det
    voxel sets); the CPU's det path then reads the card's occ outputs, so
    the downstream comparison sees the same occ points in the same order.
    The order of probabilities that tie to within f32 rounding differs
    between the devices, and it decides the ball query's first picks.
    `spread`: the card's occ probabilities must also be identical over 3
    runs (the occ backbone's scoped deterministic cuDNN); the spread with
    that scope bypassed is printed beside it."""
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network

    full = cfg.MODEL.get("OCC") is not None
    with f32_everywhere():
        outs, occ = {}, {}
        for dev in ("cuda", "cpu"):
            net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device=dev)
            net.load_state_dict(weights.synth_state_dict(net))
            batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=4096,
                                         num_gt=4, seed=3, mode="test", device=dev)
            hook = None
            if full and dev == "cuda":
                hook = net.occ_modules.register_forward_hook(
                    lambda m, i, o: occ.update(cuda={k: v.cpu() if torch.is_tensor(v) else v
                                                     for k, v in o.items()}))
            elif full:
                occ["cpu"] = net.occ_modules(batch)
                hook = net.occ_modules.register_forward_hook(lambda m, i, o: occ["cuda"])
            outs[dev] = {k: v.cpu() for k, v in net(batch).items() if torch.is_tensor(v)}
            if hook is not None:
                hook.remove()
            if spread and dev == "cuda":
                bb, spreads = net.occ_modules.backbone_3d, {}
                for scope in ("scoped deterministic cuDNN", "cuDNN default algorithms"):
                    if scope == "cuDNN default algorithms":
                        bb.forward = bb._forward
                    try:
                        p = [net.occ_modules(batch)["probs"] for _ in range(3)]
                    finally:
                        bb.__dict__.pop("forward", None)
                    spreads[scope] = max(float((q - p[0]).abs().max()) for q in p)
                assert spreads["scoped deterministic cuDNN"] == 0.0, spreads
    g, c = outs["cuda"], outs["cpu"]
    assert torch.equal(g["roi_valid"], c["roi_valid"]), "roi sets differ"
    worst = {}
    keys = ["encoded_features", "spatial_features_2d", "rpn_cls_preds", "rpn_box_preds", "rois",
            "batch_cls_preds", "batch_box_preds"]
    if full:
        go, co = occ["cuda"], occ["cpu"]
        merged = {}
        for dev, o in occ.items():
            mc = o["det_voxel_coords"]
            merged[dev] = {tuple(r) for r in mc[mc[:, 0] >= 0].tolist()}
        assert merged["cuda"] == merged["cpu"], (
            f"merged det voxel sets differ: {len(merged['cuda'] ^ merged['cpu'])} coords")
        worst["occ_probs"] = float((go["probs"] - co["probs"]).abs().max())
        torch.testing.assert_close(go["probs"], co["probs"], rtol=1e-3, atol=1e-3)
        worst["occ_points (as sets)"] = same_point_sets(
            go["occ_points"], go["occ_points_mask"], co["occ_points"], co["occ_points_mask"], 1e-3)
        order = (go["occ_points"] - co["occ_points"]).abs().amax(-1) > 1e-3
        worst["occ_points out of CPU order"] = int(order.sum())
        assert (g["occ_points_mask"].sum(1) > 0).all()
    for k in keys:
        gk, ck = g[k].float(), c[k].float()
        assert gk.shape == ck.shape and torch.isfinite(gk).all(), k
        worst[k] = float((gk - ck).abs().max())
        torch.testing.assert_close(gk, ck, rtol=1e-3, atol=1e-3, msg=lambda m, k=k: f"{k}: {m}")
    extra = ""
    if full:
        n_occ = [int(v) for v in g["occ_points_mask"].sum(1)]
        extra = f" (occ points per frame {n_occ}, merged det voxels {len(merged['cuda'])})"
    log(f"small-input check, {label}{extra} (cuda f32 vs cpu f32, rtol=atol=1e-3): max abs diff "
        + json.dumps(worst))
    if spread:
        log("card run-to-run spread of the occ probabilities over 3 runs: " + json.dumps(spreads))


def backbone_module_check():
    """The det backbone alone, the `fix` variant at the flagship's widths
    (16/32/64/64/128) on the flagship's grid, in float32 on the card against
    the CPU for OUT_FEAT_TYPE `combine` and `big_combine` (the model runs
    `big_bev_combine` only): every output level to 1e-3."""
    import numpy as np
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models import backbones_3d
    from btcdet_tpu_torch.ops import sparse

    grid, B, per_frame, cap = (41, 200, 176), 2, 4000, 24000
    rng = np.random.RandomState(5)
    coords = []
    for b in range(B):
        c = np.stack([np.full(3 * per_frame, b), rng.randint(0, 41, 3 * per_frame),
                      rng.randint(40, 120, 3 * per_frame), rng.randint(20, 100, 3 * per_frame)], 1)
        coords.append(np.unique(c, axis=0)[:per_frame])
    coords = np.concatenate(coords + [np.full((cap - B * per_frame, 4), -1)]).astype(np.int32)
    feats = rng.randn(cap, 6).astype(np.float32)
    feats[:, -2:] = rng.rand(cap, 2)
    worst = {}
    with f32_everywhere():
        for comb in ("combine", "big_combine"):
            outs = {}
            for dev in ("cuda", "cpu"):
                bb = backbones_3d.VoxelBackBone8xOcc(
                    6, (16, 32, 64, 64, 128), out_feat_type=("None",) * 4 + (comb,),
                    occ_code_num=2, occ_conv_type=("identity",) + ("fix",) * 3,
                    occ_conv_exec=(True,) * 4, out_att=(True, True, False, False))
                bb.load_state_dict(weights.synth_state_dict(bb))
                bb.to(dev).eval()
                st = sparse.from_coords(torch.from_numpy(feats).to(dev),
                                        torch.from_numpy(coords).to(dev), grid, B)
                with torch.no_grad():
                    out = bb(st, st.features[:, -2:])
                outs[dev] = {k: (v.features.cpu(), v.keys.cpu(), int(v.nnz))
                             for k, v in out.items() if v is not None}
            assert outs["cuda"].keys() == outs["cpu"].keys()
            for k, (gf, gk, gn) in outs["cuda"].items():
                cf, ck, cn = outs["cpu"][k]
                assert torch.equal(gk, ck) and gn == cn, f"{comb} {k}: site sets differ"
                assert torch.isfinite(gf).all(), (comb, k)
                torch.testing.assert_close(gf, cf, rtol=1e-3, atol=1e-3,
                                           msg=lambda m, k=k: f"{comb} {k}: {m}")
                worst[f"{comb}:{k}"] = float((gf - cf).abs().max())
            log(f"backbone module check, OUT_FEAT_TYPE {comb!r}: nnz "
                + json.dumps({k: v[2] for k, v in outs["cuda"].items()}))
    log("backbone module check (the `fix` variant at flagship widths, cuda f32 vs cpu f32, "
        "rtol=atol=1e-3): max abs diff " + json.dumps(worst))


def k3_case(name, args):
    """Compare / time K3 (the sparse-conv weight gradient) on one captured
    call of a train step's backward; a second run must equal the first
    bit for bit."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    feats, keys, coords, g, shape, bsz, ksize, stride, pad = args
    feats = feats.detach()
    args = (feats, keys, coords, g, shape, bsz, ksize, stride, pad)
    out = cuda_conv.sparse_conv_dw(*args)
    again = cuda_conv.sparse_conv_dw(*args)
    ref = cuda_conv.sparse_conv_dw_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"K3 {name}: two runs differ"
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= TOL * max(scale, 1e-6), f"K3 {name}: max err {err} vs plain max {scale}"
    # bound: what this run's data needs: the input rows some tap matched,
    # the rows of g with a match, each read once, and dW written once;
    # 2 * Cin * Cout flops per match at the bf16 tensor-core rate, the
    # rate of the TPU kernel it replaces (bf16 x bf16 products of the rows
    # and of g, f32 accumulation), as K1's bound
    idx, found = cuda_conv.conv_rulebook(keys, coords, shape, ksize, stride, pad)
    matches = int(found.sum())
    rows_read = int(idx[found].unique().numel())
    g_rows = int(found.any(dim=0).sum())
    N, cin = feats.shape
    M, cout = g.shape
    K = out.shape[0]
    nbytes = rows_read * cin * feats.element_size() + g_rows * cout * 4 + K * cin * cout * 4
    flops = 2.0 * cin * cout * matches
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS)
    ms = cuda_ms(lambda: cuda_conv.sparse_conv_dw(*args), reps=10)
    plain_ms = cuda_ms(lambda: cuda_conv.sparse_conv_dw_plain(*args), reps=3, warmup=1)
    n_chunks, _ = cuda_conv.dw_chunks(M, K, cin, cout)
    log(f"K3 {name}: N={N} M={M} Cin={cin} Cout={cout} kernel={ksize} stride={stride} "
        f"{feats.dtype} matches={matches} rows_read={rows_read} g_rows={g_rows} "
        f"chunks={n_chunks} bytes={nbytes} flops={flops:.0f} max_abs_err={err:.3e} "
        f"(plain max {scale:.3e}, bitwise repeatable) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_s * 1e3:.4f}")
    return {"name": f"sparse_conv_dw:{name}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_conv_dw.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:392", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_TENSOR_FLOPS
            else "operations", "library_ms": None}


def train_setup(cfg, num_points: int, num_gt: int, seed: int, device="cuda"):
    """A flagship-layout net in train mode with synthetic weights, its dual
    optimizer and a `mode="train"` synthetic batch."""
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import trainer

    torch.manual_seed(seed)
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device=device)
    # synthetic weights by name, but the output projections keep the
    # model's own init (the JAX package's: cls prior bias, std-0.001 box
    # and rcnn weights); synthetic box weights decode to boxes of up to
    # 1e22 m whose exp overflows once training moves them
    own, sd = net.state_dict(), weights.synth_state_dict(net)
    head = net.det_modules.roi_head
    finals = [f"det_modules.roi_head.{t}.{len(list(getattr(head, t).children())) - 1}"
              for t in ("cls_layers", "reg_layers")]
    for k in ("det_modules.dense_head.conv_cls.bias", "det_modules.dense_head.conv_box.weight",
              *(f + ".weight" for f in finals), *(f + ".bias" for f in finals)):
        sd[k] = own[k].cpu()
    net.load_state_dict(sd)
    net.train()
    opt = trainer.create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, 1000)
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=num_points,
                                 num_gt=num_gt, seed=seed, mode="train", device=device)
    return net, opt, batch


def train_phase():
    """The flagship training step at full width (B=2, train caps): kernel
    checks on a captured step, one counted step, 10 timed steps."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES
    from btcdet_tpu_torch.ops import cuda_interp
    from btcdet_tpu_torch.train import trainer

    cfg = config.flagship()
    net, opt, batch = train_setup(cfg, 16384, 10, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = capture_kernel_inputs(lambda: trainer.train_step(net, opt, batch, gen))
    torch.cuda.synchronize()
    log("train capture: " + ", ".join(f"{len(v)} {k} calls" for k, v in calls.items())
        + " per step")

    def pick_dw(kernel, stride, cin, cout):
        return next(a for a, _ in calls["sparse_conv_dw"]
                    if a[6] == kernel and a[7] == stride and a[0].shape[1] == cin
                    and a[3].shape[1] == cout)

    picks = {"conv1(subm 6->16)": pick_dw((3, 3, 3), (1, 1, 1), 6, 16),
             "conv2(3^3 s2 16->32)": pick_dw((3, 3, 3), (2, 2, 2), 16, 32),
             "conv2_combine_0(subm 34->32)": pick_dw((3, 3, 3), (1, 1, 1), 34, 32),
             "conv_out(3x1x1 s2 64->128)": pick_dw((3, 1, 1), (2, 1, 1), 64, 128),
             "down_combine_0(subm 256->128)": pick_dw((3, 3, 3), (1, 1, 1), 256, 128)}
    entries = [k3_case(name, args) for name, args in picks.items()]
    # K1 at the step's own inputs: conv1's forward over the train-cap
    # table, the transpose-query df of conv2, the subm df of down_combine_0
    fwd = next(a for a, _ in calls["sparse_conv"]
               if a[6] == (3, 3, 3) and a[7] == (1, 1, 1) and a[3].shape[2] == 16)
    entries += k1_case(f"train conv1(subm {fwd[0].shape[1]}->16)", fwd)
    df = next(a for a, kw in calls["sparse_conv_df"]
              if kw.get("transpose") and a[6] == (3, 3, 3) and a[7] == (2, 2, 2)
              and a[3].shape[2] == 16)
    entries += k1_case("conv2 df (transpose query, 32->16)", df, df=True, transpose=True)
    df = next(a for a, kw in calls["sparse_conv_df"]
              if not kw.get("transpose") and a[3].shape[1:] == (128, 256))
    entries += k1_case("down_combine_0 df (subm, 128->256)", df, df=True)
    assert len(calls["sparse_pool"]) == 1, len(calls["sparse_pool"])
    entries.append(k2_case(calls["sparse_pool"][0][0], "train"))
    entries.append(k4_case(calls["trilinear_pool"][0][0], "train"))
    calls_k4 = calls["trilinear_pool"][0][0]
    del calls, picks, df, fwd

    params = {n: p.detach().clone() for n, p in net.named_parameters()}
    stats = {n: b.clone() for n, b in net.named_buffers() if n.endswith("running_var")}
    reset_launches()
    metrics = trainer.train_step(net, opt, batch, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"train-step launches: {json.dumps(launches)}")
    assert launches.pop("sparse_sum_pool") == 0 and all(n > 0 for n in launches.values()), launches
    for e in entries:
        e["launches"] = launches[e["name"].split(":")[0]]
    vals = {k: float(v) for k, v in metrics.items()}
    log("train-step metrics: " + json.dumps({k: round(v, 6) for k, v in vals.items()}))
    assert all(math.isfinite(v) for v in vals.values()), vals
    for part in ("occ", "det"):
        assert vals[f"grad_norm_{part}"] > 0, part
    still = [n for n, p in net.named_parameters() if torch.equal(p, params[n])]
    bn_moved = sum(not torch.equal(b, stats[n]) for n, b in net.named_buffers()
                   if n in stats)
    log(f"parameters moved: {len(params) - len(still)} of {len(params)} (unmoved, zero "
        f"gradient and no weight decay: {still}); BN running variances moved: "
        f"{bn_moved} of {len(stats)}")
    assert len(still) < 0.1 * len(params) and bn_moved > 0.9 * len(stats), (still, bn_moved)
    del params, stats

    # K4's backward: plain PyTorch (the 8-corner index_add_) on the step's inputs
    vol, zyx, roi_b, valid = calls_k4
    g = torch.randn(zyx.shape[0], zyx.shape[1], vol.shape[-1], device=vol.device)
    bwd_ms = cuda_ms(lambda: cuda_interp.trilinear_pool_volume_grad(
        g, tuple(vol.shape), zyx, roi_b, valid), reps=5)
    log(f"K4 backward (plain index_add_, volume {tuple(vol.shape)} R={zyx.shape[0]} "
        f"S={zyx.shape[1]}): ms={bwd_ms:.4f}")
    del calls_k4, g

    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        m = trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(round(float(m["loss"]), 5))
    log(f"train step ms, full flagship (B=2, train caps, 10 steps on one batch): median "
        f"{statistics.median(times):.2f} all {[round(v, 2) for v in times]}")
    log(f"train max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"train loss per step: {losses}")
    assert all(math.isfinite(v) for v in losses), losses
    net.stage_ms = {}
    trainer.train_step(net, opt, batch, gen)
    log("train stage ms (synchronised, forward only): "
        + json.dumps({k: round(v, 3) for k, v in net.stage_ms.items()}))
    net.stage_ms = None
    profile_step(lambda: trainer.train_step(net, opt, batch, gen), STAGES, "train step")
    return entries


def variant_train_phase():
    """The `fix` occ-code variant of the flagship in `net.train()` at B=2
    with the train caps: one counted step in which K1 forward and df, K3,
    K2 sum (3 levels) and K4 must launch, and the attention blocks and
    conv1_combine (which read the occ code) get a non-zero gradient; then
    3 timed steps."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    net, opt, batch = train_setup(config.flagship_occ_variant("fix"), 16384, 10, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_launches()
    metrics = trainer.train_step(net, opt, batch, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"occ variant 'fix' train-step launches: {json.dumps(launches)}")
    assert launches["sparse_sum_pool"] == 3 and launches["sparse_pool"] == 0, launches
    assert all(launches[k] > 0 for k in ("sparse_conv", "sparse_conv_df", "sparse_conv_dw",
                                         "trilinear_pool")), launches
    vals = {k: float(v) for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in vals.values()), vals
    params = dict(net.named_parameters())
    grads = {k: float(params[f"det_modules.backbone_3d.{k}"].grad.abs().max())
             for k in ("att_conv1.0.0.weight", "att_conv2.0.0.weight",
                       "conv1_combine.0.0.weight")}
    log(f"occ variant 'fix' train step: loss {vals['loss']:.5f}; largest gradient "
        f"{json.dumps(grads)}")
    assert all(g > 0 and math.isfinite(g) for g in grads.values()), grads
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"train step ms, flagship occ variant 'fix' (B=2, train caps, 3 steps after the counted "
        f"one): median {statistics.median(times):.2f} all {[round(v, 2) for v in times]}")


def micro_train_config():
    """The micro config (`datasets.mini_config`: the flagship's topology on
    a 6.4 m scene, 8 channels) with the flagship's optimizers."""
    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import mini_config

    flag = config.flagship()
    cfg = config.EasyDict({"DATA_CONFIG": mini_config.micro_data_cfg(with_occ=True),
                           "MODEL": mini_config.micro_model_cfg(with_occ=True),
                           "OPTIMIZATION": flag.OPTIMIZATION,
                           "OCC_OPTIMIZATION": flag.OCC_OPTIMIZATION})
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    return cfg


def small_train_check():
    """One train step of the micro config in float32 on the card (kernels)
    and on the CPU (plain versions) from the same weights and batch, with
    the same roi and dropout draws. The CPU's PassOccVox outputs (occ
    points and the merged det table, no gradient under PASS_GRAD False)
    are replaced by the card's, so both det paths see the same occ points
    in the same order (see `small_input_check`). At larger sizes the
    gradients are too ill-conditioned for this tolerance: on the 16 m
    config a 1e-6 relative change of the weights moves some of them by
    6 % of their tensor's max (ReLU and active-site boundaries)."""
    import torch

    from btcdet_tpu_torch.models.occ import occ_subnet
    from btcdet_tpu_torch.models.roi_heads import conv_head, roi_head_utils
    from btcdet_tpu_torch.train import trainer

    cfg = micro_train_config()
    pass_keys = ("occ_points", "occ_points_mask", "det_voxel_features", "det_occ_code",
                 "det_voxel_coords", "det_voxel_num_points")
    orig = (roi_head_utils.draw_roi_sampling_uniforms, conv_head.draw_dropout_keep,
            occ_subnet.OccSubnet._pass_occ_vox)
    res, card_occ = {}, {}
    try:
        for run, dev in (("card", "cuda"), ("cpu", "cpu")):
            with f32_everywhere():
                net, opt, batch = train_setup(cfg, 2048, 4, 3, device=dev)
            draw_gen = torch.Generator().manual_seed(11)
            roi_head_utils.draw_roi_sampling_uniforms = (
                lambda generator, B, N, R, g=draw_gen: orig[0](g, B, N, R))
            conv_head.draw_dropout_keep = (
                lambda generator, shape, keep, g=draw_gen: orig[1](g, shape, keep))

            def pass_occ_vox(self, batch, out, *a, run=run):
                orig[2](self, batch, out, *a)
                if run == "card":
                    card_occ.update({k: out[k].cpu() for k in pass_keys})
                else:
                    res["occ_points_cpu"] = (out["occ_points"], out["occ_points_mask"])
                    out.update(card_occ)
            occ_subnet.OccSubnet._pass_occ_vox = pass_occ_vox
            with f32_everywhere():
                m = trainer.train_step(net, opt, batch,
                                       torch.Generator(device=dev).manual_seed(0))
            res[run] = ({k: float(v) for k, v in m.items()},
                        {n: p.grad.detach().cpu() for n, p in net.named_parameters()
                         if p.grad is not None})
            del net, opt, batch
    finally:
        (roi_head_utils.draw_roi_sampling_uniforms, conv_head.draw_dropout_keep,
         occ_subnet.OccSubnet._pass_occ_vox) = orig
    (gm, gg), (cm, cg) = res["card"], res["cpu"]
    cpu_pts, cpu_mask = res["occ_points_cpu"]
    worst_pts = same_point_sets(card_occ["occ_points"], card_occ["occ_points_mask"], cpu_pts,
                                cpu_mask, 1e-3)
    worst_loss = {}
    for k, v in cm.items():
        worst_loss[k] = abs(gm[k] - v)
        assert abs(gm[k] - v) <= 1e-3 * max(1.0, abs(v)), (k, gm[k], v)
    assert set(gg) == set(cg), set(gg) ^ set(cg)
    rel = {n: float((gg[n] - g).abs().max()) / max(float(g.abs().max()), 1e-12)
           for n, g in cg.items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:8]
    log("micro train-step check, largest gradient differences (relative to the tensor's "
        "max): " + json.dumps({n: f"{v:.3e}" for n, v in worst}))
    worst_grad = worst[0][1]
    assert worst_grad <= 1e-3, worst
    n_occ = [int(v) for v in card_occ["occ_points_mask"].sum(1)]
    log(f"micro train-step check (cuda f32 vs cpu f32, same weights, batch and draws; occ "
        f"points per frame {n_occ}, as sets to {worst_pts:.2e}): loss terms "
        + json.dumps({k: round(v, 6) for k, v in cm.items()})
        + f"; largest loss-term difference {max(worst_loss.values()):.3e}; largest gradient "
        f"difference relative to its tensor's max {worst_grad:.3e} over {len(cg)} tensors")


def forward_post(net, batch, cfg):
    """One eval forward + post-processing, ended by a synchronisation."""
    import torch

    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    post_processing(net(batch), cfg.MODEL.POST_PROCESSING, 1)
    torch.cuda.synchronize()


def timed_median(step, runs: int = 5, warmup: int = 2):
    import torch

    for _ in range(warmup):
        step()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import btcdet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the btcdet_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2
    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing
    from btcdet_tpu_torch.ops import kernel_build

    # 1. the card
    t_start = time.perf_counter()
    card = gpu_name_and_power_limit()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. kernels
    t0 = time.perf_counter()
    kernel_build.build(["sparse_nbr", "sparse_conv", "sparse_conv_dw", "sparse_pool",
                        "trilinear_pool"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, text in kernel_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "bytes smem" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # 3. full flagship model, synthetic weights by name, capture run
    cfg = config.flagship()
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"])
    net.load_state_dict(weights.synth_state_dict(net))
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                 seed=0, mode="test")
    captured = capture_kernel_inputs(lambda: net(batch))
    calls = {k: [a for a, _ in v] for k, v in captured.items()}
    convs = calls["sparse_conv"]
    log("capture: " + ", ".join(f"{len(calls[k])} {k} calls" for k in EVAL_KERNELS)
        + " per forward")
    # one map per distinct (input key table, output sites, geometry)
    pairings = {(a[1].data_ptr(), a[2].data_ptr(), a[6], a[7], a[8]) for a in convs}
    log(f"neighbour maps: {len(calls['neighbor_map'])} built for {len(convs)} convs, "
        f"{len(pairings)} distinct (input table, sites, geometry)")
    assert len(calls["neighbor_map"]) == len(pairings) == EVAL_MAPS, (
        len(calls["neighbor_map"]), len(pairings))

    # 4. kernel phase. Captured args: features, keys, out_coords, weights,
    # in_shape, batch, kernel, stride, padding; picked by kernel / stride /
    # Cout, first in call order
    def pick(kernel, stride, cout):
        return next(a for a in convs
                    if a[6] == kernel and a[7] == stride and a[3].shape[2] == cout)

    c1 = pick((3, 3, 3), (1, 1, 1), 16)
    c2c = pick((3, 3, 3), (1, 1, 1), 32)
    picks = {
        f"conv1(subm {c1[0].shape[1]}->16)": c1,
        "conv2(3^3 s2 16->32)": pick((3, 3, 3), (2, 2, 2), 32),
        f"conv2_combine_0(subm {c2c[0].shape[1]}->32)": c2c,
        "conv_out(3x1x1 s2 64->128)": pick((3, 1, 1), (2, 1, 1), 128),
        "down_combine_0(subm 256->128)": pick((3, 3, 3), (1, 1, 1), 128),
    }
    kernels = [e for name, args in picks.items() for e in k1_case(name, args)]
    k1_eval_table(captured["sparse_conv"], captured["neighbor_map"])
    assert len(calls["sparse_pool"]) == 1, len(calls["sparse_pool"])
    kernels.append(k2_case(calls["sparse_pool"][0]))
    kernels.append(k4_case(calls["trilinear_pool"][0]))
    del calls, captured, convs, picks

    # 5. main path: the full flagship forward + post-processing
    seen = {}
    hook = net.det_modules.backbone_3d.register_forward_pre_hook(
        lambda mod, args: seen.update(st=args[0]))
    reset_launches()
    out = net(batch)
    post = post_processing(out, cfg.MODEL.POST_PROCESSING, 1)
    torch.cuda.synchronize()
    launches = read_launches()
    hook.remove()
    log(f"main-path launches: {json.dumps(launches)}")
    assert all(launches[k] > 0 for k in EVAL_KERNELS) and launches["sparse_sum_pool"] == 0, launches
    assert launches["neighbor_map"] == EVAL_MAPS, launches
    for e in kernels:
        e["launches"] = launches[e["name"].split(":")[0]]
    B = batch["points"].shape[0]
    n_det = check_eval_outputs(net, batch, out, post)
    n_occ = [int(v) for v in out["occ_points_mask"].sum(dim=1)]
    st_c = seen["st"].coords
    merged = [int((st_c[:, 0] == b).sum()) for b in range(B)]
    det_rows = [int((batch["det_voxel_coords"][:, 0] == b).sum()) for b in range(B)]
    log(f"occ points per frame: {n_occ}; det voxels per frame: {det_rows}; merged det voxels "
        f"per frame: {merged} (new occ rows {[m - d for m, d in zip(merged, det_rows)]})")
    assert min(n_occ) > 0 and all(m > d for m, d in zip(merged, det_rows)), (n_occ, merged)
    log(f"nnz per level: {json.dumps(out['nnz'])}")
    log(f"rois per frame: {[int(v) for v in out['roi_valid'].sum(dim=1)]}; "
        f"detections per frame: {n_det}")
    for b in range(B):
        keep = post["pred_valid"][b]
        for box, sc in list(zip(post["pred_boxes"][b][keep], post["pred_scores"][b][keep]))[:3]:
            log(f"  frame {b}: score {float(sc):.3f} box {[round(float(v), 2) for v in box]}")

    med, times = timed_median(lambda: forward_post(net, batch, cfg))
    log(f"forward+post ms, full flagship (B=2, 5 runs after 2 warm-ups): median {med:.2f} "
        f"all {[round(t, 2) for t in times]}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    stage_profile(net, batch, cfg.MODEL.POST_PROCESSING)
    occ_determinism(net, batch, cfg.MODEL.POST_PROCESSING)
    proposal_nms_check(net, batch)
    del net, batch, out, post, seen

    # 5b. second path: the det-only flagship
    dcfg = config.flagship_det_only()
    dnet = build_network(dcfg.MODEL, dcfg.DATA_CONFIG, ["Car"])
    dnet.load_state_dict(weights.synth_state_dict(dnet))
    dbatch = make_synthetic_batch(dcfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                  seed=0, mode="test")
    reset_launches()
    dout = dnet(dbatch)
    post_processing(dout, dcfg.MODEL.POST_PROCESSING, 1)
    torch.cuda.synchronize()
    dl = read_launches(EVAL_KERNELS)
    log(f"det-only path launches: {json.dumps(dl)}")
    assert (dl["neighbor_map"] > 0 and dl["sparse_conv"] > 0 and dl["trilinear_pool"] > 0
            and dl["sparse_pool"] == 0), dl
    med, times = timed_median(lambda: forward_post(dnet, dbatch, dcfg))
    log(f"forward+post ms, det-only flagship (B=2, 5 runs after 2 warm-ups): median {med:.2f} "
        f"all {[round(t, 2) for t in times]}; nnz {json.dumps(dout['nnz'])}")
    del dnet, dbatch, dout

    # 5c. third path: the det backbone's occ-code variants
    kernels += occ_variant_paths()

    # 6. small-input checks
    small_input_check(small_config(full=True), "full config", spread=True)
    small_input_check(small_config(full=False), "det-only config")
    for down in ("fix", "avgpool"):
        small_input_check(micro_variant_config(down), f"micro config, occ variant {down!r}")
    backbone_module_check()

    # 7. train phase
    kernels += train_phase()
    small_train_check()
    variant_train_phase()

    # 8. results
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
