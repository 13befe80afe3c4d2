#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`btcdet_tpu_torch`): the full
flagship BtcNet eval forward (occupancy subnet included) on one CUDA
card, and its det-only variant as a second path.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `btcdet_tpu_torch/csrc` (one nvcc per
     source, started together) and print the build seconds;
  3. capture: one forward of the full flagship model at B=2 records the
     inputs its kernels see (these launches are not counted);
  4. kernel phase: each kernel against its plain PyTorch version on the
     captured inputs (K1 / K4 in bf16 to 1e-2 of the plain output's max,
     K2 max bit for bit), with kernel / plain / library times and the
     card's bound;
  5. main path: launch counts reset, the full forward + post-processing
     run once and every kernel (K1, K2, K4) must have launched; occ points
     and merged det voxels per frame, nnz per level, detections, median
     forward ms over 5 runs after 2 warm-ups, peak memory, ms per stage,
     and one profiled step (device idle share, top kernels); then the
     det-only flagship as the second path: counts reset, one run, its
     launches, and its median;
  6. small-input checks: small full and det-only configs in float32 on
     the card against the plain path on the CPU, same weights and batch
     (full config: the occ subnets compared, then the det paths on the
     card's occ outputs);
  7. a JSON line of per-kernel numbers, then the contract line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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


def kernel_modules():
    """{kernel wrapper name: the ops module holding it and its launch count}."""
    from btcdet_tpu_torch.ops import cuda_conv, cuda_interp, cuda_pool

    return {"sparse_conv": cuda_conv, "sparse_pool": cuda_pool, "trilinear_pool": cuda_interp}


def reset_launches():
    for mod in kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


def capture_kernel_inputs(net, batch):
    """Run one forward with recording wrappers around the kernel entry
    points; returns the recorded calls of each, in order."""
    mods = kernel_modules()
    calls = {name: [] for name in mods}
    orig = {name: getattr(mod, name) for name, mod in mods.items()}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append(args)
            return orig[name](*args, **kw)
        return rec

    for name, mod in mods.items():
        setattr(mod, name, recorder(name))
    try:
        net(batch)
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])
    return calls


def k1_case(name, args):
    """Compare / time K1 on one captured call."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    feats, keys, coords, w, shape, bsz, ksize, stride, pad = args[:9]
    feats, w = feats.to(torch.bfloat16), w.to(torch.bfloat16)
    cargs = (feats, keys, coords, w, shape, bsz, ksize, stride, pad)
    out = cuda_conv.sparse_conv(*cargs)
    ref = cuda_conv.sparse_conv_plain(*cargs)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= TOL * max(scale, 1e-6), f"K1 {name}: max err {err} vs plain max {scale}"
    # bound: what this run's data needs. Features of the input rows some
    # tap matched, the live (non-padding) keys the search runs over, the
    # weights of taps that matched anything; out_coords and the output at
    # capacity, since the kernel reads and writes every row of them.
    idx, found = cuda_conv.conv_rulebook(keys, coords, shape, ksize, stride, pad)
    matches = int(found.sum())
    rows_read = int(idx[found].unique().numel())
    live_keys = int((keys != cuda_conv.INT32_MAX).sum())
    taps_used = int(found.any(dim=1).sum())
    N, cin = feats.shape
    M = coords.shape[0]
    K, _, cout = w.shape
    nbytes = (rows_read * cin * 2 + live_keys * 4 + M * 16 + taps_used * cin * cout * 2
              + M * cout * 4)
    flops = 2.0 * cin * cout * matches
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS)
    ms = cuda_ms(lambda: cuda_conv.sparse_conv(*cargs), reps=20)
    plain_ms = cuda_ms(lambda: cuda_conv.sparse_conv_plain(*cargs), reps=5, warmup=1)
    log(f"K1 {name}: N={N} M={M} Cin={cin} Cout={cout} kernel={ksize} stride={stride} "
        f"matches={matches} rows_read={rows_read} live_keys={live_keys} taps_used={taps_used} "
        f"bytes={nbytes} flops={flops:.0f} max_abs_err={err:.3e} (plain max {scale:.3e}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_s * 1e3:.4f}")
    return {"name": f"sparse_conv:{name}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_conv.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:511", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_TENSOR_FLOPS
            else "operations", "library_ms": None}


def k2_case(args):
    """Compare (bit for bit) / time K2 max on the captured occ-code pool."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv, cuda_pool

    feats, keys, coords, shape, bsz, ksize, stride, pad = args
    out = cuda_pool.sparse_pool(*args)
    ref = cuda_pool.sparse_pool_plain(feats, keys, coords, shape, ksize, stride, pad)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), "K2: kernel and plain version differ"
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
    ms = cuda_ms(lambda: cuda_pool.sparse_pool(*args), reps=20)
    plain_ms = cuda_ms(lambda: cuda_pool.sparse_pool_plain(feats, keys, coords, shape, ksize,
                                                           stride, pad), reps=5, warmup=1)
    log(f"K2 sparse_pool (max): N={N} M={M} C={C} kernel={ksize} stride={stride} "
        f"matches={matches} rows_read={rows_read} live_keys={live_keys} "
        f"rows_with_a_match={int(found.any(0).sum())} bytes={nbytes} max_abs_err={err} "
        f"(bitwise equal) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_s * 1e3:.4f}")
    return {"name": "sparse_pool", "route": "cuda",
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


def k4_case(args):
    """Compare / time K4 on the captured ConvHead call; grid_sample as the
    library yardstick."""
    import torch
    import torch.nn.functional as F

    from btcdet_tpu_torch.ops import cuda_interp

    vol, zyx, roi_b, valid = args
    vol = vol.to(torch.bfloat16)
    out = cuda_interp.trilinear_pool(vol, zyx, roi_b, valid)
    ref = cuda_interp.trilinear_pool_plain(vol, zyx, roi_b, valid)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= TOL * max(scale, 1e-6), f"K4: max err {err} vs plain max {scale}"
    B, D, H, W, C = vol.shape
    R, S, _ = zyx.shape
    n_valid = int(valid.sum())
    # bound: the volume cells this run's samples touch, every point, flag
    # and roi index (the kernel reads them all), and the whole output
    n_cells, n_reads = k4_reads(vol, zyx, roi_b, valid)
    nbytes = (n_cells * C * vol.element_size() + R * S * 12 + R * S + R * 4
              + R * S * C * 4)
    flops = 2.0 * C * n_reads
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    ms = cuda_ms(lambda: cuda_interp.trilinear_pool(vol, zyx, roi_b, valid), reps=20)
    plain_ms = cuda_ms(lambda: cuda_interp.trilinear_pool_plain(vol, zyx, roi_b, valid),
                       reps=5, warmup=1)
    # library yardstick: 5-D grid_sample (zeros padding, align_corners) on the
    # same volume; rois are batch-ordered, N per frame
    lib_ms, lib_err = None, None
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
        lib_err = float((got - out)[valid].abs().max())
        lib_ms = cuda_ms(lib, reps=20)
    log(f"K4 trilinear_pool: volume={tuple(vol.shape)} R={R} S={S} valid={n_valid} "
        f"cells_read={n_cells} corner_reads={n_reads} bytes={nbytes} flops={flops:.0f} "
        f"max_abs_err={err:.3e} (plain max {scale:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"grid_sample_ms={lib_ms} (max diff to kernel {lib_err}) bound_ms={bound_s * 1e3:.4f}")
    return {"name": "trilinear_pool", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/trilinear_pool.cu",
            "replaces": "btcdet_tpu/ops/pallas_interp.py:150", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations", "library_ms": lib_ms}


def stage_profile(net, batch, post_cfg):
    """Where the time goes in one forward + post-processing: wall ms per
    stage (each between two device synchronisations), then one step under
    torch.profiler for the device's idle share and its top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing

    times = {}
    net.stage_ms = times
    try:
        post_processing(net(batch), post_cfg, 1, stage_ms=times)
    finally:
        net.stage_ms = None
    log("stage ms (synchronised): " + json.dumps({s: round(times[s], 3) for s in STAGES
                                                  if s in times}))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        post_processing(net(batch), post_cfg, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in STAGES:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(t for _, t in kernels.values())
    log(f"profiled step: wall {wall:.2f} ms (profiler on), kernel time {busy:.2f} ms, "
        f"device idle share {1 - busy / wall:.3f}")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"  {t:9.3f} ms  x{n:<5d} {name[:100]}")


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


def small_input_check(full: bool):
    """f32 on the card (kernels) against f32 on the CPU (plain versions).

    Full config: the occ subnets of the two devices are compared first
    (probabilities, occ point sets, merged det voxel sets); the CPU's det
    path then reads the card's occ outputs, so the downstream comparison
    sees the same occ points in the same order. The order of probabilities
    that tie to within f32 rounding differs between the devices (and
    between card runs), and it decides the ball query's first picks."""
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network

    cfg = small_config(full)
    old = os.environ.get("BTCDET_F32")
    os.environ["BTCDET_F32"] = "1"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
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
            if full and dev == "cuda":
                # the card's run-to-run spread of the occ probabilities, with
                # cuDNN free to pick any algorithm and with deterministic ones
                spread, det0 = {}, torch.backends.cudnn.deterministic
                for det in (False, True):
                    torch.backends.cudnn.deterministic = det
                    p = [net.occ_modules(batch)["probs"] for _ in range(3)]
                    spread[f"cudnn.deterministic={det}"] = max(
                        float((q - p[0]).abs().max()) for q in p)
                torch.backends.cudnn.deterministic = det0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if old is None:
            del os.environ["BTCDET_F32"]
        else:
            os.environ["BTCDET_F32"] = old
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
    log(f"small-input check, {'full' if full else 'det-only'} config{extra} (cuda f32 vs cpu "
        "f32, rtol=atol=1e-3): max abs diff " + json.dumps(worst))
    if full:
        log("card run-to-run spread of the occ probabilities over 3 runs: " + json.dumps(spread))


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
    card = gpu_name_and_power_limit()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. kernels
    t0 = time.perf_counter()
    kernel_build.build(["sparse_conv", "sparse_pool", "trilinear_pool"])
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
    calls = capture_kernel_inputs(net, batch)
    convs = calls["sparse_conv"]
    log("capture: " + ", ".join(f"{len(v)} {k} calls" for k, v in calls.items())
        + " per forward")

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
    kernels = [k1_case(name, args) for name, args in picks.items()]
    assert len(calls["sparse_pool"]) == 1, len(calls["sparse_pool"])
    kernels.append(k2_case(calls["sparse_pool"][0]))
    kernels.append(k4_case(calls["trilinear_pool"][0]))
    del calls, convs, picks

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
    assert all(n > 0 for n in launches.values()), launches
    for e in kernels:
        e["launches"] = launches[e["name"].split(":")[0]]
    B = batch["points"].shape[0]
    n_occ = [int(v) for v in out["occ_points_mask"].sum(dim=1)]
    st_c = seen["st"].coords
    merged = [int((st_c[:, 0] == b).sum()) for b in range(B)]
    det_rows = [int((batch["det_voxel_coords"][:, 0] == b).sum()) for b in range(B)]
    log(f"occ points per frame: {n_occ}; det voxels per frame: {det_rows}; merged det voxels "
        f"per frame: {merged} (new occ rows {[m - d for m, d in zip(merged, det_rows)]})")
    assert min(n_occ) > 0 and all(m > d for m, d in zip(merged, det_rows)), (n_occ, merged)
    log(f"nnz per level: {json.dumps(out['nnz'])}")
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
    n_det = [int(v) for v in post["pred_valid"].sum(dim=1)]
    log(f"rois per frame: {[int(v) for v in out['roi_valid'].sum(dim=1)]}; "
        f"detections per frame: {n_det}")
    for b in range(B):
        keep = post["pred_valid"][b]
        for box, sc in list(zip(post["pred_boxes"][b][keep], post["pred_scores"][b][keep]))[:3]:
            log(f"  frame {b}: score {float(sc):.3f} box {[round(float(v), 2) for v in box]}")

    def step(n=net, bt=batch, c=cfg):
        o = n(bt)
        post_processing(o, c.MODEL.POST_PROCESSING, 1)
        torch.cuda.synchronize()

    med, times = timed_median(step)
    log(f"forward+post ms, full flagship (B=2, 5 runs after 2 warm-ups): median {med:.2f} "
        f"all {[round(t, 2) for t in times]}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    stage_profile(net, batch, cfg.MODEL.POST_PROCESSING)
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
    dl = read_launches()
    log(f"det-only path launches: {json.dumps(dl)}")
    assert dl["sparse_conv"] > 0 and dl["trilinear_pool"] > 0 and dl["sparse_pool"] == 0, dl
    med, times = timed_median(lambda: step(dnet, dbatch, dcfg))
    log(f"forward+post ms, det-only flagship (B=2, 5 runs after 2 warm-ups): median {med:.2f} "
        f"all {[round(t, 2) for t in times]}; nnz {json.dumps(dout['nnz'])}")
    del dnet, dbatch, dout

    # 6. small-input checks
    small_input_check(full=True)
    small_input_check(full=False)

    # 7. results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
