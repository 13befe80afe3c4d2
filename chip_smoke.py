#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`btcdet_tpu_torch`): `bench.py`'s main
path as shipped (the flagship yaml untouched, its approximate ball query, at
bench.py's batch of 8) as the first path, then the full
flagship BtcNet eval forward (occupancy subnet included) on one CUDA
card, its det-only variant as a second path, the det backbone's four
occ-code variants (`config.flagship_occ_variant`) as a third, the
evaluation entry point `tools/test_torch.py` on a synthetic KITTI tree as
a fourth, the flagship training step (and the `fix` variant's) as a
fifth, the training entry point `tools/train_torch.py` on a synthetic
KITTI tree as a sixth, data parallelism (`btcdet_tpu_torch.parallel`:
2 ranks sharing the card over gloo, one rank over NCCL) as a seventh, and
the occupancy subnet's options (OccTargetsPillar + OccHead2D, the residual
and inverse occ backbones, REVERSE_VIS, USE_ABSXYZ, DB_PROJ; PASS_GRAD with
K2's backward, the occ voxel dropout, REMAIN_PERCENTAGE, the sigmoid occ
loss) as an eighth, and the det-side options (OUT_FEAT_TYPE, CLAMP, the
unfused merge, MeanVFE with the occ subnet, a fractional upsample stride,
MATCH_HEIGHT without the corner loss, the adam / adam_cosine / sgd
optimizers) with the 3-class config (`btcdet_kitti_3classes.yaml`) as a
ninth, and the side modules that no config names (VoxelResBackBone8x, the
inverse and transpose sparse convs, VoxelSetAbstraction, ATSS, the roi
pools, chamfer, PointPillarScatter, the NMS functions) as a tenth, and
BEV row sharding (`build_network(..., bev_sharding=True)` under
`parallel.init_dist(..., sp=)`: the BEV pyramid split by rows over the
ranks of a spatial group) as an eleventh, and the flagship yaml as shipped
(`config.flagship_shipped()`: ConvHead's roi-grouped approximate ball
query, the JAX package's default) as a twelfth, and the overfit proof
(`tools/overfit_proof_torch.py`: the training CLI on a memorisable 25-frame
synthetic tree, then both evaluations) as a thirteenth: a short gate in the
default run, the whole proof on request.

    python3 chip_smoke.py
    python3 chip_smoke.py --b8        # only the first path (bench.py's main path, B=8)
    python3 chip_smoke.py --syncs     # only the sync-debug check (2c)
    python3 chip_smoke.py --dp [seed ...]   # only the seventh path's data-parallel steps,
                                      # with more draws of the output projections
    python3 chip_smoke.py --kernels   # only the backward kernels' cases (K4, K2 max),
                                      # the rotated NMS at the eval shapes and FPS
    python3 chip_smoke.py --side      # only the tenth path (side modules)
    python3 chip_smoke.py --sp        # only the eleventh path (BEV row sharding)
    python3 chip_smoke.py --approx    # only the twelfth path (the approximate query)
    python3 chip_smoke.py --gate      # only the thirteenth path's short gate
    python3 chip_smoke.py --overfit [--three_classes]   # the whole proof

Phases (any failure raises and exits non-zero, printing no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `btcdet_tpu_torch/csrc` (one nvcc per
     source, started together) and print the build seconds;
  2b. the first path, `bench.py`'s main path as shipped: the flagship yaml
     untouched (`config.flagship_shipped()`, ConvHead's roi-grouped
     approximate query) with the main path's synthetic weights on
     `make_synthetic_batch` at B=8 (16 384 points, 10 gt, the yaml's test
     caps), eval forward + post-processing. One captured forward gives the
     kernels' B=8 inputs: K1's five picked convs, all 18 K1 launches and the
     maps, K2 max and K4 at 800 rois held against their plain versions as in
     step 4 (entries named `@B8`); then counts reset, one run whose launches
     must equal EVAL_LAUNCHES (nothing runs per frame), its outputs checked
     (`check_eval_outputs`), occ points and new merged det rows in every
     frame; the active sites each level capacity cut a frame and the merged
     table's drops a frame logged (bench.py's frames overflow the yaml's
     level-1 and level-2 capacities at any batch); frames 0-1 against the
     same model on the B=2 batch of the same seed (inputs asserted equal),
     stage by stage (`batch_independence`): a B=8 batch of frames 0-1
     repeated gives them the B=8 run's bits at every stage, and the level
     capacities cut frames 0-1 the same sites at B=8 and at B=2; the first
     stage where a bit differs from the B=2 run is logged with the
     detections that moved, and must be one of DENSE_STAGES (the BEV
     pyramid, the RPN, ConvHead: their cuDNN / cuBLAS calls see the whole
     batch); the B=2 run is then traced with those stages' B=8 outputs
     replaced in, their own held within DENSE_ROUNDING of their max, and
     every other output of every stage must equal the B=8 run's bit for
     bit (the roi-grouped queries that differ proven valid); the bound's
     readings against two planted faults are logged (frames swapped must
     exceed it); the forward + post median and spread, frames/s, peak
     memory, stage ms and the device idle share, stage ms a frame against
     B=2, the roi-grouped query alone (ms and peak a stage); then
     `config.fast20k()` at B=8 (launches, outputs, the sites cut a level,
     its median beside the shipped caps');
  2c. the sync-debug check (`sync_path`): the car and 3-class yamls as
     shipped at B=8, one eval forward + post-processing each under
     `torch.cuda.set_sync_debug_mode`, with the recorder on: in "warn" mode
     no synchronising call may come from outside the named read-backs
     (`utils.trace.readback`; each found site is logged by file and line),
     and in "error" mode the pass must run through, launching the
     rotated-NMS kernel twice; the read-backs a batch are logged by site;
  3. capture: one forward of the full flagship model at B=2 records the
     inputs its kernels see (these launches are not counted);
  4. kernel phase: each kernel against its plain PyTorch version on the
     captured inputs (K1's neighbour map bit for bit, its bf16 gather-GEMM
     to 1e-2 of the plain output's max and bit for bit on a repeat, K4 in
     bf16 within one bf16 ulp, K2 max over the forward's map bit for bit),
     with kernel (event and
     profiler kernel-alone; CUDA events where every profiler session
     missed the kernel, logged) / plain / library times and the card's
     bound;
     a table of all 18 K1 launches of the eval forward over the maps it
     built (shape, matches, kernel-alone ms, bound) and their sum; the
     maps built per forward asserted equal to the distinct (input table,
     sites, geometry) pairs;
  5. main path: launch counts reset, the full forward + post-processing
     run once and every kernel (K1 map and GEMM, K2, K4) must have
     launched as often as EVAL_LAUNCHES says; occ points
     and merged det voxels per frame, nnz per level, detections, median
     forward ms over 5 runs after 2 warm-ups, peak memory, ms per stage,
     and one profiled step (device idle share, top kernels), the occ
     subnet identical from run to run and its stage ms with the occ
     backbone's scoped deterministic cuDNN and without it, the fused
     merge's det voxel features identical over 5 runs, the proposal
     NMS's kernel against the full-matrix greedy and its plain version
     (same kept boxes, the three timed); then the det-only flagship as the second path: counts
     reset, one run, its launches (K1 map and GEMM and K4), and its
     median; then the occ-code
     variants (`fix`, `avgpool`, `weight`, `maxpool`) as the third: the
     `fix` and `avgpool` forwards captured and K2 sum held bit for bit
     against its plain version on their calls (the three levels of `fix`,
     the k=2 call of `avgpool`), then for each variant counts reset, one
     run with its launches asserted (the maps too: 9, 12 in `avgpool`),
     its outputs checked and nnz per
     level, and for `fix` its median and ms per stage; then the
     evaluation entry point as the fourth: a synthetic KITTI tree (16
     frames, 8 in val, about 20 000 background points a frame), infos by
     the port, synthetic weights as a reference-format `.pth`, and
     `tools/test_torch.py` in process on the flagship yaml (B=2, 2 loader
     workers): counts reset, every val frame evaluated with finite AP
     keys, the launches per forward equal to EVAL_LAUNCHES, the first
     batch's detections equal to a forward + post-processing of the same
     batch bit for bit; the host pipeline's ms a frame, the loop's frames
     per second and, over a profiled second run, the device's idle share;
  6. small-input checks: small full and det-only configs in float32 on
     the card against the plain path on the CPU, same weights and batch
     (full config: the occ subnets compared, run to run on the card as
     well, then the det paths on the card's occ outputs); the micro
     config's `fix` and `avgpool` variants the same way; the det backbone
     module alone at the flagship's widths for OUT_FEAT_TYPE `combine` and
     `big_combine`;
  7. train phase: the full flagship in `net.train()` at B=2 with the
     train caps. One captured step records its kernel calls; K3 (the
     weight gradient, over the forward's map) is held against its plain
     version on five of them (bf16, rtol 1e-3 / atol 1e-4 of the plain
     output's max, and bit for bit on a repeat) with its per-tap
     compaction bit for bit against its plain version, all 18 K3 launches
     of the step are timed, and at the step's own inputs K1's forward
     (conv1), its transpose-query df (a strided conv) and subm df, K2, K4
     and K4's volume gradient (against its plain `index_add_` version: f32
     within 1e-5 of the plain output's max and no further from a float64
     sum, bf16 one rounding of the f32 sum, bit for bit with the ordered
     plain version and on a repeat; timed by sub-kernel with its segment
     lengths, on the step's call and on the `hot` layout); then
     counts reset, one step whose launches of every kernel (K1 map, forward
     and df, K3 and its compaction, K2, K4 and its gradient) must equal
     TRAIN_LAUNCHES, with its loss terms, per-partition gradient norms and
     moved parameters and BN statistics; one forward + backward twice from
     the same state, batch and generator, every gradient equal bit for bit
     (counted per tensor group); 10 steps timed; and one step
     in float32 on the card against the CPU (loss terms
     to 1e-3, gradients to 1e-3 of each tensor's max) on the micro config;
     then the `fix` variant's train step: one counted step in which K1
     forward and df, K3, K2 sum and K4 launch and the attention blocks and
     conv1_combine get gradients, then 3 timed steps;
  8. the training entry point: a synthetic KITTI tree (12 frames, 8 in
     train, about 20 000 background points a frame, road planes), its
     infos, gt database and best-match database by the port, and
     `tools/train_torch.py` in process on the flagship yaml (B=2, 2 loader
     workers, the yaml's augmentor chain): the host pipeline's ms a train
     frame (augmentor, processors, collate); the gradient repeat (every
     group bit for bit) on a training batch of the tree; one epoch of 4 steps cut after
     its checkpoint, then a second call that auto-resumes for 4 more and
     evaluates the newest checkpoint on val; every step's launches equal
     to TRAIN_LAUNCHES with finite losses, pasted gt boxes and best-match
     points in the batches, the resume step, the eval's launches and
     finite AP keys; then the same 8 steps straight in one call (steps
     5-8 under the profiler): the loop's steps per second and wall ms by
     part, the device idle share, and how far the resumed run's weights
     and optimizer state are from the straight run's;
  8b. the seventh path, 2 ranks over gloo on cuda:0 (the script starts
     them as `chip_smoke.py --dp-worker ...`, each run with its own time
     limit, every process killed when it expires): the flagship train
     step at full width, 2 frames a rank of a B=4 batch (all-reduced
     gradients and the parameters after the step equal on both ranks bit
     for bit, a repeat the same bits, each rank's launches TRAIN_LAUNCHES,
     the step and all-reduce ms, the distance from the one-process B=4
     step); the f32 step of the micro config and of `small_config(full=True)`
     with the model's own output projections and with DP_PROJ_SEEDS' draws
     of them, 1 frame a rank, against one process at B=2: the discrete
     choices that part them counted (sampled rois, proposal NMS keeps, occ
     top-k rows, exact ball queries, the signs of ConvHead's conv-stack
     ReLU inputs), then with the ranks' ball queries and ReLU signs
     replayed in the one-process step, each differing ball proven valid
     and each differing sign's input within RELU_EDGE of 0 in both runs
     (same sampled rois, gradients within 1e-3 of each tensor's max, BN
     statistics within 1e-5). Run inside the
     fourth and sixth paths' trees: `tools/test_torch.py --launcher
     pytorch` under torchrun (merged det_annos equal the one-process
     run's bit for bit, same AP) and `tools/train_torch.py --launcher
     pytorch` under torchrun (a cut run and a resumed one with a
     distributed trailing eval against the straight run: 0 elements
     differ; each checkpoint written once), then one rank over NCCL;
  8c. the eighth path: the full flagship eval forward at B=2 with each of
     EVAL_OPTIONS in its occ subnet (launches = EVAL_LAUNCHES, finite
     outputs, occ points and merged det rows per frame, the median of the
     residual backbones and DB_PROJ) and each option's occ subnet of the
     small config f32 on the card against the CPU; train step A, the
     flagship with PASS_GRAD, DROPOUT_RATE 0.2 (REAL_DROP on) and
     REMAIN_PERCENTAGE [0.5, 1.0]: K2 max's backward on a captured step
     bit for bit against its plain version, the ops
     `use_deterministic_algorithms` flags, one counted step
     (PASS_GRAD_LAUNCHES), the gradient repeat (0 elements), the occ
     backbone's gradients against the same step without PASS_GRAD, 10
     timed steps; train step B, the `fix` variant with PASS_GRAD: K2 sum's
     backward on its 3 levels bit for bit, the launches against the step
     without PASS_GRAD, 3 timed steps; train step C: one counted step each
     with a sigmoid loss + OccHead2D + OccTargetsPillar, the two residual
     backbones and DB_PROJ;
  8d. the ninth path: the 3-class yaml's eval forward + post at B=2 on a
     relabelled synthetic batch (EVAL_LAUNCHES, detections per class, the
     median of 5 runs, peak memory) and its train step (TRAIN_LAUNCHES,
     finite loss terms, the gradient repeat, the median of 5 steps), with
     MATCH_HEIGHT and no corner loss (one counted step) and the RPN target
     assignment's peak memory with and without MATCH_HEIGHT; both CLIs on a
     3-class KITTI tree (`tools/train_torch.py` for 4 steps and its eval,
     then `tools/test_torch.py` on that checkpoint: finite AP keys of every
     class, gt boxes of every class pasted); the small config's 3-class
     variant f32 on the card against the CPU; the flagship eval with each
     of DET_OPTIONS (launches against DET_OPTION_LAUNCHES, the MERGE_IMPL
     v1 and v2 tables equal bit for bit; under `combine` K1's map and GEMM
     of the spconv5 and subm5 convs and K4 on the (2, 5, 100, 88, 128)
     volume against their plain versions); the `combine` train step (K3 of
     spconv5, K4's volume gradient on the combine volume, one counted step,
     the gradient repeat) and one counted step with each new optimizer;
     each option's small f32 config on the card against the CPU;
  8e. the tenth path, at B=2 on the flagship det voxel table after
     MeanVFE: VoxelResBackBone8x at channels (16, 32, 64, 128, 128), its
     eval forward's launches (RES_EVAL_LAUNCHES: 13 K1 GEMMs over 8 maps)
     with all 13 timed; one counted run (SIDE_LAUNCHES) of the backbone,
     the inverse convs 128->64 / 64->32 / 32->16 (keys spconv4 / 3 / 2) and
     a k (2, 2, 2) stride-2 transpose conv 128->64 on x_conv4, forward and
     backward of a fixed random projection of every output; every K1 / K3
     call of it against its plain version (maps bit for bit), the new
     geometries timed (the transpose-query forwards, the forward-query
     dfs, K3 over a transpose map), the gradients twice (0 elements may
     differ); VoxelSetAbstraction at its default widths (2048 keypoints):
     FPS, ball-query and module ms, and its card run against the CPU's
     (keypoints equal, each differing ball list proven valid); atss_assign
     on 70 400 anchors x 10 gt a frame with and without MATCH_HEIGHT (peak
     memory), roiaware_pool3d max / avg and roipoint_pool3d with 128 rois,
     chamfer_distance on 16 pairs of 2048 points, PointPillarScatter on the
     PointPillars KITTI canvas, multi_classes_nms with the 3-class yaml's
     NMS_CONFIG, each against the CPU on the same inputs, with its ms;
  8f. the eleventh path, 2 ranks over gloo on cuda:0 (dp 1 x sp 2): the
     full flagship at B=2 with the BEV pyramid split by rows, its train
     step (train caps) and its eval forward + post-processing (test caps),
     each rank's launches counted (TRAIN_LAUNCHES / EVAL_LAUNCHES: every
     kernel runs on every rank), both ranks bit-equal, held against the
     one-process run on the card from the same weights (gradients within
     1e-3 of each tensor's max, loss terms within 1e-4, BEV BN running
     statistics within 1e-5, the same detections within 1e-5); the BEV
     stage's ms on a rank and in one process, the halo exchange's and the
     row gathers' ms a step, the step and eval medians, the peak MiB a
     rank; then the micro config on 4 ranks (dp 2 x sp 2) in float32
     against one process at the global batch;
  8g. the twelfth path: the flagship yaml as shipped at B=2 (its ConvHead's
     raw and occ SA modules on the roi-grouped approximate query, 512
     candidates a roi) with the main path's synthetic weights: the eval
     forward + post (test caps) with its launches (EVAL_LAUNCHES); each SA
     module's grouped query on the card against the CPU's on the inputs
     the forward gave it (differing candidate lists and balls each proven
     valid in float64 within the f32 rounding of the cut or the radius,
     and counted), its pooled features on the card against a CPU copy
     reading the card's neighbours (bf16 MLPs to SA_BF16_TOL of the max,
     f32 MLPs to 1e-4), the query alone timed (stage 1, stage 2, gather)
     beside the exact query and its gather on the same inputs; the
     roi_head stage ms and the forward + post ms against the exact-query
     flagship on the same weights and batch, in turns, and one profiled
     forward; the train step (train caps: TRAIN_LAUNCHES, the gradient
     repeat with 0 elements differing, 4 timed steps in turns with the
     exact-query flagship's, stage ms) and the PASS_GRAD step
     (PASS_GRAD_LAUNCHES, the gradient repeat); the small full config with
     the approximate query f32 on the card against the CPU
     (`small_input_check`, the grouped queries replayed as proven);
  8h. the thirteenth path, `tools/overfit_proof_torch.py` in process: a
     synthetic KITTI tree of 25 frames x 4 cars (train == val, 4 000
     background points a frame), its infos, gt and best-match databases,
     the flagship yaml as shipped with gt sampling and the world
     augmentations off and the level capacities raised to 36 000 / 26 000 /
     13 000 / 10 000, `tools/train_torch.py` at B=2 with `--cache_items`
     (12 steps an epoch asserted), its trailing eval on the same frames and
     the final checkpoint through `tools/test_torch.py` with 2048 occ
     points and at the default population; every step's launches equal to
     TRAIN_LAUNCHES with finite loss terms, the three evals' launches 39 x
     EVAL_LAUNCHES, every AP_R40 key of every class finite at both occ
     populations (AOS where the eval reports it); the mean loss a epoch,
     the AP tables, steps/s, the loop's wall ms by part, the active sites
     dropped at the level capacities, the merged det table's drops a frame
     and every gt's heading error. The default run trains
     OVERFIT_GATE_EPOCHS epochs and gates on the last epoch's mean loss
     below OVERFIT_GATE_FALL of the first's, then evaluates the gate's
     checkpoint through `tools/test_torch.py` at `--batch_size 8` (batches
     of 8, 8, 8 and 1) and at 1 with the score threshold at
     OVERFIT_BATCH_SCORE: launches EVAL_LAUNCHES a forward, detections in
     both, the AP keys equal, the frames' detections compared and logged;
     then each batch of 8 through the same net gives the CLI's detections
     bit for bit, and each of its frames alone, with the batch's outputs of
     the BEV pyramid, the RPN and ConvHead replaced in (their own held
     within DENSE_ROUNDING of their max), equals the batch's frame bit for
     bit at every stage (`eval_batch_agreement`); `--overfit` trains 150 epochs
     (1 800 steps, the JAX package's proof) and gates on 3d, bev and bbox
     AP_R40 >= OVERFIT_AP_MIN at every difficulty for every class and on
     Car AOS >= OVERFIT_AP_MIN with 2048 occ points (the default
     population's AOS is recorded, not gated); `--three_classes` runs it on
     the 3-class yaml;
  9. JSON lines of the thirteenth path's numbers and of per-kernel numbers
     (the first path's `@B8` entries last), then the contract line
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


def ptxas_function(line: str) -> str:
    """":kernel<dtype>" of a ptxas "Compiling entry function '<mangled>'"
    line, read from the mangled name ("" where it names no kernel)."""
    import re

    m = re.search(r"\d+([a-z][a-z_]*?kernel)", line)
    if not m:
        return ""
    kind = "<bf16>" if "bfloat16" in line else "<f32>" if "IfE" in line else ""
    return f":{m.group(1)}{kind}"


def gpu_name_and_power_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def load_tool(name: str):
    """`tools/<name>.py` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
# spconv3 table), spconv_down2, subm_down2; the occ-code pools and convs
# at k=3 pair like the trunk's strided convs and read their maps, the
# `avgpool` variant's k=2 pools build one map per level
EVAL_MAPS = 9
AVGPOOL_MAPS = 12
# kernel launches of one flagship eval forward + post-processing
EVAL_LAUNCHES = {"neighbor_map": EVAL_MAPS, "sparse_conv": 18, "sparse_conv_df": 0, "tap_pairs": 0,
                 "sparse_conv_dw": 0, "sparse_pool": 1, "sparse_sum_pool": 0,
                 "sparse_pool_grad": 0, "sparse_sum_pool_grad": 0, "trilinear_pool": 1,
                 "trilinear_pool_grad": 0, "furthest_point_sample": 0}
# kernel launches of one flagship train step: the 9 forward maps and the 8
# transpose-query maps of the strided convs' dfs, 18 convs (17 of them
# with a df), 18 weight gradients, each on its own compaction of the map,
# the sampler and its volume gradient
TRAIN_LAUNCHES = {"neighbor_map": 17, "sparse_conv": 18, "sparse_conv_df": 17, "tap_pairs": 18,
                  "sparse_conv_dw": 18, "sparse_pool": 1, "sparse_sum_pool": 0,
                  "sparse_pool_grad": 0, "sparse_sum_pool_grad": 0, "trilinear_pool": 1,
                  "trilinear_pool_grad": 1, "furthest_point_sample": 0}


def kernel_modules():
    """{kernel wrapper name: the ops module holding it}; each wrapper counts
    its launches as the recorder's counter `launch.<name>`."""
    from btcdet_tpu_torch.ops import cuda_conv, cuda_interp, cuda_pool, group_ops

    return {"neighbor_map": cuda_conv, "sparse_conv": cuda_conv, "sparse_conv_df": cuda_conv,
            "tap_pairs": cuda_conv, "sparse_conv_dw": cuda_conv, "sparse_pool": cuda_pool,
            "sparse_sum_pool": cuda_pool, "sparse_pool_grad": cuda_pool,
            "sparse_sum_pool_grad": cuda_pool, "trilinear_pool": cuda_interp,
            "trilinear_pool_grad": cuda_interp, "furthest_point_sample": group_ops}


def reset_launches():
    from btcdet_tpu_torch.utils import trace

    trace.reset_counts("launch.")


def read_launches(names=None) -> dict:
    from btcdet_tpu_torch.utils import trace

    n = trace.counts("launch.")
    return {name: n.get(name, 0) for name in kernel_modules() if names is None or name in names}


def capture_kernel_inputs(run):
    """Call run() with recording wrappers around the kernel entry points;
    returns the recorded calls (args, kwargs) of each, in order."""
    mods = kernel_modules()
    calls = {name: [] for name in mods}
    orig = {name: getattr(mod, name) for name, mod in mods.items()}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return orig[name](*args, **kw)
        return rec

    for name, mod in mods.items():
        setattr(mod, name, recorder(name))
    try:
        run()
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])
    return calls


def device_ms(fn, kernel, reps: int = 20, sessions: int = 3) -> float:
    """Mean device time of the kernels whose name holds `kernel` over
    `reps` calls of fn(), from torch.profiler: the kernel's own time, where
    `cuda_ms` of back-to-back calls also counts the gaps a slower host
    leaves between short launches. The profiler may miss some of a
    session's launches (now and then all of them, in several sessions in
    a row); the mean is over those it saw, at least half, in the first of
    up to `sessions` sessions that saw that many. Where none did, the time
    is `cuda_ms` of `reps` back-to-back calls (host gaps included), and the
    miss is logged and counted in PROFILER_MISSES. `kernel` may be a tuple
    of names, each launched once a call, or a dict {name: launches a call}:
    the sum of each one's mean times its launches a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    per_call = ({kernel: 1} if isinstance(kernel, str) else
                dict(kernel) if isinstance(kernel, dict) else dict.fromkeys(kernel, 1))
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        times = {name: [e.time_range.elapsed_us() for e in events if name in e.name]
                 for name in per_call}
        if all(2 * len(times[n]) >= reps * k for n, k in per_call.items()):
            return sum(sum(t) / len(t) * per_call[n] for n, t in times.items()) / 1e3
    PROFILER_MISSES.append(tuple(per_call))
    ms = cuda_ms(fn, reps=reps)
    log(f"  (the profiler saw {[len(t) for t in times.values()]} {tuple(per_call)} kernels of "
        f"{[k * reps for k in per_call.values()]} and {len(events)} device events in all, in "
        f"each of {sessions} sessions: {ms:.4f} ms from CUDA events of back-to-back calls, host "
        "gaps included)")
    return ms


# device_ms calls whose profiler sessions all missed the kernel
PROFILER_MISSES = []


def idle_share(busy_ms: float, wall_ms: float) -> str:
    """The device's idle share over a profiled run, or why there is none:
    a session that saw no kernel measured nothing."""
    if busy_ms <= 0:
        return "not measured (the profiler saw no kernel)"
    return f"{1 - busy_ms / wall_ms:.3f}"


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
    against its plain version to TOL and bit for bit on a repeat. A
    forward with `transpose` is that of a transpose or inverse conv, over
    the transpose-query map of its input table. Returns the entries of the
    map and of the GEMM."""
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
            return cuda_conv.sparse_conv_plain(*cargs, transpose=transpose)
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


def eval_conv_picks(convs, suffix: str = "") -> dict:
    """{name: captured args} of the five K1 convs the kernel phase holds
    against their plain versions, from an eval forward's `sparse_conv`
    calls (args: features, keys, out_coords, weights, in_shape, batch,
    kernel, stride, padding), picked by kernel / stride / Cout, first in
    call order; `suffix` ends each name."""
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
    return {name + suffix: args for name, args in picks.items()}


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


def k2_case(call, label: str = "", mode: str = "max"):
    """Compare (bit for bit) / time K2 on a captured occ-code pool (args,
    kwargs), over the neighbour map the forward gave it: max mode
    (`sparse_pool`) or sum mode (`sparse_sum_pool`, FixedSparseConv3d).
    The map-driven plain version must also equal the search-driven one
    (rulebook) bit for bit. `label` names a call of another path than the
    eval forward."""
    import torch

    from btcdet_tpu_torch.ops import cuda_pool

    kern_fn, plain_fn = ((cuda_pool.sparse_pool, cuda_pool.sparse_pool_plain) if mode == "max"
                         else (cuda_pool.sparse_sum_pool, cuda_pool.sparse_sum_pool_plain))
    (feats, keys, coords, shape, bsz, ksize, stride, pad), kw = call
    nbr = kw["nbr"]
    feats = feats.detach()
    args = (feats, keys, coords, shape, bsz, ksize, stride, pad)
    out = kern_fn(*args, nbr=nbr)
    ref = plain_fn(feats, keys, coords, shape, ksize, stride, pad, nbr)
    searched = plain_fn(feats, keys, coords, shape, ksize, stride, pad)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), f"K2 {mode} {label}: kernel and plain version differ"
    assert torch.equal(ref, searched), f"K2 {mode} {label}: the forward's map pairs otherwise"
    err = float((out - ref).abs().max())
    # bound: the input rows some tap matched and the (K, M) map, read once,
    # the f32 output written once; one comparison per match and channel
    found = nbr >= 0
    matches = int(found.sum())
    rows_read = int(nbr[found].unique().numel())
    N, C = feats.shape
    K, M = nbr.shape
    nbytes = rows_read * C * 4 + K * M * 4 + M * C * 4
    flops = float(matches * C)
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    ms = cuda_ms(lambda: kern_fn(*args, nbr=nbr), reps=20)
    kernel_ms = device_ms(lambda: kern_fn(*args, nbr=nbr), "sparse_pool_kernel")
    plain_ms = cuda_ms(lambda: plain_fn(feats, keys, coords, shape, ksize, stride, pad, nbr),
                       reps=5, warmup=1)
    log(f"K2 {kern_fn.__name__} ({mode}){' ' + label if label else ''}: N={N} M={M} C={C} "
        f"kernel={ksize} stride={stride} padding={pad} "
        f"matches={matches} rows_read={rows_read} "
        f"rows_with_a_match={int(found.any(0).sum())} bytes={nbytes} max_abs_err={err} "
        f"(bitwise equal, map-driven plain = search-driven plain) ms={ms:.4f} (kernel alone, "
        f"profiler: {kernel_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms={bound_s * 1e3:.4f}")
    name = "sparse_pool" if mode == "max" else "sparse_pool_sum"
    return {"name": name + (f":{label}" if label else ""), "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_pool.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:511", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations", "library_ms": None}


def k4_corners(shape, zyx, roi_b, valid):
    """(the linear cell of every in-volume corner of a valid sample, the
    number of valid samples with at least one) in a (B, D, H, W, ...)
    volume: the other corners weigh 0 and are not read."""
    import torch

    B, D, H, W = shape[:4]
    ok = valid & ((roi_b >= 0) & (roi_b < B))[:, None]
    pts = zyx[ok]                                             # (n, 3)
    b = roi_b[:, None].expand(valid.shape)[ok].long()
    base = torch.floor(pts).long()
    cells, any_in = [], torch.zeros_like(b, dtype=torch.bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                z, y, x = base[:, 0] + dz, base[:, 1] + dy, base[:, 2] + dx
                inb = (z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
                cells.append((((b * D + z) * H + y) * W + x)[inb])
                any_in |= inb
    return torch.cat(cells), int(any_in.sum())


def k4_reads(shape, zyx, roi_b, valid):
    """(distinct volume cells, corner reads) that the valid samples of this
    run need (`k4_corners`)."""
    cells, _ = k4_corners(shape, zyx, roi_b, valid)
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
    n_cells, n_reads = k4_reads(vol.shape, zyx, roi_b, valid)
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


def k4_grad_launches(shape) -> dict:
    """{kernel: launches} of one `trilinear_pool_bwd` call on a (B, D, H,
    W, ...) volume: the entries' keys (with the first sort pass's
    histogram), per radix pass the histogram (after the first), its scan
    (three kernels) and the stable scatter, the segments' bounds, the scan
    of the cells' segments, the chunk list, the zero fill of untouched
    cells, the chunk sums and the combine of cells of several chunks. The
    passes follow the cell keys' bits (2 for the flagship's volume)."""
    from btcdet_tpu_torch.ops import cuda_interp

    keys = cuda_interp.bwd_key_count(shape)
    passes = -(-keys.bit_length() // cuda_interp.BWD_RADIX_BITS)
    return {"corner_entries_kernel": 1, "radix_upsweep_kernel": passes - 1,
            "scan_reduce_kernel": passes + 1, "scan_partials_kernel": passes + 1,
            "scan_apply_kernel": passes + 1, "radix_downsweep_kernel": passes,
            "segment_bounds_kernel": 1, "chunk_list_kernel": 1, "zero_fill_kernel": 1,
            "chunk_sum_kernel": 1, "chunk_combine_kernel": 1}


# the `hot` layout of tests/test_torch_kernels.py::_k4_grad_case at the
# flagship's width: 40 rois of 2 592 samples piled around one centre
# (within 2 cells in y and x), so cells hold thousands of corner entries;
# the rois split evenly over the 2 frames, so `grid_sampler_3d_backward`
# can time the same function
K4_GRAD_HOT = {"R": 40, "S": 2592, "C": 128, "shape": (2, 5, 200, 176), "spread": 2.0,
               "seed": 5}


def k4_grad_hot_args():
    """(g, volume shape, dtype, zyx, roi_b, valid) of the `hot` layout
    (K4_GRAD_HOT), made on the host from its seed: bf16 g, the step's dtype."""
    import torch

    h = K4_GRAD_HOT
    R, S, C, (B, D, H, W) = h["R"], h["S"], h["C"], h["shape"]
    gen = torch.Generator().manual_seed(h["seed"])
    centre = torch.rand(1, 2, generator=gen) * torch.tensor([H - 20.0, W - 20.0]) + 10
    zyx = torch.cat([torch.rand(R, S, 1, generator=gen) * (D + 2) - 1,
                     centre[:, None] + (torch.rand(R, S, 2, generator=gen) - 0.5) * h["spread"]],
                    -1)
    zyx[0, :7] = torch.tensor([0.0, 3.0, 4.0])      # on grid points: zero-weight corners
    roi_b = torch.arange(B).repeat_interleave(R // B)
    valid = torch.rand(R, S, generator=gen) < 0.9
    g = torch.randn(R, S, C, generator=gen)
    return (g.to("cuda", torch.bfloat16), (B, D, H, W, C), torch.bfloat16, zyx.to("cuda"),
            roi_b.to("cuda"), valid.to("cuda"))


# the bins of the segment-length histogram (entries a cell), upper bounds
K4_GRAD_SEG_BINS = (1, 8, 64, 1024)


def k4_segment_histogram(seg) -> dict:
    """{bin: [cells, entries]} of the per-cell entry counts `seg`: untouched
    cells, then K4_GRAD_SEG_BINS' ranges and the rest."""
    import torch

    hist, lo = {"0": [int((seg == 0).sum()), 0]}, 1
    for hi in (*K4_GRAD_SEG_BINS, None):
        sel = (seg >= lo) if hi is None else (seg >= lo) & (seg <= hi)
        name = f">{lo - 1}" if hi is None else (f"{lo}" if lo == hi else f"{lo}-{hi}")
        hist[name] = [int(sel.sum()), int(seg[sel].sum())]
        lo = (hi or 0) + 1
    return hist


def k4_grad_case(args, label: str = "train"):
    """K4's volume gradient (`trilinear_pool_bwd`) on the captured call of
    a train step (or the `hot` layout) against its plain version (8
    `index_add_` calls with float atomics): the f32 kernel within 1e-5 of
    the plain output's max and no further from a float64 sum than the
    plain version; the bf16 kernel (the step's) equal to the f32 kernel's
    sum rounded once, and within one bf16 ulp of the plain version's cast
    wherever the f32 sums round alike (the others counted); both equal bit
    for bit to the ordered plain version (`trilinear_pool_volume_grad_ordered`,
    the kernel's order of sums); bit for bit on a repeat; timed, by kernel
    too, beside `grid_sampler_3d_backward` as the library yardstick."""
    import torch

    from btcdet_tpu_torch.ops import cuda_interp

    g, shape, dtype, zyx, roi_b, valid = args
    B, D, H, W, C = shape
    R, S, _ = zyx.shape

    def kernel(dt=dtype, gg=g):
        return cuda_interp.trilinear_pool_grad(gg, shape, dt, zyx, roi_b, valid)

    out = kernel()
    again = kernel()
    out32 = kernel(torch.float32, g.float())
    ref32 = cuda_interp.trilinear_pool_volume_grad(g, shape, zyx, roi_b, valid)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, again), "K4 grad: not bit for bit on a repeat"
    assert torch.equal(out, out32.to(dtype)), "K4 grad: bf16 output is not the f32 sum rounded once"
    scale = float(ref32.abs().max())
    err32 = float((out32 - ref32).abs().max())
    assert err32 <= 1e-5 * scale, f"K4 grad: f32 {err32} from plain, max {scale}"
    exact = cuda_interp.trilinear_pool_volume_grad(g, shape, zyx, roi_b, valid, torch.float64)
    err_k = float((out32.double() - exact).abs().max())
    err_p = float((ref32.double() - exact).abs().max())
    assert err_k <= err_p, f"K4 grad: {err_k} from a float64 sum, plain {err_p}"
    del exact
    ordered = cuda_interp.trilinear_pool_volume_grad_ordered(g, shape, zyx, roi_b, valid)
    torch.cuda.synchronize()
    n_ordered = int((out32 != ordered).sum())
    assert n_ordered == 0 and torch.equal(out, ordered.to(dtype)), (
        f"K4 grad: {n_ordered} f32 elements differ from the ordered plain version")
    del ordered
    diff = (out.float() - ref32.to(dtype).float()).abs()
    mag = torch.maximum(out.float().abs(), ref32.to(dtype).float().abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    beyond = int((diff > ulp).sum())
    assert bool((diff <= ulp + 1e-5 * scale).all()), "K4 grad: bf16 beyond one ulp + f32 tolerance"
    err = float(diff.max())
    del diff, mag, ulp, out32, again
    ms = cuda_ms(kernel, reps=10)
    per_call = {k: n for k, n in k4_grad_launches(shape).items() if n}
    kernel_ms = device_ms(kernel, per_call, reps=10)
    parts = {name: round(device_ms(kernel, {name: n}, reps=5), 4) for name, n in per_call.items()}
    plain_ms = cuda_ms(lambda: cuda_interp.trilinear_pool_volume_grad(
        g, shape, zyx, roi_b, valid).to(dtype), reps=5, warmup=1)
    ordered_ms = cuda_ms(lambda: cuda_interp.trilinear_pool_volume_grad_ordered(
        g, shape, zyx, roi_b, valid).to(dtype), reps=2, warmup=1)
    # library yardstick: the input gradient of 5-D grid_sample (the mapping
    # of k4_case, f32) on the same gradient, invalid samples zeroed
    lib_ms, lib_kernel_ms, lib_err = None, None, None
    if R % B == 0 and bool((roi_b == torch.arange(B, device=roi_b.device)
                            .repeat_interleave(R // B)).all()):
        size = torch.tensor([W, H, D], dtype=torch.float32, device=zyx.device)
        grid = (2.0 * zyx.flip(-1) / (size - 1) - 1.0).reshape(B, (R // B) * S, 1, 1, 3)
        inp = torch.zeros((B, C, D, H, W), dtype=torch.float32, device=g.device)
        gout = (torch.where(valid[..., None], g.float(), 0.0).reshape(B, (R // B) * S, C)
                .permute(0, 2, 1).reshape(B, C, (R // B) * S, 1, 1).contiguous())

        def lib():
            return torch.ops.aten.grid_sampler_3d_backward(gout, inp, grid, 0, 0, True,
                                                           [True, False])[0]
        lib_err = float((lib().permute(0, 2, 3, 4, 1) - ref32).abs().max())
        lib_ms = cuda_ms(lib, reps=10)
        lib_kernel_ms = device_ms(lib, "grid_sampler_3d_backward", reps=10)
        del inp, gout
    # bound: the rows of g that a valid sample with an in-volume corner
    # needs, in g's dtype, the points, flags and roi indices read once, and
    # the whole output volume written once; operations: a multiply and an
    # add per channel of each in-volume corner of a valid sample, at the f32
    # rate. The kernel's workspace (sort keys, entries, partial rows) is its
    # own traffic, not the function's: its size is logged beside it
    n_entries = 8 * R * S
    cells, n_rows = k4_corners(shape, zyx, roi_b, valid)
    n_in = int(cells.numel())
    seg = torch.bincount(cells, minlength=B * D * H * W)
    chunks = (seg + cuda_interp.BWD_CHUNK - 1) // cuda_interp.BWD_CHUNK
    seg_max, n_chunks, n_multi = int(seg.max()), int(chunks.sum()), int((chunks > 1).sum())
    hist = k4_segment_histogram(seg)
    del cells, seg, chunks
    elt = out.element_size()
    nbytes = (n_rows * C * elt + R * S * 12 + R * S + R * 4 + B * D * H * W * C * elt)
    ws_bytes = cuda_interp._lib().trilinear_pool_bwd_workspace(R * S, B, D, H, W, C)
    flops = 2.0 * C * n_in
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    log(f"K4 volume gradient {label}: volume {tuple(shape)} {dtype} R={R} S={S} corner entries "
        f"{n_entries} (in the volume, of valid samples: {n_in}; longest segment {seg_max}; "
        f"{n_chunks} chunks of up to {cuda_interp.BWD_CHUNK} entries, {n_multi} cells of more "
        f"than one; bit for bit with the ordered plain version) max_abs_err={err:.3e} (bf16 "
        f"against the plain "
        f"version's cast; {beyond} of {out.numel()} elements beyond one bf16 ulp, all within it "
        f"plus 1e-5 of the plain max {scale:.3e}; f32 {err32:.3e}; from a float64 sum: kernel "
        f"{err_k:.3e}, plain {err_p:.3e}) ms={ms:.4f} (kernel alone, profiler: "
        f"{kernel_ms:.4f}, {n_rows * C * elt / (kernel_ms * 1e-3) / 1e9:.1f} GB/s of g rows; by "
        f"kernel {json.dumps(parts)}) plain_ms={plain_ms:.4f} (ordered plain "
        f"{ordered_ms:.4f}) "
        f"grid_sampler_3d_backward_ms={lib_ms} "
        f"(kernel alone {lib_kernel_ms}; max diff to the plain f32 {lib_err}) bytes={nbytes} "
        f"(g rows {n_rows}) bound_ms={bound_s * 1e3:.4f}; the kernel's workspace, not in the "
        f"bound: {ws_bytes} bytes; segment lengths, {{bin: [cells, entries]}}: "
        f"{json.dumps(hist)}")
    return {"name": "trilinear_pool_grad" + (f":{label}" if label else ""), "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/trilinear_pool.cu",
            "replaces": "btcdet_tpu/ops/pallas_interp.py:284", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations", "library_ms": lib_ms}


def synced_stage_ms(run) -> dict:
    """Wall ms by stage of run(), each stage span between two device
    synchronisations (the recorder's `enable(sync=True)`), summed over the
    spans of a name: for stage breakdowns, not for throughput."""
    from btcdet_tpu_torch.utils import trace

    trace.enable(sync=True, tallies=False)
    try:
        run()
    finally:
        rec = trace.disable()
    return {n: rec.ms(n) for n in dict.fromkeys(s[0] for s in rec.spans)
            if not n.startswith("sync.")}


def stage_times(net, batch, post_cfg) -> dict:
    """Wall ms per stage of one forward + post-processing, each stage
    between two device synchronisations."""
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing

    times = synced_stage_ms(lambda: post_processing(net(batch), post_cfg, 1))
    return {s: round(times[s], 3) for s in STAGES if s in times}


def stage_profile(net, batch, post_cfg, label: str = "step"):
    """Where the time goes in one forward + post-processing: wall ms per
    stage, then one step under torch.profiler for the device's idle share
    and its top kernels. Returns (stage ms, profiled wall ms, kernel ms)."""
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing

    stages = stage_times(net, batch, post_cfg)
    log("stage ms (synchronised): " + json.dumps(stages))
    return (stages, *profile_step(lambda: post_processing(net(batch), post_cfg, 1), STAGES,
                                  label))


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


def merge_repeat(net, batch, runs: int = 5):
    """The fused PassOccVox merge (`ops/voxelizer.py`) gives the same merged
    det voxel features bit for bit from run to run (its per-voxel sums are
    float `index_add_`s, which add in atomic order on the card)."""
    import torch

    outs = [net.occ_modules(batch) for _ in range(runs)]
    feats = [o["det_voxel_features"] for o in outs]
    for o in outs[1:]:
        assert torch.equal(o["det_voxel_coords"], outs[0]["det_voxel_coords"])
    moved = max(int((f != feats[0]).sum()) for f in feats)
    log(f"merged det voxel features, full flagship (B=2): {runs} runs, {moved} of "
        f"{feats[0].numel()} elements differ from the first run")
    assert moved == 0, f"merged det voxel features move between runs ({moved} elements)"


def check_eval_outputs(net, batch, out, post, bev=(200, 176)):
    """Finite eval outputs of the expected shapes (`bev` the BEV map's rows
    and columns) and finite detections; returns the detections per frame."""
    import torch

    B = batch["points"].shape[0]
    occ_grid = tuple(int(v) for v in net.occ_modules.spec.grid_size[::-1])
    n_anchor = net.det_modules.dense_head.anchors.shape[0]
    K = net.occ_modules.eval_max_occ_pnts
    expect = {"occ_probs": (B, *occ_grid), "occ_points": (B, K, 4),
              "rpn_box_preds": (B, n_anchor, 7), "batch_box_preds": (B, 100, 7),
              "batch_cls_preds": (B, 100, 1), "spatial_features_2d": (B, *bev, 256)}
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
            for level, call in enumerate(calls[:3 if down == "fix" else 1], start=1):
                cases.append(k2_case(call, f"{down}_l{level}", mode="sum"))
            del calls
        reset_launches()
        out = net(batch)
        post = post_processing(out, cfg.MODEL.POST_PROCESSING, 1)
        torch.cuda.synchronize()
        launches = read_launches()
        want = dict(EVAL_LAUNCHES, neighbor_map=AVGPOOL_MAPS if down == "avgpool" else EVAL_MAPS,
                    sparse_conv=23 if down == "weight" else 20,
                    sparse_pool=3 if down == "maxpool" else 0,
                    sparse_sum_pool=3 if down in ("fix", "avgpool") else 0)
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


def kernel_times(prof, ranges=()) -> dict:
    """{kernel name: (launches, ms)} of a finished profiler session; names
    in `ranges` are profiler ranges, not kernels."""
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    return kernels


def profile_step(fn, ranges=(), label: str = "step"):
    """One call of fn() under torch.profiler: wall ms, kernel time, the
    device's idle share and the top kernels (names in `ranges` are the
    profiler ranges of the stages, not kernels). Returns (wall ms, kernel
    ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = kernel_times(prof, ranges)
    busy = sum(t for _, t in kernels.values())
    log(f"profiled {label}: wall {wall:.2f} ms (profiler on), kernel time {busy:.2f} ms, "
        f"device idle share {idle_share(busy, wall)}")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"  {t:9.3f} ms  x{n:<5d} {name[:100]}")
    return wall, busy


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
    """The eval proposal NMS's call (`iou3d.nms_rotated_batched`, every frame
    of the batch at once, k = NMS_PRE_MAXSIZE) captured from one forward:
    the kernel keeps, frame by frame, the boxes of the full-matrix greedy and
    of the plain version; the three are timed (host clock, 5 runs of the
    call after 2 warm-ups, median; the plain and full-matrix a frame at a
    time)."""
    import torch

    from btcdet_tpu_torch.ops import iou3d

    calls, orig = [], iou3d.nms_rotated_batched

    def rec(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    iou3d.nms_rotated_batched = rec
    try:
        net(batch)
    finally:
        iou3d.nms_rotated_batched = orig
    frames = [(tuple(t[b] for t in a), kw) for a, kw in calls for b in range(a[0].shape[0])]
    for a, kw in calls:
        idx, ok = orig(*a, **kw)
        for b in range(a[0].shape[0]):
            fa = tuple(t[b] for t in a)
            want = full_matrix_nms(*fa, **kw)
            assert torch.equal(idx[b][ok[b]].cpu(), want), \
                "kernel and full-matrix NMS keep other boxes"
            p_idx, p_ok = iou3d.nms_rotated_plain(*fa, **kw)
            assert torch.equal(idx[b], p_idx) and torch.equal(ok[b], p_ok), \
                "kernel and plain NMS keep other boxes"

    def run(fn, per_frame):
        def all_calls():
            for a, kw in (frames if per_frame else calls):
                fn(*a, **kw)
            torch.cuda.synchronize()
        return timed_median(all_calls)[0]

    kernel, plain = run(orig, False), run(iou3d.nms_rotated_plain, True)
    full = run(full_matrix_nms, True)
    log(f"proposal NMS, {len(calls)} call(s) of {len(frames)} frames (k = "
        f"{[min(kw['pre_max_size'], a[0].shape[1]) for a, kw in calls]}"
        f" -> {calls[0][1]['post_max_size']}, same kept sets): kernel {kernel:.3f} ms, "
        f"plain {plain:.3f} ms, full matrix {full:.3f} ms (median of 5)")


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


def f32_everywhere():
    """Float32 activations in the port and no TF32, for the duration
    (`common.float32_everywhere`)."""
    from btcdet_tpu_torch.utils.common import float32_everywhere

    return float32_everywhere()


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
    between the devices, and it decides the ball query's first picks. Its
    ConvHead likewise takes the card's ball queries (`replay_ball_queries`)
    where the query point is the same on both devices, after each has been
    held against the CPU's own: equal but for points whose distance lies
    within f32 rounding of a ball's radius. A query whose point moved keeps
    the CPU's own neighbours.
    `spread`: the card's occ probabilities must also be identical over 3
    runs (the occ backbone's scoped deterministic cuDNN); the spread with
    that scope bypassed is printed beside it."""
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import clamp_intensity

    full = cfg.MODEL.get("OCC") is not None
    balls = ball_record()
    with f32_everywhere():
        outs, occ = {}, {}
        for dev in ("cuda", "cpu"):
            classes = list(cfg.get("CLASS_NAMES", ["Car"]))
            net = build_network(cfg.MODEL, cfg.DATA_CONFIG, classes, device=dev)
            net.load_state_dict(weights.synth_state_dict(net))
            batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=4096,
                                         num_gt=4, seed=3, mode="test", device=dev)
            if len(classes) > 1:
                batch = relabel(batch, len(classes))
            hook = None
            if full and dev == "cuda":
                hook = net.occ_modules.register_forward_hook(
                    lambda m, i, o: occ.update(cuda={k: v.cpu() if torch.is_tensor(v) else v
                                                     for k, v in o.items()}))
            elif full:
                # the occ subnet reads the batch as the forward hands it on
                occ["cpu"] = net.occ_modules(batch if net.clamp is None
                                             else clamp_intensity(batch, net.clamp))
                hook = net.occ_modules.register_forward_hook(lambda m, i, o: occ["cuda"])
            with replay_ball_queries(balls, record=dev == "cuda"):
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
    log(f"small-input check, {label}: max abs diff by stage " + json.dumps(worst))
    for k in keys:
        torch.testing.assert_close(g[k].float(), c[k].float(), rtol=1e-3, atol=1e-3,
                                   msg=lambda m, k=k: f"{k}: {m}")
    extra = (f" (ball queries: {balls['flips']} differ between the devices, each a valid "
             f"answer; the point that flips lies at most {balls['worst']:.2e} m^2 from its "
             f"radius^2; {balls['moved']} query points moved more than {BALL_MOVED_M} m, at "
             f"most {balls['moved_max']:.2e} m, and kept the CPU's neighbours, "
             f"{balls['moved_differ']} of them with lists that differ; each differing query: "
             f"{json.dumps(balls['differ'][:10])})")
    if full:
        n_occ = [int(v) for v in g["occ_points_mask"].sum(1)]
        extra += f" (occ points per frame {n_occ}, merged det voxels {len(merged['cuda'])})"
    if balls.get("grouped_stats"):
        extra += (" (roi-grouped queries, the CPU's own against the card's; a roi whose centre "
                  f"or grid points moved more than {BALL_MOVED_M} m keeps the CPU's: "
                  + json.dumps(balls["grouped_stats"]) + ")")
    log(f"small-input check, {label}{extra}: every stage within rtol=atol=1e-3 (cuda f32 vs "
        "cpu f32)")
    if spread:
        log("card run-to-run spread of the occ probabilities over 3 runs: " + json.dumps(spreads))


# the distance^2 (m^2) within which a ball query's neighbour may differ
# between the card and the CPU: f32 rounding of |q|^2 + |x|^2 - 2 q.x on a
# 16 m scene is about 3e-5, and the query points differ by f32 rounding too
BALL_EDGE_M2 = 1e-3
# a query point (roi grid point) that moved more than this (m, any axis)
# between the devices keeps the CPU's own neighbours
BALL_MOVED_M = 1e-4


@contextlib.contextmanager
def replay_ball_queries(balls: dict, record: bool):
    """`group_ops.multi_ball_query` recorded (`record`, the card's run) into
    balls["calls"], or replayed: each call computes its own result and
    checks it against the recorded one call by call (the roi-grouped
    `multi_ball_query_grouped_cand` likewise, into balls["grouped"],
    checked by `grouped_query_diff` into balls["grouped_stats"]; a roi whose
    centre or grid points moved more than BALL_MOVED_M keeps the CPU's
    answer, the others take the card's). Where the two lists of
    a query differ, each must be a valid answer for its own query point in
    float64: every listed point within BALL_EDGE_M2 of the ball (or shell),
    every point deeper inside than that listed, up to the list's last index
    where the ball holds more than it keeps (the first points in point
    order). A query whose point lies within BALL_MOVED_M on both devices
    then pools the card's neighbours on the CPU too, so both devices pool
    the same points; one whose point moved further keeps the CPU's own, and
    the downstream comparison holds it end to end. balls["flips"] counts
    the differing queries that did not move, balls["worst"] is the largest,
    over them, of the distance from the radius^2 of the differing point
    nearest the edge (the one that flipped); balls["moved"] counts the
    queries that moved, balls["moved_differ"] those of them whose lists
    differ, balls["moved_max"] is the largest move (m), and
    balls["differ"] describes each differing query."""
    import torch

    from btcdet_tpu_torch.ops import group_ops

    orig = group_ops.multi_ball_query
    calls = iter(list(balls["calls"]))
    orig_g = group_ops.multi_ball_query_grouped_cand
    gcalls = iter(list(balls.setdefault("grouped", [])))

    def recorded(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, **kw):
        out = orig(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, **kw)
        balls["calls"].append((new_xyz.cpu(), [(i.cpu(), e.cpu()) for i, e in out]))
        return out

    def edge_m2(d2, differ, lo, hi):
        """The distance from the radius^2 of the differing point nearest it."""
        return min(min([abs(float(d2[n]) - hi)] + ([abs(float(d2[n]) - lo)] if lo > 0 else []))
                   for n in differ)

    def replayed(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, **kw):
        out = orig(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, **kw)
        card_xyz, card = next(calls)
        q, qm = new_xyz.cpu(), new_mask.cpu()
        move = (q - card_xyz).abs().amax(-1)
        moved = (move > BALL_MOVED_M) & qm
        balls["moved"] += int(moved.sum())
        if bool(qm.any()):
            balls["moved_max"] = max(balls["moved_max"], float(move[qm].max()))
        pts, ok = xyz.cpu().double(), xyz_mask.cpu()
        res = []
        for s, ((idx, empty), (cidx, cempty), (lo, hi)) in enumerate(
                zip(out, card, group_ops._radii2(radii))):
            idx, empty = idx.cpu(), empty.cpu()
            for b, m in ((idx != cidx).any(-1) | (empty != cempty)).nonzero().tolist():
                d2_cpu = ((pts[b] - q[b, m].double()) ** 2).sum(-1)
                for lst, emp, qm_ in ((idx[b, m], empty[b, m], q[b, m]),
                                      (cidx[b, m], cempty[b, m], card_xyz[b, m])):
                    assert ball_list_valid(lst.numpy(), bool(emp), pts[b].numpy(),
                                           ok[b].numpy(), qm_.double().numpy(), hi,
                                           BALL_EDGE_M2, lo), (
                        f"ball query {m} of frame {b} (scale {s}, moved {float(move[b, m]):.2e}"
                        f" m): {sorted(set(lst.tolist()))} is no first-in-point-order answer "
                        f"within {BALL_EDGE_M2} m^2 of its radius")
                differ = set(idx[b, m].tolist()) ^ set(cidx[b, m].tolist())
                edge = edge_m2(d2_cpu, differ, lo, hi) if differ else 0.0
                full = not bool(empty[b, m]) and len(set(idx[b, m].tolist())) == idx.shape[-1]
                balls["differ"].append({"frame": b, "query": m, "scale": s,
                                        "moved_m": float(move[b, m]), "full": full,
                                        "edge_m2": edge})
                if moved[b, m]:
                    balls["moved_differ"] += 1
                else:
                    balls["flips"] += 1
                    balls["worst"] = max(balls["worst"], edge)
            res.append((torch.where(moved[..., None], idx, cidx).to(xyz.device),
                        torch.where(moved, empty, cempty).to(xyz.device)))
        return res

    def recorded_g(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers,
                   group_size, cand_k=512):
        out = orig_g(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers,
                     group_size, cand_k=cand_k)
        balls["grouped"].append(grouped_answer(new_xyz, group_centers, out))
        return out

    def replayed_g(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers,
                   group_size, cand_k=512):
        """The CPU's own answer held against the card's (each valid for its
        own query points where they differ), then the card's answer for the
        rois whose centre and grid points moved at most BALL_MOVED_M."""
        own = orig_g(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers,
                     group_size, cand_k=cand_k)
        card = next(gcalls)
        cpu = grouped_answer(new_xyz, group_centers, own)
        grouped_query_diff(xyz.cpu(), xyz_mask.cpu(), card, cpu, radii,
                           balls.setdefault("grouped_stats", grouped_stats()))
        B, R, ck = cpu[2].shape
        G = int(group_size)
        move = torch.maximum((cpu[0] - card[0]).abs().amax(-1).reshape(B, R, G).amax(-1),
                             (cpu[1] - card[1]).abs().amax(-1))
        moved = move > BALL_MOVED_M                                          # (B, R)
        balls["grouped_stats"]["moved_rois"] = (balls["grouped_stats"].get("moved_rois", 0)
                                                + int(moved.sum()))
        cand = torch.where(moved[..., None], cpu[2], card[2]).to(xyz.device)
        mg = moved.repeat_interleave(G, dim=1)[..., None]
        scales = [(torch.where(mg, p, cp).to(xyz.device), torch.where(mg[..., 0], e, ce).to(
            xyz.device)) for (p, e), (cp, ce) in zip(cpu[3], card[3])]
        flat = cand.reshape(B, R * ck)
        cand_xyz = torch.gather(xyz, 1, flat[..., None].expand(B, R * ck, 3)).reshape(B * R, ck, 3)
        return scales, cand, cand_xyz, torch.gather(xyz_mask, 1, flat).reshape(B * R, ck)

    group_ops.multi_ball_query = recorded if record else replayed
    group_ops.multi_ball_query_grouped_cand = recorded_g if record else replayed_g
    try:
        yield
    finally:
        group_ops.multi_ball_query = orig
        group_ops.multi_ball_query_grouped_cand = orig_g


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


# K3's per-tap compaction of the map: two kernels a call
K3_PAIR_KERNELS = ("pair_count_kernel", "pair_scatter_kernel")


def k3_kernels(feats, g, nbr) -> tuple:
    """The kernels of one K3 contraction: the bf16 tensor-core body or the
    f32 one, then the ordered reduction of the partials when the pair
    lists are cut into more than one chunk."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    K, M = nbr.shape
    body = "dw_mma_kernel" if feats.dtype == torch.bfloat16 else "dw_f32_kernel"
    n_chunks, _ = cuda_conv.dw_chunks(M, K, feats.shape[1], g.shape[1])
    return (body, "dw_reduce_kernel") if n_chunks > 1 else (body,)


def k3_bound(feats, g, nbr):
    """(bytes, flops, bound seconds, bound_by) of K3 over the map `nbr`:
    what this run's data needs. The input rows some tap matched, the rows
    of g with a match, the map, each read once, and dW written once; 2 *
    Cin * Cout flops per match at the bf16 tensor-core rate, the rate of
    the TPU kernel it replaces (bf16 x bf16 products of the rows and of g,
    f32 accumulation), as K1's bound."""
    found = nbr >= 0
    matches = int(found.sum())
    rows_read = int(nbr[found].unique().numel())
    g_rows = int(found.any(dim=0).sum())
    cin, cout = feats.shape[1], g.shape[1]
    K, M = nbr.shape
    nbytes = (rows_read * cin * feats.element_size() + g_rows * cout * 4 + K * M * 4
              + K * cin * cout * 4)
    flops = 2.0 * cin * cout * matches
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    return nbytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k3_case(name, call):
    """Compare / time K3 (the sparse-conv weight gradient) on one captured
    call (args, kwargs) of a train step's backward, over the forward's map
    it was given: against its plain version (the same bf16 rounding of the
    rows and of g) to rtol 1e-3 / atol 1e-4 of the plain output's max, and
    bit for bit on a repeat. The compaction (`tap_pairs`) is checked
    against its plain version and timed apart. Returns the entries of the
    contraction and of the compaction."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    args, kw = call
    nbr = kw["nbr"]
    feats, keys, coords, g, shape, bsz, ksize, stride, pad = args
    feats = feats.detach()
    args = (feats, keys, coords, g, shape, bsz, ksize, stride, pad)

    def kern():
        return cuda_conv.sparse_conv_dw(*args, nbr=nbr)

    out, again = kern(), kern()
    ref = cuda_conv.sparse_conv_dw_plain(*args, nbr=nbr)
    pairs, counts = cuda_conv.tap_pairs(nbr)
    pref, cref = cuda_conv.tap_pairs_plain(nbr)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"K3 {name}: two runs differ"
    assert torch.equal(counts, cref) and all(
        torch.equal(pairs[k, :n], pref[k, :n]) for k, n in enumerate(cref.tolist())), (
        f"K3 {name}: compaction and its plain version differ")
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-4 * scale,
                               msg=lambda m: f"K3 {name}: {m}")
    nbytes, flops, bound_s, bound_by = k3_bound(feats, g, nbr)
    K, M = nbr.shape
    matches = int(counts.sum())
    pair_bytes = K * M * 4 + matches * 8 + K * 4
    ms = cuda_ms(kern, reps=10)
    kernel_ms = device_ms(kern, k3_kernels(feats, g, nbr))
    pair_ms = device_ms(lambda: cuda_conv.tap_pairs(nbr), K3_PAIR_KERNELS)
    plain_ms = cuda_ms(lambda: cuda_conv.sparse_conv_dw_plain(*args, nbr=nbr), reps=3, warmup=1)
    pair_plain_ms = cuda_ms(lambda: cuda_conv.tap_pairs_plain(nbr), reps=3, warmup=1)
    n_chunks, rows = cuda_conv.dw_chunks(M, K, feats.shape[1], g.shape[1])
    N, cin = feats.shape
    cout = g.shape[1]
    log(f"K3 {name}: N={N} M={M} Cin={cin} Cout={cout} kernel={ksize} stride={stride} "
        f"{feats.dtype} matches={matches} chunks={n_chunks}x{rows} bytes={nbytes} "
        f"flops={flops:.0f} max_abs_err={err:.3e} (plain max {scale:.3e}, bitwise repeatable) "
        f"ms={ms:.4f} (kernel alone, profiler: contraction {kernel_ms:.4f} + compaction "
        f"{pair_ms:.4f}, compaction share {pair_ms / (kernel_ms + pair_ms):.3f}; "
        f"{flops / ((kernel_ms + pair_ms) * 1e-3) / 1e12:.1f} TFLOP/s) plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_s * 1e3:.4f}; compaction bitwise equal, plain_ms={pair_plain_ms:.4f} "
        f"bound_ms={pair_bytes / HBM_BYTES_PER_S * 1e3:.4f}")
    dw = {"name": f"sparse_conv_dw:{name}", "route": "cuda",
          "source": "btcdet_tpu_torch/csrc/sparse_conv_dw.cu",
          "replaces": "btcdet_tpu/ops/pallas_conv.py:392", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
          "library_ms": None}
    pair = {"name": f"tap_pairs:{name}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_conv_dw.cu",
            "replaces": "btcdet_tpu/ops/pallas_conv.py:392", "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: cuda_conv.tap_pairs(nbr), reps=10),
            "plain_ms": pair_plain_ms, "bound_ms": pair_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}
    return [dw, pair]


def k3_step_table(dw_calls):
    """Every K3 launch of one train step, from its captured calls: the
    contraction and the compaction kernel alone (profiler, mean of 5 runs
    each) beside the bound, and their sums."""
    from btcdet_tpu_torch.ops import cuda_conv

    log(f"K3 train-step launches ({len(dw_calls)}; kernel alone from the profiler, mean of 5 "
        "runs each):")
    tot = tot_pairs = 0.0
    for i, (a, kw) in enumerate(dw_calls):
        feats, g, nbr = a[0].detach(), a[3], kw["nbr"]
        K, M = nbr.shape
        n_chunks, _ = cuda_conv.dw_chunks(M, K, feats.shape[1], g.shape[1])
        t = device_ms(lambda: cuda_conv.sparse_conv_dw(feats, *a[1:9], nbr=nbr),
                      k3_kernels(feats, g, nbr), reps=5)
        tp = device_ms(lambda: cuda_conv.tap_pairs(nbr), K3_PAIR_KERNELS, reps=5)
        _, flops, bound_s, by = k3_bound(feats, g, nbr)
        tot, tot_pairs = tot + t, tot_pairs + tp
        log(f"  #{i:2d} N,Cin={tuple(feats.shape)} M={M} Cout={g.shape[1]} kernel={a[6]} "
            f"stride={a[7]} matches={int((nbr >= 0).sum())} chunks={n_chunks} ms={t:.4f} "
            f"compaction_ms={tp:.4f} bound_ms={bound_s * 1e3:.4f} ({by}) "
            f"TFLOP/s={flops / ((t + tp) * 1e-3) / 1e12:.1f}")
    log(f"K3 train step: {len(dw_calls)} launches {tot + tot_pairs:.4f} ms of kernel in all "
        f"(contraction {tot:.4f}, compaction {tot_pairs:.4f})")


def train_setup(cfg, num_points: int, num_gt: int, seed: int, device="cuda",
                batch_size: int = 2, bev_sharding: bool = False, proj_seed=None):
    """A flagship-layout net of `cfg`'s CLASS_NAMES in train mode with
    synthetic weights (`bev_sharding` as `build_network`'s), its dual
    optimizer and a `mode="train"` synthetic batch of `batch_size` frames
    (its gt boxes `relabel`led over the classes where there are
    several). With `proj_seed` the output projections' random weights
    (the RPN box conv's and ConvHead's final cls and reg convs') are drawn
    again by their law, N(0, 0.001^2), from a generator of that seed."""
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import trainer

    torch.manual_seed(seed)
    classes = list(cfg.get("CLASS_NAMES", ["Car"]))
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, classes, device=device,
                        bev_sharding=bev_sharding)
    # synthetic weights by name, but the output projections keep the
    # model's own init (the JAX package's: cls prior bias, std-0.001 box
    # and rcnn weights); synthetic box weights decode to boxes of up to
    # 1e22 m whose exp overflows once training moves them
    own, sd = net.state_dict(), weights.synth_state_dict(net)
    head = net.det_modules.roi_head
    finals = [f"det_modules.roi_head.{t}.{len(list(getattr(head, t).children())) - 1}"
              for t in ("cls_layers", "reg_layers")]
    drawn = ("det_modules.dense_head.conv_box.weight", *(f + ".weight" for f in finals))
    for k in ("det_modules.dense_head.conv_cls.bias", *drawn, *(f + ".bias" for f in finals)):
        sd[k] = own[k].cpu()
    if proj_seed is not None:
        g = torch.Generator().manual_seed(proj_seed)
        for k in drawn:
            sd[k] = torch.randn(own[k].shape, generator=g) * 0.001
    net.load_state_dict(sd)
    net.train()
    opt = trainer.create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, 1000)
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=batch_size, num_points=num_points,
                                 num_gt=num_gt, seed=seed, mode="train", device=device)
    if len(classes) > 1:
        batch = relabel(batch, len(classes))
    return net, opt, batch


def train_phase():
    """The flagship training step at full width (B=2, train caps): kernel
    checks on a captured step, one counted step, 10 timed steps."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES
    from btcdet_tpu_torch.train import trainer

    cfg = config.flagship()
    net, opt, batch = train_setup(cfg, 16384, 10, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = capture_kernel_inputs(lambda: trainer.train_step(net, opt, batch, gen))
    torch.cuda.synchronize()
    log("train capture: " + ", ".join(f"{len(v)} {k} calls" for k, v in calls.items())
        + " per step")

    def pick_dw(kernel, stride, cin, cout):
        return next((a, kw) for a, kw in calls["sparse_conv_dw"]
                    if a[6] == kernel and a[7] == stride and a[0].shape[1] == cin
                    and a[3].shape[1] == cout)

    picks = {"conv1(subm 6->16)": pick_dw((3, 3, 3), (1, 1, 1), 6, 16),
             "conv2(3^3 s2 16->32)": pick_dw((3, 3, 3), (2, 2, 2), 16, 32),
             "conv2_combine_0(subm 34->32)": pick_dw((3, 3, 3), (1, 1, 1), 34, 32),
             "conv_out(3x1x1 s2 64->128)": pick_dw((3, 1, 1), (2, 1, 1), 64, 128),
             "down_combine_0(subm 256->128)": pick_dw((3, 3, 3), (1, 1, 1), 256, 128)}
    entries = [e for name, call in picks.items() for e in k3_case(name, call)]
    k3_step_table(calls["sparse_conv_dw"])
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
    entries.append(k2_case(calls["sparse_pool"][0], "train"))
    entries.append(k4_case(calls["trilinear_pool"][0][0], "train"))
    assert len(calls["trilinear_pool_grad"]) == 1, len(calls["trilinear_pool_grad"])
    entries.append(k4_grad_case(calls["trilinear_pool_grad"][0][0], "train"))
    entries.append(k4_grad_case(k4_grad_hot_args(), "hot"))
    del calls, picks, df, fwd

    params = {n: p.detach().clone() for n, p in net.named_parameters()}
    stats = {n: b.clone() for n, b in net.named_buffers() if n.endswith("running_var")}
    reset_launches()
    metrics = trainer.train_step(net, opt, batch, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"train-step launches: {json.dumps(launches)}")
    assert launches == TRAIN_LAUNCHES, (launches, TRAIN_LAUNCHES)
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
    gradient_repeat(net, batch)

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
    stages = synced_stage_ms(lambda: trainer.train_step(net, opt, batch, gen))
    log("train stage ms (synchronised, forward only): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    profile_step(lambda: trainer.train_step(net, opt, batch, gen), STAGES, "train step")
    return entries


# tensor groups of the gradient-repeat count, by state-dict prefix
GRAD_GROUPS = ("occ_modules.", "det_modules.backbone_3d.", "det_modules.backbone_2d.",
               "det_modules.dense_head.", "det_modules.roi_head.")


def gradient_repeat(net, batch, label: str = "synthetic batch"):
    """One train forward + backward (`trainer.forward_backward`, the train
    step's) twice from the same parameters, batch and generator seed
    (train-mode BN reads the batch's statistics, so the
    running statistics the first pass moves do not enter the second):
    prints, per tensor group, how many gradient elements differ between
    the two and by how much, and fails unless none does (no kernel or op of
    the step adds floats in a varying order)."""
    import torch

    from btcdet_tpu_torch.train import trainer

    def grads():
        trainer.forward_backward(net, batch, torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in net.named_parameters()
                if p.grad is not None}

    g1, g2 = grads(), grads()
    for p in net.parameters():
        p.grad = None
    rows = {}
    for group in GRAD_GROUPS:
        names = [n for n in g1 if n.startswith(group)]
        diff = [int((g1[n] != g2[n]).sum()) for n in names]
        worst = max((float((g1[n] - g2[n]).abs().max()) for n in names), default=0.0)
        rows[group.rstrip(".")] = {"tensors": len(names),
                                   "elements": sum(g1[n].numel() for n in names),
                                   "differ": sum(diff), "tensors_differ": sum(d > 0 for d in diff),
                                   "max_abs_diff": worst}
    log(f"train gradient repeat ({label}; same state, batch and generator, twice): "
        + json.dumps(rows))
    assert all(r["differ"] == 0 for r in rows.values()), rows


def eval_cli_phase(card: str):
    """The evaluation entry point end to end: a synthetic KITTI tree (16
    frames, 8 in val, about 20 000 background points a frame, so a
    front-view frame holds about a KITTI FOV cloud), infos by the port's
    `kitti_infos`, synthetic weights saved as a reference-format `.pth`,
    then `tools/test_torch.py` in process on the flagship yaml at full
    widths and test caps (B=2, 2 loader workers). Asserts every val frame
    evaluated with finite AP keys, the kernels' launches per forward as on
    the main path, and the first loader batch's detections equal to a
    forward + post-processing of the same batch, bit for bit; prints the
    loop's frames per second and wall ms by part (with 2 loader workers and
    with none), the host pipeline's ms a frame and the device's idle share
    over a profiled run of the loop."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets.kitti import kitti_infos
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, to_device
    from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing
    from btcdet_tpu_torch.train import eval_utils

    t_phase = time.perf_counter()
    cli = load_tool("test_torch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        frames = make_raw_kitti(root, n_frames=16, n_train=8, seed=0, n_background=20000)
        val_ids = frames[8:]
        kitti_infos.create_kitti_infos(root, workers=4)
        cfg = config.flagship()
        cfg.DATA_CONFIG.DATA_PATH = str(root)
        net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"])
        pth = tmp / "reference.pth"
        torch.save({"model_state": weights.synth_state_dict(net), "epoch": 0, "it": 0}, pth)
        del net

        # the host pipeline alone: __getitem__, then collate, per frame
        ds = KittiDataset(cfg.DATA_CONFIG, ["Car"], training=False)
        t0 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        t_get = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for i in range(0, len(items), 2):
            ds.collate_batch(items[i:i + 2])
        t_col = (time.perf_counter() - t0) * 1e3
        n_pts = [len(d["points"]) for d in items]
        log(f"[{card}] eval CLI host pipeline: {(t_get + t_col) / len(items):.2f} ms a frame "
            f"(__getitem__ {t_get / len(items):.2f}, collate {t_col / len(items):.2f}; points a "
            f"frame after FOV and range {min(n_pts)}-{max(n_pts)}, collate cap {ds.max_points})")
        del ds, items

        seen, first = {}, {}
        build_eval = cli.build_eval

        def keep_net(*a, **kw):
            built = build_eval(*a, **kw)
            seen["net"] = built[0]
            return built

        arrivals = []

        def keep_first(batch_idx, batch, outputs):
            arrivals.append(time.perf_counter())
            if batch_idx == 0:
                first.update(batch=batch, outputs=outputs)

        cli.build_eval = keep_net
        def argv(workers: int = 2):
            return ["--cfg_file", str(config.FLAGSHIP_CFG), "--ckpt", str(pth), "--batch_size",
                    "2", "--workers", str(workers), "--output_dir", str(tmp / "out"),
                    "--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False", "DATA_CONFIG.DATA_PATH",
                    str(root)]

        reset_launches()
        t0 = time.perf_counter()
        (run,) = cli.main(argv(), on_batch=keep_first)
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"[{card}] eval CLI batches done at ms (from main()'s start): "
            f"{[round((t - t0) * 1e3, 2) for t in arrivals]}")
        _, _, result, annos = run
        forwards = len(val_ids) // 2
        log(f"[{card}] eval CLI launches over {forwards} forwards: {json.dumps(launches)}")
        assert launches == {k: v * forwards for k, v in EVAL_LAUNCHES.items()}, launches
        assert [a["frame_id"] for a in annos] == val_ids, [a["frame_id"] for a in annos]
        ap = {k: float(v) for k, v in result.items() if k.startswith("Car_")}
        assert len(ap) >= 18 and all(math.isfinite(v) for v in ap.values()), ap
        log(f"[{card}] eval CLI: {len(annos)} frames, detections a frame "
            f"{[len(a['name']) for a in annos]}, loop {result['frames_per_sec']:.3f} frames/s "
            f"(B=2, 2 loader workers, profiler off), Car_3d/moderate_R40 "
            f"{ap['Car_3d/moderate_R40']:.4f}, occ_precision@0.5 "
            f"{result.get('occ_precision@0.5', float('nan')):.4f}; loop wall ms by part "
            + json.dumps({k: round(v, 2) for k, v in result["time_ms"].items()}))

        # the first loader batch again, straight through the same net
        net = seen["net"]
        out = net(to_device(first["batch"], "cuda"))
        again = eval_utils.to_host(post_processing(out, cfg.MODEL.POST_PROCESSING, 1))
        for k in ("pred_boxes", "pred_scores", "pred_labels", "pred_valid"):
            assert np.array_equal(again[k], first["outputs"][k]), k
        log(f"[{card}] eval CLI first batch: detections of net(to_device(batch)) + "
            f"post_processing equal the loop's bit for bit "
            f"({int(again['pred_valid'].sum())} boxes)")
        del net, out, seen["net"]

        # the same loop with the loader in the main process (no worker fork)
        (run0,) = cli.main(argv(workers=0))
        log(f"[{card}] eval CLI with 0 loader workers: loop {run0[2]['frames_per_sec']:.3f} "
            f"frames/s; loop wall ms by part "
            + json.dumps({k: round(v, 2) for k, v in run0[2]["time_ms"].items()}))

        # a second run of the loop under the profiler: the device's idle share
        eval_ckpt = cli.eval_ckpt
        prof_box = {}

        def profiled(*a, **kw):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = eval_ckpt(*a, **kw)
                torch.cuda.synchronize()
                prof_box["wall"] = (time.perf_counter() - t0) * 1e3
            prof_box["prof"] = prof
            return res

        cli.eval_ckpt = profiled
        cli.main(argv())
        busy = sum(t for _, t in kernel_times(prof_box["prof"], STAGES).values())
        wall = prof_box["wall"]
        log(f"[{card}] eval CLI loop under the profiler: wall {wall:.2f} ms for {len(val_ids)} "
            f"frames, kernel time {busy:.2f} ms, device idle share {idle_share(busy, wall)}")
        # the seventh path's eval CLI under torchrun, on this tree
        dp_eval_cli(card, root, pth, tmp, annos, result)
    log(f"[{card}] eval CLI phase: {time.perf_counter() - t_phase:.1f} s")


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
                                         "trilinear_pool", "trilinear_pool_grad")), launches
    assert launches["tap_pairs"] == launches["sparse_conv_dw"], launches
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


def train_cli_phase(card: str):
    """The training entry point end to end (see the module docstring, 8.)."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import bestmatch
    from btcdet_tpu_torch.datasets.kitti import kitti_infos
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, to_device
    from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
    from btcdet_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    cli = load_tool("train_torch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        cars = 2
        make_raw_kitti(root, n_frames=12, n_train=8, seed=0, cars_per_frame=cars,
                       n_background=20000)
        t0 = time.perf_counter()
        kitti_infos.create_kitti_infos(root, workers=4)
        bestmatch.create_best_match_db(root, class_names=("Car",), splits=("train",))
        log(f"[{card}] train CLI databases (infos, gt database, best-match database): "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = config.flagship()
        cfg.DATA_CONFIG.DATA_PATH = str(root)

        # the host pipeline of a train frame, by part, in this process
        ds = KittiDataset(cfg.DATA_CONFIG, ["Car"], training=True)
        part_ms = dict.fromkeys(("augmentor", "processor"), 0.0)

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                r = fn(*a, **kw)
                part_ms[name] += (time.perf_counter() - t) * 1e3
                return r
            return run

        ds.data_augmentor.forward = timed("augmentor", ds.data_augmentor.forward)
        ds.data_processor.forward = timed("processor", ds.data_processor.forward)
        t0 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        t_get = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for i in range(0, len(items), 2):
            ds.collate_batch(items[i:i + 2])
        t_col = (time.perf_counter() - t0) * 1e3
        n = len(items)
        pasted = [int((np.abs(d["gt_boxes"][:, 3:6]).sum(1) > 0).sum()) - cars for d in items]
        log(f"[{card}] train host pipeline: {(t_get + t_col) / n:.2f} ms a frame (__getitem__ "
            f"{t_get / n:.2f}: augmentor {part_ms['augmentor'] / n:.2f}, processors "
            f"{part_ms['processor'] / n:.2f}; collate {t_col / n:.2f}); points a frame "
            f"{[len(d['points']) for d in items]}, gt boxes pasted a frame {pasted}, best-match "
            f"points a frame {[len(d['bm_points']) for d in items]}")
        # the gradient repeat on a training batch of the tree (pasted boxes,
        # dense best-match points: several points a voxel in the occ targets)
        net, _, _ = train_setup(cfg, 16384, 10, 0)
        gradient_repeat(net, to_device(ds.collate_batch(items[:2]), "cuda"),
                        "a training batch of the KITTI tree")
        del ds, items, net

        step_log = []

        def on_step(gstep, batch, metrics):
            launches = read_launches()
            reset_launches()
            vals = {k: float(v) for k, v in metrics.items()}
            gt = (np.abs(batch["gt_boxes"][..., 3:6]).sum(-1) > 0).sum(1)
            step_log.append((gstep, launches, vals["loss"], gt.tolist(),
                             batch["bm_points_mask"].sum(1).tolist()))
            assert launches == TRAIN_LAUNCHES, (gstep, launches)
            assert all(math.isfinite(v) for v in vals.values()), (gstep, vals)
            assert batch["bm_points_mask"].any(1).all(), gstep

        def argv(out, *extra):
            return ["--cfg_file", str(config.FLAGSHIP_CFG), "--batch_size", "2", "--workers",
                    "2", "--epochs", "2", "--steps", "4", "--output_dir", str(out), *extra,
                    "--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False", "DATA_CONFIG.DATA_PATH",
                    str(root)]

        out = tmp / "resumed"
        reset_launches()
        cut = cli.main(argv(out, "--num_epochs_to_eval", "0"), on_step=on_step,
                       on_epoch_end=lambda epoch, step: True)
        assert cut["stopped"] and cut["steps_run"] == 4, cut
        assert checkpoint.CheckpointManager(out / "ckpt").all_steps() == [4]
        reset_launches()
        res = cli.main(argv(out, "--num_epochs_to_eval", "1"), on_step=on_step)
        torch.cuda.synchronize()
        eval_launches = read_launches()
        assert res["start_step"] == 4 and res["steps_run"] == 4, res["start_step"]
        assert [s for s, *_ in step_log] == list(range(8)), [s for s, *_ in step_log]
        assert max(max(g) for _, _, _, g, _ in step_log) > cars, "no gt box pasted"
        log(f"[{card}] train CLI steps (global step, loss, gt boxes a frame, best-match points "
            f"a frame): " + json.dumps([(s, round(l, 5), g, b) for s, _, l, g, b in step_log]))
        log(f"[{card}] train CLI: every step launched TRAIN_LAUNCHES; cut after step 4, "
            f"auto-resumed at step {res['start_step']}")
        (eval_step, result), = res["eval"]
        val_forwards = 2
        assert eval_step == 8 and eval_launches == {
            k: v * val_forwards for k, v in EVAL_LAUNCHES.items()}, (eval_step, eval_launches)
        ap = {k: float(v) for k, v in result.items() if k.startswith("Car_")}
        assert len(ap) >= 18 and all(math.isfinite(v) for v in ap.values()), ap
        log(f"[{card}] train CLI trailing eval of step {eval_step}: {len(ap)} finite AP keys, "
            f"Car_3d/moderate_R40 {ap['Car_3d/moderate_R40']:.4f}, launches over "
            f"{val_forwards} forwards {json.dumps(eval_launches)}")

        # the same 8 steps in one call, steps 5-8 under the profiler
        step_log.clear()
        reset_launches()
        straight = cli.main(argv(tmp / "straight", "--num_epochs_to_eval", "0",
                                 "--profile_steps", "4-8"), on_step=on_step)
        for name, r in (("resumed (second call)", res), ("cut (first call)", cut),
                        ("straight", straight)):
            wall = sum(r["time_ms"].values())
            log(f"[{card}] train CLI loop, {name}: {r['steps_run']} steps, "
                f"{r['steps_run'] / wall * 1e3:.3f} steps/s, wall ms by part "
                + json.dumps({k: round(v, 2) for k, v in r["time_ms"].items()}))
        prof, wall = straight["profile"]
        busy = sum(t for _, t in kernel_times(prof).values())
        log(f"[{card}] train CLI steps 5-8 under the profiler: wall {wall:.2f} ms, kernel time "
            f"{busy:.2f} ms, device idle share {idle_share(busy, wall)}")
        a = checkpoint.load_file(checkpoint.CheckpointManager(out / "ckpt").path(8))
        b = checkpoint.load_file(checkpoint.CheckpointManager(tmp / "straight" / "ckpt").path(8))
        diffs = {}
        for part in ("model_state", "optimizer_state"):
            flat_a, flat_b = flatten_tensors(a[part]), flatten_tensors(b[part])
            assert flat_a.keys() == flat_b.keys(), part
            n_diff = sum(int((flat_a[k] != flat_b[k]).sum()) for k in flat_a)
            worst = max(float((flat_a[k].double() - flat_b[k].double()).abs().max())
                        for k in flat_a if flat_a[k].numel())
            diffs[part] = {"tensors": len(flat_a), "elements_differ": n_diff,
                           "max_abs_diff": worst}
        log(f"[{card}] train CLI resumed (4 + 4 steps) against straight (8 steps), step-8 "
            f"checkpoints: " + json.dumps(diffs))
        # the seventh path's train CLI under torchrun, on this tree
        dp_train_cli(card, root, tmp)
    log(f"[{card}] train CLI phase: {time.perf_counter() - t_phase:.1f} s")


def flatten_tensors(tree, prefix="") -> dict:
    """{path: tensor} of a nested dict's tensors."""
    import torch

    if torch.is_tensor(tree):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tensors(v, f"{prefix}.{k}"))
    return out


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


# ------------------------------------------ eighth path: occupancy options

# the occupancy options of the eighth path: name -> {config path: value}
# set on the flagship config (MODEL.OCC / DATA_CONFIG.OCC only)
OCC_OPTIONS = {
    "pillar_2d": {"MODEL.OCC.TARGETS.NAME": "OccTargetsPillar",
                  "MODEL.OCC.OCC_DENSE_HEAD.NAME": "OccHead2D"},
    "deconv_res": {"MODEL.OCC.BACKBONE_3D.NAME": "VoxelBackBoneDeconvRes"},
    "inverse_res": {"MODEL.OCC.BACKBONE_3D.NAME": "VoxelBackBoneInverseRes"},
    "back_track": {"DATA_CONFIG.OCC.REVERSE_VIS": "BACK_TRACK"},
    "vcc": {"DATA_CONFIG.OCC.REVERSE_VIS": "VCC"},
    "absxyz_original": {"DATA_CONFIG.OCC.USE_ABSXYZ": "original"},
    "absxyz_both": {"DATA_CONFIG.OCC.USE_ABSXYZ": "both"},
    # DB_PROJ's candidates make many new det rows: the merged table's headroom
    # is set for them (K // 4 without it)
    "db_proj": {"MODEL.OCC.OCC_PNT_UPDATE.DB_PROJ": True,
                "MODEL.OCC.OCC_PNT_UPDATE.MERGED_CAP_EXTRA": 80000},
    "sigmoid_pillar_2d": {"MODEL.OCC.OCC_DENSE_HEAD.LOSS_CONFIG.CLS_LOSS_TYPE": "sigmoid",
                          "MODEL.OCC.TARGETS.NAME": "OccTargetsPillar",
                          "MODEL.OCC.OCC_DENSE_HEAD.NAME": "OccHead2D"},
}
EVAL_OPTIONS = ("pillar_2d", "deconv_res", "inverse_res", "back_track", "vcc", "absxyz_original",
                "absxyz_both", "db_proj")
# train step A: the flagship with the occ train options
PASS_GRAD_OPTIONS = {"MODEL.OCC.OCC_PNT_UPDATE.PASS_GRAD": True,
                     "DATA_CONFIG.OCC.DROPOUT_RATE": 0.2, "DATA_CONFIG.OCC.REAL_DROP": None,
                     "MODEL.OCC.PARAMS.REMAIN_PERCENTAGE": [0.5, 1.0]}
# a PASS_GRAD step adds to TRAIN_LAUNCHES: K2 max's backward and the
# transpose-query map it reads, and K1's df of conv1 (its input, the merged
# det voxel features, now needs a gradient; the subm df reads the forward's
# map)
PASS_GRAD_LAUNCHES = dict(TRAIN_LAUNCHES, neighbor_map=TRAIN_LAUNCHES["neighbor_map"] + 1,
                          sparse_conv_df=TRAIN_LAUNCHES["sparse_conv_df"] + 1,
                          sparse_pool_grad=1)


def set_options(cfg, edits: dict):
    """Set each `A.B.C` path of `edits` in the config tree (None deletes)."""
    for path, value in edits.items():
        *head, last = path.split(".")
        node = cfg
        for k in head:
            node = node[k]
        if value is None:
            node.pop(last, None)
        else:
            node[last] = value
    return cfg


def occ_subnet_for(cfg, device="cuda"):
    """The occ subnet of `cfg` (its MODEL.OCC and DATA_CONFIG), with
    synthetic weights by its `occ_modules.*` names, in eval mode."""
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models.occ.occ_subnet import OccSubnet

    d = cfg.DATA_CONFIG
    det_vs = next(p.VOXEL_SIZE for p in d.DATA_PROCESSOR
                  if p.NAME == "det_transform_points_to_voxels")
    sub = OccSubnet(cfg.MODEL.OCC, d, d.POINT_CLOUD_RANGE, det_vs, 4).to(device)
    sub.load_state_dict({k: torch.from_numpy(weights.synth_tensor(f"occ_modules.{k}", v.shape))
                         for k, v in sub.state_dict().items()})
    return sub.eval()


def merged_rows(net, batch, run):
    """run() with a hook on the det backbone: (its result, merged det voxel
    rows per frame)."""
    seen = {}
    hook = net.det_modules.backbone_3d.register_forward_pre_hook(
        lambda mod, args: seen.update(st=args[0]))
    try:
        res = run()
    finally:
        hook.remove()
    c = seen["st"].coords
    return res, [int((c[:, 0] == b).sum()) for b in range(int(batch["points"].shape[0]))]


def occ_options_eval():
    """The eighth path's eval forwards: the full flagship at B=2 with each
    of EVAL_OPTIONS in its occ subnet (the det modules and weights are the
    main path's): launches a forward equal to EVAL_LAUNCHES, finite outputs,
    occ points and merged det rows per frame; the median forward + post of
    the two residual backbones and DB_PROJ."""
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    base = config.flagship()
    net = build_network(base.MODEL, base.DATA_CONFIG, ["Car"])
    net.load_state_dict(weights.synth_state_dict(net))
    batch = make_synthetic_batch(base.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                 seed=0, mode="test")
    det_rows = [int((batch["det_voxel_coords"][:, 0] == b).sum()) for b in range(2)]
    for option in EVAL_OPTIONS:
        cfg = set_options(config.flagship(), OCC_OPTIONS[option])
        net.occ_modules = occ_subnet_for(cfg)

        def run():
            o = net(batch)
            return o, post_processing(o, cfg.MODEL.POST_PROCESSING, 1)
        reset_launches()
        (out, post), rows = merged_rows(net, batch, run)
        torch.cuda.synchronize()
        launches = read_launches()
        assert launches == EVAL_LAUNCHES, (option, launches, EVAL_LAUNCHES)
        n_det = check_eval_outputs(net, batch, out, post)
        n_occ = [int(v) for v in out["occ_points_mask"].sum(dim=1)]
        assert min(n_occ) > 0 and all(m > d for m, d in zip(rows, det_rows)), (option, n_occ, rows)
        extra = cfg.MODEL.OCC.OCC_PNT_UPDATE.get("MERGED_CAP_EXTRA")
        log(f"occ option {option!r} eval (B=2): launches = EVAL_LAUNCHES; occ points per frame "
            f"{n_occ}; merged det rows per frame {rows} (det {det_rows}, new "
            f"{[m - d for m, d in zip(rows, det_rows)]}"
            + (f" of at most {extra}" if extra else "") + f"); detections per frame {n_det}")
        if option in ("deconv_res", "inverse_res", "db_proj"):
            med, times = timed_median(lambda: forward_post(net, batch, cfg))
            log(f"forward+post ms, occ option {option!r} (B=2, 5 runs after 2 warm-ups): median "
                f"{med:.2f} all {[round(t, 2) for t in times]}; occ_subnet stage ms "
                f"{stage_times(net, batch, cfg.MODEL.POST_PROCESSING)['occ_subnet']}")
        del out, post
    del net, batch


def occ_option_small_check(option: str):
    """The occ subnet of `small_config(full=True)` with `option`, f32 on the
    card against f32 on the CPU, same synthetic weights and batch:
    probabilities to 1e-3, occ point sets to 1e-3, merged det voxel sets
    equal. Under DB_PROJ the candidates whose centre lies on a det or occ
    cell edge to float32 rounding land on either side (the card's and the
    CPU's atan2 differ in their last bits), so there the sets must agree
    but for 1 % of the rows; the count is printed."""
    import torch

    from btcdet_tpu_torch.datasets import make_synthetic_batch

    cfg = set_options(small_config(full=True), OCC_OPTIONS[option])
    outs = {}
    with f32_everywhere():
        batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=4096, num_gt=4,
                                     seed=3, mode="test", device="cpu")
        for dev in ("cuda", "cpu"):
            o = occ_subnet_for(cfg, dev)({k: v.to(dev) for k, v in batch.items()})
            outs[dev] = {k: v.cpu() for k, v in o.items() if torch.is_tensor(v)}
    g, c = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(g["probs"], c["probs"], rtol=1e-3, atol=1e-3)
    worst = same_point_sets(g["occ_points"], g["occ_points_mask"], c["occ_points"],
                            c["occ_points_mask"], 1e-3)
    sets = {dev: {tuple(r) for r in o["det_voxel_coords"][o["det_voxel_coords"][:, 0] >= 0]
                  .tolist()} for dev, o in outs.items()}
    differ = len(sets["cuda"] ^ sets["cpu"])
    assert differ <= (0.01 * len(sets["cpu"]) if option == "db_proj" else 0), (option, differ)
    log(f"occ option {option!r}, small config (cuda f32 vs cpu f32): probs max abs diff "
        f"{float((g['probs'] - c['probs']).abs().max()):.3e}, occ points as sets {worst:.2e} "
        f"({[int(v) for v in g['occ_points_mask'].sum(1)]} a frame), merged det voxels "
        f"{len(sets['cuda'])} ({differ} differ)")


def k2_grad_case(call, mode: str, label: str):
    """K2's backward on a captured call (max: features, out, g, nbr, tnbr;
    sum: g, tnbr) against its plain version, bit for bit and bit for bit on
    a repeat, kernel-alone and plain ms, and the bound: the bytes of g,
    the rows the maps match, both maps (max) or the transpose-query map
    (sum), and df, at HBM3's rate."""
    import torch

    from btcdet_tpu_torch.ops import cuda_pool

    args, _ = call
    if mode == "max":
        kern, plain, kname = (cuda_pool.sparse_pool_grad, cuda_pool.sparse_pool_grad_plain,
                              ("sparse_maxpool_share_kernel", "sparse_maxpool_bwd_kernel"))
        feats, out, g, nbr, tnbr = args
        N, C = feats.shape
        nbytes = (g.numel() + out.numel() + feats.numel() + nbr.numel() + tnbr.numel()
                  + N * C) * 4
    else:
        kern, plain, kname = (cuda_pool.sparse_sum_pool_grad,
                              cuda_pool.sparse_sum_pool_grad_plain, "sparse_pool_kernel")
        g, tnbr = args
        N, C = tnbr.shape[1], g.shape[1]
        found = tnbr >= 0
        rows = int(tnbr[found].unique().numel())
        nbytes = (rows * C + tnbr.numel() + N * C) * 4
    df = kern(*args)
    ref = plain(*args)
    again = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(df, ref), f"K2 {mode} bwd {label}: kernel and plain version differ"
    assert torch.equal(df, again), f"K2 {mode} bwd {label}: the kernel does not repeat"
    bound_s = nbytes / HBM_BYTES_PER_S
    ms = device_ms(lambda: kern(*args), kname)
    parts = ({name: round(device_ms(lambda: kern(*args), name), 4) for name in kname}
             if isinstance(kname, tuple) else {})
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    log(f"K2 {mode} bwd {label}: N={N} C={C} taps={tnbr.shape[0]} "
        f"matches={int((tnbr >= 0).sum())} nonzero_df={int((df != 0).sum())} bytes={nbytes} "
        f"(bitwise equal to the plain version and on a repeat) ms={ms:.4f} (kernel alone"
        f"{'; by kernel ' + json.dumps(parts) if parts else ''}) "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_s * 1e3:.4f}")
    name = "sparse_pool_grad" if mode == "max" else "sparse_sum_pool_grad"
    return {"name": f"{name}:{label}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/sparse_pool.cu",
            "replaces": "btcdet_tpu/ops/sparse.py:1025",
            "max_abs_err": float((df - ref).abs().max()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": "bytes", "library_ms": None}


def deterministic_scan(net, batch, label: str):
    """One train forward + backward under
    `torch.use_deterministic_algorithms(True, warn_only=True)`: prints the
    ops that PyTorch flags as not deterministic on the card."""
    import warnings

    import torch

    from btcdet_tpu_torch.train import trainer

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.forward_backward(net, batch, torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).splitlines()[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
    log(f"{label}: ops flagged under use_deterministic_algorithms: {len(flagged)} "
        + json.dumps(flagged))
    for p in net.parameters():
        p.grad = None


def occ_grads(net, batch):
    """The occ subnet's gradients of one train forward + backward (the
    gradient-repeat generator)."""
    import torch

    from btcdet_tpu_torch.train import trainer

    trainer.forward_backward(net, batch, torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    out = {n: p.grad.detach().clone() for n, p in net.named_parameters()
           if n.startswith("occ_modules.backbone_3d.") and p.grad is not None}
    for p in net.parameters():
        p.grad = None
    return out


def pass_grad_train_phase():
    """Train step A: the flagship with PASS_GRAD, DROPOUT_RATE 0.2 (REAL_DROP
    unset, so on) and REMAIN_PERCENTAGE [0.5, 1.0] at the train caps. K2
    max's backward on a captured step; the ops PyTorch flags as not
    deterministic; one counted step (PASS_GRAD_LAUNCHES); the gradient
    repeat; the occ backbone's gradients against the same step without
    PASS_GRAD; 10 timed steps. Returns the kernels line's entries."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    cfg = set_options(config.flagship(), PASS_GRAD_OPTIONS)
    net, opt, batch = train_setup(cfg, 16384, 10, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = capture_kernel_inputs(lambda: trainer.train_step(net, opt, batch, gen))
    assert len(calls["sparse_pool_grad"]) == 1, len(calls["sparse_pool_grad"])
    entries = [k2_grad_case(calls["sparse_pool_grad"][0], "max", "pass_grad")]
    del calls
    deterministic_scan(net, batch, "PASS_GRAD step")
    reset_launches()
    metrics = trainer.train_step(net, opt, batch, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"PASS_GRAD train-step launches: {json.dumps(launches)}")
    assert launches == PASS_GRAD_LAUNCHES, (launches, PASS_GRAD_LAUNCHES)
    for e in entries:
        e["launches"] = launches[e["name"].split(":")[0]]
    vals = {k: float(v) for k, v in metrics.items()}
    log("PASS_GRAD train-step metrics: " + json.dumps({k: round(v, 6) for k, v in vals.items()}))
    assert all(math.isfinite(v) for v in vals.values()), vals
    gradient_repeat(net, batch, "PASS_GRAD, DROPOUT_RATE 0.2, REMAIN_PERCENTAGE")
    on = occ_grads(net, batch)
    net.occ_modules.pass_grad = False
    try:
        off = occ_grads(net, batch)
    finally:
        net.occ_modules.pass_grad = True
    rel = {n: float((on[n] - off[n]).abs().max()) / max(float(off[n].abs().max()), 1e-30)
           for n in on}
    moved = sum(v > 1e-3 for v in rel.values())
    log(f"PASS_GRAD: the occ backbone's gradients against the same step without it: "
        f"{moved} of {len(rel)} tensors differ by more than 1e-3 of their max (largest "
        f"{max(rel.values()):.3e})")
    assert moved > 0, rel
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"train step ms, flagship PASS_GRAD + dropout + remain (B=2, train caps, 10 steps): "
        f"median {statistics.median(times):.2f} all {[round(v, 2) for v in times]}")
    return entries


def pass_grad_fix_phase():
    """Train step B: the `fix` variant with PASS_GRAD: K2 sum's backward on
    its three levels against its plain version, the step's launches
    against the same step without PASS_GRAD (3 more K2 sum backwards and
    their 3 transpose-query maps, conv1's df), 3 timed steps."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    cfg = set_options(config.flagship_occ_variant("fix"),
                      {"MODEL.OCC.OCC_PNT_UPDATE.PASS_GRAD": True})
    net, opt, batch = train_setup(cfg, 16384, 10, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = capture_kernel_inputs(lambda: trainer.train_step(net, opt, batch, gen))
    assert len(calls["sparse_sum_pool_grad"]) == 3, len(calls["sparse_sum_pool_grad"])
    entries = [k2_grad_case(call, "sum", f"fix_l{level}")
               for level, call in enumerate(calls["sparse_sum_pool_grad"], start=1)]
    del calls
    counts = {}
    for on in (False, True):
        net.occ_modules.pass_grad = on
        reset_launches()
        m = trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        counts[on] = read_launches()
        assert all(math.isfinite(float(v)) for v in m.values())
    want = dict(counts[False], neighbor_map=counts[False]["neighbor_map"] + 3,
                sparse_conv_df=counts[False]["sparse_conv_df"] + 1, sparse_sum_pool_grad=3)
    log(f"occ variant 'fix' PASS_GRAD train-step launches: {json.dumps(counts[True])}")
    assert counts[True] == want, (counts, want)
    for e in entries:
        e["launches"] = counts[True]["sparse_sum_pool_grad"]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"train step ms, flagship occ variant 'fix' with PASS_GRAD (B=2, train caps, 3 steps): "
        f"median {statistics.median(times):.2f} all {[round(v, 2) for v in times]}")
    return entries


def occ_options_train():
    """Train step C: one counted step of the flagship at the train caps with
    each of a sigmoid occ loss + OccHead2D + OccTargetsPillar, the two
    residual backbones and DB_PROJ in its occ subnet: finite losses, a
    gradient in every occ parameter, launches equal to TRAIN_LAUNCHES."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    net, _, batch = train_setup(config.flagship(), 16384, 10, 0)
    for option in ("sigmoid_pillar_2d", "deconv_res", "inverse_res", "db_proj"):
        cfg = set_options(config.flagship(), OCC_OPTIONS[option])
        net.occ_modules = occ_subnet_for(cfg).train()
        opt = trainer.create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, 1000)
        reset_launches()
        keep = {"occ_points_mask": None}
        m = trainer.train_step(net, opt, batch, torch.Generator(device="cuda").manual_seed(0),
                               keep=keep)
        torch.cuda.synchronize()
        launches = read_launches()
        vals = {k: round(float(v), 6) for k, v in m.items()}
        assert launches == TRAIN_LAUNCHES, (option, launches)
        assert all(math.isfinite(v) for v in vals.values()), (option, vals)
        assert vals["grad_norm_occ"] > 0, (option, vals)
        log(f"occ option {option!r} train step: launches = TRAIN_LAUNCHES; occ points per frame "
            f"{[int(v) for v in keep['occ_points_mask'].sum(1)]}; loss {vals['loss']} occ_loss "
            f"{vals['occ_loss']} grad_norm_occ {vals['grad_norm_occ']}")


def occ_options_path():
    """The eighth path (module docstring, 8c); returns the K2 backward
    entries of the kernels line."""
    import torch

    t0 = time.perf_counter()
    occ_options_eval()
    for option in EVAL_OPTIONS:
        occ_option_small_check(option)
    entries = pass_grad_train_phase()
    entries += pass_grad_fix_phase()
    occ_options_train()
    torch.cuda.synchronize()
    log(f"eighth path (occupancy options): {time.perf_counter() - t0:.1f} s")
    return entries


# ------------------------------- ninth path: det options and the 3-class config

# the det-side options of the ninth path: name -> edit of the flagship config
def _out_feat(kind):
    return lambda cfg: set_options(cfg, {"MODEL.BACKBONE_3D.OUT_FEAT_TYPE": ["None"] * 4 + [kind]})


def _fractional_upsample(cfg):
    """UPSAMPLE_STRIDES [0.5, 1]: both deblocks at the coarser stride-16 map
    (a 1x1 conv of stride 2, then the stride-1 one), the anchors with it."""
    cfg.MODEL.BACKBONE_2D.UPSAMPLE_STRIDES = [0.5, 1]
    for a in cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
        a["feature_map_stride"] = 16
    return cfg


def _combine(cfg):
    """OUT_FEAT_TYPE `combine` with ConvHead's x_combine sampler at its
    grid's stride: (16, 16, 8) det voxels in x, y, z (spconv5 halves the
    conv4 grid's rows and columns); the yaml's (8, 8, 8) would sample the
    strided volume at twice the distance."""
    set_options(_out_feat("combine")(cfg), {
        "MODEL.ROI_HEAD.CONV_GRID_POOL.CONV_LAYER.x_combine.DOWNSAMPLE_FACTOR": [16, 16, 8]})
    return cfg


DET_OPTIONS = {
    "out_none": _out_feat("None"),
    "combine": _combine,
    "big_combine": _out_feat("big_combine"),
    "clamp_tanh": lambda cfg: set_options(cfg, {"DATA_CONFIG.CLAMP": "tanh"}),
    "clamp_max": lambda cfg: set_options(cfg, {"DATA_CONFIG.CLAMP": 1.0}),
    "unfused_v1": lambda cfg: set_options(cfg, {"MODEL.OCC.OCC_PNT_UPDATE.FUSED_VFE": False,
                                                "MODEL.OCC.OCC_PNT_UPDATE.MERGE_IMPL": "v1"}),
    "unfused_v2": lambda cfg: set_options(cfg, {"MODEL.OCC.OCC_PNT_UPDATE.FUSED_VFE": False,
                                                "MODEL.OCC.OCC_PNT_UPDATE.MERGE_IMPL": "v2"}),
    "mean_vfe": lambda cfg: set_options(cfg, {"MODEL.VFE.NAME": "MeanVFE"}),
    "fractional_upsample": _fractional_upsample,
}
# kernel launches of one eval forward + post-processing per option, where
# they differ from EVAL_LAUNCHES: `None` has no down2 / down3 / squeezeBev /
# down_combine convs (12 GEMMs; the spconv3 / spconv4 maps serve the trunk
# only, subm_down2's goes) and no x_combine to sample; `combine` drops
# squeezeBev (and the subm_down2 map) and adds the strided spconv5 conv and
# the subm5 conv, each on a map of its own (10 maps, 18 GEMMs);
# `big_combine` drops squeezeBev and its map; MeanVFE passes no occ code,
# so the side branch's max-pool goes
DET_OPTION_LAUNCHES = {
    "out_none": dict(EVAL_LAUNCHES, neighbor_map=8, sparse_conv=12, trilinear_pool=0),
    "combine": dict(EVAL_LAUNCHES, neighbor_map=10),
    "big_combine": dict(EVAL_LAUNCHES, neighbor_map=8, sparse_conv=17),
    "mean_vfe": dict(EVAL_LAUNCHES, sparse_pool=0),
}
# a `combine` train step: the 10 forward maps and the transpose-query maps
# of its 8 strided convs (spconv5 for squeezeBev)
COMBINE_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES, neighbor_map=18)


def det_grid(cfg):
    """(nz, ny, nx) of the sparse det grid of `cfg` (z padded by one)."""
    from btcdet_tpu_torch.ops.voxelizer import compute_grid_size

    vs = next(p.VOXEL_SIZE for p in cfg.DATA_CONFIG.DATA_PROCESSOR
              if p.NAME == "det_transform_points_to_voxels")
    nx, ny, nz = compute_grid_size(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, vs)
    return nz + 1, ny, nx


def combine_grid(cfg):
    """(D, H, W) of `combine`'s x_combine: the conv4 grid (three stride-2
    convs, the third without z padding) through spconv5's stride (1, 2, 2);
    (5, 100, 88) on the flagship."""
    def down(n, pad):
        return (n + 2 * pad - 3) // 2 + 1
    z, y, x = det_grid(cfg)
    for pz in (1, 1, 0):
        z, y, x = down(z, pz), down(y, 1), down(x, 1)
    return z, down(y, 1), down(x, 1)


def bev_shape(cfg):
    """(H, W) of the BEV head's map: the stride-8 grid, or the stride-16
    one where an upsample stride is fractional."""
    _, ny, nx = det_grid(cfg)
    h, w = ny // 8, nx // 8
    if min(cfg.MODEL.BACKBONE_2D.UPSAMPLE_STRIDES) < 1:
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def relabel(batch, num_class: int):
    """The batch with its gt boxes' class ids cycled over 1..num_class, box
    by box (0 stays on padding)."""
    import torch

    gt = batch["gt_boxes"].clone()
    ids = torch.arange(gt.shape[1], device=gt.device) % num_class + 1
    gt[..., 7] = torch.where(gt[..., 7] > 0, ids[None].to(gt.dtype), torch.zeros_like(gt[..., 7]))
    return dict(batch, gt_boxes=gt)


def det_net(cfg):
    """The model of `cfg` for its CLASS_NAMES on the card, synthetic
    weights by name, eval mode."""
    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models import build_network

    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES))
    net.load_state_dict(weights.synth_state_dict(net))
    return net


def per_class(post, num_class: int) -> list:
    """Kept detections of each class (labels 1..num_class), over the batch."""
    labels = post["pred_labels"][post["pred_valid"]]
    return [int((labels == c).sum()) for c in range(1, num_class + 1)]


def three_class_eval():
    """The 3-class yaml's eval forward + post at B=2 on a relabelled
    synthetic batch: launches = EVAL_LAUNCHES, finite outputs, detections
    per class, the median of 5 runs after 2 warm-ups and the peak memory."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    cfg = config.three_class()
    net = det_net(cfg)
    batch = relabel(make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384,
                                         num_gt=10, seed=0, mode="test"), 3)
    reset_launches()
    out = net(batch)
    post = post_processing(out, cfg.MODEL.POST_PROCESSING, 3)
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == EVAL_LAUNCHES, launches
    n_det = check_eval_outputs(net, batch, out, post)
    rois = out["roi_labels"][out["roi_valid"]]
    log(f"3-class eval (B=2): launches = EVAL_LAUNCHES; anchors {out['rpn_box_preds'].shape[1]}, "
        f"rois per class {[int((rois == c).sum()) for c in (1, 2, 3)]}, detections per frame "
        f"{n_det}, per class {per_class(post, 3)}")
    med, times = timed_median(lambda: forward_post(net, batch, cfg))
    log(f"forward+post ms, 3-class yaml (B=2, 5 runs after 2 warm-ups): median {med:.2f} all "
        f"{[round(t, 2) for t in times]}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def assign_peak_mib(net, gt) -> float:
    """Peak device memory (MiB above what was allocated) of the RPN's target
    assignment of `gt`."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net.det_modules.dense_head.assign_targets(gt)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def counted_step(net, opt, batch, want: dict, label: str) -> dict:
    """One train step with the launch counts reset before and read after:
    asserts they equal `want` and the metrics are finite; returns them."""
    import torch

    from btcdet_tpu_torch.train import trainer

    reset_launches()
    m = trainer.train_step(net, opt, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == want, (label, launches, want)
    vals = {k: float(v) for k, v in m.items()}
    assert all(math.isfinite(v) for v in vals.values()), (label, vals)
    log(f"{label} train step: launches as asserted; metrics "
        + json.dumps({k: round(v, 6) for k, v in vals.items()}))
    return vals


def three_class_train():
    """The 3-class yaml's train step at the train caps on a relabelled
    synthetic batch: launches = TRAIN_LAUNCHES, finite loss terms, the
    gradient repeat (0 elements may differ), the median of 5 steps; then
    MATCH_HEIGHT with the corner loss off at 3 classes (one counted step,
    no corner term) and the RPN target assignment's peak memory with and
    without MATCH_HEIGHT."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    cfg = config.three_class()
    net, opt, batch = train_setup(cfg, 16384, 10, 0)
    vals = counted_step(net, opt, batch, TRAIN_LAUNCHES, "3-class")
    assert vals["rpn_loss_loc"] > 0, vals
    gradient_repeat(net, batch, "3-class yaml, relabelled synthetic batch")
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"train step ms, 3-class yaml (B=2, train caps, 5 steps): median "
        f"{statistics.median(times):.2f} all {[round(v, 2) for v in times]}")
    peak = {"nearest BEV": assign_peak_mib(net, batch["gt_boxes"])}
    del net, opt
    mh = set_options(config.three_class(), {
        "MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT": True,
        "MODEL.ROI_HEAD.LOSS_CONFIG.CORNER_LOSS_REGULARIZATION": False})
    net, opt, batch = train_setup(mh, 16384, 10, 0)
    vals = counted_step(net, opt, batch, TRAIN_LAUNCHES, "3-class, MATCH_HEIGHT, no corner loss")
    assert "rcnn_loss_corner" not in vals and vals["rpn_loss_loc"] > 0, vals
    peak["MATCH_HEIGHT (rotated 3-D IoU)"] = assign_peak_mib(net, batch["gt_boxes"])
    log(f"RPN target assignment at 3 classes ({net.det_modules.dense_head.anchors.shape[0]} "
        f"anchors, gt boxes {tuple(batch['gt_boxes'].shape)}): peak MiB above the allocated "
        + json.dumps({k: round(v, 1) for k, v in peak.items()}))


def three_class_clis(card: str):
    """The 3-class yaml through both entry points on a 3-class KITTI tree
    (12 frames, 8 in train, 2 cars, 2 pedestrians and 2 cyclists a frame,
    about 20 000 background points): infos, gt database and the best-match
    database of each class by the port; `tools/train_torch.py` for one
    epoch of 4 steps (each step's launches TRAIN_LAUNCHES, finite losses,
    gt boxes of every class pasted) with its trailing eval; then
    `tools/test_torch.py` on that checkpoint: every val frame, finite AP
    keys for each class."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import bestmatch
    from btcdet_tpu_torch.datasets.kitti import kitti_infos
    from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
    from btcdet_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    clis = {name: load_tool(name) for name in ("train_torch", "test_torch")}
    classes = ("Car", "Pedestrian", "Cyclist")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3class_") as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        objects = {c: 2 for c in classes}
        frames = make_raw_kitti(root, n_frames=12, n_train=8, seed=1, n_background=20000,
                                objects_per_frame=objects)
        kitti_infos.create_kitti_infos(root, workers=4)
        bestmatch.create_best_match_db(root, class_names=classes, splits=("train",))
        sets = ["--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False", "DATA_CONFIG.DATA_PATH",
                str(root)]
        seen = []

        def on_step(gstep, batch, metrics):
            launches = read_launches()
            reset_launches()
            vals = {k: float(v) for k, v in metrics.items()}
            assert launches == TRAIN_LAUNCHES, (gstep, launches)
            assert all(math.isfinite(v) for v in vals.values()), (gstep, vals)
            gt = np.asarray(batch["gt_boxes"])
            live = np.abs(gt[..., 3:6]).sum(-1) > 0
            seen.append((gstep, round(vals["loss"], 5), live.sum(1).tolist(),
                         sorted({int(c) for c in gt[..., 7][live]})))

        out = tmp / "train"
        reset_launches()
        res = clis["train_torch"].main(
            ["--cfg_file", str(config.THREE_CLASS_CFG), "--batch_size", "2", "--workers", "2",
             "--epochs", "1", "--output_dir", str(out), "--num_epochs_to_eval", "1", *sets],
            on_step=on_step)
        torch.cuda.synchronize()
        assert res["steps_run"] == 4, res["steps_run"]
        assert all(c == [1, 2, 3] for *_, c in seen), seen
        assert max(max(n) for _, _, n, _ in seen) > sum(objects.values()), "no gt box pasted"
        log(f"[{card}] 3-class train CLI steps (global step, loss, gt boxes a frame, classes): "
            + json.dumps(seen))
        (step, result), = res["eval"]
        ckpt = checkpoint.CheckpointManager(out / "ckpt").path(step)
        reset_launches()
        (run,) = clis["test_torch"].main(
            ["--cfg_file", str(config.THREE_CLASS_CFG), "--ckpt", str(ckpt), "--batch_size", "2",
             "--workers", "2", "--output_dir", str(tmp / "eval"), *sets])
        torch.cuda.synchronize()
        launches = read_launches()
        _, _, result, annos = run
        assert [a["frame_id"] for a in annos] == frames[8:], [a["frame_id"] for a in annos]
        assert launches == {k: v * 2 for k, v in EVAL_LAUNCHES.items()}, launches
        ap = {k: float(v) for k, v in result.items() if k.split("_")[0] in classes
              and "/" in k}
        for c in classes:
            keys = [k for k in ap if k.startswith(f"{c}_")]
            assert len(keys) >= 18 and all(math.isfinite(ap[k]) for k in keys), (c, keys)
        log(f"[{card}] 3-class test CLI on the step-{step} checkpoint: {len(annos)} frames, "
            f"detections a frame {[len(a['name']) for a in annos]}, {len(ap)} finite AP keys; "
            + json.dumps({k: round(v, 4) for k, v in ap.items() if k.endswith("3d/moderate_R40")}))
    log(f"[{card}] 3-class CLI phase: {time.perf_counter() - t_phase:.1f} s")


def det_options_eval():
    """The flagship eval forward + post at B=2 with each of DET_OPTIONS:
    launches against DET_OPTION_LAUNCHES (EVAL_LAUNCHES where unlisted),
    finite outputs, detections; the two MERGE_IMPL versions' materialized
    tables equal bit for bit. Under `combine`, the spconv5 and subm5 convs
    (K1 map and GEMM) and K4 on the (B, 5, 100, 88, 128) volume against
    their plain versions, timed with their bounds. Returns those entries."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    entries, tables = [], {}
    batch = make_synthetic_batch(config.flagship().DATA_CONFIG, batch_size=2, num_points=16384,
                                 num_gt=10, seed=0, mode="test")
    for option, edit in DET_OPTIONS.items():
        cfg = edit(config.flagship())
        net = det_net(cfg)
        if option == "combine":
            captured = capture_kernel_inputs(lambda: net(batch))
            convs = [a for a, _ in captured["sparse_conv"]]
            i5 = next(i for i, a in enumerate(convs) if a[7] == (1, 2, 2))
            # subm5 runs on spconv5's output sites
            assert convs[i5 + 1][7] == (1, 1, 1) and convs[i5 + 1][2].shape == convs[i5][2].shape
            entries += k1_case("combine spconv5(3^3 s(1,2,2) 128->128)", convs[i5])
            entries += k1_case("combine subm5(subm 128->128)", convs[i5 + 1])
            (vol, zyx, roi_b, valid), = [a for a, _ in captured["trilinear_pool"]]
            assert tuple(vol.shape[:4]) == (2, *combine_grid(cfg)), tuple(vol.shape)
            entries.append(k4_case((vol, zyx, roi_b, valid), "combine"))
            del captured, convs, vol, zyx, roi_b, valid
        seen = {}
        hook = None
        if option.startswith("unfused"):
            hook = net.occ_modules.register_forward_hook(
                lambda m, i, o: seen.update(vox=o["det_voxels"].clone()))
        reset_launches()
        out = net(batch)
        post = post_processing(out, cfg.MODEL.POST_PROCESSING, 1)
        torch.cuda.synchronize()
        launches = read_launches()
        if hook is not None:
            hook.remove()
            tables[option] = seen["vox"]
        want = DET_OPTION_LAUNCHES.get(option, EVAL_LAUNCHES)
        assert launches == want, (option, launches, want)
        if option == "combine":
            for e in entries:
                e["launches"] = launches[e["name"].split(":")[0]]
        n_det = check_eval_outputs(net, batch, out, post, bev=bev_shape(cfg))
        log(f"det option {option!r} eval (B=2): launches {json.dumps(launches)}; nnz "
            f"{json.dumps(out['nnz'])}; detections per frame {n_det}")
        if option in ("out_none", "combine", "fractional_upsample"):
            med, times = timed_median(lambda: forward_post(net, batch, cfg))
            log(f"forward+post ms, det option {option!r} (B=2, 5 runs after 2 warm-ups): median "
                f"{med:.2f} all {[round(t, 2) for t in times]}")
        del net, out, post
    a, b = tables["unfused_v1"], tables["unfused_v2"]
    assert torch.equal(a, b), "MERGE_IMPL v1 and v2 tables differ"
    log(f"det options: the materialized merged tables of MERGE_IMPL v1 and v2 equal bit for bit "
        f"({tuple(a.shape)}, {int((a.abs().sum(-1) > 0).sum())} filled point slots)")
    return entries


def det_options_train():
    """Train steps of the flagship at the train caps: `combine` (K3 of the
    spconv5 conv and K4's volume gradient on the combine volume against
    their plain versions on a captured step, then one counted step,
    COMBINE_TRAIN_LAUNCHES), and one counted step with each of `adam`,
    `adam_cosine` (both with LR_WARMUP) and `sgd`. Returns the entries."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    cfg = DET_OPTIONS["combine"](config.flagship())
    net, opt, batch = train_setup(cfg, 16384, 10, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = capture_kernel_inputs(lambda: trainer.train_step(net, opt, batch, gen))
    dw = next(c for c in calls["sparse_conv_dw"] if c[0][7] == (1, 2, 2))
    entries = k3_case("combine spconv5(3^3 s(1,2,2) 128->128)", dw)
    (g_args,) = [a for a, _ in calls["trilinear_pool_grad"]]
    assert tuple(g_args[1][:4]) == (2, *combine_grid(cfg)), g_args[1]
    entries.append(k4_grad_case(g_args, "combine"))
    del calls, dw, g_args
    reset_launches()
    trainer.train_step(net, opt, batch, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == COMBINE_TRAIN_LAUNCHES, (launches, COMBINE_TRAIN_LAUNCHES)
    for e in entries:
        e["launches"] = launches[e["name"].split(":")[0]]
    log(f"det option 'combine' train step: launches {json.dumps(launches)}")
    gradient_repeat(net, batch, "OUT_FEAT_TYPE combine")
    del net, opt
    for name in ("adam", "adam_cosine", "sgd"):
        cfg = config.flagship()
        for blk in (cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION):
            blk.OPTIMIZER = name
            blk.LR_WARMUP = name != "sgd"
        net, opt, batch = train_setup(cfg, 16384, 10, 0)
        vals = counted_step(net, opt, batch, TRAIN_LAUNCHES, f"optimizer {name!r}")
        assert vals["grad_norm_det"] > 0 and vals["grad_norm_occ"] > 0, vals
        del net, opt
    return entries


def det_option_small_check(option: str):
    """`small_config(full=True)` with a det option, f32 on the card against
    the CPU (small_input_check); `combine` / `big_combine` / fractional
    strides on its 16 m grid."""
    small_input_check(DET_OPTIONS[option](small_config(full=True)), f"det option {option!r}")


def det_options_path(card: str):
    """The ninth path (module docstring, 8d); returns its kernels-line
    entries."""
    import torch

    t0 = time.perf_counter()
    three_class_eval()
    three_class_train()
    three_class_clis(card)
    small_input_check(small_three_class(), "3-class config")
    entries = det_options_eval()
    entries += det_options_train()
    for option in DET_OPTIONS:
        det_option_small_check(option)
    torch.cuda.synchronize()
    log(f"ninth path (det options, 3-class config): {time.perf_counter() - t0:.1f} s")
    return entries


def small_three_class():
    """`small_config(full=True)` with the 3-class yaml's classes and anchors."""
    from btcdet_tpu_torch import config

    cfg = small_config(full=True)
    three = config.three_class()
    cfg.CLASS_NAMES = list(three.CLASS_NAMES)
    cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = three.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    return cfg

# --------------------------------------------- tenth path: side modules
#
# The modules no config names, at the flagship's widths and sizes:
# VoxelResBackBone8x, the inverse and transpose convs (K1 and K3 at new
# geometries), VoxelSetAbstraction, and the plain functions ATSS, the roi
# pools, chamfer, PointPillarScatter and the NMS functions, each against the
# port's CPU run on the same inputs.

SIDE_CHANNELS = (16, 32, 64, 128, 128)
SIDE_LEVELS = ("encoded", "x_conv1", "x_conv2", "x_conv3", "x_conv4")
# one eval forward of VoxelResBackBone8x: 13 gather-GEMMs over 8 maps
# (conv_input and res1's pair read the input table's map, each later
# residual pair its level's, each strided conv its own)
RES_EVAL_LAUNCHES = dict(dict.fromkeys(TRAIN_LAUNCHES, 0), neighbor_map=8, sparse_conv=13)
# the tenth path's counted run: that forward with its backward (12 dfs:
# conv_input's input needs no gradient; the 4 strided dfs build a
# transpose-query map each), then the 3 inverse convs and the transpose
# conv, each with a transpose-query map for its forward and a
# forward-query map for its df; 17 weight gradients, each compacted
SIDE_LAUNCHES = dict(dict.fromkeys(TRAIN_LAUNCHES, 0), neighbor_map=8 + 4 + 2 * 4,
                     sparse_conv=13 + 4, sparse_conv_df=12 + 4, tap_pairs=17,
                     sparse_conv_dw=17)
# the forward calls of the counted run, in order
SIDE_CONVS = ("conv_input", "res1_0", "res1_1", "conv2", "res2_0", "res2_1", "conv3", "res3_0",
              "res3_1", "conv4", "res4_0", "res4_1", "conv_out", "inv4", "inv3", "inv2", "deconv")


def side_setup():
    """VoxelResBackBone8x at SIDE_CHANNELS on the flagship det voxel table
    (make_synthetic_batch: 16 384 points, 10 gt, test caps) after MeanVFE,
    eval mode, and the side convs: inverse convs 128->64 (key spconv4),
    64->32 (spconv3), 32->16 (spconv2), and a k (2, 2, 2) stride-2
    transpose conv 128->64 on x_conv4 whose output capacity (8 rows an
    input row) cuts nothing. Synthetic weights by name. Returns (backbone,
    convs, input tensor, batch, cfg)."""
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import backbones_3d, vfe
    from btcdet_tpu_torch.ops import sparse

    cfg = config.flagship_det_only()
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                 seed=0, mode="test")
    feats = vfe.MeanVFE()(batch["voxels"], batch["voxel_num_points"])
    st = sparse.from_coords(feats, batch["voxel_coords"], det_grid(cfg), 2)
    net = backbones_3d.VoxelResBackBone8x(feats.shape[1], SIDE_CHANNELS).cuda().eval()
    net.load_state_dict(weights.synth_state_dict(net))
    per_frame = 8 * st.capacity // st.batch_size
    convs = torch.nn.ModuleDict({
        "inv4": sparse.SparseInverseConv3d(128, 64, 3, "spconv4", 2, (0, 1, 1)),
        "inv3": sparse.SparseInverseConv3d(64, 32, 3, "spconv3", 2, 1),
        "inv2": sparse.SparseInverseConv3d(32, 16, 3, "spconv2", 2, 1),
        "deconv": sparse.SparseConvTranspose3d(128, 64, 2, 2, 0,
                                               frame_capacity=(per_frame, per_frame)),
    }).cuda().eval()
    convs.load_state_dict(weights.synth_state_dict(convs))
    return net, convs, st, batch, cfg


def side_step(net, convs, st, proj: list):
    """The backbone, the inverse convs (levels 3, 2, 1 from 4, 3, 2) and the
    transpose conv forward, then the backward of a fixed random projection
    of every output (`proj`, filled on the first call). Returns the
    outputs."""
    import torch

    cache = {}
    out = net(st, cache)
    outs = [out[k] for k in SIDE_LEVELS]
    outs += [convs[f"inv{lv}"](out[f"x_conv{lv}"], cache) for lv in (4, 3, 2)]
    outs.append(convs["deconv"](out["x_conv4"], cache))
    if not proj:
        gen = torch.Generator(device="cuda").manual_seed(13)
        proj += [torch.randn(o.features.shape, generator=gen, device="cuda")
                 * o.valid[:, None] for o in outs]
    sum((o.features.float() * p).sum() for o, p in zip(outs, proj)).backward()
    return outs


def side_grads(net, convs, st, proj) -> dict:
    for p in list(net.parameters()) + list(convs.parameters()):
        p.grad = None
    side_step(net, convs, st, proj)
    return {n: p.grad.clone() for mod in (net, convs) for n, p in mod.named_parameters()}


def side_light_checks(calls):
    """Every K1 and K3 call of the counted run against its plain version:
    the forwards' maps bit for bit (transpose-query for the inverse and
    transpose convs), the bf16 gather-GEMMs and dfs to TOL of the plain
    max, the weight gradients to rtol 1e-3 / atol 1e-4 of the plain max.
    Returns the number of calls checked."""
    import torch

    from btcdet_tpu_torch.ops import cuda_conv

    fwd = calls["sparse_conv"]
    assert len(fwd) == len(SIDE_CONVS), len(fwd)
    torch.set_grad_enabled(False)
    for name, (a, kw) in zip(SIDE_CONVS, fwd):
        feats, keys, coords, w, shape, bsz, k, s, p = a[:9]
        transpose = name.startswith(("inv", "deconv"))
        ref_map = cuda_conv.neighbor_map_plain(keys, coords, shape, k, s, p, transpose)
        assert torch.equal(kw["nbr"], ref_map), f"K1 map {name}: kernel and plain version differ"
        out = cuda_conv.sparse_conv(*a[:9], nbr=kw["nbr"])
        ref = cuda_conv.apply_map_matmul(feats.detach(), ref_map, w)
        scale = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= TOL * max(scale, 1e-6), f"K1 {name}"
    for a, kw in calls["sparse_conv_df"]:
        out = cuda_conv.sparse_conv_df(*a[:9], transpose=kw["transpose"], nbr=kw.get("nbr"))
        ref = cuda_conv.sparse_conv_plain(*a[:9], transpose=kw["transpose"])
        scale = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= TOL * max(scale, 1e-6), (
            f"K1 df kernel={a[6]} stride={a[7]} transpose={kw['transpose']}")
    for a, kw in calls["sparse_conv_dw"]:
        out = cuda_conv.sparse_conv_dw(a[0].detach(), *a[1:9], nbr=kw["nbr"])
        ref = cuda_conv.sparse_conv_dw_plain(a[0].detach(), *a[1:9], nbr=kw["nbr"])
        torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m, a=a: f"K3 kernel={a[6]} stride={a[7]}: {m}")
    torch.set_grad_enabled(True)
    torch.cuda.synchronize()
    return len(fwd) + len(calls["sparse_conv_df"]) + len(calls["sparse_conv_dw"])


def side_sparse_phase():
    """The residual backbone's eval forward (RES_EVAL_LAUNCHES, its 13
    launches timed), then the counted run (SIDE_LAUNCHES): every K1 / K3
    call against its plain version, the new geometries timed with their
    bounds, and the run's gradients twice from the same state (0 elements
    may differ). Returns (kernels-line entries, backbone, st, batch, cfg)."""
    import torch

    net, convs, st, batch, cfg = side_setup()
    reset_launches()
    with torch.no_grad():
        out = net(st)
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == RES_EVAL_LAUNCHES, (launches, RES_EVAL_LAUNCHES)
    log(f"VoxelResBackBone8x {SIDE_CHANNELS} eval forward (B=2, flagship det table): launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; nnz "
        f"{json.dumps({k: int(out[k].nnz) for k in SIDE_LEVELS})}; grids "
        f"{json.dumps({k: out[k].spatial_shape for k in SIDE_LEVELS})}")
    with torch.no_grad():
        captured = capture_kernel_inputs(lambda: net(st))
    k1_eval_table(captured["sparse_conv"], captured["neighbor_map"])
    med, times = timed_median(lambda: (net(st), torch.cuda.synchronize()))
    log(f"VoxelResBackBone8x eval forward ms (5 runs after 2 warm-ups): median {med:.2f} all "
        f"{[round(t, 2) for t in times]}")
    del captured, out

    proj = []
    side_grads(net, convs, st, proj)                 # fills proj
    reset_launches()
    outs = side_step(net, convs, st, proj)
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == SIDE_LAUNCHES, (launches, SIDE_LAUNCHES)
    log(f"tenth path counted run (backbone + 3 inverse convs + transpose conv, forward and "
        f"backward): launches {json.dumps({k: v for k, v in launches.items() if v})}")
    inv = dict(zip(("inv4", "inv3", "inv2", "deconv"), outs[5:]))
    # every tap of a k=2 stride-2 transpose conv lands on the grid, on a site
    # of its own: 8 candidates an input row, all distinct
    n_cand = 8 * int(outs[4].nnz)
    log(f"inverse convs restore nnz {[int(inv[k].nnz) for k in ('inv4', 'inv3', 'inv2')]} (levels "
        f"3, 2, 1: {[int(outs[k].nnz) for k in (3, 2, 1)]}); transpose conv 2^3 s2 on x_conv4: "
        f"{n_cand} candidates, nnz {int(inv['deconv'].nnz)} of capacity "
        f"{inv['deconv'].capacity}, grid {inv['deconv'].spatial_shape}")
    assert [int(inv[k].nnz) for k in ("inv4", "inv3", "inv2")] == [
        int(outs[k].nnz) for k in (3, 2, 1)]
    assert int(inv["deconv"].nnz) == n_cand <= inv["deconv"].capacity
    for o in outs:
        assert bool(torch.isfinite(o.features).all())
    del outs, inv

    calls = capture_kernel_inputs(lambda: side_step(net, convs, st, proj))
    n = side_light_checks(calls)
    log(f"tenth path: {n} K1 / K3 calls of the counted run against their plain versions "
        f"(maps bit for bit)")
    fwd = dict(zip(SIDE_CONVS, calls["sparse_conv"]))
    entries = []
    for name, label, transpose in (
            ("conv4", "res conv4(3^3 s2 p(0,1,1) 64->128)", False),
            ("res4_0", "res4 subm(128->128)", False),
            ("conv_out", "res conv_out(3x1x1 s(2,1,1) 128->128)", False),
            ("inv4", "inv4(3^3 s2 p(0,1,1) 128->64, transpose map)", True),
            ("inv2", "inv2(3^3 s2 32->16, transpose map)", True),
            ("deconv", "deconv(2^3 s2 128->64, transpose map)", True)):
        entries += k1_case(label, fwd[name][0], transpose=transpose)

    def pick(kind, cin, cout, kernel):
        return next(c for c in calls[kind]
                    if c[0][6] == kernel and c[0][0].shape[1] == cin
                    and (c[0][3].shape[1] if kind == "sparse_conv_dw" else c[0][3].shape[2])
                    == cout)

    for label, (cin, cout, kernel) in (("inv4 df(64->128, forward-query map)",
                                        (64, 128, (3, 3, 3))),
                                       ("deconv df(64->128, forward-query map)",
                                        (64, 128, (2, 2, 2)))):
        call = pick("sparse_conv_df", cin, cout, kernel)
        assert call[1]["transpose"] is False
        entries += k1_case(label, call[0], df=True)
    for label, (cin, cout, kernel) in (("res conv4(3^3 s2 64->128)", (64, 128, (3, 3, 3))),
                                       ("inv4(128->64, transpose map)", (128, 64, (3, 3, 3))),
                                       ("deconv(2^3 128->64, transpose map)",
                                        (128, 64, (2, 2, 2)))):
        entries += k3_case(label, pick("sparse_conv_dw", cin, cout, kernel))
    del calls, fwd
    for e in entries:
        e["launches"] = launches[e["name"].split(":")[0]]

    g1 = side_grads(net, convs, st, proj)
    g2 = side_grads(net, convs, st, proj)
    differ = sum(int((g1[k] != g2[k]).sum()) for k in g1)
    total = sum(g.numel() for g in g1.values())
    log(f"tenth path gradient repeat: {differ} of {total} elements differ over "
        f"{len(g1)} tensors")
    assert differ == 0
    assert all(float(g.abs().max()) > 0 for g in g1.values())
    del g1, g2, convs, proj
    return entries, net, st, batch, cfg



def ball_list_valid(idx, empty, xyz64, mask, q64, r2: float, eps, lo2: float = 0.0) -> bool:
    """Whether a ball (or shell) query's list `idx` (k,) is a valid answer
    for the query point q among the points of `mask`: the first k points in
    point order among a set that holds every point with d^2 < r2 - eps (and
    d^2 > lo2 + eps in a shell) and only points with lo2 - eps <= d^2 <=
    r2 + eps (numpy, distances in float64, `eps` one bound or one a point),
    the slots past its count repeating its first entry; an empty ball holds
    no point surely inside."""
    d2 = ((xyz64 - q64) ** 2).sum(-1)
    sure = mask & (d2 < r2 - eps) & ((d2 > lo2 + eps) if lo2 > 0 else True)
    maybe = mask & (d2 <= r2 + eps) & (d2 >= lo2 - eps)
    if empty:
        return not sure.any()
    idx = [int(i) for i in idx]
    count = next((j for j in range(1, len(idx)) if idx[j] <= idx[j - 1]), len(idx))
    listed, fill = idx[:count], idx[count:]
    if any(i != listed[0] for i in fill) or not all(maybe[i] for i in listed):
        return False
    last = listed[-1] if count == len(idx) else len(d2) - 1
    return all(i in listed for i in sure[:last + 1].nonzero()[0].tolist())


def vsa_queries(xyz, mask, kp, kp_mask, levels, vsa):
    """Every ball query of `vsa` on its inputs: {(SA, scale): (idx, empty,
    support xyz, support mask, r^2)}."""
    import torch

    from btcdet_tpu_torch.ops import group_ops
    from btcdet_tpu_torch.utils import common

    sas = [("raw", vsa.SA_rawpoints, xyz, mask)]
    for name, sa in zip(vsa.levels, vsa.SA_layers):
        st = levels[name]
        c = common.get_voxel_centers(st.coords[:, 1:4], 2 ** (int(name[-1]) - 1), vsa.voxel_size,
                                     vsa.point_cloud_range)
        frames = torch.arange(xyz.shape[0], device=c.device)[:, None]
        sas.append((name, sa, c[None].expand(xyz.shape[0], -1, -1),
                    (st.coords[None, :, 0] == frames) & st.valid[None]))
    out = {}
    for name, sa, sxyz, smask in sas:
        qs = group_ops.multi_ball_query(sxyz, smask, kp, kp_mask, sa.radii, sa.nsamples)
        for s, ((idx, empty), r) in enumerate(zip(qs, sa.radii)):
            out[(name, s)] = (idx, empty, sxyz, smask, float(r) ** 2)
    return out


def vsa_phase(net, st, batch, cfg):
    """VoxelSetAbstraction at its own default widths (2048 keypoints,
    FEATURES_SOURCE bev, x_conv3, x_conv4, raw_points, 128 features) on the
    residual backbone's levels and the HeightCompression of its `encoded`,
    synthetic weights, eval: the ms of FPS, of the ball queries and of the
    module; then the card's run against the CPU's on the same inputs, f32:
    the keypoints exact, the features within rtol = atol = 1e-3 but for
    keypoints whose ball lists differ, each differing card list proven a
    valid answer (its flipped points within f32 rounding of the radius)."""
    import numpy as np
    import torch

    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models import map_to_bev, pfe
    from btcdet_tpu_torch.ops import group_ops

    with torch.no_grad():
        lv = net(st)
        _, bev = map_to_bev.HeightCompression()(lv["encoded"])
    levels = {k: lv[k] for k in ("x_conv3", "x_conv4")}
    xyz = batch["points"][..., :3].contiguous()
    mask = batch["points_mask"]
    inten = batch["points"][..., 3:4].contiguous()
    det_vs = next(p.VOXEL_SIZE for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                  if p.NAME == "det_transform_points_to_voxels")
    vsa = pfe.VoxelSetAbstraction({"x_conv3": SIDE_CHANNELS[2], "x_conv4": SIDE_CHANNELS[3]},
                                  raw_channels=1, bev_channels=bev.shape[-1],
                                  point_cloud_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                  voxel_size=det_vs).cuda().eval()
    vsa.load_state_dict(weights.synth_state_dict(vsa))
    with torch.no_grad():
        fps_ms = cuda_ms(lambda: group_ops.furthest_point_sample(xyz, mask, vsa.num_keypoints),
                         reps=3, warmup=1)
        kp_idx = group_ops.furthest_point_sample(xyz, mask, vsa.num_keypoints)
        kp = group_ops.gather_points(xyz, kp_idx)
        kp_mask = torch.gather(mask, 1, kp_idx)
        q_ms = cuda_ms(lambda: vsa_queries(xyz, mask, kp, kp_mask, levels, vsa), reps=3,
                       warmup=1)
        vsa_ms = cuda_ms(lambda: vsa(xyz, mask, inten, levels, bev), reps=3, warmup=1)
    log(f"VoxelSetAbstraction (B=2, {vsa.num_keypoints} keypoints, sources "
        f"{list(vsa.features_source)}, support rows: raw {xyz.shape[1]}, "
        f"{ {k: v.capacity for k, v in levels.items()} }, BEV {tuple(bev.shape)}): FPS "
        f"{fps_ms:.2f} ms, ball queries {q_ms:.2f} ms, module {vsa_ms:.2f} ms")

    res = {}
    with f32_everywhere(), torch.no_grad():
        for dev in ("cuda", "cpu"):
            m = vsa.to(dev)
            lvd = {k: v.replace(features=v.features.float().to(dev), coords=v.coords.to(dev),
                                keys=v.keys.to(dev), nnz=v.nnz.to(dev))
                   for k, v in levels.items()}
            args = (xyz.to(dev), mask.to(dev), inten.to(dev), lvd, bev.float().to(dev))
            kp_, f_, km_ = m(*args)
            res[dev] = (kp_.cpu(), f_.cpu(), km_.cpu(), vsa_queries(
                args[0], args[1], kp_, km_, lvd, m))
    (kp_g, f_g, km_g, q_g), (kp_c, f_c, km_c, q_c) = res["cuda"], res["cpu"]
    assert torch.equal(kp_g, kp_c) and torch.equal(km_g, km_c), "FPS: card and CPU differ"
    differ = set()
    flips = 0
    for key, (gi, ge, sxyz, smask, r2) in q_g.items():
        ci, ce = q_c[key][0].cpu(), q_c[key][1].cpu()
        gi, ge = gi.cpu(), ge.cpu()
        rows = ((gi != ci).any(-1) | (ge != ce)).nonzero().tolist()
        sx = sxyz.double().cpu().numpy()
        sm = smask.cpu().numpy()
        for b, m_ in rows:
            q64 = kp_g[b, m_].double().numpy()
            assert ball_list_valid(gi[b, m_].numpy(), bool(ge[b, m_]), sx[b], sm[b], q64, r2,
                                   1e-5 * max(r2, 1.0)), (key, b, m_)
            differ.add((b, m_))
            flips += 1
    keep = torch.ones(km_g.shape, dtype=torch.bool)
    for b, m_ in differ:
        keep[b, m_] = False
    torch.testing.assert_close(f_g[keep], f_c[keep], rtol=1e-3, atol=1e-3)
    log(f"VoxelSetAbstraction card vs CPU (f32): keypoints equal ({int(km_g.sum())} valid), "
        f"{flips} ball lists differ on {len(differ)} keypoints, each card list valid; the other "
        f"keypoints' features within 1e-3 (max abs diff "
        f"{float((f_g[keep] - f_c[keep]).abs().max()):.3e}, max {float(f_c.abs().max()):.3f})")
    assert len(differ) <= 0.02 * km_g.numel(), len(differ)
    assert float(f_c.abs().max()) > 0
    vsa.cuda()


def roi_edge_points(rois, points, out_size=None, tol=1e-5):
    """(P,) bool numpy: points within `tol` (float64) of some roi's box
    face, or with `out_size` of one of its cell edges, where the card and
    the CPU may round a point to either side."""
    import numpy as np

    r, p = rois.double().cpu().numpy(), points.double().cpu().numpy()
    local = p[None, :, :3] - r[:, None, :3]
    c, s = np.cos(-r[:, 6])[:, None], np.sin(-r[:, 6])[:, None]
    local = np.stack([local[..., 0] * c + local[..., 1] * s,
                      -local[..., 0] * s + local[..., 1] * c, local[..., 2]], -1)
    half = r[:, None, 3:6] / 2
    edge = (np.abs(np.abs(local) - half) < tol).any(-1)
    if out_size is not None:
        oz, oy, ox = out_size
        q = (local + half) / (r[:, None, 3:6] / np.array([ox, oy, oz]))
        inside = (np.abs(local) <= half + tol).all(-1)
        edge |= inside & (np.abs(q - np.round(q)) < tol).any(-1)
    return edge.any(0)


def on_both(fn, *args, **kw):
    """fn on the card's tensors and on their CPU copies: (card result,
    CPU result, card ms), results on the CPU."""
    import torch

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    def host(out):
        if isinstance(out, (tuple, list)):
            return type(out)(host(o) for o in out)
        return cpu(out)

    g = host(fn(*args, **kw))
    c = host(fn(*(cpu(a) for a in args), **kw))
    return g, c, cuda_ms(lambda: fn(*args, **kw), reps=3, warmup=1)


def side_functions_phase(batch, cfg):
    """ATSS, the roi pools, chamfer, PointPillarScatter and the NMS
    functions at realistic sizes on the card against the port's CPU run on
    the same inputs, with their card ms (and ATSS's peak memory). Index
    outputs exact (roi points on a face or cell edge left out of both
    runs, after asserting they lie there); f32 outputs within rtol = atol
    = 1e-3."""
    import numpy as np
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.models import map_to_bev, model_nms_utils
    from btcdet_tpu_torch.models.dense_heads import anchor_head, atss_assigner
    from btcdet_tpu_torch.ops import chamfer, roiaware_pool

    rng = np.random.RandomState(17)
    nz, ny, nx = det_grid(cfg)
    anchors = torch.from_numpy(anchor_head.generate_anchors(
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE, (nx, ny),
        cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG)[0]).cuda()
    for b in range(2):
        gt = batch["gt_boxes"][b]
        for mh in (True, False):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            args = (anchors, gt[:, :7].contiguous(), gt[:, 7] > 0, gt[:, 7].long())
            (gl, gr, gp), (cl, cr, cp), ms = on_both(atss_assigner.atss_assign, *args,
                                                    match_height=mh)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            assert torch.equal(gl, cl) and torch.equal(gp, cp), ("ATSS labels", b, mh)
            torch.testing.assert_close(gr, cr, rtol=1e-3, atol=1e-3)
            log(f"atss_assign frame {b} match_height={mh}: {anchors.shape[0]} anchors x "
                f"{int((gt[:, 7] > 0).sum())} gt, {int(gp.sum())} positive, labels equal to the "
                f"CPU's; {ms:.2f} ms, peak {peak:.1f} MiB above the allocated")
            assert int(gp.sum()) > 0

    pts = batch["points"][0][batch["points_mask"][0]][:, :3].contiguous()
    gt = batch["gt_boxes"][0][:, :7].cpu().numpy()
    pick = rng.randint(0, len(gt), 128)
    rois = gt[pick] + np.concatenate([rng.normal(0, 0.3, (128, 3)), rng.normal(0, 0.1, (128, 3)),
                                      rng.normal(0, 0.2, (128, 1))], 1)
    rois[:len(gt)] = gt
    rois = torch.from_numpy(rois.astype(np.float32)).cuda()
    pfeat = torch.from_numpy(rng.randn(len(pts), 16).astype(np.float32)).cuda()
    for method in ("max", "avg"):
        edge = torch.from_numpy(roi_edge_points(rois, pts, (6, 6, 6))).cuda()
        pmask = ~edge
        g, c, ms = on_both(roiaware_pool.roiaware_pool3d, rois, pts, pfeat, pmask,
                           pool_method=method)
        if method == "max":
            assert torch.equal(g, c), "roiaware_pool3d max: card and CPU differ"
        else:
            torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-3)
        log(f"roiaware_pool3d {method} (6,6,6), 128 rois, {len(pts)} points x 16: "
            f"{int((g != 0).any(-1).sum())} filled cells, {int(edge.sum())} points on a face or "
            f"cell edge left out, {'equal' if method == 'max' else 'within 1e-3'}; {ms:.2f} ms")
    edge = torch.from_numpy(roi_edge_points(
        torch.cat([rois[:, :3], rois[:, 3:6] + 0.2, rois[:, 6:]], 1), pts)).cuda()
    (gp_, ge), (cp_, ce), ms = on_both(roiaware_pool.roipoint_pool3d, rois, pts, pfeat, ~edge,
                                       num_sampled_points=512, extra_width=(0.2, 0.2, 0.2))
    assert torch.equal(gp_, cp_) and torch.equal(ge, ce), "roipoint_pool3d: card and CPU differ"
    log(f"roipoint_pool3d 128 rois x 512 samples: {int((~ge).sum())} non-empty rois, "
        f"{int(edge.sum())} points on a face left out, equal; {ms:.2f} ms")

    a = torch.from_numpy((rng.randn(16, 2048, 3) * 5).astype(np.float32)).cuda()
    bb = torch.from_numpy((rng.randn(16, 2048, 3) * 5).astype(np.float32)).cuda()
    m1 = torch.from_numpy(rng.rand(16, 2048) > 0.1).cuda()
    m2 = torch.from_numpy(rng.rand(16, 2048) > 0.1).cuda()
    (g1, g2), (c1, c2), ms = on_both(chamfer.chamfer_distance, a, bb, m1, m2)
    for g, c in ((g1, c1), (g2, c2)):
        assert torch.equal(torch.isinf(g), torch.isinf(c))
        fin = torch.isfinite(c)
        torch.testing.assert_close(g[fin], c[fin], rtol=1e-3, atol=1e-3)
    log(f"chamfer_distance 16 pairs of 2048 points: within 1e-3 of the CPU's (max abs diff "
        f"{float((g1[torch.isfinite(c1)] - c1[torch.isfinite(c1)]).abs().max()):.3e}); "
        f"{ms:.2f} ms")

    pp_nx, pp_ny, C, per = 432, 496, 64, 12000
    coords = []
    for fb in range(2):
        cells = rng.choice(pp_ny * pp_nx, per, replace=False)
        y, x = np.divmod(cells, pp_nx)
        coords.append(np.stack([np.full(per, fb), np.zeros(per, int), y, x], 1))
    coords = torch.from_numpy(np.concatenate(coords).astype(np.int32)).cuda()
    pf = torch.from_numpy(rng.randn(len(coords), C).astype(np.float32)).cuda()
    scatter = map_to_bev.PointPillarScatter(C, (pp_nx, pp_ny, 1))
    (gn, gh), (cn, ch), ms = on_both(scatter, pf, coords, 2)
    assert torch.equal(gh, ch) and torch.equal(gn, cn) and tuple(gn.shape) == (2, C, pp_ny, pp_nx)
    log(f"PointPillarScatter {per} pillars a frame onto ({pp_ny}, {pp_nx}) x {C}: equal; "
        f"{ms:.2f} ms")

    post = config.three_class().MODEL.POST_PROCESSING
    n = 4000
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform([0, -40], [70.4, 40], (n, 2))
    boxes[:, 2] = rng.uniform(-2, 0, n)
    boxes[:, 3:6] = rng.uniform([0.6, 0.5, 1.4], [4.5, 1.9, 1.9], (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:n // 2, :2] = boxes[n // 2:, :2] + rng.normal(0, 0.5, (n // 2, 2))   # overlaps
    scores = torch.from_numpy(rng.rand(n, 3).astype(np.float32)).cuda()
    gres, cres, ms = on_both(model_nms_utils.multi_classes_nms, scores,
                             torch.from_numpy(boxes).cuda(), post.NMS_CONFIG,
                             float(post.SCORE_THRESH))
    kept = []
    for (gi, gv, gl), (ci, cv, cl) in zip(gres, cres):
        assert torch.equal(gv, cv) and torch.equal(gi[gv], ci[cv]) and torch.equal(gl, cl)
        kept.append(int(gv.sum()))
    log(f"multi_classes_nms (3 classes, {n} boxes, NMS_CONFIG of the 3-class yaml: thresh "
        f"{post.NMS_CONFIG.NMS_THRESH}, pre {post.NMS_CONFIG.NMS_PRE_MAXSIZE}, post "
        f"{post.NMS_CONFIG.NMS_POST_MAXSIZE}): kept {kept} per class, equal to the CPU's; "
        f"{ms:.2f} ms")


def side_modules_path(card: str):
    """The tenth path (module docstring, 8e); returns its kernels-line
    entries."""
    import torch

    t0 = time.perf_counter()
    entries, net, st, batch, cfg = side_sparse_phase()
    vsa_phase(net, st, batch, cfg)
    side_functions_phase(batch, cfg)
    torch.cuda.synchronize()
    log(f"tenth path (side modules): {time.perf_counter() - t0:.1f} s ({card})")
    return entries


# ------------------------------------------ seventh path: data parallelism
#
# The card machine has one card. NCCL refuses two ranks on one device, so
# the data-parallel ranks run over gloo, both on cuda:0 (gloo stages the
# CUDA tensors through the host); NCCL runs one rank. Their times show the
# path running, not scaling.

DP_WORLD = 2
DP_TIMEOUT_S = 300           # the limit of each spawned run, seconds
# how this script is started as a rank (`--dp-worker <task> <io dir> ...`)
SELF = [sys.executable, os.path.abspath(__file__)]
DP_DEVICE = "cuda"           # the one-process references' device


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for rank `rank` of `world` on this host."""
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="2")
    return env


def torchrun_argv(nproc: int, *script_and_args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
            "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
            *map(str, script_and_args)]


def run_group(cmds, label: str, timeout: float = DP_TIMEOUT_S) -> list:
    """Start every (argv, env) of `cmds` together, each in a process group
    of its own, and wait for all within `timeout` seconds; every group
    still running then is killed. Raises unless every exit code is 0
    (printing the outputs' ends); returns the outputs."""
    import signal
    import tempfile

    procs = []
    for argv, env in cmds:
        f = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(argv, env=env, cwd=REPO, stdout=f,
                                       stderr=subprocess.STDOUT, start_new_session=True), f))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _ in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = []
    for p, f in procs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    rcs = [p.returncode for p, _ in procs]
    if rcs != [0] * len(procs):
        for o in outs:
            log(o[-8000:])
        raise RuntimeError(f"{label}: exit codes {rcs} (negative: killed at the {timeout} s "
                           "limit or by a signal)")
    return outs


def record_picks(proposals: list | None = None):
    """Wrap `roi_head_utils.subsample_rois` to record each frame's sampled
    roi indices and foreground flags (and with `proposals` a list, the
    proposal NMS's kept rois and flags into it); returns (list, undo)."""
    from btcdet_tpu_torch.models.roi_heads import roi_head_utils as RH

    picked, orig, orig_prop = [], RH.subsample_rois, RH.proposal_layer

    def subsample(*a, **k):
        out = orig(*a, **k)
        picked.append(tuple(t.cpu() for t in out))
        return out

    def proposal(*a, **k):
        out = orig_prop(*a, **k)
        proposals.append((out.rois.detach().cpu(), out.roi_valid.cpu()))
        return out

    RH.subsample_rois = subsample
    if proposals is not None:
        RH.proposal_layer = proposal

    def undo():
        RH.subsample_rois, RH.proposal_layer = orig, orig_prop
    return picked, undo


def host_state(net) -> dict:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def host_grads(net) -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()
            if p.grad is not None}


def dp_step_worker(io: str, proj_seeds=()):
    """A rank of the data-parallel train step (see `dp_step_phase`)."""
    import copy

    import torch

    from btcdet_tpu_torch import config, parallel
    from btcdet_tpu_torch.train import trainer
    from btcdet_tpu_torch.utils.common import resolve_device

    local = parallel.init_dist("pytorch", "gloo", timeout_s=DP_TIMEOUT_S)
    try:
        dev = resolve_device("cuda", local)
        torch.cuda.set_device(dev)
        rank, world = parallel.get_dist_info()
        out = {}
        # 1. the flagship at full width: the global batch of 2 * world frames
        net, opt, batch = train_setup(config.flagship(), 16384, 10, 0, device=dev,
                                      batch_size=2 * world)
        batch = trainer.split_batch(batch, rank, world)
        parallel.broadcast_state(net)
        if rank == 0:
            torch.save(host_state(net), os.path.join(io, "init_full.pt"))
        snap, opt_snap = copy.deepcopy(net.state_dict()), copy.deepcopy(opt.state_dict())

        def step():
            m = trainer.train_step(net, opt, batch, trainer.step_generator(0, 0, dev))
            torch.cuda.synchronize()
            return m

        reset_launches()
        metrics = {k: float(v) for k, v in step().items()}
        launches = read_launches()
        grads, state = host_grads(net), host_state(net)
        net.load_state_dict(snap)
        opt.load_state_dict(opt_snap)
        step()
        g2, s2 = host_grads(net), host_state(net)
        repeat = (sum(int((grads[n] != g2[n]).sum()) for n in grads)
                  + sum(int((state[k] != s2[k]).sum()) for k in state))
        times = []
        for _ in range(5):
            parallel.barrier()
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        ar = []
        for _ in range(5):
            torch.cuda.synchronize()
            parallel.barrier()
            t0 = time.perf_counter()
            parallel.all_reduce_grads(net)
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        out["full"] = {"metrics": metrics, "launches": launches, "grads": grads,
                       "state": state, "repeat_differ": repeat, "step_ms": times,
                       "all_reduce_ms": ar,
                       "grad_mib": sum(p.numel() * 4 for p in net.parameters()) / 2**20}
        del net, opt, batch, snap, opt_snap, g2, s2
        torch.cuda.empty_cache()

        out.update(dp_f32_cases(io, dev, rank, world, proj_seeds))
        torch.save(out, os.path.join(io, f"rank{rank}.pt"))
    finally:
        parallel.destroy()


def dp_f32_cases(io: str, dev, rank: int, world: int, proj_seeds=()) -> dict:
    """A rank's `f32_cases(proj_seeds)` steps in float32, 1 frame a rank:
    the micro config, and the flagship's widths on a 16 m scene with the
    output projections of each draw; records the rank's sampled rois,
    proposal NMS keeps, kept outputs, ball queries (`replay_ball_queries`)
    and conv-stack ReLU signs (`replay_relu_signs`)."""
    import torch

    from btcdet_tpu_torch import parallel
    from btcdet_tpu_torch.train import trainer

    out = {}
    for name, (cfg_fn, points, gts, proj_seed) in f32_cases(proj_seeds).items():
        with f32_everywhere():
            net, opt, batch = train_setup(cfg_fn(), points, gts, 3, device=dev,
                                          batch_size=world, proj_seed=proj_seed)
            batch = trainer.split_batch(batch, rank, world)
            parallel.broadcast_state(net)
            if rank == 0:
                torch.save(host_state(net), os.path.join(io, f"init_{name}.pt"))
            proposals, rec, relus = [], ball_record(), relu_record()
            picked, undo = record_picks(proposals)
            kept = dict.fromkeys(KEPT)
            try:
                with replay_ball_queries(rec, record=True), replay_relu_signs(relus, True):
                    m = trainer.train_step(net, opt, batch,
                                           torch.Generator(device=dev).manual_seed(0), keep=kept)
            finally:
                undo()
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "grads": host_grads(net), "state": host_state(net), "picked": picked,
                     "proposals": proposals, "balls": rec, "relus": relus,
                     "kept": {k: v.cpu() for k, v in kept.items()}}
        del net, opt, batch
    return out


def one_process_step(cfg, init_path, batch_size, num_points, num_gt, seed, generator,
                     f32=False, perturb=0.0, kept=None, balls=None, relus=None,
                     proposals=None):
    """The one-process train step on the card from a rank's saved initial
    weights (each float parameter times 1 + `perturb` * N(0, 1) when
    given): (metrics, gradients, state after, sampled rois); `kept`, a
    dict of output names, gets those outputs on the host; `balls`, a
    `ball_record` of the same step, is replayed (`replay_ball_queries`:
    each ball query's own answer held against the recorded one and
    replaced by it), and `relus`, a `relu_record`, likewise
    (`replay_relu_signs`); `proposals`, a list, gets the proposal NMS's
    keeps."""
    import torch

    from btcdet_tpu_torch.train import trainer

    ctx = f32_everywhere() if f32 else contextlib.nullcontext()
    with ctx:
        net, opt, batch = train_setup(cfg, num_points, num_gt, seed, device=DP_DEVICE,
                                      batch_size=batch_size)
        net.load_state_dict(torch.load(init_path, map_location=DP_DEVICE, weights_only=True))
        if perturb:
            g = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g).to(p.device))
        picked, undo = record_picks(proposals)
        try:
            with contextlib.ExitStack() as replay:
                if balls is not None:
                    replay.enter_context(replay_ball_queries(balls, record=False))
                if relus is not None:
                    replay.enter_context(replay_relu_signs(relus, record=False))
                m = trainer.train_step(net, opt, batch, generator, keep=kept)
            torch.cuda.synchronize()
        finally:
            undo()
        if kept is not None:
            kept.update({k: v.cpu() for k, v in kept.items()})
    return ({k: float(v) for k, v in m.items()}, host_grads(net), host_state(net), picked)


# the f32 comparisons of the data-parallel step with one process: (config,
# points, gt boxes a frame, the output projections' draw: None keeps the
# model's own)
def f32_cases(proj_seeds=()) -> dict:
    """The micro config, the small config with the output projections the
    model draws (the configs' own), and the small config with each draw of
    `proj_seeds` (`train_setup(proj_seed=)`)."""
    cases = {"micro": (lambda: micro_train_config(), 2048, 4, None),
             "small": (lambda: small_config(full=True), 4096, 4, None)}
    for s in proj_seeds:
        cases[f"small@proj{s}"] = (lambda: small_config(full=True), 4096, 4, int(s))
    return cases


# the draws of the small config's output projections the default run holds
# besides the model's own: on draws 1, 2, 3 and 6 the runs part by ReLU
# inputs of ConvHead's x_combine conv stack at 0 (2-4 a draw), on 3 and 6 by
# exact balls at their radius too (PERF.md, §6)
DP_PROJ_SEEDS = tuple(range(1, 11))
# the train forward's outputs each rank's frames are compared on
KEPT = ("rois", "occ_points")


def ball_record() -> dict:
    """The record `replay_ball_queries` fills and reads."""
    return {"calls": [], "flips": 0, "worst": 0.0, "moved": 0, "moved_differ": 0,
            "moved_max": 0.0, "differ": []}


# an input of a ReLU in ConvHead's x_combine conv stack within this share of
# its call's largest |input| of 0 may take either sign in two runs whose
# forwards part by f32 rounding (the data-parallel step's inputs of the
# roi head's FCs part by about 2e-6 of their max)
RELU_EDGE = 1e-5


def relu_record() -> dict:
    """The record `replay_relu_signs` fills and reads."""
    return {"calls": [], "flips": 0, "worst": 0.0, "of": 0}


@contextlib.contextmanager
def replay_relu_signs(rec: dict, record: bool):
    """The ReLUs of ConvHead's x_combine conv stack (`_conv_stack`)
    recorded (`record`) into rec["calls"]: each call's signs (input > 0)
    and the inputs within RELU_EDGE of 0 (relative to the call's largest
    |input|), on the host; or replayed: the elements whose sign differs
    from the recorded call's must lie within RELU_EDGE of 0 in both runs,
    and every element takes the recorded sign (the ReLU passes its input
    where the recorded one was positive, 0 elsewhere, and so routes the
    gradient). rec["flips"] counts the differing signs, rec["worst"] is
    their largest |input| relative to the call's largest, rec["of"] the
    inputs seen."""
    import torch

    from btcdet_tpu_torch.models.roi_heads import conv_head

    orig_stack, orig_relu = conv_head.ConvHead._conv_stack, torch.relu
    calls = iter(list(rec["calls"]))

    def near_zero(x):
        a = x.detach().abs()
        return a <= RELU_EDGE * float(a.max()), a

    def recorded(x):
        rec["calls"].append({"pos": (x > 0).cpu(), "near": near_zero(x)[0].cpu()})
        return orig_relu(x)

    def replayed(x):
        want = next(calls)
        pos = want["pos"].to(x.device)
        flip = (x > 0) != pos
        rec["of"] += x.numel()
        if bool(flip.any()):
            near, a = near_zero(x)
            assert bool((near & want["near"].to(x.device))[flip].all()), (
                "conv-stack ReLU inputs whose sign differs lie away from 0")
            rec["flips"] += int(flip.sum())
            rec["worst"] = max(rec["worst"], float(a[flip].max() / a.max()))
        return torch.where(pos, x, torch.zeros_like(x))

    def stack(self, g, m):
        torch.relu = recorded if record else replayed
        try:
            return orig_stack(self, g, m)
        finally:
            torch.relu = orig_relu

    conv_head.ConvHead._conv_stack = stack
    try:
        yield
    finally:
        conv_head.ConvHead._conv_stack = orig_stack


def merged_record(ranks, name: str) -> dict:
    """The ranks' `ball_record`s of case `name` (1 frame a rank), call by
    call, as one record of a batch of the ranks' frames in rank order."""
    import torch

    recs = [res[name]["balls"] for res in ranks]
    assert len({len(r["calls"]) for r in recs}) == 1
    assert not any(r.get("grouped") for r in recs), "grouped calls"
    out = ball_record()
    for per_rank in zip(*(r["calls"] for r in recs)):
        out["calls"].append((
            torch.cat([q for q, _ in per_rank]),
            [(torch.cat([sc[i][0] for _, sc in per_rank]),
              torch.cat([sc[i][1] for _, sc in per_rank])) for i in range(len(per_rank[0][1]))]))
    return out


def merged_relus(ranks, name: str) -> dict:
    """The ranks' `relu_record`s of case `name`, call by call, as one record
    of a batch of the ranks' frames in rank order (the conv stack's rows
    are frame-major)."""
    import torch

    recs = [res[name]["relus"]["calls"] for res in ranks]
    assert len({len(r) for r in recs}) == 1
    out = relu_record()
    out["calls"] = [{k: torch.cat([c[k] for c in per_rank]) for k in ("pos", "near")}
                    for per_rank in zip(*recs)]
    return out


def discrete_choices(ranks, name: str, picked, proposals, kept) -> dict:
    """Counts of the discrete choices that part the ranks' frames from the
    one-process step's: sampled roi indices and foreground flags, proposal
    NMS keeps (a kept row whose flag or box differs by more than 1e-4 of the
    max), occ top-k rows (more than 1e-4 of the max)."""
    import torch

    out = {"sampled_rois": 0, "nms_keeps": 0, "occ_topk": 0}
    for r, res in enumerate(ranks):
        rp = res[name]
        # subsample_rois runs frame by frame
        out["sampled_rois"] += int((rp["picked"][0][0] != picked[r][0]).sum())
        (rr, rv), (orr, orv) = rp["proposals"][0], proposals[0]
        tol = 1e-4 * max(float(orr.abs().max()), 1e-30)
        box = (rr[0] - orr[r]).abs().amax(-1) > tol
        out["nms_keeps"] += int(((rv[0] != orv[r]) | ((rv[0] | orv[r]) & box)).sum())
        occ, oocc = rp["kept"]["occ_points"][0], kept["occ_points"][r]
        out["occ_topk"] += int(((occ - oocc).abs().amax(-1)
                                > 1e-4 * max(float(oocc.abs().max()), 1e-30)).sum())
    return out


def f32_case(card: str, name: str, cfg_fn, points: int, gts: int, ranks, io: str) -> str:
    """One `f32_cases` comparison: the data-parallel step (2 ranks x 1
    frame) against one process at B=2 from the same weights, batch and
    generator. The discrete choices that part them are counted
    (`discrete_choices`, the exact ball queries whose lists differ and the
    conv-stack ReLU inputs whose sign differs); the one-process step is
    then run again with the ranks' ball queries and conv-stack ReLU signs
    replayed (each differing ball proven valid for its own query,
    `replay_ball_queries`; each differing sign's input within RELU_EDGE of
    0 in both runs, `replay_relu_signs`), and held to: the same sampled rois
    (indices and boxes) and occ points, the loss and the BN running
    statistics within 1e-5, every gradient tensor within 1e-3 of its max.
    Returns "" or what failed."""
    import torch

    init = os.path.join(io, f"init_{name}.pt")
    res = {}
    for replay in (False, True):
        kept, proposals = dict.fromkeys(KEPT), []
        rec = merged_record(ranks, name) if replay else None
        relus = merged_relus(ranks, name) if replay else None
        metrics, grads, state, picked = one_process_step(
            cfg_fn(), init, DP_WORLD, points, gts, 3,
            torch.Generator(device=DP_DEVICE).manual_seed(0), f32=True, kept=kept,
            balls=rec, relus=relus, proposals=proposals)
        g = ranks[0][name]
        assert g["grads"].keys() == grads.keys()
        res[replay] = {
            "rois_equal": all(torch.equal(rk[name]["picked"][0][i], picked[r][i])
                              for r, rk in enumerate(ranks) for i in (0, 1)),
            # each output's largest difference over the ranks' frames, relative to its max
            "outs": {k: max(float((rk[name]["kept"][k][0] - v[r]).abs().max())
                            for r, rk in enumerate(ranks)) / max(float(v.abs().max()), 1e-30)
                     for k, v in kept.items()},
            "rel": grad_distance(g["grads"], grads),
            "stats": max(float((g["state"][k] - v).abs().max()) for k, v in state.items()
                         if "running_" in k),
            "loss_rel": abs(g["metrics"]["loss"] - metrics["loss"]) / abs(metrics["loss"]),
            "choices": discrete_choices(ranks, name, picked, proposals, kept),
            "balls": rec, "relus": relus}
    before, after = res[False], res[True]
    balls, relus = after["balls"], after["relus"]
    n_balls = sum(int(e[1].numel()) for _, sc in balls["calls"] for e in sc)
    log(f"[{card}] data-parallel f32 step ({name} config, 2 ranks x 1 frame) against one "
        f"process at B=2 on the card: discrete choices that differ "
        + json.dumps(dict(after["choices"], exact_balls=balls["flips"] + balls["moved_differ"],
                          exact_balls_of=n_balls, grouped_calls=0,
                          conv_stack_relu_signs=relus["flips"], relu_inputs_of=relus["of"]))
        + f"; the differing balls, each proven valid for its own query: "
        f"{json.dumps(balls['differ'][:8])}; the point that flips lies at most "
        f"{balls['worst']:.2e} m^2 from its radius^2; the ReLU inputs whose sign differs lie "
        f"at most {relus['worst']:.2e} of their call's largest |input| from 0 (bound "
        f"{RELU_EDGE})")
    for label, r in (("own choices", before), ("the ranks' balls and ReLU signs replayed",
                                                after)):
        log(f"[{card}]   {name}, {label}: sampled roi indices equal {r['rois_equal']}; roi "
            f"boxes and occ points largest difference relative to their max "
            f"{json.dumps({k: f'{v:.3e}' for k, v in r['outs'].items()})} (bound 1e-4); loss "
            f"relative difference {r['loss_rel']:.3e}; largest BN running-statistic difference "
            f"{r['stats']:.3e} (bound 1e-5); gradient difference relative to each tensor's max: "
            f"largest {max(r['rel'].values()):.3e} over {len(r['rel'])} tensors (bound 1e-3), "
            f"worst 8 " + json.dumps(worst_of(r["rel"])))
    r = after
    fails = []
    if not (r["rois_equal"] and max(r["outs"].values()) <= 1e-4):
        fails.append(f"rois / outputs {r['outs']}")
    if r["loss_rel"] > 1e-5:
        fails.append(f"loss {r['loss_rel']:.3e}")
    if r["stats"] > 1e-5:
        fails.append(f"BN statistics {r['stats']:.3e}")
    if max(r["rel"].values()) > 1e-3:
        fails.append(f"gradients {worst_of(r['rel'], 3)}")
    return f"{name}: " + "; ".join(fails) if fails else ""


def grad_distance(grads, ref) -> dict:
    """{tensor: max |grads - ref| / max |ref|}."""
    return {n: float((grads[n] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for n, r in ref.items()}


def worst_of(rel: dict, k: int = 8) -> dict:
    return {n: f"{v:.3e}" for n, v in sorted(rel.items(), key=lambda kv: -kv[1])[:k]}


def group_distance(grads, ref) -> dict:
    """GRAD_GROUPS' largest difference, relative to the group's max."""
    out = {}
    for group in GRAD_GROUPS:
        names = [n for n in ref if n.startswith(group)]
        top = max(float(ref[n].abs().max()) for n in names)
        diff = max(float((grads[n] - ref[n]).abs().max()) for n in names)
        out[group.rstrip(".")] = f"{diff / max(top, 1e-30):.3e}"
    return out


def dp_step_phase(card: str, proj_seeds=DP_PROJ_SEEDS):
    """Seventh path, parts 1 and 2: 2 ranks over gloo, both on cuda:0.
    1. The flagship train step at full width (train caps), 2 frames a
    rank of a synthetic B=4 batch, from the same synthetic weights:
    the all-reduced gradients and the parameters after the step equal on
    both ranks bit for bit, a repeat of the step the same bits, each
    rank's launches TRAIN_LAUNCHES, the loss finite; the median step ms
    and the gradient all-reduce's ms; the loss's and each gradient
    group's relative distance from the one-process B=4 step.
    2. `f32_cases(proj_seeds)` in float32, 1 frame a rank, against one
    process at B=2 (`f32_case`): the discrete choices that part them
    counted, then with the ranks' ball queries and conv-stack ReLU signs
    replayed (each differing one proven valid) the same sampled rois, every
    gradient within 1e-3 of its tensor's max, the BN running statistics
    within 1e-5."""
    import tempfile

    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as io:
        port = free_port()
        run_group([(SELF + ["--dp-worker", "step", io, *map(str, proj_seeds)],
                    rank_env(r, DP_WORLD, port)) for r in range(DP_WORLD)],
                  "data-parallel step ranks")
        ranks = [torch.load(os.path.join(io, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
        a, b = ranks[0]["full"], ranks[1]["full"]
        for r, res in enumerate(ranks):
            f = res["full"]
            assert f["launches"] == TRAIN_LAUNCHES, (r, f["launches"])
            assert f["repeat_differ"] == 0, (r, f["repeat_differ"])
            assert all(math.isfinite(v) for v in f["metrics"].values()), f["metrics"]
        grad_differ = sum(int((a["grads"][n] != b["grads"][n]).sum()) for n in a["grads"])
        state_differ = sum(int((a["state"][k] != b["state"][k]).sum()) for k in a["state"])
        assert a["grads"].keys() == b["grads"].keys() and grad_differ == 0, grad_differ
        assert state_differ == 0 and a["metrics"] == b["metrics"], state_differ
        log(f"[{card}] data-parallel flagship step (2 ranks x 2 frames of a B=4 batch, gloo, "
            f"both on cuda:0): launches a rank {json.dumps(a['launches'])} (TRAIN_LAUNCHES); "
            f"all-reduced gradients equal on both ranks ({len(a['grads'])} tensors, 0 elements "
            f"differ), parameters and BN statistics after the step equal (0 of "
            f"{sum(v.numel() for v in a['state'].values())} elements differ), the step repeated "
            f"from the same state gives the same bits on both ranks; loss "
            f"{a['metrics']['loss']:.6f}")
        log(f"[{card}] 2 ranks sharing one H100 over gloo (no scaling figure): step ms median "
            f"{statistics.median(a['step_ms']):.2f} (rank 0 {[round(v, 2) for v in a['step_ms']]},"
            f" rank 1 {[round(v, 2) for v in b['step_ms']]}); gradient all-reduce alone "
            f"({a['grad_mib']:.1f} MiB f32) median {statistics.median(a['all_reduce_ms']):.2f} "
            f"ms (all {[round(v, 2) for v in a['all_reduce_ms']]})")

        metrics, grads, _, _ = one_process_step(
            config.flagship(), os.path.join(io, "init_full.pt"), 2 * DP_WORLD, 16384, 10, 0,
            trainer.step_generator(0, 0, DP_DEVICE))
        loss_rel = abs(a["metrics"]["loss"] - metrics["loss"]) / abs(metrics["loss"])
        log(f"[{card}] data-parallel flagship step against the one-process B=4 step on the "
            f"card (bf16, same weights, batch and generator): loss {metrics['loss']:.6f}, "
            f"relative difference {loss_rel:.3e}; gradient difference by group, relative to the "
            f"group's max: " + json.dumps(group_distance(a["grads"], grads)))
        cmetrics, cgrads, _, _ = one_process_step(
            config.flagship(), os.path.join(io, "init_full.pt"), 2 * DP_WORLD, 16384, 10, 0,
            trainer.step_generator(0, 0, DP_DEVICE), perturb=1e-7)
        log(f"[{card}] control: the one-process B=4 step from weights moved by 1e-7 relative: "
            f"loss relative difference "
            f"{abs(cmetrics['loss'] - metrics['loss']) / abs(metrics['loss']):.3e}; gradient "
            f"difference by group: " + json.dumps(group_distance(cgrads, grads)))
        assert math.isfinite(loss_rel), loss_rel

        fails = [f32_case(card, name, cfg_fn, points, gts, ranks, io)
                 for name, (cfg_fn, points, gts, _) in f32_cases(proj_seeds).items()]
        assert not any(fails), [f for f in fails if f]
    log(f"[{card}] seventh path, data-parallel steps: {time.perf_counter() - t0:.1f} s")


def dp_cli_worker(task: str, io: str, argv: list):
    """A torchrun rank running a CLI's `main(argv)` in process: `train_cli`
    (`train_cli_cut`: stopped after the first epoch's checkpoint) records
    every step's launches and loss and the trailing eval; `eval_cli` the
    merged det_annos, the result and the launches."""
    import pickle

    name = "train_torch" if task.startswith("train") else "test_torch"
    cli = load_tool(name)
    rank = int(os.environ["RANK"])
    rec = {"steps": []}
    reset_launches()
    if name == "train_torch":
        def on_step(gstep, batch, metrics):
            rec["steps"].append((gstep, read_launches(), float(metrics["loss"])))
            reset_launches()

        res = cli.main(argv, on_step=on_step,
                       on_epoch_end=(lambda e, s: True) if task == "train_cli_cut" else None)
        rec.update({k: res[k] for k in ("start_step", "steps_run", "stopped", "eval")})
    else:
        (run,) = cli.main(argv)
        rec.update(annos=run[3], result={k: v for k, v in run[2].items() if k.startswith("Car_")})
    rec["launches_after"] = read_launches()
    with open(os.path.join(io, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)


def _read_ranks(io: str, n: int = DP_WORLD) -> list:
    import pickle

    out = []
    for r in range(n):
        with open(os.path.join(io, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def dp_train_cli(card: str, root, tmp):
    """Seventh path, part 3: `tools/train_torch.py --launcher pytorch
    --dist_backend gloo` under torchrun, 2 ranks on cuda:0, on the sixth
    path's tree and the flagship yaml (2 frames and 2 loader workers a
    rank, 2 steps an epoch): an epoch cut after its checkpoint, beside it
    the 4 steps straight; then a run that resumes the cut one and
    evaluates the step-4 checkpoint over both ranks, beside it one rank
    over NCCL for 2 steps. Every step's launches TRAIN_LAUNCHES on each
    rank, each checkpoint written once, the resumed checkpoint equal to
    the straight one."""
    from pathlib import Path

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import checkpoint

    t0 = time.perf_counter()

    def argv(out, *extra):
        return ["--cfg_file", str(config.FLAGSHIP_CFG), "--batch_size", "2", "--workers", "2",
                "--epochs", "2", "--steps", "2", "--launcher", "pytorch", "--output_dir",
                str(out), *extra, "--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False",
                "DATA_CONFIG.DATA_PATH", str(root)]

    resumed, straight = Path(tmp) / "dp_resumed", Path(tmp) / "dp_straight"
    nccl = Path(tmp) / "dp_nccl"
    # the straight run goes beside the cut run, the NCCL rank beside the
    # resumed run: each pair shares the card, each run its own group
    side = {"train_cli_cut": (torchrun_argv(DP_WORLD, "tools/train_torch.py",
                                            *argv(straight, "--dist_backend", "gloo",
                                                  "--num_epochs_to_eval", "0")),
                              dict(os.environ)),
            "train_cli": (torchrun_argv(1, "tools/train_torch.py",
                                        *argv(nccl, "--dist_backend", "nccl", "--epochs", "1",
                                              "--num_epochs_to_eval", "0")),
                          dict(os.environ))}
    runs, nccl_out = {}, None
    for task, extra in (("train_cli_cut", ("--num_epochs_to_eval", "0")),
                        ("train_cli", ("--num_epochs_to_eval", "1"))):
        io = Path(tmp) / f"io_{task}"
        io.mkdir()
        outs = run_group([(torchrun_argv(DP_WORLD, SELF[1], "--dp-worker", task, io,
                                         *argv(resumed, "--dist_backend", "gloo", *extra)),
                           dict(os.environ)), side[task]], f"torchrun {task} and its side run")
        runs[task] = _read_ranks(str(io))
        if task == "train_cli_cut":
            assert checkpoint.CheckpointManager(resumed / "ckpt").all_steps() == [2]
        else:
            nccl_out = outs[1]
    for task, want_steps in (("train_cli_cut", [0, 1]), ("train_cli", [2, 3])):
        for r, rec in enumerate(runs[task]):
            assert [s for s, _, _ in rec["steps"]] == want_steps, (task, r, rec["steps"])
            for s, launches, loss in rec["steps"]:
                assert launches == TRAIN_LAUNCHES and math.isfinite(loss), (task, r, s, launches)
    cut, res = runs["train_cli_cut"], runs["train_cli"]
    assert all(c["stopped"] and c["steps_run"] == 2 for c in cut), cut
    assert all(c["start_step"] == 2 and c["steps_run"] == 2 for c in res), res
    # the logged losses are the global batch's: the same on both ranks
    assert cut[0]["steps"] == cut[1]["steps"] and res[0]["steps"] == res[1]["steps"]
    (step, result), = res[0]["eval"]
    assert step == 4 and res[1]["eval"][0][0] == 4
    ap = {k: float(v) for k, v in result.items() if k.startswith("Car_")}
    ap1 = {k: float(v) for k, v in res[1]["eval"][0][1].items() if k.startswith("Car_")}
    assert len(ap) >= 18 and ap == ap1 and all(math.isfinite(v) for v in ap.values()), ap
    for r, rec in enumerate(res):
        assert rec["launches_after"] == EVAL_LAUNCHES, (r, rec["launches_after"])
    text = "".join(p.read_text() for p in resumed.glob("train_*.log"))
    saves = {s: text.count(f"saved checkpoint at step {s}") for s in (2, 4)}
    assert saves == {2: 1, 4: 1}, saves
    assert "eval: 4 frames over 2 rank(s)" in text and "auto-resumed from step 2" in text
    log(f"[{card}] data-parallel train CLI under torchrun (2 ranks, gloo, cuda:0): cut after "
        f"step 2, resumed at step 2 for 2 steps on both ranks; every step's launches "
        f"TRAIN_LAUNCHES on each rank; losses (step, rank 0) "
        f"{[(s, round(l, 5)) for s, _, l in cut[0]['steps'] + res[0]['steps']]}; checkpoints "
        f"written once a save {saves}; trailing eval of step 4 over both ranks (4 frames, one "
        f"forward a rank, launches EVAL_LAUNCHES a rank): {len(ap)} finite AP keys, equal on "
        f"both ranks")

    a = checkpoint.load_file(checkpoint.CheckpointManager(resumed / "ckpt").path(4))
    b = checkpoint.load_file(checkpoint.CheckpointManager(straight / "ckpt").path(4))
    diffs = {}
    for part in ("model_state", "optimizer_state"):
        flat_a, flat_b = flatten_tensors(a[part]), flatten_tensors(b[part])
        assert flat_a.keys() == flat_b.keys(), part
        diffs[part] = {"tensors": len(flat_a),
                       "elements_differ": sum(int((flat_a[k] != flat_b[k]).sum())
                                              for k in flat_a)}
    log(f"[{card}] data-parallel train CLI, resumed (2 + 2 steps) against straight (4 steps), "
        f"step-4 checkpoints: " + json.dumps(diffs))
    assert all(d["elements_differ"] == 0 for d in diffs.values()), diffs

    text = "".join(p.read_text() for p in nccl.glob("train_*.log"))
    assert "data parallel: 1 ranks over pytorch" in text and "epoch 0 it 1/2" in text, \
        nccl_out[-3000:]
    assert checkpoint.CheckpointManager(nccl / "ckpt").all_steps() == [2]
    log(f"[{card}] train CLI under torchrun, one rank over NCCL: 2 steps, checkpoint at step 2")
    log(f"[{card}] seventh path, train CLI under torchrun: {time.perf_counter() - t0:.1f} s")


def dp_eval_cli(card: str, root, pth, tmp, annos, result):
    """Seventh path, part 4: `tools/test_torch.py --launcher pytorch` with
    2 ranks on cuda:0 over the fourth path's tree (2 frames a rank, as the
    fourth path's one process): the merged det_annos, in frame order,
    equal to the one-process run's bit for bit, the AP equal, each rank's
    launches EVAL_LAUNCHES per forward."""
    from pathlib import Path

    import numpy as np

    from btcdet_tpu_torch import config

    t0 = time.perf_counter()
    io = Path(tmp) / "io_eval"
    io.mkdir()
    run_group([(torchrun_argv(DP_WORLD, SELF[1], "--dp-worker", "eval_cli", io,
                              "--cfg_file", config.FLAGSHIP_CFG, "--ckpt", pth, "--batch_size",
                              "2", "--workers", "2", "--launcher", "pytorch", "--dist_backend",
                              "gloo", "--output_dir", Path(tmp) / "dp_eval", "--set",
                              "MODEL.ROI_HEAD.APPROX_QUERY", "False", "DATA_CONFIG.DATA_PATH",
                              root), dict(os.environ))], "torchrun eval CLI")
    forwards = len(annos) // (2 * DP_WORLD)
    ap = {k: float(v) for k, v in result.items() if k.startswith("Car_")}
    for r, rec in enumerate(_read_ranks(str(io))):
        assert rec["launches_after"] == {k: v * forwards for k, v in EVAL_LAUNCHES.items()}, (
            r, rec["launches_after"])
        assert [a["frame_id"] for a in rec["annos"]] == [a["frame_id"] for a in annos], r
        for got, want in zip(rec["annos"], annos):
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), (r, want["frame_id"], k)
        assert {k: float(v) for k, v in rec["result"].items()} == ap, r
    log(f"[{card}] data-parallel eval CLI under torchrun (2 ranks, gloo, cuda:0, 2 frames a "
        f"rank): the merged det_annos of {len(annos)} frames equal the one-process run's bit "
        f"for bit, in frame order, the {len(ap)} AP keys equal; {forwards} forwards a rank, "
        f"launches EVAL_LAUNCHES each; {time.perf_counter() - t0:.1f} s")


# ---------------------------------------- eleventh path: BEV row sharding

SP_WORLD = 2                 # the flagship's grid on the card: dp 1 x sp 2
SP_MICRO_GRID = (2, 2)       # the micro config's grid: dp 2 x sp 2
BEV_BN = "det_modules.backbone_2d."
# the parameters the BEV pyramid's backward reaches
BEV_UPSTREAM = ("det_modules.backbone_2d.", "det_modules.backbone_3d.")
# the float32 train forward's outputs the row-sharded step is compared on
SP_KEPT = ("spatial_features_2d", "rois")
# kernels every rank of a row-sharded train step launches
SP_LAUNCHED = ("neighbor_map", "sparse_conv", "sparse_conv_df", "sparse_conv_dw",
               "sparse_pool", "trilinear_pool", "trilinear_pool_grad")


def sp_flagship_worker(io: str):
    """A rank of the flagship's dp 1 x sp 2 grid (see `sp_path`): the
    row-sharded flagship's bf16 train step and eval forward + post (the
    main path: counted, then timed with the BEV stage and the collectives
    broken out), then its train step in float32."""
    import torch

    from btcdet_tpu_torch import config, parallel, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing
    from btcdet_tpu_torch.parallel import spatial
    from btcdet_tpu_torch.train import trainer
    from btcdet_tpu_torch.utils.common import resolve_device

    local = parallel.init_dist("pytorch", "gloo", timeout_s=DP_TIMEOUT_S, sp=SP_WORLD)
    try:
        dev = resolve_device("cuda", local)
        torch.cuda.set_device(dev)
        rank = parallel.get_sp_info()[0]
        cfg = config.flagship()
        net, opt, batch = train_setup(cfg, 16384, 10, 0, device=dev, batch_size=2,
                                      bev_sharding=True)
        parallel.broadcast_state(net)
        if rank == 0:
            torch.save(host_state(net), os.path.join(io, "init.pt"))

        def step():
            m = trainer.train_step(net, opt, batch, trainer.step_generator(0, 0, dev))
            torch.cuda.synchronize()
            return m

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = {"metrics": {k: float(v) for k, v in step().items()},
               "train_launches": read_launches()}
        out.update(grads=host_grads(net), state=host_state(net),
                   train_peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        times = []
        for _ in range(5):
            parallel.barrier()
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = times
        spatial.COMM_MS = {}
        out["train_stage_ms"] = synced_stage_ms(step)
        out["train_comm_ms"] = spatial.COMM_MS

        net.load_state_dict(weights.synth_state_dict(net))   # the main path's weights
        net.eval()
        spatial.COMM_MS = None
        ebatch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384,
                                      num_gt=10, seed=0, mode="test", device=dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        post = post_processing(net(ebatch), cfg.MODEL.POST_PROCESSING, 1, device=dev)
        torch.cuda.synchronize()
        out["eval_launches"] = read_launches()
        out["post"] = {k: v.cpu() for k, v in post.items()}
        out["eval_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        parallel.barrier()
        out["eval_ms"] = timed_median(lambda: forward_post(net, ebatch, cfg))
        spatial.COMM_MS = {}
        out["eval_stage_ms"] = synced_stage_ms(lambda: forward_post(net, ebatch, cfg))
        out["eval_comm_ms"] = spatial.COMM_MS
        spatial.COMM_MS = None
        del net, opt, batch, ebatch
        torch.cuda.empty_cache()

        with f32_everywhere():
            net, opt, batch = train_setup(cfg, 16384, 10, 0, device=dev, batch_size=2,
                                          bev_sharding=True)
            net.load_state_dict(torch.load(os.path.join(io, "init.pt"), map_location=dev,
                                           weights_only=True))
            kept = dict.fromkeys(SP_KEPT)
            m = trainer.train_step(net, opt, batch, trainer.step_generator(0, 0, dev),
                                   keep=kept)
            torch.cuda.synchronize()
        out["f32"] = {"metrics": {k: float(v) for k, v in m.items()},
                      "grads": host_grads(net), "state": host_state(net),
                      "kept": {k: v.cpu() for k, v in kept.items()}}
        torch.save(out, os.path.join(io, f"rank{rank}.pt"))
    finally:
        parallel.destroy()


def sp_micro_worker(io: str):
    """A rank of the micro config's dp 2 x sp 2 grid: one float32 train
    step of 2 frames a dp rank (see `sp_path`)."""
    import torch
    import torch.distributed as tdist

    from btcdet_tpu_torch import parallel
    from btcdet_tpu_torch.train import trainer
    from btcdet_tpu_torch.utils.common import resolve_device

    local = parallel.init_dist("pytorch", "gloo", timeout_s=DP_TIMEOUT_S, sp=SP_MICRO_GRID[1])
    try:
        dev = resolve_device("cuda", local)
        torch.cuda.set_device(dev)
        rank, (d, dp) = tdist.get_rank(), parallel.get_dist_info()
        with f32_everywhere():
            net, opt, batch = train_setup(micro_train_config(), 2048, 4, 3, device=dev,
                                          batch_size=2 * dp, bev_sharding=True)
            batch = trainer.split_batch(batch, d, dp)
            parallel.broadcast_state(net)
            if rank == 0:
                torch.save(host_state(net), os.path.join(io, "init_micro.pt"))
            picked, undo = record_picks()
            reset_launches()
            try:
                m = trainer.train_step(net, opt, batch,
                                       torch.Generator(device=dev).manual_seed(0))
                torch.cuda.synchronize()
            finally:
                undo()
        torch.save({"metrics": {k: float(v) for k, v in m.items()}, "launches": read_launches(),
                    "grads": host_grads(net), "state": host_state(net), "picked": picked,
                    "grid": (d, parallel.get_sp_info()[0])},
                   os.path.join(io, f"micro{rank}.pt"))
    finally:
        parallel.destroy()


def bev_bn_distance(state, ref) -> float:
    return max(float((state[k] - v).abs().max()) for k, v in ref.items()
               if k.startswith(BEV_BN) and "running_" in k)


def one_flagship_run(init: str, f32: bool, perturb: float = 0.0) -> dict:
    """The one-process flagship on the card: its train step from the
    weights at `init` (each float parameter times 1 + `perturb` * N(0, 1)
    when given; metrics, gradients, state; f32: the SP_KEPT outputs;
    bf16: the step's median ms and the BEV stage's ms) and, in bf16, its
    eval forward + post from the main path's synthetic weights
    (detections, median ms, BEV stage ms)."""
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing
    from btcdet_tpu_torch.train import trainer

    cfg = config.flagship()
    out = {}
    with f32_everywhere() if f32 else contextlib.nullcontext():
        net, opt, batch = train_setup(cfg, 16384, 10, 0, device=DP_DEVICE, batch_size=2)
        net.load_state_dict(torch.load(init, map_location=DP_DEVICE, weights_only=True))
        if perturb:
            g = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g).to(p.device))
        kept = dict.fromkeys(SP_KEPT)

        def step():
            m = trainer.train_step(net, opt, batch, trainer.step_generator(0, 0, DP_DEVICE),
                                   keep=kept)
            torch.cuda.synchronize()
            return m

        out["metrics"] = {k: float(v) for k, v in step().items()}
        out["grads"], out["state"] = host_grads(net), host_state(net)
        out["kept"] = {k: v.cpu() for k, v in kept.items()}
    if f32:
        return out
    out["step_ms"] = timed_median(step)[0]
    out["train_bev_ms"] = synced_stage_ms(step)["bev"]
    net.load_state_dict(weights.synth_state_dict(net))
    net.eval()
    ebatch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                  seed=0, mode="test")
    out["post"] = {k: v.cpu() for k, v in post_processing(
        net(ebatch), cfg.MODEL.POST_PROCESSING, 1).items()}
    out["eval_ms"] = timed_median(lambda: forward_post(net, ebatch, cfg))[0]
    out["eval_bev_ms"] = synced_stage_ms(lambda: forward_post(net, ebatch, cfg))["bev"]
    return out


def bev_bn_distance(state, ref) -> float:
    return max(float((state[k] - v).abs().max()) for k, v in ref.items()
               if k.startswith(BEV_BN) and "running_" in k)


def step_distance(res: dict, one: dict) -> tuple:
    """(largest loss-term relative difference, {tensor: gradient
    difference relative to its max}, BEV BN running-statistic difference)
    of a rank's step from the one-process step."""
    metric = max(abs(res["metrics"][k] - v) / max(abs(v), 1e-30)
                 for k, v in one["metrics"].items() if not k.startswith("grad_norm"))
    return metric, grad_distance(res["grads"], one["grads"]), bev_bn_distance(res["state"],
                                                                               one["state"])


def sp_path(card: str):
    """Eleventh path: BEV row sharding on the card (see the module
    docstring, 8f). Two ranks on one card give no scaling figure."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as io:
        port = free_port()
        run_group([(SELF + ["--dp-worker", "sp", io], rank_env(r, SP_WORLD, port))
                   for r in range(SP_WORLD)], "row-sharded flagship ranks")
        ranks = [torch.load(os.path.join(io, f"rank{r}.pt"), weights_only=False)
                 for r in range(SP_WORLD)]
        a = ranks[0]
        for r, res in enumerate(ranks):
            assert res["train_launches"] == TRAIN_LAUNCHES, (r, res["train_launches"])
            assert res["eval_launches"] == EVAL_LAUNCHES, (r, res["eval_launches"])
            assert all(math.isfinite(v) for v in res["metrics"].values()), res["metrics"]
            assert res["metrics"] == a["metrics"], r
            for part in ("grads", "state", "post"):
                differ = sum(int((res[part][k] != a[part][k]).sum()) for k in a[part])
                assert res[part].keys() == a[part].keys() and differ == 0, (r, part, differ)
        log(f"[{card}] row-sharded flagship (dp 1 x sp 2: 2 ranks over gloo on cuda:0, each "
            f"rank half the BEV rows of both frames), launches a rank: train step "
            f"{json.dumps(a['train_launches'])} (TRAIN_LAUNCHES), eval forward + post "
            f"{json.dumps(a['eval_launches'])} (EVAL_LAUNCHES); gradients, state and "
            f"detections equal on both ranks bit for bit")

        init = os.path.join(io, "init.pt")
        one = one_flagship_run(init, f32=False)
        metric, rel, bn = step_distance(a, one)
        post = one["post"]
        same_kept = torch.equal(a["post"]["pred_valid"], post["pred_valid"])
        labels = torch.equal(a["post"]["pred_labels"], post["pred_labels"])
        det = max(float((a["post"][k] - post[k]).abs().max())
                  for k in ("pred_boxes", "pred_scores"))
        log(f"[{card}] row-sharded flagship (bf16, the main path) against one process on the "
            f"card (B=2, same weights, batch and generator): train step loss "
            f"{one['metrics']['loss']:.6f}, loss terms' largest relative difference "
            f"{metric:.3e} (bound 1e-4); BEV BN running statistics largest difference "
            f"{bn:.3e} (bound 1e-5); gradient difference relative to each tensor's max by "
            f"group {json.dumps(group_distance(a['grads'], one['grads']))} (0 outside the "
            f"pyramid's backward; inside it the slabs' dW and the halo rows' dX are bf16 "
            f"partial sums rounded apart, held in float32 below); eval detections: "
            f"kept slots equal {same_kept}, labels equal {labels}, largest box / score "
            f"difference {det:.3e} (bound 1e-5), {int(post['pred_valid'].sum())} detections")
        comm = {k: round(v, 3) for k, v in a["train_comm_ms"].items()}
        ecomm = {k: round(v, 3) for k, v in a["eval_comm_ms"].items()}
        log(f"[{card}] 2 ranks sharing one H100 over gloo (no scaling figure): train step ms "
            f"median {statistics.median(a['step_ms']):.2f} (rank 0 "
            f"{[round(v, 2) for v in a['step_ms']]}, rank 1 "
            f"{[round(v, 2) for v in ranks[1]['step_ms']]}) against one process "
            f"{one['step_ms']:.2f}; eval forward + post ms median {a['eval_ms'][0]:.2f} "
            f"against one process {one['eval_ms']:.2f}; BEV stage ms (synchronised, forward) "
            f"a rank: train {[round(r['train_stage_ms']['bev'], 3) for r in ranks]}, eval "
            f"{[round(r['eval_stage_ms']['bev'], 3) for r in ranks]}, one process: train "
            f"{one['train_bev_ms']:.3f}, eval {one['eval_bev_ms']:.3f}; collectives a step "
            f"(rank 0, synchronised ms by kind: halo exchange, the row take's backward "
            f"gather, the output gather): train {json.dumps(comm)}, eval {json.dumps(ecomm)}; "
            f"peak MiB a rank: train {[round(r['train_peak_mib'], 1) for r in ranks]}, eval "
            f"{[round(r['eval_peak_mib'], 1) for r in ranks]}")
        assert metric <= 1e-4 and bn <= 1e-5, (metric, bn)
        assert same_kept and labels and det <= 1e-5, (same_kept, labels, det)
        assert int(post["pred_valid"].sum()) > 0
        # the forward is the one process's bit for bit, so every gradient the
        # BEV backward does not reach is too
        outside = {n: v for n, v in rel.items() if not n.startswith(BEV_UPSTREAM)}
        assert max(outside.values()) == 0.0, worst_of(outside)
        del one

        one = one_flagship_run(init, f32=True)
        again = one_flagship_run(init, f32=True)
        ctrl = one_flagship_run(init, f32=True, perturb=1e-7)
        b = ranks[1]["f32"]
        log(f"[{card}] float32 flagship steps, run to run: rank 1 against rank 0, loss "
            f"terms' largest relative difference {step_distance(b, a['f32'])[0]:.3e}, "
            f"gradients by group {json.dumps(group_distance(b['grads'], a['f32']['grads']))}; "
            f"the one-process step repeated, {step_distance(again, one)[0]:.3e}, by group "
            f"{json.dumps(group_distance(again['grads'], one['grads']))}")
        metric, rel, bn = step_distance(a["f32"], one)
        kept = {k: float((a["f32"]["kept"][k] - v).abs().max()) / max(float(v.abs().max()),
                                                                      1e-30)
                for k, v in one["kept"].items()}
        groups = group_distance(a["f32"]["grads"], one["grads"])
        control = grad_distance(ctrl["grads"], one["grads"])
        log(f"[{card}] row-sharded flagship in float32 against one process on the card: loss "
            f"terms' largest relative difference {metric:.3e} (bound 1e-4); BEV map and rois, "
            f"largest difference relative to their max "
            f"{json.dumps({k: f'{v:.3e}' for k, v in kept.items()})}; gradient difference "
            f"relative to the group's max {json.dumps(groups)} (bound 1e-3), relative to each "
            f"tensor's max: worst 8 {json.dumps(worst_of(rel))}; control, the one-process "
            f"step from weights moved by 1e-7 relative: by group "
            f"{json.dumps(group_distance(ctrl['grads'], one['grads']))}, worst 8 "
            f"{json.dumps(worst_of(control))}; BEV BN running statistics largest difference "
            f"{bn:.3e} (bound 1e-5)")
        assert metric <= 1e-4 and bn <= 1e-5, (metric, bn)
        # a float32 flagship step moves single small tensors by up to 1e-1 of
        # their max under a 1e-7 change of the weights (the control), so the
        # bound is taken over each group of GRAD_GROUPS, as the seventh path's
        assert max(float(v) for v in groups.values()) <= 1e-3, groups
        del one, again, ctrl

        # the micro config on a dp 2 x sp 2 grid in float32
        dp, sp = SP_MICRO_GRID
        port = free_port()
        run_group([(SELF + ["--dp-worker", "sp_micro", io], rank_env(r, dp * sp, port))
                   for r in range(dp * sp)], "micro dp x sp ranks")
        micro = [torch.load(os.path.join(io, f"micro{r}.pt"), weights_only=False)
                 for r in range(dp * sp)]
        mm, mgrads, mstate, mpicked = one_process_step(
            micro_train_config(), os.path.join(io, "init_micro.pt"), 2 * dp, 2048, 4, 3,
            torch.Generator(device=DP_DEVICE).manual_seed(0), f32=True)
        worst = {}
        for r, res in enumerate(micro):
            d = res["grid"][0]
            assert all(res["launches"][k] > 0 for k in SP_LAUNCHED), (r, res["launches"])
            for i, (sampled, fg) in enumerate(res["picked"]):
                assert torch.equal(sampled, mpicked[2 * d + i][0]), (r, i)
                assert torch.equal(fg, mpicked[2 * d + i][1]), (r, i)
            worst[r] = step_distance(res, {"metrics": mm, "grads": mgrads, "state": mstate})
        log(f"[{card}] micro config, dp 2 x sp 2 (4 ranks over gloo on cuda:0), float32, "
            f"against one process at B=4: per rank (loss terms' largest relative difference, "
            f"largest gradient difference relative to its tensor's max, BEV BN running-"
            f"statistic difference) "
            + json.dumps({r: [f"{m:.3e}", f"{max(g.values()):.3e}", f"{b:.3e}"]
                          for r, (m, g, b) in worst.items()})
            + f"; launches a rank {json.dumps(micro[0]['launches'])}")
        for r, (m, g, b) in worst.items():
            assert m <= 1e-4 and max(g.values()) <= 1e-3 and b <= 1e-5, (r, m, worst_of(g), b)
    log(f"[{card}] eleventh path, BEV row sharding: {time.perf_counter() - t0:.1f} s")
    return {"train": a["train_launches"], "eval": a["eval_launches"]}


# --------------------- twelfth path: the roi-grouped approximate ball query

# f32 rounding of |c|^2 + |x|^2 - 2 c.x: within D2_ROUND_U * (|c| + |x|)^2
# of its exact value (u = 2^-24, eight roundings), whatever order either
# device sums it in. The query checks prove a differing entry valid within it.
D2_ROUND_U = 8 * 2.0 ** -24
# the SA module's pooled features on the card against the CPU on the same
# inputs and neighbours: bf16 MLPs (two layers, each rounding its output to
# bf16 once) to this share of the output's max; f32 copies to 1e-4
SA_BF16_TOL = 2.0 ** -5


def grouped_answer(new_xyz, centers, out) -> tuple:
    """(grid points, roi centres, cand, [(cpos, empty)...]) of one
    `multi_ball_query_grouped_cand` call, on the CPU."""
    scales, cand, _, _ = out
    return (new_xyz.detach().cpu(), centers.detach().cpu(), cand.cpu(),
            [(p.cpu(), e.cpu()) for p, e in scales])


def grouped_stats() -> dict:
    return {"rois": 0, "rois_differ": 0, "rois_reordered": 0, "cut_m2": 0.0, "cut_bound_m2": 0.0,
            "balls": 0, "balls_differ": 0, "balls_differ_same_cands": 0, "edge_m2": 0.0}


def _d2_and_bound(pts64, q64):
    """float64 d^2 of every point from q and its f32 rounding bound."""
    d2 = ((pts64 - q64) ** 2).sum(-1)
    return d2, D2_ROUND_U * (pts64.norm(dim=-1) + q64.norm()) ** 2


def grouped_query_diff(pts, mask, a, b, radii, stats: dict):
    """Two answers `a`, `b` (`grouped_answer`) of the roi-grouped query on
    the point table (pts (B, N, 3), mask (B, N)), each for its own grid
    points and roi centres. Where a roi's candidate sets differ, each list
    must be valid for its own centre in float64: every valid point nearer
    than the cut (the ck-th valid distance) less its rounding bound listed,
    every listed point within the cut plus its bound (all valid points where
    there are at most ck). Where a grid point's ball (as point indices)
    differs, each must be valid among its own candidates (`ball_list_valid`,
    within each point's f32 rounding bound). Counts into `stats`
    (`grouped_stats`): rois, rois_differ (as sets), rois_reordered (same
    set, other order), cut_m2 (largest distance from the cut of a differing
    member) beside cut_bound_m2 (its bound), balls, balls_differ, and of
    those balls_differ_same_cands with edge_m2, the largest distance from
    its radius^2 of a point that flipped."""
    import torch

    from btcdet_tpu_torch.ops import group_ops

    pts64 = pts.double()
    B, R, ck = a[2].shape
    G = a[0].shape[1] // R
    stats["rois"] += B * R
    same_cands = torch.ones(B, R, dtype=torch.bool)
    for f, r in (a[2] != b[2]).any(-1).nonzero().tolist():
        sets = [set(side[2][f, r].tolist()) for side in (a, b)]
        if sets[0] == sets[1]:
            stats["rois_reordered"] += 1
            continue
        same_cands[f, r] = False
        stats["rois_differ"] += 1
        valid = mask[f].nonzero()[:, 0]
        for side, own, other in ((a, sets[0], sets[1]), (b, sets[1], sets[0])):
            d2, eps = _d2_and_bound(pts64[f], side[1][f, r].double())
            listed = {i for i in own if mask[f, i]}
            if valid.numel() <= ck:
                assert listed == set(valid.tolist()), ("roi candidates", f, r)
                continue
            cut = float(d2[valid].kthvalue(ck).values)
            sure = set((mask[f] & (d2 < cut - eps)).nonzero()[:, 0].tolist())
            assert sure <= listed and all(float(d2[i]) <= cut + float(eps[i]) for i in listed), (
                f"roi {r} of frame {f}: its {ck} candidates are no nearest-{ck} list within "
                "the f32 rounding of the cut")
            for i in own - other:
                if abs(float(d2[i]) - cut) > stats["cut_m2"]:
                    stats["cut_m2"], stats["cut_bound_m2"] = abs(float(d2[i]) - cut), float(eps[i])
    rows = torch.arange(R).repeat_interleave(G)
    for (pa, ea), (pb, eb), (lo, hi) in zip(a[3], b[3], group_ops._radii2(radii)):
        ia = torch.gather(a[2][:, rows], -1, pa)
        ib = torch.gather(b[2][:, rows], -1, pb)
        stats["balls"] += ia.shape[0] * ia.shape[1]
        differ = (ea != eb) | (~ea & (ia != ib).any(-1))
        for f, m in differ.nonzero().tolist():
            r = m // G
            stats["balls_differ"] += 1
            for side, ids, emp in ((a, ia, ea), (b, ib, eb)):
                q64 = side[0][f, m].double()
                _, eps = _d2_and_bound(pts64[f], q64)
                in_cands = torch.zeros_like(mask[f])
                in_cands[side[2][f, r]] = True
                assert ball_list_valid(ids[f, m].numpy(), bool(emp[f, m]), pts64[f].numpy(),
                                       (mask[f] & in_cands).numpy(), q64.numpy(), hi,
                                       eps.numpy(), lo), (
                    f"grid point {m} of frame {f} ([{lo}, {hi}] m^2): "
                    f"{sorted(set(ids[f, m].tolist()))} is no first-in-point-order answer among "
                    "its roi's candidates")
            if same_cands[f, r]:
                stats["balls_differ_same_cands"] += 1
                flipped = set(ia[f, m].tolist()) ^ set(ib[f, m].tolist())
                d2, _ = _d2_and_bound(pts64[f], a[0][f, m].double())
                edge = min(min(abs(float(d2[i]) - hi), abs(float(d2[i]) - lo) if lo > 0 else 1e9)
                           for i in flipped) if flipped else 0.0
                stats["edge_m2"] = max(stats["edge_m2"], edge)


@contextlib.contextmanager
def fixed_grouped_query(answer):
    """`group_ops.multi_ball_query_grouped_cand` returns `answer`'s (cpos,
    empty) scales and candidates (moved to the call's device) for the
    duration."""
    from btcdet_tpu_torch.ops import group_ops

    orig = group_ops.multi_ball_query_grouped_cand

    def fixed(xyz, *args, **kw):
        dev = xyz.device
        return ([(p.to(dev), e.to(dev)) for p, e in answer[3]], answer[2].to(dev), None, None)

    group_ops.multi_ball_query_grouped_cand = fixed
    try:
        yield
    finally:
        group_ops.multi_ball_query_grouped_cand = orig


def approx_sa_check(name: str, sa, args, kw):
    """One SA module of the approximate ConvHead on the inputs the eval
    forward gave it (card tensors): its grouped query on the card against
    the CPU's on the same inputs (`grouped_query_diff`); its pooled
    features on the card against a CPU copy reading the card's neighbours,
    as built (bf16 MLPs, SA_BF16_TOL) and with f32 MLPs on both (1e-4);
    and the query alone timed on the card, stage 1 (`roi_candidates`),
    stage 2 (`select_in_candidates`) and the gather (`candidate_table` +
    `group_from_candidates`), beside the exact query (`multi_ball_query`)
    and its gather (`group_from_idx`) on the same inputs."""
    import copy

    import torch

    from btcdet_tpu_torch.ops import group_ops

    xyz, mask, new_xyz, new_mask = args[:4]
    cent, G, feats, rot = kw["group_centers"], kw["group_size"], kw["features"], kw["rotate_matrix"]
    ck = group_ops.GROUP_CAND_K
    qargs = (sa.radii, sa.nsamples, cent, G)
    with torch.no_grad():
        card_out = group_ops.multi_ball_query_grouped_cand(xyz, mask, new_xyz, new_mask, *qargs,
                                                           cand_k=ck)
        cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
        cpu_out = group_ops.multi_ball_query_grouped_cand(
            *map(cpu, (xyz, mask, new_xyz, new_mask)), sa.radii, sa.nsamples, cent.cpu(), G,
            cand_k=ck)
        card = grouped_answer(new_xyz, cent, card_out)
        stats = grouped_stats()
        grouped_query_diff(xyz.cpu(), mask.cpu(), card, grouped_answer(new_xyz, cent, cpu_out),
                           sa.radii, stats)
        n_q = [int(new_mask.sum())] * len(sa.radii)
        full = [int(((~e) & new_mask.cpu()).sum()) for _, e in card[3]]
        log(f"{name} query, card against CPU on the same inputs (N {xyz.shape[1]}, "
            f"{cent.shape[1]} rois x {G} grid points a frame, candidates {card[2].shape[-1]}): "
            + json.dumps(stats) + f"; non-empty balls per scale {full} of {n_q}")
        cpu_kw = {k: cpu(v) for k, v in kw.items()}
        worst = {}
        for dtype in ("as built", "f32"):
            mod_card, mod_cpu = copy.deepcopy(sa), copy.deepcopy(sa).cpu()
            if dtype == "f32":
                for m in (*mod_card.mlps, *mod_cpu.mlps):
                    m.compute_dtype = torch.float32
            with f32_everywhere() if dtype == "f32" else contextlib.nullcontext():
                got = mod_card(*args, **kw).float().cpu()
                with fixed_grouped_query(card):
                    want = mod_cpu(*map(cpu, args), **cpu_kw).float()
            scale = float(want.abs().max())
            worst[dtype] = float((got - want).abs().max())
            tol = SA_BF16_TOL * scale if dtype == "as built" else 1e-4 * max(scale, 1.0)
            assert torch.isfinite(got).all() and worst[dtype] <= tol, (name, dtype, worst, tol)
        log(f"{name} pooled features, card against CPU (same inputs and neighbours): max abs "
            f"diff {json.dumps(worst)} (output max {scale:.4f}; bf16 bound {SA_BF16_TOL} of "
            "the max, f32 bound 1e-4)")

        cand, cxyz, cok = group_ops.roi_candidates(xyz, mask, cent, ck)
        scales = group_ops.select_in_candidates(cand, cxyz, cok, new_xyz, new_mask, sa.radii,
                                                sa.nsamples, xyz.shape[1])
        nf = feats.shape[-1]
        exact = group_ops.multi_ball_query(xyz, mask, new_xyz, new_mask, sa.radii, sa.nsamples)
        fns = {
            "stage1": lambda: group_ops.roi_candidates(xyz, mask, cent, ck),
            "stage2": lambda: group_ops.select_in_candidates(
                cand, cxyz, cok, new_xyz, new_mask, sa.radii, sa.nsamples, xyz.shape[1]),
            "gather": lambda: [group_ops.group_from_candidates(
                group_ops.candidate_table(xyz, feats, cand), p, e, new_xyz, rotate_matrix=rot,
                n_feat=nf) for p, e in scales],
            "exact_query": lambda: group_ops.multi_ball_query(xyz, mask, new_xyz, new_mask,
                                                              sa.radii, sa.nsamples),
            "exact_gather": lambda: [group_ops.group_from_idx(
                xyz, new_xyz, i, e, features=feats, rotate_matrix=rot) for i, e in exact],
        }
        ms = {k: round(cuda_ms(fn, reps=10), 3) for k, fn in fns.items()}
    ms["approx_total"] = round(ms["stage1"] + ms["stage2"] + ms["gather"], 3)
    ms["exact_total"] = round(ms["exact_query"] + ms["exact_gather"], 3)
    log(f"{name} query alone, ms on the card (CUDA events, mean of 10): " + json.dumps(ms))


def approx_train_steps(card: str):
    """The twelfth path's train steps: the shipped flagship at the train caps
    (B=2, 128 rois a frame): one counted step (TRAIN_LAUNCHES), the
    gradient repeat (0 elements may differ), then 8 steps in turns with the
    exact-query flagship of the same weights and batch (4 each) and each
    one's train stage ms; then with PASS_GRAD (PASS_GRAD_OPTIONS): one
    counted step (PASS_GRAD_LAUNCHES) and the gradient repeat, the occ
    probabilities' gradient now running through the candidate table's
    fixed-point sums."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    runs = {"approx": train_setup(config.flagship_shipped(), 16384, 10, 0),
            "exact": train_setup(config.flagship(), 16384, 10, 0)}
    net, opt, batch = runs["approx"]
    counted_step(net, opt, batch, TRAIN_LAUNCHES, "approximate-query flagship")
    gradient_repeat(net, batch, "approximate query")
    gen = torch.Generator(device="cuda").manual_seed(0)
    times, stages = {k: [] for k in runs}, {}
    for i in range(10):
        kind = ("approx", "exact", "exact", "approx")[i % 4]
        net, opt, batch = runs[kind]
        t0 = time.perf_counter()
        trainer.train_step(net, opt, batch, gen)
        torch.cuda.synchronize()
        if i >= 2:
            times[kind].append((time.perf_counter() - t0) * 1e3)
    for kind, (net, opt, batch) in runs.items():
        stages[kind] = {k: round(v, 3) for k, v in synced_stage_ms(
            lambda: trainer.train_step(net, opt, batch, gen)).items()}
    log("train step ms (B=2, train caps, same weights and batch, 4 steps each in turns after "
        "a warm-up each): " + json.dumps({k: {"median": round(statistics.median(v), 2),
                                              "all": [round(t, 2) for t in v]}
                                          for k, v in times.items()})
        + f"; stage ms (synchronised, forward only) {json.dumps(stages)} ({card})")
    del runs, net, opt, batch
    torch.cuda.empty_cache()
    net, opt, batch = train_setup(set_options(config.flagship_shipped(), PASS_GRAD_OPTIONS),
                                  16384, 10, 0)
    counted_step(net, opt, batch, PASS_GRAD_LAUNCHES, "approximate-query PASS_GRAD")
    gradient_repeat(net, batch, "approximate query, PASS_GRAD, DROPOUT_RATE 0.2, "
                                "REMAIN_PERCENTAGE")
    del net, opt, batch
    torch.cuda.empty_cache()


def approx_query_path(card: str):
    """The twelfth path (module docstring, 8g)."""
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing

    t0 = time.perf_counter()
    cfg = config.flagship_shipped()
    assert "APPROX_QUERY" not in cfg.MODEL.ROI_HEAD, "the yaml as shipped"
    nets = {}
    for kind, c in (("approx", cfg), ("exact", config.flagship())):
        nets[kind] = build_network(c.MODEL, c.DATA_CONFIG, ["Car"])
        nets[kind].load_state_dict(weights.synth_state_dict(nets[kind]))
    net, head = nets["approx"], nets["approx"].det_modules.roi_head
    assert head.SA_rawpoints.approx_query and head.SA_occpoints.approx_query
    assert not nets["exact"].det_modules.roi_head.SA_rawpoints.approx_query
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                 seed=0, mode="test")
    sa_calls = {}
    hooks = [getattr(head, n).register_forward_pre_hook(
        lambda m, a, kw, n=n: sa_calls.setdefault(n, (a, kw)), with_kwargs=True)
        for n in ("SA_rawpoints", "SA_occpoints")]
    reset_launches()
    out = net(batch)
    post = post_processing(out, cfg.MODEL.POST_PROCESSING, 1)
    torch.cuda.synchronize()
    launches = read_launches()
    for h in hooks:
        h.remove()
    log(f"approximate-query path launches: {json.dumps(launches)}")
    assert launches == EVAL_LAUNCHES, (launches, EVAL_LAUNCHES)
    n_det = check_eval_outputs(net, batch, out, post)
    ref = nets["exact"](batch)
    ref_post = post_processing(ref, cfg.MODEL.POST_PROCESSING, 1)
    cls_diff = float((ref["batch_cls_preds"] - out["batch_cls_preds"]).abs().max())
    log(f"approximate-query flagship (B=2, test caps): rois per frame "
        f"{[int(v) for v in out['roi_valid'].sum(dim=1)]}, occ points per frame "
        f"{[int(v) for v in out['occ_points_mask'].sum(dim=1)]}, detections per frame {n_det} "
        f"(exact query, same weights and batch: "
        f"{[int(v) for v in ref_post['pred_valid'].sum(dim=1)]}); rois equal to the exact "
        f"net's: {bool(torch.equal(ref['rois'], out['rois']))}; max |rcnn cls diff| against "
        f"the exact query {cls_diff:.4f}")
    for n, (args, kw) in sa_calls.items():
        approx_sa_check(n, getattr(head, n), args, kw)
    ms = {"approx": [], "exact": []}
    for i in range(12):
        kind = ("approx", "exact", "exact", "approx")[i % 4]
        ms[kind].append(stage_times(nets[kind], batch, cfg.MODEL.POST_PROCESSING)["roi_head"])
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"roi_head stage ms (synchronised, median of 6 in turns, same rois and weights): "
        f"approximate query {med['approx']:.3f}, exact query {med['exact']:.3f}; all "
        + json.dumps({k: [round(v, 3) for v in vs] for k, vs in ms.items()}))
    fwd = {k: timed_median(lambda k=k: forward_post(nets[k], batch, cfg))[0] for k in nets}
    log(f"forward+post ms (B=2, median of 5 after 2 warm-ups): approximate query "
        f"{fwd['approx']:.2f}, exact query {fwd['exact']:.2f}")
    profile_step(lambda: post_processing(net(batch), cfg.MODEL.POST_PROCESSING, 1), STAGES,
                 "approximate-query forward + post")
    del nets, net, head, batch, out, post, ref, ref_post, sa_calls
    torch.cuda.empty_cache()
    approx_train_steps(card)
    small = small_config(full=True)
    small.MODEL.ROI_HEAD.APPROX_QUERY = True
    small_input_check(small, "full config, approximate query")
    log(f"twelfth path (approximate query): {time.perf_counter() - t0:.1f} s ({card})")


# the thirteenth path: tools/overfit_proof_torch.py on its 25-frame tree
OVERFIT_STEPS_A_EPOCH = 12         # 25 frames at B=2, the last partial batch dropped
OVERFIT_GATE_EPOCHS = 10           # the default run's short gate
OVERFIT_GATE_FALL = 0.5            # its last epoch's mean loss below this share of its first's
# the eval CLI's batch comparison on the gate's checkpoint lowers the score
# threshold to this: after OVERFIT_GATE_EPOCHS the model scores no detection
# above the yaml's 0.60, and at 0 every valid roi left by the NMS is kept
OVERFIT_BATCH_SCORE = 0.0
OVERFIT_AP_MIN = 99.0              # the full proof: 3d / bev / bbox AP_R40, and Car AOS at 2048
# the trailing eval, the 2048 one and the default population's, 13 batches each
OVERFIT_EVAL_FORWARDS = 3 * 13
AP_DIFFICULTIES = ("easy", "moderate", "hard")


def overfit_path(card: str, full: bool = False, three_classes: bool = False) -> dict:
    """The thirteenth path (module docstring, 8h): the short gate, or with
    `full` the whole proof. Returns its numbers for the JSON line."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    proof = load_tool("overfit_proof_torch")
    steps = []

    def on_step(gstep, batch, metrics):
        launches = read_launches()
        reset_launches()
        vals = {k: float(v) for k, v in metrics.items()}
        steps.append(vals)
        assert launches == TRAIN_LAUNCHES, (gstep, launches)
        assert all(math.isfinite(v) for v in vals.values()), (gstep, vals)

    epochs = 150 if full else OVERFIT_GATE_EPOCHS
    argv = ["--fresh", "--epochs", str(epochs)] + (["--three_classes"] if three_classes else [])
    with contextlib.ExitStack() as stack:
        if not full:   # the gate's data and checkpoints go with it
            root = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_overfit_"))
            argv += ["--root", root]
        reset_launches()
        summary = proof.main(argv, on_step=on_step)
        torch.cuda.synchronize()
        eval_launches = read_launches()
        if not full:
            batches = eval_batch_agreement(card, proof, root)
    label = f"{'3-class ' if three_classes else ''}overfit {'proof' if full else 'gate'}"
    assert summary["steps_per_epoch"] == OVERFIT_STEPS_A_EPOCH, summary["steps_per_epoch"]
    assert summary["start_step"] == 0 and len(steps) == epochs * OVERFIT_STEPS_A_EPOCH, (
        summary["start_step"], len(steps))
    assert summary["resumed_at_step"] is None, summary["resumed_at_step"]
    assert eval_launches == {k: v * OVERFIT_EVAL_FORWARDS for k, v in EVAL_LAUNCHES.items()}, (
        eval_launches)
    epoch_loss = [statistics.fmean(s["loss"] for s in steps[i:i + OVERFIT_STEPS_A_EPOCH])
                  for i in range(0, len(steps), OVERFIT_STEPS_A_EPOCH)]
    keys = [f"{c}_{kind}/{d}_R40" for c in summary["classes"] for kind in proof.AP_KINDS
            for d in AP_DIFFICULTIES]
    for name in ("ap", "ap_occ2048"):
        # the official eval leaves AOS out when no frame has a detection
        missing = [k for k in keys if "_aos/" not in k and k not in summary[name]]
        bad = [k for k, v in summary[name].items() if not math.isfinite(v)]
        assert not missing and not bad, (name, missing, bad)
    log(f"[{card}] {label}: {len(steps)} steps ({epochs} epochs of "
        f"{OVERFIT_STEPS_A_EPOCH}), every step launched TRAIN_LAUNCHES with finite loss terms; "
        f"the evals {OVERFIT_EVAL_FORWARDS} x EVAL_LAUNCHES")
    log(f"[{card}] {label}: mean loss a epoch (every step) "
        + json.dumps([round(v, 4) for v in epoch_loss]))
    log(f"[{card}] {label}: first / final / min logged loss {summary['first_loss']:.4f} / "
        f"{summary['final_loss']:.4f} / {summary['min_loss']:.4f}; final loss terms "
        + json.dumps({k: round(v, 4) for k, v in summary["final_loss_terms"].items()}))
    for name, pop in (("ap", "default occ population"), ("ap_occ2048", "occ points 2048")):
        log(f"[{card}] {label}: AP_R40 ({pop})\n" + proof.ap_table(summary[name]))
    log(f"[{card}] {label}: {summary['steps_per_s']:.3f} steps/s; train loop wall ms by part "
        + json.dumps({k: round(v, 2) for k, v in summary["train_loop_ms"].items()})
        + "; wall s " + json.dumps({k: round(v, 1) for k, v in summary["wall_s"].items()}))
    log(f"[{card}] {label}: drops " + json.dumps(summary["drops"]))
    log(f"[{card}] {label}: heading errors of the matched detections "
        + json.dumps(summary["heading_errors"]))
    fall = epoch_loss[-1] / epoch_loss[0]
    if full:
        low = {k: summary["ap"][k] for k in keys
               if "_aos/" not in k and summary["ap"][k] < OVERFIT_AP_MIN}
        aos = {k: summary["ap_occ2048"].get(k, math.nan) for k in keys
               if k.startswith("Car_aos/")}
        log(f"[{card}] {label}: 3d / bev / bbox AP_R40 below {OVERFIT_AP_MIN}: {low}; Car AOS "
            f"at 2048 occ points {aos}")
        assert not low and min(aos.values()) >= OVERFIT_AP_MIN, (low, aos)
    else:
        log(f"[{card}] {label}: last epoch's mean loss / first's = {fall:.4f} (gate "
            f"< {OVERFIT_GATE_FALL})")
        assert fall < OVERFIT_GATE_FALL, (fall, epoch_loss)
    log(f"thirteenth path ({label}): {time.perf_counter() - t0:.1f} s ({card})")
    return {**({} if full else {"eval_batch_8_against_1": batches}),
            "classes": summary["classes"], "epochs": epochs, "steps": len(steps),
            "epoch_loss": epoch_loss, "loss_fall": fall, "first_loss": summary["first_loss"],
            "final_loss": summary["final_loss"], "min_loss": summary["min_loss"],
            "ap": summary["ap"], "ap_occ2048": summary["ap_occ2048"],
            "heading_errors": summary["heading_errors"], "steps_per_s": summary["steps_per_s"],
            "wall_s": summary["wall_s"], "card": card}


# ------------------------------- the first path: bench.py's main path as shipped

BENCH_B = 8                        # bench.py's batch (its `main`; tools/run_kitti_val.sh's)
BENCH_PAIR = (0, 1)                # the frames a B=2 batch of the same seed holds
# the flagship geometry test's bound on detections that move between two
# runs (tests/test_torch_eval_cli.py): at most this share of them, each
# within this distance (m) and score of its nearest counterpart
MOVED_SHARE, MOVED_M, MOVED_SCORE = 0.05, 0.25, 0.01
SAME_DET = 1e-4                    # a detection with a counterpart within this is unmoved


def sparse_frame(st, b: int) -> tuple:
    """(coords (z, y, x), features) of frame b's rows of a SparseTensor, on
    the host: the frame's place in its batch left out."""
    m = st.coords[:, 0] == b
    return st.coords[m][:, 1:].cpu(), st.features[m].cpu()


@contextlib.contextmanager
def frame_site_drops(calls: list):
    """The recorder on around the block: each strided conv's output sites
    under its level capacity (`sparse._unique_capped`'s tallies) append
    ([distinct sites wanted a frame], [sites kept a frame]) on the host."""
    from btcdet_tpu_torch.utils import trace

    trace.enable()
    try:
        yield
    finally:
        rec = trace.disable()
    calls.extend((w.tolist(), k.tolist()) for w, k in zip(
        rec.tallies.get("backbone.sites_wanted", []), rec.tallies.get("backbone.sites_kept", [])))


def frame_views(net, batch, post_cfg, drops=None) -> tuple:
    """One eval forward + post-processing: its per-frame outputs by stage
    ({stage: {name: [one host tensor a frame]}}, `btcnet.STAGES` order), the
    roi-grouped query's calls ((points, mask, radii, `grouped_answer`) on
    the host), and the forward's and post-processing's outputs; `drops`, a
    list, gets the strided convs' sites a frame (`frame_site_drops`)."""
    import torch

    from btcdet_tpu_torch.models.detectors.btcnet import post_processing
    from btcdet_tpu_torch.ops import group_ops

    seen, queries = {}, []
    bb = net.det_modules.backbone_3d
    hooks = [bb.register_forward_pre_hook(lambda m, a: seen.update(merged=a[0])),
             bb.register_forward_hook(lambda m, a, o: seen.update(encoded=o["encoded"]))]
    orig = group_ops.multi_ball_query_grouped_cand

    def recorded(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers, group_size,
                 cand_k=512):
        out = orig(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers,
                   group_size, cand_k=cand_k)
        queries.append((xyz.cpu(), xyz_mask.cpu(), radii,
                        grouped_answer(new_xyz, group_centers, out)))
        return out

    group_ops.multi_ball_query_grouped_cand = recorded
    try:
        with frame_site_drops([] if drops is None else drops):
            out = net(batch)
        post = post_processing(out, post_cfg, 1, device=batch["points"].device)
        torch.cuda.synchronize()
    finally:
        group_ops.multi_ball_query_grouped_cand = orig
        for h in hooks:
            h.remove()
    B = batch["points"].shape[0]

    def frames(src, *keys):
        return {k: [src[k][b].cpu() for b in range(B)] for k in keys}

    merged = [sparse_frame(seen["merged"], b) for b in range(B)]
    encoded = [sparse_frame(seen["encoded"], b) for b in range(B)]
    views = {
        "occ_subnet": dict(frames(out, "occ_probs"), occ_points=[
            out["occ_points"][b][out["occ_points_mask"][b]].cpu() for b in range(B)],
            merged_coords=[c for c, _ in merged], merged_features=[f for _, f in merged]),
        "backbone_3d": dict(frames(out, "spatial_features"),
                            encoded_coords=[c for c, _ in encoded],
                            encoded_features=[f for _, f in encoded]),
        "bev": frames(out, "spatial_features_2d"),
        "dense_head": frames(out, "rpn_cls_preds", "rpn_box_preds"),
        "proposal_nms": frames(out, "rois", "roi_valid"),
        "roi_head": frames(out, "batch_cls_preds", "batch_box_preds"),
        "post_processing": frames(post, "pred_boxes", "pred_scores", "pred_labels",
                                  "pred_valid"),
    }
    return views, queries, out, post


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (NaNs of the same bits equal)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return torch.equal(a, b)


def frame_differences(big: dict, small: dict, frames) -> dict:
    """{stage: {output: (tensors that differ, max abs difference)}} of frames
    `frames` of the run `big` against the frames of the run `small`, in
    order, bit for bit; a shape that differs counts as an infinite
    difference."""
    diffs = {}
    for stage, outs in big.items():
        for name, per in outs.items():
            n, worst = 0, 0.0
            for a, b in zip([per[f] for f in frames], small[stage][name]):
                if same_bits(a, b):
                    continue
                n += 1
                worst = max(worst, float((a.double() - b.double()).abs().max())
                            if a.shape == b.shape else math.inf)
            if n:
                diffs.setdefault(stage, {})[name] = (n, worst)
    return diffs


def moved_detections(boxes_a, scores_a, boxes_b, scores_b) -> list:
    """[(centre distance, score difference)] to its nearest counterpart in
    b of each detection of a with none in b within SAME_DET (box and score,
    relative and absolute), as tests/test_torch_eval_cli.py `_unmatched`
    compares two runs: as sets, since near-tied scores may be visited in
    another order."""
    import torch

    ra = torch.cat([boxes_a.double(), scores_a.double()[:, None]], 1)
    rb = torch.cat([boxes_b.double(), scores_b.double()[:, None]], 1)
    out = []
    for r in ra:
        if len(rb) and bool(((rb - r).abs() <= SAME_DET + SAME_DET * rb.abs()).all(1).any()):
            continue
        if not len(rb):
            out.append((math.inf, math.inf))
            continue
        j = int((rb[:, :3] - r[:3]).norm(dim=1).argmin())
        out.append((float((rb[j, :3] - r[:3]).norm()), float((rb[j, 7] - r[7]).abs())))
    return out


def frame_dets(post, b: int) -> tuple:
    """(boxes, scores) of frame b's kept detections, on the host."""
    keep = post["pred_valid"][b]
    return post["pred_boxes"][b][keep].cpu(), post["pred_scores"][b][keep].cpu()


# the stages whose cuDNN / cuBLAS calls see the whole batch, by the module
# that runs them: the BEV pyramid's convs, the RPN's convs, ConvHead's dense
# conv stack and FCs (the other stages hold each frame's rows apart)
DENSE_STAGES = {"bev": "backbone_2d", "dense_head": "dense_head", "roi_head": "roi_head"}
# how far such a stage's output may part, relative to its max, when another
# batch size picks another algorithm: 8 bf16 ulps at the max, for a chain of
# bf16 layers each rounding once (the BEV pyramid: 7 convs a path)
DENSE_ROUNDING = 2.0 ** -5


def frames_of(obj, frames, n: int):
    """Frames `frames` of an output of n frames: a tensor (n, ...) indexed,
    one of (n * k, ...) rows taken by blocks of k; dicts, lists and tuples
    item by item."""
    import torch

    if torch.is_tensor(obj):
        if not obj.dim() or obj.shape[0] % n:
            return obj
        k = obj.shape[0] // n
        return obj.reshape(n, k, *obj.shape[1:])[list(frames)].reshape(len(frames) * k,
                                                                         *obj.shape[1:])
    if isinstance(obj, dict):
        return type(obj)({key: frames_of(v, frames, n) for key, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(frames_of(v, frames, n) for v in obj)
    return obj


def batch_frames(batch: dict, n: int, frames) -> dict:
    """The frames `frames` (in order, repeats allowed) of a batch of n
    frames, as a batch of its own: each key's blocks of rows, the voxel
    tables' frame column renumbered."""
    import torch

    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // n
        v = torch.cat([v[f * rows:(f + 1) * rows] for f in frames])
        if k.endswith("voxel_coords"):
            new = torch.arange(len(frames), device=v.device,
                               dtype=v.dtype).repeat_interleave(rows)
            v = torch.cat([torch.where(v[:, :1] >= 0, new[:, None], v[:, :1]), v[:, 1:]], 1)
        out[k] = v
    return out


def tensors_of(obj, prefix: str = "") -> dict:
    """{path: tensor} of an output's floating tensors."""
    import torch

    if torch.is_tensor(obj):
        return {prefix: obj} if obj.is_floating_point() else {}
    items = (obj.items() if isinstance(obj, dict) else enumerate(obj)
             if isinstance(obj, (list, tuple)) else ())
    return {k: v for key, item in items for k, v in tensors_of(item, f"{prefix}.{key}").items()}


@contextlib.contextmanager
def dense_stage_hooks(net, rec: dict, replay=None):
    """Forward hooks on DENSE_STAGES' modules: each output recorded into
    `rec`; or, with `replay` (such a record
    of a run of `replay["n"]` frames, and `replay["frames"]` the frames this
    run holds), each module's own output held against the recorded one's
    frames (largest difference and the recorded max, by tensor, into `rec`)
    and replaced by them, so every later stage reads the same inputs as in
    the recorded run."""
    det = net.det_modules

    def hook(stage):
        def fn(mod, args, out):
            if replay is None:
                rec[stage] = out
                return None
            want = frames_of(replay[stage], replay["frames"], replay["n"])
            mine, theirs = tensors_of(out), tensors_of(want)
            rec[stage] = {k: (float((v.float() - theirs[k].float()).abs().max()),
                              float(theirs[k].float().abs().max())) for k, v in mine.items()}
            return want
        return fn

    hooks = [getattr(det, m).register_forward_hook(hook(s)) for s, m in DENSE_STAGES.items()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def batch_independence(card: str, net, cfg, batch8, big, queries8, post8, drops8,
                       dense8) -> dict:
    """Frames BENCH_PAIR of the B=8 run against the same shipped model on
    the B=2 batch of the same seed (its inputs asserted equal to those
    frames'), stage by stage: the first stage where any bit differs and by
    how much, and how far the detections moved (`moved_detections`). The
    sites each strided conv wanted and kept must be the same for those
    frames in both runs (`drops8` against the B=2 run's: every level
    capacity is a frame's own). At one batch size no frame may see another:
    a B=8 batch of frames 0-1 four times over must give frames 0-1 the B=8
    run's bits at every stage. Equal bit for bit at B=2 passes. Otherwise
    the difference is traced: the B=2 run again with each of DENSE_STAGES'
    outputs replaced by the B=8 run's (`dense8`, `dense_stage_hooks`), after
    its own has been held to them within DENSE_ROUNDING of their max (the
    rounding of another cuDNN / cuBLAS algorithm at another batch size);
    every stage of that run must then equal the B=8 run's frames bit for bit
    (the occ top-k, the sparse backbone, both NMSs and the roi-grouped
    queries give the same answer on the same inputs). Returns the B=2
    batch."""
    import torch

    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES

    batch2 = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                  seed=0, mode="test")
    for k, v in batch2.items():
        # a key holds (frames, ...) or a fixed number of rows a frame
        assert torch.equal(v, batch8[k][:v.shape[0] // 2 * 2]), (
            f"the B=2 batch's {k} is not frames 0-1 of the B=8 batch")
    pair, post_cfg = list(BENCH_PAIR), cfg.MODEL.POST_PROCESSING
    repeated, _, _, _ = frame_views(net, batch_frames(batch8, BENCH_B, pair * (BENCH_B // 2)),
                                    post_cfg)
    coupled = frame_differences(big, repeated, pair)
    log(f"[{card}] batch independence at B={BENCH_B}: frames {pair} among frames 2-7 and "
        f"among copies of themselves give the same bits at every stage: {not coupled} "
        + json.dumps({s: list(v) for s, v in coupled.items()}))
    assert not coupled, f"at one batch size frames 0-1 see the other frames: {coupled}"
    drops2 = []
    small, _, _, post2 = frame_views(net, batch2, post_cfg, drops2)
    assert [([w[f] for f in pair], [k[f] for f in pair]) for w, k in drops8] == drops2, (
        "the level capacities cut frames 0-1 otherwise at B=8 than at B=2", drops8, drops2)
    diffs = frame_differences(big, small, BENCH_PAIR)
    first = next((s for s in STAGES if s in diffs), None)
    moved = [moved_detections(*frame_dets(post8, b), *frame_dets(post2, i))
             for i, b in enumerate(BENCH_PAIR)]
    n_det = [(len(frame_dets(post8, b)[0]), len(frame_dets(post2, i)[0]))
             for i, b in enumerate(BENCH_PAIR)]
    if first is None:
        log(f"[{card}] batch independence: frames {pair} of the B=8 run equal the B=2 run of "
            f"the same frames bit for bit at every stage ({sum(len(v) for v in big.values())} "
            f"outputs over {len(big)} stages, the merged det rows and the sites each level "
            f"kept included)")
        return batch2
    log(f"[{card}] batch independence: frames {pair} of the B=8 run against the B=2 run: "
        f"first stage that differs {first}; differing outputs by stage (frames that differ, "
        "max abs difference): " + json.dumps({s: {k: [n, f"{w:.3e}"] for k, (n, w) in v.items()}
                                              for s, v in diffs.items()})
        + f"; detections a frame (B=8, B=2) {n_det}, moved or missing "
        f"{[len(m) for m in moved]} (nearest counterpart: largest distance "
        f"{max([d for m in moved for d, _ in m], default=0.0):.3f} m)")
    assert first in DENSE_STAGES, f"frames part first at {first}, a stage that keeps them apart"
    rec = {}
    with dense_stage_hooks(net, rec, dict(dense8, frames=pair, n=BENCH_B)):
        traced, queries2, _, _ = frame_views(net, batch2, post_cfg)
    rest = frame_differences(big, traced, BENCH_PAIR)
    # the roi-grouped query on the same inputs: the same answers, or each
    # differing one valid for its own query (`grouped_query_diff`)
    stats = grouped_stats()
    for (_, _, radii, a8), (xyz2, m2, _, a2) in zip(queries8, queries2):
        sliced = (a8[0][pair], a8[1][pair], a8[2][pair], [(p[pair], e[pair]) for p, e in a8[3]])
        grouped_query_diff(xyz2, m2, sliced, a2, radii, stats)
    worst = {s: max(d / max(m, 1e-30) for d, m in rec[s].values()) for s in DENSE_STAGES}
    log(f"[{card}] batch independence, traced: the B=2 run with the B=8 run's outputs of "
        f"{list(DENSE_STAGES)} replaced in: their own outputs within {json.dumps(worst)} of "
        f"the max (bound {DENSE_ROUNDING}); every other output of every stage equal bit for "
        f"bit: {not rest} {json.dumps({s: list(v) for s, v in rest.items()})}; the "
        f"roi-grouped queries of {len(queries2)} calls against the B=8 run's "
        + json.dumps(stats))
    assert max(worst.values()) <= DENSE_ROUNDING and not rest, (worst, rest)
    assert len(queries2) == len(queries8), (len(queries2), len(queries8))
    planted = planted_dense_faults(net, batch2, post_cfg, dense8)
    log(f"[{card}] DENSE_ROUNDING against planted faults: the same traced B=2 run's dense "
        f"outputs against the B=8 run's, relative to the max, (a) against frames "
        f"{pair[::-1]} (each frame held to the other's), (b) with {PLANTED_DROP:.0%} of frame "
        f"0's active BEV cells zeroed in the BEV pyramid's input: " + json.dumps(
            {k: {s: f"{v:.3e}" for s, v in w.items()} for k, w in planted.items()})
        + f" (sound reading above {json.dumps({s: f'{v:.3e}' for s, v in worst.items()})})")
    assert all(max(w.values()) > DENSE_ROUNDING for w in planted.values()), planted
    return batch2


# the share of a frame's active BEV cells the planted fault of
# `planted_dense_faults` zeroes: a site drop a shared capacity could make
PLANTED_DROP = 0.01


def planted_dense_faults(net, batch2, post_cfg, dense8) -> dict:
    """`batch_independence`'s traced B=2 run twice more with a planted
    fault: (a) its dense outputs held to the B=8 run's frames swapped, (b)
    PLANTED_DROP of frame 0's active cells zeroed in the BEV pyramid's input
    (a random draw of seed 0). Returns each run's DENSE_STAGES readings
    (largest difference relative to the B=8 run's max)."""
    import torch

    def zero_cells(mod, args):
        x = args[0].clone()
        cells = (x[0] != 0).any(0).nonzero()
        g = torch.Generator().manual_seed(0)
        pick = cells[torch.randperm(len(cells), generator=g)[:max(1, int(PLANTED_DROP * len(
            cells)))].to(cells.device)]
        x[0, :, pick[:, 0], pick[:, 1]] = 0
        return (x, *args[1:])

    out = {}
    for name, frames, pre in (("a", [1, 0], None), ("b", [0, 1], zero_cells)):
        rec = {}
        hook = None if pre is None else net.det_modules.backbone_2d.register_forward_pre_hook(pre)
        try:
            with dense_stage_hooks(net, rec, dict(dense8, frames=frames, n=BENCH_B)):
                frame_views(net, batch2, post_cfg)
        finally:
            if hook is not None:
                hook.remove()
        out[name] = {s: max(d / max(m, 1e-30) for d, m in rec[s].values()) for s in DENSE_STAGES}
    return out


def bench_path(card: str) -> list:
    """The first path (module docstring, 2b): `bench.py`'s main path as
    shipped, at its batch of 8. Returns the kernels' `@B8` entries."""
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = config.flagship_shipped()
    assert "APPROX_QUERY" not in cfg.MODEL.ROI_HEAD, "the yaml as shipped"
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"])
    net.load_state_dict(weights.synth_state_dict(net))
    head = net.det_modules.roi_head
    assert head.SA_rawpoints.approx_query and head.SA_occpoints.approx_query
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=BENCH_B, num_points=16384,
                                 num_gt=10, seed=0, mode="test")
    caps = {p.NAME: p.MAX_NUMBER_OF_VOXELS["test"] for p in cfg.DATA_CONFIG.DATA_PROCESSOR
            if "MAX_NUMBER_OF_VOXELS" in p}
    post_cfg = cfg.MODEL.POST_PROCESSING

    # the kernels at B=8, on the inputs one forward gives them
    captured = capture_kernel_inputs(lambda: net(batch))
    calls = {k: [a for a, _ in v] for k, v in captured.items()}
    picks = eval_conv_picks(calls["sparse_conv"], "@B8")
    kernels = [e for name, args in picks.items() for e in k1_case(name, args)]
    k1_eval_table(captured["sparse_conv"], captured["neighbor_map"])
    assert len(calls["sparse_pool"]) == 1, len(calls["sparse_pool"])
    kernels.append(k2_case(captured["sparse_pool"][0], "@B8"))
    kernels.append(k4_case(calls["trilinear_pool"][0], "@B8"))
    del captured, calls, picks
    torch.cuda.empty_cache()

    # the main path: counts reset, one forward + post-processing
    probe = load_tool("overfit_proof_torch").DropProbe()
    probe.phase = "eval"
    drops8, dense8 = [], {}
    reset_launches()
    with probe, dense_stage_hooks(net, dense8):
        big, queries8, out, post = frame_views(net, batch, post_cfg, drops8)
    launches = read_launches()
    log(f"[{card}] first path (bench.py's main path: the yaml as shipped, B={BENCH_B}, caps "
        f"{json.dumps(caps)}) launches: {json.dumps(launches)}")
    assert launches == EVAL_LAUNCHES, (launches, EVAL_LAUNCHES)
    for e in kernels:
        e["launches"] = launches[e["name"].split(":")[0]]
    n_det = check_eval_outputs(net, batch, out, post)
    drops = probe.read()
    n_occ = [int(v) for v in out["occ_points_mask"].sum(dim=1)]
    det_rows = [int((batch["det_voxel_coords"][:, 0] == b).sum()) for b in range(BENCH_B)]
    merged = [len(c) for c in big["occ_subnet"]["merged_coords"]]
    new_rows = [m - d for m, d in zip(merged, det_rows)]
    log(f"[{card}] B={BENCH_B}: occ points per frame {n_occ}; det voxels per frame {det_rows}; "
        f"merged det rows per frame {merged} (new occ rows {new_rows}); rois per frame "
        f"{[int(v) for v in out['roi_valid'].sum(dim=1)]}; detections per frame {n_det}; nnz "
        f"per level {json.dumps(out['nnz'])}")
    log(f"[{card}] B={BENCH_B} active sites a frame dropped at each level capacity "
        "(strided conv: [dropped of wanted] by frame): " + json.dumps(
            {f"call {i}": [f"{w - k} of {w}" for w, k in zip(want, kept)]
             for i, (want, kept) in enumerate(drops8)})
        + "; the merged det table " + json.dumps(drops["merged_table"]))
    assert min(n_occ) > 0 and min(new_rows) > 0, (n_occ, new_rows)

    batch2 = batch_independence(card, net, cfg, batch, big, queries8, post, drops8, dense8)
    del big, queries8, out, post, dense8

    # numbers
    med, times = timed_median(lambda: forward_post(net, batch, cfg))
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[{card}] forward+post ms, the yaml as shipped at B={BENCH_B} (5 runs after 2 "
        f"warm-ups): median {med:.2f}, spread {min(times):.2f}-{max(times):.2f}, all "
        f"{[round(t, 2) for t in times]}; {BENCH_B * 1e3 / med:.2f} frames/s; peak "
        f"{peak:.1f} MiB")
    stages8, wall, busy = stage_profile(net, batch, post_cfg, f"forward + post at B={BENCH_B}")
    log(f"[{card}] B={BENCH_B} forward + post under the profiler: wall {wall:.2f} ms, kernel "
        f"{busy:.2f} ms, device idle share {idle_share(busy, wall)}")
    med2, _ = timed_median(lambda: forward_post(net, batch2, cfg))
    stages2 = stage_times(net, batch2, post_cfg)
    per_frame = {s: {f"B={BENCH_B}": round(stages8[s] / BENCH_B, 3),
                     "B=2": round(stages2[s] / 2, 3)} for s in stages8}
    log(f"[{card}] stage ms a frame, B={BENCH_B} against B=2 (one synchronised run each; "
        f"B=2 forward+post median {med2:.2f} ms): " + json.dumps(per_frame))
    grouped_query_alone(card, net, batch)
    del batch2

    # the fast-eval yaml at B=8: its 20 000 caps
    fast = config.fast20k()
    fnet = build_network(fast.MODEL, fast.DATA_CONFIG, ["Car"])
    fnet.load_state_dict(weights.synth_state_dict(fnet))
    fbatch = make_synthetic_batch(fast.DATA_CONFIG, batch_size=BENCH_B, num_points=16384,
                                  num_gt=10, seed=0, mode="test")
    fdrops = []
    reset_launches()
    with frame_site_drops(fdrops):
        fout = fnet(fbatch)
    fpost = post_processing(fout, fast.MODEL.POST_PROCESSING, 1)
    torch.cuda.synchronize()
    flaunch = read_launches()
    assert flaunch == EVAL_LAUNCHES, (flaunch, EVAL_LAUNCHES)
    fdet = check_eval_outputs(fnet, fbatch, fout, fpost)
    fcut = {f"call {i}": sum(w) - sum(k) for i, (w, k) in enumerate(fdrops)}
    fmed, ftimes = timed_median(lambda: forward_post(fnet, fbatch, fast))
    fcaps = {p.NAME: p.MAX_NUMBER_OF_VOXELS["test"] for p in fast.DATA_CONFIG.DATA_PROCESSOR
             if "MAX_NUMBER_OF_VOXELS" in p}
    log(f"[{card}] fast20k yaml (test caps {json.dumps(fcaps)}) at B={BENCH_B}: launches "
        f"EVAL_LAUNCHES, detections per frame {fdet}, active sites dropped a batch by level "
        f"{json.dumps(fcut)}; forward+post "
        f"median {fmed:.2f} ms (all {[round(t, 2) for t in ftimes]}) against {med:.2f} at the "
        f"shipped yaml's caps")
    del fnet, fbatch, fout, fpost, net, batch
    torch.cuda.empty_cache()
    log(f"first path (bench.py's main path, B={BENCH_B}): {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return kernels


def sync_sites(net, batch, post_cfg, num_class: int) -> tuple:
    """One eval forward + post-processing with the recorder on and the
    card's sync debug mode at "warn": each synchronising call outside the
    named read-backs (`trace.readback`) warns, and is collected by the
    innermost frame of the port it came from ("file:line function").
    Returns ({site: count} of those calls, {read-back site: count})."""
    import traceback
    import warnings

    import torch

    from btcdet_tpu_torch.models.detectors.btcnet import post_processing
    from btcdet_tpu_torch.utils import trace

    found = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        port = [f for f in traceback.extract_stack()[:-1] if "btcdet_tpu_torch" in f.filename
                and not f.filename.endswith("utils/trace.py")]
        if port:
            f = port[-1]
            site = f"{f.filename.split('btcdet_tpu_torch/')[-1]}:{f.lineno} {f.name}"
        else:
            site = " < ".join(f"{f.filename}:{f.lineno} {f.name}"
                              for f in reversed(traceback.extract_stack()[-6:-1]))
        found[site] = found.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        trace.enable(sync_debug="warn")
        try:
            post_processing(net(batch), post_cfg, num_class)
        finally:
            rec = trace.disable()
    torch.cuda.synchronize()
    return found, rec.sync_counts()


def sync_path(card: str) -> dict:
    """The sync-debug check (module docstring, 2c): the car yaml and the
    3-class yaml as shipped (the approximate query) at B=8, each after a
    warm-up pass: one eval forward + post-processing in "warn" mode
    (`sync_sites`) must find no synchronising call outside the named
    read-backs, and one in "error" mode (`trace.enable(sync_debug="error")`,
    which lifts the mode only inside each read-back) must run through; so
    must a hand-built NMS call that walks three chunks, with no read-back.
    Each batch launches the NMS kernel twice (proposal and final).
    Returns {config: {read-back site: count a batch}}."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing
    from btcdet_tpu_torch.ops import iou3d
    from btcdet_tpu_torch.utils import trace

    t0 = time.perf_counter()
    out, unnamed = {}, {}
    for name, cfg in (("car", config.flagship_shipped()),
                      ("three_class", config.cfg_from_yaml_file(config.THREE_CLASS_CFG))):
        assert "APPROX_QUERY" not in cfg.MODEL.ROI_HEAD, "the yaml as shipped"
        ncls = len(cfg.CLASS_NAMES)
        net = det_net(cfg)
        batch = relabel(make_synthetic_batch(cfg.DATA_CONFIG, batch_size=BENCH_B,
                                             num_points=16384, num_gt=10, seed=0, mode="test"),
                        ncls)
        post_cfg = cfg.MODEL.POST_PROCESSING
        post_processing(net(batch), post_cfg, ncls)
        torch.cuda.synchronize()
        found, counts = sync_sites(net, batch, post_cfg, ncls)
        log(f"[{card}] sync inventory, {name} yaml at B={BENCH_B}: read-backs a batch "
            f"{json.dumps(counts)} ({sum(counts.values())} in all); synchronising calls outside "
            f"them: {json.dumps(found)}")
        out[name] = counts
        if found:
            unnamed[name] = found
            continue
        trace.enable(sync_debug="error")
        try:
            post_processing(net(batch), post_cfg, ncls)
            torch.cuda.synchronize()
        finally:
            rec = trace.disable()
        assert rec.sync_counts() == counts, (rec.sync_counts(), counts)
        assert rec.counts.get("launch.nms_rotated") == 2, rec.counts
        del net, batch
        torch.cuda.empty_cache()
    assert not unnamed, f"synchronising calls outside the named read-backs: {unnamed}"
    # the NMS's later chunks (the survivors of earlier chunks suppressing),
    # which the synthetic weights' boxes do not reach: 600 apart, every one
    # kept, on the card with no read-back
    boxes = torch.zeros((600, 7), device="cuda")
    boxes[:, 0] = torch.arange(600, device="cuda") * 3.0
    boxes[:, 3:6] = torch.tensor([2.0, 1.0, 1.5], device="cuda")
    trace.enable(sync_debug="error")
    try:
        iou3d.nms_rotated(boxes, torch.linspace(1.0, 0.1, 600, device="cuda"),
                          torch.ones(600, dtype=torch.bool, device="cuda"), thresh=0.1,
                          pre_max_size=600, post_max_size=1000)
        torch.cuda.synchronize()
    finally:
        rec = trace.disable()
    assert rec.sync_counts() == {}, rec.sync_counts()
    assert rec.tally("nms.chunks").tolist() == [3], rec.tallies
    log(f"sync-debug check (car and 3-class at B={BENCH_B}, \"error\" mode): passed, "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return out


def grouped_query_alone(card: str, net, batch):
    """ConvHead's roi-grouped query at the batch's rois: each SA module's
    stage 1 (`roi_candidates`) and stage 2 (`select_in_candidates`) alone on
    the inputs the forward gave it, ms (CUDA events) and the peak MiB above
    what was allocated before the call."""
    import torch

    from btcdet_tpu_torch.ops import group_ops

    head = net.det_modules.roi_head
    sa_calls = {}
    hooks = [getattr(head, n).register_forward_pre_hook(
        lambda m, a, kw, n=n: sa_calls.setdefault(n, (a, kw)), with_kwargs=True)
        for n in ("SA_rawpoints", "SA_occpoints")]
    try:
        net(batch)
    finally:
        for h in hooks:
            h.remove()
    res = {}
    with torch.no_grad():
        for n, (args, kw) in sa_calls.items():
            sa = getattr(head, n)
            xyz, mask, new_xyz, new_mask = args[:4]
            cent, ck = kw["group_centers"], group_ops.GROUP_CAND_K
            cand, cxyz, cok = group_ops.roi_candidates(xyz, mask, cent, ck)
            fns = {"stage1": lambda: group_ops.roi_candidates(xyz, mask, cent, ck),
                   "stage2": lambda: group_ops.select_in_candidates(
                       cand, cxyz, cok, new_xyz, new_mask, sa.radii, sa.nsamples,
                       xyz.shape[1])}
            for k, fn in fns.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                res[f"{n}.{k}"] = {"ms": round(cuda_ms(fn, reps=10), 3), "peak_mib": round(
                    (torch.cuda.max_memory_allocated() - base) / 2**20, 1)}
            res[n] = {"rois": int(cent.shape[0] * cent.shape[1]), "points": int(xyz.shape[1]),
                      "candidates": ck}
    log(f"[{card}] the roi-grouped query alone at B={batch['points'].shape[0]} (CUDA events, "
        "mean of 10; peak above the allocation before the call): " + json.dumps(res))


def nonfinite_origin(out, post) -> dict:
    """Rows with a value not finite in an eval forward's outputs: the RPN's
    box predictions (of every anchor), the valid rois, the valid rois'
    refined boxes (by column) and the kept detections."""
    import torch

    def bad(t):
        return ~torch.isfinite(t.float()).all(-1)

    valid = out["roi_valid"]
    box = out["batch_box_preds"][valid]
    return {"rpn_box_preds": int(bad(out["rpn_box_preds"]).sum()),
            "rois": int(bad(out["rois"][valid]).sum()),
            "refined": int(bad(box).sum()),
            "refined_by_column": (~torch.isfinite(box.float())).sum(0).tolist(),
            "detections": int(bad(post["pred_boxes"][post["pred_valid"]]).sum())}


def eval_batch_agreement(card: str, proof, root: str) -> dict:
    """The gate's final checkpoint through `tools/test_torch.py` on the
    gate's tree at `--batch_size` BENCH_B (batches of 8, 8, 8 and a partial
    1) and at 1, the score threshold at OVERFIT_BATCH_SCORE: each run's
    launches EVAL_LAUNCHES a forward, detections in both, their AP keys
    equal; each frame's detections of the two runs are compared
    (`moved_detections`, logged). Then the cascade is traced on the
    runs' own batches (`cli_batch_trace`): each batch of 8 through the same
    net equals the CLI's outputs bit for bit, and each of its frames alone,
    with the batch's outputs of DENSE_STAGES replaced in after its own were
    held within DENSE_ROUNDING of their max, equals that batch's frame bit
    for bit at every stage. Returns the counts."""
    from pathlib import Path

    import numpy as np
    import torch

    from btcdet_tpu_torch.train.checkpoint import CheckpointManager

    work, run_dir = proof.run_dirs(Path(root))
    mgr = CheckpointManager(run_dir / "ckpt")
    cli, runs = load_tool("test_torch"), {}
    for bs in (BENCH_B, 1):
        argv = ["--cfg_file", str(work / f"{run_dir.name}.yaml"), "--ckpt",
                str(mgr.path(mgr.latest_step())), "--batch_size", str(bs), "--workers", "2",
                "--output_dir", str(work / f"eval_batch_{bs}"), "--set",
                "MODEL.POST_PROCESSING.SCORE_THRESH", str(OVERFIT_BATCH_SCORE)]
        batches = []
        reset_launches()
        (_, _, result, annos), = cli.main(argv, on_batch=lambda i, b, p: batches.append((b, p)))
        torch.cuda.synchronize()
        launches = read_launches()
        assert launches == {k: v * len(batches) for k, v in EVAL_LAUNCHES.items()}, (
            bs, launches)
        assert len(batches) == -(-len(annos) // bs), (bs, len(batches))
        runs[bs] = (proof.ap_keys(result), annos, batches, argv)
    (ap8, annos8, batches8, argv8), (ap1, annos1, batches1, _) = runs[BENCH_B], runs[1]
    assert [a["frame_id"] for a in annos8] == [a["frame_id"] for a in annos1]

    def dets(a):
        boxes = torch.from_numpy(a["boxes_lidar"])
        ok = torch.isfinite(boxes).all(-1)
        return boxes[ok], torch.from_numpy(a["score"])[ok]

    counts = [(len(a["score"]), len(b["score"])) for a, b in zip(annos8, annos1)]
    n_det = sum(a for a, _ in counts)
    assert n_det > 0 and sum(b for _, b in counts) > 0, counts
    nonfinite = [sum(int((~np.isfinite(a["boxes_lidar"]).all(-1)).sum()) for a in annos)
                 for annos in (annos8, annos1)]
    moved = [moved_detections(*dets(a), *dets(b)) for a, b in zip(annos8, annos1)]
    assert ap8.keys() == ap1.keys(), (sorted(ap8), sorted(ap1))
    ap_diff = {k: ap8[k] - ap1[k] for k in ap8 if ap8[k] != ap1[k]}
    res = {"detections": n_det, "frames_count_differs": sum(a != b for a, b in counts),
           "nonfinite_boxes": nonfinite, "moved": sum(len(m) for m in moved),
           "frames_moved": sum(bool(m) for m in moved),
           "max_m": max([d for m in moved for d, _ in m], default=0.0),
           "max_score": max([s for m in moved for _, s in m], default=0.0),
           "ap_keys": len(ap8), "ap_differ": len(ap_diff),
           "ap_max_diff": max(map(abs, ap_diff.values()), default=0.0)}
    log(f"[{card}] the gate's checkpoint through tools/test_torch.py on its {len(annos8)} "
        f"frames, SCORE_THRESH {OVERFIT_BATCH_SCORE}, at --batch_size {BENCH_B} (batches of "
        f"{BENCH_B} and a partial {len(annos8) % BENCH_B or BENCH_B}) against --batch_size 1: "
        f"launches EVAL_LAUNCHES a forward in each; detections (batch 8, batch 1) a frame "
        f"{counts}; " + json.dumps(res) + " (moved: detections with a finite box and no "
        f"counterpart within {SAME_DET}; bound of the flagship geometry test {MOVED_SHARE} of "
        f"them, {MOVED_M} m, {MOVED_SCORE}); AP differences " + json.dumps(ap_diff))
    res.update(cli_batch_trace(card, cli, argv8, batches8, batches1))
    return res


def cli_batch_trace(card: str, cli, argv, batches8, batches1) -> dict:
    """`eval_batch_agreement`'s trace: the CLI's net (`build_eval`, the
    checkpoint loaded) on the batch-8 run's batches and, frame by frame, on
    the batch-1 run's (`frame_views`, `dense_stage_hooks`). Returns the
    trace's readings."""
    import torch

    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import to_device
    from btcdet_tpu_torch.train import checkpoint as ckpt_mod

    args, cfg = cli.parse_config(argv)
    dev = torch.device(args.device)
    net, _, _ = cli.build_eval(args, cfg, None, dev)
    ckpt_mod.load_any(args.ckpt, net)
    post_cfg = cfg.MODEL.POST_PROCESSING
    frame, worst, origin = 0, dict.fromkeys(DENSE_STAGES, 0.0), []
    for host8, cli_post in batches8:
        n = len(host8["frame_id"])
        rec = {}
        with dense_stage_hooks(net, rec):
            big, _, out, post = frame_views(net, to_device(host8, dev), post_cfg)
        for k in ("pred_boxes", "pred_scores", "pred_labels", "pred_valid"):
            assert same_bits(post[k].cpu(), torch.from_numpy(cli_post[k])), (
                f"the batch of frames {frame}-{frame + n - 1} through the CLI's net gives "
                f"other {k} than the CLI's run")
        origin.append(nonfinite_origin(out, post))
        for f in range(n):
            host1, _ = batches1[frame + f]
            assert host1["frame_id"][0] == host8["frame_id"][f]
            got = {}
            with dense_stage_hooks(net, got, dict(rec, frames=[f], n=n)):
                alone, _, _, _ = frame_views(net, to_device(host1, dev), post_cfg)
            rest = frame_differences(big, alone, [f])
            assert not rest, (f"frame {frame + f} alone, with its batch's dense outputs, "
                              f"parts from its batch at {rest}")
            for s in DENSE_STAGES:
                worst[s] = max([worst[s]] + [d / max(m, 1e-30) for d, m in got[s].values()])
        frame += n
    origin = {k: (sum(o[k] for o in origin) if k != "refined_by_column" else
                  [sum(c) for c in zip(*(o[k] for o in origin))]) for k in origin[0]}
    log(f"[{card}] the eval CLI's batches traced: each batch of {BENCH_B} through the CLI's "
        f"net gives the CLI's detections bit for bit; each of its {frame} frames alone, with "
        f"its batch's outputs of {list(DENSE_STAGES)} replaced in, equals its batch's frame "
        f"bit for bit at every stage, those stages' own outputs within "
        f"{json.dumps({s: f'{v:.3e}' for s, v in worst.items()})} of the max (bound "
        f"{DENSE_ROUNDING}); rows not finite in the batch-{BENCH_B} run's outputs "
        + json.dumps(origin))
    assert max(worst.values()) <= DENSE_ROUNDING, worst
    return {"traced_frames": frame, "dense_rounding": worst, "nonfinite_origin": origin}


def dp_worker(args: list) -> int:
    """`chip_smoke.py --dp-worker <task> <io dir> [CLI arguments]`: one
    rank of the seventh path."""
    sys.path.insert(0, REPO)
    task, io, rest = args[0], args[1], args[2:]
    if task == "step":
        dp_step_worker(io, [int(v) for v in rest])
    elif task == "sp":
        sp_flagship_worker(io)
    elif task == "sp_micro":
        sp_micro_worker(io)
    else:
        dp_cli_worker(task, io, rest)
    return 0


# the eval path's two rotated NMSs at B=8: (label, candidates a frame, objects
# a frame, NMS_THRESH, NMS_PRE_MAXSIZE, NMS_POST_MAXSIZE): the car yaml's RPN
# anchors through its proposal NMS, ConvHead's rois through the final NMS
NMS_SHAPES = (("proposal@B8", 70400, 10, 0.7, 1024, 100), ("final@B8", 100, 10, 0.1, 4096, 500))
# flops of one pair's clip: at most 8 vertices against each of 4 edges, about
# 10 float operations each, and the shoelace and IoU
NMS_PAIR_FLOPS = 4 * 8 * 10 + 80


def nms_case(label: str, n: int, objects: int, thresh: float, pre: int, post: int) -> dict:
    """The rotated-NMS kernel on 8 synthetic frames of `n` boxes crowded round
    `objects` cars (scores drawn, three in four valid), against its plain
    version a frame at a time: the same kept indices, the kernel alone (its
    launch only, profiler) and the whole batched call (sort, gathers, corners
    and the launch, CUDA events) beside the plain version's ms, and the bound:
    the clip flops of every pair the plain version's chunks could compare
    (within each chunk walked and against the survivors before it) at
    float32's 67 TFLOP/s."""
    import numpy as np
    import torch

    from btcdet_tpu_torch.ops import iou3d
    from btcdet_tpu_torch.utils import trace

    rng = np.random.RandomState(0)
    B = 8
    centres = np.zeros((B, objects, 7), np.float32)
    centres[..., :2] = rng.uniform([0, -30], [60, 30], (B, objects, 2))
    centres[..., 3:6] = [3.9, 1.6, 1.56]
    centres[..., 6] = rng.uniform(-np.pi, np.pi, (B, objects))
    boxes = np.take_along_axis(centres, rng.randint(0, objects, (B, n))[..., None], axis=1)
    boxes = (boxes + rng.normal(0, 1, (B, n, 7)) * [0.6, 0.6, 0.1, 0.3, 0.15, 0.1, 0.3]
             ).astype(np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6])
    args = [torch.from_numpy(a).cuda() for a in (boxes, rng.rand(B, n).astype(np.float32),
                                                 rng.rand(B, n) < 0.75)]
    kw = dict(thresh=thresh, pre_max_size=pre, post_max_size=post)
    trace.enable()
    idx, ok = iou3d.nms_rotated_batched(*args, **kw)
    rec = trace.disable()
    chunks = rec.tally("nms.chunks")
    for b in range(B):
        p_idx, p_ok = iou3d.nms_rotated_plain(*(t[b] for t in args), **kw)
        assert torch.equal(idx[b], p_idx) and torch.equal(ok[b], p_ok), (label, b)
    k, kept, C = min(pre, n), ok.sum(1).tolist(), iou3d.NMS_CHUNK
    sizes = [min(C, k - i * C) for i in range(-(-k // C))]
    pairs = sum(m * (m - 1) // 2 + m * min(post, i * C)
                for c in chunks.tolist() for i, m in enumerate(sizes[:c]))
    bound_ms = pairs * NMS_PAIR_FLOPS / F32_FLOPS * 1e3
    ms = device_ms(lambda: iou3d.nms_rotated_batched(*args, **kw), "nms_rotated_kernel")
    call_ms = cuda_ms(lambda: iou3d.nms_rotated_batched(*args, **kw), reps=20)
    plain_ms = cuda_ms(lambda: [iou3d.nms_rotated_plain(*(t[b] for t in args), **kw)
                                for b in range(B)], reps=3, warmup=1)
    log(f"rotated NMS {label}: B={B} n={n} k={k} post={post} thresh={thresh} kept {kept} "
        f"chunks {chunks.tolist()} (equal to the plain version, frame by frame) "
        f"ms={ms:.4f} (kernel alone) call_ms={call_ms:.4f} (sort, gathers and launch) "
        f"plain_ms={plain_ms:.4f} (8 frames) bound_ms={bound_ms:.4f} ({pairs} pairs at most)")
    return {"name": f"nms_rotated:{label}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/nms_rotated.cu",
            "replaces": "none (btcdet_tpu/ops/iou3d.py:219 nms_rotated, XLA)",
            "max_abs_err": 0.0, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "flops", "library_ms": None}


# PV-RCNN's keypoint sampling at B=8: (label, frames, points a frame, picks)
FPS_SHAPES = (("pv_rcnn@B8", 8, 16384, 2048), ("large@B2", 2, 40000, 2048))


def fps_case(label: str, B: int, n: int, k: int) -> dict:
    """The FPS kernel on `B` frames of `n` points (uniform over the KITTI
    range, one in twenty masked, as padded slots are) against the plain
    loop on the card: the same indices, one launch a call, the kernel alone
    (profiler) beside the plain loop's ms, and the bound: 10 operations a
    valid point a step at float32's 67 TFLOP/s, or the coordinates read
    once and the picks written at HBM3's rate, whichever is longer."""
    import numpy as np
    import torch

    from btcdet_tpu_torch.ops import group_ops
    from btcdet_tpu_torch.utils import trace

    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(rng.uniform([0, -40, -3], [70.4, 40, 1], (B, n, 3))
                           .astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.rand(B, n) > 0.05).cuda()
    before = trace.COUNTS.get("launch.furthest_point_sample", 0)
    idx = group_ops.furthest_point_sample(xyz, mask, k)
    launches = trace.COUNTS.get("launch.furthest_point_sample", 0) - before
    assert launches == 1, (label, launches)
    plain = group_ops.furthest_point_sample_plain(xyz, mask, k)
    assert torch.equal(idx, plain), (label, (idx != plain).any(1).nonzero().flatten().tolist())
    valid = int(mask.sum())
    flops_s = (k - 1) * valid * 10 / F32_FLOPS
    bytes_s = (B * n * 3 * 4 + B * k * 8) / HBM_BYTES_PER_S
    bound_ms = max(flops_s, bytes_s) * 1e3
    ms = device_ms(lambda: group_ops.furthest_point_sample(xyz, mask, k), "fps_kernel", reps=10)
    plain_ms = cuda_ms(lambda: group_ops.furthest_point_sample_plain(xyz, mask, k), reps=2,
                       warmup=1)
    log(f"FPS {label}: B={B} n={n} k={k} valid {valid} launches {launches} (indices equal to "
        f"the plain loop's) ms={ms:.4f} (kernel alone) plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f}")
    return {"name": f"furthest_point_sample:{label}", "route": "cuda",
            "source": "btcdet_tpu_torch/csrc/furthest_point_sample.cu",
            "replaces": "none (btcdet_tpu/ops/group_ops.py furthest_point_sample, XLA)",
            "launches": launches, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "flops" if flops_s >= bytes_s else "bytes",
            "library_ms": None}


def kernel_bench() -> None:
    """`chip_smoke.py --kernels`: only the backward kernels' cases of the
    full run, for a quick check of a change to them. K4's volume gradient
    on the flagship train step's call and on the `hot` layout, and K2
    max's backward on the flagship PASS_GRAD step's call, each against its
    plain version with its times (K4's by kernel, and its segment
    lengths); the rotated NMS at the eval path's two shapes (`nms_case`);
    and FPS at PV-RCNN's eval shape and past its registers (`fps_case`);
    prints their kernels-line entries (launch counts for FPS only)."""
    import torch

    from btcdet_tpu_torch import config
    from btcdet_tpu_torch.train import trainer

    entries = []
    for edits in ({}, PASS_GRAD_OPTIONS):
        net, opt, batch = train_setup(set_options(config.flagship(), edits), 16384, 10, 0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        calls = capture_kernel_inputs(lambda: trainer.train_step(net, opt, batch, gen))
        if edits:
            entries.append(k2_grad_case(calls["sparse_pool_grad"][0], "max", "pass_grad"))
        else:
            entries.append(k4_grad_case(calls["trilinear_pool_grad"][0][0], "train"))
        del net, opt, batch, calls
    entries.append(k4_grad_case(k4_grad_hot_args(), "hot"))
    entries += [nms_case(*shape) for shape in NMS_SHAPES]
    entries += [fps_case(*shape) for shape in FPS_SHAPES]
    print(json.dumps({"kernels": entries}), flush=True)


def print_contract_line():
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    import torch

    if len(sys.argv) > 3 and sys.argv[1] == "--dp-worker":
        return dp_worker(sys.argv[2:])
    dp_only = sys.argv[1:2] == ["--dp"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    kernels_only = sys.argv[1:] == ["--kernels"]
    side_only = sys.argv[1:] == ["--side"]
    sp_only = sys.argv[1:] == ["--sp"]
    approx_only = sys.argv[1:] == ["--approx"]
    b8_only = sys.argv[1:] == ["--b8"]
    syncs_only = sys.argv[1:] == ["--syncs"]
    gate_only = sys.argv[1:] == ["--gate"]
    overfit = sys.argv[1:] in (["--overfit"], ["--overfit", "--three_classes"])
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
                        "trilinear_pool", "nms_rotated", "furthest_point_sample"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, text in kernel_build.BUILD_LOGS.items():
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = ptxas_function(line)
            elif "registers" in line or "bytes smem" in line:
                log(f"  ptxas[{name}{fn}]: {line.strip()}")
    if kernels_only:
        kernel_bench()
        log(f"chip_smoke --kernels: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if side_only:
        keys = ("name", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        entries = side_modules_path(card)
        log(f"chip_smoke --side: {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}), flush=True)
        return 0
    if sp_only:
        launches = sp_path(card)
        log(f"chip_smoke --sp: {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"launches_a_rank": launches}), flush=True)
        return 0
    if approx_only:
        approx_query_path(card)
        log(f"chip_smoke --approx: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if dp_only:
        dp_step_phase(card, DP_PROJ_SEEDS + tuple(int(v) for v in sys.argv[2:]))
        log(f"chip_smoke {' '.join(sys.argv[1:])}: {time.perf_counter() - t_start:.1f} s in all")
        return 0
    if b8_only:
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        entries = bench_path(card)
        log(f"chip_smoke --b8: {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}), flush=True)
        print_contract_line()
        return 0
    if syncs_only:
        res = sync_path(card)
        log(f"chip_smoke --syncs: {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"read_backs_a_batch": res}), flush=True)
        return 0
    if gate_only or overfit:
        res = overfit_path(card, full=overfit, three_classes="--three_classes" in sys.argv)
        log(f"chip_smoke {' '.join(sys.argv[1:])}: {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"overfit_proof" if overfit else "overfit_gate": res}), flush=True)
        print_contract_line()
        return 0

    # 2b. first path: bench.py's main path as shipped (B=8, the approximate query)
    b8_kernels = bench_path(card)

    # 2c. the sync-debug check: every synchronisation of the eval forward +
    # post-processing is a named read-back
    sync_path(card)

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

    # 4. kernel phase
    picks = eval_conv_picks(convs)
    kernels = [e for name, args in picks.items() for e in k1_case(name, args)]
    k1_eval_table(captured["sparse_conv"], captured["neighbor_map"])
    assert len(calls["sparse_pool"]) == 1, len(calls["sparse_pool"])
    kernels.append(k2_case(captured["sparse_pool"][0]))
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
    assert launches == EVAL_LAUNCHES, (launches, EVAL_LAUNCHES)
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
    merge_repeat(net, batch)
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

    # 5d. fourth path: the evaluation entry point on a KITTI tree (and the
    # seventh path's eval CLI under torchrun)
    eval_cli_phase(card)

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

    # 8. sixth path: the training entry point on a KITTI tree (and the
    # seventh path's train CLI under torchrun)
    train_cli_phase(card)

    # 8b. seventh path: the data-parallel train step, 2 ranks on the card
    dp_step_phase(card)

    # 8c. eighth path: the occupancy subnet's options
    kernels += occ_options_path()

    # 8d. ninth path: the det-side options and the 3-class config
    kernels += det_options_path(card)

    # 8e. tenth path: the side modules no config names
    kernels += side_modules_path(card)

    # 8f. eleventh path: BEV row sharding, 2 ranks on the card
    sp_path(card)

    # 8g. twelfth path: the flagship yaml as shipped (ConvHead's roi-grouped
    # approximate ball query)
    approx_query_path(card)

    # 8h. thirteenth path: the overfit proof's short gate
    gate = overfit_path(card)

    # 9. results
    log(f"profiler sessions that missed their kernel (timed by CUDA events instead): "
        f"{len(PROFILER_MISSES)} {PROFILER_MISSES}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"overfit_gate": gate}), flush=True)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels + b8_kernels]}),
          flush=True)
    print_contract_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
