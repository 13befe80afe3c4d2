"""Training entry point of the PyTorch port (counterpart of tools/train.py).

Trains BtcDet on a KITTI tree with the yaml's data augmentor (gt sampling,
best-match points, world flip / scaling / rotation), the dual occ / det
`adam_onecycle` and checkpoint rotation; auto-resumes from the newest
checkpoint in the output dir (reference `train.py:157-163`), then evaluates
the newest checkpoints on the val split (reference `train.py:202-222`).
Runs on the CUDA card unless `--device cpu` is passed; there is no silent
CPU fallback.

    python -m btcdet_tpu_torch.datasets.kitti.kitti_infos <kitti_root>
    python -m btcdet_tpu_torch.datasets.bestmatch <kitti_root>
    python tools/train_torch.py --cfg_file tools/cfgs/model_configs/btcdet_kitti_car.yaml \\
        --set DATA_CONFIG.DATA_PATH <kitti_root>
    python tools/train_torch.py --cfg_file ... --synthetic --epochs 1 --steps 5   # no data
    python tools/train_torch.py --cfg_file ... --pre_occ output/<cfg>/occ_run/ckpt  # staged
    python -m torch.distributed.run --nproc_per_node 8 tools/train_torch.py \\
        --launcher pytorch --cfg_file ...      # data parallel, one process a GPU

A config that leaves ROI_HEAD.APPROX_QUERY unset (the flagship yaml) trains
with ConvHead's roi-grouped approximate ball query, as the JAX package
does; `--set MODEL.ROI_HEAD.APPROX_QUERY False` selects the reference
CUDA's exact query, for reference-trained `.pth` checkpoints. A step's
random draws come from a generator seeded by (--seed, global step), each
epoch's order and per-frame augmentation from (--seed, epoch), so a resumed
run trains as an unbroken one would.

Data parallel (`--launcher pytorch` under torchrun, or `slurm` under
srun): `--batch_size` frames a process, each rank reading its shard of
every epoch (`datasets.ShardSampler`); a step computes what one process
computes on the global batch, and the ranks keep equal weights
(`btcdet_tpu_torch.parallel`). Rank 0 logs, writes tensorboard and the
checkpoints; the trailing evaluation is distributed too.
"""

from __future__ import annotations

import argparse
import datetime
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from btcdet_tpu_torch import parallel  # noqa: E402
from btcdet_tpu_torch.config import EasyDict, cfg_from_list, cfg_from_yaml_file  # noqa: E402
from btcdet_tpu_torch.utils.common import create_logger, resolve_device  # noqa: E402


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="frames a process (default OPTIMIZATION.BATCH_SIZE_PER_GPU)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--cache_items", action="store_true",
                        help="memoize dataset items (deterministic-aug runs only)")
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--pre_occ", type=str, default=None,
                        help="load occ params only from this ckpt dir")
    parser.add_argument("--pre_det", type=str, default=None,
                        help="load det params only from this ckpt dir")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic batches (no KITTI needed)")
    parser.add_argument("--steps", type=int, default=None,
                        help="cap steps per epoch (smoke runs); logs every step")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_steps", type=str, default=None,
                        help="torch.profiler trace over global steps A-B (e.g. '10-15') into "
                             "<output_dir>/profile")
    parser.add_argument("--vis_stride", type=int, default=0,
                        help="dump every Nth batch as a cloud .npy for "
                             "tools/visual_utils/visualize_pc.py (0 = off)")
    parser.add_argument("--num_epochs_to_eval", type=int, default=30,
                        help="after training, evaluate this many newest checkpoints on the val "
                             "split (0 = off; off with --synthetic)")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none",
                        help="data parallel over processes started by torchrun ('pytorch') "
                             "or srun ('slurm'), one a GPU")
    parser.add_argument("--tcp_port", type=int, default=18888,
                        help="rendezvous port of --launcher slurm without MASTER_PORT")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="default nccl on CUDA, gloo on the CPU")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="default output/<cfg name>/<extra_tag>")
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file, EasyDict())
    cfg.TAG = Path(args.cfg_file).stem
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def make_dataloader(args, cfg, logger, device):
    """(loader(epoch) -> iterator of numpy batches, steps per epoch,
    dataset or None). In a data-parallel run each rank reads its
    `ShardSampler` shard (synthetic batches: its frames of the global
    batch)."""
    bs = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    rank, world = parallel.get_dist_info()
    if args.synthetic:
        from btcdet_tpu_torch.datasets import make_synthetic_batch_np
        from btcdet_tpu_torch.train.trainer import split_batch

        steps = args.steps or 10

        def synthetic(epoch):
            for i in range(steps):
                b = make_synthetic_batch_np(cfg.DATA_CONFIG, batch_size=bs * world,
                                            num_points=16384, num_gt=10,
                                            seed=epoch * 10000 + i, mode="train")
                yield b if world == 1 else split_batch(b, rank, world)

        return synthetic, steps, None

    from btcdet_tpu_torch.datasets import build_dataloader, set_epoch

    # the cache is sound only with the stochastic augmentation disabled
    dataset, dl, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, bs, dist=True,
                                      workers=0 if args.cache_items else args.workers,
                                      logger=logger, training=True, seed=args.seed,
                                      cache_items=args.cache_items)
    if args.cache_items:
        logger.info("item cache on (deterministic __getitem__ assumed)")
    steps = min(args.steps, len(dl)) if args.steps else len(dl)

    def loader(epoch):
        set_epoch(dataset, dl, epoch)
        for i, b in enumerate(dl):
            if i >= steps:
                break
            yield b

    return loader, steps, dataset


def dump_train_cloud(cloud_dir: Path, epoch: int, i: int, batch: dict):
    """The batch's first frame for tools/visual_utils/visualize_pc.py
    (reference `train_utils.py:153-154` pc_{epoch}_{iter}.npy)."""
    cloud_dir.mkdir(parents=True, exist_ok=True)
    d = {}
    p = np.asarray(batch["points"][0])
    d["gt_points"] = p[np.abs(p[:, :3]).sum(1) > 0][:, :3]
    if "bm_points" in batch:
        bm = np.asarray(batch["bm_points"][0])
        d["boxvoxel_center"] = bm[np.asarray(batch["bm_points_mask"][0]).astype(bool)][:, :3]
    if "gt_boxes" in batch:
        gb = np.asarray(batch["gt_boxes"][0])
        d["gt_boxes"] = gb[np.abs(gb[:, 3:6]).sum(1) > 0][:, :7]
    np.save(cloud_dir / f"pc_{epoch}_{i}.npy", d)


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def main(argv=None, on_step=None, on_epoch_end=None) -> dict:
    """Run the CLI. `on_step(gstep, batch, metrics)` is called after each
    step (numpy batch, metrics as device tensors); `on_epoch_end(epoch,
    step)` after each epoch's checkpoint, and training stops there when it
    returns True (as a run cut after that checkpoint). Returns {output_dir,
    steps_per_epoch, start_step, steps_run, history [(global step, metrics
    floats) of the logged steps], time_ms (the loop's wall ms: waiting on
    the loader, the steps, the host's work between them), profile
    (profiler, wall ms) or None, eval [(step, result dict)], stopped}.
    With a --launcher the process joins its data-parallel group first and
    leaves it at the end."""
    args, cfg = parse_config(argv)
    local_rank = None
    if args.launcher != "none":
        backend = args.dist_backend or ("gloo" if args.device == "cpu" else "nccl")
        local_rank = parallel.init_dist(args.launcher, backend, args.tcp_port)
    try:
        return _main(args, cfg, local_rank, on_step, on_epoch_end)
    finally:
        parallel.destroy()


def _main(args, cfg, local_rank, on_step, on_epoch_end) -> dict:
    device = resolve_device(args.device, local_rank)
    rank, world = parallel.get_dist_info()
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import to_device
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import checkpoint as ckpt_mod
    from btcdet_tpu_torch.train import trainer

    output_dir = Path(args.output_dir or Path("output") / cfg.TAG / args.extra_tag)
    output_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    logger = create_logger(output_dir / f"train_{stamp}.log", rank=rank)
    logger.info(f"device {device}; config {args.cfg_file}; overrides {args.set_cfgs}")
    if args.launcher != "none":
        logger.info(f"data parallel: {world} ranks over {args.launcher}, "
                    f"{args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU} frames a rank")
    tb = None
    if rank == 0:
        shutil.copy(args.cfg_file, output_dir / Path(args.cfg_file).name)
        # the config as run (yaml, its base config and --set merged)
        (output_dir / f"{cfg.TAG}_merged.yaml").write_text(yaml.safe_dump(_plain(cfg),
                                                                          sort_keys=False))
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(str(output_dir / "tensorboard"))
        except ImportError:
            logger.info("tensorboard unavailable; scalar logging to the log only")

    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    loader, steps_per_epoch, _ = make_dataloader(args, cfg, logger, device)
    total_steps = epochs * steps_per_epoch
    torch.manual_seed(args.seed)
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, cfg.CLASS_NAMES, device=device)
    occ_opt = cfg.get("OCC_OPTIMIZATION", None)
    opt = trainer.create_train_state(net, cfg.OPTIMIZATION, occ_opt, total_steps)
    n_params = sum(p.numel() for p in net.parameters())
    logger.info(f"model parameters: {n_params / 1e6:.2f}M, total steps: {total_steps}")

    mgr = ckpt_mod.CheckpointManager(output_dir / "ckpt", max_to_keep=args.max_ckpt_save_num)
    if args.pre_occ:
        n = ckpt_mod.load_partial(args.pre_occ, net, want_occ=True)
        logger.info(f"loaded {n} occ entries from {args.pre_occ}")
    if args.pre_det:
        n = ckpt_mod.load_partial(args.pre_det, net, want_occ=False)
        logger.info(f"loaded {n} det entries from {args.pre_det}")
    start_step = mgr.restore(net, opt) or 0
    parallel.broadcast_state(net)   # every rank starts from rank 0's weights
    start_epoch = start_step // steps_per_epoch
    if start_step:
        logger.info(f"auto-resumed from step {start_step} (epoch {start_epoch})")
    frozen = trainer.frozen_partitions(cfg.OPTIMIZATION, occ_opt)
    if frozen:
        logger.info(f"frozen partitions (LR 0, no gradient): {frozen}")

    prof_lo = prof_hi = -1
    if args.profile_steps and rank == 0:
        lo, _, hi = args.profile_steps.partition("-")
        prof_lo, prof_hi = int(lo), int(hi or int(lo) + 1)
    cloud_dir = output_dir / "cloud"
    # occ-debug views every STEP_STRIDE steps (reference
    # add_occ_template.visualize:290-422, gated by OCC_PNT_UPDATE.VIS)
    vis_cfg = cfg.MODEL.get("OCC", {}).get("OCC_PNT_UPDATE", {}).get("VIS", None)
    occ_vis_every = int(vis_cfg.get("STEP_STRIDE", 1000)) if vis_cfg and rank == 0 else 0
    if occ_vis_every:
        from btcdet_tpu_torch.models.detectors.btcnet import VIS_MASK_KEYS
        from btcdet_tpu_torch.models.occ import occ_targets
        from btcdet_tpu_torch.train.eval_utils import to_host
        from btcdet_tpu_torch.utils import vis_utils

        occ_spec = occ_targets.build_grid_spec(cfg.DATA_CONFIG)
        vis_keys = VIS_MASK_KEYS + ("occ_probs", "occ_points", "occ_points_mask")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def stop_profiler(prof, t_prof, end) -> float:
        """Stop the trace after global step `end`, write it; its wall ms."""
        sync()
        prof.stop()
        wall = (time.perf_counter() - t_prof) * 1e3
        (output_dir / "profile").mkdir(exist_ok=True)
        prof.export_chrome_trace(str(output_dir / "profile" / f"steps_{prof_lo}_{end}.json"))
        logger.info(f"profiler trace of steps {prof_lo}-{end} saved to {output_dir / 'profile'}")
        return wall

    time_ms = dict.fromkeys(("loader", "step", "host"), 0.0)
    history, prof, prof_wall, steps_run, stopped = [], None, None, 0, False
    for epoch in range(start_epoch, epochs):
        t_mark = time.perf_counter()
        for i, batch in enumerate(loader(epoch)):
            t_got = time.perf_counter()
            gstep = epoch * steps_per_epoch + i
            if gstep == prof_lo:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if device.type == "cuda" else [])
                prof = profile(activities=acts)
                sync()
                prof.start()
                t_prof = time.perf_counter()
            keep = (dict.fromkeys(vis_keys)
                    if occ_vis_every and (gstep + 1) % occ_vis_every == 0 else None)
            metrics = trainer.train_step(net, opt, to_device(batch, device),
                                         trainer.step_generator(args.seed, gstep, device),
                                         keep=keep)
            logged = i % 10 == 0 or bool(args.steps)
            m = trainer.read_metrics(metrics) if logged else None
            t_dev = time.perf_counter()
            time_ms["loader"] += (t_got - t_mark) * 1e3
            time_ms["step"] += (t_dev - t_got) * 1e3
            steps_run += 1
            if gstep + 1 == prof_hi and prof is not None:
                prof_wall = stop_profiler(prof, t_prof, gstep + 1)
            if args.vis_stride and i % args.vis_stride == 0 and rank == 0:
                dump_train_cloud(cloud_dir, epoch, i, batch)
            if keep is not None:
                tb_imgs, pc = vis_utils.collect_occ_vis_clouds(
                    to_host({k: v for k, v in keep.items() if v is not None}), batch, occ_spec,
                    vis_cfg)
                if pc:
                    cloud_dir.mkdir(parents=True, exist_ok=True)
                    np.save(cloud_dir / f"occ_vis_{gstep + 1}.npy", pc)
                if tb is not None:
                    for k, img in tb_imgs.items():
                        tb.add_image(f"occ/{k}", img, gstep + 1, dataformats="HWC")
            if logged:
                history.append((gstep, m))
                msg = "  ".join(f"{k}={v:.4f}" for k, v in m.items())
                logger.info(f"epoch {epoch} it {i}/{steps_per_epoch}  {msg}")
                if tb is not None:
                    for k, v in m.items():
                        tb.add_scalar(("occ/" if k.startswith("occ") else "train/") + k, v,
                                      gstep)
            if on_step is not None:
                on_step(gstep, batch, metrics)
            t_mark = time.perf_counter()
            time_ms["host"] += (t_mark - t_dev) * 1e3
        step = (epoch + 1) * steps_per_epoch
        if (epoch + 1) % args.ckpt_save_interval == 0 or epoch == epochs - 1:
            mgr.save(step, net, opt)
            logger.info(f"saved checkpoint at step {step}")
        if on_epoch_end is not None and on_epoch_end(epoch, step):
            stopped = True
            break
    if prof is not None and prof_wall is None:  # the run ended inside the window
        prof_wall = stop_profiler(prof, t_prof, gstep + 1)
    logger.info(f"training {'stopped' if stopped else 'done'}: {steps_run} steps; loop wall ms "
                + ", ".join(f"{k} {v:.2f}" for k, v in time_ms.items()))
    result = {"output_dir": output_dir, "steps_per_epoch": steps_per_epoch,
              "start_step": start_step, "steps_run": steps_run, "history": history,
              "time_ms": time_ms, "profile": None if prof is None else (prof, prof_wall),
              "eval": [], "stopped": stopped}
    if not stopped and args.num_epochs_to_eval > 0 and not args.synthetic:
        result["eval"] = eval_with_train(args, cfg, net, mgr, output_dir, logger, tb)
    return result


def eval_with_train(args, cfg, net, mgr, output_dir, logger, tb) -> list:
    """The trailing evaluation of the newest `--num_epochs_to_eval`
    checkpoints on the val split (reference `train.py:202-222`, its
    `repeat_eval_ckpt`), over the ranks of a data-parallel run; returns
    [(step, result dict)]."""
    from btcdet_tpu_torch.datasets import build_dataloader
    from btcdet_tpu_torch.train import eval_utils

    eval_dir = output_dir / "eval" / "eval_with_train"
    eval_dir.mkdir(parents=True, exist_ok=True)
    bs = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    val_ds, vdl, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, bs,
                                      dist=parallel.data_parallel_group() is not None,
                                      workers=args.workers, logger=logger, training=False)
    post = cfg.MODEL.POST_PROCESSING
    best, out = {}, []
    for s in parallel.broadcast_object(mgr.all_steps()[-args.num_epochs_to_eval:]):
        mgr.restore(net, step=s)
        logger.info(f"eval_with_train: checkpoint step {s}")
        step_dir = eval_dir / f"step_{s}" / "val"
        step_dir.mkdir(parents=True, exist_ok=True)
        _, result, _ = eval_utils.eval_one_epoch(
            net, vdl, val_ds, post, cfg.CLASS_NAMES, logger=logger, result_dir=step_dir,
            recall_thresh_list=post.RECALL_THRESH_LIST)
        for k, v in result.items():
            if tb is not None and isinstance(v, (int, float)):
                tb.add_scalar(f"eval/{k}", float(v), s)
            if k.endswith("_R40") and v > best.get(k, -1):
                best[k] = v
                logger.info(f"new best {k}: {v:.4f} (step {s})")
        if parallel.get_dist_info()[0] == 0:
            with open(eval_dir / "eval_list_val.txt", "a") as f:
                f.write(f"{s}\n")
        out.append((s, result))
    logger.info(f"eval_with_train best results: {best}")
    return out


if __name__ == "__main__":
    main()
