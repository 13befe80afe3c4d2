"""Evaluation entry point of the PyTorch port (counterpart of tools/test.py).

Evaluates one checkpoint on a KITTI split with the official AP, or polls a
checkpoint directory (`--eval_all`), tracking the best mAP per class and
metric (reference `repeat_eval_ckpt:84`, `update_3d_map:141`). Runs on the
CUDA card unless `--device cpu` is passed; there is no silent CPU fallback.

    python -m btcdet_tpu_torch.datasets.kitti.kitti_infos <kitti_root>
    python tools/test_torch.py --cfg_file tools/cfgs/model_configs/btcdet_kitti_car.yaml \\
        --ckpt <checkpoint .pth, the port's or the reference BtcDet's> --batch_size 2 \\
        --set DATA_CONFIG.DATA_PATH <kitti_root>

    python -m torch.distributed.run --nproc_per_node 8 tools/test_torch.py \\
        --launcher pytorch --cfg_file ... --ckpt ...   # data parallel, one process a GPU

A config that leaves ROI_HEAD.APPROX_QUERY unset (the flagship yaml) runs
ConvHead's roi-grouped approximate ball query, as the JAX package does;
`--set MODEL.ROI_HEAD.APPROX_QUERY False` selects the reference CUDA's
exact query, for reference-trained `.pth` checkpoints. With a
--launcher each rank evaluates its shard of the split (`--batch_size`
frames a process) and the results are merged in frame order; rank 0
logs and writes the files.
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from btcdet_tpu_torch import parallel  # noqa: E402
from btcdet_tpu_torch.config import EasyDict, cfg_from_list, cfg_from_yaml_file  # noqa: E402
from btcdet_tpu_torch.utils.common import create_logger, resolve_device  # noqa: E402


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=1, help="frames a process")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="one checkpoint file: the port's or a reference BtcDet .pth")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument("--vis_stride", type=int, default=0,
                        help="dump every Nth batch as a cloud .npy for "
                             "tools/visual_utils/visualize_pc.py (0 = off)")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none",
                        help="data parallel over processes started by torchrun ('pytorch') "
                             "or srun ('slurm'), one a GPU")
    parser.add_argument("--tcp_port", type=int, default=18888,
                        help="rendezvous port of --launcher slurm without MASTER_PORT")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="default nccl on CUDA, gloo on the CPU")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="default output/<cfg name>/<extra_tag>/eval")
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file, EasyDict())
    cfg.TAG = Path(args.cfg_file).stem
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def build_eval(args, cfg, logger, device):
    from btcdet_tpu_torch.datasets import build_dataloader
    from btcdet_tpu_torch.models import build_network

    dataset, dl, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.batch_size,
                                      dist=parallel.data_parallel_group() is not None,
                                      workers=args.workers, logger=logger, training=False)
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, cfg.CLASS_NAMES, device=device)
    return net, dl, dataset


def eval_ckpt(net, dl, dataset, cfg, args, result_dir, logger, on_batch=None):
    from btcdet_tpu_torch.train import eval_utils

    post = cfg.MODEL.POST_PROCESSING
    return eval_utils.eval_one_epoch(
        net, dl, dataset, post, cfg.CLASS_NAMES, logger=logger,
        result_dir=result_dir if args.save_to_file else None,
        recall_thresh_list=post.RECALL_THRESH_LIST,
        cloud_dir=(result_dir / "cloud") if args.vis_stride else None,
        vis_stride=args.vis_stride, on_batch=on_batch)


class BestMapTracker:
    """Per-class / per-difficulty / per-metric best-mAP incumbents with the
    step that reached them (reference `update_3d_map` / `update_bev_map`,
    `tools/test.py:141-218`, over every metric family)."""

    FAMILIES = ("3d", "bev", "image", "aos")
    DIFFS = ("easy", "moderate", "hard")

    def __init__(self, class_names):
        self.class_names = list(class_names)
        self.best = {}  # key -> (value, step)

    def update(self, result_dict, step):
        improved = []
        for cls in self.class_names:
            for fam in self.FAMILIES:
                for diff in self.DIFFS:
                    for key in (f"{cls}_{fam}/{diff}_R40", f"{cls}_{fam}/11R_{diff}"):
                        v = result_dict.get(key)
                        if v is None:
                            continue
                        if v > self.best.get(key, (-1.0, None))[0]:
                            self.best[key] = (float(v), step)
                            improved.append(key)
        return improved

    def summary(self):
        lines = []
        for fam in self.FAMILIES:
            for cls in self.class_names:
                row = []
                for metric in ("R40", "11R"):
                    for diff in self.DIFFS:
                        key = (f"{cls}_{fam}/{diff}_R40" if metric == "R40"
                               else f"{cls}_{fam}/11R_{diff}")
                        if key in self.best:
                            v, s = self.best[key]
                            row.append(f"{metric}_{diff}={v:.2f}@{s}")
                if row:
                    lines.append(f"best {cls}_{fam}: " + "  ".join(row))
        return "\n".join(lines)


def main(argv=None, on_batch=None) -> list:
    """Run the CLI; returns [(step, result_str, result_dict, det_annos)] of
    every checkpoint evaluated. `on_batch(batch_idx, batch, outputs)` is
    handed to the eval loop. With a --launcher the process joins its
    data-parallel group first and leaves it at the end."""
    args, cfg = parse_config(argv)
    local_rank = None
    if args.launcher != "none":
        backend = args.dist_backend or ("gloo" if args.device == "cpu" else "nccl")
        local_rank = parallel.init_dist(args.launcher, backend, args.tcp_port)
    try:
        return _main(args, cfg, local_rank, on_batch)
    finally:
        parallel.destroy()


def _main(args, cfg, local_rank, on_batch) -> list:
    device = resolve_device(args.device, local_rank)
    rank = parallel.get_dist_info()[0]
    from btcdet_tpu_torch.train import checkpoint as ckpt_mod

    output_dir = Path(args.output_dir or Path("output") / cfg.TAG / args.extra_tag / "eval")
    output_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    logger = create_logger(output_dir / f"eval_{stamp}.log", rank=rank)
    logger.info(f"device {device}; config {args.cfg_file}; overrides {args.set_cfgs}")
    net, dl, dataset = build_eval(args, cfg, logger, device)

    def evaluate(step):
        step_dir = output_dir / f"step_{step}" / "val"
        if args.save_to_file or args.vis_stride:
            step_dir.mkdir(parents=True, exist_ok=True)
        result_str, result_dict, det_annos = eval_ckpt(net, dl, dataset, cfg, args, step_dir,
                                                       logger, on_batch)
        if rank == 0:
            with open(output_dir / "eval_list_val.txt", "a") as f:
                f.write(f"{step}\n")  # reference test.py:86-88 eval record
        return step, result_str, result_dict, det_annos

    if args.ckpt is not None:
        step = ckpt_mod.load_any(args.ckpt, net)
        logger.info(f"evaluating {args.ckpt} (step {step})")
        return [evaluate(step)]

    mgr = ckpt_mod.CheckpointManager(
        args.ckpt_dir or Path("output") / cfg.TAG / args.extra_tag / "ckpt")
    done, results = set(), []
    best = BestMapTracker(cfg.CLASS_NAMES)
    wait_start = time.time()
    while True:
        # rank 0's reading of the directory, so that every rank evaluates the same
        steps = parallel.broadcast_object(mgr.all_steps() if args.eval_all
                                          else [mgr.latest_step()])
        todo = [s for s in steps if s is not None and s not in done]
        if not todo:
            if not args.eval_all or parallel.broadcast_object(
                    time.time() - wait_start > args.max_waiting_mins * 60):
                break
            time.sleep(30)
            continue
        for s in sorted(todo):
            mgr.restore(net, step=s)
            logger.info(f"evaluating checkpoint step {s}")
            results.append(evaluate(s))
            for k in best.update(results[-1][2], s):
                logger.info(f"new best {k}: {best.best[k][0]:.4f} (step {s})")
            done.add(s)
            wait_start = time.time()
        if not args.eval_all:
            break
    if not results:
        logger.warning(f"no checkpoint under {mgr.ckpt_dir}")
    summary = best.summary()
    if summary:
        logger.info("best results (value@step):\n" + summary)
    return results


if __name__ == "__main__":
    main()
