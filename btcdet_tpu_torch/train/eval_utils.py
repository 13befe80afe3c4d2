"""Evaluation loop and occupancy metrics (counterpart of
`btcdet_tpu/train/eval_utils.py`, reference `tools/eval_utils/eval_utils.py`
and `detector3d_template.py:479-591`).

    _, result, det_annos = eval_one_epoch(net, dataloader, dataset, cfg.MODEL.POST_PROCESSING,
                                          cfg.CLASS_NAMES)

Each collated batch goes to the net's device (`to_device`), through the
eval forward and post-processing (`infer`), and its outputs come back to
the host in one copy (`to_host`); the KITTI-format predictions, recall
records and occupancy statistics are then numpy on the host.

In a data-parallel run each rank evaluates its `datasets.ShardSampler`
shard; the per-frame results (annos, recall records, coverage counts, and
each batch's occupancy statistics with its first frame) are merged in
dataset order without the shard padding (`parallel.merge_results_dist`),
the AP is computed on rank 0 and broadcast. With BEV row sharding the
ranks of a spatial group infer the same frames and return the same
detections: their first rank's results go into the merge.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..datasets.kitti.kitti_dataset import to_device
from ..models.detectors.btcnet import post_processing
from ..parallel import (broadcast_object, get_dist_info, get_sp_info, is_lead,
                        merge_results_dist)
from ..ops import iou3d
from ..utils import box_utils

# outputs of the eval forward the loop reads besides the detections
_OUT_KEYS = ("rois", "roi_valid", "occ_probs", "occ_pos_mask", "occ_cls_mask", "occ_points",
             "occ_points_mask")


def _dump_cloud(cloud_dir: Path, batch_idx: int, batch: dict, post: dict):
    """Write a named point-set dict `.npy` per frame for
    tools/visual_utils/visualize_pc.py (reference `eval_utils.py:119-120`)."""
    cloud_dir.mkdir(parents=True, exist_ok=True)
    for b in range(post["pred_boxes"].shape[0]):
        d = {"gt_points": batch["points"][b][batch["points_mask"][b]][:, :3]}
        if "occ_points" in post:
            d["addpnt_view"] = post["occ_points"][b][post["occ_points_mask"][b]][:, :3]
        if "gt_boxes" in batch:
            gb = batch["gt_boxes"][b]
            d["gt_boxes"] = gb[np.abs(gb[:, 3:6]).sum(1) > 0][:, :7]
        pv = post["pred_valid"][b]
        d["pred_boxes"] = post["pred_boxes"][b][pv][:, :7]
        d["pred_scores"] = post["pred_scores"][b][pv]
        np.save(cloud_dir / f"pc_eval_{batch_idx}_{b}.npy", d)


def occ_match_stats(probs, targets, thresholds=(0.3, 0.5, 0.7)):
    """Voxel occupancy precision / recall / F1 at thresholds (reference
    `occ_post_processing:479` + `eval_utils.get_match_stats:23`)."""
    pos = np.asarray(targets["pos_mask"], bool)
    mask = np.asarray(targets["general_cls_loss_mask"], bool)
    p = np.asarray(probs)
    out = {}
    for t in thresholds:
        pred = (p > t) & mask
        tp = (pred & pos).sum()
        prec = tp / max(pred.sum(), 1)
        rec = tp / max((pos & mask).sum(), 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        out[f"occ_precision@{t}"] = float(prec)
        out[f"occ_recall@{t}"] = float(rec)
        out[f"occ_f1@{t}"] = float(f1)
    return out


def occ_box_coverage(occ_points, occ_mask, gt_boxes,
                     thresholds=tuple(t / 10.0 for t in range(1, 10))):
    """Per-threshold gt-box coverage (reference `detector3d_template.py:515-535`):
    for each threshold, the count of gt boxes holding at least one
    predicted occupancy point of prob >= threshold. occ_points (K, >=4)
    xyz + prob; gt_boxes (M, 7+), zero rows ignored."""
    gb = np.asarray(gt_boxes)
    gb = gb[np.abs(gb[:, 3:6]).sum(-1) > 0]
    pts = np.asarray(occ_points)[np.asarray(occ_mask).astype(bool)]
    out = {"box_num_sum": int(len(gb))}
    if len(gb) == 0 or len(pts) == 0:
        out["occ_box_num"] = [0] * len(thresholds)
        return out
    inbox = box_utils.points_in_boxes_mask_np(pts[:, :3], gb[:, :7])
    prob = pts[:, 3]
    out["occ_box_num"] = [int(inbox[prob >= t].any(axis=0).sum()) for t in thresholds]
    return out


def _iou3d_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return iou3d.boxes_iou3d(torch.from_numpy(np.ascontiguousarray(a)),
                             torch.from_numpy(np.ascontiguousarray(b))).numpy()


def recall_record(pred_boxes, pred_valid, rois, roi_valid, gt_boxes, thresh_list):
    """One frame's roi / rcnn recall against its gt at 3D IoU thresholds
    (reference `generate_recall_record:548`); numpy in, counts out."""
    out = {f"roi_{t}": 0 for t in thresh_list}
    out.update({f"rcnn_{t}": 0 for t in thresh_list})
    gt7 = gt_boxes[:, :7][gt_boxes[:, 7] > 0]
    out["gt"] = len(gt7)
    if len(gt7) == 0:
        return out
    for name, boxes, valid in (("roi", rois, roi_valid), ("rcnn", pred_boxes, pred_valid)):
        if valid.any():
            iou = _iou3d_np(gt7, boxes[valid][:, :7])
            best = iou.max(axis=1)
            for t in thresh_list:
                out[f"{name}_{t}"] = int((best > t).sum())
    return out


def infer(net, batch: dict, post_cfg, num_class: int = 1) -> dict:
    """The eval forward + post-processing of `net` (put in eval mode) on a
    device batch: the detections (pred_boxes / pred_scores / pred_labels /
    pred_valid) and the forward's rois and occupancy outputs, on the device."""
    net.eval()
    with torch.inference_mode():
        out = net(batch)
        post = post_processing(out, post_cfg, num_class, device=batch["points"].device)
    post.update({k: out[k] for k in _OUT_KEYS if k in out})
    return post


def to_host(tensors: dict) -> dict:
    """Numpy copies of a dict of device tensors, in one device-to-host
    copy: the tensors' bytes packed into one buffer, then split and viewed
    back on the host."""
    names = list(tensors)
    flat = [tensors[k].contiguous().reshape(-1) for k in names]
    packed = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = {}, 0
    for k, t in zip(names, flat):
        n = t.numel() * t.element_size()
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out[k] = packed[off:off + n].view(dt).reshape(tuple(tensors[k].shape))
        off += n
    return out


def eval_one_epoch(net, dataloader, dataset, post_cfg, class_names, logger=None,
                   result_dir=None, recall_thresh_list=(0.3, 0.5, 0.7), cloud_dir=None,
                   vis_stride: int = 0, on_batch=None):
    """Reference `eval_one_epoch:41`: every batch of `dataloader` through
    `infer` on the net's device; returns (result string, result dict,
    det_annos). The result dict holds the official AP keys, recall,
    sec_per_example / frames_per_sec, the occupancy precision / recall /
    F1 (means over batches), the occ box coverage, and `time_ms`, the
    loop's wall ms in its parts. With `result_dir` the KITTI txt files and
    pc_rc.pkl are written there; with `cloud_dir` and `vis_stride > 0`
    every vis_stride-th batch is dumped for tools/visual_utils/visualize_pc.py
    (by rank 0 in a data-parallel run, whose loop covers this rank's
    shard and returns the merged results on every rank).
    `on_batch(batch_idx, batch, host_outputs)` is called after each batch."""
    dev = next(net.parameters()).device
    num_class = len(class_names)
    world = get_dist_info()[1]
    lead = is_lead()
    sampler = getattr(dataloader, "sampler", None)
    order = list(sampler) if sampler is not None else list(range(len(dataset)))
    # the shard's padding (`ShardSampler`) follows its real frames
    n_real = getattr(sampler, "num_real", len(order))
    # (dataset index, the frame's results); a batch's occupancy statistics,
    # over its real frames, ride on its first frame
    records = []
    n_frames = 0
    # wall ms of the loop's parts: waiting on the loader; `infer` with the
    # copies to and from the device (the copy back synchronises); the host's
    # work on the outputs; the AP evaluation
    time_ms = dict.fromkeys(("loader", "infer", "host", "ap"), 0.0)
    t_start = time.time()
    t_mark = time.perf_counter()
    for batch_idx, batch in enumerate(dataloader):
        t_got = time.perf_counter()
        post = to_host(infer(net, to_device(batch, dev), post_cfg, num_class))
        t_dev = time.perf_counter()
        time_ms["loader"] += (t_got - t_mark) * 1e3
        time_ms["infer"] += (t_dev - t_got) * 1e3
        if on_batch is not None:
            on_batch(batch_idx, batch, post)
        if cloud_dir is not None and vis_stride > 0 and batch_idx % vis_stride == 0 and lead:
            _dump_cloud(Path(cloud_dir), batch_idx, batch, post)
        B = post["pred_boxes"].shape[0]
        real = min(B, n_real - n_frames)
        occ = None
        if "occ_probs" in post and real > 0:
            occ = occ_match_stats(post["occ_probs"][:real], {
                "pos_mask": post["occ_pos_mask"][:real],
                "general_cls_loss_mask": post["occ_cls_mask"][:real]})
        pred_dicts = [{k: post[k][b] for k in ("pred_boxes", "pred_scores", "pred_labels",
                                                "pred_valid")} for b in range(B)]
        annos = dataset.generate_prediction_dicts({"frame_id": batch["frame_id"]}, pred_dicts,
                                                  class_names)
        for b in range(B):
            rec = {"anno": annos[b], "occ": occ if b == 0 else None, "cov": None, "recall": None}
            if "gt_boxes" in batch:
                gt = batch["gt_boxes"][b]
                if "occ_points" in post:
                    rec["cov"] = occ_box_coverage(post["occ_points"][b],
                                                  post["occ_points_mask"][b], gt)
                rec["recall"] = recall_record(post["pred_boxes"][b], post["pred_valid"][b],
                                              post["rois"][b], post["roi_valid"][b], gt,
                                              recall_thresh_list)
            records.append((order[n_frames + b], rec))
        n_frames += B
        t_mark = time.perf_counter()
        time_ms["host"] += (t_mark - t_dev) * 1e3

    sec_per_example = (time.time() - t_start) / max(n_frames, 1)
    frames = ([r for _, r in records] if world == 1 else
              merge_results_dist(records if get_sp_info()[0] == 0 else [], len(dataset)))
    det_annos = [r["anno"] for r in frames]
    recall_dict, cov_acc, occ_stats_acc = {}, {}, {}
    for r in frames:
        for k, v in (r["recall"] or {}).items():
            recall_dict[k] = recall_dict.get(k, 0) + v
        if r["cov"] is not None:
            cov = r["cov"]
            cov_acc["box_num_sum"] = cov_acc.get("box_num_sum", 0) + cov["box_num_sum"]
            prev = cov_acc.get("occ_box_num", [0] * len(cov["occ_box_num"]))
            cov_acc["occ_box_num"] = [a + c for a, c in zip(prev, cov["occ_box_num"])]
        for k, v in (r["occ"] or {}).items():
            occ_stats_acc.setdefault(k, []).append(v)
    if logger:
        logger.info(f"eval: {len(det_annos)} frames over {world} rank(s), "
                    f"{sec_per_example:.4f} s/frame")
        gt_cnt = max(recall_dict.get("gt", 1), 1)
        for t in recall_thresh_list:
            logger.info(f"recall_roi_{t}: {recall_dict.get(f'roi_{t}', 0) / gt_cnt:.4f}  "
                        f"recall_rcnn_{t}: {recall_dict.get(f'rcnn_{t}', 0) / gt_cnt:.4f}")
    result_str, result_dict = "", {}
    if lead:
        if result_dir is not None:
            for anno in det_annos:
                dataset.write_kitti_txt(anno, anno["frame_id"], result_dir)
        # coverage-bucket difficulty axis (reference eval_utils.py:179 CVRG_RATES)
        t_ap = time.perf_counter()
        result_str, result_dict, pr_rc_details = dataset.evaluation(
            det_annos, class_names, coverage_rates=post_cfg.get("CVRG_RATES", None))
        time_ms["ap"] = (time.perf_counter() - t_ap) * 1e3
        if result_dir is not None and pr_rc_details:
            with open(Path(result_dir) / "pc_rc.pkl", "wb") as f:
                pickle.dump(pr_rc_details, f)
    result_str, result_dict = broadcast_object((result_str, result_dict))
    result_dict["sec_per_example"] = sec_per_example
    result_dict["frames_per_sec"] = 1.0 / max(sec_per_example, 1e-9)
    result_dict["recall"] = dict(recall_dict)
    result_dict["time_ms"] = time_ms
    for k, vals in occ_stats_acc.items():
        result_dict[k] = float(np.mean(vals))
    if cov_acc.get("box_num_sum", 0) > 0:
        for i, n in enumerate(cov_acc["occ_box_num"]):
            result_dict[f"occ_box_cvrg@{(i + 1) / 10:.1f}"] = n / cov_acc["box_num_sum"]
    if logger:
        logger.info("\n" + result_str)
    return result_str, result_dict, det_annos
