"""Official KITTI AP metric (counterpart of `btcdet_tpu/eval/kitti_eval.py`,
reference `btcdet/datasets/kitti/kitti_object_eval_python/eval.py`).

AP@11 and AP@R40 for bbox / BEV / 3D / AOS with the official difficulty
buckets and ignore / dontcare semantics, or the coverage-rate buckets of
the BtcDet fork. The per-image assignment loops run in the C++ core
`csrc/host/eval_core.cpp` (g++, built at first use; a failed build
raises), `compute_statistics_plain` is its numpy twin. Rotated overlaps
come from the port's `ops.iou3d` on CPU float64 tensors, the dtype the
JAX package's numpy path computes in.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..ops import iou3d, kernel_build

NO_DETECTION = -10000000


def _load_native() -> ctypes.CDLL:
    lib = kernel_build.load_host("eval_core")
    lib.compute_statistics.restype = None
    return lib


CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
MIN_HEIGHTS = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno, dt_anno, current_class: int, difficulty):
    """Official per-image filtering (reference `eval.py:34-90`).

    `difficulty` is an int (0/1/2 = easy/moderate/hard) or a 2-list
    `[lo, hi)` coverage-rate bucket (the BtcDet fork's extension,
    reference `eval.py:55-57`): in bucket mode a gt whose
    `coverage_rates` falls inside the bucket is moved to the ignored
    class (reference semantics preserved verbatim), and dt boxes use the
    'hard' min-height filter (reference `eval.py:80-81`)."""
    cvrg_bucket = isinstance(difficulty, (list, tuple)) and len(difficulty) == 2
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        valid_class = -1
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        if cvrg_bucket:
            cvrg = float(np.asarray(gt_anno["coverage_rates"][i]).reshape(-1)[0])
            ignore = difficulty[0] <= cvrg < difficulty[1]
        else:
            ignore = (
                gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                or height <= MIN_HEIGHTS[difficulty]
            )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(bbox)
    dt_difficulty = 2 if cvrg_bucket else difficulty
    for i in range(num_dt):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHTS[dt_difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D bbox overlap (reference `eval.py:107`-style)."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_q = (query_boxes[:, 2] - query_boxes[:, 0]) * (query_boxes[:, 3] - query_boxes[:, 1])
    if criterion == -1:
        denom = area_b[:, None] + area_q[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b[:, None], inter.shape)
    else:
        denom = np.broadcast_to(area_q[None, :], inter.shape)
    return inter / np.clip(denom, 1e-9, None)


def _cam_to_bev_boxes(boxes):
    """camera [x, y, z, l, h, w, ry] -> pseudo lidar-style BEV box
    (cx, cz, dummy, l, w, dummy, ry): consistent corner geometry for IoU."""
    out = np.zeros((len(boxes), 7), np.float64)
    out[:, 0] = boxes[:, 0]
    out[:, 1] = boxes[:, 2]
    out[:, 3] = boxes[:, 3]
    out[:, 4] = boxes[:, 5]
    out[:, 5] = 1.0
    out[:, 6] = boxes[:, 6]
    return out


def _overlap_bev(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotated BEV overlap areas of float64 boxes, on the CPU in float64."""
    return iou3d.boxes_overlap_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Rotated BEV overlap in camera coords (reference uses the numba
    rotate_iou kernel). criterion -1 = IoU."""
    if len(boxes) == 0 or len(qboxes) == 0:
        return np.zeros((len(boxes), len(qboxes)))
    a = _cam_to_bev_boxes(boxes)
    b = _cam_to_bev_boxes(qboxes)
    inter = _overlap_bev(a, b)
    area_a = (boxes[:, 3] * boxes[:, 5])[:, None]
    area_b = (qboxes[:, 3] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape)
    else:
        denom = np.broadcast_to(area_b, inter.shape)
    return inter / np.clip(denom, 1e-9, None)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D IoU in camera coords: BEV rotated overlap x y-axis overlap
    (camera y points down; box y is the bottom face)."""
    if len(boxes) == 0 or len(qboxes) == 0:
        return np.zeros((len(boxes), len(qboxes)))
    a = _cam_to_bev_boxes(boxes)
    b = _cam_to_bev_boxes(qboxes)
    inter_bev = _overlap_bev(a, b)
    ymax = np.minimum(boxes[:, 1, None], qboxes[None, :, 1])
    ymin = np.maximum(
        boxes[:, 1, None] - boxes[:, 4, None], qboxes[None, :, 1] - qboxes[None, :, 4]
    )
    inter_h = np.clip(ymax - ymin, 0, None)
    inter = inter_bev * inter_h
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inter.shape)
    else:
        denom = np.broadcast_to(vol_b, inter.shape)
    return inter / np.clip(denom, 1e-9, None)


def compute_statistics(
    overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes,
    metric, min_overlap, thresh=0.0, compute_fp=False, compute_aos=False,
):
    """One image's (tp, fp, fn, similarity, scores of the tps), by the C++
    core. overlaps is [num_dt, num_gt]."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = np.ascontiguousarray(dt_datas[:, -1], np.float64)
    dt_alphas = np.ascontiguousarray(dt_datas[:, 4], np.float64)
    gt_alphas = np.ascontiguousarray(gt_datas[:, 4], np.float64)
    dc_overlaps = _dc_overlaps(dt_datas, dc_bboxes, metric)
    lib = _load_native()
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    ov = np.ascontiguousarray(overlaps, np.float64)
    dco = np.ascontiguousarray(dc_overlaps, np.float64)
    ig = np.ascontiguousarray(ignored_gt, np.int32)
    idt = np.ascontiguousarray(ignored_det, np.int32)
    tp, fp, fn, tcount = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    sim = ctypes.c_double()
    thresholds = np.zeros(max(gt_size, 1), np.float64)
    lib.compute_statistics(
        ov.ctypes.data_as(dp), ctypes.c_int(det_size), ctypes.c_int(gt_size),
        dt_scores.ctypes.data_as(dp), gt_alphas.ctypes.data_as(dp), dt_alphas.ctypes.data_as(dp),
        ig.ctypes.data_as(ip), idt.ctypes.data_as(ip),
        dco.ctypes.data_as(dp), ctypes.c_int(dc_overlaps.shape[1]),
        ctypes.c_int(metric), ctypes.c_double(min_overlap), ctypes.c_double(thresh),
        ctypes.c_int(int(compute_fp)), ctypes.c_int(int(compute_aos)),
        ctypes.byref(tp), ctypes.byref(fp), ctypes.byref(fn), ctypes.byref(sim),
        thresholds.ctypes.data_as(dp), ctypes.byref(tcount))
    return tp.value, fp.value, fn.value, sim.value, thresholds[: tcount.value]


def _dc_overlaps(dt_datas, dc_bboxes, metric):
    """[num_dt, num_dontcare] image overlaps (bbox metric only)."""
    if metric == 0 and len(dc_bboxes):
        return image_box_overlap(dt_datas[:, :4].astype(np.float64),
                                 np.asarray(dc_bboxes, np.float64), criterion=0)
    return np.zeros((dt_datas.shape[0], 0))


def compute_statistics_plain(
    overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes,
    metric, min_overlap, thresh=0.0, compute_fp=False, compute_aos=False,
):
    """`compute_statistics` in Python and numpy: the C++ core's twin, equal
    to it exactly (the AOS similarity is summed in tp order with libm's cos)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1].astype(np.float64)
    dt_alphas = dt_datas[:, 4].astype(np.float64)
    gt_alphas = gt_datas[:, 4].astype(np.float64)
    dc_overlaps = _dc_overlaps(dt_datas, dc_bboxes, metric)
    assigned = np.zeros(det_size, bool)
    ignored_threshold = dt_scores < thresh if compute_fp else np.zeros(det_size, bool)
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    deltas = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and dt_score > valid_detection:
                det_idx, valid_detection = j, dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap, det_idx = overlap, j
                valid_detection, assigned_ignored_det = 1, False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx, valid_detection, assigned_ignored_det = j, 1, True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and dc_overlaps.shape[1]:
            for j in range(det_size):
                if assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]:
                    continue
                if (dc_overlaps[j] > min_overlap).any():
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            for d in deltas:
                similarity += (1.0 + math.cos(d)) / 2.0
    return tp, fp, fn, similarity, np.asarray(thresholds, np.float64)


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Official recall-spaced score thresholds (reference `eval.py:20`)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.asarray(thresholds)


def _gt_datas(anno):
    return np.concatenate(
        [anno["bbox"], anno["alpha"][..., None]], axis=1
    ) if len(anno["name"]) else np.zeros((0, 5))


def _dt_datas(anno):
    return np.concatenate(
        [anno["bbox"], anno["alpha"][..., None], anno["score"][..., None]], axis=1
    ) if len(anno["name"]) else np.zeros((0, 6))


def calculate_iou(gt_annos, dt_annos, metric):
    """Per-image [num_dt, num_gt] overlap matrices."""
    out = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            ov = image_box_overlap(
                np.asarray(dt["bbox"], np.float64).reshape(-1, 4),
                np.asarray(gt["bbox"], np.float64).reshape(-1, 4),
            )
        else:
            def cam_boxes(a):
                if len(a["name"]) == 0:
                    return np.zeros((0, 7))
                return np.concatenate(
                    [a["location"], a["dimensions"], a["rotation_y"][..., None]], axis=1
                )
            if metric == 1:
                ov = bev_box_overlap(cam_boxes(dt), cam_boxes(gt))
            else:
                ov = d3_box_overlap(cam_boxes(dt), cam_boxes(gt))
        out.append(np.asarray(ov, np.float64))
    return out


def eval_class(
    gt_annos, dt_annos, current_classes, difficultys, metric, min_overlaps,
    compute_aos=False, num_sample_pts=41,
):
    """reference `eval.py:454`. Returns dict with precision / recall /
    aos arrays [num_class, num_diff, num_minoverlap, num_sample_pts]."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou(gt_annos, dt_annos, metric)
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, num_sample_pts])
    recall = np.zeros_like(precision)
    real_recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for d, difficulty in enumerate(difficultys):
            rets = [
                clean_data(gt, dt, current_class, difficulty)
                for gt, dt in zip(gt_annos, dt_annos)
            ]
            total_num_valid_gt = sum(r[0] for r in rets)
            for k in range(num_minoverlap):
                min_overlap = min_overlaps[k, metric, m]
                all_thresholds = []
                for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
                    num_valid_gt, ignored_gt, ignored_det, dc_bboxes = rets[i]
                    tp, fp, fn, sim, th = compute_statistics(
                        overlaps[i], _gt_datas(gt), _dt_datas(dt),
                        ignored_gt, ignored_det, dc_bboxes, metric,
                        min_overlap=min_overlap, thresh=0.0, compute_fp=False,
                    )
                    all_thresholds.append(th)
                thresholdss = np.concatenate(all_thresholds) if all_thresholds else np.zeros(0)
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(thresholdss, total_num_valid_gt, num_sample_pts)
                pr = np.zeros([len(thresholds), 4])
                for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
                    num_valid_gt, ignored_gt, ignored_det, dc_bboxes = rets[i]
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            overlaps[i], _gt_datas(gt), _dt_datas(dt),
                            ignored_gt, ignored_det, dc_bboxes, metric,
                            min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos,
                        )
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        pr[t, 3] += sim
                for t in range(len(thresholds)):
                    recall[m, d, k, t] = pr[t, 0] / (pr[t, 0] + pr[t, 2])
                    precision[m, d, k, t] = pr[t, 0] / (pr[t, 0] + pr[t, 1])
                    if compute_aos:
                        aos[m, d, k, t] = pr[t, 3] / (pr[t, 0] + pr[t, 1])
                    # running max of the *raw* recall curve up to t
                    # (reference eval.py:489,545 "real_recall")
                    real_recall[m, d, k, t] = recall[m, d, k, : t + 1].max()
                for t in range(len(thresholds)):
                    precision[m, d, k, t] = precision[m, d, k, t:].max()
                    recall[m, d, k, t] = recall[m, d, k, t:].max()
                    if compute_aos:
                        aos[m, d, k, t] = aos[m, d, k, t:].max()
    return {
        "recall": recall,
        "real_recall": real_recall,
        "precision": precision,
        "orientation": aos,
    }


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def create_details(current_classes, pc, rc, difficultys=None):
    """Per-class / per-difficulty precision+real-recall curve export for
    PR-curve plotting (reference `eval.py:639` create_details). `pc`/`rc`
    are [num_class, num_diff, num_minoverlap, 41] precision / real_recall."""
    if difficultys is None or isinstance(difficultys[0], int):
        diff_to_name = {0: "easy", 1: "moderate", 2: "hard"}
    else:
        diff_to_name = {
            i: "{}<=cvrg<{}".format(d[0], d[1]) for i, d in enumerate(difficultys)
        }
    out = {}
    for j, curcls in enumerate(current_classes):
        cls_name = CLASS_NAMES[curcls].capitalize()
        out[cls_name] = {}
        for d in range(pc.shape[1]):
            out[cls_name][diff_to_name[d]] = {
                "R11_pc": pc[j, d, 0, 0::4],
                "R11_rc": rc[j, d, 0, 0::4],
                "R40_pc": pc[j, d, 0, 1:],
                "R40_rc": rc[j, d, 0, 1:],
            }
    return out


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False,
            pr_rc_details=None, coverage_rates=None):
    """`coverage_rates`: optional list of `[lo, hi)` coverage buckets that
    replaces the standard 0/1/2 difficulty axis (reference `eval.py:597`)."""
    difficultys = [0, 1, 2] if coverage_rates is None else coverage_rates
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0, min_overlaps,
                     compute_aos)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret_bev = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps)
    mAP_bev = get_mAP(ret_bev["precision"])
    mAP_bev_R40 = get_mAP_R40(ret_bev["precision"])
    if pr_rc_details is not None:
        pr_rc_details["bev"] = create_details(
            current_classes, ret_bev["precision"], ret_bev["real_recall"], difficultys)
    ret_3d = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps)
    mAP_3d = get_mAP(ret_3d["precision"])
    mAP_3d_R40 = get_mAP_R40(ret_3d["precision"])
    if pr_rc_details is not None:
        pr_rc_details["3d"] = create_details(
            current_classes, ret_3d["precision"], ret_3d["real_recall"], difficultys)
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes, coverage_rates=None):
    """reference `eval.py:685`. Returns (result_str, result_dict,
    pr_rc_details) — the third element holds per-class precision /
    real-recall curves for 'bev' and '3d' at the 0.7-overlap setting
    (reference `eval.py:720,803`), consumed by
    tools/visual_utils/visualize_pcrc_curve.py via `pc_rc.pkl`.

    `coverage_rates`: optional list of `[lo, hi)` best-match coverage
    buckets replacing the easy/moderate/hard axis (the BtcDet fork's
    shape-coverage evaluation; gt annos must then carry
    `coverage_rates` from `create_kitti_infos_with_coverage`)."""
    overlap_0_7 = np.array([
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
    ])
    overlap_0_5 = np.array([
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
    ])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)  # (2, 3, 6)
    name_to_class = {
        "Car": 0, "Pedestrian": 1, "Cyclist": 2, "Van": 3,
        "Person_sitting": 4, "Truck": 5,
    }
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes_int = [
        name_to_class[c] if isinstance(c, str) else int(c) for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes_int]

    compute_aos = any(
        len(anno["alpha"]) and anno["alpha"][0] != -10 for anno in dt_annos
    )
    result = ""
    ret_dict = {}
    pr_rc_details = {}
    (mAPbbox, mAPbev, mAP3d, mAPaos,
     mAPbbox_R40, mAPbev_R40, mAP3d_R40, mAPaos_R40) = [], [], [], [], [], [], [], []
    for k in range(min_overlaps.shape[0]):
        ret = do_eval(
            gt_annos, dt_annos, current_classes_int, min_overlaps[k][None], compute_aos,
            pr_rc_details=pr_rc_details if k == 0 else None,
            coverage_rates=coverage_rates,
        )
        mAPbbox.append(ret[0])
        mAPbev.append(ret[1])
        mAP3d.append(ret[2])
        mAPaos.append(ret[3])
        mAPbbox_R40.append(ret[4])
        mAPbev_R40.append(ret[5])
        mAP3d_R40.append(ret[6])
        mAPaos_R40.append(ret[7])

    if coverage_rates is None:
        diff_names = ["easy", "moderate", "hard"]
    else:
        diff_names = [f"cvrg_{lo}_{hi}" for lo, hi in coverage_rates]

    def fmt(m):
        return ", ".join("%.4f" % v for v in m)

    for j, curcls in enumerate(current_classes_int):
        cls_name = CLASS_NAMES[curcls].capitalize()
        for k in range(min_overlaps.shape[0]):
            ov = min_overlaps[k, :, j]
            result += f"{cls_name} AP@{ov[0]:.2f}, {ov[1]:.2f}, {ov[2]:.2f}:\n"
            result += "bbox AP:%s\n" % fmt(mAPbbox[k][j, :, 0])
            result += "bev  AP:%s\n" % fmt(mAPbev[k][j, :, 0])
            result += "3d   AP:%s\n" % fmt(mAP3d[k][j, :, 0])
            if compute_aos and mAPaos[k] is not None:
                result += "aos  AP:%s\n" % fmt(mAPaos[k][j, :, 0])
            result += f"{cls_name} AP_R40@{ov[0]:.2f}, {ov[1]:.2f}, {ov[2]:.2f}:\n"
            result += "bbox AP:%s\n" % fmt(mAPbbox_R40[k][j, :, 0])
            result += "bev  AP:%s\n" % fmt(mAPbev_R40[k][j, :, 0])
            result += "3d   AP:%s\n" % fmt(mAP3d_R40[k][j, :, 0])
            if compute_aos and mAPaos_R40[k] is not None:
                result += "aos  AP:%s\n" % fmt(mAPaos_R40[k][j, :, 0])
            if k == 0:
                for d, dname in enumerate(diff_names):
                    ret_dict[f"{cls_name}_3d/{dname}_R40"] = mAP3d_R40[k][j, d, 0]
                    ret_dict[f"{cls_name}_bev/{dname}_R40"] = mAPbev_R40[k][j, d, 0]
                    ret_dict[f"{cls_name}_image/{dname}_R40"] = mAPbbox_R40[k][j, d, 0]
                    ret_dict[f"{cls_name}_3d/{dname}"] = mAP3d[k][j, d, 0]
                    ret_dict[f"{cls_name}_bev/{dname}"] = mAPbev[k][j, d, 0]
                    ret_dict[f"{cls_name}_image/{dname}"] = mAPbbox[k][j, d, 0]
                    if compute_aos and mAPaos_R40[k] is not None:
                        ret_dict[f"{cls_name}_aos/{dname}_R40"] = mAPaos_R40[k][j, d, 0]
    return result, ret_dict, pr_rc_details
