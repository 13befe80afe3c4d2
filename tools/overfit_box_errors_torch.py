"""Per-gt box errors of an evaluation's detections against a KITTI tree's
labels: for each gt of a class, the detection of that class with the
largest 3D IoU (the official metric's `d3_box_overlap`, camera frame), its
3D and BEV IoU, its centre, size and heading errors and its score. It tells
which gt boxes hold an AP_R40 below 100 and how (a vertical error leaves the
BEV IoU whole; a heading flipped by pi costs AOS, not IoU).

    python tools/overfit_box_errors_torch.py --dets <eval dir of <frame>.txt files> \\
        --labels <kitti root>/training/label_2 [--cls Car] [--min_iou 0.7]

The detections are the KITTI txt files `tools/train_torch.py`'s trailing
evaluation writes (`<run dir>/eval/eval_with_train/step_<n>/val`), or
`tools/test_torch.py --save_to_file`'s; the tree of
`tools/overfit_proof_torch.py` is made again, the same bit for bit, by its
`build_data`. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cam_boxes(objs):
    """(N, 7) camera boxes x, y, z, l, h, w, ry of label objects."""
    import numpy as np

    return np.array([[*o.loc, o.l, o.h, o.w, o.ry] for o in objs], np.float64).reshape(-1, 7)


def box_errors(dets_dir: Path, labels_dir: Path, cls: str = "Car", min_iou: float = 0.7) -> dict:
    """{gt, missed (no detection of the class overlaps), below (3D IoU under
    `min_iou`), the median 3D IoU, and each gt under `min_iou` with its
    errors}, over the frames of `dets_dir`."""
    import numpy as np

    from btcdet_tpu_torch.datasets.kitti.object3d import get_objects_from_label
    from btcdet_tpu_torch.eval.kitti_eval import bev_box_overlap, d3_box_overlap

    rows, missed = [], 0
    for det_file in sorted(Path(dets_dir).glob("*.txt")):
        gts = [o for o in get_objects_from_label(Path(labels_dir) / det_file.name)
               if o.cls_type == cls]
        dets = [o for o in get_objects_from_label(det_file) if o.cls_type == cls]
        g, d = _cam_boxes(gts), _cam_boxes(dets)
        iou3d, iou_bev = d3_box_overlap(g, d), bev_box_overlap(g, d)
        for i in range(len(g)):
            j = int(np.argmax(iou3d[i])) if len(d) else -1
            if j < 0 or iou_bev[i].max() <= 0:
                missed += 1
                continue
            err = d[j] - g[i]
            rows.append({"frame": det_file.stem, "gt": i, "iou3d": float(iou3d[i, j]),
                         "iou_bev": float(iou_bev[i, j]),
                         "centre_error_m": [float(v) for v in err[:3]],
                         "lhw_error_m": [float(v) for v in err[3:6]],
                         "heading_error": float((err[6] + math.pi) % (2 * math.pi) - math.pi),
                         "score": float(dets[j].score)})
    below = sorted((r for r in rows if r["iou3d"] < min_iou), key=lambda r: r["iou3d"])
    return {"class": cls, "gt": len(rows) + missed, "missed": missed, "below": len(below),
            "min_iou": min_iou,
            "median_iou3d": float(np.median([r["iou3d"] for r in rows])) if rows else None,
            "below_min_iou": below}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dets", type=str, required=True)
    ap.add_argument("--labels", type=str, required=True)
    ap.add_argument("--cls", type=str, default="Car")
    ap.add_argument("--min_iou", type=float, default=0.7)
    args = ap.parse_args(argv)
    out = box_errors(Path(args.dets), Path(args.labels), args.cls, args.min_iou)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
