"""Diagnosis of a finished overfit proof (`tools/overfit_proof_torch.py`)
whose 3D AP_R40 falls short at the default occ population. From the proof's
final checkpoint:

1. every frame at the default population on the device, its per-gt box
   errors (`tools/overfit_box_errors_torch.py`) and the frames holding a gt
   under 0.7 3D IoU;
2. those frames at the default population again on the CPU (the kernels'
   plain versions, bf16 as on the device) and on the device in float32
   (`BTCDET_F32=1`, no TF32): each run's per-gt box errors and its largest
   box and score difference from the device's bf16 detections;
3. every frame at the default population with the merged det table's
   training headroom (`MERGED_CAP_EXTRA` 512 new rows a frame, what 2048
   occ points give), and every frame with 2048 occ points and room for all
   their cells (2048 rows): AP_R40 and the gt under 0.7 3D IoU of each.

    python tools/overfit_diag_torch.py [--three_classes] [--root output]

Runs on the CUDA card unless `--device cpu` is passed; `--set` takes the
overrides the proof ran with. Prints one JSON object and writes it to
`diag.json` in the proof's work dir.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import pickle
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

MIN_IOU = 0.7     # a gt under this 3D IoU marks its frame for the checks of 2.

TRAIN_HEADROOM = ["MODEL.OCC.OCC_PNT_UPDATE.MERGED_CAP_EXTRA", "512"]
FULL_HEADROOM_2048 = ["MODEL.OCC.OCC_PNT_UPDATE.MERGED_CAP_EXTRA", "2048"]


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_diag", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


proof = _load_tool("overfit_proof_torch")


def low_frames(errors: list) -> list:
    return sorted({r["frame"] for e in errors for r in e["below_min_iou"]})


def diagnose(args, work: Path, run_dir: Path, cfg_path: Path, class_names) -> dict:
    from btcdet_tpu_torch.train.checkpoint import CheckpointManager
    from btcdet_tpu_torch.utils.common import float32_everywhere

    mgr = CheckpointManager(run_dir / "ckpt")
    last = mgr.latest_step()
    assert last is not None, f"no checkpoint under {run_dir / 'ckpt'}: run the proof first"
    ckpt, labels = mgr.path(last), work / "data" / "training" / "label_2"
    boxes = _load_tool("overfit_box_errors_torch")
    out_root = run_dir / "diag"

    def run(name, device, sets=(), scope=contextlib.nullcontext):
        t0 = time.perf_counter()
        with scope():
            _, result, annos = proof.evaluate(cfg_path, ckpt, out_root / name, device,
                                              [*sets, *args.set_cfgs], args.workers,
                                              save_to_file=True)
        dets = out_root / name / f"step_{last}" / "val"
        errors = [boxes.box_errors(dets, labels, c, MIN_IOU) for c in class_names]
        return {"seconds": time.perf_counter() - t0, "ap": proof.ap_keys(result),
                "box_errors": errors}, annos

    out = {"step": last}
    default, _ = run("default", args.device)
    out["default"] = default
    frames = low_frames(default["box_errors"])
    out["low_frames"] = frames
    if frames:
        with open(work / "data" / "kitti_infos_val.pkl", "rb") as f:
            infos = pickle.load(f)
        name = "kitti_infos_diag.pkl"
        with open(work / "data" / name, "wb") as f:
            pickle.dump([i for i in infos if str(i["point_cloud"]["lidar_idx"]) in frames], f)
        sub = ["DATA_CONFIG.INFO_PATH.test", f"['{name}']"]
        runs = {"device_bf16": run("frames_device", args.device, sub),
                "cpu_bf16": run("frames_cpu", "cpu", sub),
                "device_f32": run("frames_device_f32", args.device, sub, float32_everywhere)}
        ref = runs["device_bf16"][1]
        for key, (res, annos) in runs.items():
            res.pop("ap")    # the AP of a few frames says nothing
            diff = {}
            for a, b in zip(ref, annos):
                same = len(a["boxes_lidar"]) == len(b["boxes_lidar"])
                diff[str(a["frame_id"])] = {
                    "detections": [len(a["boxes_lidar"]), len(b["boxes_lidar"])],
                    "max_abs_box_diff": float(abs(a["boxes_lidar"] - b["boxes_lidar"]).max())
                    if same and len(a["boxes_lidar"]) else None,
                    "max_abs_score_diff": float(abs(a["score"] - b["score"]).max())
                    if same and len(a["score"]) else None}
            out[key] = dict(res, against_device_bf16=diff)
    out["default_train_headroom"] = run("default_train_headroom", args.device, TRAIN_HEADROOM)[0]
    out["occ2048_full_headroom"] = run("occ2048_full_headroom", args.device,
                                       proof.OCC_PNTS_2048 + FULL_HEADROOM_2048)[0]
    return out


def main(argv=None) -> dict:
    from btcdet_tpu_torch.utils.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--three_classes", action="store_true")
    ap.add_argument("--root", type=str, default=str(REPO / "output"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--workers", type=int, default=2, help="loader workers of the evals")
    ap.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=[],
                    help="config overrides of every run (those the proof ran with)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    work, run_dir = proof.run_dirs(Path(args.root), args.three_classes)
    class_names = proof.THREE_CLASSES if args.three_classes else ("Car",)
    cfg_path = work / f"{run_dir.name}.yaml"
    out = {"card": proof.card_name_and_power_limit(args.device), "device": args.device}
    out.update(diagnose(args, work, run_dir, cfg_path, class_names))
    (work / "diag.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
