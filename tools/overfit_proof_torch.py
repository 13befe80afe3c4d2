"""Overfit-to-convergence proof of the PyTorch port through its CLI stack
(counterpart of tools/overfit_proof.py): the loss and target plumbing of
the port, trained end to end, can solve the task it is given.

Pipeline: a synthetic on-disk KITTI tree (`make_raw_kitti`, 25 frames x 4
cars, train == val) -> the infos and gt database -> the best-match
database -> `tools/train_torch.py` in process (the real loader and
augmentor chain with gt sampling and the world augmentations disabled, so
that the frames can be memorised; `--cache_items`) for 150 epochs at B=2
(12 steps an epoch) -> its trailing eval on the same frames with the
official KITTI AP -> the final checkpoint evaluated again through
`tools/test_torch.py` with `MODEL.OCC.PARAMS.EVAL_MAX_NUM_OCC_PNTS 2048`,
the occ point population the det net sees in training (the JAX package's
matched-population eval). Success: a near-zero loss and AP_R40 near 100
on the memorised frames.

    python tools/overfit_proof_torch.py --fresh                    # Car, flagship yaml
    python tools/overfit_proof_torch.py --fresh --three_classes    # 3-class yaml
    python tools/overfit_proof_torch.py --fresh --epochs 2 --device cpu --set ...

Runs on the CUDA card unless `--device cpu` is passed; there is no CPU
fallback. The data lands in `<root>/overfit_torch/data` (`overfit3_torch`
with --three_classes), the run in `<root>/btcdet_overfit_torch`
(`btcdet_overfit3_torch`), `<root>` being `output/` by default. The
training CLI auto-resumes from the newest checkpoint of its run dir, so a
finished run dir makes it skip training: `--fresh` wipes the data and the
run dir first. The summary (`summary.json` in the work dir, and printed)
holds the JAX proof's keys (epochs, frames, classes, cars_per_frame,
first_loss, final_loss, min_loss, ap) and ap_occ2048, the loss a epoch,
the wall seconds, the steps per second, the loop's wall ms by part, the
active sites the strided convs dropped at their capacities, the merged det
table's drops a frame, every gt's heading error at both occ populations
(AOS counts a heading flipped by pi as a miss), and the card's name and
power limit; `ap_tables.log` holds both evaluations' AP. For a bisect,
`--cut_and_resume` trains in two calls, cut after half the epochs, which
must give the straight run's numbers; `tools/overfit_diag_torch.py` takes a
finished proof further.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CAR_YAML = "tools/cfgs/model_configs/btcdet_kitti_car.yaml"
THREE_CLASS_YAML = "tools/cfgs/model_configs/btcdet_kitti_3classes.yaml"
THREE_CLASSES = ("Car", "Pedestrian", "Cyclist")
# the synthetic frames carry dense car interiors (4 cars a frame), so their
# strided convs' active sets run past the KITTI-sized level capacities
LEVEL_CAPACITIES = [36000, 26000, 13000, 10000]
OCC_PNTS_2048 = ["MODEL.OCC.PARAMS.EVAL_MAX_NUM_OCC_PNTS", "2048"]
AP_KINDS = ("3d", "bev", "image", "aos")
BATCH_SIZE = 2       # frames a step: 25 frames give 12 steps an epoch, as the JAX proof's


def build_data(root: Path, n_frames: int, cars_per_frame: int = 4, class_names=("Car",),
               **tree):
    """The tree, its infos, gt database and best-match database, as
    tools/overfit_proof.py's `build_data`; val == train. `tree` overrides
    `make_raw_kitti`'s placement (x_range, y_range, n_background)."""
    from btcdet_tpu_torch.datasets import bestmatch
    from btcdet_tpu_torch.datasets.kitti import kitti_infos
    from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti

    root.mkdir(parents=True, exist_ok=True)
    # train == val: overfit and evaluate on the same frames. The official
    # AP_R40 fills at most one recall slot a true positive, so it can reach
    # 100 only with >= ~41 gt a class; x <= 26 m keeps every gt's image box
    # taller than 40 px, so none is ignored at 'easy'
    objects = {c: cars_per_frame for c in class_names} if len(class_names) > 1 else None
    kw = dict(seed=7, x_range=(8, 26))
    kw.update(tree)
    make_raw_kitti(root, n_frames=n_frames, n_train=n_frames, cars_per_frame=cars_per_frame,
                   objects_per_frame=objects, **kw)
    (root / "ImageSets" / "val.txt").write_text((root / "ImageSets" / "train.txt").read_text())
    kitti_infos.create_kitti_infos(root, workers=2)
    bestmatch.create_best_match_db(root, class_names=class_names, splits=("train",))


def write_cfg(root: Path, out_cfg: Path, base_yaml: str = CAR_YAML) -> Path:
    """`base_yaml` with the data rooted at the tree, val split = train split,
    world augmentation and gt sampling off (memorisation needs frames that
    repeat; the best-match points stay on for the occ supervision) and the
    raised level capacities: tools/overfit_proof.py's `write_cfg`."""
    import yaml

    from btcdet_tpu_torch.config import cfg_from_yaml_file

    base = Path(base_yaml)
    cfg = cfg_from_yaml_file(base if base.is_absolute() else REPO / base)
    d = json.loads(json.dumps(cfg))
    dc = d["DATA_CONFIG"]
    dc.pop("_BASE_CONFIG_", None)
    dc["DATA_PATH"] = str(root)
    dc["DATA_SPLIT"] = {"train": "train", "test": "val"}
    dc["INFO_PATH"] = {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]}
    dc["FOV_POINTS_ONLY"] = False
    dc["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = [
        "gt_sampling", "random_world_flip", "random_world_rotation", "random_world_scaling"]
    d["MODEL"]["BACKBONE_3D"]["LEVEL_CAPACITIES"] = {"train": list(LEVEL_CAPACITIES),
                                                     "test": list(LEVEL_CAPACITIES)}
    out_cfg.parent.mkdir(parents=True, exist_ok=True)
    out_cfg.write_text(yaml.safe_dump(d, sort_keys=False))
    return out_cfg


def card_name_and_power_limit(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


class DropProbe:
    """Counts what the run drops at its static capacities, by phase ("train",
    "eval", "eval_occ2048", "eval_default"), on the device (read once at the
    end): the active sites each strided conv's capacity cut (`sparse.
    _unique_capped`, by capacity a frame) and, in the occ merge
    (`voxelizer._merge_plan`), the new det cells a frame wanted beyond the
    merged table's headroom and the occ points left out."""

    def __init__(self):
        import torch

        from btcdet_tpu_torch.ops import sparse, voxelizer

        self.torch, self.sparse, self.voxelizer = torch, sparse, voxelizer
        self.phase = "train"
        self.sites, self.merge = {}, {}
        self.orig = (sparse._unique_capped, voxelizer._merge_plan)

    def __enter__(self):
        sparse, voxelizer = self.sparse, self.voxelizer
        unique_capped, merge_plan = self.orig
        torch = self.torch

        def counted_unique(cand_keys, capacity, cells, batch_size):
            keys, nnz = unique_capped(cand_keys, capacity, cells, batch_size)
            s = torch.sort(cand_keys.long()).values
            live = s != sparse.INT32_MAX
            distinct = live[:1].sum() + ((s[1:] != s[:-1]) & live[1:]).sum()
            # a frame's capacity names the level (LEVEL_CAPACITIES)
            key = (self.phase, int(capacity) // int(batch_size))
            acc = self.sites.setdefault(key, [0, 0, 0])
            acc[0] += 1
            acc[1] = acc[1] + (distinct - nnz)
            acc[2] = acc[2] + distinct
            return keys, nnz

        def counted_merge(dkey, dnum, opts, ovalid, grid_size, lo, vs, extra, max_points):
            plan = merge_plan(dkey, dnum, opts, ovalid, grid_size, lo, vs, extra, max_points)
            row, keep = plan[1], plan[3]
            Nd = dkey.shape[1]
            # a missing cell's row is Nd + its rank among the frame's missing cells
            wanted = (row.max(dim=1).values - Nd + 1).clamp(min=0)
            acc = self.merge.setdefault(self.phase, {"frames": 0, "headroom": int(extra)})
            acc["frames"] += int(ovalid.shape[0])
            for k, v in (("new_cells", wanted), ("cells_dropped", (wanted - extra).clamp(min=0)),
                         ("points_dropped", ovalid.sum(1) - keep.sum(1))):
                acc[k] = acc.get(k, 0) + v.sum()
                acc[f"max_{k}"] = torch.maximum(acc.get(f"max_{k}", v.max()), v.max())
            return plan

        sparse._unique_capped, voxelizer._merge_plan = counted_unique, counted_merge
        return self

    def __exit__(self, *exc):
        self.sparse._unique_capped, self.voxelizer._merge_plan = self.orig

    def read(self) -> dict:
        sites = {}
        for (phase, cap), (calls, dropped, distinct) in sorted(self.sites.items()):
            sites.setdefault(phase, {})[f"capacity {cap} a frame"] = {
                "calls": calls, "sites_wanted": int(distinct), "sites_dropped": int(dropped)}
        merge = {}
        for phase, acc in self.merge.items():
            n = max(acc["frames"], 1)
            merge[phase] = {"frames": acc["frames"], "headroom_rows_a_frame": acc["headroom"]}
            for k in ("new_cells", "cells_dropped", "points_dropped"):
                merge[phase][f"{k}_a_frame"] = float(acc[k]) / n
                merge[phase][f"max_{k}"] = int(acc[f"max_{k}"])
        return {"active_sites": sites, "merged_table": merge}


def _wrap(a, period=2 * math.pi):
    """a wrapped into [-period / 2, period / 2)."""
    return (a + period / 2) % period - period / 2


def heading_errors(det_annos, infos, class_names, dir_offset: float) -> dict:
    """Each gt box of `class_names` against the detection of its class whose
    centre lies nearest in bird's eye view (within 1 m): the heading error
    wrapped to [-pi, pi), counted as flipped past pi / 2. Each of the five
    worst carries its frame, gt index, gt heading, error, detection score
    and the gt heading's distance from the nearest direction-bin boundary
    (`dir_offset` + k pi, where the RPN's direction label changes)."""
    import numpy as np

    by_frame = {i["point_cloud"]["lidar_idx"]: i for i in infos}
    rows, unmatched = [], 0
    for det in det_annos:
        annos = by_frame[det["frame_id"]]["annos"]
        gts = annos["gt_boxes_lidar"]
        for g, (box, name) in enumerate(zip(gts, annos["name"][:len(gts)])):
            if name not in class_names:
                continue
            mine = det["name"] == name
            d = np.linalg.norm(det["boxes_lidar"][mine, :2] - box[:2], axis=1)
            if not d.size or d.min() > 1.0:
                unmatched += 1
                continue
            j = int(np.argmin(d))
            err = float(_wrap(det["boxes_lidar"][mine][j, 6] - box[6]))
            b = float((box[6] - dir_offset) % np.pi)
            rows.append((abs(err), {"frame": str(det["frame_id"]), "gt": g, "class": str(name),
                                    "gt_heading": float(box[6]), "error": err,
                                    "score": float(det["score"][mine][j]),
                                    "to_dir_boundary": min(b, np.pi - b)}))
    errs = np.array([e for e, _ in rows])
    rows.sort(key=lambda r: -r[0])
    return {"gt": len(rows) + unmatched, "unmatched": unmatched,
            "flipped": int((errs > np.pi / 2).sum()),
            "over_0.1_rad": int((errs > 0.1).sum()),
            "mean_abs_error": float(errs.mean()) if errs.size else None,
            "median_abs_error": float(np.median(errs)) if errs.size else None,
            "worst": [r for _, r in rows[:5]]}


def run_dirs(root: Path, three_classes: bool = False):
    """(work dir, run dir) of a proof under `root`: the data, config and
    summary go in the first, the training run in the second."""
    tag = "overfit3_torch" if three_classes else "overfit_torch"
    return root / tag, root / f"btcdet_{tag}"


def evaluate(cfg_path: Path, ckpt: Path, out_dir: Path, device: str, sets=(), workers: int = 2,
             save_to_file: bool = False, on_batch=None):
    """One `tools/test_torch.py` evaluation of `ckpt` at B=BATCH_SIZE with the
    overrides `sets`: (result string, result dict, det annos)."""
    argv = ["--cfg_file", str(cfg_path), "--ckpt", str(ckpt), "--batch_size", str(BATCH_SIZE),
            "--workers", str(workers), "--device", device, "--output_dir", str(out_dir)]
    argv += (["--save_to_file"] if save_to_file else []) + (["--set", *sets] if sets else [])
    (_, result_str, result, det_annos), = _load_tool("test_torch").main(argv, on_batch=on_batch)
    return result_str, result, det_annos


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_cli", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ap_keys(result: dict) -> dict:
    """The official AP_R40 keys of an eval result, `<Class>_<kind>/<difficulty>_R40`."""
    return {k: float(v) for k, v in result.items()
            if k.endswith("_R40") and "/" in k and k.split("/")[0].rsplit("_", 1)[-1] in AP_KINDS}


def ap_table(ap: dict) -> str:
    lines = []
    for cls in dict.fromkeys(k.split("_")[0] for k in ap):
        for kind in AP_KINDS:
            vals = [ap.get(f"{cls}_{kind}/{d}_R40") for d in ("easy", "moderate", "hard")]
            if any(v is not None for v in vals):
                lines.append(f"{cls} {kind:5s} AP_R40 easy / moderate / hard: "
                             + " / ".join("-" if v is None else f"{v:.4f}" for v in vals))
    return "\n".join(lines)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--cars_per_frame", type=int, default=4)
    ap.add_argument("--workers", type=int, default=2, help="loader workers of the evals")
    ap.add_argument("--fresh", action="store_true",
                    help="wipe the data and the run dir first (the CLI auto-resumes)")
    ap.add_argument("--three_classes", action="store_true",
                    help="the 3-class proof on btcdet_kitti_3classes.yaml")
    ap.add_argument("--base_yaml", type=str, default=None,
                    help="default the flagship yaml (the 3-class yaml with --three_classes)")
    ap.add_argument("--root", type=str, default=str(REPO / "output"),
                    help="where the data and the run dir go")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cut_and_resume", action="store_true",
                    help="cut the training after half its epochs and resume it in a second "
                         "call (the run must equal a straight one)")
    ap.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=[],
                    help="config overrides of both the training and the evaluation")
    return ap.parse_args(argv)


def main(argv=None, tree=None, on_step=None) -> dict:
    """Run the proof; returns the summary. `tree` overrides the synthetic
    tree's placement (`build_data`); `on_step` is handed to the training
    CLI (`train_torch.main`)."""
    from btcdet_tpu_torch.utils.common import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)
    t_start = time.perf_counter()
    card = card_name_and_power_limit(args.device)
    class_names = THREE_CLASSES if args.three_classes else ("Car",)
    base_yaml = args.base_yaml or (THREE_CLASS_YAML if args.three_classes else CAR_YAML)
    work, run_dir = run_dirs(Path(args.root), args.three_classes)
    if args.fresh:
        for p in (work, run_dir):
            if p.exists():
                shutil.rmtree(p)
    data_root = work / "data"
    if not (data_root / "kitti_infos_train.pkl").exists():
        print("building the synthetic KITTI tree ...", flush=True)
        build_data(data_root, args.frames, args.cars_per_frame, class_names, **(tree or {}))
    t_data = time.perf_counter() - t_start
    cfg_path = write_cfg(data_root, work / f"{run_dir.name}.yaml", base_yaml)
    sets = list(args.set_cfgs)

    resume_at = args.epochs // 2 if args.cut_and_resume else 0
    interval = resume_at or args.epochs
    train_argv = ["--cfg_file", str(cfg_path), "--extra_tag", "overfit", "--output_dir",
                  str(run_dir), "--epochs", str(args.epochs), "--batch_size",
                  str(BATCH_SIZE), "--workers", str(args.workers), "--ckpt_save_interval",
                  str(interval), "--max_ckpt_save_num", "1", "--num_epochs_to_eval", "1",
                  "--cache_items", "--device", args.device] + (["--set", *sets] if sets else [])
    print("training: tools/train_torch.py " + " ".join(train_argv), flush=True)
    probe = DropProbe()

    def epoch_end(epoch, step):
        if epoch == args.epochs - 1:
            probe.phase = "eval"     # the trailing eval follows the last checkpoint
        return epoch + 1 == resume_at

    t0 = time.perf_counter()
    with probe:
        train_torch = _load_tool("train_torch")
        res = train_torch.main(train_argv, on_step=on_step, on_epoch_end=epoch_end)
        if res["stopped"]:   # cut halfway: a second call resumes there
            rest = train_torch.main(train_argv, on_step=on_step, on_epoch_end=epoch_end)
            assert rest["start_step"] == resume_at * res["steps_per_epoch"], rest
            res = dict(rest, start_step=res["start_step"], history=res["history"]
                       + rest["history"], steps_run=res["steps_run"] + rest["steps_run"],
                       time_ms={k: v + rest["time_ms"][k] for k, v in res["time_ms"].items()},
                       resumed_at_step=rest["start_step"])
        t_train = time.perf_counter() - t0
        spe = res["steps_per_epoch"]
        assert spe == args.frames // BATCH_SIZE, (spe, args.frames, BATCH_SIZE)
        from btcdet_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(run_dir / "ckpt")
        last = mgr.latest_step()
        assert last == args.epochs * spe, (last, args.epochs * spe)
        probe.phase = "eval_occ2048"
        t0 = time.perf_counter()
        ckpt = mgr.path(last)
        result_str, result_2048, annos_2048 = evaluate(
            cfg_path, ckpt, run_dir / "eval_occ2048", args.device, OCC_PNTS_2048 + sets,
            args.workers)
        t_eval = time.perf_counter() - t0
        probe.phase = "eval_default"
        _, _, annos_default = evaluate(cfg_path, ckpt, run_dir / "eval_default", args.device,
                                       sets, args.workers)
        drops = probe.read()
    import pickle

    import yaml

    with open(data_root / "kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    dir_offset = float(yaml.safe_load(cfg_path.read_text())["MODEL"]["DENSE_HEAD"]["DIR_OFFSET"])
    headings = {name: heading_errors(annos, infos, class_names, dir_offset)
                for name, annos in (("default", annos_default), ("occ2048", annos_2048))}

    history = res["history"]
    losses = [m["loss"] for _, m in history]
    by_epoch = {}
    for gstep, m in history:
        by_epoch.setdefault(gstep // spe, []).append(m)
    epoch_terms = [{k: sum(m[k] for m in ms) / len(ms) for k in ms[0]}
                   for _, ms in sorted(by_epoch.items())]
    evals = res["eval"]
    ap = ap_keys(evals[-1][1]) if evals else {}
    ap_2048 = ap_keys(result_2048)
    loop_s = sum(res["time_ms"].values()) / 1e3
    summary = {
        "epochs": args.epochs,
        "frames": args.frames,
        "classes": list(class_names),
        "cars_per_frame": args.cars_per_frame,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "min_loss": min(losses) if losses else None,
        "ap": ap,
        "ap_occ2048": ap_2048,
        "epoch_loss": [e["loss"] for e in epoch_terms],
        "first_loss_terms": history[0][1] if history else None,
        "final_loss_terms": history[-1][1] if history else None,
        "epoch_loss_terms": epoch_terms,
        "steps_per_epoch": spe,
        "start_step": res["start_step"],
        "steps_run": res["steps_run"],
        "resumed_at_step": res.get("resumed_at_step"),
        "steps_per_s": res["steps_run"] / loop_s if loop_s > 0 else None,
        "train_loop_ms": res["time_ms"],
        "wall_s": {"data": t_data, "train_and_trailing_eval": t_train, "eval_occ2048": t_eval,
                   "all": time.perf_counter() - t_start},
        "drops": drops,
        "heading_errors": headings,
        "card": card,
        "device": args.device,
        "config": str(cfg_path),
        "overrides": sets,
    }
    for k, v in (("first_loss", summary["first_loss"]), ("final_loss", summary["final_loss"])):
        assert v is None or math.isfinite(v), (k, v)
    (work / "summary.json").write_text(json.dumps(summary, indent=1))
    (work / "ap_tables.log").write_text(
        f"{card}\ntrailing eval of step {evals[-1][0] if evals else '-'} (default occ "
        f"population):\n{ap_table(ap)}\n\nthe final checkpoint with EVAL_MAX_NUM_OCC_PNTS 2048 "
        f"(tools/test_torch.py):\n{ap_table(ap_2048)}\n\n{result_str}\n")
    print(json.dumps({k: summary[k] for k in ("epochs", "frames", "classes", "first_loss",
                                                "final_loss", "min_loss", "ap", "ap_occ2048",
                                                "steps_per_s", "card")}, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
