#!/usr/bin/env bash
# One-command KITTI-val run of the PyTorch port (the counterpart of
# tools/run_kitti_val.sh): evaluate a reference BtcDet checkpoint on
# KITTI val with the official metric, on the yaml as shipped.
#
#   tools/run_kitti_val_torch.sh <kitti_root> <reference.pth> [cfg_file] [batch_size] [key value ...]
#
# <kitti_root> holds the standard layout:
#   ImageSets/{train,val}.txt  training/{velodyne,calib,label_2[,planes]}
# Missing info pkls are generated in place. The port loads a reference
# .pth directly (train/checkpoint.py:load_any), so there is no import step.
# Pairs after the batch size go to tools/test_torch.py's --set, e.g.
# `MODEL.ROI_HEAD.APPROX_QUERY False` for the reference CUDA's exact ball
# query (the yaml leaves it unset: the roi-grouped approximate query).
#
# Environment: DEVICE (default cuda; cpu runs without a card), WORKERS
# (loader workers, default 4), OUTPUT_DIR (default
# output/kitti_val_parity_torch).
set -euo pipefail

KITTI_ROOT=${1:?usage: run_kitti_val_torch.sh <kitti_root> <reference.pth> [cfg] [bs] [key value ...]}
REF_PTH=${2:?usage: run_kitti_val_torch.sh <kitti_root> <reference.pth> [cfg] [bs] [key value ...]}
CFG=${3:-}
BS=${4:-8}
shift $(( $# < 4 ? $# : 4 ))
# the caller's paths, before the move to the repo's root
KITTI_ROOT=$(realpath "$KITTI_ROOT")
REF_PTH=$(realpath "$REF_PTH")
[ -n "$CFG" ] && CFG=$(realpath "$CFG")
[ -n "${OUTPUT_DIR:-}" ] && OUTPUT_DIR=$(realpath -m "$OUTPUT_DIR")

cd "$(dirname "$0")/.."
CFG=${CFG:-tools/cfgs/model_configs/btcdet_kitti_car.yaml}
OUT=${OUTPUT_DIR:-output/kitti_val_parity_torch}
mkdir -p "$OUT"

if [ ! -f "$KITTI_ROOT/kitti_infos_val.pkl" ]; then
  echo "== generating kitti infos under $KITTI_ROOT =="
  python -m btcdet_tpu_torch.datasets.kitti.kitti_infos "$KITTI_ROOT" \
    "$(( ${WORKERS:-4} > 0 ? ${WORKERS:-4} : 1 ))"
fi

echo "== evaluating $REF_PTH on KITTI val (batch $BS, device ${DEVICE:-cuda}) =="
python tools/test_torch.py --cfg_file "$CFG" --ckpt "$REF_PTH" --batch_size "$BS" \
  --workers "${WORKERS:-4}" --device "${DEVICE:-cuda}" --output_dir "$OUT" \
  --set DATA_CONFIG.DATA_PATH "$KITTI_ROOT" "$@"

echo "== done: AP report in $OUT/eval_*.log =="
