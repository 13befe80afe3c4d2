"""What the eval cell knows of BtcNet (`MODEL.NAME: BtcNet`), with or
without its occupancy subnet (`MODEL.OCC`).

The harness (`benchmark/lib/`) finds this module by the configuration's
`MODEL.NAME`, lower-cased (`lib/spec.arch_module`), and reads:

- `STAGES`: the program's stage range names, in order;
- `post_processing(out, cfg, device)`: the program's final NMS;
- `final_inputs(out)`: what the reference's check of a sampled batch
  reads of the forward's output;
- `Capture(net, cfg)`: forward hooks that keep each compared stage's
  output of the batch in flight;
- `check(...)`: the comparison with the frozen reference;
- `check_names(cfg)`: the numbers `check` reads for a configuration;
- `reference_net(cfg_dict, sd, device)` and `entry_flops(ref, entry, B)`:
  the sparse FLOPs of one pool entry, for `eval_mfu`.

With `MODEL.OCC` the reference starts from the benchmark's batch for the
occupancy subnet and from the program's merged det table for the det
backbone. Without it the reference's MeanVFE and det backbone start from
the batch's own voxel table, so `backbone` also covers the VFE, and
ConvHead reads no occupancy points.
"""

from __future__ import annotations

import torch

from benchmark.reference import stages
from benchmark.reference.btcref.ops import sparse as rsparse
from benchmark.work import counts

# the program's stage ranges of one eval forward + post-processing, in order
# (the port's `btcnet.STAGES`; without MODEL.OCC `occ_subnet` never opens)
STAGES = ("occ_subnet", "backbone_3d", "bev", "dense_head", "proposal_nms", "roi_head",
          "post_processing")
# the control's precision for the box decodes, which the configuration
# computes in float32 (its convolutions and linears, on bfloat16, take
# float8: `reference.lowp`)
LOWP_DECODE = torch.bfloat16
# numbers of the occupancy subnet, read only with MODEL.OCC
OCC_CHECKS = ("occ_subnet", "occ_rows")
# the batch's own voxel table, which the det backbone reads without MODEL.OCC
TABLE = ("voxels", "voxel_coords", "voxel_num_points")
# what a pool entry's FLOP count reads of the occupancy subnet's output
MERGED = ("det_voxel_features", "det_voxel_coords", "det_occ_code")


def _use_occ(cfg) -> bool:
    return cfg["MODEL"].get("OCC") is not None


def check_names(cfg) -> list:
    """The numbers `check` reads for configuration `cfg` (a dict)."""
    occ = _use_occ(cfg)
    return [k for k in stages.KINDS if occ or k not in OCC_CHECKS]


def post_processing(out: dict, cfg, device) -> dict:
    """The program's final NMS, looked up on the port's module at each call."""
    from btcdet_tpu_torch.models.detectors import btcnet

    return btcnet.post_processing(out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), device)


def final_inputs(out: dict) -> dict:
    """What the final NMS reads, and the raw ConvHead outputs its boxes and
    scores were decoded from."""
    return {k: out[k] for k in ("batch_cls_preds", "batch_box_preds", "roi_labels",
                                "roi_valid", "rois", "rcnn_cls", "rcnn_reg")}


class Capture:
    """Forward hooks on the program's occupancy subnet (with MODEL.OCC), det
    backbone and dense head that keep what each returned for the batch in
    flight; without MODEL.OCC a hook on the network keeps the batch's own
    voxel table instead."""

    def __init__(self, net, cfg):
        self.occ = self.bb = self.head = self.table = None
        self.use_occ = _use_occ(cfg)
        det = net.det_modules
        first = (net.occ_modules.register_forward_hook(self._occ) if self.use_occ
                 else net.register_forward_pre_hook(self._table))
        self.handles = [
            first,
            det.backbone_3d.register_forward_hook(self._bb),
            det.dense_head.register_forward_hook(self._head),
        ]

    def _occ(self, mod, args, out):
        self.occ = out

    def _table(self, mod, args):
        self.table = {k: args[0][k] for k in TABLE}

    def _bb(self, mod, args, out):
        self.bb = {k: stages.sparse_fields(v) for k, v in out.items()
                   if k in ("encoded", "x_combine")}

    def _head(self, mod, args, out):
        self.head = out

    def kept(self) -> dict:
        """The stage outputs `check` reads of the last batch."""
        return dict(occ=self.occ, bb=self.bb, head=self.head)

    def entry(self) -> dict:
        """What a traced run keeps of the batch for its pool entry's FLOP count."""
        if self.use_occ:
            return {k: self.occ[k] for k in MERGED}
        return self.table

    def clear(self):
        self.occ = self.bb = self.head = self.table = None

    def remove(self):
        for h in self.handles:
            h.remove()


def reference_net(cfg_dict: dict, sd: dict, device):
    from benchmark.reference.btcref.config import EasyDict
    from benchmark.reference.btcref.models.detectors import btcnet as rbtcnet

    cfg = EasyDict(cfg_dict)
    ref = rbtcnet.build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device=device)
    ref.load_state_dict(sd)
    return ref.eval(), cfg


def check(cfg_dict, sd, last, sampled, device, want_work=False, lowp=False):
    """{number: value} of the comparison with the reference, and the work
    recorder of the reference's pass over the last batch (`want_work`).
    `last` holds the last batch (`batch`), the forward's output (`out`) and
    `Capture.kept()`; `sampled` the (`final_inputs`, detections on the
    host) of the sampled batches. `lowp` runs the reference in the
    control's precision in the program's place (the program's own stage
    outputs are then not read)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref, cfg = reference_net(cfg_dict, sd, device)
        nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        args = (ref, last["batch"], last["occ"], last["bb"], last["head"], last["out"], nms)
        rec = counts.WorkRecorder() if want_work else None
        if rec is not None:
            with rec:
                want = stages.ref_stages(*args)
        else:
            want = stages.ref_stages(*args)
        if lowp:
            from benchmark.reference.lowp import fp8_operands

            with fp8_operands():
                got = stages.ref_stages(*args, decode_dtype=LOWP_DECODE)
        else:
            got = stages.program_stages(last["occ"], last["bb"], last["head"], last["out"])
        checks = stages.gaps(got, want)
        del got, want
        roi_head = ref.det_modules.roi_head
        box_gaps = []
        for inp, _ in sampled:
            raw = (inp["rois"], inp["rcnn_cls"], inp["rcnn_reg"])
            want = stages.decode_rcnn(roi_head, *raw)
            got = (stages.decode_rcnn(roi_head, *raw, dtype=LOWP_DECODE) if lowp
                   else [inp["batch_cls_preds"], inp["batch_box_preds"]])
            box_gaps.append(stages.box_gap(got, want))
        checks["rcnn_boxes"] = max(box_gaps)
        post_cfg = cfg.MODEL.POST_PROCESSING
        ref_dets = [stages.ref_final(ref, inp, post_cfg, device) for inp, _ in sampled]
        checks["final"] = stages.final_mismatch([d for _, d in sampled], ref_dets)
        return checks, rec
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def entry_flops(ref, entry: dict, B: int) -> float:
    """The sparse convs' FLOPs of one pool entry (`Capture.entry()`), counted
    by the reference's det backbone (`ref` from `reference_net`) on the
    entry's merged det table, or on its own voxel table through MeanVFE."""
    nx, ny, nz = ref.det_grid_size
    rec = counts.WorkRecorder()
    with torch.no_grad(), rec:
        if "det_occ_code" in entry:
            st, code = rsparse.from_coords(entry["det_voxel_features"].float(),
                                           entry["det_voxel_coords"], (nz + 1, ny, nx), B,
                                           aux=entry["det_occ_code"].float())
        else:
            st = rsparse.from_coords(ref.vfe(entry["voxels"], entry["voxel_num_points"]),
                                     entry["voxel_coords"], (nz + 1, ny, nx), B)
            code = None
        ref.det_modules.backbone_3d(st, code)
    return rec.sparse_flops()
