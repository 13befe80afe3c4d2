"""What the eval cell knows of PV-RCNN (`MODEL.NAME: PVRCNN`).

The harness (`benchmark/lib/`) finds this module by the configuration's
`MODEL.NAME`, lower-cased (`lib/spec.arch_module`), and reads what
`arch/btcnet.py` lists: `STAGES`, `post_processing`, `final_inputs`,
`Capture`, `check`, `check_names`, `reference_net` and `entry_flops`.

The reference (`reference.pvref`) starts its backbone from the batch's own
voxel table through MeanVFE and its FPS from the batch's points; every
later stage starts from what the program handed it (`pvref.stages`). The
work recorder of `check` (`work.pvrcnn.WorkRecorder`) also logs the
reference's furthest point sampling, which `fps_roofline.eval` reads.
"""

from __future__ import annotations

import torch

from benchmark.reference import stages
from benchmark.reference.btcref.ops import sparse as rsparse
from benchmark.reference.pvref import stages as pstages
from benchmark.work import pvrcnn as pwork

# the program's stage ranges of one eval forward + post-processing, in order
# (the port's `pv_rcnn.STAGES`)
STAGES = ("backbone_3d", "vsa", "bev", "dense_head", "point_head", "proposal_nms",
          "roi_grid_pool", "roi_head", "post_processing")
# the control's precision for the box decodes, which the configuration
# computes in float32 (its linears and convs, on bfloat16, take float8:
# `reference.lowp`)
LOWP_DECODE = torch.bfloat16
# the batch's voxel table, which the backbone reads
TABLE = ("voxels", "voxel_coords", "voxel_num_points")


def check_names(cfg) -> list:
    """The numbers `check` reads."""
    return [*pstages.KINDS, "rcnn_boxes", "final"]


def post_processing(out: dict, cfg, device) -> dict:
    """The program's final NMS (the rois' labels as the detections')."""
    from btcdet_tpu_torch.models.detectors import btcnet

    return btcnet.post_processing(out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), device)


def final_inputs(out: dict) -> dict:
    """What the final NMS reads, and the raw roi head outputs its boxes and
    scores were decoded from."""
    return {k: out[k] for k in ("batch_cls_preds", "batch_box_preds", "roi_labels",
                                "roi_valid", "rois", "rcnn_cls", "rcnn_reg")}


class Capture:
    """Forward hooks that keep the batch's voxel table (a pre-hook on the
    network), the backbone's levels and the dense head's dict of the batch
    in flight; the rest `check` reads is in the forward's output."""

    def __init__(self, net, cfg):
        self.table = self.bb = self.head = None
        self.handles = [net.register_forward_pre_hook(self._table),
                        net.backbone_3d.register_forward_hook(self._bb),
                        net.dense_head.register_forward_hook(self._head)]

    def _table(self, mod, args):
        self.table = {k: args[0][k] for k in TABLE}

    def _bb(self, mod, args, out):
        self.bb = {k: stages.sparse_fields(out[k]) for k in pstages.LEVELS}

    def _head(self, mod, args, out):
        self.head = out

    def kept(self) -> dict:
        return dict(bb=self.bb, head=self.head)

    def entry(self) -> dict:
        """What a traced run keeps of the batch for its pool entry's FLOP count."""
        return self.table

    def clear(self):
        self.table = self.bb = self.head = None

    def remove(self):
        for h in self.handles:
            h.remove()


def reference_net(cfg_dict: dict, sd: dict, device):
    from benchmark.reference.btcref.config import EasyDict
    from benchmark.reference.pvref import pvrcnn

    cfg = EasyDict(cfg_dict)
    ref = pvrcnn.build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device)
    ref.load_state_dict(sd)
    return ref.eval(), cfg


def check(cfg_dict, sd, last, sampled, device, want_work=False, lowp=False):
    """{number: value} of the comparison with the reference, and the work
    recorder of the reference's pass over the last batch (`want_work`), as
    `arch/btcnet.py`'s `check`."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref, cfg = reference_net(cfg_dict, sd, device)
        nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        args = (ref, last["batch"], last["bb"], last["head"], last["out"], nms)
        rec = pwork.WorkRecorder() if want_work else None
        if rec is not None:
            with rec:
                want = pstages.ref_stages(*args)
        else:
            want = pstages.ref_stages(*args)
        if lowp:
            from benchmark.reference.lowp import fp8_operands

            with fp8_operands():
                got = pstages.ref_stages(*args, decode_dtype=LOWP_DECODE)
        else:
            got = pstages.program_stages(last["bb"], last["head"], last["out"])
        checks = pstages.gaps(got, want)
        del got, want
        box_gaps = []
        for inp, _ in sampled:
            raw = (inp["rois"], inp["rcnn_cls"], inp["rcnn_reg"])
            want = stages.decode_rcnn(ref.roi_head, *raw)
            got = (stages.decode_rcnn(ref.roi_head, *raw, dtype=LOWP_DECODE) if lowp
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
    """The sparse convs' FLOPs of one pool entry (`Capture.entry()`, its voxel
    table), counted by the reference's backbone through its MeanVFE."""
    nx, ny, nz = ref.det_grid_size
    rec = pwork.WorkRecorder()
    with torch.no_grad(), rec:
        st = rsparse.from_coords(ref.vfe(entry["voxels"], entry["voxel_num_points"]),
                                 entry["voxel_coords"], (nz + 1, ny, nx), B)
        ref.backbone_3d(st, None)
    return rec.sparse_flops()
