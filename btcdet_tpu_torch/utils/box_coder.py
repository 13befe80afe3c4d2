"""Box coders (counterpart of `btcdet_tpu/utils/box_coder.py`, reference
`btcdet/utils/box_coder_utils.py`).

`ResidualCoder` is the one the RPN and ROI heads of every shipped config
use. The others are there for configs that name them (`build_box_coder`):
`AbsResidualCoder` (plain differences), `DeltaXYZWLHRBBoxCoder` (the
residual coder under another name), the decode-only
`PreviousResidualDecoder` / `PreviousResidualRoIDecoder`, and the
point-anchored `PointResidualCoder`. Columns past the box's 7 (velocities
and the like) encode and decode as plain differences.
"""

from __future__ import annotations

import torch


def _sincos_residual(rg, ra):
    return [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]


class ResidualCoder:
    """SECOND residual encoding: diagonal-normalised centre residuals, log
    dims, heading residual, or (`encode_angle_by_sincos`) the cos / sin
    differences of the heading (reference `box_coder_utils.py:78-140`)."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False, **kwargs):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """boxes, anchors (..., 7 + C) -> (..., code_size + C) residuals."""
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3:6].clamp(min=1e-5).unbind(-1)
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = boxes[..., 3:6].clamp(min=1e-5).unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        rg, ra = boxes[..., 6], anchors[..., 6]
        rts = _sincos_residual(rg, ra) if self.encode_angle_by_sincos else [rg - ra]
        extras = [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        return torch.stack([
            (xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza), *rts, *extras,
        ], dim=-1)

    def decode(self, box_encodings: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """box_encodings (..., code_size + C), anchors (..., 7 + C) -> boxes
        (..., 7 + C)."""
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)[:7]
        xt, yt, zt, dxt, dyt, dzt = box_encodings.unbind(-1)[:6]
        if self.encode_angle_by_sincos:
            cost, sint = box_encodings[..., 6], box_encodings[..., 7]
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
            extra0 = 8
        else:
            rg = box_encodings[..., 6] + ra
            extra0 = 7
        extras = [box_encodings[..., extra0 + i] + anchors[..., 7 + i]
                  for i in range(box_encodings.shape[-1] - extra0)]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza, rg, *extras,
        ], dim=-1)


class AbsResidualCoder:
    """Plain differences against the anchor: centre, dims (clamped at
    1e-5), heading or its cos / sin differences (reference
    `box_coder_utils.AbsResidualCoder:4-76`)."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False, **kwargs):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        da = anchors[..., 3:6].clamp(min=1e-5)
        dg = boxes[..., 3:6].clamp(min=1e-5)
        ra, rg = anchors[..., 6:7], boxes[..., 6:7]
        rot = (torch.cat(_sincos_residual(rg, ra), -1) if self.encode_angle_by_sincos
               else rg - ra)
        return torch.cat([boxes[..., 0:3] - anchors[..., 0:3], dg - da, rot,
                          boxes[..., 7:] - anchors[..., 7:]], -1)

    def decode(self, box_encodings, anchors):
        ra = anchors[..., 6:7]
        if self.encode_angle_by_sincos:
            rg = torch.atan2(box_encodings[..., 7:8] + torch.sin(ra),
                             box_encodings[..., 6:7] + torch.cos(ra))
            extra = box_encodings[..., 8:] + anchors[..., 7:]
        else:
            rg = box_encodings[..., 6:7] + ra
            extra = box_encodings[..., 7:] + anchors[..., 7:]
        return torch.cat([box_encodings[..., 0:3] + anchors[..., 0:3],
                          box_encodings[..., 3:6] + anchors[..., 3:6], rg, extra], -1)


class DeltaXYZWLHRBBoxCoder(ResidualCoder):
    """The residual coder under the name the reference also keeps
    (`box_coder_utils.DeltaXYZWLHRBBoxCoder`)."""


class PreviousResidualDecoder:
    """Decode-only legacy coder (reference
    `box_coder_utils.PreviousResidualDecoder`): the dims decode from the
    (w, l, h) order of the encodings, columns past 7 add to the anchor's."""

    code_size = 7

    @staticmethod
    def decode(box_encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)[:7]
        xt, yt, zt, wt, lt, ht, rt = box_encodings.unbind(-1)[:7]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        out = torch.stack([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                           torch.exp(lt) * dxa, torch.exp(wt) * dya, torch.exp(ht) * dza,
                           rt + ra], dim=-1)
        return torch.cat([out, box_encodings[..., 7:] + anchors[..., 7:]], -1)


class PreviousResidualRoIDecoder(PreviousResidualDecoder):
    """`PreviousResidualDecoder` with the heading decoded as ra - rt
    (reference `box_coder_utils.PreviousResidualRoIDecoder:185-216`)."""

    @staticmethod
    def decode(box_encodings, anchors):
        out = PreviousResidualDecoder.decode(box_encodings, anchors)
        rg = anchors[..., 6] - box_encodings[..., 6]
        return torch.cat([out[..., :6], rg[..., None], out[..., 7:]], -1)


class PointResidualCoder:
    """Boxes against bare points (reference
    `box_coder_utils.PointResidualCoder`): with `use_mean_size` the
    residuals of the class's mean size ((class id - 1) rows of
    `mean_size`, the first row without class ids), else plain offsets and
    log dims; the heading as (cos, sin)."""

    def __init__(self, code_size: int = 8, use_mean_size: bool = True, mean_size=None,
                 **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        self.mean_size = torch.tensor(mean_size if mean_size is not None
                                      else [[3.9, 1.6, 1.56]], dtype=torch.float32)

    def _mean(self, classes, like):
        mean = self.mean_size.to(like.device)
        m = mean[classes.long() - 1] if classes is not None else mean[0]
        return m[..., 0], m[..., 1], m[..., 2]

    def encode(self, boxes, points, gt_classes=None):
        xg, yg, zg, dxg, dyg, dzg, rg = boxes.unbind(-1)[:7]
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._mean(gt_classes, boxes)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                   torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            res = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg)]
        return torch.stack([*res, torch.cos(rg), torch.sin(rg)], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        xt, yt, zt, dxt, dyt, dzt, cost, sint = box_encodings.unbind(-1)[:8]
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._mean(pred_classes, box_encodings)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            out = [xt * diag + xa, yt * diag + ya, zt * dza + za,
                   torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            out = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        return torch.stack([*out, torch.atan2(sint, cost)], dim=-1)


_CODERS = {
    "ResidualCoder": ResidualCoder,
    "AbsResidualCoder": AbsResidualCoder,
    "DeltaXYZWLHRBBoxCoder": DeltaXYZWLHRBBoxCoder,
    "PreviousResidualDecoder": PreviousResidualDecoder,
    "PreviousResidualRoIDecoder": PreviousResidualRoIDecoder,
    "PointResidualCoder": PointResidualCoder,
}


def build_box_coder(name: str, **kwargs):
    """The coder class named `name` (a config's BOX_CODER) built with
    `kwargs` (its BOX_CODER_CONFIG)."""
    return _CODERS[name](**kwargs)
