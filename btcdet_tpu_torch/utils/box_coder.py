"""Box coders (counterpart of `btcdet_tpu/utils/box_coder.py`)."""

from __future__ import annotations

import torch


class ResidualCoder:
    """SECOND residual encoding: diagonal-normalised centre residuals, log
    dims, heading residual (reference `box_coder_utils.py:78-140`)."""

    def __init__(self, code_size: int = 7):
        self.code_size = code_size

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """boxes, anchors (..., 7) -> (..., 7) residuals."""
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3:6].clamp(min=1e-5).unbind(-1)
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = boxes[..., 3:6].clamp(min=1e-5).unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
            boxes[..., 6] - anchors[..., 6],
        ], dim=-1)

    def decode(self, box_encodings: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)[:7]
        xt, yt, zt, dxt, dyt, dzt, rt = box_encodings.unbind(-1)[:7]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
            rt + ra,
        ], dim=-1)
