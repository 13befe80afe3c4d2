"""HeightCompression and PointPillarScatter (counterpart of
`btcdet_tpu/models/map_to_bev.py`, reference `height_compression.py:10-26`
and `pointpillar_scatter.py`)."""

from __future__ import annotations

import torch

from ..ops import sparse
from ..utils.common import activation_dtype


class HeightCompression:
    """Densify the encoded sparse tensor and fold z into channels.

    Returns (bev_nchw, bev_nhwc):
      bev_nchw (B, C*nz, ny, nx): the reference's C-MAJOR fold (channel
        c*nz + d, `.dense().view(B, C*D, H, W)`), which the first BEV conv's
        reference weights expect;
      bev_nhwc (B, ny, nx, nz*C): the JAX package's z-major public layout
        (channel d*C + c) of the same map.
    Both in the activation dtype."""

    def __call__(self, st: sparse.SparseTensor):
        st = st.replace(features=st.features.to(activation_dtype()))
        d = st.dense(layout="yzx")                     # (B, ny, nz, nx, C)
        B, ny, nz, nx, C = d.shape
        nchw = d.permute(0, 4, 2, 1, 3).reshape(B, C * nz, ny, nx)
        nhwc = d.permute(0, 1, 3, 2, 4).reshape(B, ny, nx, nz * C)
        return nchw, nhwc


class PointPillarScatter:
    """Scatter pillar features onto the BEV canvas (reference
    `pointpillar_scatter.py`; no config names it). coords (N, 4) (b, z=0,
    y, x), rows with b < 0 are padding; `grid_size` (nx, ny, ...).

    Returns (bev_nchw (B, C, ny, nx), bev_nhwc (B, ny, nx, C)) as
    HeightCompression does (one z slice: both folds are the same map), in
    the features' dtype. Each cell holds at most one pillar, as the
    voxelizer makes them."""

    def __init__(self, num_bev_features: int, grid_size):
        self.num_bev_features = int(num_bev_features)
        self.nx, self.ny = int(grid_size[0]), int(grid_size[1])

    def __call__(self, pillar_features, coords, batch_size: int):
        C = pillar_features.shape[-1]
        cells = batch_size * self.ny * self.nx
        c = coords.long()
        valid = c[:, 0] >= 0
        idx = torch.where(valid, (c[:, 0] * self.ny + c[:, 2]) * self.nx + c[:, 3],
                          torch.full_like(c[:, 0], cells))
        canvas = torch.zeros((cells + 1, C), dtype=pillar_features.dtype,
                             device=pillar_features.device)
        canvas[idx] = torch.where(valid[:, None], pillar_features,
                                  torch.zeros_like(pillar_features))
        nhwc = canvas[:-1].reshape(batch_size, self.ny, self.nx, C)
        return nhwc.permute(0, 3, 1, 2), nhwc
