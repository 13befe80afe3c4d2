"""3D backbones (counterpart of `btcdet_tpu/models/backbones_3d.py`).

`VoxelBackBone8xOcc` -- the det backbone (reference
`spconv_backbone.py:630-1020`): SECOND-style 8x sparse encoder (channels
16/32/64/64/128 on the flagship), the occ-code side branch (the occ code
max-pooled onto the conv2 sites and concatenated into the trunk before
`conv2_combine`) and the `big_bev_combine` multi-scale fusion that feeds
ConvHead's `x_combine` branch.

`VoxelBackBoneDeconv` -- the occupancy backbone (reference
`spconv_backbone.py:91-224`) on the small cylinder occ grid, run as dense
cuDNN conv3d / conv_transpose3d that reproduce the sparse semantics: the
active-site mask is dilated alongside each regular / transpose conv,
batch norm uses running statistics on active sites, inactive sites are
re-zeroed after every block.

Submodule names follow the reference state dict (`conv1.0.weight`,
`conv2_combine.1.1.running_var`, `deconv4.0.0.weight`); conv weights keep
the spconv layout (kz, ky, kx, Cin, Cout).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sparse
from ..utils.common import activation_dtype


class SparseConvBlock(nn.Module):
    """conv (`0`) + masked BN (`1`) + ReLU on a SparseTensor (reference
    `post_act_block`)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0, conv_type="subm",
                 indice_key=None, frame_capacity=None):
        super().__init__()
        if conv_type == "subm":
            conv = sparse.SubMConv3d(cin, cout, kernel_size, indice_key=indice_key)
        elif conv_type == "spconv":
            conv = sparse.SparseConv3d(cin, cout, kernel_size, stride, padding,
                                       indice_key=indice_key, frame_capacity=frame_capacity)
        else:
            raise NotImplementedError(conv_type)
        self.add_module("0", conv)
        self.add_module("1", sparse.MaskedBatchNorm(cout))

    def forward(self, st: sparse.SparseTensor, cache: dict) -> sparse.SparseTensor:
        st = getattr(self, "0")(st, cache)
        valid = st.valid
        f = torch.relu(getattr(self, "1")(st.features, valid))
        return st.replace(features=torch.where(valid[:, None], f, torch.zeros_like(f)))


def _seq(*blocks):
    return nn.ModuleList(blocks)


class VoxelBackBone8xOcc(nn.Module):
    """Returns {"encoded": stride-8 z-squeezed tensor, "x_combine": fused
    tensor on the x_conv4 grid, and the per-level tensors}.

    `occ_code_num` > 0 with `occ_conv_exec` [False, True] and
    `occ_conv_type[1]` "maxpool" is the flagship's occ side branch: conv1
    takes the voxel features with the occ code appended, and the occ code
    (a per-row side table of the input) is max-pooled onto the conv2 sites
    (`occ_conv2`, no norm, no activation) and concatenated onto x_conv2."""

    def __init__(self, input_channels: int, channels=(16, 32, 64, 64, 128),
                 out_feat_type=("None", "None", "None", "None", "big_bev_combine"),
                 level_caps=None, occ_code_num: int = 0, occ_conv_type=(),
                 occ_conv_exec=(), out_att=()):
        super().__init__()
        ch = list(channels)
        self.out_feat_type = tuple(out_feat_type)
        # {"train": per-frame caps or None, "test": ...}
        self.level_caps = dict(level_caps or {})
        exec_ = [bool(e) for e in occ_conv_exec]
        if any(out_att):
            raise NotImplementedError("OCC_ATT attention blocks")
        if any(exec_):
            if exec_ != [False, True] or occ_code_num <= 0:
                raise NotImplementedError(
                    f"OCC_CONV_EXECUTE {exec_}: only the level-2 occ code concat is ported")
            if occ_conv_type[1] != "maxpool":
                raise NotImplementedError(f"occ-code downsampler {occ_conv_type[1]!r}")
        self.occ_cat2 = any(exec_)
        blk = SparseConvBlock
        self.conv1 = blk(input_channels, ch[0], 3, indice_key="subm1")
        self.conv1_combine = _seq(blk(ch[0], ch[0], 3, indice_key="subm1"))
        self.conv2 = _seq(blk(ch[0], ch[1], 3, 2, 1, "spconv", "spconv2", self._cap(0)))
        if self.occ_cat2:
            # occ_conv2: shares the spconv2 site set, so it is row-aligned with x_conv2
            self.occ_conv2 = sparse.SparseMaxPool3d(3, 2, 1, indice_key="spconv2")
        c2_in = ch[1] + (occ_code_num if self.occ_cat2 else 0)
        self.conv2_combine = _seq(blk(c2_in, ch[1], 3, indice_key="subm2"),
                                  blk(ch[1], ch[1], 3, indice_key="subm2"))
        self.conv3 = _seq(blk(ch[1], ch[2], 3, 2, 1, "spconv", "spconv3", self._cap(1)))
        self.conv3_combine = _seq(blk(ch[2], ch[2], 3, indice_key="subm3"),
                                  blk(ch[2], ch[2], 3, indice_key="subm3"))
        self.conv4 = _seq(blk(ch[2], ch[3], 3, 2, (0, 1, 1), "spconv", "spconv4", self._cap(2)))
        self.conv4_combine = _seq(blk(ch[3], ch[3], 3, indice_key="subm4"),
                                  blk(ch[3], ch[3], 3, indice_key="subm4"))
        # [5, 200, 176] -> [2, 200, 176] on the flagship grid
        self.conv_out = blk(ch[3], ch[4], (3, 1, 1), (2, 1, 1), 0, "spconv", "spconv_down2",
                            self._cap(3))
        comb = self.out_feat_type[4]
        if comb not in ("None", "big_bev_combine"):
            raise NotImplementedError(f"OUT_FEAT_TYPE {comb}")
        if comb == "big_bev_combine":
            # down2 / down3 reuse the spconv3 / spconv4 site sets
            self.down2 = _seq(blk(ch[1], ch[1], 3, 2, 1, "spconv", "spconv3"),
                              blk(ch[1], ch[2], 3, 2, (0, 1, 1), "spconv", "spconv4"))
            self.down3 = _seq(blk(ch[2], ch[2], 3, 2, (0, 1, 1), "spconv", "spconv4"))
            self.squeezeBev = _seq(blk(ch[4], ch[3], (2, 1, 1), (2, 1, 1), 0, "spconv",
                                       "subm_down2"))
            cin = ch[2] + ch[2] + ch[3] + ch[3]   # d2 | d3 | x_conv4 | squeezed BEV
            self.down_combine = _seq(blk(cin, ch[3] * 2, 3, indice_key="subm4"),
                                     blk(ch[3] * 2, ch[3] * 2, 3, indice_key="subm4"))

    def _cap(self, level: int):
        """(train, eval) per-frame capacities (LEVEL_CAPACITIES) of strided
        level `level`; None inherits the input capacity. Train without its
        own caps inherits, as in the JAX package."""
        def pick(mode):
            caps = self.level_caps.get(mode)
            if caps is None or level >= len(caps) or not caps[level]:
                return None
            return int(caps[level])
        return pick("train"), pick("test")

    def forward(self, st: sparse.SparseTensor, occ_code=None) -> dict:
        """occ_code: (N, occ_code_num) per-row side table of `st` (the
        occ side branch), or None."""
        cache: dict = {}
        x = self.conv1(st, cache)
        x_conv1 = self.conv1_combine[0](x, cache)
        x_conv2 = self.conv2[0](x_conv1, cache)
        if self.occ_cat2:
            x_occ = self.occ_conv2(st.replace(features=occ_code), cache)
            x_conv2 = x_conv2.replace(features=torch.cat([x_conv2.features, x_occ.features], -1))
        for b in self.conv2_combine:
            x_conv2 = b(x_conv2, cache)
        x_conv3 = self.conv3[0](x_conv2, cache)
        for b in self.conv3_combine:
            x_conv3 = b(x_conv3, cache)
        x_conv4 = self.conv4[0](x_conv3, cache)
        for b in self.conv4_combine:
            x_conv4 = b(x_conv4, cache)
        out = self.conv_out(x_conv4, cache)
        x_combine = None
        if self.out_feat_type[4] == "big_bev_combine":
            x_combine = self._big_bev_combine(x_conv2, x_conv3, x_conv4, out, cache)
        return {"encoded": out, "x_conv1": x_conv1, "x_conv2": x_conv2,
                "x_conv3": x_conv3, "x_conv4": x_conv4, "x_combine": x_combine}

    def _big_bev_combine(self, x_conv2, x_conv3, x_conv4, bev_out, cache):
        """reference `res_combine` (`spconv_backbone.py:905-918`)."""
        d2 = self.down2[1](self.down2[0](x_conv2, cache), cache)
        d3 = self.down3[0](x_conv3, cache)
        feats = torch.cat([d2.features, d3.features, x_conv4.features], dim=-1)
        sq = self.squeezeBev[0](bev_out, cache)
        dense_bev = sq.dense()                           # (B, nz, ny, nx, C)
        B, nz, ny, nx, C = dense_bev.shape
        bev2d = dense_bev.permute(0, 2, 3, 1, 4).reshape(B, ny, nx, nz * C)
        c = x_conv4.coords.long()
        gathered = bev2d[c[:, 0].clamp(0, B - 1), c[:, 2].clamp(0, ny - 1), c[:, 3].clamp(0, nx - 1)]
        valid = x_conv4.valid
        gathered = torch.where(valid[:, None], gathered, torch.zeros_like(gathered))
        x = x_conv4.replace(features=torch.cat([feats, gathered], dim=-1))
        for b in self.down_combine:
            x = b(x, cache)
        return x


# ------------------------------------------------------- occ backbone


def _dilate_mask(mask, kernel, stride, padding, transpose: bool = False):
    """Active sites of a regular (or transpose) sparse conv: an output site
    is active iff some input in its receptive field is. mask (B, D, H, W)."""
    m = mask[:, None].float()
    ones = torch.ones((1, 1, *kernel), dtype=torch.float32, device=mask.device)
    conv = F.conv_transpose3d if transpose else F.conv3d
    return conv(m, ones, stride=stride, padding=padding)[:, 0] > 0.5


class DenseSparseBlock(nn.Module):
    """conv (`0`, spconv weight layout, no bias) -> masked BN (`1`, running
    statistics) -> ReLU -> re-zero the inactive sites; the mask dilates
    like a regular / transpose sparse conv's active set, or stays
    (submanifold). Channels-first dense volumes (B, C, D, H, W)."""

    def __init__(self, cin, cout, stride=1, transpose: bool = False, submanifold: bool = False):
        super().__init__()
        self.stride = stride
        self.transpose, self.submanifold = transpose, submanifold
        conv = nn.Module()
        conv.weight = nn.Parameter(torch.empty(3, 3, 3, cin, cout))
        nn.init.normal_(conv.weight, std=(1.0 / (27 * cin)) ** 0.5)
        self.add_module("0", conv)
        self.add_module("1", sparse.MaskedBatchNorm(cout))

    def forward(self, x, mask):
        dt = activation_dtype()
        w = getattr(self, "0").weight
        if self.transpose:
            # torch's transpose conv is the adjoint of the strided conv: the
            # spconv deconv weights apply as stored (the JAX package's flax
            # ConvTranspose needs them spatially flipped)
            y = F.conv_transpose3d(x.to(dt), w.permute(3, 4, 0, 1, 2).to(dt),
                                   stride=self.stride, padding=1)
            new_mask = _dilate_mask(mask, (3, 3, 3), self.stride, 1, transpose=True)
        else:
            y = F.conv3d(x.to(dt), w.permute(4, 3, 0, 1, 2).to(dt), stride=self.stride, padding=1)
            new_mask = mask if self.submanifold else _dilate_mask(mask, (3, 3, 3), self.stride, 1)
        B, C, D, H, W = y.shape
        rows = y.permute(0, 2, 3, 4, 1).reshape(-1, C)
        y = torch.relu(getattr(self, "1")(rows, new_mask.reshape(-1)))
        y = y.reshape(B, D, H, W, C).permute(0, 4, 1, 2, 3)
        return torch.where(new_mask[:, None], y, torch.zeros_like(y)), new_mask


class VoxelBackBoneDeconv(nn.Module):
    """Occupancy backbone: dense (B, C, nz, ny, nx) + active mask in, the
    stride-1 `channels[1]`-wide volume and its active mask out, cropped /
    zero-padded back to the input grid."""

    def __init__(self, input_channels: int, channels=(16, 32, 64)):
        super().__init__()
        c0, c1, c2 = channels
        blk = DenseSparseBlock
        self.conv1 = _seq(blk(input_channels, c0))
        self.conv2 = _seq(blk(c0, c1, stride=2), blk(c1, c1, submanifold=True))
        self.conv3 = _seq(blk(c1, c2, stride=2), blk(c2, c2, submanifold=True))
        self.deconv4 = _seq(blk(c2, c1, stride=2, transpose=True), blk(c1, c1, submanifold=True))
        self.deconv5 = _seq(blk(c1, c1, stride=2, transpose=True), blk(c1, c1, submanifold=True))

    def forward(self, x, mask):
        tgt = mask.shape[1:4]
        for stage in (self.conv1, self.conv2, self.conv3, self.deconv4, self.deconv5):
            for b in stage:
                x, mask = b(x, mask)
        # stride-2 down / up does not invert every grid size: crop, then
        # zero-pad back to the input grid
        x = x[:, :, :tgt[0], :tgt[1], :tgt[2]]
        mask = mask[:, :tgt[0], :tgt[1], :tgt[2]]
        d, h, w = mask.shape[1:]
        out = x.new_zeros((*x.shape[:2], *tgt))
        out[:, :, :d, :h, :w] = x
        out_mask = mask.new_zeros((mask.shape[0], *tgt))
        out_mask[:, :d, :h, :w] = mask
        return out, out_mask
