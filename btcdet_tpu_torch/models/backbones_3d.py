"""3D backbones (counterpart of `btcdet_tpu/models/backbones_3d.py`).

`VoxelBackBone8xOcc` -- the det backbone (reference
`spconv_backbone.py:630-1020`): SECOND-style 8x sparse encoder (channels
16/32/64/64/128 on the flagship), the occ-code side branch (the occ code
downsampled level to level by max-pool, fixed-weight sum or a learned
strided conv, concatenated into the trunk where OCC_CONV_EXECUTE says,
with the OCC_ATT attention blocks) and the multi-scale fusion
(OUT_FEAT_TYPE `combine`, `big_combine`, `big_bev_combine`) whose output
feeds ConvHead's `x_combine` branch.

`VoxelBackBoneDeconv` -- the occupancy backbone (reference
`spconv_backbone.py:91-224`) on the small cylinder occ grid, run as dense
cuDNN conv3d / conv_transpose3d that reproduce the sparse semantics: the
active-site mask is dilated alongside each regular / transpose conv,
batch norm uses running statistics on active sites, inactive sites are
re-zeroed after every block. Its convs run under cuDNN's deterministic
algorithms, so the occupancy probabilities (and the top-K that reads them)
are the same from run to run on the card. `VoxelBackBoneDeconvRes` and
`VoxelBackBoneInverseRes` (BACKBONE_3D.NAME of MODEL.OCC) add residual
blocks and the decoder's lateral skips on the same dense blocks.

Submodule names follow the reference state dict (`conv1.0.weight`,
`conv2_combine.1.1.running_var`, `deconv4.0.0.weight`); conv weights keep
the spconv layout (kz, ky, kx, Cin, Cout).
"""

from __future__ import annotations

import inspect

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sparse
from ..utils.common import activation_dtype


class SparseConvBlock(nn.Module):
    """conv or pool (`0`) + masked BN (`1`) + activation on a SparseTensor
    (reference `post_act_block`). With `use_norm` False (the occ-code
    downsamplers) the block is the bare conv or pool: no BN, no
    activation. conv_type: subm | spconv | maxpool | fixspconv (the
    constant-weight sum, `default_value` per tap)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0, conv_type="subm",
                 indice_key=None, frame_capacity=None, use_norm: bool = True,
                 activation: str = "relu", default_value: float = 1.0 / 27):
        super().__init__()
        if conv_type == "subm":
            conv = sparse.SubMConv3d(cin, cout, kernel_size, indice_key=indice_key)
        elif conv_type == "spconv":
            conv = sparse.SparseConv3d(cin, cout, kernel_size, stride, padding,
                                       indice_key=indice_key, frame_capacity=frame_capacity)
        elif conv_type == "maxpool":
            conv = sparse.SparseMaxPool3d(kernel_size, stride, padding, indice_key=indice_key)
        elif conv_type == "fixspconv":
            conv = sparse.FixedSparseConv3d(kernel_size, stride, padding, indice_key=indice_key,
                                            default_value=default_value)
        else:
            raise NotImplementedError(conv_type)
        if activation not in ("relu", "leaky_relu"):
            raise NotImplementedError(f"activation {activation}")
        self.activation = activation
        self.add_module("0", conv)
        if use_norm:
            self.add_module("1", sparse.MaskedBatchNorm(cout))

    def forward(self, st: sparse.SparseTensor, cache: dict) -> sparse.SparseTensor:
        st = getattr(self, "0")(st, cache)
        if not hasattr(self, "1"):
            return st
        valid = st.valid
        f = getattr(self, "1")(st.features, valid)
        f = torch.relu(f) if self.activation == "relu" else F.leaky_relu(f, 0.01)
        return st.replace(features=torch.where(valid[:, None], f, torch.zeros_like(f)))


def _seq(*blocks):
    return nn.ModuleList(blocks)


class VoxelBackBone8xOcc(nn.Module):
    """Returns {"encoded": stride-8 z-squeezed tensor, "x_combine": fused
    tensor on the x_conv4 sites (`combine`: on its own stride-(1,2,2)
    sites; None for OUT_FEAT_TYPE "None"), and the per-level tensors}.

    The occ-code side branch (`occ_code_num` > 0; the occ code is a per-row
    side table of the input): the code is downsampled level to level by
    `occ_conv_type[l]` (`_occ_down`: maxpool, fix, avgpool or weight; level
    0 is the identity), and where `occ_conv_exec[l]` holds it is
    concatenated onto the trunk at level l, before conv1_combine,
    conv2_combine_0, conv3_combine_0 or conv4_combine_0. `out_att[0]` /
    `out_att[1]` add the attention blocks `att_conv1` / `att_conv2` (x * att
    + x) after the level-0 / level-1 concat. The flagship runs
    `occ_conv_type` ['identity', 'maxpool'], `occ_conv_exec` [False, True]:
    conv1 reads the voxel features with the occ code appended, and the code
    max-pooled onto the conv2 sites joins x_conv2."""

    def __init__(self, input_channels: int, channels=(16, 32, 64, 64, 128),
                 out_feat_type=("None", "None", "None", "None", "big_bev_combine"),
                 level_caps=None, occ_code_num: int = 0, occ_conv_type=(),
                 occ_conv_exec=(), out_att=()):
        super().__init__()
        ch = list(channels)
        self.out_feat_type = tuple(out_feat_type)
        # {"train": per-frame caps or None, "test": ...}
        self.level_caps = dict(level_caps or {})
        self.occ_exec = [bool(e) for e in occ_conv_exec]
        if any(self.occ_exec) and occ_code_num <= 0:
            raise ValueError(f"OCC_CONV_EXECUTE {self.occ_exec} without an occ code")
        # the occ code is downsampled to every level that OCC_CONV_EXECUTE
        # lists (levels 1 .. len - 1), concatenated only where it is true
        self.occ_levels = len(self.occ_exec) if occ_code_num > 0 else 0
        add = [occ_code_num if l < self.occ_levels and self.occ_exec[l] else 0 for l in range(4)]
        att = [bool(a) for a in out_att] + [False] * 2
        blk = SparseConvBlock
        self.conv1 = blk(input_channels, ch[0], 3, indice_key="subm1")
        if add[0] and att[0]:
            self.att_conv1 = _seq(blk(ch[0] + add[0], ch[0] + add[0], 3, indice_key="subm1",
                                      activation="leaky_relu"))
        self.conv1_combine = _seq(blk(ch[0] + add[0], ch[0], 3, indice_key="subm1"))
        self.conv2 = _seq(blk(ch[0], ch[1], 3, 2, 1, "spconv", "spconv2", self._cap(0)))
        for level in range(1, self.occ_levels):
            self.add_module(f"occ_conv{level + 1}",
                            _seq(self._occ_down(level, occ_conv_type, occ_code_num)))
        if add[1] and att[1]:
            self.att_conv2 = _seq(blk(ch[1] + add[1], ch[1] + add[1], 3, indice_key="subm2",
                                      activation="leaky_relu"))
        self.conv2_combine = _seq(blk(ch[1] + add[1], ch[1], 3, indice_key="subm2"),
                                  blk(ch[1], ch[1], 3, indice_key="subm2"))
        self.conv3 = _seq(blk(ch[1], ch[2], 3, 2, 1, "spconv", "spconv3", self._cap(1)))
        self.conv3_combine = _seq(blk(ch[2] + add[2], ch[2], 3, indice_key="subm3"),
                                  blk(ch[2], ch[2], 3, indice_key="subm3"))
        self.conv4 = _seq(blk(ch[2], ch[3], 3, 2, (0, 1, 1), "spconv", "spconv4", self._cap(2)))
        self.conv4_combine = _seq(blk(ch[3] + add[3], ch[3], 3, indice_key="subm4"),
                                  blk(ch[3], ch[3], 3, indice_key="subm4"))
        # [5, 200, 176] -> [2, 200, 176] on the flagship grid
        self.conv_out = blk(ch[3], ch[4], (3, 1, 1), (2, 1, 1), 0, "spconv", "spconv_down2",
                            self._cap(3))
        comb = self.out_feat_type[4]
        if comb not in ("None", "combine", "big_combine", "big_bev_combine"):
            raise NotImplementedError(f"OUT_FEAT_TYPE {comb}")
        if comb != "None":
            # down2 / down3 reuse the spconv3 / spconv4 site sets
            self.down2 = _seq(blk(ch[1], ch[1], 3, 2, 1, "spconv", "spconv3"),
                              blk(ch[1], ch[2], 3, 2, (0, 1, 1), "spconv", "spconv4"))
            self.down3 = _seq(blk(ch[2], ch[2], 3, 2, (0, 1, 1), "spconv", "spconv4"))
            cin = ch[2] + ch[2] + ch[3]                      # d2 | d3 | x_conv4
            if comb == "big_bev_combine":
                self.squeezeBev = _seq(blk(ch[4], ch[3], (2, 1, 1), (2, 1, 1), 0, "spconv",
                                           "subm_down2"))
                cin += ch[3]                                 # | squeezed BEV
            combine = [blk(cin, ch[3] * 2, 3, indice_key="subm4")]
            if comb == "combine":
                # a stride-(1,2,2) conv onto its own sites, then a subm conv there
                combine += [blk(ch[3] * 2, ch[3] * 2, 3, (1, 2, 2), 1, "spconv", "spconv5",
                                self._cap(4)),
                            blk(ch[3] * 2, ch[3] * 2, 3, indice_key="subm5")]
            else:
                combine.append(blk(ch[3] * 2, ch[3] * 2, 3, indice_key="subm4"))
            self.down_combine = _seq(*combine)

    @staticmethod
    def _occ_down(level: int, occ_conv_type, occ_code_num: int):
        """The occ-code downsampler onto trunk level `level`'s sites (reference
        `build_occ_{maxpool,fix,avgpool,weight}_net`, `spconv_backbone.py:793-866`;
        the JAX package's `_occ_down`): a bare pool or conv with no norm and
        no activation, under the trunk conv's `spconv{level+1}` key. The k=3
        ones pair like the trunk conv; `avgpool`'s k=2 uses its own padding
        (`sparse.shared_sites`). A level past `occ_conv_type` pools."""
        t = occ_conv_type[level] if level < len(occ_conv_type) else "maxpool"
        c = occ_code_num
        kw = dict(indice_key=f"spconv{level + 1}", use_norm=False)
        pad = 1 if level < 3 else (1, 1, 1)
        if t == "maxpool":
            return SparseConvBlock(c, c, 3, 2, pad, "maxpool", **kw)
        if t == "fix":
            return SparseConvBlock(c, c, 3, 2, pad, "fixspconv", default_value=1.0 / 27, **kw)
        if t == "avgpool":
            return SparseConvBlock(c, c, 2, 2, pad, "fixspconv", default_value=1.0, **kw)
        if t == "weight":
            return SparseConvBlock(c, c, 3, 2, pad, "spconv", **kw)
        raise NotImplementedError(f"occ-code downsampler {t!r} at level {level}")

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

    def _occ_cat(self, level: int, x, x_occ, cache):
        """x with the occ code appended at `level` where it executes, then
        the level's attention block (level 0 / 1) if there is one."""
        if not (level < self.occ_levels and self.occ_exec[level]):
            return x
        x = x.replace(features=torch.cat([x.features, x_occ.features], -1))
        att = getattr(self, f"att_conv{level + 1}", None)
        if att is not None:
            a = att[0](x, cache)
            x = x.replace(features=x.features * a.features + x.features)
        return x

    def forward(self, st: sparse.SparseTensor, occ_code=None) -> dict:
        """occ_code: (N, occ_code_num) per-row side table of `st` (the
        occ side branch), or None."""
        cache: dict = {}
        x_occ = None if self.occ_levels == 0 else st.replace(features=occ_code)
        x = self._occ_cat(0, self.conv1(st, cache), x_occ, cache)
        x_conv1 = self.conv1_combine[0](x, cache)
        levels = [x_conv1]
        for level, (down, combine) in enumerate(((self.conv2, self.conv2_combine),
                                                 (self.conv3, self.conv3_combine),
                                                 (self.conv4, self.conv4_combine)), start=1):
            x = down[0](levels[-1], cache)
            if level < self.occ_levels:
                x_occ = getattr(self, f"occ_conv{level + 1}")[0](x_occ, cache)
            x = self._occ_cat(level, x, x_occ, cache)
            for b in combine:
                x = b(x, cache)
            levels.append(x)
        x_conv1, x_conv2, x_conv3, x_conv4 = levels
        out = self.conv_out(x_conv4, cache)
        x_combine = None
        if self.out_feat_type[4] != "None":
            x_combine = self._res_combine(x_conv2, x_conv3, x_conv4, out, cache)
        return {"encoded": out, "x_conv1": x_conv1, "x_conv2": x_conv2,
                "x_conv3": x_conv3, "x_conv4": x_conv4, "x_combine": x_combine}

    def _res_combine(self, x_conv2, x_conv3, x_conv4, bev_out, cache):
        """reference `res_combine` (`spconv_backbone.py:905-918`):
        down2(x_conv2) | down3(x_conv3) | x_conv4 [| the squeezed BEV
        gathered onto the x_conv4 sites, for big_bev_combine], then
        down_combine."""
        d2 = self.down2[1](self.down2[0](x_conv2, cache), cache)
        d3 = self.down3[0](x_conv3, cache)
        feats = [d2.features, d3.features, x_conv4.features]
        if self.out_feat_type[4] == "big_bev_combine":
            sq = self.squeezeBev[0](bev_out, cache)
            dense_bev = sq.dense()                       # (B, nz, ny, nx, C)
            B, nz, ny, nx, C = dense_bev.shape
            bev2d = dense_bev.permute(0, 2, 3, 1, 4).reshape(B, ny, nx, nz * C)
            c = x_conv4.coords.long()
            gathered = bev2d[c[:, 0].clamp(0, B - 1), c[:, 2].clamp(0, ny - 1),
                             c[:, 3].clamp(0, nx - 1)]
            feats.append(torch.where(x_conv4.valid[:, None], gathered, torch.zeros_like(gathered)))
        x = x_conv4.replace(features=torch.cat(feats, dim=-1))
        for b in self.down_combine:
            x = b(x, cache)
        return x


# ------------------------------------------------------- occ backbone


def deterministic_cudnn():
    """A context in which cuDNN picks deterministic algorithms only, every
    other cuDNN flag left as it is (`torch.backends.cudnn.flags` sets each
    argument it is not given None for)."""
    names = inspect.signature(torch.backends.cudnn.flags).parameters
    return torch.backends.cudnn.flags(**{n: None for n in names if n != "deterministic"},
                                      deterministic=True)


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
        with deterministic_cudnn():
            return self._forward(x, mask)

    def _forward(self, x, mask):
        tgt = mask.shape[1:4]
        for stage in (self.conv1, self.conv2, self.conv3, self.deconv4, self.deconv5):
            for b in stage:
                x, mask = b(x, mask)
        # stride-2 down / up does not invert every grid size
        return crop_pad_to(x, mask, tgt)


def crop_pad_to(x, mask, tgt):
    """Crop, then zero-pad, a (B, C, D, H, W) volume and its (B, D, H, W)
    mask to the spatial shape `tgt`."""
    x = x[:, :, :tgt[0], :tgt[1], :tgt[2]]
    mask = mask[:, :tgt[0], :tgt[1], :tgt[2]]
    d, h, w = mask.shape[1:]
    out = x.new_zeros((*x.shape[:2], *tgt))
    out[:, :, :d, :h, :w] = x
    out_mask = mask.new_zeros((mask.shape[0], *tgt))
    out_mask[:, :d, :h, :w] = mask
    return out, out_mask


class DenseResBlock(nn.Module):
    """Two submanifold blocks (`conv1`, `conv2`) and the identity skip,
    re-zeroed off the mask (reference `SparseBasicBlock`,
    `spconv_backbone.py:25-88`, densely; the JAX package's
    `_DenseResBlock`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = DenseSparseBlock(channels, channels, submanifold=True)
        self.conv2 = DenseSparseBlock(channels, channels, submanifold=True)

    def forward(self, x, mask):
        h, _ = self.conv1(x, mask)
        h, _ = self.conv2(h, mask)
        return torch.where(mask[:, None], h + x, torch.zeros((), dtype=h.dtype,
                                                             device=h.device)), mask


class VoxelBackBoneDeconvRes(nn.Module):
    """Residual occupancy backbone (reference `VoxelBackBoneDeconvRes`,
    `spconv_backbone.py:226-381`; the JAX package's): a residual block
    after each encoder conv and each decoder deconv, and lateral skips on
    the decoder: the deconv's output (cropped / padded to the encoder
    level's grid) plus the level's features (level 1 through the 1x1 conv
    `lat1`, from `channels[0]` to `channels[1]`) on the union of both
    masks, the reference's coordinate-union `combine`. `inverse` is
    `VoxelBackBoneInverseRes`: each deconv (`inv4`, `inv5`) restores the
    encoder level's active set exactly (SparseInverseConv3d), so the sum
    and every block after it keep that level's mask. Same interface as
    `VoxelBackBoneDeconv`."""

    inverse = False

    def __init__(self, input_channels: int, channels=(16, 32, 64)):
        super().__init__()
        c0, c1, c2 = channels
        blk = DenseSparseBlock
        up = ("inv4", "inv5") if self.inverse else ("deconv4", "deconv5")
        self.up_names = up
        self.conv1 = _seq(blk(input_channels, c0))
        self.res1 = DenseResBlock(c0)
        self.conv2 = _seq(blk(c0, c1, stride=2))
        self.res2 = DenseResBlock(c1)
        self.conv3 = _seq(blk(c1, c2, stride=2))
        self.res3 = DenseResBlock(c2)
        self.add_module(up[0], _seq(blk(c2, c1, stride=2, transpose=True)))
        self.res4 = DenseResBlock(c1)
        self.add_module(up[1], _seq(blk(c1, c1, stride=2, transpose=True)))
        self.lat1 = nn.Module()
        self.lat1.weight = nn.Parameter(torch.empty(1, 1, 1, c0, c1))
        nn.init.normal_(self.lat1.weight, std=(1.0 / c0) ** 0.5)
        self.res5 = DenseResBlock(c1)

    def forward(self, x, mask):
        with deterministic_cudnn():
            return self._forward(x, mask)

    def _lateral(self, u, mu, skip, m):
        """The decoder's lateral combine at one level: u cropped / padded
        to the level's grid, plus the level's features, on the union of
        the masks (on the level's own mask for the inverse backbone)."""
        u, mu = crop_pad_to(u, mu, m.shape[1:])
        keep = m if self.inverse else mu | m
        return torch.where(keep[:, None], u + skip, torch.zeros((), dtype=u.dtype,
                                                                device=u.device)), keep

    def _forward(self, x, mask):
        x1, m1 = self.res1(*self.conv1[0](x, mask))
        x2, m2 = self.res2(*self.conv2[0](x1, m1))
        x3, m3 = self.res3(*self.conv3[0](x2, m2))
        u2, mu2 = self.res4(*self._lateral(*getattr(self, self.up_names[0])[0](x3, m3), x2, m2))
        dt = activation_dtype()
        lat1 = F.conv3d(x1.to(dt), self.lat1.weight.permute(4, 3, 0, 1, 2).to(dt))
        u1, mu1 = self.res5(*self._lateral(*getattr(self, self.up_names[1])[0](u2, mu2), lat1,
                                           m1))
        return crop_pad_to(u1, mu1, mask.shape[1:4])


class VoxelBackBoneInverseRes(VoxelBackBoneDeconvRes):
    """Inverse-conv occupancy backbone (reference `VoxelBackBoneInverseRes`,
    `spconv_backbone.py:385-527`): `VoxelBackBoneDeconvRes` with the
    decoder masked to the encoder levels' active sets."""

    inverse = True


# the occupancy backbones by BACKBONE_3D.NAME
OCC_BACKBONES = {"VoxelBackBoneDeconv": VoxelBackBoneDeconv,
                 "VoxelBackBoneDeconvRes": VoxelBackBoneDeconvRes,
                 "VoxelBackBoneInverseRes": VoxelBackBoneInverseRes}
