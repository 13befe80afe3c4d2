"""Weights carried across from the JAX package, and deterministic
synthetic weights by name.

`from_jax_variables` turns the JAX model's variables ({'params',
'batch_stats'} trees of numpy arrays) into this port's state dict, whose
keys are the reference BtcDet names (`det_modules.backbone_3d.conv1.0.weight`,
`occ_modules.backbone_3d.deconv4.0.0.weight`, ...). It inverts the JAX
package's reference import (`btcdet_tpu/train/ref_import.py`): own
inverted copies of its layout transforms live below.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

# ours (flax module) -> (reference name, block index or None when plain)
_DET3D = {
    "conv1": ("conv1", None), "conv_out": ("conv_out", None),
    "conv1_combine": ("conv1_combine", 0), "conv2": ("conv2", 0),
    "conv2_combine_0": ("conv2_combine", 0), "conv2_combine_1": ("conv2_combine", 1),
    "conv3": ("conv3", 0), "conv3_combine_0": ("conv3_combine", 0),
    "conv3_combine_1": ("conv3_combine", 1), "conv4": ("conv4", 0),
    "conv4_combine_0": ("conv4_combine", 0), "conv4_combine_1": ("conv4_combine", 1),
    "down2_0": ("down2", 0), "down2_1": ("down2", 1), "down3": ("down3", 0),
    "down_combine_0": ("down_combine", 0), "down_combine_1": ("down_combine", 1),
    "down_combine_2": ("down_combine", 2), "squeezeBev": ("squeezeBev", 0),
    # OCC_ATT blocks (conv + BN) and the `weight` occ-code downsamplers (a
    # bare conv, no BN)
    "att_conv1": ("att_conv1", 0), "att_conv2": ("att_conv2", 0),
    "occ_conv2": ("occ_conv2", 0), "occ_conv3": ("occ_conv3", 0), "occ_conv4": ("occ_conv4", 0),
}
_DET3D_KERNEL = {"conv_out": (3, 1, 1), "squeezeBev": (2, 1, 1)}
# VoxelResBackBone8x: ours -> (reference block, None for a conv + BN block,
# else the conv / bn index inside the reference's SparseBasicBlock)
_RES3D = {"conv_input": ("conv_input", None), "conv_out": ("conv_out", None),
          "conv1_0": ("conv1.0", 1), "conv1_1": ("conv1.0", 2),
          **{f"conv{lv}": (f"conv{lv}.0", None) for lv in (2, 3, 4)},
          **{f"conv{lv}b_{j}": (f"conv{lv}.1", j + 1) for lv in (2, 3, 4) for j in (0, 1)}}
# the sparse conv a JAX SparseConvBlock holds, by its conv_type
_SPARSE_CONVS = ("SubMConv3d_0", "SparseConv3d_0", "SparseConvTranspose3d_0",
                 "SparseInverseConv3d_0")
# occ backbone: ours -> (reference block, sub-block); deconv*_0 and inv* are
# transpose convs. The residual backbones' blocks (res1-5, each two blocks
# conv1 / conv2) and their 1x1 lateral conv lat1 keep the JAX package's
# names: the reference's sparse residual backbones have no lat1.
_OCC3D = {"conv1": ("conv1", 0), "conv2_0": ("conv2", 0), "conv2_1": ("conv2", 1),
          "conv3_0": ("conv3", 0), "conv3_1": ("conv3", 1), "deconv4_0": ("deconv4", 0),
          "deconv4_1": ("deconv4", 1), "deconv5_0": ("deconv5", 0), "deconv5_1": ("deconv5", 1),
          "inv4": ("inv4", 0), "inv5": ("inv5", 0)}


def synth_tensor(name: str, shape) -> np.ndarray:
    """Deterministic tensor for a reference state-dict name (seeded by the
    name's crc32): BN statistics and affines perturbed away from identity,
    conv / linear weights fan-in scaled. Same values as the JAX package's
    `train/golden_synth.synth_tensor`."""
    rs = np.random.RandomState(zlib.crc32(name.encode()) & 0xFFFFFFFF)
    shape = tuple(int(s) for s in shape)
    if name.endswith("num_batches_tracked"):
        return np.zeros(shape, np.int64)
    if name.endswith("running_var"):
        return rs.uniform(0.5, 1.5, shape).astype(np.float32)
    if name.endswith("running_mean"):
        return rs.normal(0.0, 0.3, shape).astype(np.float32)
    if len(shape) <= 1:
        if name.endswith(".weight"):  # BN gamma
            return rs.normal(1.0, 0.2, shape).astype(np.float32)
        return rs.normal(0.0, 0.05, shape).astype(np.float32)
    co = shape[-1] if len(shape) == 5 else shape[0]
    fan_in = int(np.prod(shape)) // co
    return rs.normal(0.0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)


def synth_state_dict(model: torch.nn.Module) -> dict:
    """`synth_tensor` for every entry of `model.state_dict()`."""
    return {k: torch.from_numpy(synth_tensor(k, v.shape)) for k, v in model.state_dict().items()}


# ------------------------------------------------- inverted layout transforms

def inv_sparse3d(w, kernel):
    """engine (K, ci, co), K row-major (dz, dy, dx) -> spconv (kz, ky, kx, ci, co)."""
    w = np.asarray(w)
    return w.reshape(*kernel, w.shape[-2], w.shape[-1])


def inv_deconv3d(w):
    """flax ConvTranspose (kz, ky, kx, ci, co), spatially flipped -> spconv
    deconv (kz, ky, kx, ci, co)."""
    return np.asarray(w)[::-1, ::-1, ::-1].copy()


def inv_conv2d(w):
    """flax (kh, kw, ci, co) -> torch Conv2d (co, ci, kh, kw)."""
    return np.asarray(w).transpose(3, 2, 0, 1)


def inv_conv2d_bev_first(w, bev_channels: int):
    """First BEV conv: our input axis is z-major (d*C + c), the reference's
    C-major (c*D + d)."""
    w = inv_conv2d(w)
    co, cd, kh, kw = w.shape
    D = cd // bev_channels
    if D > 1 and D * bev_channels == cd:
        w = w.reshape(co, D, bev_channels, kh, kw).transpose(0, 2, 1, 3, 4).reshape(co, cd, kh, kw)
    return w


def inv_convT2d(w):
    """flax ConvTranspose (kh, kw, ci, co), spatially flipped -> torch
    ConvTranspose2d (ci, co, kh, kw)."""
    return np.asarray(w)[::-1, ::-1].transpose(2, 3, 0, 1).copy()


def inv_fc(w, ndim: int = 3):
    """flax Dense (ci, co) -> torch Conv1d (co, ci, 1) / Conv2d (co, ci, 1, 1)."""
    w = np.asarray(w).T
    return w.reshape(w.shape + (1,) * (ndim - 2))


def inv_fc_pooled(w, grid_num: int):
    """First rcnn FC: our rows are grid-major (g*C + c), the reference's
    columns C-major (c*G + g)."""
    w = np.asarray(w).T                                   # (co, G*C)
    co, cin = w.shape
    C = cin // grid_num
    return w.reshape(co, grid_num, C).transpose(0, 2, 1).reshape(co, cin)[..., None]


# ----------------------------------------------------------------- mapping

def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = p["scale"]
    sd[f"{name}.bias"] = p["bias"]
    sd[f"{name}.running_mean"] = s["mean"]
    sd[f"{name}.running_var"] = s["var"]
    sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)


def _sorted_children(tree, prefix):
    """Keys `<prefix><int>` of a tree, in numeric order."""
    return sorted((k for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit()),
                  key=lambda k: int(k[len(prefix):]))


def _infer_layer_nums(p2d):
    """BEV block depths from the flax Conv_k sequence: each block's 3x3
    convs end at its 1x1 (stride-1) upsample conv; the last block's
    upsample is the ConvTranspose."""
    nums, run = [], 0
    for k in _sorted_children(p2d, "Conv_"):
        if p2d[k]["kernel"].shape[:2] == (1, 1):
            nums.append(run - 1)
            run = 0
        else:
            run += 1
    if run:
        nums.append(run - 1)
    return nums


def _trunk_index(i: int, dp: bool, dropout_after) -> int:
    """Sequential index of hidden layer i in a reference FC trunk."""
    return sum(3 + (1 if dp and dropout_after(j) else 0) for j in range(i))


def _dense_block(sd, base, p, s):
    """A JAX `_DenseSparseBlock` (conv or transpose conv + masked BN) ->
    `{base}.0.weight` (spconv layout) and the BN under `{base}.1`."""
    if "ConvTranspose_0" in p:
        sd[f"{base}.0.weight"] = inv_deconv3d(p["ConvTranspose_0"]["kernel"])
    else:
        sd[f"{base}.0.weight"] = np.asarray(p["Conv_0"]["kernel"])
    _bn(sd, f"{base}.1", p["_DenseBN_0"]["MaskedBatchNorm_0"], s["_DenseBN_0"]["MaskedBatchNorm_0"])


def _occ_head_weight(w):
    """OccHead3D's kernel stays in the spconv layout; OccHead2D's flax
    (3, 3, ci, co) becomes torch Conv2d (co, ci, 3, 3)."""
    w = np.asarray(w)
    return w if w.ndim == 5 else inv_conv2d(w)


def occ_subnet_state(params: dict, batch_stats: dict, prefix: str = "occ_modules.") -> dict:
    """The JAX `OccSubnet`'s `params` / `batch_stats` trees (BtcNet's
    `occ_subnet` subtrees) -> the port's `OccSubnet` state dict under
    `prefix` (`backbone_3d.*`, `occ_dense_head.*`), numpy arrays."""
    sd: dict = {}
    pb, sb = params["backbone_3d"], batch_stats["backbone_3d"]
    bb = f"{prefix}backbone_3d"
    for ours, sub in pb.items():
        if ours == "lat1":
            sd[f"{bb}.lat1.weight"] = np.asarray(sub["kernel"])
        elif ours.startswith("res"):
            for blk in ("conv1", "conv2"):
                _dense_block(sd, f"{bb}.{ours}.{blk}", sub[blk], sb[ours][blk])
        else:
            ref, i = _OCC3D[ours]
            _dense_block(sd, f"{bb}.{ref}.{i}", sub, sb[ours])
    head = f"{prefix}occ_dense_head"
    sd[f"{head}.conv_cls.0.weight"] = _occ_head_weight(params["conv_cls"]["kernel"])
    sd[f"{head}.conv_cls.0.bias"] = params["conv_cls"]["bias"]
    if "conv_res" in params:
        sd[f"{head}.conv_res.0.weight"] = _occ_head_weight(params["conv_res"]["kernel"])
    return sd


def _sparse_kernel(block: dict, kernel) -> np.ndarray:
    """The spconv-layout kernel of a JAX SparseConvBlock's conv, whichever
    of subm, strided, transpose or inverse it is."""
    (name,) = [k for k in _SPARSE_CONVS if k in block]
    return inv_sparse3d(block[name]["kernel"], kernel)


def sparse_block_state(params: dict, batch_stats: dict, prefix: str, kernel=(3, 3, 3)) -> dict:
    """One JAX `SparseConvBlock` (any conv type: subm, spconv, spdeconv,
    inverseconv) -> the port's block state: `{prefix}0.weight`
    (kz, ky, kx, Cin, Cout) and the BN under `{prefix}1` when the block has
    one. numpy arrays."""
    sd = {f"{prefix}0.weight": _sparse_kernel(params, kernel)}
    if "MaskedBatchNorm_0" in params:
        _bn(sd, f"{prefix}1", params["MaskedBatchNorm_0"], batch_stats["MaskedBatchNorm_0"])
    return sd


def res_backbone_3d_state(params: dict, batch_stats: dict, prefix: str = "") -> dict:
    """The JAX `VoxelResBackBone8x`'s `params` / `batch_stats` trees -> the
    port's `VoxelResBackBone8x` state dict under `prefix` (the reference's
    names: `conv_input.0.weight`, `conv2.0.1.running_mean`, the residual
    pairs as `conv{l}.{i}.conv1` / `bn1` / `conv2` / `bn2`), numpy arrays."""
    sd: dict = {}
    for ours, sub in params.items():
        ref, i = _RES3D[ours]
        kernel = (3, 1, 1) if ours == "conv_out" else (3, 3, 3)
        if i is None:
            sd.update(sparse_block_state(sub, batch_stats[ours], f"{prefix}{ref}.", kernel))
            continue
        sd[f"{prefix}{ref}.conv{i}.weight"] = _sparse_kernel(sub, kernel)
        _bn(sd, f"{prefix}{ref}.bn{i}", sub["MaskedBatchNorm_0"],
            batch_stats[ours]["MaskedBatchNorm_0"])
    return sd


def _sa_state(sd: dict, prefix: str, params: dict, batch_stats: dict) -> int:
    """A JAX `PointSAModuleMSG`'s GroupMLPs -> `{prefix}mlps.{i}.{3k}.weight`
    (Conv2d) and `{prefix}mlps.{i}.{3k + 1}` (BN); returns the module's
    output width (the last widths of its MLPs, summed)."""
    width = 0
    for mlp in _sorted_children(params, "mlp_"):
        i = int(mlp[4:])
        pm, sm = params[mlp], batch_stats[mlp]
        dense = _sorted_children(pm, "Dense_")
        for d in dense:
            k = int(d[6:])
            sd[f"{prefix}mlps.{i}.{3 * k}.weight"] = inv_fc(pm[d]["kernel"], 4)
            _bn(sd, f"{prefix}mlps.{i}.{3 * k + 1}", pm[f"MaskedBatchNorm_{k}"],
                sm[f"MaskedBatchNorm_{k}"])
        width += pm[dense[-1]]["kernel"].shape[-1]
    return width


def sa_module_state(params: dict, batch_stats: dict, prefix: str = "") -> dict:
    """One JAX `PointSAModuleMSG` -> the port's `PointSAModuleMSG` state
    under `prefix` (`mlps.{i}.{3k}.weight`, `mlps.{i}.{3k + 1}.*`)."""
    sd: dict = {}
    _sa_state(sd, prefix, params, batch_stats)
    return sd


def pfe_state(params: dict, batch_stats: dict, features_source, prefix: str = "") -> dict:
    """The JAX `VoxelSetAbstraction`'s `params` / `batch_stats` trees ->
    the port's state dict under `prefix`: `sa_raw` -> `SA_rawpoints`, each
    `sa_{level}` -> `SA_layers.{j}` (j the level's place among the sparse
    levels of `features_source`), the final Dense ->
    `vsa_point_feature_fusion.0.weight`. numpy arrays."""
    sd: dict = {}
    if "sa_raw" in params:
        _sa_state(sd, f"{prefix}SA_rawpoints.", params["sa_raw"], batch_stats["sa_raw"])
    levels = [n for n in features_source if n not in ("bev", "raw_points")]
    for j, name in enumerate(levels):
        _sa_state(sd, f"{prefix}SA_layers.{j}.", params[f"sa_{name}"], batch_stats[f"sa_{name}"])
    sd[f"{prefix}vsa_point_feature_fusion.0.weight"] = np.asarray(params["Dense_0"]["kernel"]).T
    return sd


def det_backbone_3d_state(params: dict, batch_stats: dict, prefix: str = "") -> dict:
    """The JAX det backbone's `params` / `batch_stats` trees (a
    `VoxelBackBone8xOcc`'s, the `det_backbone_3d` subtrees of BtcNet) ->
    the port's backbone state dict under `prefix`, numpy arrays. Blocks
    without a norm (the `weight` occ-code convs) have no BN entries."""
    sd: dict = {}
    for ours, sub in params.items():
        ref, blk = _DET3D[ours]
        base = f"{prefix}{ref}" + ("" if blk is None else f".{blk}")
        sd.update(sparse_block_state(sub, batch_stats.get(ours, {}), f"{base}.",
                                     _DET3D_KERNEL.get(ours, (3, 3, 3))))
    return sd


def from_jax_variables(variables_np: dict, *, upsample_strides, dp_ratio: float = 0.3,
                       layer_nums=None) -> dict:
    """JAX BtcNet variables -> this port's state dict (reference names,
    `occ_modules.` / `det_modules.` prefixes, torch tensors).

    `dp_ratio` is ROI_HEAD.DP_RATIO (dropout layers shift the reference
    FC indices); `layer_nums` is BACKBONE_2D.LAYER_NUMS, inferred from the
    variables when omitted; `upsample_strides` is BACKBONE_2D.UPSAMPLE_STRIDES,
    required: a fractional one's deblock is a Conv2d, the others are
    ConvTranspose2d, and the JAX names (`Conv_{k}` for s == 1 and s < 1)
    cannot tell them apart. The parameter sets follow the config: no x_combine
    branch under OUT_FEAT_TYPE `None`, `combine`'s strided down_combine,
    per-class dense-head widths."""
    P, S = variables_np["params"], variables_np.get("batch_stats", {})
    sd: dict = {}
    pre = "det_modules."
    if "occ_subnet" in P:
        sd.update(occ_subnet_state(P["occ_subnet"], S["occ_subnet"]))

    p3, s3 = P["det_backbone_3d"], S["det_backbone_3d"]
    sd.update(det_backbone_3d_state(p3, s3, f"{pre}backbone_3d."))
    bev_channels = p3["conv_out"]["SparseConv3d_0"]["kernel"].shape[-1]

    p2, s2 = P["det_backbone_2d"], S["det_backbone_2d"]
    nums = list(layer_nums) if layer_nums is not None else _infer_layer_nums(p2)
    n_transpose = 0
    for b, n in enumerate(nums):
        base_idx = sum(m + 1 for m in nums[:b]) + b
        for k in range(n + 1):
            w = p2[f"Conv_{base_idx + k}"]["kernel"]
            sd[f"{pre}backbone_2d.blocks.{b}.{1 + 3 * k}.weight"] = (
                inv_conv2d_bev_first(w, bev_channels) if b == 0 and k == 0 else inv_conv2d(w))
            bn = f"_BN_{base_idx + k}"
            _bn(sd, f"{pre}backbone_2d.blocks.{b}.{2 + 3 * k}", p2[bn]["BatchNorm_0"],
                s2[bn]["BatchNorm_0"])
        up = base_idx + n + 1
        if f"Conv_{up}" in p2:
            w = p2[f"Conv_{up}"]["kernel"]
        else:
            w = p2[f"ConvTranspose_{n_transpose}"]["kernel"]
            n_transpose += 1
        fractional = float(upsample_strides[b]) < 1
        sd[f"{pre}backbone_2d.deblocks.{b}.0.weight"] = (inv_conv2d(w) if fractional
                                                         else inv_convT2d(w))
        _bn(sd, f"{pre}backbone_2d.deblocks.{b}.1", p2[f"_BN_{up}"]["BatchNorm_0"],
            s2[f"_BN_{up}"]["BatchNorm_0"])

    ph = P["det_dense_head"]
    for ours, ref in (("Conv_0", "conv_cls"), ("Conv_1", "conv_box"), ("Conv_2", "conv_dir_cls")):
        if ours in ph:
            sd[f"{pre}dense_head.{ref}.weight"] = inv_conv2d(ph[ours]["kernel"])
            sd[f"{pre}dense_head.{ref}.bias"] = ph[ours]["bias"]

    pr, sr = P["det_roi_head"], S["det_roi_head"]
    rh = f"{pre}roi_head."
    c_pool = 0
    for sa in ("SA_rawpoints", "SA_occpoints"):
        if sa in pr:
            c_pool += _sa_state(sd, f"{rh}{sa}.", pr[sa], sr[sa])
    xcs = _sorted_children(pr, "xc_conv_")
    for x in xcs:
        j = int(x[8:])
        sd[f"{rh}conv_layers.0.{j}.0.weight"] = np.asarray(pr[x]["kernel"])
        _bn(sd, f"{rh}conv_layers.0.{j}.1", pr[f"xc_bn_{j}"]["MaskedBatchNorm_0"],
            sr[f"xc_bn_{j}"]["MaskedBatchNorm_0"])
    if xcs:
        c_pool += pr[xcs[-1]]["kernel"].shape[-1]

    dp = dp_ratio > 0
    shared = _sorted_children(pr, "shared_fc_")
    for name in shared:
        i = int(name[10:])
        idx = _trunk_index(i, dp, lambda j: j != len(shared) - 1)
        w = pr[name]["kernel"]
        sd[f"{rh}shared_fc_layer.{idx}.weight"] = (
            inv_fc_pooled(w, w.shape[0] // c_pool) if i == 0 else inv_fc(w))
        _bn(sd, f"{rh}shared_fc_layer.{idx + 1}", pr[f"shared_bn_{i}"]["MaskedBatchNorm_0"],
            sr[f"shared_bn_{i}"]["MaskedBatchNorm_0"])
    for head, ref in (("cls", "cls_layers"), ("reg", "reg_layers")):
        layers = _sorted_children(pr, f"{head}_")
        for name in layers:
            i = int(name[len(head) + 1:])
            idx = _trunk_index(i, dp, lambda j: j == 0)
            sd[f"{rh}{ref}.{idx}.weight"] = inv_fc(pr[name]["kernel"])
            _bn(sd, f"{rh}{ref}.{idx + 1}", pr[f"{head}_bn_{i}"]["MaskedBatchNorm_0"],
                sr[f"{head}_bn_{i}"]["MaskedBatchNorm_0"])
        final = _trunk_index(len(layers), dp, lambda j: j == 0)
        sd[f"{rh}{ref}.{final}.weight"] = inv_fc(pr[f"{head}_out"]["kernel"])
        sd[f"{rh}{ref}.{final}.bias"] = pr[f"{head}_out"]["bias"]

    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
