"""Scaled-down BtcDet configs (own copy of `btcdet_tpu/datasets/mini_config.py`).

Same schema and stride chain as the flagship `btcdet_kitti_car.yaml`
(z grid 41 voxels + the backbone's +1 pad = 42 -> 21 -> 11 -> 5 -> 2) on a
16 m (mini) or 6.4 m (micro) scene with narrow channels, for small
checks of the port: the card-vs-CPU checks of `chip_smoke.py`. `occ_down`
builds the det backbone's occ-code variants.
"""

from __future__ import annotations

from ..config import EasyDict, set_occ_variant


def mini_data_cfg(with_occ: bool = False) -> EasyDict:
    d = EasyDict({
        "POINT_CLOUD_RANGE": [0, -8.0, -3.0, 16.0, 8.0, 1.1],
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity"],
            "src_feature_list": ["x", "y", "z", "intensity"],
        },
        "DATA_PROCESSOR": [
            {"NAME": "det_transform_points_to_voxels",
             "VOXEL_SIZE": [0.1, 0.1, 0.1],
             "MAX_POINTS_PER_VOXEL": 5,
             "MAX_NUMBER_OF_VOXELS": {"train": 4000, "test": 4000}},
        ],
    })
    if with_occ:
        d["OCC"] = {
            "VOXEL_SIZE": [0.5, 2.0, 0.45],
            "DIST_KERN": [5, 9, 5],
            "HALF_X": True,
            "EMPT_SUR_THRESH": 1,
            "POINT_CLOUD_RANGE": [2.0, -40.0, -2.6, 16.0, 40.0, 1.0],
            "SUPPORT_SPHERE_RANGE": [2.0, -40.0, -16.6, 16.5, 40.0, 4.0, 2.0],
            "BOX_WEIGHT": 0.2,
            "RES_NUM_DIM": 3,
            "CODE_NUM_DIM": 2,
            "INTEN": 0.0,
            "DROPOUT_RATE": 0.0,
            "COORD_TYPE": "cylinder",
            "USE_ABSXYZ": True,
            "MAX_VFE": True,
            "USEOCC_PERCENTAGE": 1.1,
        }
        d["DATA_PROCESSOR"].insert(0, EasyDict({
            "NAME": "transform_points_to_sphere_voxels",
            "VOXEL_SIZE": [0.5, 2.0, 0.45],
            "MAX_POINTS_PER_VOXEL": 8,
            "MAX_NUMBER_OF_VOXELS": {"train": 3000, "test": 3000},
        }))
    return d


def mini_model_cfg(with_occ: bool = False, with_roi: bool = True,
                   occ_down: str | None = None) -> EasyDict:
    """`occ_down` (fix, avgpool, weight or maxpool; needs `with_occ`) sets
    the det backbone's occ-code variant (`config.set_occ_variant`: the code
    downsampled by `occ_down` and concatenated at every level, OCC_ATT at
    levels 0 and 1)."""
    m = EasyDict({
        "NAME": "BtcNet",
        "VFE": {"NAME": "OccVFE" if with_occ else "MeanVFE"},
        "BACKBONE_3D": {
            "NAME": "VoxelBackBone8xOcc",
            "OCC_CONV_TYPE": ["identity", "maxpool"] if with_occ else [],
            "OCC_CONV_EXECUTE": [False, True] if with_occ else [],
            "OUT_FEAT_TYPE": ["None", "None", "None", "None", "big_bev_combine"],
        },
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
            "NUM_FILTERS": [32, 32], "UPSAMPLE_STRIDES": [1, 2],
            "NUM_UPSAMPLE_FILTERS": [32, 32],
        },
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle",
            "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True,
            "DIR_OFFSET": 0.78539, "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [{
                "class_name": "Car",
                "anchor_sizes": [[3.9, 1.6, 1.56]],
                "anchor_rotations": [0, 1.57],
                "anchor_bottom_heights": [-1.78],
                "align_center": False,
                "feature_map_stride": 8,
                "matched_threshold": 0.6,
                "unmatched_threshold": 0.45,
            }],
            "TARGET_ASSIGNER_CONFIG": {
                "NAME": "AxisAlignedTargetAssigner",
                "POS_FRACTION": -1.0, "SAMPLE_SIZE": 512,
                "NORM_BY_NUM_EXAMPLES": False, "MATCH_HEIGHT": False,
                "BOX_CODER": "ResidualCoder",
            },
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                "code_weights": [1.0] * 7,
            }},
        },
        "POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
            "SCORE_THRESH": 0.1, "OUTPUT_RAW_SCORE": False,
            "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {
                "MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 256, "NMS_POST_MAXSIZE": 32,
            },
        },
    })
    if with_roi:
        m["ROI_HEAD"] = {
            "NAME": "ConvHead", "CLASS_AGNOSTIC": True,
            "SHARED_FC": [64, 64], "CLS_FC": [32], "REG_FC": [32],
            "DP_RATIO": 0.3,
            "NMS_CONFIG": {
                "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                          "NMS_PRE_MAXSIZE": 256, "NMS_POST_MAXSIZE": 64,
                          "NMS_THRESH": 0.8},
                "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                         "NMS_PRE_MAXSIZE": 256, "NMS_POST_MAXSIZE": 16,
                         "NMS_THRESH": 0.7},
            },
            "CONV_GRID_POOL": {
                "POOL_METHOD": "max_pool", "GRID_SIZE": [2, 2, 2],
                "DIM_TIMES": 1.0, "POINT_ROT": True, "INTRP_NORM": False,
                "FEATURES_SOURCE": ["x_combine", "raw_points"] + (
                    ["occ_points"] if with_occ else []),
                "CONV_LAYER": {
                    "occ_points": {"MLPS": [[8, 8]], "POOL_RADIUS": [1.2],
                                   "NSAMPLE": [8]},
                    "raw_points": {"MLPS": [[8, 8], [8, 8]],
                                   "POOL_RADIUS": [0.4, 1.2], "NSAMPLE": [8, 8]},
                    "x_combine": {
                        "SCENE_TIMES": 1.0, "DOWNSAMPLE_FACTOR": [8, 8, 8],
                        "PART_SCENE_SIZE": [-0.8, -0.8, -2.4, 0.8, 0.8, 2.4],
                        "KER_SIZE": [0.8, 0.4, 0.4],
                        "KERNEL": [[3, 3, 3], [3, 3, 3], [2, 2, 3]],
                        "PADDING": [[1, 1, 1], [1, 1, 1], [0, 0, 0]],
                        "STRIDE": [[1, 1, 2], [1, 2, 2], [2, 2, 3]],
                        "CHANNEL": [32, 32, 32, 32],
                    },
                },
            },
            "TARGET_CONFIG": {
                "BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 32, "FG_RATIO": 0.5,
                "SAMPLE_ROI_BY_EACH_CLASS": True, "CLS_SCORE_TYPE": "roi_iou",
                "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25,
                "CLS_BG_THRESH_LO": 0.1, "HARD_BG_RATIO": 0.8,
                "REG_FG_THRESH": 0.55,
            },
            "LOSS_CONFIG": {
                "CLS_LOSS": "BinaryCrossEntropy", "REG_LOSS": "smooth-l1",
                "CORNER_LOSS_REGULARIZATION": True,
                "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                                 "rcnn_corner_weight": 1.0,
                                 "code_weights": [1.0] * 7},
            },
        }
    if with_occ:
        m["OCC"] = {
            "PARAMS": {
                "OCC_THRESH": 0.3, "EVAL_OCC_THRESH": 0.57,
                "MAX_NUM_OCC_PNTS": 256, "EVAL_MAX_NUM_OCC_PNTS": 512,
                "CLASS_AGNOSTIC": True, "REG": True,
            },
            "TARGETS": {"NAME": "OccTargets3D", "TMPLT": True},
            "VFE": {"NAME": "MeanVFE"},
            "BACKBONE_3D": {"STRIDE": 1, "NAME": "VoxelBackBoneDeconv"},
            "OCC_DENSE_HEAD": {
                "NAME": "OccHead3D", "CLASS_AGNOSTIC": True,
                "LOSS_CONFIG": {
                    "CLS_LOSS_TYPE": "softmax",
                    "LOSS_WEIGHTS": {
                        "occ_fore_cls_weight": 1.0, "occ_mirr_cls_weight": 1.0,
                        "occ_bm_cls_weight": 1.0, "occ_neg_cls_weight": 1.0,
                        "occ_fore_res_weight": 0.1, "occ_mirr_res_weight": 0.0,
                        "occ_bm_res_weight": 0.0, "res_beta": 0.025,
                        "cls_alpha": 0.5,
                        "fore_dropout_cls_weight": 1.0,
                        "fore_dropout_reg_weight": 1.0,
                    },
                },
            },
            "OCC_PNT_UPDATE": {"NAME": "PassOccVox", "PASS_GRAD": False},
            "OCC_POST_PROCESSING": None,
        }
    if occ_down is not None:
        if not with_occ:
            raise ValueError("an occ-code variant needs the occupancy subnet (with_occ)")
        set_occ_variant(m["BACKBONE_3D"], occ_down)
    return m


def micro_data_cfg(with_occ: bool = True) -> EasyDict:
    """Micro-scale config: the flagship's module topology and stride chain
    with every grid, capacity and channel count cut to the bone."""
    d = mini_data_cfg(with_occ=with_occ)
    # 6.4 m x 6.4 m scene -> 32 x 32 x 41 det grid (z chain 41->21->11->5->2)
    d["POINT_CLOUD_RANGE"] = [0.0, -3.2, -3.0, 6.4, 3.2, 1.1]
    d["DATA_PROCESSOR"][-1]["VOXEL_SIZE"] = [0.2, 0.2, 0.1]
    d["DATA_PROCESSOR"][-1]["MAX_NUMBER_OF_VOXELS"] = {"train": 768, "test": 768}
    if with_occ:
        # cylinder occ grid 9 x 20 x 8
        d["OCC"]["POINT_CLOUD_RANGE"] = [2.0, -40.0, -2.6, 6.5, 40.0, 1.0]
        d["OCC"]["VOXEL_SIZE"] = [0.5, 4.0, 0.45]
        d["OCC"]["SUPPORT_SPHERE_RANGE"] = [2.0, -40.0, -16.6, 6.5, 40.0, 4.0, 2.0]
        d["OCC"]["DIST_KERN"] = [3, 5, 3]
        sph = d["DATA_PROCESSOR"][0]
        assert sph["NAME"] == "transform_points_to_sphere_voxels"
        sph["VOXEL_SIZE"] = [0.5, 4.0, 0.45]
        sph["MAX_NUMBER_OF_VOXELS"] = {"train": 512, "test": 512}
    return d


def micro_model_cfg(with_occ: bool = True, with_roi: bool = True,
                    occ_down: str | None = None) -> EasyDict:
    m = mini_model_cfg(with_occ=with_occ, with_roi=with_roi, occ_down=occ_down)
    m["BACKBONE_3D"]["CHANNELS"] = [8, 8, 8, 8, 8]
    m["BACKBONE_2D"].update({
        "LAYER_NUMS": [1, 1], "NUM_FILTERS": [8, 8],
        "NUM_UPSAMPLE_FILTERS": [8, 8],
    })
    # MAP_TO_BEV features = nz_out(2) * ch4(8)
    m["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 16
    m["POST_PROCESSING"]["NMS_CONFIG"].update(
        {"NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 8})
    if with_roi:
        rh = m["ROI_HEAD"]
        rh["SHARED_FC"] = [16, 16]
        rh["CLS_FC"] = [16]
        rh["REG_FC"] = [16]
        rh["NMS_CONFIG"]["TRAIN"].update(
            {"NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16})
        rh["NMS_CONFIG"]["TEST"].update(
            {"NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 8})
        rh["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 8
        cl = rh["CONV_GRID_POOL"]["CONV_LAYER"]
        cl["raw_points"].update({"MLPS": [[4, 4]], "POOL_RADIUS": [0.8],
                                 "NSAMPLE": [4]})
        cl["occ_points"].update({"MLPS": [[4, 4]], "POOL_RADIUS": [1.2],
                                 "NSAMPLE": [4]})
        cl["x_combine"]["CHANNEL"] = [8, 8, 8, 8]
    if with_occ:
        m["OCC"]["BACKBONE_3D"]["CHANNELS"] = [8, 8, 8]
        m["OCC"]["PARAMS"]["MAX_NUM_OCC_PNTS"] = 64
        m["OCC"]["PARAMS"]["EVAL_MAX_NUM_OCC_PNTS"] = 128
    return m


def mini_opt_cfg(lr: float = 0.003) -> EasyDict:
    return EasyDict({
        "BATCH_SIZE_PER_GPU": 2, "NUM_EPOCHS": 2,
        "OPTIMIZER": "adam_onecycle", "LR": lr, "WEIGHT_DECAY": 0.01,
        "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.4,
        "DIV_FACTOR": 10, "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1,
        "LR_CLIP": 0.0000001, "LR_WARMUP": False, "WARMUP_EPOCH": 1,
        "GRAD_NORM_CLIP": 10,
    })
