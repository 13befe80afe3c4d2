"""YAML configuration: attribute dicts, `_BASE_CONFIG_` inheritance, the
flagship config, its det-only variant and its occ-code variants, and the
3-class config.

Own copy of the config layer of `btcdet_tpu/config.py`, so the reference
YAML files under `tools/cfgs/` load unchanged.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path

import yaml


class EasyDict(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EasyDict):
            return EasyDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EasyDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EasyDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        del self[k]

    def get(self, k, default=None):
        return super().get(k, default)

    def __deepcopy__(self, memo):
        return EasyDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def merge_new_config(config: EasyDict, new_config: dict, base_dir: Path | None = None) -> EasyDict:
    """Recursively merge `new_config` into `config`, resolving
    `_BASE_CONFIG_` first (relative to `base_dir` and its parents, then
    the working directory)."""
    if "_BASE_CONFIG_" in new_config:
        base_rel = new_config["_BASE_CONFIG_"]
        candidates = []
        if base_dir is not None:
            candidates.append(Path(base_dir) / base_rel)
            candidates.append(Path(base_dir).parent / base_rel)
            candidates.append(Path(base_dir).parent.parent / base_rel)
        candidates.append(Path(base_rel))
        for cand in candidates:
            if cand.exists():
                with open(cand) as f:
                    base_cfg = yaml.safe_load(f)
                merge_new_config(config, base_cfg, base_dir=cand.parent)
                break
        else:
            raise FileNotFoundError(f"_BASE_CONFIG_ {base_rel} not found (tried {candidates})")

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), dict):
                config[key] = EasyDict()
            merge_new_config(config[key], val, base_dir=base_dir)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config: EasyDict | None = None) -> EasyDict:
    config = config if config is not None else EasyDict()
    cfg_file = Path(cfg_file)
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config, new_config, base_dir=cfg_file.parent)
    return config


def cfg_from_list(cfg_list, config: EasyDict) -> EasyDict:
    """Set config keys from a flat list of dotted-path / value pairs, e.g.
    ['MODEL.ROI_HEAD.APPROX_QUERY', 'False'] (reference `config.py:16-48`).
    Values are Python literals where they parse; a "k1:v1,k2:v2" string
    updates a dict entry."""
    if len(cfg_list) % 2:
        raise ValueError(f"override list must be key / value pairs: {cfg_list}")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        keys = full_key.split(".")
        d = config
        for subkey in keys[:-1]:
            if subkey not in d:
                d[subkey] = EasyDict()
            d = d[subkey]
        subkey = keys[-1]
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        old = d.get(subkey)
        if isinstance(old, dict) and isinstance(value, str):
            kv = {}
            for pair in value.split(","):
                k2, v2 = pair.split(":")
                try:
                    kv[k2.strip()] = ast.literal_eval(v2.strip())
                except (ValueError, SyntaxError):
                    kv[k2.strip()] = v2.strip()
            old.update(kv)
            continue
        if isinstance(old, float) and isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        elif isinstance(old, list) and isinstance(value, tuple):
            value = list(value)
        d[subkey] = value
    return config


def det_only(cfg):
    """The det-only variant of a full BtcDet config (returns a copy).

    Drops the occupancy subnet and everything that feeds it, keeping the
    detector at the config's own widths and capacities:
      - DATA_CONFIG.OCC, the sphere-voxel processor and MODEL.OCC go;
      - MODEL.VFE becomes MeanVFE, the backbone's occ side branch is off;
      - ConvHead pools `x_combine` and the raw points only;
      - ball queries use the exact first-in-point-order selection.
    Works on any attribute-dict config tree (this package's or another
    loader's)."""
    cfg = copy.deepcopy(cfg)
    data = cfg["DATA_CONFIG"]
    if "OCC" in data:
        del data["OCC"]
    data["DATA_PROCESSOR"] = [
        p for p in data["DATA_PROCESSOR"]
        if p["NAME"] != "transform_points_to_sphere_voxels"
    ]
    model = cfg["MODEL"]
    if "OCC" in model:
        del model["OCC"]
    model["VFE"]["NAME"] = "MeanVFE"
    model["BACKBONE_3D"]["OCC_CONV_TYPE"] = []
    model["BACKBONE_3D"]["OCC_CONV_EXECUTE"] = []
    rh = model["ROI_HEAD"]
    rh["CONV_GRID_POOL"]["FEATURES_SOURCE"] = ["x_combine", "raw_points"]
    rh["APPROX_QUERY"] = False
    return cfg


REPO_ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP_CFG = REPO_ROOT / "tools" / "cfgs" / "model_configs" / "btcdet_kitti_car.yaml"


def flagship() -> EasyDict:
    """The flagship `btcdet_kitti_car.yaml`, occupancy subnet included, with
    ConvHead's ball queries set to the exact first-in-point-order query of
    the reference (`ROI_HEAD.APPROX_QUERY` False; the yaml leaves it unset,
    which selects the roi-grouped approximate query: `flagship_shipped`)."""
    cfg = cfg_from_yaml_file(FLAGSHIP_CFG)
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    return cfg


def flagship_shipped() -> EasyDict:
    """The flagship `btcdet_kitti_car.yaml` untouched: ROI_HEAD.APPROX_QUERY
    unset, so ConvHead runs the roi-grouped approximate ball query. This is
    what `bench.py` (the JAX package's timed eval forward and train step)
    and the JAX package's `tools/test.py` / `tools/train.py` run."""
    return cfg_from_yaml_file(FLAGSHIP_CFG)


FAST20K_CFG = REPO_ROOT / "tools" / "cfgs" / "model_configs" / "btcdet_kitti_car_fast20k.yaml"


def fast20k() -> EasyDict:
    """`btcdet_kitti_car_fast20k.yaml` as shipped: the flagship yaml (its
    `_BASE_CONFIG_`) with the eval voxel caps at 20 000 instead of 40 000,
    the approximate ball query left on."""
    return cfg_from_yaml_file(FAST20K_CFG)


THREE_CLASS_CFG = REPO_ROOT / "tools" / "cfgs" / "model_configs" / "btcdet_kitti_3classes.yaml"


def three_class() -> EasyDict:
    """The 3-class `btcdet_kitti_3classes.yaml` (Car, Pedestrian, Cyclist:
    the flagship with per-class anchors) with the exact ball query, as
    `flagship()`."""
    cfg = cfg_from_yaml_file(THREE_CLASS_CFG)
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    return cfg


def flagship_det_only() -> EasyDict:
    """`det_only` of the flagship `btcdet_kitti_car.yaml`."""
    return det_only(cfg_from_yaml_file(FLAGSHIP_CFG))


OCC_VARIANT_DOWNSAMPLERS = ("fix", "avgpool", "weight", "maxpool")


def set_occ_variant(backbone_cfg, down: str):
    """Set a det `BACKBONE_3D` config (in place) to the occ-code variant
    with downsampler `down` (fix, avgpool, weight or maxpool): the occ code
    downsampled by `down` to every level and concatenated into the trunk at
    every level, with the attention blocks at levels 0 and 1:
      OCC_CONV_TYPE    ['identity', down, down, down]
      OCC_CONV_EXECUTE [True, True, True, True]
      OCC_ATT          [True, True, False, False]
    No shipped yaml sets these; the reference constructs these blocks in
    `build_occ_{fix,avgpool,weight,maxpool}_net` and `apply_att`
    (`spconv_backbone.py:793-876`), and `tests/test_backbone_variants.py`
    runs the same settings."""
    if down not in OCC_VARIANT_DOWNSAMPLERS:
        raise ValueError(f"occ-code downsampler {down!r}: one of {OCC_VARIANT_DOWNSAMPLERS}")
    backbone_cfg["OCC_CONV_TYPE"] = ["identity", down, down, down]
    backbone_cfg["OCC_CONV_EXECUTE"] = [True, True, True, True]
    backbone_cfg["OCC_ATT"] = [True, True, False, False]
    return backbone_cfg


def flagship_occ_variant(down: str) -> EasyDict:
    """`flagship()` (widths 16/32/64/64/128, test and train caps, the
    occupancy subnet, ConvHead, exact ball queries) with the det backbone's
    occ-code variant `down` (`set_occ_variant`)."""
    cfg = flagship()
    set_occ_variant(cfg.MODEL.BACKBONE_3D, down)
    return cfg
