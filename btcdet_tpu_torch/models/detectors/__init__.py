from . import btcnet, pv_rcnn
from .btcnet import BtcNet, post_processing  # noqa: F401
from .pv_rcnn import PVRCNN  # noqa: F401

# the detector builders by MODEL.NAME
DETECTORS = {"BtcNet": btcnet.build_network, "PVRCNN": pv_rcnn.build_network}


def build_network(model_cfg, data_cfg, class_names, device=None, bev_sharding: bool = False):
    """The detector MODEL.NAME names (BtcNet where the config names none),
    in eval mode on `device` (CUDA unless the caller passes another); an
    unknown name raises KeyError."""
    name = model_cfg.get("NAME", "BtcNet")
    if name not in DETECTORS:
        raise KeyError(f"unknown MODEL.NAME {name!r}: one of {sorted(DETECTORS)}")
    return DETECTORS[name](model_cfg, data_cfg, class_names, device=device,
                           bev_sharding=bev_sharding)
