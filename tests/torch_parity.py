"""Shared helpers of the JAX-vs-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs; the JAX side runs on the CPU
in float32 (`BTCDET_F32=1`) with exact ball queries, as
tests/test_golden_full.py does.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

# f32 stage tensors: sums run in a different order in the two packages
RTOL = ATOL = 1e-4

# torch's intra-op threads in a test process. The suite runs several test
# processes at once on the machine's cores; at the parity tests' sizes
# more threads a process only spin against the other processes' work.
# Every tests/test_torch_*.py file that computes with torch imports this
# module, so the cap holds in each test process.
TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)


@contextlib.contextmanager
def f32_mode():
    """BTCDET_F32=1 for the duration (both packages read it at call time),
    restored afterwards so other tests in the worker keep their dtypes."""
    old = os.environ.get("BTCDET_F32")
    os.environ["BTCDET_F32"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["BTCDET_F32"]
        else:
            os.environ["BTCDET_F32"] = old


def det_only_micro_cfgs(**roi_overrides):
    """The micro det-only config of the JAX package (exact ball queries)."""
    from btcdet_tpu.datasets.mini_config import micro_data_cfg, micro_model_cfg

    data_cfg = micro_data_cfg(with_occ=False)
    model_cfg = micro_model_cfg(with_occ=False)
    model_cfg.ROI_HEAD.APPROX_QUERY = False
    for k, v in roi_overrides.items():
        model_cfg.ROI_HEAD[k] = v
    return data_cfg, model_cfg


def full_micro_cfgs(**roi_overrides):
    """The full micro config of the JAX package (occ subnet on, exact ball
    queries)."""
    from btcdet_tpu.datasets.mini_config import micro_data_cfg, micro_model_cfg

    data_cfg = micro_data_cfg(with_occ=True)
    model_cfg = micro_model_cfg(with_occ=True)
    model_cfg.ROI_HEAD.APPROX_QUERY = False
    for k, v in roi_overrides.items():
        model_cfg.ROI_HEAD[k] = v
    return data_cfg, model_cfg


def to_np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


# output projections the JAX package initialises at std 0.001: widened so
# the compared rcnn / box outputs are O(1), not O(1e-3)
_NEAR_ZERO_INIT = ("cls_out/kernel", "reg_out/kernel", "det_dense_head/Conv_1/kernel")


def perturb_variables(variables, seed: int = 0):
    """Move every BatchNorm off identity (running stats and affine) and
    widen the near-zero output projections, so the parity tests exercise
    the BN arithmetic and see O(1) head outputs."""
    rng = np.random.RandomState(seed)
    v = to_np_tree(variables)

    def walk(tree, path):
        for k, x in tree.items():
            if isinstance(x, dict):
                walk(x, path + (k,))
                continue
            name = "/".join(path + (k,))
            if name.endswith(_NEAR_ZERO_INIT):
                tree[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
            if "BatchNorm" not in name:
                continue
            if k == "mean":
                tree[k] = rng.normal(0.0, 0.3, x.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k == "scale":
                tree[k] = rng.normal(1.0, 0.2, x.shape).astype(np.float32)
            elif k == "bias":
                tree[k] = rng.normal(0.0, 0.1, x.shape).astype(np.float32)

    walk(v, ())
    return v


def init_jax(net, batch_np):
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    batch = {k: jnp.asarray(x) for k, x in batch_np.items()}
    return jax.jit(lambda b: net.init(rngs, b, train=False))(batch)


def shaped_jax_variables(net, batch_np, seed: int = 0):
    """Variables of `net` with the tree, shapes and dtypes its init gives,
    drawn from N(0, 0.1) by numpy (BN variances from U(0.5, 1.5)): the
    init is traced (`jax.eval_shape`), not compiled. For the tests that
    read names and shapes, or any values, but not the init's own."""
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    batch = {k: jnp.asarray(x) for k, x in batch_np.items()}
    shapes = jax.eval_shape(lambda b: net.init(rngs, b, train=False), batch)
    rng = np.random.RandomState(seed)

    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return (rng.normal(0.0, 0.1, x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def relabel(batch_np, num_class: int):
    """The synthetic batch with its gt boxes' class ids (`gt_boxes[..., 7]`,
    0 on padding) cycled over 1..num_class, box by box."""
    gt = batch_np["gt_boxes"].copy()
    ids = np.arange(gt.shape[1]) % num_class + 1
    gt[..., 7] = np.where(gt[..., 7] > 0, ids[None, :], 0).astype(gt.dtype)
    return dict(batch_np, gt_boxes=gt)


def run_both(cfg, num_points: int, num_gt: int, class_names=("Car",),
             batch_size: int = 2) -> dict:
    """One JAX BtcNet eval forward + post-processing and the port's on the
    same synthetic batch (seed 0, `batch_size` frames; with several
    `class_names` its gt boxes `relabel`led) and the same weights (JAX
    init, BN moved off identity, carried across with
    `weights.from_jax_variables`).
    cfg: {"DATA_CONFIG", "MODEL"} of the JAX package.

    With MODEL.OCC the occupancy bias moves off its logit(0.01) prior, so
    random weights emit occ points, and the run also returns the occ
    subnet's outputs (`ref_occ` / `occ`), the occ backbone's (volume,
    mask) (`ref_bb` / `bb`, channels last) and `per_frame`, the det voxel
    rows of a frame. Always: `ref` / `ref_post` (JAX outputs and
    detections), `out` / `post` (the port's), `missing` (the port's
    strict load_state_dict report), `port` (the port's model, on the CPU,
    holding those weights). All arrays are numpy."""
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
    from btcdet_tpu.models import build_network as jax_build
    from btcdet_tpu.models.detectors.btcnet import post_processing as jax_post

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    use_occ = cfg.MODEL.get("OCC") is not None
    res = {}
    with f32_mode():
        batch_np = jax_batch(cfg.DATA_CONFIG, batch_size=batch_size, num_points=num_points,
                             num_gt=num_gt, seed=0, mode="test")
        if len(class_names) > 1:
            batch_np = relabel(batch_np, len(class_names))
        res["batch"] = batch_np
        net = jax_build(cfg.MODEL, cfg.DATA_CONFIG, list(class_names))
        variables = perturb_variables(init_jax(net, batch_np))
        if use_occ:
            cls = variables["params"]["occ_subnet"]["conv_cls"]
            cls["bias"] = np.zeros_like(cls["bias"])
        jb = {k: jnp.asarray(v) for k, v in batch_np.items()}

        def run(v, b):
            return net.apply(v, b, train=False, mutable=["intermediates"],
                             capture_intermediates=lambda mdl, name: name == "__call__")
        ref, inter = jax.jit(run)(variables, jb)
        res["ref_post"] = to_np_tree(jax_post(ref, cfg.MODEL.POST_PROCESSING,
                                              len(class_names)))
        res["ref"] = {k: np.asarray(v) for k, v in ref.items() if not isinstance(v, dict)}
        if use_occ:
            occ_node = inter["intermediates"]["occ_subnet"]
            res["ref_occ"] = to_np_tree(occ_node["__call__"][0])
            res["ref_bb"] = to_np_tree(occ_node["backbone_3d"]["__call__"][0])

        tc = tcfg.EasyDict(cfg)
        port = build_network(tc.MODEL, tc.DATA_CONFIG, list(class_names), device="cpu")
        sd = weights.from_jax_variables(variables, dp_ratio=tc.MODEL.ROI_HEAD.DP_RATIO,
                                        upsample_strides=tc.MODEL.BACKBONE_2D.UPSAMPLE_STRIDES)
        res["missing"] = port.load_state_dict(sd, strict=True)
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch_np.items()}
        seen = {}
        hooks = [] if not use_occ else [
            port.occ_modules.register_forward_hook(lambda m, i, o: seen.update(occ=o)),
            port.occ_modules.backbone_3d.register_forward_hook(
                lambda m, i, o: seen.update(bb=o))]
        out = port(tb)
        for h in hooks:
            h.remove()
        post = post_processing(out, tc.MODEL.POST_PROCESSING, len(class_names), device="cpu")
    res["port"] = port
    res["out"] = {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}
    res["post"] = {k: v.numpy() for k, v in post.items()}
    if use_occ:
        res["occ"] = {k: v.numpy() for k, v in seen["occ"].items() if v is not None}
        x, m = seen["bb"]
        res["bb"] = (x.permute(0, 2, 3, 4, 1).numpy(), m.numpy())
        res["per_frame"] = batch_np["det_voxels"].shape[0] // batch_size
    return res


@functools.cache
def full_micro_run() -> dict:
    """`run_both` on the full micro config (2048 points, 4 boxes), once
    per test process: the model and occupancy parity tests share it."""
    from btcdet_tpu.config import EasyDict

    data_cfg, model_cfg = full_micro_cfgs()
    return run_both(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}), 2048, 4)


def assert_close(a, b, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=err_msg)
