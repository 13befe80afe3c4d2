"""The port's training step against the JAX package on the CPU, float32:
the unit cases, and `train_step_both`, the harness of the whole-step
tests (tests/test_torch_train_step.py and the option files).

Unit cases: every loss function, the box helpers the losses use, the RPN
target assignment and loss, the roi sampling and targets (the JAX
package's draws for a fixed key fed to the port), the chunked NMS at a
train-size k, train-mode batch norms (outputs and running statistics),
the dual optimizer against optax, the sparse-conv and roi-sampler
gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.datasets.mini_config import micro_data_cfg, micro_model_cfg, mini_opt_cfg
from btcdet_tpu.models.dense_heads import anchor_head as JAH
from btcdet_tpu.models.roi_heads import roi_head_utils as JRH
from btcdet_tpu.ops import iou3d as JI
from btcdet_tpu.utils import box_coder as JBC
from btcdet_tpu.utils import box_utils as JBU
from btcdet_tpu.utils import loss_utils as JL
from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch import weights as W
from btcdet_tpu_torch.models.dense_heads import anchor_head as TAH
from btcdet_tpu_torch.models.roi_heads import roi_head_utils as TRH
from btcdet_tpu_torch.ops import iou3d as TI
from btcdet_tpu_torch.utils import box_coder as TBC
from btcdet_tpu_torch.utils import box_utils as TBU
from btcdet_tpu_torch.utils import loss_utils as TL
from torch_parity import assert_close, f32_mode, init_jax, perturb_variables, to_np_tree

# elementwise f32 losses and box maths: the same operations in the same order
TIGHT = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def random_boxes(rng, n, spread=12.0):
    ctr = rng.rand(n, 3) * [spread, spread, 1.0]
    dims = np.stack([rng.uniform(3, 4.5, n), rng.uniform(1.4, 2.0, n),
                     rng.uniform(1.3, 1.8, n)], 1)
    yaw = rng.uniform(-np.pi, np.pi, n)
    return np.concatenate([ctr, dims, yaw[:, None]], 1).astype(np.float32)


# ------------------------------------------------------------------ losses

def _loss_cases():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 50, 3) * 3).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 50))]
    preds = rng.randn(2, 50, 7).astype(np.float32)
    tgt = rng.randn(2, 50, 7).astype(np.float32)
    tgt[0, :5, 2] = np.nan                                  # ignored targets
    wts = rng.rand(2, 50).astype(np.float32)
    soft = rng.rand(2, 50).astype(np.float32)
    b1, b2 = random_boxes(rng, 40), random_boxes(rng, 40)
    return {
        "sigmoid_focal": ((logits, onehot), {}),
        "softmax_focal": ((logits, onehot), dict(alpha=1.0, gamma=2.0)),
        "smooth_l1": ((preds - np.nan_to_num(tgt),), dict(beta=0.025)),
        "weighted_smooth_l1": ((preds, tgt, wts), dict(code_weights=[1, 2, 1, 1, 0.5, 1, 1])),
        "weighted_cross_entropy": ((logits, onehot, wts), {}),
        "binary_cross_entropy_with_logits": ((logits[..., 0], soft), {}),
        "get_corner_loss_lidar": ((b1, b2), {}),
    }


LOSSES = list(_loss_cases())


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches(name):
    args, kw = _loss_cases()[name]
    fn = {"sigmoid_focal": "sigmoid_focal_loss", "softmax_focal": "softmax_focal_loss",
          "smooth_l1": "smooth_l1_loss", "weighted_smooth_l1": "weighted_smooth_l1_loss"}.get(
        name, name)
    ref = np.asarray(getattr(JL, fn)(*(jnp.asarray(a) for a in args), **kw))
    out = getattr(TL, fn)(*(t(a) for a in args), **kw).numpy()
    assert out.shape == ref.shape and np.isfinite(ref).all()
    assert_close(out, ref, **TIGHT)


def test_box_helpers_match():
    rng = np.random.RandomState(1)
    a, b = random_boxes(rng, 30), random_boxes(rng, 20)
    a[:, 6] = rng.uniform(-4, 4, 30)
    assert_close(TBU.boxes_to_corners_3d(t(a)).numpy(),
                 np.asarray(JBU.boxes_to_corners_3d(jnp.asarray(a))), **TIGHT)
    assert_close(TBU.boxes3d_nearest_bev_iou(t(a), t(b)).numpy(),
                 np.asarray(JBU.boxes3d_nearest_bev_iou(jnp.asarray(a), jnp.asarray(b))), **TIGHT)
    assert_close(TI.boxes_iou3d(t(a), t(b)).numpy(),
                 np.asarray(JI.boxes_iou3d(jnp.asarray(a), jnp.asarray(b))), **TIGHT)
    enc = JBC.ResidualCoder().encode(jnp.asarray(a[:20]), jnp.asarray(b))
    assert_close(TBC.ResidualCoder().encode(t(a[:20]), t(b)).numpy(), np.asarray(enc), **TIGHT)


# --------------------------------------------------------------- RPN head

def _rpn_case(seed=2):
    """Anchors of the micro grid, gts placed on some of them."""
    cfg = micro_model_cfg(with_occ=False).DENSE_HEAD
    pcr = micro_data_cfg(with_occ=False).POINT_CLOUD_RANGE
    anchors, anchor_class, per_loc = JAH.generate_anchors(pcr, (32, 32, 41),
                                                         cfg.ANCHOR_GENERATOR_CONFIG)
    rng = np.random.RandomState(seed)
    gt = np.zeros((2, 5, 8), np.float32)
    for b in range(2):
        pick = anchors[rng.choice(len(anchors), 4, replace=False)]
        gt[b, :4, :7] = pick + rng.normal(0, 0.2, pick.shape) * [1, 1, 0.2, 0.2, 0.1, 0.1, 0.3]
        gt[b, :4, 7] = 1
    return cfg, anchors, anchor_class, per_loc, gt


def test_assign_targets_single_class_matches():
    _, anchors, anchor_class, _, gt = _rpn_case()
    coder = JBC.ResidualCoder()
    for b in range(2):
        ref = JAH.assign_targets_single_class(
            jnp.asarray(anchors), jnp.asarray(anchor_class == 0), jnp.asarray(gt[b, :, :7]),
            jnp.asarray(gt[b, :, 7] > 0), 1, 0.6, 0.45, coder, False)
        out = TAH.assign_targets_single_class(
            t(anchors), t(anchor_class == 0), t(gt[b, :, :7]), t(gt[b, :, 7] > 0), 1, 0.6, 0.45,
            TBC.ResidualCoder())
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
        assert_close(out[1].numpy(), np.asarray(ref[1]), **TIGHT)
        assert (np.asarray(ref[0]) == 1).sum() >= 4


def test_rpn_loss_matches():
    cfg, anchors, anchor_class, per_loc, gt = _rpn_case()
    lw = cfg.LOSS_CONFIG.LOSS_WEIGHTS
    kw = dict(cls_weight=lw["cls_weight"], loc_weight=lw["loc_weight"],
              dir_weight=lw["dir_weight"], code_weights=tuple(lw["code_weights"]))
    jhead = JAH.AnchorHeadSingle(num_class=1, anchors=anchors, anchor_class=anchor_class,
                                 num_anchors_per_location=per_loc, **kw)
    targets = jhead._assign(jnp.asarray(anchors), jnp.asarray(gt))
    rng = np.random.RandomState(3)
    A = len(anchors)
    preds = {"cls_preds": rng.randn(2, A, 1), "box_preds": rng.randn(2, A, 7) * 0.3,
             "dir_preds": rng.randn(2, A, 2)}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    ref_total, ref = jhead.get_loss({**{k: jnp.asarray(v) for k, v in preds.items()}, **targets})
    thead = TAH.AnchorHeadSingle(8, 1, anchors, per_loc, anchor_class=anchor_class, **kw)
    tt = thead.assign_targets(t(gt))
    for k in ("box_cls_labels", "box_reg_mask"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(targets[k]))
    total, out = thead.get_loss({**{k: t(v) for k, v in preds.items()}, **tt})
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k].numpy(), np.asarray(ref[k]), **TIGHT, err_msg=k)
    assert_close(total.numpy(), np.asarray(ref_total), **TIGHT)


# ------------------------------------------------------------ roi targets

def jax_roi_draws(key, B, N, R):
    """The uniforms `roi_head_utils.assign_targets` draws from `key`, split
    as `subsample_rois` splits it; (B, N) x 3 and (B, R) x 2 numpy."""
    draws = [[], [], [], [], []]
    for rng in jax.random.split(key, B):
        r_fg, _ = jax.random.split(rng)
        ks = jax.random.split(r_fg, 5)
        for i, (k, n) in enumerate(zip(ks, (N, N, N, R, R))):
            draws[i].append(np.asarray(jax.random.uniform(k, (n,))))
    return tuple(np.stack(d) for d in draws)


def patched_draws(monkeypatch, draws):
    monkeypatch.setattr(TRH, "draw_roi_sampling_uniforms",
                        lambda generator, B, N, R: tuple(t(d) for d in draws))


def test_roi_assign_targets_matches(monkeypatch):
    B, N, R = 2, 60, 16
    rng = np.random.RandomState(4)
    gt = np.zeros((B, 4, 8), np.float32)
    rois = np.zeros((B, N, 7), np.float32)
    for b in range(B):
        gt[b, :3, :7] = random_boxes(rng, 3)
        gt[b, :3, 7] = 1
        near = gt[b, rng.randint(0, 3, N), :7] + rng.normal(0, 0.4, (N, 7)) * [1, 1, .2, .3, .2, .1, .3]
        rois[b] = np.where(rng.rand(N, 1) < 0.5, near, random_boxes(rng, N))
    valid = rng.rand(B, N) < 0.9
    labels = np.ones((B, N), np.int32)
    scores = rng.rand(B, N).astype(np.float32)
    kw = dict(roi_per_image=R, fg_ratio=0.5, reg_fg_thresh=0.55, cls_fg_thresh=0.75,
              cls_bg_thresh=0.25, cls_bg_thresh_lo=0.1, hard_bg_ratio=0.8)
    key = jax.random.PRNGKey(7)
    ref = JRH.assign_targets(key, JRH.Proposals(jnp.asarray(rois), jnp.asarray(scores),
                                                jnp.asarray(labels), jnp.asarray(valid)),
                             jnp.asarray(gt), **kw)
    patched_draws(monkeypatch, jax_roi_draws(key, B, N, R))
    out = TRH.assign_targets(None, TRH.Proposals(t(rois), t(scores), t(labels).long(),
                                                 t(valid)), t(gt), **kw)
    for k in ("roi_labels", "reg_valid_mask", "roi_valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(out["rois"].numpy(), np.asarray(ref["rois"]))
    for k in ("roi_ious", "rcnn_cls_labels", "gt_of_rois", "gt_of_rois_src"):
        assert_close(out[k].numpy(), np.asarray(ref[k]), **TIGHT, err_msg=k)
    assert np.asarray(ref["reg_valid_mask"]).any() and not np.asarray(ref["reg_valid_mask"]).all()


def test_rcnn_loss_matches():
    """ConvHead's BCE cls, smooth-L1 reg and corner losses on sampled roi
    targets with foreground rois."""
    from btcdet_tpu.models.roi_heads import conv_head as JCH
    from btcdet_tpu_torch.models.roi_heads import conv_head as TCH

    B, N, R = 2, 40, 16
    rng = np.random.RandomState(12)
    gt = np.zeros((B, 3, 8), np.float32)
    rois = np.zeros((B, N, 7), np.float32)
    for b in range(B):
        gt[b, :, :7] = random_boxes(rng, 3)
        gt[b, :, 7] = 1
        rois[b] = gt[b, rng.randint(0, 3, N), :7] + rng.normal(0, 0.3, (N, 7)) * [1, 1, .2, .2, .1, .1, .5]
    props = JRH.Proposals(jnp.asarray(rois), jnp.zeros((B, N)), jnp.ones((B, N), jnp.int32),
                          jnp.asarray(rng.rand(B, N) < 0.9))
    kw = dict(roi_per_image=R, fg_ratio=0.5, reg_fg_thresh=0.55, cls_fg_thresh=0.75,
              cls_bg_thresh=0.25, cls_bg_thresh_lo=0.1, hard_bg_ratio=0.8)
    # the JAX side jitted: one compile each, not one an op
    targets = jax.jit(functools.partial(JRH.assign_targets, **kw))(
        jax.random.PRNGKey(3), props, jnp.asarray(gt))
    rcnn_cls = rng.randn(B * R, 1).astype(np.float32)
    rcnn_reg = (rng.randn(B * R, 7) * 0.2).astype(np.float32)
    weights = dict(rcnn_cls_weight=1.0, rcnn_reg_weight=0.5, rcnn_corner_weight=2.0,
                   code_weights=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0))
    jhead = JCH.ConvHead(num_class=1, **weights)
    ref_total, ref = jax.jit(lambda c, r: jhead.get_loss({"rcnn_cls": c, "rcnn_reg": r},
                                                         targets))(
        jnp.asarray(rcnn_cls), jnp.asarray(rcnn_reg))
    head = TCH.ConvHead(1, 16, **weights)
    cls_t, reg_t = t(rcnn_cls).requires_grad_(), t(rcnn_reg).requires_grad_()
    total, out = head.get_loss(cls_t, reg_t, {k: t(np.asarray(v)) for k, v in targets.items()})
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k].detach().numpy(), np.asarray(ref[k]), **TIGHT, err_msg=k)
    assert_close(total.detach().numpy(), np.asarray(ref_total), **TIGHT)
    assert float(ref["rcnn_loss_corner"]) > 0 and float(ref["rcnn_loss_reg"]) > 0
    # gradients of each reg term on its own (the corner loss goes through
    # the roi-frame decode) and of the total, against jax.grad
    for term in ("rcnn_loss_reg", "rcnn_loss_corner", "rcnn_loss"):
        def jloss(c, r, term=term):
            return jhead.get_loss({"rcnn_cls": c, "rcnn_reg": r}, targets)[1][term]
        ref_g = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(rcnn_cls),
                                                         jnp.asarray(rcnn_reg))
        got = torch.autograd.grad(out[term], (cls_t, reg_t), retain_graph=True,
                                  allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g for g, x in zip(got, (cls_t, reg_t))]
        for g, r, name in zip(got, ref_g, ("rcnn_cls", "rcnn_reg")):
            assert_close(g.numpy(), np.asarray(r), **TIGHT, err_msg=f"{term} d/d{name}")
        assert np.abs(np.asarray(ref_g[1])).max() > 0, term


def test_chunked_nms_matches_at_train_size():
    """k = 3000, a train-size candidate list: the port's chunked pass keeps
    the same set as the JAX chunked NMS and as the plain greedy over the
    full (k, k) matrix (JAX `impl="rounds"`, one IoU row per kept box)."""
    rng = np.random.RandomState(5)
    n = 3500
    boxes = random_boxes(rng, n, spread=60.0)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) < 0.95
    kw = dict(thresh=0.3, pre_max_size=3000, post_max_size=256)
    ti, tv = TI.nms_rotated(t(boxes), t(scores), t(valid), **kw)
    tv = tv.numpy()
    for impl in ("chunked", "rounds"):
        ji, jv = jax.jit(functools.partial(JI.nms_rotated, impl=impl, **kw))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
        jv = np.asarray(jv)
        np.testing.assert_array_equal(tv, jv, err_msg=impl)
        np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv], err_msg=impl)
    # the pass spans several chunks before 256 survive
    s = torch.where(t(valid), t(scores), torch.full((n,), -np.inf))
    order = torch.sort(s, descending=True, stable=True).indices[:3000]
    rank = {int(i): r for r, i in enumerate(order)}
    assert tv.sum() == 256 and max(rank[int(i)] for i in ti[tv]) >= TI.NMS_CHUNK


# -------------------------------------------------------------- batch norms

@pytest.mark.parametrize("eps,momentum", [(1e-3, 0.01), (1e-5, 0.1)],
                         ids=["backbone", "fc-trunk"])
def test_masked_batchnorm_train_matches(eps, momentum):
    """Batch statistics over the masked rows, biased variance in the
    running statistics (the backbone / occ / x_combine BNs, and the FC
    trunk BNs with torch's defaults)."""
    from btcdet_tpu.ops import sparse as JS
    from btcdet_tpu_torch.ops import sparse as TS

    rng = np.random.RandomState(6)
    x = (rng.randn(80, 5) * 2 + 1).astype(np.float32)
    mask = rng.rand(80) < 0.6
    p = {"scale": rng.randn(5).astype(np.float32), "bias": rng.randn(5).astype(np.float32)}
    s = {"mean": rng.randn(5).astype(np.float32), "var": rng.rand(5).astype(np.float32) + 0.5}
    ref, mut = JS.MaskedBatchNorm(momentum=momentum, epsilon=eps).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x), jnp.asarray(mask),
        use_running_average=False, mutable=["batch_stats"])
    bn = TS.MaskedBatchNorm(5, eps=eps, momentum=momentum).train()
    bn.load_state_dict({"weight": t(p["scale"]), "bias": t(p["bias"]),
                        "running_mean": t(s["mean"]), "running_var": t(s["var"]),
                        "num_batches_tracked": torch.zeros((), dtype=torch.long)})
    out = bn(t(x).requires_grad_(), t(mask))
    assert_close(out.detach().numpy(), np.asarray(ref), **TIGHT)
    assert_close(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), **TIGHT)
    assert_close(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), **TIGHT)


def test_bev_batchnorm_train_matches():
    """The BEV pyramid's BN at train against flax's `nn.BatchNorm`
    (`backbones_2d._BN`): biased variance in the running statistics."""
    from btcdet_tpu.models import backbones_2d as J2D
    from btcdet_tpu_torch.models import backbones_2d as T2D

    rng = np.random.RandomState(7)
    x = (rng.randn(2, 6, 7, 4) * 1.5 + 0.5).astype(np.float32)           # NHWC
    p = {"scale": rng.randn(4).astype(np.float32), "bias": rng.randn(4).astype(np.float32)}
    s = {"mean": rng.randn(4).astype(np.float32), "var": rng.rand(4).astype(np.float32) + 0.5}
    ref, mut = J2D._BN().apply({"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}},
                               jnp.asarray(x), True, mutable=["batch_stats"])
    bn = T2D.BatchNorm2d(4, eps=1e-3, momentum=0.01).train()
    bn.load_state_dict({"weight": t(p["scale"]), "bias": t(p["bias"]),
                        "running_mean": t(s["mean"]), "running_var": t(s["var"]),
                        "num_batches_tracked": torch.zeros((), dtype=torch.long)})
    out = bn(t(x).permute(0, 3, 1, 2))
    assert_close(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TIGHT)
    stats = mut["batch_stats"]["BatchNorm_0"]
    assert_close(bn.running_mean.numpy(), np.asarray(stats["mean"]), **TIGHT)
    assert_close(bn.running_var.numpy(), np.asarray(stats["var"]), **TIGHT)


@pytest.mark.parametrize("stride,transpose,sub", [(1, False, False), (2, True, False)],
                         ids=["conv", "deconv"])
def test_dense_occ_block_train_matches(stride, transpose, sub):
    """One masked dense occ-backbone block at train (`_DenseSparseBlock`
    with `_DenseBN`): outputs and running statistics."""
    from btcdet_tpu.models.backbones_3d import _DenseSparseBlock
    from btcdet_tpu.train import ref_import
    from btcdet_tpu_torch.models.backbones_3d import DenseSparseBlock

    rng = np.random.RandomState(8)
    B, D, H, Wd, ci, co = 2, 5, 9, 7, 3, 4
    mask = rng.rand(B, D, H, Wd) < 0.3
    x = (rng.randn(B, D, H, Wd, ci) * mask[..., None]).astype(np.float32)
    w_ref = (rng.randn(3, 3, 3, ci, co) * 0.3).astype(np.float32)
    blk = _DenseSparseBlock(co, stride=(stride,) * 3, transpose=transpose, submanifold=sub)
    with f32_mode():
        v = to_np_tree(blk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False))
        conv = "ConvTranspose_0" if transpose else "Conv_0"
        v["params"][conv]["kernel"] = ref_import.t_deconv3d(w_ref) if transpose else w_ref
        (ref_y, ref_m), mut = blk.apply(v, jnp.asarray(x), jnp.asarray(mask), True,
                                        mutable=["batch_stats"])
        port = DenseSparseBlock(ci, co, stride=stride, transpose=transpose, submanifold=sub)
        bnp = v["params"]["_DenseBN_0"]["MaskedBatchNorm_0"]
        bns = v["batch_stats"]["_DenseBN_0"]["MaskedBatchNorm_0"]
        port.load_state_dict({"0.weight": t(w_ref), "1.weight": t(bnp["scale"]),
                              "1.bias": t(bnp["bias"]), "1.running_mean": t(bns["mean"]),
                              "1.running_var": t(bns["var"]),
                              "1.num_batches_tracked": torch.zeros((), dtype=torch.long)})
        port.train()
        y, m = port(t(x).permute(0, 4, 1, 2, 3), t(mask))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    assert_close(y.detach().permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref_y))
    stats = mut["batch_stats"]["_DenseBN_0"]["MaskedBatchNorm_0"]
    assert_close(getattr(port, "1").running_mean.numpy(), np.asarray(stats["mean"]))
    assert_close(getattr(port, "1").running_var.numpy(), np.asarray(stats["var"]))


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("frozen", [None, "occ", "det"])
def test_dual_optimizer_matches_optax(frozen):
    """Three dual `adam_onecycle` updates of a small parameter tree against
    `optim.build_dual_optimizer` (optax), with one partition frozen."""
    import torch.nn as nn

    from btcdet_tpu.train import optim as JO
    from btcdet_tpu_torch.train import trainer as TT

    rng = np.random.RandomState(9)
    shapes = {("occ_subnet", "conv", "kernel"): (3, 4), ("occ_subnet", "bn", "scale"): (4,),
              ("det_head", "kernel"): (5, 2), ("det_head", "bias"): (2,),
              ("det_bn", "bias"): (5,)}
    names = {("occ_subnet", "conv", "kernel"): "occ_modules.conv.weight",
             ("occ_subnet", "bn", "scale"): "occ_modules.bn.weight",
             ("det_head", "kernel"): "det_modules.head.weight",
             ("det_head", "bias"): "det_modules.head.bias",
             ("det_bn", "bias"): "det_modules.bn.bias"}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 6).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]

    def tree(flat):
        out = {}
        for path, v in flat.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(v)
        return out

    det_cfg = mini_opt_cfg(lr=0.01)
    occ_cfg = mini_opt_cfg(lr=0.003)
    occ_cfg["WEIGHT_DECAY"] = 0.001
    if frozen == "occ":
        occ_cfg["LR"] = 0.0
    if frozen == "det":
        det_cfg["LR"] = 0.0
    tx = JO.build_dual_optimizer(det_cfg, occ_cfg, total_steps=20)
    params = tree(init)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(tree(g), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)

    class Leaf(nn.Module):
        pass

    net = nn.Module()
    for path, name in names.items():
        mod = net
        for part in name.split(".")[:-1]:
            if not hasattr(mod, part):
                mod.add_module(part, Leaf())
            mod = getattr(mod, part)
        mod.register_parameter(name.split(".")[-1], nn.Parameter(t(init[path])))
    opt = TT.create_train_state(net, tcfg.EasyDict(det_cfg), tcfg.EasyDict(occ_cfg), 20)
    tp = dict(net.named_parameters())
    for g in grads:
        for path, name in names.items():
            tp[name].grad = t(g[path]) if tp[name].requires_grad else None
        norms = opt.step()
    assert set(norms) == {f"grad_norm_{p}" for p in ("occ", "det") if p != frozen}
    for path, name in names.items():
        ref = np.asarray(functools.reduce(lambda d, k: d[k], path, params))
        np.testing.assert_allclose(tp[name].detach().numpy(), ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        moved = not np.array_equal(ref, init[path])
        assert moved == (frozen is None or not name.startswith(f"{frozen}_modules")), name


def assert_step_gradients_match(res, prefix="", nonzero=0.9):
    """Every gradient under `prefix` within 1e-3 of its tensor's max of the
    JAX package's; more than a `nonzero` share of them nonzero."""
    grads = {k: g for k, g in res["grads"].items() if k.startswith(prefix)}
    assert grads and set(grads) <= set(res["ref_grads"])
    for k, g in grads.items():
        r = res["ref_grads"][k].numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * np.abs(r).max() + 1e-8, err_msg=k)
    assert sum(np.abs(g).max() > 0 for g in grads.values()) > nonzero * len(grads)


# ------------------------------------------------------------- whole step

class _RecordingTx:
    """An optax transformation that keeps the gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.tx.update(grads, state, params)


OCC_TARGET_KEYS = ("voxelwise_mask", "vcc_mask", "occ_voxelwise_mask", "fore_voxelwise_mask",
                   "mirr_voxelwise_mask", "bm_voxelwise_mask", "pos_mask", "neg_mask",
                   "general_cls_loss_mask", "general_reg_loss_mask", "forebox_label",
                   "general_cls_loss_mask_float", "general_reg_loss_mask_float", "res_mtrx")
ROI_KEY = jax.random.PRNGKey(7)


def train_step_both(data_cfg, model_cfg, num_points: int, num_gt: int, total_steps: int = 50,
                    batch_np=None, class_names=("Car",)):
    """One JAX train step (`trainer.make_train_step`, XLA engine) and one
    port step (`trainer.train_step`) from the same weights (JAX init, BN
    moved off identity, occupancy bias 0 so occ points exist) on the same
    `mode="train"` batch (seed 0, B=2; or `batch_np`, numpy arrays) for
    `class_names`. Roi sampling uses PRNGKey(7) in
    both: the JAX `assign_targets` is given that key, the port
    `draw_roi_sampling_uniforms` returns its draws. The JAX occ targets and
    sampled rois come back through debug callbacks, beside the JAX
    `variables` and the `batch`. All arrays numpy."""
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
    from btcdet_tpu.models import build_network as jax_build
    from btcdet_tpu.models.occ import occ_subnet as JOS
    from btcdet_tpu.train import optim as JO
    from btcdet_tpu.train import trainer as JT
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import trainer as TT

    res, seen = {}, {}
    det_cfg, occ_cfg = mini_opt_cfg(lr=0.01), mini_opt_cfg(lr=0.003)
    orig_assign, orig_targets = JRH.assign_targets, JOS.OccSubnet._make_targets
    orig_draws = TRH.draw_roi_sampling_uniforms

    def assign(rng, *a, **k):
        out = orig_assign(ROI_KEY, *a, **k)
        jax.debug.callback(lambda r: seen.update(rois=np.asarray(r)), out["rois"])
        return out

    def make_targets(self, *a, **k):
        out = orig_targets(self, *a, **k)
        jax.debug.callback(lambda d: seen.update(occ={k: np.asarray(v) for k, v in d.items()}),
                           {k: out[k] for k in OCC_TARGET_KEYS})
        return out

    with f32_mode():
        if batch_np is None:
            batch_np = jax_batch(data_cfg, batch_size=2, num_points=num_points, num_gt=num_gt,
                                 seed=0, mode="train")
        net = jax_build(model_cfg, data_cfg, list(class_names))
        variables = perturb_variables(init_jax(net, batch_np))
        cls = variables["params"]["occ_subnet"]["conv_cls"]
        cls["bias"] = np.zeros_like(cls["bias"])
        tx = _RecordingTx(JO.build_dual_optimizer(det_cfg, occ_cfg, total_steps))
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JT.TrainState(jnp.zeros((), jnp.int32), params,
                              jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              tx.init(params))
        step = JT.make_train_step(net, tx)

        def run(st, b, r):
            new, metrics = step(st, b, r)
            return new, metrics, tx.grads

        JRH.assign_targets, JOS.OccSubnet._make_targets = assign, make_targets
        try:
            new, metrics, grads = jax.jit(run)(
                state, {k: jnp.asarray(v) for k, v in batch_np.items()}, jax.random.PRNGKey(0))
            jax.effects_barrier()
        finally:
            JRH.assign_targets, JOS.OccSubnet._make_targets = orig_assign, orig_targets
        mapping = dict(dp_ratio=float(model_cfg.ROI_HEAD.DP_RATIO),
                       upsample_strides=model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES)
        res["ref_metrics"] = to_np_tree(metrics)
        res["ref_grads"] = W.from_jax_variables(
            {"params": to_np_tree(grads), "batch_stats": variables["batch_stats"]}, **mapping)
        res["ref_after"] = W.from_jax_variables(
            {"params": to_np_tree(new.params), "batch_stats": to_np_tree(new.batch_stats)},
            **mapping)
        res["ref_rois"], res["ref_occ"] = seen["rois"], seen["occ"]
        res["variables"], res["batch"] = variables, batch_np

        tc = tcfg.EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
        port = build_network(tc.MODEL, tc.DATA_CONFIG, list(class_names), device="cpu")
        port.load_state_dict(W.from_jax_variables(variables, **mapping), strict=True)
        opt = TT.create_train_state(port, tcfg.EasyDict(det_cfg), tcfg.EasyDict(occ_cfg),
                                    total_steps)
        N = int(tc.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
        R = int(tc.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
        draws = jax_roi_draws(ROI_KEY, 2, N, R)
        port_seen = {}
        hooks = [port.occ_modules.register_forward_hook(
                     lambda m, i, o: port_seen.update(occ=o)),
                 port.det_modules.roi_head.register_forward_pre_hook(
                     lambda m, a: port_seen.update(rois=a[0]))]
        TRH.draw_roi_sampling_uniforms = lambda generator, B, N, R: tuple(t(d) for d in draws)
        try:
            tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch_np.items()}
            metrics_t = TT.train_step(port, opt, tb, torch.Generator().manual_seed(0))
        finally:
            TRH.draw_roi_sampling_uniforms = orig_draws
            for h in hooks:
                h.remove()
    res["metrics"] = {k: float(v) for k, v in metrics_t.items()}
    res["grads"] = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
    res["after"] = {k: v.numpy().copy() for k, v in port.state_dict().items()
                    if not k.endswith("num_batches_tracked")}
    res["rois"] = port_seen["rois"].numpy()
    res["occ"] = {k: port_seen["occ"][k].detach().numpy() for k in OCC_TARGET_KEYS}
    return res
