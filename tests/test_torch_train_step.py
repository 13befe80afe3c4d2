"""One whole train step of the port against the JAX package on the CPU,
float32 (`test_torch_train.train_step_both`): the JAX package's
`trainer.make_train_step` and the port's `trainer.train_step` from the
same weights on the same batch with the same roi draws. The full micro
config compared loss term by loss term, in the sampled rois and occ
targets, gradient by gradient, and in the parameters and BN statistics
after the update (the mini config's loss terms and targets under
`-m slow`); and the micro step with MATCH_HEIGHT on and the corner loss
off. The unit cases of the train step are in tests/test_torch_train.py."""

import functools

import numpy as np
import pytest
import torch

from btcdet_tpu.datasets.mini_config import mini_data_cfg, mini_model_cfg, mini_opt_cfg
from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch import weights as W
from test_torch_train import (OCC_TARGET_KEYS, TIGHT, assert_step_gradients_match,
                              train_step_both)
from torch_parity import assert_close, f32_mode, full_micro_cfgs


@functools.cache
def match_height_step():
    """One micro train step in both packages with MATCH_HEIGHT on and the
    corner loss off (`train_step_both`)."""
    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0)
    model_cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT = True
    model_cfg.ROI_HEAD.LOSS_CONFIG.CORNER_LOSS_REGULARIZATION = False
    return train_step_both(data_cfg, model_cfg, 2048, 4)


@pytest.mark.parametrize("path,value", [
    (("model", "DENSE_HEAD", "TARGET_ASSIGNER_CONFIG", "MATCH_HEIGHT"), True),
    (("model", "ROI_HEAD", "LOSS_CONFIG", "CORNER_LOSS_REGULARIZATION"), False),
], ids=lambda v: v[-1] if isinstance(v, tuple) else None)
def test_train_refuses_unported_options(path, value):
    """Named for the refusals these two train options had; both now run,
    and each case holds one micro train step with both set against the JAX
    package's. MATCH_HEIGHT (the rotated 3-D IoU assignment): the RPN loss
    terms to 1e-4 and the dense head's gradients to 1e-3 of each tensor's
    max. CORNER_LOSS_REGULARIZATION False: no `rcnn_loss_corner` term on
    either side, the rcnn terms to 1e-4 and the roi head's gradients to
    1e-3 of each tensor's max (the micro step samples no foreground roi, so
    the reg trunk's output layers get none)."""
    res = match_height_step()
    ref, out = res["ref_metrics"], res["metrics"]
    if path[-1] == "MATCH_HEIGHT":
        keys, prefix, nonzero = ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss"), \
            "det_modules.dense_head.", 0.9
        assert ref["rpn_loss_loc"] > 0
    else:
        keys, prefix, nonzero = ("rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss"), \
            "det_modules.roi_head.", 0.8
        assert "rcnn_loss_corner" not in ref and "rcnn_loss_corner" not in out
    for k in keys + ("loss",):
        assert_close(out[k], float(np.asarray(ref[k])), err_msg=k)
    assert_step_gradients_match(res, prefix, nonzero)


@functools.cache
def micro_step():
    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0)
    return train_step_both(data_cfg, model_cfg, 2048, 4)


def _mini_step():
    data_cfg, model_cfg = mini_data_cfg(with_occ=True), mini_model_cfg(with_occ=True)
    model_cfg.ROI_HEAD.APPROX_QUERY = False
    model_cfg.ROI_HEAD.DP_RATIO = 0.0
    return train_step_both(data_cfg, model_cfg, 8192, 6)


@pytest.fixture(scope="module", params=["micro", pytest.param("mini", marks=pytest.mark.slow)])
def step(request):
    return micro_step() if request.param == "micro" else _mini_step()


@pytest.fixture(scope="module")
def micro():
    """The gradients and the update are compared on the micro config only:
    on the mini config they are too ill-conditioned for 1e-3 of a tensor's
    max -- a 1e-6 relative change of the weights moves some of them (the
    occ deconvs, the x_combine conv stack) by up to 6 % of their max,
    through ReLU and active-site boundaries -- while its loss terms and
    targets still match."""
    return micro_step()


def test_step_loss_terms_match(step):
    ref, out = step["ref_metrics"], step["metrics"]
    assert set(ref) <= set(out), set(ref) - set(out)
    for k in ref:
        assert np.isfinite(out[k]), k
        assert_close(out[k], ref[k], err_msg=k)
    assert ref["occ_loss"] > 0 and ref["rpn_loss_loc"] > 0


def test_step_sampled_rois_and_occ_targets_match(step):
    # the same rois picked in the same slots (the boxes themselves are f32
    # RPN outputs, equal to 1e-4; another pick would differ by metres)
    assert_close(step["rois"], step["ref_rois"])
    for k in OCC_TARGET_KEYS:
        a, b = step["occ"][k], step["ref_occ"][k]
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert_close(a, b, **TIGHT, err_msg=k)
    assert step["ref_occ"]["pos_mask"].any() and step["ref_occ"]["forebox_label"].any()


def test_step_gradients_match(micro):
    ref, out = micro["ref_grads"], micro["grads"]
    assert set(out) <= set(ref)
    for k, g in out.items():
        r = ref[k].numpy()
        scale = np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * scale + 1e-8, err_msg=k)
    assert sum(np.abs(g).max() > 0 for g in out.values()) > 0.9 * len(out)


def test_step_updated_weights_match(micro):
    """Parameters and BN running statistics after the update, at 1e-4.
    Adam's first step moves an element by about lr * sign(g) however small
    g is, so where the JAX gradient lies within the gradient check's
    tolerance of 0 (1e-3 of the tensor's max), the two signs may differ:
    there the step is held to its size, 2 * lr."""
    ref, out = micro["ref_after"], micro["after"]
    assert set(out) == {k for k in ref if not k.endswith("num_batches_tracked")}
    lr0 = {"det": 0.01 / 10, "occ": 0.003 / 10}            # OneCycle LR at step 0
    n_noise = 0
    for k, v in out.items():
        r = ref[k].numpy()
        g = micro["ref_grads"].get(k)
        if g is None:                                           # BN statistics
            assert_close(v, r, err_msg=k)
            continue
        g = g.numpy()
        noise = np.abs(g) <= 1e-3 * np.abs(g).max()
        n_noise += int(noise.sum())
        assert_close(v[~noise], r[~noise], err_msg=k)
        lr = lr0["occ" if k.startswith("occ_modules.") else "det"]
        np.testing.assert_array_less(np.abs(v - r)[noise], 2 * lr + 1e-4, err_msg=k)
    assert n_noise < 0.05 * sum(v.size for v in out.values())


@pytest.mark.slow
def test_mini_step_gradients_are_ill_conditioned():
    """Why the gradients are compared on the micro config only: on the mini
    config a 1e-6 relative change of the weights moves some gradients of
    the port's own train step by far more than 1e-3 of their tensor's max
    (ReLU and active-site boundaries). Prints the largest move."""
    from btcdet_tpu_torch.datasets import make_synthetic_batch, mini_config
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import trainer as TT

    d, m = mini_config.mini_data_cfg(with_occ=True), mini_config.mini_model_cfg(with_occ=True)
    m.ROI_HEAD.APPROX_QUERY = False
    m.ROI_HEAD.DP_RATIO = 0.0
    batch = make_synthetic_batch(d, batch_size=2, num_points=8192, num_gt=6, seed=0,
                                 mode="train", device="cpu")

    def grads(eps):
        net = build_network(m, d, ["Car"], device="cpu")
        sd = W.synth_state_dict(net)
        bias = "occ_modules.occ_dense_head.conv_cls.0.bias"
        sd[bias] = torch.zeros_like(sd[bias])
        g = torch.Generator().manual_seed(5)
        for k, v in sd.items():
            if v.dtype == torch.float32 and "running" not in k:
                sd[k] = v * (1 + eps * torch.randn(v.shape, generator=g))
        net.load_state_dict(sd)
        opt = TT.create_train_state(net, tcfg.EasyDict(mini_opt_cfg()),
                                    tcfg.EasyDict(mini_opt_cfg()), 100)
        TT.train_step(net, opt, batch, torch.Generator().manual_seed(0))
        return {n: p.grad for n, p in net.named_parameters()}

    with f32_mode():
        g0, g1 = grads(0.0), grads(1e-6)
    move = max(float((g1[n] - g0[n]).abs().max()) / max(float(g0[n].abs().max()), 1e-30)
               for n in g0)
    print(f"largest gradient move under a 1e-6 weight change: {move:.3e} of its tensor's max")
    assert move > 1e-2
