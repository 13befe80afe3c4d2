"""Training with the det-side options in the port against the JAX package
on the CPU: one micro train step (`test_torch_train.train_step_both`: same
weights, batch and sampled rois) with OUT_FEAT_TYPE `combine` (the strided
spconv5 / subm5 convs and the x_combine sampler's backward on their
grid), and with the unfused merge under PASS_GRAD (the det losses' gradient
through OccVFE and the materialized merged table into the occ subnet);
each gradient within 1e-3 of its tensor's max. Then the optimizers
`adam`, `adam_cosine` and `sgd`, with and without LR_WARMUP, against the
JAX package's optax chains over three updates. MATCH_HEIGHT with the
corner loss off is held in tests/test_torch_train.py. CPU, float32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_det_options import set_out_feat_type
from test_torch_train import assert_step_gradients_match, train_step_both
from torch_parity import assert_close, full_micro_cfgs


@functools.cache
def option_step(option: str) -> dict:
    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0)
    if option == "combine":
        set_out_feat_type(model_cfg, "combine")
    else:
        model_cfg.OCC.OCC_PNT_UPDATE.FUSED_VFE = False
        model_cfg.OCC.OCC_PNT_UPDATE.PASS_GRAD = True
    return train_step_both(data_cfg, model_cfg, 2048, 4)


@pytest.mark.parametrize("option", ["combine", "unfused_pass_grad"])
def test_option_step_matches(option):
    """Loss terms to 1e-4 and every gradient within 1e-3 of its tensor's
    max; under `combine` the strided and subm5 convs of down_combine get
    gradients, under the unfused PASS_GRAD step the occ subnet's backbone
    does from the det losses too."""
    res = option_step(option)
    ref, out = res["ref_metrics"], res["metrics"]
    assert set(ref) <= set(out)
    for k in ref:
        assert np.isfinite(out[k]), k
        assert_close(out[k], float(np.asarray(ref[k])), err_msg=k)
    assert_step_gradients_match(res)
    if option == "combine":
        for i in (1, 2):
            g = res["grads"][f"det_modules.backbone_3d.down_combine.{i}.0.weight"]
            assert np.abs(g).max() > 0, i
    else:
        g = res["grads"]["occ_modules.backbone_3d.conv1.0.0.weight"]
        assert np.abs(g).max() > 0


# ------------------------------------------------------------ optimizers

def _opt_cfg(name: str, lr: float, warmup: bool):
    from btcdet_tpu.datasets.mini_config import mini_opt_cfg

    cfg = mini_opt_cfg(lr=lr)
    cfg.update({"OPTIMIZER": name, "NUM_EPOCHS": 3, "DECAY_STEP_LIST": [1, 2],
                "LR_WARMUP": warmup, "WARMUP_EPOCH": 1})
    return cfg


@pytest.mark.parametrize("warmup", [False, True], ids=["no_warmup", "warmup"])
@pytest.mark.parametrize("name", ["adam", "adam_cosine", "sgd"])
def test_optimizer_matches_optax(name, warmup):
    """Three updates of a small occ / det parameter tree with `name` in
    both partitions (LR 0.01 / 0.003, WEIGHT_DECAY 0.01, GRAD_NORM_CLIP 10
    with gradients large enough to clip, 6 steps over 3 epochs: `adam`
    decays at steps 2 and 4, LR_WARMUP ramps over steps 0-1) against the
    JAX package's `build_dual_optimizer`, to 1e-6. The weight decay
    reaches kernels only, and only under `adam_cosine` (as in the JAX
    package's chains)."""
    import torch.nn as nn

    from btcdet_tpu.train import optim as JO

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.train import trainer as TT

    rng = np.random.RandomState(11)
    shapes = {("occ_subnet", "conv", "kernel"): (3, 4), ("occ_subnet", "bn", "scale"): (4,),
              ("det_head", "kernel"): (5, 2), ("det_head", "bias"): (2,)}
    names = {("occ_subnet", "conv", "kernel"): "occ_modules.conv.weight",
             ("occ_subnet", "bn", "scale"): "occ_modules.bn.weight",
             ("det_head", "kernel"): "det_modules.head.weight",
             ("det_head", "bias"): "det_modules.head.bias"}
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

    det_cfg, occ_cfg = _opt_cfg(name, 0.01, warmup), _opt_cfg(name, 0.003, warmup)
    tx = JO.build_dual_optimizer(det_cfg, occ_cfg, total_steps=6)
    params = tree(init)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(tree(g), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)

    net = nn.Module()
    for path, name_t in names.items():
        mod = net
        for part in name_t.split(".")[:-1]:
            if not hasattr(mod, part):
                mod.add_module(part, nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(name_t.split(".")[-1],
                               nn.Parameter(torch.from_numpy(init[path].copy())))
    opt = TT.create_train_state(net, tcfg.EasyDict(det_cfg), tcfg.EasyDict(occ_cfg), 6)
    tp = dict(net.named_parameters())
    for g in grads:
        for path, name_t in names.items():
            tp[name_t].grad = torch.from_numpy(g[path].copy())
        opt.step()
    for path, name_t in names.items():
        ref = np.asarray(functools.reduce(lambda d, k: d[k], path, params))
        np.testing.assert_allclose(tp[name_t].detach().numpy(), ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name_t)
        assert not np.array_equal(ref, init[path]), name_t
    # the optimizer state survives a round trip through its state dict
    again = TT.create_train_state(net, tcfg.EasyDict(det_cfg), tcfg.EasyDict(occ_cfg), 6)
    again.load_state_dict(opt.state_dict())
    assert again.parts["det"].count == 3
