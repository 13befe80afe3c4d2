"""The port's own init against the JAX package's (`net.init`) on the full
micro config: each parameter drawn by the same law (constant ones equal,
the focal priors of the RPN and the occ head included; drawn ones at the
same spread), and the first train step's loss terms of the two inits on one
batch within a factor of each other. Before the port took the JAX laws its
occ head started without the occupancy prior (occ_loss 0.1994 against
JAX's 1.9978 on this batch) and its torch layers at torch's own law."""

import numpy as np
import pytest
import torch

from torch_parity import f32_mode, full_micro_cfgs, init_jax, to_np_tree

from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch import weights as W
from btcdet_tpu_torch.datasets.mini_config import mini_opt_cfg

# a drawn tensor's spread is compared where it has this many elements
MIN_DRAWN = 64
SPREAD = 1.3          # the std ratio allowed between two draws of one law
FIRST_LOSS = 1.5      # and between the two inits' first loss terms


@pytest.fixture(scope="module")
def inits():
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
    from btcdet_tpu.models import build_network as jax_build
    from btcdet_tpu_torch.models import build_network

    data_cfg, model_cfg = full_micro_cfgs()
    with f32_mode():
        batch = jax_batch(data_cfg, batch_size=2, num_points=2048, num_gt=4, seed=0,
                          mode="train")
        variables = to_np_tree(init_jax(jax_build(model_cfg, data_cfg, ["Car"]), batch))
    mapping = dict(dp_ratio=float(model_cfg.ROI_HEAD.DP_RATIO),
                   upsample_strides=model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES)
    tc = tcfg.EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
    torch.manual_seed(0)
    port = build_network(tc.MODEL, tc.DATA_CONFIG, ["Car"], device="cpu")
    return tc, batch, W.from_jax_variables(variables, **mapping), port


def test_port_init_draws_by_the_jax_law(inits):
    _, _, ref, port = inits
    drawn = 0
    for k, v in port.state_dict().items():
        if not v.is_floating_point():
            continue
        r = torch.as_tensor(np.asarray(ref[k])).float()
        if v.numel() < 2 or float(r.std()) == 0.0:
            torch.testing.assert_close(v.float(), r, rtol=0, atol=1e-6, msg=k)
        elif v.numel() >= MIN_DRAWN:
            ratio = float(v.float().std()) / float(r.std())
            assert 1 / SPREAD < ratio < SPREAD, (k, ratio)
            drawn += 1
    assert drawn >= 20, drawn


def test_first_step_loss_of_both_inits(inits):
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import trainer as TT

    tc, batch, ref, port = inits
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    terms = {}
    for name, state in (("jax", ref), ("port", port.state_dict())):
        net = build_network(tc.MODEL, tc.DATA_CONFIG, ["Car"], device="cpu")
        net.load_state_dict(state, strict=True)
        opt = TT.create_train_state(net, tcfg.EasyDict(mini_opt_cfg(0.01)),
                                    tcfg.EasyDict(mini_opt_cfg(0.003)), 50)
        with f32_mode():
            m = TT.train_step(net, opt, tb, torch.Generator().manual_seed(0))
        terms[name] = {k: float(v) for k, v in m.items()}
    print(terms)
    for k in ("loss", "occ_loss", "rpn_loss_cls", "rpn_loss_loc", "rcnn_loss_cls"):
        ratio = terms["port"][k] / terms["jax"][k]
        assert 1 / FIRST_LOSS < ratio < FIRST_LOSS, (k, terms)
