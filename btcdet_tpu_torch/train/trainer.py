"""The train step (counterpart of `btcdet_tpu/train/trainer.py`): one
loss, one backward, the dual occ / det update, the BN running statistics
moved by the train forward.

    opt = create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, total_steps)
    metrics = train_step(net, opt, batch, torch.Generator(device="cuda").manual_seed(0))
"""

from __future__ import annotations

import torch

from . import optim


def frozen_partitions(det_cfg, occ_cfg) -> tuple:
    """Partitions whose LR is 0 (reference staged training: `--pre_occ`
    and OCC_OPTIMIZATION.LR 0 freeze the occ subnet)."""
    out = []
    if det_cfg is not None and float(det_cfg.LR) == 0.0:
        out.append("det")
    if occ_cfg is not None and float(occ_cfg.LR) == 0.0:
        out.append("occ")
    return tuple(out)


def create_train_state(net, det_cfg, occ_cfg, total_steps: int) -> optim.DualOptimizer:
    """The dual optimizer over `net`'s parameters. The parameters of a
    frozen partition stop requiring a gradient, so the backward skips
    them."""
    frozen = frozen_partitions(det_cfg, occ_cfg)
    for name, p in net.named_parameters():
        part = "occ" if name.startswith(optim.OCC_PREFIX) else "det"
        p.requires_grad_(part not in frozen)
    return optim.DualOptimizer(net.named_parameters(), det_cfg, occ_cfg, total_steps)


def train_step(net, opt: optim.DualOptimizer, batch: dict, generator: torch.Generator) -> dict:
    """One training step of `net` (put in train mode) on `batch`, its
    random draws from `generator`. Returns the loss, every term of
    `loss_dict` and the per-partition gradient norms, as tensors on the
    run's device (reading them synchronises)."""
    net.train()
    for p in net.parameters():
        p.grad = None
    out = net(batch, generator=generator)
    out["loss"].backward()
    metrics = {"loss": out["loss"].detach()}
    metrics.update({k: v.detach() for k, v in out["loss_dict"].items()})
    metrics.update(opt.step())
    return metrics
