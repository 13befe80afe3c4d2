"""The train step (counterpart of `btcdet_tpu/train/trainer.py`): one
loss, one backward, the dual occ / det update, the BN running statistics
moved by the train forward; and what a training loop needs around it.

    opt = create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, total_steps)
    metrics = train_step(net, opt, batch, step_generator(seed, gstep, "cuda"))
    print(read_metrics(metrics))
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


def forward_backward(net, batch: dict, generator: torch.Generator) -> dict:
    """The train forward of `net` (put in train mode) on `batch` and the
    backward of its loss into the parameters' `.grad` (cleared first);
    returns the forward's outputs."""
    net.train()
    for p in net.parameters():
        p.grad = None
    out = net(batch, generator=generator)
    out["loss"].backward()
    return out


def train_step(net, opt: optim.DualOptimizer, batch: dict, generator: torch.Generator,
               keep: dict | None = None) -> dict:
    """One training step of `net` (put in train mode) on `batch`, its
    random draws from `generator`. Returns the loss, every term of
    `loss_dict` and the per-partition gradient norms, as tensors on the
    run's device (reading them synchronises). `keep`, a dict of output
    names, gets the train forward's outputs under those names, detached
    (None where the forward has none)."""
    out = forward_backward(net, batch, generator)
    metrics = {"loss": out["loss"].detach()}
    metrics.update({k: v.detach() for k, v in out["loss_dict"].items()})
    metrics.update(opt.step())
    if keep is not None:
        keep.update({k: None if out.get(k) is None else out[k].detach() for k in keep})
    return metrics


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step `step` of a run seeded `seed`: a
    function of both alone, so a resumed run draws what an unbroken run
    draws at the same step."""
    return torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))


def read_metrics(metrics: dict) -> dict:
    """A step's metrics as Python floats, read back in one copy."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))
