"""The train step (counterpart of `btcdet_tpu/train/trainer.py`): one
loss, one backward, the dual occ / det update, the BN running statistics
moved by the train forward; and what a training loop needs around it.

    opt = create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, total_steps)
    metrics = train_step(net, opt, batch, step_generator(seed, gstep, "cuda"))
    print(read_metrics(metrics))

In a data-parallel run (`parallel.init_dist`) every rank calls the same
functions on its frames of the global batch (`split_batch` cuts a
collated batch the way `datasets.ShardSampler` and collate would): the
step then computes what one process computes on the global batch, and
the ranks leave it with the same parameters, bit for bit (see
`parallel.dist`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from . import optim

# batch keys laid out per frame in row blocks of a fixed capacity, with
# the frame's index in the batch as the first column of the coords
_VOXEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points")


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


def split_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s share of a collated batch of B frames (numpy or
    torch) split over `world` ranks: frames [rank*b, (rank+1)*b), b =
    B / world, exactly what collating those frames alone gives. Keys with
    a leading frame axis are sliced; the voxel tables, B blocks of a
    fixed row capacity, keep their frames' blocks with the frame column
    renumbered from 0 (padding rows keep -1); `frame_id` is sliced."""
    B = len(batch["points"])
    if B % world:
        raise ValueError(f"a batch of {B} frames does not split over {world} ranks")
    b = B // world
    lo = rank * b
    out = {}
    for k, v in batch.items():
        if not k.endswith(_VOXEL_KEYS):
            out[k] = v[lo:lo + b]
            continue
        per = len(v) // B
        part = v[lo * per:(lo + b) * per]
        if k.endswith("voxel_coords"):
            where = torch.where if torch.is_tensor(part) else np.where
            part = part.clone() if torch.is_tensor(part) else part.copy()
            part[:, 0] = where(part[:, 0] >= 0, part[:, 0] - lo, part[:, 0])
        out[k] = part
    return out


def forward_backward(net, batch: dict, generator: torch.Generator) -> dict:
    """The train forward of `net` (put in train mode) on `batch` and the
    backward of its loss into the parameters' `.grad` (cleared first);
    returns the forward's outputs. In a data-parallel run the loss is the
    rank's share of the global loss and the gradients are then summed
    over the ranks (`parallel.all_reduce_grads`): the global batch's
    gradients, the same on every rank."""
    net.train()
    for p in net.parameters():
        p.grad = None
    out = net(batch, generator=generator)
    out["loss"].backward()
    parallel.all_reduce_grads(net)
    return out


def train_step(net, opt: optim.DualOptimizer, batch: dict, generator: torch.Generator,
               keep: dict | None = None) -> dict:
    """One training step of `net` (put in train mode) on `batch`, its
    random draws from `generator`. Returns the loss, every term of
    `loss_dict` (in a data-parallel run summed over the ranks: the
    global batch's) and the per-partition gradient norms, as tensors on
    the run's device (reading them synchronises). `keep`, a dict of output
    names, gets the train forward's outputs under those names, detached
    (None where the forward has none)."""
    out = forward_backward(net, batch, generator)
    names = ["loss", *out["loss_dict"]]
    terms = torch.stack([out["loss"].detach()] + [v.detach().reshape(())
                                                   for v in out["loss_dict"].values()])
    # the global batch's loss terms: the sum of the ranks' shares
    metrics = dict(zip(names, parallel.all_reduce_sum(terms).unbind()))
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
