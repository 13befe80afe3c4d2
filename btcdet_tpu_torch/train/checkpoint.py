"""Checkpoints (counterpart of `btcdet_tpu/train/checkpoint.py`, reference
`train_utils.py:272-317` and `detector3d_template.py:594-678`).

A checkpoint is one `checkpoint_step_<step>.pth` file holding
{model_state, optimizer_state, step}: the model's state dict under the
reference BtcDet names, and the dual optimizer's per-partition state.
`CheckpointManager` rotates them, keeping the newest `max_to_keep`;
`load_partial` copies only the occ (or the det) partition, for staged
training (reference `--pre_occ` / `--pre_det`); `load_reference_pth`
reads a checkpoint of the reference BtcDet, {model_state, epoch, it}.

In a data-parallel run rank 0 writes and every rank waits for it; every
rank restores. The file is the one-process format, so a checkpoint moves
between runs of any number of ranks.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from ..parallel import barrier, broadcast_object, is_lead
from .optim import OCC_PREFIX

_NAME = re.compile(r"checkpoint_step_(\d+)\.pth$")
# entries of the reference's state dict the port has no counterpart for:
# its step counter and the constant dilation kernel of its occ targets
REFERENCE_ONLY = ("global_step", "occ_modules.occ_targets.fix_conv_2dzy.weight")


class CheckpointManager:
    def __init__(self, ckpt_dir, max_to_keep: int = 30):
        self.ckpt_dir = Path(ckpt_dir).resolve()
        self.max_to_keep = int(max_to_keep)

    def path(self, step: int) -> Path:
        return self.ckpt_dir / f"checkpoint_step_{int(step)}.pth"

    def all_steps(self) -> list[int]:
        if not self.ckpt_dir.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.ckpt_dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, net: torch.nn.Module, opt=None) -> Path:
        """Write the step's checkpoint (atomically), then drop the oldest
        beyond `max_to_keep`; in a data-parallel run rank 0 writes, and
        every rank returns once it has."""
        out = self.path(step)
        if is_lead():
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            state = {"model_state": {k: v.detach().cpu() for k, v in net.state_dict().items()},
                     "optimizer_state": None if opt is None else _to_cpu(opt.state_dict()),
                     "step": int(step)}
            tmp = out.with_suffix(".tmp")
            torch.save(state, tmp)
            tmp.replace(out)
            for old in self.all_steps()[:-self.max_to_keep]:
                self.path(old).unlink()
        barrier()
        return out

    def restore(self, net: torch.nn.Module, opt=None, step=None):
        """Load a step's checkpoint (the latest by default) into `net` (and
        `opt`), strictly by name; returns the step, or None without one.
        In a data-parallel run the latest step is rank 0's reading."""
        step = broadcast_object(self.latest_step()) if step is None else step
        if step is None:
            return None
        state = load_file(self.path(step))
        net.load_state_dict(state["model_state"], strict=True)
        if opt is not None:
            opt.load_state_dict(state["optimizer_state"])
        return int(state["step"])


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def load_file(path) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def load_partial(ckpt_dir, net: torch.nn.Module, want_occ: bool, step=None) -> int:
    """Copy into `net` the checkpoint's entries (parameters and BN
    statistics) that lie under the occ subnet (`want_occ`) or outside it,
    where the shapes match; the other partition is left as it is (reference
    `load_params_from_file:594-618`). Returns the count copied."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step() if step is None else step
    if step is None:
        return 0
    saved = load_file(mgr.path(step))["model_state"]
    own = net.state_dict()
    take = {k: v for k, v in saved.items()
            if k in own and k.startswith(OCC_PREFIX) == want_occ and v.shape == own[k].shape}
    with torch.no_grad():
        for k, v in take.items():
            own[k].copy_(v)
    return len(take)


def is_reference_pth(state: dict) -> bool:
    return "model_state" in state and "step" not in state


def load_reference_pth(path, net: torch.nn.Module, strict: bool = True) -> dict:
    """Load a reference BtcDet checkpoint {model_state, epoch, it} into the
    port (same module names); the reference-only entries (REFERENCE_ONLY)
    are dropped, every other name must match when `strict`. Returns
    {"epoch", "it"}."""
    return _load_reference(load_file(path), net, strict)


def _load_reference(state: dict, net, strict: bool) -> dict:
    sd = {k: v for k, v in state["model_state"].items() if k not in REFERENCE_ONLY}
    net.load_state_dict(sd, strict=strict)
    return {"epoch": state.get("epoch"), "it": state.get("it")}


def load_any(path, net: torch.nn.Module, opt=None) -> int | None:
    """Load one checkpoint file, the port's or a reference `.pth`, into
    `net` (and `opt`, from a port checkpoint); returns its step (the
    reference's `it`)."""
    state = load_file(path)
    if is_reference_pth(state):
        return _load_reference(state, net, strict=True)["it"]
    net.load_state_dict(state["model_state"], strict=True)
    if opt is not None:
        opt.load_state_dict(state["optimizer_state"])
    return int(state["step"])
