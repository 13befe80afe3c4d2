"""The dual `adam_onecycle` optimizer (counterpart of
`btcdet_tpu/train/optim.py`, reference `tools/train_utils/optimization/`).

Written out rather than taken from `torch.optim.AdamW`, whose eps and
weight decay sit elsewhere. Per partition, in the order of the JAX
package's optax chain:

  1. clip the partition's gradients to a global norm of GRAD_NORM_CLIP;
  2. Adam (b1 from the fastai OneCycle momentum schedule, b2 = 0.99,
     eps = 1e-8 added outside the square root, optax `scale_by_adam`);
  3. decoupled weight decay on conv and linear kernels (parameters of two
     or more dimensions; not BN affines, not biases): + WEIGHT_DECAY * p;
  4. scale by minus the fastai OneCycle learning rate, and add to p.

Parameters under `occ_modules.` take OCC_OPTIMIZATION, all others
OPTIMIZATION (reference `optimization/__init__.py:11-16`); a partition
whose LR is 0 is frozen.
"""

from __future__ import annotations

import math

import torch

OCC_PREFIX = "occ_modules."


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float, div_factor: float):
    """fastai OneCycle LR: cosine from max_lr / div_factor up to max_lr over
    pct_start of the steps, then cosine down to max_lr / 1e4."""
    up = max(int(total_steps * pct_start), 1)
    down = max(total_steps - up, 1)

    def sched(step: int) -> float:
        step = min(step, total_steps)
        if step < up:
            return (0.5 * (max_lr / div_factor + max_lr)
                    - 0.5 * (max_lr - max_lr / div_factor) * math.cos(math.pi * step / up))
        t = min(max((step - up) / down, 0.0), 1.0)
        return 0.5 * (max_lr / 1e4 + max_lr) + 0.5 * (max_lr - max_lr / 1e4) * math.cos(math.pi * t)

    return sched


def onecycle_momentum(moms, total_steps: int, pct_start: float):
    """fastai OneCycle momentum: moms[0] -> moms[1] -> moms[0]."""
    hi, lo = float(moms[0]), float(moms[1])
    up = max(int(total_steps * pct_start), 1)
    down = max(total_steps - up, 1)

    def sched(step: int) -> float:
        step = min(step, total_steps)
        if step < up:
            return hi + (lo - hi) * 0.5 * (1 - math.cos(math.pi * step / up))
        t = min(max((step - up) / down, 0.0), 1.0)
        return lo + (hi - lo) * 0.5 * (1 - math.cos(math.pi * t))

    return sched


class AdamOneCycle:
    """One partition's `adam_onecycle` chain over a list of (name, param)."""

    def __init__(self, named_params, opt_cfg, total_steps: int):
        if opt_cfg.OPTIMIZER != "adam_onecycle":
            raise NotImplementedError(f"optimizer {opt_cfg.OPTIMIZER}")
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr = onecycle_lr(float(opt_cfg.LR), total_steps, float(opt_cfg.PCT_START),
                              float(opt_cfg.DIV_FACTOR))
        self.b1 = onecycle_momentum(opt_cfg.MOMS, total_steps, float(opt_cfg.PCT_START))
        self.b2, self.eps = 0.99, 1e-8
        self.wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
        self.clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0.0))
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' `.grad` (None counts as
        zero); returns the partition's gradient norm before clipping."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float() for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads)) if grads else torch.zeros(())
        if self.clip > 0:
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = [g * scale for g in grads]
        n = self.count
        b1, lr = self.b1(n), self.lr(n)
        c1, c2 = 1.0 - b1 ** (n + 1), 1.0 - self.b2 ** (n + 1)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.wd > 0 and p.ndim >= 2:
                upd = upd + self.wd * p
            p.add_(-lr * upd)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """{count, mu, nu}, the moments keyed by parameter name."""
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if sorted(state["mu"]) != sorted(self.names):
            raise KeyError("optimizer state names differ from the partition's parameters")
        for i, n in enumerate(self.names):
            self.mu[i].copy_(state["mu"][n])
            self.nu[i].copy_(state["nu"][n])
        self.count = int(state["count"])


class DualOptimizer:
    """The occ / det split: {partition: AdamOneCycle or None (frozen)}."""

    def __init__(self, named_params, det_cfg, occ_cfg, total_steps: int):
        named = list(named_params)
        occ_cfg = det_cfg if occ_cfg is None else occ_cfg
        self.parts = {}
        for part, cfg in (("det", det_cfg), ("occ", occ_cfg)):
            sel = [(n, p) for n, p in named if (part == "occ") == n.startswith(OCC_PREFIX)]
            self.parts[part] = AdamOneCycle(sel, cfg, total_steps) if float(cfg.LR) > 0 else None

    def step(self) -> dict:
        """One update of every partition that is not frozen; returns
        {"grad_norm_<part>": norm before clipping}."""
        return {f"grad_norm_{part}": opt.step() for part, opt in self.parts.items()
                if opt is not None}

    def state_dict(self) -> dict:
        """{partition: its state, or None when frozen}."""
        return {part: None if opt is None else opt.state_dict()
                for part, opt in self.parts.items()}

    def load_state_dict(self, state: dict):
        for part, opt in self.parts.items():
            if (opt is None) != (state.get(part) is None):
                raise ValueError(f"partition {part!r}: frozen in one state and not the other")
            if opt is not None:
                opt.load_state_dict(state[part])
