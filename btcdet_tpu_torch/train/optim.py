"""The dual optimizer (counterpart of `btcdet_tpu/train/optim.py`,
reference `tools/train_utils/optimization/`): `adam_onecycle`, `adam`,
`adam_cosine` or `sgd` per partition.

Written out rather than taken from `torch.optim`, whose eps and weight
decay sit elsewhere. Per partition, in the order of the JAX package's optax
chain:

  1. clip the partition's gradients to a global norm of GRAD_NORM_CLIP;
  2. the direction: Adam (optax `scale_by_adam`, eps 1e-8 added outside
     the square root; `adam_onecycle`: b1 from the fastai OneCycle momentum
     schedule, b2 0.99; `adam`, `adam_cosine`: b1 0.9, b2 0.999), or for
     `sgd` the momentum trace g + MOMENTUM * t;
  3. `adam_onecycle` and `adam_cosine` only: decoupled weight decay on
     conv and linear kernels (parameters of two or more dimensions; not BN
     affines, not biases): + WEIGHT_DECAY * p;
  4. scale by minus the learning rate, and add to p. The rate follows the
     fastai OneCycle (`adam_onecycle`), a cosine decay to LR * 1e-4 over
     the run (`adam_cosine`), LR times LR_DECAY at each epoch of
     DECAY_STEP_LIST, at least LR_CLIP (`adam`), or stays LR (`sgd`);
     `adam` and `adam_cosine` under LR_WARMUP first ramp from LR /
     DIV_FACTOR to LR on a cosine over WARMUP_EPOCH epochs.

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


def with_cosine_warmup(sched, opt_cfg, total_steps: int):
    """`sched` behind the reference's CosineWarmupLR where LR_WARMUP is set:
    for WARMUP_EPOCH epochs the rate ramps from LR / DIV_FACTOR to LR on a
    cosine, then `sched` takes over."""
    if not bool(opt_cfg.get("LR_WARMUP", False)):
        return sched
    lr = float(opt_cfg.LR)
    eta_min = lr / float(opt_cfg.get("DIV_FACTOR", 10.0))
    spe = max(total_steps // max(int(opt_cfg.get("NUM_EPOCHS", 1)), 1), 1)
    warm = max(int(opt_cfg.get("WARMUP_EPOCH", 1)) * spe, 1)

    def wrapped(step: int) -> float:
        if step >= warm:
            return sched(step)
        return eta_min + (lr - eta_min) * 0.5 * (1.0 - math.cos(math.pi * step / warm))

    return wrapped


def _schedules(opt_cfg, total_steps: int):
    """(learning rate, Adam b1, Adam b2, weight decay applies) of an
    OPTIMIZATION block; b1 and the rate are functions of the step, b1 None
    for `sgd`."""
    name, lr = opt_cfg.OPTIMIZER, float(opt_cfg.LR)
    if name == "adam_onecycle":
        return (onecycle_lr(lr, total_steps, float(opt_cfg.PCT_START), float(opt_cfg.DIV_FACTOR)),
                onecycle_momentum(opt_cfg.MOMS, total_steps, float(opt_cfg.PCT_START)), 0.99,
                True)
    if name == "adam_cosine":
        def cosine(step: int) -> float:
            t = min(step, total_steps) / total_steps
            return lr * ((1 - 1e-4) * 0.5 * (1 + math.cos(math.pi * t)) + 1e-4)
        return with_cosine_warmup(cosine, opt_cfg, total_steps), lambda step: 0.9, 0.999, True
    if name == "adam":
        spe = max(total_steps // max(int(opt_cfg.get("NUM_EPOCHS", 1)), 1), 1)
        bounds = sorted({int(e) * spe for e in opt_cfg.get("DECAY_STEP_LIST", [])})
        decay, clip = float(opt_cfg.get("LR_DECAY", 0.1)), float(opt_cfg.get("LR_CLIP", 0.0))

        def stepped(step: int) -> float:
            return max(lr * decay ** sum(step >= b for b in bounds), clip)
        return with_cosine_warmup(stepped, opt_cfg, total_steps), lambda step: 0.9, 0.999, False
    if name == "sgd":
        return (lambda step: lr), None, None, False
    raise NotImplementedError(f"optimizer {name}")


class PartitionOptimizer:
    """One partition's chain (the module docstring's steps 1-4) over a list
    of (name, param)."""

    def __init__(self, named_params, opt_cfg, total_steps: int):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.b1, self.b2, decays = _schedules(opt_cfg, total_steps)
        self.eps = 1e-8
        self.momentum = float(opt_cfg.get("MOMENTUM", 0.9))
        self.wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0)) if decays else 0.0
        self.clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0.0))
        # Adam's moments, or the sgd trace in `mu` alone
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                   if self.b1 is not None else [])
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
        lr = self.lr(n)
        if self.b1 is None:
            for p, g, t in zip(self.params, grads, self.mu):
                t.mul_(self.momentum).add_(g)
                p.add_(-lr * t)
        else:
            b1 = self.b1(n)
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
        """{count, mu, nu}, the moments (or the trace, in mu) keyed by
        parameter name."""
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if sorted(state["mu"]) != sorted(self.names) or len(state["nu"]) != len(self.nu):
            raise KeyError("optimizer state names differ from the partition's parameters")
        for i, n in enumerate(self.names):
            self.mu[i].copy_(state["mu"][n])
            if self.nu:
                self.nu[i].copy_(state["nu"][n])
        self.count = int(state["count"])


class DualOptimizer:
    """The occ / det split: {partition: PartitionOptimizer or None (frozen)}."""

    def __init__(self, named_params, det_cfg, occ_cfg, total_steps: int):
        named = list(named_params)
        occ_cfg = det_cfg if occ_cfg is None else occ_cfg
        self.parts = {}
        for part, cfg in (("det", det_cfg), ("occ", occ_cfg)):
            sel = [(n, p) for n, p in named if (part == "occ") == n.startswith(OCC_PREFIX)]
            self.parts[part] = (PartitionOptimizer(sel, cfg, total_steps) if float(cfg.LR) > 0
                                else None)

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
