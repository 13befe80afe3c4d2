"""Synthetic weights made on the device from the run's seed.

The laws by state-dict name follow the port's synthetic weights (a frozen
copy of their rules): BN running variances U(0.5, 1.5), running means
N(0, 0.3), BN scales N(1, 0.2), other vectors N(0, 0.05), and conv /
linear weights N(0, 2 / fan_in), the output axis being the last of a
5-d sparse or dense 3-d kernel and the first otherwise. All draws come
from one generator on the device in two calls, in float32, the type the
parameters are held in.
"""

from __future__ import annotations

import math

import torch


def _law(name: str, shape: tuple):
    """(kind, a, b): a tensor of `kind` "zero", "uniform" (a + (b - a) U)
    or "normal" (a + b N)."""
    if name.endswith("num_batches_tracked"):
        return "zero", 0.0, 0.0
    if name.endswith("running_var"):
        return "uniform", 0.5, 1.5
    if name.endswith("running_mean"):
        return "normal", 0.0, 0.3
    if len(shape) <= 1:
        return ("normal", 1.0, 0.2) if name.endswith(".weight") else ("normal", 0.0, 0.05)
    co = shape[-1] if len(shape) == 5 else shape[0]
    fan_in = math.prod(shape) // co
    return "normal", 0.0, math.sqrt(2.0 / fan_in)


def make_state_dict(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for `shapes` ({name: (shape, dtype)}), drawn from
    `seed` on `device`."""
    laws = {k: _law(k, tuple(s)) for k, (s, _) in shapes.items()}
    n_norm = sum(math.prod(shapes[k][0]) for k, law in laws.items() if law[0] == "normal")
    n_unif = sum(math.prod(shapes[k][0]) for k, law in laws.items() if law[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    norm = torch.randn((n_norm,), generator=gen, device=device)
    unif = torch.rand((n_unif,), generator=gen, device=device)
    sd, on, ou = {}, 0, 0
    for k, (shape, dtype) in shapes.items():
        kind, a, b = laws[k]
        n = math.prod(shape)
        if kind == "zero":
            sd[k] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "uniform":
            sd[k] = (unif[ou:ou + n] * (b - a) + a).reshape(shape).to(dtype)
            ou += n
        else:
            sd[k] = (norm[on:on + n] * b + a).reshape(shape).to(dtype)
            on += n
    return sd


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}
