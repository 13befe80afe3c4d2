"""The control of the comparison that decides `correct`: the reference
computed in the nearest precision below the configuration's.

The configuration runs its convolutions, linear layers and sparse
convolutions on bfloat16 operands. The control rounds both operands of
every such product to float8 (e4m3, each tensor scaled so that its
largest magnitude maps to e4m3's largest finite value) and accumulates in
float32, as an fp8 tensor-core product would. Run under `fp8_operands()`.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0

# the products whose operands are rounded: name -> positions of the two operands
_OPERANDS = {
    "conv1d": (0, 1), "conv2d": (0, 1), "conv3d": (0, 1), "conv_transpose1d": (0, 1),
    "conv_transpose2d": (0, 1), "conv_transpose3d": (0, 1), "linear": (0, 1),
    "matmul": (0, 1), "mm": (0, 1), "bmm": (0, 1), "__matmul__": (0, 1),
    "addmm": (1, 2), "baddbmm": (1, 2),
}


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's dtype."""
    if not x.dtype.is_floating_point or x.numel() == 0:
        return x
    amax = x.detach().abs().max().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class fp8_operands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pos = _OPERANDS.get(getattr(func, "__name__", ""))
        if pos is not None:
            args = list(args)
            for i in pos:
                if i < len(args) and isinstance(args[i], torch.Tensor):
                    args[i] = to_fp8(args[i])
        return func(*args, **kwargs)
