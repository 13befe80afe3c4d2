"""The benchmark's own count of the work a batch needs: operations and
bytes of the port's hand-written kernels K1 (sparse-conv gather-GEMM) and
K4 (trilinear sampler), and the model's FLOPs.

Everything is counted from what the frozen reference (`reference.btcref`) finds on
the same inputs: the active sites and matched (input, output, tap)
pairs of every sparse conv, the valid sample points of every trilinear
pool, and the shapes of every dense conv and linear layer. Nothing is
read from the port, so a change to how the port pairs sites or samples
cannot move the count.

Bytes count each input byte read once and each output byte written once,
in the dtypes the configuration states (bfloat16 activations and
weights; K1 writes float32 rows).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.overrides import TorchFunctionMode

# published peaks of one H100 SXM (dense, no sparsity) and its HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

BF16, F32 = 2, 4


def k1_work(pairs: int, n_in: int, m_out: int, taps: int, cin: int, cout: int) -> tuple:
    """(flops, bytes) of one sparse-conv gather-GEMM: a multiply-add for
    every matched pair and channel pair; the input rows, the weights and
    the output rows once."""
    flops = 2 * pairs * cin * cout
    nbytes = n_in * cin * BF16 + taps * cin * cout * BF16 + m_out * cout * F32
    return flops, nbytes


def k4_work(samples: int, cells: int, rois: int, points: int, channels: int) -> tuple:
    """(flops, bytes) of one trilinear pool: 8 corners, a multiply-add per
    corner and channel of every valid sample; the distinct volume cells
    the samples touch, the sample coordinates and validity, and the
    (rois, points, channels) output once."""
    flops = 16 * samples * channels
    nbytes = (cells * channels * BF16 + rois * points * (3 * F32 + 1)
              + rois * points * channels * BF16)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def trilinear_cells(zyx: torch.Tensor, valid: torch.Tensor, roi_b: torch.Tensor, dhw) -> int:
    """Distinct in-volume (frame, cell) corners of the valid samples."""
    D, H, W = dhw
    p = zyx[valid]
    b = roi_b[:, None].expand(valid.shape)[valid].long()
    base = torch.floor(p).long()
    keys = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                z, y, x = base[:, 0] + dz, base[:, 1] + dy, base[:, 2] + dx
                inb = (z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
                keys.append((((b * D + z) * H + y) * W + x)[inb])
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


class _DenseFlops(TorchFunctionMode):
    """FLOPs of the dense convs and linear layers that run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in ("conv1d", "conv2d", "conv3d"):
            # weight (Cout, Cin / groups, *k)
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.flops += 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])
        elif name in ("conv_transpose1d", "conv_transpose2d", "conv_transpose3d"):
            # weight (Cin, Cout / groups, *k): every input element feeds them all
            x = args[0]
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.flops += 2 * x.numel() * w.shape[1] * math.prod(w.shape[2:])
        elif name == "linear":
            x, w = args[0], args[1]
            self.flops += 2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1]
        return out


class WorkRecorder:
    """Records, while the reference runs, every sparse conv's pairs
    (`k1`), every trilinear pool's samples (`k4`) and the dense convs' and
    linear layers' FLOPs (`dense_flops`). Use as a context manager around
    reference calls."""

    def __init__(self):
        self.k1 = []      # (pairs, n_in, m_out, taps, cin, cout)
        self.k4 = []      # (samples, cells, rois, points, channels)
        self.dense_flops = 0
        self._stack = None

    def sparse_flops(self) -> int:
        return sum(k1_work(*c)[0] for c in self.k1)

    def flops(self) -> int:
        return self.dense_flops + self.sparse_flops()

    def __enter__(self):
        from ..reference.btcref.ops import cuda_conv, cuda_interp

        stack = contextlib.ExitStack()
        rec = self
        conv_fn, pool_fn = cuda_conv.sparse_conv, cuda_interp.trilinear_pool

        def sparse_conv(features, in_keys, out_coords, weights, *a, nbr=None, **kw):
            out = conv_fn(features, in_keys, out_coords, weights, *a, nbr=nbr, **kw)
            if nbr is None:
                nbr = cuda_conv.neighbor_map_plain(in_keys, out_coords, *a[:1], *a[2:5])
            pairs = int((nbr >= 0).sum().item())
            n_in = int((in_keys != 2**31 - 1).sum().item())
            m_out = int((out_coords[:, 0] >= 0).sum().item())
            rec.k1.append((pairs, n_in, m_out, weights.shape[0], weights.shape[1],
                           weights.shape[2]))
            return out

        def trilinear_pool(volume, zyx, roi_b, valid):
            out = pool_fn(volume, zyx, roi_b, valid)
            B, D, H, W, C = volume.shape
            R, S, _ = zyx.shape
            rec.k4.append((int(valid.sum().item()), trilinear_cells(zyx, valid, roi_b, (D, H, W)),
                           R, S, C))
            return out

        cuda_conv.sparse_conv, cuda_interp.trilinear_pool = sparse_conv, trilinear_pool
        stack.callback(setattr, cuda_conv, "sparse_conv", conv_fn)
        stack.callback(setattr, cuda_interp, "trilinear_pool", pool_fn)
        dense = _DenseFlops()
        stack.enter_context(dense)
        stack.callback(lambda: setattr(rec, "dense_flops", rec.dense_flops + dense.flops))
        self._stack = stack
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False
