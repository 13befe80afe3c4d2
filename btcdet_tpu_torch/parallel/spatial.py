"""Row slabs of the BEV maps over the spatial group (the port's
counterpart of the JAX package's `bev_sharding`, under which GSPMD splits
the `[B, H, W, C]` BEV maps' H over the mesh's `sp` axis and adds the halo
exchanges of the 3x3 convs).

Rank s of a spatial group of S ranks holds rows [s*H/S, (s+1)*H/S) of a
(B, C, H, W) map. Three autograd functions move rows between the ranks:

- `take_rows`: this rank's slab of a map every rank holds whole; its
  backward gathers the slabs' gradients, so every rank leaves with the
  whole map's gradient (the stages upstream run the same on every rank);
- `gather_rows`: the whole map from the slabs; its backward takes this
  rank's rows of the gradient (every rank computes the same loss
  downstream, so summing the ranks' gradients would count it S times);
- `halo_rows`: the slab with one row above and one below from the
  neighbouring slabs (zero rows at the map's edges, as ZeroPad2d gives);
  its backward sends each halo row's gradient to the rank that owns the
  row, which adds it to its own.

Each is built from `all_reduce` sums over zero-filled buffers in which a
rank writes only its own rows, so the sums are exact (a value plus zeros)
and the same code runs over gloo, which takes CUDA tensors for
`all_reduce` but not for `send` / `recv`, and over NCCL. bf16 maps travel
as float32 (exact both ways). A failed collective raises: no fallback.

Without a spatial group (outside a run, or sp 1) `take_rows` and
`gather_rows` are the identity and `halo_rows` pads zero rows.

`COMM_MS`, when set to a dict, collects the synchronised wall ms of each
kind of collective ("halo", "take", "gather"; forward and backward) for
a breakdown; it serialises the device, so it is off by default.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .dist import get_sp_info, spatial_group

# a dict here collects the synchronised ms of the collectives by kind
COMM_MS = None


def _all_reduce(buf: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum `buf` over the spatial group in place (in float32 when it is a
    16-bit float); returns it in its own dtype."""
    wire = buf.float() if buf.dtype in (torch.bfloat16, torch.float16) else buf
    timed = COMM_MS is not None
    if timed:
        if wire.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=spatial_group())
    if timed:
        if wire.is_cuda:
            torch.cuda.synchronize()
        COMM_MS[kind] = COMM_MS.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
    return wire.to(buf.dtype) if wire is not buf else buf


def _slab(H: int, what: str) -> tuple:
    """(this rank's first row, rows a slab) of a map of H rows."""
    s, S = get_sp_info()
    if H % S:
        raise ValueError(f"{what}: {H} rows do not split over {S} spatial ranks")
    h = H // S
    return s * h, h


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        lo, h = _slab(x.shape[2], "take_rows")
        ctx.lo, ctx.H = lo, x.shape[2]
        return x[:, :, lo:lo + h].contiguous()

    @staticmethod
    def backward(ctx, dy):
        B, C, h, W = dy.shape
        buf = dy.new_zeros((B, C, ctx.H, W))
        buf[:, :, ctx.lo:ctx.lo + h] = dy
        return _all_reduce(buf, "take")


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        B, C, h, W = x.shape
        s, S = get_sp_info()
        lo = s * h
        ctx.lo, ctx.h = lo, h
        buf = x.new_zeros((B, C, h * S, W))
        buf[:, :, lo:lo + h] = x
        return _all_reduce(buf, "gather")

    @staticmethod
    def backward(ctx, dy):
        return dy[:, :, ctx.lo:ctx.lo + ctx.h].contiguous()


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s, S = get_sp_info()
        ctx.s, ctx.S = s, S
        edges = x.new_zeros((S, 2) + x[:, :, 0].shape)
        edges[s, 0], edges[s, 1] = x[:, :, 0], x[:, :, -1]
        edges = _all_reduce(edges, "halo")
        zero = torch.zeros_like(x[:, :, :1])
        top = edges[s - 1, 1][:, :, None] if s > 0 else zero
        bottom = edges[s + 1, 0][:, :, None] if s < S - 1 else zero
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, dy):
        s, S = ctx.s, ctx.S
        dx = dy[:, :, 1:-1].clone()
        edges = dy.new_zeros((S, 2) + dy[:, :, 0].shape)
        if s > 0:
            edges[s - 1, 1] = dy[:, :, 0]
        if s < S - 1:
            edges[s + 1, 0] = dy[:, :, -1]
        edges = _all_reduce(edges, "halo")
        dx[:, :, 0] += edges[s, 0]
        dx[:, :, -1] += edges[s, 1]
        return dx


def take_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's row slab of the whole (B, C, H, W) map `x`."""
    return x if spatial_group() is None else _TakeRows.apply(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole (B, C, S*h, W) map from every rank's (B, C, h, W) slab."""
    return x if spatial_group() is None else _GatherRows.apply(x)


def halo_rows(x: torch.Tensor) -> torch.Tensor:
    """The (B, C, h+2, W) slab: the row above from the rank above, the row
    below from the rank below, zero rows at the map's top and bottom."""
    if spatial_group() is None:
        return torch.nn.functional.pad(x, (0, 0, 1, 1))
    return _HaloRows.apply(x)
