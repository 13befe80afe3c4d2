"""Data parallelism across processes (counterpart of
`btcdet_tpu/parallel/mesh.py`, reference `btcdet/utils/common_utils.py:114-195`).

One process per GPU, as PyTorch does it: `init_dist` joins the process
group from torchrun's environment (`--launcher pytorch`) or SLURM's
(`--launcher slurm`) and makes it the data-parallel group the model reads.
With W ranks of b frames each, the step on rank r holds frames
[r*b, (r+1)*b) of a global batch of W*b frames and computes what one
process computes on that global batch -- the JAX package's GSPMD
semantics (`btcdet_tpu/train/trainer.py:93-120`):

- batch norms in train mode take the global batch's statistics
  (`all_reduce_sum(..., differentiable=True)`, so the backward carries
  the cross-rank terms), summed in float64 and rounded to float32 once:
  the same bits however the frames are split, so a rank's forward is the
  one-process forward of its frames and a ReLU or a top-k near a tie
  decides as it does in one process;
- each rank's loss is its share of the global loss: frame-count
  normalisers divide by W*b (`global_rows`), batch-wide counts are summed
  over ranks; the gradients are then summed, not averaged
  (`all_reduce_grads`), and every rank applies the same update;
- each rank's random draws are its rows of the draws one process makes
  for the global batch from the same generator (`global_rows`).

With `init_dist(..., sp=S)` the W ranks form a dp x sp grid of W/S
data-parallel rows of S ranks each, rank = d*S + s (the JAX package's
`devices.reshape(dp, sp)` under a `('dp', 'sp')` mesh). The S ranks of a
row hold the same frames and split the BEV pyramid by rows
(`models.backbones_2d.BaseBEVBackbone(row_sharded=True)`, the JAX
package's `bev_sharding`):

- `data_parallel_group()` joins the ranks with the same s: sums over
  frames (the sparse and the occ batch norms, the loss normalisers, the
  step's metrics) run over it, as sp ranks hold the same frames;
- `spatial_group()` joins the ranks with the same d: the BEV row slabs'
  halo rows and gathers run over it;
- the BEV batch norms of a row-sharded pyramid sum over every rank
  (`all_reduce_sum(..., over="dp_sp")`), since each holds only its rows;
- `all_reduce_grads` sums the row-sharded parameters' gradients over sp
  first, then every gradient over dp.

`get_dist_info()` and `global_rows()` count frames, so they read the dp
group; `get_sp_info()` reads the spatial group. Outside a run, or with
S = 1, `spatial_group()` is None and every sp helper is the one-process
identity; outside a run `data_parallel_group()` is None too and every
helper here is the one-process identity.
"""

from __future__ import annotations

import datetime
import os
import re

import torch
import torch.distributed as dist

# the run's groups: process-wide, as torch.distributed's own default group
# is, because the model's layers read them deep inside a step. _GROUP: the
# data-parallel group (ranks with this rank's s); _SP_GROUP: the spatial
# group (ranks with this rank's d; None with sp 1); _RUN: every rank
_GROUP = None
_SP_GROUP = None
_RUN = None

_ENV = {
    "pytorch": ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"),
    "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "MASTER_ADDR"),
}


def data_parallel_group():
    """The process group of the data-parallel run, or None."""
    return _GROUP


def spatial_group():
    """The process group that splits the BEV rows of this rank's frames
    (the ranks with this rank's d), or None (outside a run, or sp 1)."""
    return _SP_GROUP


def _set_groups(dp, sp=None, run=None):
    """Make `dp` / `sp` / `run` (None: none) the run's groups; returns the
    data-parallel group they replace."""
    global _GROUP, _SP_GROUP, _RUN
    prev = _GROUP
    _GROUP, _SP_GROUP, _RUN = dp, sp, run if run is not None else dp
    return prev


def _grid_groups(world: int, sp: int, timeout):
    """(dp group, sp group) of this rank in a dp x sp grid of `world`
    ranks, rank = d*sp + s. Every rank creates every group, in the same
    order, as `dist.new_group` requires."""
    if sp == 1:
        return dist.group.WORLD, None
    rank, dp = dist.get_rank(), world // sp
    mine = {}
    for s in range(sp):
        g = dist.new_group([d * sp + s for d in range(dp)], timeout=timeout)
        if rank % sp == s:
            mine["dp"] = g
    for d in range(dp):
        g = dist.new_group([d * sp + s for s in range(sp)], timeout=timeout)
        if rank // sp == d:
            mine["sp"] = g
    return mine["dp"], mine["sp"]


def _launch_env(launcher: str, tcp_port: int) -> tuple:
    """(rank, world, local rank, local world, master address, port) from
    the launcher's environment; raises when a variable is missing."""
    if launcher not in _ENV:
        raise ValueError(f"unknown launcher {launcher!r}: none, pytorch or slurm")
    env = os.environ
    missing = [k for k in _ENV[launcher] if not env.get(k)]
    if missing:
        where = "torchrun (python -m torch.distributed.run)" if launcher == "pytorch" else \
            "srun, with MASTER_ADDR exported (the first host of SLURM_NODELIST)"
        raise RuntimeError(f"--launcher {launcher} reads {', '.join(_ENV[launcher])} "
                           f"from {where}; missing: {', '.join(missing)}")
    if launcher == "pytorch":
        rank, world, local = (int(env[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        port = int(env["MASTER_PORT"])
    else:
        rank, world, local = (int(env[k]) for k in ("SLURM_PROCID", "SLURM_NTASKS",
                                                    "SLURM_LOCALID"))
        per_node = re.match(r"\d+", env.get("SLURM_NTASKS_PER_NODE", ""))
        local_world = int(per_node.group()) if per_node else world
        port = int(env.get("MASTER_PORT") or tcp_port)
    return rank, world, local, local_world, env["MASTER_ADDR"], port


def init_dist(launcher: str, backend: str, tcp_port: int = 18888,
              timeout_s: float = 1800.0, sp: int = 1) -> int:
    """Join the process group of a `launcher` ("pytorch": torchrun's
    RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT; "slurm":
    SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID and MASTER_ADDR, the port
    MASTER_PORT or `tcp_port`) over `backend` ("nccl" or "gloo"), and lay
    its W ranks out as a dp x sp grid (W/sp data-parallel rows of `sp`
    ranks; sp 1: every rank is data-parallel). Returns the local rank,
    whose device is `utils.common.resolve_device(device, local_rank)`.
    A world size that `sp` does not divide is refused.

    NCCL needs a device of its own for every rank of a node: with more
    ranks than visible devices it raises (gloo may share one). A
    collective that fails, or waits longer than `timeout_s`, raises."""
    rank, world, local, local_world, addr, port = _launch_env(launcher, tcp_port)
    sp = int(sp)
    if sp < 1 or world % sp:
        raise ValueError(f"sp={sp} does not divide the world size {world}: a dp x sp grid "
                         "needs world = dp * sp ranks")
    if backend == "nccl":
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > n_dev:
            raise RuntimeError(
                f"--dist_backend nccl needs one CUDA device a rank: {local_world} ranks on "
                f"this node, {n_dev} visible devices (NCCL refuses two ranks on one device); "
                "start fewer ranks, or use --dist_backend gloo")
        torch.cuda.set_device(local)
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=timeout)
    _set_groups(*_grid_groups(world, sp, timeout), run=dist.group.WORLD)
    return local


def destroy():
    """Leave the run's groups and its process group."""
    if _set_groups(None) is not None:
        dist.destroy_process_group()


def get_dist_info() -> tuple:
    """(rank, world size) in the data-parallel group; (0, 1) outside one."""
    if _GROUP is None:
        return 0, 1
    return dist.get_rank(_GROUP), dist.get_world_size(_GROUP)


def get_sp_info() -> tuple:
    """(rank, size) in the spatial group: this rank's slab of the BEV rows
    and the number of slabs; (0, 1) without one."""
    if _SP_GROUP is None:
        return 0, 1
    return dist.get_rank(_SP_GROUP), dist.get_world_size(_SP_GROUP)


def is_lead() -> bool:
    """True on the run's first rank (the one that writes files), and
    outside a run."""
    return _RUN is None or dist.get_rank() == 0


def global_rows(n: int) -> tuple:
    """(rows of the global batch, this rank's first row) for a leading
    extent of `n` rows a rank: (W*n, r*n)."""
    rank, world = get_dist_info()
    return world * n, rank * n


def _group_of(over: str):
    """The group a sum `over` "dp" (the data-parallel group), "sp" (the
    spatial group) or "dp_sp" (every rank) runs in; None: no sum."""
    if over not in ("dp", "sp", "dp_sp"):
        raise ValueError(f"unknown reduction {over!r}: dp, sp or dp_sp")
    return {"dp": _GROUP, "sp": _SP_GROUP, "dp_sp": _RUN}[over]


def all_reduce_sum(t: torch.Tensor, differentiable: bool = False,
                   over: str = "dp") -> torch.Tensor:
    """The sum of `t` over the ranks of `over` ("dp": the data-parallel
    group, the default; "sp"; "dp_sp": every rank); `t` itself outside a
    run. `differentiable` reduces through an autograd function whose
    backward sums the gradient over the same ranks in turn (as
    `torch.distributed.nn`'s all_reduce); otherwise `t` is detached."""
    group = _group_of(over)
    if group is None:
        return t
    if differentiable:
        return _AllReduceSum.apply(t, group)
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks; dx = the sum of dy over
    them (every rank's loss depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None


def _flat_groups(tensors):
    """{dtype: [tensors]} in the given order."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


@torch.no_grad()
def broadcast_state(net: torch.nn.Module, src: int = 0):
    """Copy rank `src`'s parameters and buffers to every rank, one
    coalesced broadcast per dtype."""
    if _RUN is None:
        return
    state = [t for t in list(net.parameters()) + list(net.buffers())]
    for ts in _flat_groups(state).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=_RUN)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _sum_grads(params, group):
    """Sum the gradients of `params` over `group`, in one coalesced buffer
    in the parameters' order (a missing gradient counts as zero, and every
    parameter leaves with one)."""
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()


def _broadcast_grads(params, group):
    """Every rank of `group` takes its first rank's gradients of `params`,
    in one coalesced buffer (a missing gradient counts as zero)."""
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()


@torch.no_grad()
def all_reduce_grads(net: torch.nn.Module):
    """Sum the gradients of `net`'s trainable parameters over the ranks:
    those of a row-sharded module (`row_sharded` True: each rank's
    gradient is its rows' part) over the spatial group first, then every
    one over the data-parallel group. Every other parameter has the same
    gradient on each rank of a spatial group, so it is not summed there:
    the group's first rank's is taken (a kernel whose float order is not
    fixed would otherwise let the ranks' copies of the weights drift
    apart). The sums are the same on every rank, bit for bit."""
    if _GROUP is None:
        return
    params = [p for p in net.parameters() if p.requires_grad]
    if _SP_GROUP is not None:
        rows = {id(p) for m in net.modules() if getattr(m, "row_sharded", False)
                for p in m.parameters()}
        _sum_grads([p for p in params if id(p) in rows], _SP_GROUP)
        _broadcast_grads([p for p in params if id(p) not in rows], _SP_GROUP)
    _sum_grads(params, _GROUP)


def barrier():
    if _RUN is not None:
        dist.barrier(group=_RUN)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` on every rank (`obj` itself outside a run)."""
    if _RUN is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_RUN)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's `obj`, in rank order, on every rank."""
    if _RUN is None:
        return [obj]
    out = [None] * dist.get_world_size(_RUN)
    dist.all_gather_object(out, obj, group=_RUN)
    return out


def merge_results_dist(parts: list, size: int) -> list:
    """Merge every rank's `parts`, a list of (dataset index, result), into
    the results of indices 0..size-1 in dataset order, on every rank. An
    index a rank holds twice or that a lower rank holds too (the padding
    `datasets.ShardSampler` appends to the last shard) keeps its first
    occurrence in (rank, position) order. Raises unless every index
    appears."""
    out = {}
    for rank_parts in gather_objects(parts):
        for idx, item in rank_parts:
            out.setdefault(int(idx), item)
    if sorted(out) != list(range(size)):
        raise RuntimeError(f"merged results hold indices {sorted(out)[:8]}..., "
                           f"expected 0..{size - 1}")
    return [out[i] for i in range(size)]
