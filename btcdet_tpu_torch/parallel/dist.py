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

Outside a data-parallel run `data_parallel_group()` is None and every
helper here is the one-process identity.
"""

from __future__ import annotations

import datetime
import os
import re

import torch
import torch.distributed as dist

# the data-parallel group: process-wide, as torch.distributed's own default
# group is, because the model's layers read it deep inside a step
_GROUP = None

_ENV = {
    "pytorch": ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"),
    "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "MASTER_ADDR"),
}


def data_parallel_group():
    """The process group of the data-parallel run, or None."""
    return _GROUP


def _set_group(group):
    """Make `group` (None: none) the data-parallel group; returns the one
    it replaces."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    return prev


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
              timeout_s: float = 1800.0) -> int:
    """Join the process group of a `launcher` ("pytorch": torchrun's
    RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT; "slurm":
    SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID and MASTER_ADDR, the port
    MASTER_PORT or `tcp_port`) over `backend` ("nccl" or "gloo"), and make
    it the data-parallel group. Returns the local rank, whose device is
    `utils.common.resolve_device(device, local_rank)`.

    NCCL needs a device of its own for every rank of a node: with more
    ranks than visible devices it raises (gloo may share one). A
    collective that fails, or waits longer than `timeout_s`, raises."""
    rank, world, local, local_world, addr, port = _launch_env(launcher, tcp_port)
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
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    _set_group(dist.group.WORLD)
    return local


def destroy():
    """Leave the data-parallel group and its process group."""
    if _set_group(None) is not None:
        dist.destroy_process_group()


def get_dist_info() -> tuple:
    """(rank, world size) in the data-parallel group; (0, 1) outside one."""
    if _GROUP is None:
        return 0, 1
    return dist.get_rank(_GROUP), dist.get_world_size(_GROUP)


def global_rows(n: int) -> tuple:
    """(rows of the global batch, this rank's first row) for a leading
    extent of `n` rows a rank: (W*n, r*n)."""
    rank, world = get_dist_info()
    return world * n, rank * n


def all_reduce_sum(t: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """The sum of `t` over the ranks (`t` itself outside a run).
    `differentiable` reduces through an autograd function whose backward
    sums the gradient over the ranks in turn (as `torch.distributed.nn`'s
    all_reduce); otherwise `t` is detached."""
    if _GROUP is None:
        return t
    if differentiable:
        return _AllReduceSum.apply(t)
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_GROUP)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dx = the sum of dy over the ranks
    (every rank's loss depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_GROUP)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=_GROUP)
        return dx


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
    if _GROUP is None:
        return
    state = [t for t in list(net.parameters()) + list(net.buffers())]
    for ts in _flat_groups(state).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=_GROUP)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def all_reduce_grads(net: torch.nn.Module):
    """Sum the gradients of `net`'s trainable parameters over the ranks,
    in one coalesced buffer in the parameters' order (a missing gradient
    counts as zero, and every trainable parameter leaves with one). The
    sum is the same on every rank, bit for bit."""
    if _GROUP is None:
        return
    params = [p for p in net.parameters() if p.requires_grad]
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_GROUP)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()


def barrier():
    if _GROUP is not None:
        dist.barrier(group=_GROUP)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` on every rank (`obj` itself outside a run)."""
    if _GROUP is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_GROUP)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's `obj`, in rank order, on every rank."""
    if _GROUP is None:
        return [obj]
    out = [None] * dist.get_world_size(_GROUP)
    dist.all_gather_object(out, obj, group=_GROUP)
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
