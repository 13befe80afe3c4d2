"""Stage trace of `chip_smoke.py`'s seventh-path f32 check (the
data-parallel train step, 2 ranks x 1 frame, against one process at B=2) on
draws of the small config's output projections, with the ranks' ball
queries replayed in the one-process step and no other choice:

    python tools/dp_f32_diag_torch.py [seed ...]     # default: 1 2 6

ConvHead's train forward and loss are recorded in both runs (the conv
stack's active cells, each layer's ReLU signs, the FC trunks' ReLU signs
and dropout masks, the loss targets, the corner loss's heading choice, and
the gradient at each of those stages). Prints a case's worst gradient
tensors against the ranks' (GRADS), then stage by stage how far each
rank's frame is from the one-process run's (TRACE; a mask: the elements
that differ; a float: the largest difference relative to its max), and
each conv-stack BN's bias gradient summed in float64 from each run's own
per-row gradients beside the cancellation in that sum, the sum of the
terms' magnitudes over the magnitude of the sum (BIAS_SUMS). The ranks run
over gloo on cuda:0 (`torch.multiprocessing`), as the seventh path's do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402

TRACE = []        # one record a ConvHead train forward, in call order


def keep(rec: dict, name: str, t, value: bool = True):
    """`t` (on the host) into rec[name], and its gradient into rec["d_" + name]."""
    if value:
        rec[name] = t.detach().cpu()
    if t.requires_grad:
        t.register_hook(lambda g: rec.__setitem__("d_" + name, g.detach().float().cpu()))


def head_trace():
    """ConvHead's conv stack, FC trunks and loss, as the port runs them,
    recorded into a new TRACE entry a forward."""
    from btcdet_tpu_torch.models.roi_heads import conv_head as CH
    from btcdet_tpu_torch.parallel.dist import global_rows
    from btcdet_tpu_torch.utils import box_utils

    orig_loss = CH.ConvHead.get_loss

    def stack(self, g, m):
        rec = {"_trunks": 0}
        TRACE.append(rec)
        keep(rec, "sampled", g, value=False)
        cd = self.compute_dtype
        act = ((g.abs() > 0).any(dim=1, keepdim=True) & m[:, None, None, None, None]).float()
        rec["act_in"] = act.bool().cpu()
        for n, (blk, (k, s, p)) in enumerate(zip(self.conv_layers[0], self.xc_params)):
            g = getattr(blk, "0")(g, cd)
            ones = torch.ones((1, 1, *k), dtype=torch.float32, device=g.device)
            act = F.conv3d(act, ones, stride=tuple(s), padding=tuple(p)) > 0.5
            rec[f"act{n}"] = act.cpu()
            Rr, Co, dz, dy, dx = g.shape
            rows = g.permute(0, 2, 3, 4, 1).reshape(-1, Co)
            mrows = act.permute(0, 2, 3, 4, 1).reshape(-1)
            keep(rec, f"conv{n}", rows, value=False)
            pre = getattr(blk, "1")(rows, mrows)
            keep(rec, f"bn{n}", pre, value=False)
            rec[f"bn{n}_mask"] = mrows.cpu()
            rec[f"relu{n}"] = (pre > 0).cpu()
            y = torch.relu(pre)
            y = y.reshape(Rr, dz, dy, dx, Co).permute(0, 4, 1, 2, 3)
            g = torch.where(act, y, torch.zeros_like(y))
            keep(rec, f"out{n}", g, value=False)
            act = act.float()
        return g

    def trunk(module, x, mask, dtype, generator=None):
        rec = TRACE[-1]
        t = rec["_trunks"]
        rec["_trunks"] += 1
        keep(rec, f"fc{t}_in", x)
        children = list(module.children())
        for i, m in enumerate(children):
            if isinstance(m, torch.nn.Conv1d):
                if i == len(children) - 1 and m.bias is not None:
                    x = F.linear(x.float(), m.weight[:, :, 0], m.bias)
                else:
                    x = F.linear(x.to(dtype), m.weight[:, :, 0].to(dtype))
            elif isinstance(m, CH.MaskedBatchNorm):
                x = m(x, mask)
            elif isinstance(m, torch.nn.ReLU):
                rec[f"fc{t}_relu{i}"] = (x > 0).cpu()
                x = torch.relu(x)
            elif isinstance(m, torch.nn.Dropout) and m.training:
                rows, lo = global_rows(x.shape[0])
                keep_ = CH.draw_dropout_keep(generator, (rows,) + tuple(x.shape[1:]), 1.0 - m.p)
                keep_ = keep_[lo:lo + x.shape[0]].to(x.device)
                rec[f"fc{t}_drop{i}"] = keep_.cpu()
                x = torch.where(keep_, x / (1.0 - m.p), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))
        return x

    def loss(self, rcnn_cls, rcnn_reg, targets):
        rec = TRACE[-1]
        keep(rec, "rcnn_cls", rcnn_cls)
        keep(rec, "rcnn_reg", rcnn_reg)
        rec["cls_labels"] = targets["rcnn_cls_labels"].reshape(-1).detach().cpu()
        rec["reg_mask"] = targets["reg_valid_mask"].reshape(-1).cpu()
        if self.corner_loss:
            with torch.no_grad():
                rois = targets["rois"].reshape(-1, 7)
                pred = box_utils.boxes_to_corners_3d(self._to_global(rois, rcnn_reg.float()))
                gt = targets["gt_of_rois_src"].reshape(-1, 7)
                flip = torch.cat([gt[:, :6], gt[:, 6:7] + torch.pi, gt[:, 7:]], dim=-1)
                d0 = torch.linalg.norm(pred - box_utils.boxes_to_corners_3d(gt), dim=-1)
                d1 = torch.linalg.norm(pred - box_utils.boxes_to_corners_3d(flip), dim=-1)
                rec["corner_pick"] = (d0 <= d1).cpu()
        return orig_loss(self, rcnn_cls, rcnn_reg, targets)

    CH.ConvHead._conv_stack = stack
    CH._run_trunk = trunk
    CH.ConvHead.get_loss = loss


def small_cases(seeds):
    return {k: v for k, v in cs.f32_cases(seeds).items() if k != "micro"}


def rank_main(rank, io, port, seeds):
    from btcdet_tpu_torch import parallel

    head_trace()
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    parallel.init_dist("pytorch", "gloo", timeout_s=600)
    torch.cuda.set_device(0)
    cs.f32_cases = (lambda f: lambda s=(): {k: v for k, v in f(s).items() if k != "micro"})(
        cs.f32_cases)
    out = cs.dp_f32_cases(io, torch.device("cuda", 0), rank, 2, seeds)
    torch.save(out, os.path.join(io, f"rank{rank}.pt"))
    torch.save(TRACE, os.path.join(io, f"trace{rank}.pt"))
    parallel.destroy()


def compare_traces(ranks: list, one: dict) -> dict:
    """{stage: a mask's differing elements (of how many), or a float's
    largest difference relative to its max}, each rank's frame against the
    one-process run's frames, the worse rank's."""
    out = {}
    for name, v in one.items():
        if not torch.is_tensor(v):
            continue
        worst = 0.0
        for r, rec in enumerate(ranks):
            mine = cs.frames_of(v, [r], 2)
            theirs = rec[name]
            assert mine.shape == theirs.shape, (name, mine.shape, theirs.shape)
            if v.dtype == torch.bool:
                worst = max(worst, int((mine != theirs).sum()))
            else:
                d = float((mine.double() - theirs.double()).abs().max())
                worst = max(worst, d / max(float(mine.double().abs().max()), 1e-30))
        out[name] = (f"{worst} of {v.numel() // 2}" if v.dtype == torch.bool
                     else f"{worst:.3e}")
    return out


def bias_sums(ranks: list, one: dict) -> dict:
    """Each conv-stack BN's bias gradient summed in float64 from each run's
    own per-row gradients at its output: the largest difference between the
    ranks' sum and the one-process run's, relative to its max, and the
    cancellation of that sum (largest over the channels of sum |terms| /
    |sum|)."""
    out = {}
    n = 0
    while f"d_bn{n}" in one:
        full = one[f"d_bn{n}"].double()
        mine = full.sum(0)
        theirs = sum(rec[f"d_bn{n}"].double().sum(0) for rec in ranks)
        ratio = full.abs().sum(0) / mine.abs().clamp(min=1e-300)
        rel = float((mine - theirs).abs().max()) / max(float(mine.abs().max()), 1e-30)
        out[f"bn{n}"] = {"f64_sum_rel": f"{rel:.3e}", "cancellation": f"{float(ratio.max()):.3e}"}
        n += 1
    return out


def main(argv=None):
    from btcdet_tpu_torch.ops import kernel_build

    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", nargs="*", type=int, default=[1, 2, 6])
    args = ap.parse_args(argv)
    kernel_build.build(["sparse_nbr", "sparse_conv", "sparse_conv_dw", "sparse_pool",
                        "trilinear_pool"])
    with tempfile.TemporaryDirectory() as io:
        mp.spawn(rank_main, args=(io, cs.free_port(), args.seeds), nprocs=2)
        head_trace()
        ranks = [torch.load(os.path.join(io, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        traces = [torch.load(os.path.join(io, f"trace{r}.pt"), weights_only=False)
                  for r in range(2)]
        assert all(len(t) == len(traces[0]) for t in traces)
        for c, (name, (fn, p, g, _)) in enumerate(small_cases(args.seeds).items()):
            TRACE.clear()
            _, grads, _, _ = cs.one_process_step(
                fn(), os.path.join(io, f"init_{name}.pt"), 2, p, g, 3,
                torch.Generator(device="cuda").manual_seed(0), f32=True,
                balls=cs.merged_record(ranks, name))
            assert len(TRACE) == 1
            g0 = ranks[0][name]["grads"]
            worst = sorted(cs.grad_distance(g0, grads).items(), key=lambda kv: -kv[1])[:4]
            print("GRADS", name, json.dumps(
                {k: {"max_abs_grad": float(g0[k].abs().max()), "rel": d} for k, d in worst}),
                flush=True)
            per_rank = [t[c] for t in traces]
            print("TRACE", name, json.dumps(compare_traces(per_rank, TRACE[0])), flush=True)
            print("BIAS_SUMS", name, json.dumps(bias_sums(per_rank, TRACE[0])), flush=True)


if __name__ == "__main__":
    main()
