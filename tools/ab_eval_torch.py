"""Compare the port's flagship eval time between two checkouts on one card.

    python tools/ab_eval_torch.py --trees PARENT_DIR CHANGE_DIR [--pairs 12]
        [--runs 20] [--warmup 3] [--out chiprun_out/ab_eval.json]

One worker process per tree (this script with `--worker`, started in that
tree, importing that tree's `btcdet_tpu_torch`) builds the full flagship
(`config.flagship()`, synthetic weights by name, B=2, 16 384 points, as
`chip_smoke.py`'s main path) and waits. Then, pair after pair, each worker
in turn times `--runs` eval forwards + post-processing (each ended by a
synchronisation) after `--warmup` more; the side that runs first alternates
from pair to pair, and only one worker runs at a time. Then each worker, in
the same alternation, times `--runs` forwards stage by stage (the
recorder's `trace.enable(sync=True)`: a device synchronisation around each
stage). Prints, and
writes to `--out`, each tree's median and quartiles over the block medians
and over all runs, the change's block median minus the parent's, pair by
pair, with its median and quartiles, and each tree's median ms per stage.
Passing one tree twice measures the harness itself (an A/A run)."""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PREFIX = "AB "


def worker(runs: int, warmup: int) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from btcdet_tpu_torch import config, weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors.btcnet import STAGES, post_processing
    from btcdet_tpu_torch.utils import trace

    cfg = config.flagship()
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"])
    net.load_state_dict(weights.synth_state_dict(net))
    batch = make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=16384, num_gt=10,
                                 seed=0, mode="test")

    def step():
        post_processing(net(batch), cfg.MODEL.POST_PROCESSING, 1)
        torch.cuda.synchronize()

    step()
    print(PREFIX + json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        for _ in range(warmup):
            step()
        if line.strip() == "run":
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                step()
                times.append((time.perf_counter() - t0) * 1e3)
            print(PREFIX + json.dumps({"ms": times}), flush=True)
        elif line.strip() == "stages":
            per = {}
            for _ in range(runs):
                trace.enable(sync=True, tallies=False)
                try:
                    post_processing(net(batch), cfg.MODEL.POST_PROCESSING, 1)
                finally:
                    rec = trace.disable()
                for k in STAGES:
                    per.setdefault(k, []).append(rec.ms(k))
            print(PREFIX + json.dumps({k: statistics.median(per[k]) for k in STAGES if k in per}),
                  flush=True)
        else:
            break
    return 0


def ask(proc, what: str) -> dict:
    proc.stdin.write(what + "\n")
    proc.stdin.flush()
    return answer(proc)


def answer(proc) -> dict:
    for line in proc.stdout:
        if line.startswith(PREFIX):
            return json.loads(line[len(PREFIX):])
    raise RuntimeError(f"worker exited with {proc.wait()}")


def quartiles(xs) -> list:
    return statistics.quantiles(xs, n=4, method="inclusive")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"))
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.worker:
        return worker(args.runs, args.warmup)
    names = ("parent", "change")
    procs = {n: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--runs", str(args.runs),
         "--warmup", str(args.warmup)], cwd=os.path.abspath(t), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for n, t in zip(names, args.trees)}
    try:
        for p in procs.values():
            answer(p)
        blocks = {n: [] for n in names}
        runs = {n: [] for n in names}
        for i in range(args.pairs):
            for n in (names if i % 2 == 0 else names[::-1]):
                ms = ask(procs[n], "run")["ms"]
                runs[n] += ms
                blocks[n].append(statistics.median(ms))
        stages = {n: [] for n in names}
        for i in range(2):
            for n in (names if i % 2 == 0 else names[::-1]):
                stages[n].append(ask(procs[n], "stages"))
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=60)
    diff = [c - p for p, c in zip(blocks["parent"], blocks["change"])]
    res = {"pairs": args.pairs, "runs": args.runs, "warmup": args.warmup,
           "first": ["parent" if i % 2 == 0 else "change" for i in range(args.pairs)],
           "block_median_ms": blocks,
           "change_minus_parent_ms": diff,
           "change_minus_parent_median_ms": statistics.median(diff),
           "change_minus_parent_quartiles_ms": quartiles(diff),
           "stage_median_ms": stages}
    for n in names:
        res[n] = {"median_of_blocks_ms": statistics.median(blocks[n]),
                  "quartiles_of_blocks_ms": quartiles(blocks[n]),
                  "median_of_runs_ms": statistics.median(runs[n]),
                  "quartiles_of_runs_ms": quartiles(runs[n])}
    text = json.dumps(res)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
