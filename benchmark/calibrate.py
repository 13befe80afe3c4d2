"""Readings that the limits of the comparison with the reference are set
from: the program's numbers over many seeds and the control's (the
reference computed in the control's precision, `reference/lowp.py`, in
the program's place) on the same batches, at the cell's own size.

    python3 benchmark/calibrate.py --workload car.eval_b8 --seeds 1-12 --control 3 \\
        --seconds 3 --out cal_car.json

Each seed runs a short window of the cell's own traffic; the first
`--control` seeds also read the control. Prints one line a seed and
writes every reading to `--out`. The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import evalcell
    from benchmark.lib.spec import Cell

    import torch

    cell = Cell(args.workload)
    rows = []
    for i, seed in enumerate(seeds_of(args.seeds)):
        t0 = time.perf_counter()
        res = evalcell.run(cell.config(), cell.traffic(), seed, args.seconds, False,
                           torch.device(args.device), t0, {}, control=i < args.control)
        row = {"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
               "control": res.get("control"), "eval_fps": res["eval_fps"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del res
        if args.device == "cuda":
            torch.cuda.empty_cache()
    keys = rows[0]["program"]
    summary = {k: {"lower": max(r["program"][k] for r in rows),
                   "upper": min((r["control"][k] for r in rows if r["control"]), default=None)}
               for k in keys}
    print("summary " + json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
