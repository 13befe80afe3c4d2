"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload car.eval_b8 --seed 7 --seconds 30 --trace 0

The cell (`BENCHMARK.json`'s `workloads`) names a configuration file
(`benchmark/configs/`) and a traffic file (`benchmark/traffic/`); its
limits for the comparison with the reference are in
`benchmark/limits/<workload>.json` and each per-layer metric is read by
`benchmark/metrics/<metric>.py`. With `--trace 0` the result carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics and a
breakdown, read from a profiler trace of the window. The last line of
standard output is one JSON object; the numbers compared with the
reference, each beside its limit, end standard error.

Needs a CUDA device: without one it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "btcdet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(cfg: dict, traffic: dict, limits: dict, seed: int, seconds: float, trace: bool,
             device, end_to_end: list, per_layer: list) -> dict:
    """The result line of one run (without its device entry)."""
    import torch

    from benchmark.lib import evalcell

    if traffic["kind"] != "eval":
        raise NotImplementedError(f"traffic kind {traffic['kind']!r}")
    res = evalcell.run(cfg, traffic, seed, seconds, trace, torch.device(device), T_START,
                       limits)
    line = {"correct": res["correct"], "attempted": res["frames"], "failed": 0}
    if not trace:
        line["metrics"] = {m["name"]: {"value": res[m["name"]], "unit": m["unit"]}
                           for m in end_to_end}
    else:
        from benchmark.lib.layers import Layers
        from benchmark.lib.spec import arch_module, metric_reader

        t0 = time.perf_counter()
        layers = Layers(res["trace"], arch_module(cfg).STAGES, torch.device(device))
        print(f"after the window: trace and work counts {time.perf_counter() - t0:.2f} s",
              file=sys.stderr)
        metrics = {}
        for m in per_layer:
            v = metric_reader(m["name"])(layers)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line["metrics"] = metrics
        line["trace"] = {"busy_s": layers.t.busy_s(), "window_s": layers.t.window_s}
        line["breakdown"] = layers.breakdown()
    line["checks"] = res["checks"]
    line["peak"] = res["peak"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib.spec import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line = run_cell(cell.config(), cell.traffic(), cell.limits(), args.seed, args.seconds,
                    bool(args.trace), "cuda", cell.end_to_end, cell.per_layer)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(line.pop("peak"))}
    if "trace" in line:
        device.update(line.pop("trace"))
    checks = line.pop("checks")
    line["device"] = device
    line["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
