"""The harness takes its knowledge of a network from the architecture
module of the configuration's `MODEL.NAME` (`benchmark/arch/`).

BtcNet without its occupancy subnet (the port's `config.det_only`) runs
the whole eval cell on the CPU at the micro config, held to the car
cell's limits without the occupancy subnet's two numbers; planted faults
fail it; a `MODEL.NAME` with no module fails at `Cell` load; a limit that
a run did not read makes it not correct; and nothing under
`benchmark/lib/` or in `benchmark/run.py` names BtcNet's structure."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from benchmark.lib import evalcell
from benchmark.lib.spec import Cell, arch_module, load_config
from benchmark.tests.test_bench_faults import _half_batch, _stale_stage

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
TRAFFIC = {"kind": "eval", "batch_size": 2, "pool": 2, "num_points": 2048, "gt": {"Car": 2},
           "mode": "test", "scene_seed": 7, "weight_seed": 2}
CAR_LIMITS = {k: v["limit"] for k, v in
              json.loads((BENCH / "limits" / "car.eval_b8.json").read_text()).items()}
DET_LIMITS = {k: v for k, v in CAR_LIMITS.items() if k not in ("occ_subnet", "occ_rows")}
DET_NUMBERS = {"backbone", "backbone_sites", "rpn", "rpn_boxes", "proposals", "rcnn",
               "rcnn_boxes", "final"}


def _det_only_micro() -> dict:
    pytest.importorskip("btcdet_tpu_torch")
    from btcdet_tpu_torch.config import det_only

    return det_only(load_config(HERE / "micro.json"))


def _run(cfg, limits, seed=2**31 + 33, control=False):
    return evalcell.run(cfg, TRAFFIC, seed, 0.5, False, torch.device("cpu"),
                        time.perf_counter(), limits, control=control)


def test_det_only_run_is_correct_on_its_eight_numbers():
    cfg = _det_only_micro()
    assert set(arch_module(cfg).check_names(cfg)) == DET_NUMBERS
    res = _run(cfg, DET_LIMITS, control=True)
    assert set(res["checks"]) == DET_NUMBERS
    assert res["correct"], res["checks"]
    # the control (the reference in float8, box decodes in bfloat16) is not
    ctl = res["control"]
    assert set(ctl) == DET_NUMBERS and not evalcell.judge(ctl, DET_LIMITS)[1], ctl


@pytest.mark.parametrize("fault", [_half_batch, _stale_stage], ids=["half_batch", "stale_stage"])
def test_det_only_planted_fault_is_not_correct(monkeypatch, fault):
    cfg = _det_only_micro()
    fault(monkeypatch)
    res = _run(cfg, DET_LIMITS)
    assert not res["correct"], res["checks"]
    assert any(not v["value"] <= v["limit"] for v in res["checks"].values())


def test_det_only_traced_run_counts_its_flops():
    """A traced run keeps each pool entry's voxel table and counts its
    sparse FLOPs through the reference's MeanVFE and det backbone."""
    import benchmark.run as R

    cfg = _det_only_micro()
    line = R.run_cell(cfg, TRAFFIC, DET_LIMITS, 2**31 + 35, 0.5, True, "cpu", [],
                      [{"name": "eval_mfu", "unit": "%"}])
    assert line["correct"], line["checks"]
    assert line["metrics"]["eval_mfu"]["value"] > 0


def test_micro_check_names_are_the_car_limits():
    cfg = load_config(HERE / "micro.json")
    assert arch_module(cfg).check_names(cfg) == list(CAR_LIMITS)


def test_unknown_model_name_fails_at_cell_load(tmp_path):
    cfg = load_config(HERE / "micro.json")
    cfg["MODEL"]["NAME"] = "NoSuchNet"
    path = tmp_path / "nosuchnet.json"
    path.write_text(json.dumps(cfg))
    bench = {"configs": [{"name": "x", "file": str(path)}],
             "workloads": [{"name": "x.eval", "config": "x", "traffic": "eval_b8", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    with pytest.raises(FileNotFoundError, match=re.escape(str(BENCH / "arch" / "nosuchnet.py"))):
        Cell("x.eval", bench)


def test_a_limit_not_read_is_not_correct(monkeypatch):
    """A sound micro run whose architecture module drops one number: the
    limit that was not read makes the run not correct."""
    pytest.importorskip("btcdet_tpu_torch")
    cfg = load_config(HERE / "micro.json")
    arch = arch_module(cfg)
    orig = arch.check

    def check(*a, **kw):
        checks, rec = orig(*a, **kw)
        del checks["rpn"]
        return checks, rec

    monkeypatch.setattr(arch, "check", check)
    res = _run(cfg, CAR_LIMITS, seed=2**31 + 21)
    assert not res["correct"], res["checks"]
    assert res["checks"]["rpn"] == {"value": None, "limit": CAR_LIMITS["rpn"]}
    assert all(v["value"] <= v["limit"] for k, v in res["checks"].items() if k != "rpn")


def test_judge():
    assert evalcell.judge({"a": 1.0}, {"a": 1.0}) == ({"a": {"value": 1.0, "limit": 1.0}}, True)
    assert not evalcell.judge({"a": 2.0}, {"a": 1.0})[1]
    assert not evalcell.judge({"a": 0.0, "b": 0.0}, {"a": 1.0})[1]     # no limit for b
    assert not evalcell.judge({"a": 0.0}, {"a": 1.0, "b": 0.0})[1]     # b not read


def test_harness_names_no_architecture():
    words = re.compile(r"btcnet|occ_modules|det_modules|btcref\.models", re.IGNORECASE)
    found = [f"{p.relative_to(BENCH)}:{i}" for p in [*sorted((BENCH / "lib").rglob("*.py")),
                                                     BENCH / "run.py"]
             for i, line in enumerate(p.read_text().splitlines(), 1) if words.search(line)]
    assert not found, found
