"""The frozen reference against the port's CPU path at the micro config,
and what the reference and the benchmark may import."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import weights
from benchmark.lib.spec import arch_module, load_config
from benchmark.reference import stages
from benchmark.traffic import generator as G

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
TRAFFIC = {"kind": "eval", "batch_size": 2, "pool": 1, "num_points": 2048, "gt": {"Car": 2},
           "mode": "test", "scene_seed": 7, "weight_seed": 2}


def _port_run(cfg, sd, batch):
    """The port's eval forward on the CPU, float32 everywhere, with the
    stage outputs its modules returned."""
    from btcdet_tpu_torch.config import EasyDict
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.detectors import btcnet
    from btcdet_tpu_torch.utils.common import float32_everywhere

    c = EasyDict(cfg)
    with float32_everywhere():
        net = build_network(c.MODEL, c.DATA_CONFIG, list(c.CLASS_NAMES), device="cpu")
        net.load_state_dict(sd)
        cap = arch_module(cfg).Capture(net, c)
        out = net(batch)
        post = btcnet.post_processing(out, c.MODEL.POST_PROCESSING, 1, "cpu")
    return cap, out, post


@pytest.fixture(scope="module")
def micro():
    pytest.importorskip("btcdet_tpu_torch")
    cfg = load_config(HERE / "micro.json")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in G.make_pool(cfg, TRAFFIC, 2**31 + 3)[0].items()}
    from btcdet_tpu_torch.config import EasyDict
    from btcdet_tpu_torch.models import build_network

    c = EasyDict(cfg)
    shapes = weights.shapes_of(build_network(c.MODEL, c.DATA_CONFIG, ["Car"], device="cpu"))
    sd = weights.make_state_dict(shapes, 2**31 + 3, "cpu")
    return cfg, sd, batch


def test_reference_stages_match_port_in_float32(micro):
    cfg, sd, batch = micro
    cap, out, post = _port_run(cfg, sd, batch)
    ref, rcfg = arch_module(cfg).reference_net(cfg, sd, "cpu")
    want = stages.ref_stages(ref, batch, cap.occ, cap.bb, cap.head, out,
                             rcfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST)
    got = stages.program_stages(cap.occ, cap.bb, cap.head, out)
    g = stages.gaps(got, want)
    g["rcnn_boxes"] = stages.box_gap(
        [out["batch_cls_preds"], out["batch_box_preds"]],
        stages.decode_rcnn(ref.det_modules.roi_head, out["rois"], out["rcnn_cls"],
                           out["rcnn_reg"]))
    assert set(g) == set(stages.KINDS) - {"final"}
    for k, v in g.items():
        assert v <= (0 if stages.KINDS[k] == "count" else 1e-5), (k, v)
    dets = stages.ref_final(ref, {k: out[k] for k in ("batch_cls_preds", "batch_box_preds",
                                                      "roi_labels", "roi_valid")},
                            rcfg.MODEL.POST_PROCESSING, "cpu")
    assert stages.final_mismatch([post], [dets]) == 0


def test_reference_full_forward_matches_port_in_float32(micro):
    """The reference's own eval forward, not fed by the program, gives the
    port's detections (float32 on both sides)."""
    cfg, sd, batch = micro
    _, out, post = _port_run(cfg, sd, batch)
    ref, rcfg = arch_module(cfg).reference_net(cfg, sd, "cpu")
    rout = ref(batch)
    for k in ("occ_probs", "rpn_cls_preds", "rcnn_cls", "rcnn_reg", "batch_box_preds"):
        np.testing.assert_allclose(rout[k].float().numpy(), out[k].float().numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(out[k].abs().max())))


def test_box_gap_takes_headings_modulo_two_pi():
    a = torch.tensor([[10.0, -5.0, 1.0, 4.0, 1.6, 1.5, 3.0]])
    turned = a.clone()
    turned[0, 6] -= 2 * torch.pi
    assert stages.box_gap([turned], [a]) < 1e-6
    flipped = a.clone()
    flipped[0, 6] += torch.pi
    assert stages.box_gap([flipped], [a]) == pytest.approx(1.0)
    moved = a.clone()
    moved[0, 1] += 0.5
    assert stages.box_gap([moved], [a]) == pytest.approx(0.1)
    inf = a.clone()
    inf[0, 3] = float("inf")
    assert stages.box_gap([inf], [inf.clone()]) == 0


def _imports(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                       cwd=ROOT, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in r.stdout.split()}


def test_reference_loads_nothing_of_the_port():
    top = _imports("import benchmark.reference.stages, benchmark.reference.lowp, "
                   "benchmark.work.counts, benchmark.traffic.generator")
    assert not top & {"btcdet_tpu_torch", "btcdet_tpu", "jax", "jaxlib", "flax"}, top


def test_harness_loads_no_jax_package():
    """A whole run on the CPU at the micro config loads neither JAX nor the
    JAX package (`btcdet_tpu_torch`, the port, is allowed: the top-level
    names are compared whole)."""
    code = ("import json, sys\nsys.argv = ['run']\nimport benchmark.run as R\n"
            "from benchmark.lib.spec import load_config\n"
            f"cfg = load_config('benchmark/tests/micro.json')\nt = {TRAFFIC!r}\n"
            "R.run_cell(cfg, t, {}, 5, 0.3, True, 'cpu', [], "
            "[{'name': 'eval_mfu', 'unit': '%'}])\n"
            "print('forbidden', R.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       check=True)
    assert "forbidden []" in r.stdout, r.stdout[-2000:]
    top = _imports("import benchmark.run as R; R.sys.path.insert(0, '.')\n"
                   "import benchmark.lib.evalcell, btcdet_tpu_torch.models")
    assert "btcdet_tpu_torch" in top and not top & {"btcdet_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_compare_whole():
    import benchmark.run as R

    sys.modules.setdefault("btcdet_tpu_torch_probe", sys)
    try:
        assert "btcdet_tpu_torch_probe" not in R.forbidden_modules()
    finally:
        del sys.modules["btcdet_tpu_torch_probe"]
