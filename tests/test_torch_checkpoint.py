"""The port's checkpoints (`btcdet_tpu_torch/train/checkpoint.py`): a save /
restore round trip resumes a micro train step bit for bit, rotation keeps
`max_to_keep`, partial loads touch one partition only, and a reference
BtcDet `.pth` loads into the flagship model by name."""

import json
from pathlib import Path

import pytest
import torch

from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch import weights
from btcdet_tpu_torch.datasets import make_synthetic_batch, mini_config
from btcdet_tpu_torch.models import build_network
from btcdet_tpu_torch.train import checkpoint as C
from btcdet_tpu_torch.train import optim, trainer
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)

MANIFEST = Path(__file__).parent / "fixtures" / "reference_state_dict_manifest.json"


def micro(seed: int = 0):
    d = mini_config.micro_data_cfg(with_occ=True)
    m = mini_config.micro_model_cfg(with_occ=True)
    m.ROI_HEAD.APPROX_QUERY = False
    torch.manual_seed(seed)
    net = build_network(m, d, ["Car"], device="cpu")
    opt = trainer.create_train_state(net, tcfg.EasyDict(mini_config.mini_opt_cfg(0.01)),
                                     tcfg.EasyDict(mini_config.mini_opt_cfg(0.003)), 50)
    return net, opt, d


@pytest.fixture(scope="module")
def batch():
    return make_synthetic_batch(mini_config.micro_data_cfg(with_occ=True), batch_size=2,
                                num_points=1024, num_gt=3, seed=1, mode="train", device="cpu")


def _step(net, opt, batch, k):
    return trainer.train_step(net, opt, batch, torch.Generator().manual_seed(k))


def _flat_opt(opt):
    out = {}
    for part, st in opt.state_dict().items():
        out[f"{part}.count"] = torch.tensor(st["count"])
        for m in ("mu", "nu"):
            out.update({f"{part}.{m}.{n}": v for n, v in st[m].items()})
    return out


def test_resume_is_bit_for_bit(batch, tmp_path):
    """Step 1, save, restore into a fresh net and optimizer, step 2: the
    parameters, BN statistics and both optimizer partitions equal an
    uninterrupted run's after step 2."""
    net, opt, _ = micro()
    for k in (1, 2):
        _step(net, opt, batch, k)
    want_state, want_opt = net.state_dict(), _flat_opt(opt)

    net1, opt1, _ = micro()
    _step(net1, opt1, batch, 1)
    mgr = C.CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, net1, opt1)
    del net1, opt1
    net2, opt2, _ = micro(seed=123)  # other weights: all must come from the file
    assert mgr.restore(net2, opt2) == 1
    _step(net2, opt2, batch, 2)
    got_state, got_opt = net2.state_dict(), _flat_opt(opt2)
    assert got_state.keys() == want_state.keys() and got_opt.keys() == want_opt.keys()
    assert {k.split(".")[0] for k in got_opt} == {"det", "occ"}
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    for k, v in want_opt.items():
        assert torch.equal(got_opt[k], v), k
    assert int(want_opt["det.count"]) == 2


def test_rotation_keeps_max_to_keep(tmp_path):
    net = torch.nn.Linear(2, 2)
    mgr = C.CheckpointManager(tmp_path, max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(net) is None
    for s in (10, 20, 30, 40, 50):
        mgr.save(s, net)
    assert mgr.all_steps() == [40, 50] and mgr.latest_step() == 50
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint_step_40.pth", "checkpoint_step_50.pth"]


@pytest.mark.parametrize("want_occ", [True, False], ids=["occ", "det"])
def test_partial_load_touches_one_partition(tmp_path, want_occ):
    src, _, _ = micro(seed=0)
    C.CheckpointManager(tmp_path).save(7, src)
    dst, _, _ = micro(seed=1)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    n = C.load_partial(tmp_path, dst, want_occ=want_occ)
    saved = src.state_dict()
    moved = 0
    for k, v in dst.state_dict().items():
        in_part = k.startswith(optim.OCC_PREFIX) == want_occ
        assert torch.equal(v, saved[k] if in_part else before[k]), k
        moved += in_part
    assert n == moved > 0


def test_reference_pth_loads_with_strict_names(tmp_path):
    """A reference-format {model_state, epoch, it} file with every tensor of
    the reference manifest loads into the flagship model by name; a missing
    name fails."""
    manifest = json.load(open(MANIFEST))
    sd = {k: torch.from_numpy(weights.synth_tensor(k, s)) for k, s in manifest.items()}
    pth = tmp_path / "reference.pth"
    torch.save({"model_state": sd, "epoch": 7, "it": 123}, pth)
    cfg = tcfg.flagship()
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    assert C.load_reference_pth(pth, net) == {"epoch": 7, "it": 123}
    name = "det_modules.backbone_3d.conv1.0.weight"
    assert torch.equal(net.state_dict()[name], sd[name])
    assert C.load_any(pth, net) == 123
    sd.pop(name)
    torch.save({"model_state": sd, "epoch": 7, "it": 123}, pth)
    with pytest.raises(RuntimeError, match="Missing key"):
        C.load_reference_pth(pth, net)
