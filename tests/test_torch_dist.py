"""Data parallelism of the port on the CPU: 2 ranks over gloo, each a
process of its own that the test starts and joins with a time limit
(every rank is killed when it expires, so a hung collective fails the
test instead of holding the suite).

- `ShardSampler` gives the JAX package's indices over a grid of cases;
  `split_batch` equals collating the frame subset, bit for bit.
- The synced `MaskedBatchNorm` and `BatchNorm2d` (output, running
  statistics, input gradient) against the JAX `MaskedBatchNorm(axis_name=)`
  and flax's `BatchNorm(axis_name=)` under `jax.pmap` on 2 host devices.
- The micro config's train step, 2 ranks x 1 frame against the port's one
  process at B=2 (the roi and dropout draws from the same generator):
  gradients within 1e-3 of each tensor's max, the same sampled rois, both
  ranks bit-equal after the step.
- The micro eval, 2 ranks x 1 frame over 3 val frames (the second shard
  padded) against one process: det_annos equal bit for bit, same AP.
- `tools/train_torch.py --launcher pytorch` under torchrun for 2 steps,
  then a resumed run with its distributed trailing eval, and the
  checkpoint loading in a 1-rank run; `tools/test_torch.py --launcher
  pytorch` writing the one-process run's KITTI files.
- Refusals: NCCL with more ranks than devices, `--launcher slurm` without
  SLURM's environment, and a rank whose collective fails.
- The JAX package's `merge_results_dist` against its `ShardSampler`: the
  frames come back out of order (ROADMAP, Queue 3); the port's merge
  puts them in dataset order.
- `-m slow`: the 2-rank port step against the JAX package's
  `make_data_parallel_train_step` on a 2-device mesh.

The rank processes import this module and run `rank_main`."""

import copy
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from btcdet_tpu_torch import parallel
from btcdet_tpu_torch.datasets import ShardSampler, make_synthetic_batch_np, mini_config
from btcdet_tpu_torch.train import trainer
from test_torch_train_cli import _plain, micro_train_data_cfg

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
JOIN_S = 240               # a spawn's time limit, seconds
WORKER = ("import sys; sys.path[:0] = [{tests!r}, {repo!r}]; import test_torch_dist as T; "
          "T.rank_main(sys.argv[1], sys.argv[2])")


# ------------------------------------------------------------ launching

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a directory whose `tensorflow` fails to import, put on the processes'
# path: the CLIs' tensorboard writer then runs on tensorboard's own stub
# instead of spending seconds importing TensorFlow in every rank 0
NO_TF = {}


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    if NO_TF:
        env["PYTHONPATH"] = NO_TF["path"]
    env.update({k: str(v) for k, v in extra.items()})
    return env


def rank_env(rank: int, port: int, **extra) -> dict:
    """torchrun's environment for rank `rank` of WORLD on this host."""
    return _env(RANK=rank, WORLD_SIZE=WORLD, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=WORLD,
                MASTER_ADDR="127.0.0.1", MASTER_PORT=port, **extra)


def start_procs(cmds, log_dir: Path, timeout: float = JOIN_S) -> dict:
    """Start every (argv, env) of `cmds` at once (output to
    log_dir/proc<i>.log); `join_procs` waits for them until `timeout`
    seconds after this start."""
    log_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (argv, env) in enumerate(cmds):
        f = open(log_dir / f"proc{i}.log", "w")
        procs.append((subprocess.Popen(argv, env=env, cwd=str(REPO), stdout=f,
                                       stderr=subprocess.STDOUT, start_new_session=True), f))
    return {"procs": procs, "log_dir": log_dir, "timeout": timeout,
            "deadline": time.monotonic() + timeout}


def kill_procs(started: dict):
    for p, f in started["procs"]:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        f.close()


def join_procs(started: dict) -> list:
    """Wait for `start_procs`' processes within their time limit, killing
    every process group when it expires; returns the exit codes."""
    expired = False
    try:
        for p, _ in started["procs"]:
            try:
                p.wait(timeout=max(started["deadline"] - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                expired = True
                break
    finally:
        kill_procs(started)
    if expired:
        pytest.fail(f"processes still running after {started['timeout']} s, killed: "
                    + logs(started["log_dir"]))
    return [p.returncode for p, _ in started["procs"]]


def run_procs(cmds, log_dir: Path, timeout: float = JOIN_S) -> list:
    """`start_procs`, then `join_procs`."""
    return join_procs(start_procs(cmds, log_dir, timeout))


def logs(log_dir: Path) -> str:
    return "".join(p.read_text()[-3000:] for p in sorted(log_dir.glob("proc*.log")))


def spawn_ranks(task: str, inputs: dict, io: Path) -> list:
    """Run `task` (a function of TASKS) on WORLD rank processes over gloo
    with `inputs`; returns each rank's result."""
    io.mkdir(parents=True, exist_ok=True)
    with open(io / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    port = _free_port()
    code = WORKER.format(tests=str(REPO / "tests"), repo=str(REPO))
    rcs = run_procs([([sys.executable, "-c", code, task, str(io)], rank_env(r, port))
                     for r in range(WORLD)], io / "logs")
    assert rcs == [0] * WORLD, (rcs, logs(io / "logs"))
    out = []
    for r in range(WORLD):
        with open(io / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def start_torchrun(script: str, args, log_dir: Path, nproc: int = WORLD) -> dict:
    """Start `python -m torch.distributed.run --nproc_per_node nproc
    <script> <args>` on this host (`start_procs`)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
            "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), script,
            *map(str, args)]
    return start_procs([(argv, _env())], log_dir)


def join_torchrun(started: dict) -> str:
    """The ranks' output of a `start_torchrun`, failing on a non-zero exit."""
    rcs = join_procs(started)
    assert rcs == [0], logs(started["log_dir"])
    return logs(started["log_dir"])


def spawn_one(task: str, inputs: dict, io: Path):
    """Run `task` in one process of its own, outside any group; returns
    its result."""
    io.mkdir(parents=True, exist_ok=True)
    with open(io / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    code = WORKER.format(tests=str(REPO / "tests"), repo=str(REPO))
    rcs = run_procs([([sys.executable, "-c", code, task, str(io)], _env(WORLD_SIZE=1))],
                    io / "logs")
    assert rcs == [0], (rcs, logs(io / "logs"))
    with open(io / "out0.pkl", "rb") as f:
        return pickle.load(f)


def rank_main(task: str, io: str):
    """A rank process: join the group from torchrun's variables (none when
    WORLD_SIZE is 1), run TASKS[task] on the inputs, write its result."""
    torch.set_num_threads(1)
    if os.environ["WORLD_SIZE"] != "1":
        parallel.init_dist("pytorch", "gloo", timeout_s=JOIN_S)
    try:
        with open(Path(io) / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        out = TASKS[task](inputs)
        with open(Path(io) / f"out{parallel.get_dist_info()[0]}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        parallel.destroy()


# --------------------------------------------------------------- setups

def micro_cfg(data_cfg=None):
    """The port's micro config (occ subnet on, dropout 0.3) with the
    mini optimizers."""
    from btcdet_tpu_torch.config import EasyDict

    cfg = EasyDict({"CLASS_NAMES": ["Car"],
                    "DATA_CONFIG": data_cfg or mini_config.micro_data_cfg(with_occ=True),
                    "MODEL": mini_config.micro_model_cfg(with_occ=True),
                    "OPTIMIZATION": mini_config.mini_opt_cfg(0.01),
                    "OCC_OPTIMIZATION": mini_config.mini_opt_cfg(0.003)})
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    return cfg


def micro_weights(cfg) -> dict:
    """Synthetic weights by name; the output projections keep the model's
    own init (as `chip_smoke.train_setup`)."""
    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models import build_network

    torch.manual_seed(0)
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    own, sd = net.state_dict(), weights.synth_state_dict(net)
    head = net.det_modules.roi_head
    finals = [f"det_modules.roi_head.{t}.{len(list(getattr(head, t).children())) - 1}"
              for t in ("cls_layers", "reg_layers")]
    for k in ("det_modules.dense_head.conv_cls.bias", "det_modules.dense_head.conv_box.weight",
              *(f + ".weight" for f in finals), *(f + ".bias" for f in finals)):
        sd[k] = own[k]
    return sd


def f32(fn):
    """Run `fn()` with BTCDET_F32=1."""
    old = os.environ.get("BTCDET_F32")
    os.environ["BTCDET_F32"] = "1"
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["BTCDET_F32"]
        else:
            os.environ["BTCDET_F32"] = old


def as_cfg(d):
    from btcdet_tpu_torch.config import EasyDict

    return EasyDict(copy.deepcopy(d))


def train_once(cfg, sd, batch_np, draws=None, bev_sharding=False) -> dict:
    """One port train step in float32 (this process: one rank of a run, or
    alone) from `sd` on `batch_np` with the generator seeded 0 (`draws`,
    the global batch's roi uniforms, in place of the generator's;
    `bev_sharding` as `build_network`'s): the loss terms, every gradient,
    the state after the update and each frame's sampled roi indices."""
    return f32(lambda: _train_once(as_cfg(cfg), sd, batch_np, draws, bev_sharding))


def _train_once(cfg, sd, batch_np, draws, bev_sharding=False) -> dict:
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.models.roi_heads import roi_head_utils as RH

    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu",
                        bev_sharding=bev_sharding)
    net.load_state_dict(sd)
    opt = trainer.create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, 50)
    parallel.broadcast_state(net)
    picked, orig = [], RH.subsample_rois

    def subsample(*a, **k):
        out = orig(*a, **k)
        picked.append(tuple(t.numpy().copy() for t in out))
        return out

    RH.subsample_rois = subsample
    orig_draws = RH.draw_roi_sampling_uniforms
    if draws is not None:
        RH.draw_roi_sampling_uniforms = lambda *a: tuple(torch.from_numpy(d) for d in draws)
    try:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch_np.items()}
        m = trainer.train_step(net, opt, batch, torch.Generator().manual_seed(0))
    finally:
        RH.subsample_rois, RH.draw_roi_sampling_uniforms = orig, orig_draws
    return {"metrics": trainer.read_metrics(m),
            "grads": {n: p.grad.numpy().copy() for n, p in net.named_parameters()},
            "state": {k: v.numpy().copy() for k, v in net.state_dict().items()},
            "picked": picked}


def train_batch(cfg) -> dict:
    """A B=2 synthetic training batch without `use_occ_prob`, so the train
    forward draws the occ gate too."""
    b = make_synthetic_batch_np(cfg.DATA_CONFIG, batch_size=2, num_points=2048, num_gt=4,
                                seed=3, mode="train")
    del b["use_occ_prob"]
    return b


def eval_once(cfg, sd, dist: bool, batch_size: int = 1, bev_sharding: bool = False) -> tuple:
    """(det_annos, AP keys) of the micro eval at `batch_size` frames a
    process over the tree's val split (`build_dataloader(dist=)`;
    `bev_sharding` as `build_network`'s)."""
    from btcdet_tpu_torch.datasets import build_dataloader
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import eval_utils

    cfg = as_cfg(cfg)
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu",
                        bev_sharding=bev_sharding)
    net.load_state_dict(sd)
    ds, dl, _ = build_dataloader(cfg.DATA_CONFIG, ["Car"], batch_size, dist=dist, workers=0,
                                 training=False)
    post = cfg.MODEL.POST_PROCESSING
    _, result, annos = eval_utils.eval_one_epoch(net, dl, ds, post, ["Car"],
                                                 recall_thresh_list=post.RECALL_THRESH_LIST)
    return annos, {k: v for k, v in result.items() if k.startswith(("Car_", "occ_", "recall"))}


def bn_inputs() -> dict:
    rng = np.random.RandomState(0)
    n, c = 40, 6
    mask = rng.rand(WORLD * n) < 0.7
    return {"x1": (rng.randn(WORLD * n, c) * 2 + 1).astype(np.float32), "m1": mask,
            "w1": rng.randn(WORLD * n, c).astype(np.float32),
            "g1": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "b1": rng.randn(c).astype(np.float32) * 0.1,
            "x2": (rng.randn(2 * WORLD, 5, 6, 7) * 2 - 1).astype(np.float32),
            "w2": rng.randn(2 * WORLD, 5, 6, 7).astype(np.float32),
            "g2": rng.uniform(0.5, 1.5, 5).astype(np.float32),
            "b2": rng.randn(5).astype(np.float32) * 0.1}


def _task_suite(inp):
    """Every rank-side check that needs one group: the synced BNs, the
    micro train step, the micro eval."""
    from btcdet_tpu_torch.models.backbones_2d import BatchNorm2d
    from btcdet_tpu_torch.ops.sparse import MaskedBatchNorm

    rank, world = parallel.get_dist_info()
    b = inp["bn"]
    out = {}
    for key, bn, x, w, extra in (
            ("masked", MaskedBatchNorm(6, eps=1e-3, momentum=0.01), b["x1"], b["w1"], "m1"),
            ("bn2d", BatchNorm2d(5, eps=1e-3, momentum=0.01), b["x2"], b["w2"], None)):
        g, bb = (b["g1"], b["b1"]) if key == "masked" else (b["g2"], b["b2"])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(g))
            bn.bias.copy_(torch.from_numpy(bb))
        n = len(x) // world
        xr = torch.from_numpy(x[rank * n:(rank + 1) * n]).requires_grad_(True)
        args = (torch.from_numpy(b[extra][rank * n:(rank + 1) * n]),) if extra else ()
        y = bn.train()(xr, *args)
        (y * torch.from_numpy(w[rank * n:(rank + 1) * n])).sum().backward()
        out[key] = {"y": y.detach().numpy(), "dx": xr.grad.numpy(),
                    "mean": bn.running_mean.numpy().copy(), "var": bn.running_var.numpy().copy()}
    out["train"] = train_once(inp["cfg"], inp["sd"],
                              trainer.split_batch(inp["batch"], rank, world))
    out["eval"] = eval_once(inp["eval_cfg"], inp["eval_sd"], dist=True)
    out["eval_b2"] = eval_once(inp["eval_cfg"], inp["eval_sd"], dist=True, batch_size=2)
    return out


def float64_everywhere():
    """Make this process compute the port in float64 from here on: float32
    and `.float()` mean float64, as do new tensors and the activation
    dtype. A witness free of float32 rounding, for a process that does
    nothing else."""
    import btcdet_tpu_torch.models  # noqa: F401  (every module that reads activation_dtype)

    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self: self.to(torch.float64)
    torch.float32 = torch.float64
    for m in list(sys.modules.values()):
        if getattr(m, "__name__", "").startswith("btcdet_tpu_torch") \
                and hasattr(m, "activation_dtype"):
            m.activation_dtype = lambda default=None: torch.float64


def _task_f64_step(inp):
    """The train step of `chip_smoke.small_config(full=True)` in float64 on
    this process's frames of a B=2 batch (both frames outside a group)."""
    import chip_smoke as cs

    torch.set_num_threads(2)
    float64_everywhere()
    rank, world = parallel.get_dist_info()
    net, opt, batch = cs.train_setup(cs.small_config(full=True), 4096, 4, 3, device="cpu",
                                     batch_size=2)
    net.double()
    batch = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in batch.items()}
    batch = trainer.split_batch(batch, rank, world)
    parallel.broadcast_state(net)
    picked, undo = cs.record_picks()
    try:
        m = trainer.train_step(net, opt, batch, torch.Generator().manual_seed(0))
    finally:
        undo()
    return {"loss": float(m["loss"]),
            "grads": {n: p.grad.numpy().copy() for n, p in net.named_parameters()},
            "state": {k: v.numpy().copy() for k, v in net.state_dict().items()},
            "picked": [tuple(t.numpy().copy() for t in p) for p in picked]}


def _task_jax_parity(inp):
    rank, world = parallel.get_dist_info()
    return train_once(inp["cfg"], inp["sd"], trainer.split_batch(inp["batch"], rank, world),
                      inp["draws"])


TASKS = {"suite": _task_suite, "jax_parity": _task_jax_parity, "f64_step": _task_f64_step}


# -------------------------------------------------------------- fixtures

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's own steps and evals are micro-sized: on one thread
    they do not fight the rank processes and the suite's other workers
    for the cores (on all threads they take seconds instead of tenths)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A micro-scale KITTI tree (4 train, 3 val frames) with infos, gt and
    best-match databases, and the micro config as a yaml reading it."""
    from btcdet_tpu_torch.datasets import bestmatch
    from btcdet_tpu_torch.datasets.kitti import kitti_infos
    from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti

    tmp = tmp_path_factory.mktemp("dist")
    (tmp / "no_tf" / "tensorflow").mkdir(parents=True)
    (tmp / "no_tf" / "tensorflow" / "__init__.py").write_text(
        'raise ImportError("TensorFlow is left out of these runs")\n')
    NO_TF["path"] = str(tmp / "no_tf")
    root = tmp / "kitti"
    make_raw_kitti(root, n_frames=7, n_train=4, seed=6, cars_per_frame=1, n_background=3000,
                   x_range=(3.0, 3.4), y_range=(-0.4, 0.4))
    kitti_infos.create_kitti_infos(root, workers=2)
    bestmatch.create_best_match_db(root, class_names=("Car",), splits=("train",))
    cfg = _plain(micro_cfg(micro_train_data_cfg(root)))
    cfg_file = tmp / "micro_kitti_train.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return tmp, cfg_file


def eval_weights(tree, name: str) -> Path:
    """The micro weights as a reference-format `.pth` for the eval CLI."""
    tmp, cfg_file = tree
    pth = tmp / f"{name}.pth"
    cfg = as_cfg(yaml.safe_load(cfg_file.read_text()))
    torch.save({"model_state": micro_weights(cfg), "epoch": 0, "it": 3}, pth)
    return pth


FAIL_RANK = ("import os, runpy, sys; import torch.distributed as d; "
             "d.all_gather_object = lambda *a, **k: os._exit(3); "
             "sys.argv = ['tools/test_torch.py'] + sys.argv[1:]; "
             "runpy.run_path('tools/test_torch.py', run_name='__main__')")


@pytest.fixture(scope="module")
def background(tree):
    """The CLI runs that need no result of another, started together
    before the suite's ranks so they overlap: the train CLI's first run
    under torchrun, the eval CLI under torchrun, and an eval CLI whose
    rank 1 dies at the merge of the results. Each is joined by its test;
    whatever is still running at the end is killed."""
    tmp, cfg_file = tree
    dist = ["--launcher", "pytorch", "--dist_backend", "gloo", "--steps", "2"]
    pth = eval_weights(tree, "eval_weights")
    fail_args = _cli_args(cfg_file, tmp / "fail", "--launcher", "pytorch", "--ckpt", pth)
    port = _free_port()
    runs = {
        "train": start_torchrun("tools/train_torch.py",
                                _cli_args(cfg_file, tmp / "torchrun", *dist, "--epochs", "1",
                                          "--num_epochs_to_eval", "0"), tmp / "tr1"),
        "eval": start_torchrun("tools/test_torch.py",
                               _cli_args(cfg_file, tmp / "eval2", "--ckpt", pth,
                                         "--save_to_file", "--launcher", "pytorch"),
                               tmp / "te"),
        "fail": start_procs([([sys.executable, "tools/test_torch.py", *fail_args],
                              rank_env(0, port)),
                             ([sys.executable, "-c", FAIL_RANK, *fail_args],
                              rank_env(1, port))], tmp / "fail_logs", timeout=120)}
    yield runs
    for started in runs.values():
        kill_procs(started)


@pytest.fixture(scope="module")
def suite(tree, background, tmp_path_factory):
    """(rank results of `_task_suite`, its inputs)."""
    tmp, cfg_file = tree
    cfg, eval_cfg = micro_cfg(), as_cfg(yaml.safe_load(cfg_file.read_text()))
    inputs = {"bn": bn_inputs(), "cfg": _plain(cfg), "sd": micro_weights(cfg),
              "batch": train_batch(cfg), "eval_cfg": _plain(eval_cfg),
              "eval_sd": micro_weights(eval_cfg)}
    return spawn_ranks("suite", inputs, tmp_path_factory.mktemp("suite")), inputs


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("n", [0, 1, 5, 7, 8, 13])
def test_shard_sampler_matches_jax(n):
    from btcdet_tpu.datasets import ShardSampler as JaxShardSampler

    for shards in (1, 2, 3, 4):
        for shard in range(shards):
            for shuffle in (False, True):
                for seed, epoch in ((0, 0), (5, 3)):
                    ours = ShardSampler(n, shards, shard, shuffle, seed)
                    ref = JaxShardSampler(n, shards, shard, shuffle, seed)
                    ours.set_epoch(epoch)
                    ref.set_epoch(epoch)
                    assert list(ours) == [int(i) for i in ref], (n, shards, shard, shuffle)
                    assert len(ours) == len(ref)


def test_split_batch_equals_collating_the_frames(tree):
    from btcdet_tpu_torch.config import EasyDict, cfg_from_yaml_file
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, to_device

    _, cfg_file = tree
    cfg = cfg_from_yaml_file(cfg_file, EasyDict())
    ds = KittiDataset(cfg.DATA_CONFIG, ["Car"], training=True)
    items = [ds[i] for i in range(4)]
    whole = ds.collate_batch(items)
    for world in (2, 4):
        for rank in range(world):
            b = 4 // world
            part = trainer.split_batch(whole, rank, world)
            want = ds.collate_batch(items[rank * b:(rank + 1) * b])
            assert part.keys() == want.keys()
            for k, v in want.items():
                if k == "frame_id":
                    assert part[k] == v
                else:
                    assert part[k].dtype == v.dtype and np.array_equal(part[k], v), (k, rank)
            tpart = trainer.split_batch(to_device(whole, "cpu"), rank, world)
            for k, v in to_device(want, "cpu").items():
                assert k == "frame_id" or torch.equal(tpart[k], v), k
    with pytest.raises(ValueError, match="does not split"):
        trainer.split_batch(whole, 0, 3)


def _jax_bn_reference(b):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from btcdet_tpu.ops.sparse import MaskedBatchNorm as JaxMaskedBatchNorm

    devs = jax.devices()[:WORLD]
    out = {}

    def shards(a):
        return jnp.asarray(a.reshape((WORLD, -1) + a.shape[1:]))

    masked = JaxMaskedBatchNorm(axis_name="dp")
    mvars = {"params": {"scale": b["g1"], "bias": b["b1"]},
             "batch_stats": {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}}

    def local1(x, m, w):
        y, mut = masked.apply(mvars, x, m, use_running_average=False, mutable=["batch_stats"])
        return (y * w).sum(), (y, mut["batch_stats"])

    bn2d = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3, axis_name="dp")
    bvars = {"params": {"scale": b["g2"], "bias": b["b2"]},
             "batch_stats": {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}}

    def local2(x, w):
        y, mut = bn2d.apply(bvars, x, mutable=["batch_stats"])
        return (y * w).sum(), (y, mut["batch_stats"])

    nhwc = (0, 2, 3, 1)
    for key, fn, args in (("masked", local1, (b["x1"], b["m1"], b["w1"])),
                          ("bn2d", local2, (b["x2"].transpose(nhwc), b["w2"].transpose(nhwc)))):
        step = jax.pmap(jax.value_and_grad(fn, has_aux=True), axis_name="dp", devices=devs)
        (_, (y, stats)), dx = step(*map(shards, args))
        y, dx = np.asarray(y), np.asarray(dx)
        if key == "bn2d":
            y, dx = y.transpose(0, 1, 4, 2, 3), dx.transpose(0, 1, 4, 2, 3)
        out[key] = {"y": y, "dx": dx, "mean": np.asarray(stats["mean"][0]),
                    "var": np.asarray(stats["var"][0])}
    return out


@pytest.mark.parametrize("kind", ["masked", "bn2d"])
def test_synced_batchnorm_matches_jax_axis_name(suite, kind):
    """Forward, running statistics and input gradient of the synced BN on
    each rank against the JAX package's `axis_name` path, at 1e-5."""
    ranks, inputs = suite
    ref = _jax_bn_reference(inputs["bn"])[kind]
    for r, res in enumerate(ranks):
        got = res[kind]
        np.testing.assert_allclose(got["y"], ref["y"][r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dx"], ref["dx"][r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["var"], ref["var"], rtol=1e-5, atol=1e-5)
    assert np.array_equal(ranks[0][kind]["mean"], ranks[1][kind]["mean"])


@pytest.fixture(scope="module")
def one_process_step(suite):
    _, inputs = suite
    return train_once(inputs["cfg"], inputs["sd"], inputs["batch"])


def test_dp_step_gradients_match_one_process(suite, one_process_step):
    """The all-reduced gradients of 2 ranks x 1 frame against one process
    at B=2, within 1e-3 of each tensor's max (the bound of
    `test_torch_train.py::test_step_gradients_match`); the loss terms, the
    sum of the ranks' shares, to 1e-4."""
    ranks, _ = suite
    ref = one_process_step
    for r in ranks:
        g = r["train"]["grads"]
        assert g.keys() == ref["grads"].keys()
        for k, v in ref["grads"].items():
            scale = np.abs(v).max()
            np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-3 * scale + 1e-8, err_msg=k)
        for k, v in ref["metrics"].items():
            if not k.startswith("grad_norm"):
                np.testing.assert_allclose(r["train"]["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=k)
    assert sum(np.abs(v).max() > 0 for v in ref["grads"].values()) > 0.9 * len(ref["grads"])


def test_dp_step_samples_the_one_process_rois(suite, one_process_step):
    """Each rank's sampled rois (indices and foreground flags) are the
    one-process step's for its frame: the roi draws are the global
    batch's rows."""
    ranks, _ = suite
    ref = one_process_step["picked"]
    assert len(ref) == WORLD
    for r, res in enumerate(ranks):
        (sampled, fg), = res["train"]["picked"]
        assert np.array_equal(sampled, ref[r][0]) and np.array_equal(fg, ref[r][1])


def test_dp_step_leaves_the_ranks_bit_equal(suite, one_process_step):
    """Gradients, parameters, BN statistics and loss terms are the same
    on both ranks, bit for bit; the BN running statistics within 1e-5 of
    one process's."""
    a, b = (r["train"] for r in suite[0])
    for part in ("grads", "state"):
        for k in a[part]:
            assert np.array_equal(a[part][k], b[part][k]), (part, k)
    assert a["metrics"] == b["metrics"]
    for k, v in one_process_step["state"].items():
        if "running_" in k:
            np.testing.assert_allclose(a["state"][k], v, rtol=0, atol=1e-5, err_msg=k)


def test_dp_eval_equals_one_process(suite):
    """2 ranks x 1 frame over the 3 val frames (the second rank's shard
    padded with frame 0) merge into the one-process det_annos, in frame
    order, bit for bit, and the same AP, recall and occ keys."""
    ranks, inputs = suite
    annos, keys = eval_once(inputs["eval_cfg"], inputs["eval_sd"], dist=False)
    assert [a["frame_id"] for a in annos] == ["000004", "000005", "000006"]
    for res in ranks:
        r_annos, r_keys = res["eval"]
        assert len(r_annos) == len(annos)
        for a, b in zip(r_annos, annos):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k
        assert r_keys == keys
    assert "Car_3d/moderate_R40" in keys and "occ_precision@0.5" in keys


def test_dp_eval_drops_the_shard_padding_from_a_batch(suite):
    """2 ranks x 2 frames over the 3 val frames: the second rank's one
    batch holds frame 6 and, as padding, frame 4. The merged det_annos
    match one process's at 2 frames a batch (its batches: frames 4 and 5,
    then 6 alone; frame 6 is inferred beside another frame on the rank,
    alone in the one process, so its boxes agree to float32 rounding),
    and the AP, recall and occupancy keys are equal: the padded frame's
    occupancy counts stay out of that batch's."""
    ranks, inputs = suite
    annos, keys = eval_once(inputs["eval_cfg"], inputs["eval_sd"], dist=False, batch_size=2)
    for res in ranks:
        r_annos, r_keys = res["eval_b2"]
        assert [a["frame_id"] for a in r_annos] == [a["frame_id"] for a in annos]
        for a, b in zip(r_annos, annos):
            assert a.keys() == b.keys()
            for k in a:
                if np.asarray(b[k]).dtype.kind == "f":
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)
                else:
                    assert np.array_equal(a[k], b[k]), k
        assert r_keys == keys
    assert any(k.startswith("occ_precision") for k in keys)


def _cli_args(cfg_file, out, *extra) -> list:
    return [str(a) for a in ("--cfg_file", cfg_file, "--device", "cpu", "--workers", "0",
                             "--batch_size", "1", "--output_dir", out, *extra, "--set",
                             "MODEL.ROI_HEAD.APPROX_QUERY", "False")]


def _log_text(out: Path) -> str:
    return "".join(p.read_text() for p in sorted(out.glob("train_*.log")))


def test_train_cli_under_torchrun_resumes_and_loads_in_one_rank(tree, background):
    """`tools/train_torch.py --launcher pytorch --dist_backend gloo` under
    torchrun: 2 steps (4 frames over 2 ranks, 1 a rank), then a second
    run that resumes at step 2 for 2 more and evaluates on the 3 val
    frames over both ranks; rank 0 writes each checkpoint once and the
    logs; the step-4 checkpoint loads into one process's net and
    optimizer, which train on from it."""
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import checkpoint as C

    tmp, cfg_file = tree
    out = tmp / "torchrun"
    dist = ["--launcher", "pytorch", "--dist_backend", "gloo", "--steps", "2"]
    join_torchrun(background["train"])
    assert C.CheckpointManager(out / "ckpt").all_steps() == [2]
    join_torchrun(start_torchrun("tools/train_torch.py",
                                 _cli_args(cfg_file, out, *dist, "--epochs", "2",
                                           "--num_epochs_to_eval", "1"), tmp / "tr2"))
    assert C.CheckpointManager(out / "ckpt").all_steps() == [2, 4]
    log = _log_text(out)
    assert log.count("data parallel: 2 ranks over pytorch") == 2
    assert log.count("saved checkpoint at step 2") == 1
    assert log.count("saved checkpoint at step 4") == 1
    assert "auto-resumed from step 2" in log
    assert "eval: 3 frames over 2 rank(s)" in log
    assert (out / "eval" / "eval_with_train" / "eval_list_val.txt").read_text().split() == ["4"]
    assert not list((out / "ckpt").glob("*.tmp"))
    cfg = as_cfg(yaml.safe_load(cfg_file.read_text()))
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    opt = trainer.create_train_state(net, cfg.OPTIMIZATION, cfg.OCC_OPTIMIZATION, 6)
    assert C.CheckpointManager(out / "ckpt").restore(net, opt) == 4
    assert all(p.count == 4 for p in opt.parts.values())
    batch = make_synthetic_batch_np(cfg.DATA_CONFIG, batch_size=1, num_points=2048, num_gt=2,
                                    seed=1, mode="train")
    m = trainer.read_metrics(trainer.train_step(
        net, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0)))
    assert all(np.isfinite(v) for v in m.values()), m


def test_eval_cli_under_torchrun_writes_the_one_process_files(tree, background):
    """`tools/test_torch.py --launcher pytorch` on 2 ranks writes the same
    KITTI result files as one process, and the same AP."""
    from test_torch_eval_cli import _load_cli

    tmp, cfg_file = tree
    args = ["--ckpt", tmp / "eval_weights.pth", "--save_to_file"]
    (one,) = _load_cli().main(_cli_args(cfg_file, tmp / "eval1", *args))
    join_torchrun(background["eval"])
    files = sorted((tmp / "eval1" / "step_3" / "val").glob("*.txt"))
    assert [f.name for f in files] == ["000004.txt", "000005.txt", "000006.txt"]
    for f in files:
        assert (tmp / "eval2" / "step_3" / "val" / f.name).read_text() == f.read_text()
    log2 = "".join(p.read_text() for p in (tmp / "eval2").glob("eval_*.log"))
    assert "eval: 3 frames over 2 rank(s)" in log2
    assert "Car_3d/moderate_R40" in one[2]


def test_nccl_with_more_ranks_than_devices_is_refused(tree, tmp_path, monkeypatch):
    from test_torch_train_cli import _load_cli

    _, cfg_file = tree
    for k, v in rank_env(0, _free_port()).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="nccl needs one CUDA device a rank: 2 ranks"):
        _load_cli().main(_cli_args(cfg_file, tmp_path, "--launcher", "pytorch",
                                   "--dist_backend", "nccl"))
    assert parallel.data_parallel_group() is None


def test_slurm_without_its_environment_is_refused(tree, tmp_path, monkeypatch):
    from test_torch_train_cli import _load_cli

    _, cfg_file = tree
    for k in [k for k in os.environ if k.startswith("SLURM_")] + ["MASTER_ADDR"]:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="missing: SLURM_PROCID"):
        _load_cli().main(_cli_args(cfg_file, tmp_path, "--launcher", "slurm"))


def test_a_failed_collective_fails_the_run(tree, background):
    """`tools/test_torch.py --launcher pytorch` whose rank 1 dies at the
    merge of the results: rank 0's collective raises and the CLI exits
    non-zero, within the time limit."""
    tmp, _ = tree
    rcs = join_procs(background["fail"])
    assert rcs[1] == 3 and rcs[0] not in (0, None), (rcs, logs(tmp / "fail_logs"))
    assert "Traceback" in (tmp / "fail_logs" / "proc0.log").read_text()


def test_jax_merge_results_dist_misorders_shard_sampler_shards(tmp_path, monkeypatch):
    """A fault of the JAX package (ROADMAP, Queue 3): its
    `merge_results_dist` interleaves the processes' parts round-robin, but
    its `ShardSampler` hands out contiguous shards, so an eval built from
    the two would put 5 frames over 2 processes in the order 0, 3, 1, 4, 2.
    The port merges by dataset index. Two processes are simulated: rank 1
    writes its part, then rank 0 writes and merges."""
    from jax.experimental import multihost_utils

    from btcdet_tpu.datasets import ShardSampler as JaxShardSampler
    from btcdet_tpu.parallel import mesh

    parts = [[int(i) for i in JaxShardSampler(5, 2, r, shuffle=False)] for r in range(2)]
    assert parts == [[0, 1, 2], [3, 4, 0]]
    monkeypatch.setattr(multihost_utils, "sync_global_devices", lambda name: None)
    for rank in (1, 0):
        monkeypatch.setattr(mesh, "get_dist_info", lambda rank=rank: (rank, 2))
        merged = mesh.merge_results_dist(parts[rank], 5, tmp_path)
    assert merged == [0, 3, 1, 4, 2]
    monkeypatch.setattr(parallel.dist, "gather_objects",
                        lambda obj: [[(i, i) for i in p] for p in parts])
    assert parallel.merge_results_dist([], 5) == [0, 1, 2, 3, 4]


@pytest.mark.slow
def test_dp_step_in_float64_matches_one_process(tmp_path):
    """The flagship's widths on a 16 m scene (`chip_smoke.small_config`),
    whose float32 step decides a few ReLUs and top-k picks by rounding:
    in float64, 2 ranks x 1 frame against one process at B=2 sample the
    same rois, and the loss, every gradient and the BN statistics agree to
    1e-10 of their max -- the data-parallel step is the one-process step
    up to the order of its sums."""
    ranks = spawn_ranks("f64_step", {}, tmp_path / "dp")
    one = spawn_one("f64_step", {}, tmp_path / "one")
    assert abs(ranks[0]["loss"] - one["loss"]) <= 1e-10 * abs(one["loss"])
    for r, res in enumerate(ranks):
        (sampled, fg), = res["picked"]
        assert np.array_equal(sampled, one["picked"][r][0])
        assert np.array_equal(fg, one["picked"][r][1])
    for k, v in one["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][k], v, rtol=0,
                                   atol=1e-10 * np.abs(v).max(), err_msg=k)
    for k, v in one["state"].items():
        if "running_" in k:
            np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=0, atol=1e-10, err_msg=k)


@pytest.mark.slow
def test_dp_step_matches_jax_data_parallel_step(tmp_path):
    """The JAX package's `make_data_parallel_train_step` on a 2-device mesh
    and the port's step on 2 ranks x 1 frame, from bridged weights on the
    same B=2 batch with the same roi draws: loss terms to 1e-3, every
    gradient within 1e-3 of its tensor's max."""
    import jax
    import jax.numpy as jnp

    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
    from btcdet_tpu.models import build_network as jax_build
    from btcdet_tpu.models.roi_heads import roi_head_utils as JRH
    from btcdet_tpu.parallel import make_mesh
    from btcdet_tpu.train import optim as JO
    from btcdet_tpu.train import trainer as JT
    from btcdet_tpu_torch import weights as W
    from test_torch_train import ROI_KEY, jax_roi_draws
    from torch_parity import f32_mode, full_micro_cfgs, init_jax, perturb_variables, to_np_tree

    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0)
    det_cfg, occ_cfg = mini_config.mini_opt_cfg(0.01), mini_config.mini_opt_cfg(0.003)
    seen = {}

    class Recording:
        def __init__(self, tx):
            self.tx = tx

        def init(self, params):
            return self.tx.init(params)

        def update(self, grads, state, params):
            jax.debug.callback(lambda g: seen.update(grads=g), grads)
            return self.tx.update(grads, state, params)

    orig_assign = JRH.assign_targets
    with f32_mode():
        batch_np = jax_batch(data_cfg, batch_size=2, num_points=2048, num_gt=4, seed=0,
                             mode="train")
        net = jax_build(model_cfg, data_cfg, ["Car"])
        variables = perturb_variables(init_jax(net, batch_np))
        cls = variables["params"]["occ_subnet"]["conv_cls"]
        cls["bias"] = np.zeros_like(cls["bias"])
        tx = Recording(JO.build_dual_optimizer(det_cfg, occ_cfg, 50))
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JT.TrainState(jnp.zeros((), jnp.int32), params,
                              jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              tx.init(params))
        mesh = make_mesh(devices=jax.devices()[:WORLD])
        JRH.assign_targets = lambda rng, *a, **k: orig_assign(ROI_KEY, *a, **k)
        try:
            step = JT.make_data_parallel_train_step(net, tx, mesh)
            _, metrics = step(state, JT.shard_batch(
                {k: jnp.asarray(v) for k, v in batch_np.items()}, mesh), jax.random.PRNGKey(0))
            metrics = {k: float(v) for k, v in metrics.items()}
            jax.effects_barrier()
        finally:
            JRH.assign_targets = orig_assign
    ref_grads = W.from_jax_variables({"params": to_np_tree(seen["grads"]),
                                      "batch_stats": variables["batch_stats"]}, dp_ratio=0.0,
                                     upsample_strides=model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES)
    N = int(model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    R = int(model_cfg.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
    cfg = {"CLASS_NAMES": ["Car"], "DATA_CONFIG": _plain(data_cfg), "MODEL": _plain(model_cfg),
           "OPTIMIZATION": _plain(det_cfg), "OCC_OPTIMIZATION": _plain(occ_cfg)}
    inputs = {"cfg": cfg, "sd": W.from_jax_variables(
                  variables, dp_ratio=0.0, upsample_strides=model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES),
              "batch": batch_np, "draws": [np.asarray(d) for d in jax_roi_draws(ROI_KEY, 2, N, R)]}
    ranks = spawn_ranks("jax_parity", inputs, tmp_path / "io")
    for res in ranks:
        for k, v in metrics.items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-3, atol=1e-3, err_msg=k)
        for k, g in res["grads"].items():
            r = ref_grads[k].numpy()
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * np.abs(r).max() + 1e-8,
                                       err_msg=k)


def test_occ_draws_are_the_rank_rows_of_the_one_process_draws(monkeypatch):
    """The occ voxel dropout and REMAIN_PERCENTAGE draws of the port's occ
    subnet (`draw_occ_dropout` / `draw_occ_remain`) in a data-parallel run:
    each rank draws the global batch's numbers from the step's generator
    and keeps its frames' rows. Two ranks are simulated in one process:
    each rank's dropped cells and occ points equal the one-process run's on
    its frame (the occ backbone's BN on running statistics, so that a
    frame's outputs depend on its own data and draws alone)."""
    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets import make_synthetic_batch, mini_config
    from btcdet_tpu_torch.models.occ import occ_subnet as TOS

    data_cfg = mini_config.micro_data_cfg(with_occ=True)
    model_cfg = mini_config.micro_model_cfg(with_occ=True)
    data_cfg.OCC.DROPOUT_RATE = 0.5
    model_cfg.OCC.PARAMS.REMAIN_PERCENTAGE = [0.5, 1.0]
    net = TOS.OccSubnet(model_cfg.OCC, data_cfg, data_cfg.POINT_CLOUD_RANGE, (0.2, 0.2, 0.1), 4)
    sd = weights.synth_state_dict(net)
    sd["occ_dense_head.conv_cls.0.bias"].zero_()
    net.load_state_dict(sd)
    net.train()
    net.backbone_3d.eval()
    batch = make_synthetic_batch(data_cfg, batch_size=2, num_points=2048, num_gt=4, seed=0,
                                 mode="train", device="cpu")
    calls = {"one": [], "ranks": []}
    orig = (TOS.draw_occ_dropout, TOS.draw_occ_remain)

    def recording(fn, key):
        def draw(generator, rows, n):
            out = fn(generator, rows, n)
            calls[key].append((rows, out))
            return out
        return draw

    def run(part, key):
        monkeypatch.setattr(TOS, "draw_occ_dropout", recording(orig[0], key))
        monkeypatch.setattr(TOS, "draw_occ_remain", recording(orig[1], key))
        with torch.no_grad():
            return net(part, torch.Generator().manual_seed(5))

    one = run(batch, "one")
    for rank in range(2):
        monkeypatch.setattr(parallel.dist, "get_dist_info", lambda rank=rank: (rank, 2))
        out = run(trainer.split_batch(batch, rank, 2), "ranks")
        assert torch.equal(out["voxel_drop_mask"][0], one["voxel_drop_mask"][rank])
        assert one["voxel_drop_mask"][rank].any()
        m, om = out["occ_points_mask"][0], one["occ_points_mask"][rank]
        assert torch.equal(m, om) and m.any()
        # the same points: the dense convs of one frame and of two round apart
        torch.testing.assert_close(out["occ_points"][0][m], one["occ_points"][rank][om],
                                   rtol=1e-5, atol=1e-5)
    # every rank drew the global batch's rows, the same numbers as one process
    for (rows, draws), (one_rows, one_draws) in zip(calls["ranks"], calls["one"] * 2):
        assert rows == one_rows == 2
        assert all(torch.equal(a, b) for a, b in zip(draws, one_draws))
