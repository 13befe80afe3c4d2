"""The occupancy subnet's options in the port against the JAX package on
the CPU: OccTargetsPillar and OccHead2D, the residual and inverse occ
backbones, OCC.REVERSE_VIS, OCC.USE_ABSXYZ, OCC_PNT_UPDATE.DB_PROJ, the
occ voxel dropout with and without REAL_DROP, PARAMS.REMAIN_PERCENTAGE
and the sigmoid occ loss; with their helpers (`db_proj_expand`,
`real_drop_det_points`) in cylinder and cartesian coordinates. PASS_GRAD
and K2's backward are in tests/test_torch_pass_grad.py.

Each config runs the JAX `OccSubnet` alone (as tests/test_occ_pillar.py
drives it, with the fused merge the detector selects) and the port's on
the micro config, float32, same batch and weights
(`weights.occ_subnet_state`); the occupancy bias is moved to 0 so random
weights emit occ points. Each JAX compile costs 10-15 s here, so the
options share two eval and two train configs. The JAX draws
(`jax.random.uniform` in the subnet) are read back through debug
callbacks and handed to the port's `draw_occ_dropout` / `draw_occ_remain`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, f32_mode, perturb_variables, to_np_tree

B = 2
MIN_OCC_POINTS = 20
# the train gradients: each occ parameter's within this share of its max
GRAD_RTOL = 1e-3

TARGET_KEYS = ("voxelwise_mask", "vcc_mask", "occ_voxelwise_mask", "fore_voxelwise_mask",
               "mirr_voxelwise_mask", "bm_voxelwise_mask", "pos_mask", "neg_mask",
               "general_cls_loss_mask")
TRAIN_KEYS = ("general_cls_loss_mask_float", "general_reg_loss_mask",
              "general_reg_loss_mask_float", "res_mtrx")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _set(path, value):
    def edit(cfgs):
        node = cfgs[path[0]]
        for k in path[1:-1]:
            node = node[k]
        node[path[-1]] = value
    return edit


def _unset(path):
    def edit(cfgs):
        node = cfgs[path[0]]
        for k in path[1:-1]:
            node = node[k]
        node.pop(path[-1], None)
    return edit


# option -> the edits of the micro config that turn it on
OPTIONS = {
    "back_track": [_set(("data", "OCC", "REVERSE_VIS"), "BACK_TRACK")],
    "vcc": [_set(("data", "OCC", "REVERSE_VIS"), "VCC")],
    "absxyz_original": [_set(("data", "OCC", "USE_ABSXYZ"), "original")],
    "absxyz_both": [_set(("data", "OCC", "USE_ABSXYZ"), "both")],
    "pillar_2d": [_set(("model", "OCC", "TARGETS", "NAME"), "OccTargetsPillar"),
                  _set(("model", "OCC", "OCC_DENSE_HEAD", "NAME"), "OccHead2D")],
    "deconv_res": [_set(("model", "OCC", "BACKBONE_3D", "NAME"), "VoxelBackBoneDeconvRes")],
    "inverse_res": [_set(("model", "OCC", "BACKBONE_3D", "NAME"), "VoxelBackBoneInverseRes")],
    "db_proj": [_set(("model", "OCC", "OCC_PNT_UPDATE", "DB_PROJ"), True),
                _set(("model", "OCC", "OCC_PNT_UPDATE", "MERGED_CAP_EXTRA"), 1024)],
    "dropout_real_drop": [_set(("data", "OCC", "DROPOUT_RATE"), 0.6),
                          _unset(("data", "OCC", "REAL_DROP"))],
    "dropout": [_set(("data", "OCC", "DROPOUT_RATE"), 0.6),
                _set(("data", "OCC", "REAL_DROP"), False)],
    "remain": [_set(("model", "OCC", "PARAMS", "REMAIN_PERCENTAGE"), [0.5, 1.0])],
    "sigmoid": [_set(("model", "OCC", "OCC_DENSE_HEAD", "LOSS_CONFIG", "CLS_LOSS_TYPE"),
                     "sigmoid")],
}
# the configs the JAX package runs (each JAX compile costs 10-15 s here):
# every option in an eval config and in a train config
EVAL_CONFIGS = ("back_track+absxyz_original+pillar_2d+deconv_res",
                "vcc+absxyz_both+inverse_res+db_proj")
TRAIN_CONFIGS = ("dropout_real_drop+remain+pillar_2d+inverse_res+vcc",
                 "dropout+sigmoid+deconv_res+absxyz_both+db_proj+back_track")


def option_cfgs(config):
    """The JAX package's micro (data, model) configs with the options of
    `config` ("+"-joined names of OPTIONS, or "" for none) on."""
    from btcdet_tpu.datasets.mini_config import micro_data_cfg, micro_model_cfg

    cfgs = {"data": micro_data_cfg(with_occ=True), "model": micro_model_cfg(with_occ=True)}
    for option in filter(None, config.split("+")):
        for edit in OPTIONS[option]:
            edit(cfgs)
    return cfgs["data"], cfgs["model"]


def _det_voxel_size(data_cfg):
    return next(tuple(p.VOXEL_SIZE) for p in data_cfg.DATA_PROCESSOR
                if p.NAME == "det_transform_points_to_voxels")


class _Uniforms:
    """`jax.random.uniform` replaced for a trace: each call's [0, 1) draw
    comes back through a debug callback (in call order), and the result is
    the draw scaled into [minval, maxval) the way jax.random.uniform does."""

    def __init__(self):
        self.draws, self.orig = {}, jax.random.uniform
        self.calls = 0

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = self.orig(key, shape, dtype)
        i = self.calls
        self.calls += 1
        jax.debug.callback(lambda v, i=i: self.draws.__setitem__(i, np.asarray(v)), u)
        return jnp.maximum(minval, u * (maxval - minval) + minval)

    def __enter__(self):
        jax.random.uniform = self
        return self

    def __exit__(self, *exc):
        jax.random.uniform = self.orig


def _batch(config, train: bool):
    """The micro batch of `config` (the JAX package's synthetic batch, seed
    0, B=2), numpy."""
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch

    data_cfg, _ = option_cfgs(config)
    return jax_batch(data_cfg, batch_size=B, num_points=2048, num_gt=4, seed=0,
                     mode="train" if train else "test")


@functools.cache
def jax_run(config, train: bool):
    """The JAX `OccSubnet` alone on the micro batch: its outputs, the
    backbone's (volume, mask) at eval, the loss and the parameter
    gradients at train, its uniform draws, the variables, and DB_PROJ's
    arguments and kept candidates (`db_proj`)."""
    from btcdet_tpu.config import CfgBox
    from btcdet_tpu.models.occ import occ_subnet as JOS

    data_cfg, model_cfg = option_cfgs(config)
    batch_np = _batch(config, train)
    res = {"batch": batch_np}
    orig_db = JOS.db_proj_expand

    def db_proj(*args, **kw):
        pts, keep = orig_db(*args, **kw)
        res["db_proj_kw"] = kw
        jax.debug.callback(lambda *v: res.update(db_proj=[np.asarray(x) for x in v]),
                           *args, keep)
        return pts, keep

    with f32_mode():
        net = JOS.OccSubnet(model_cfg=CfgBox(model_cfg.OCC), data_cfg=CfgBox(data_cfg),
                            point_cloud_range=tuple(data_cfg.POINT_CLOUD_RANGE),
                            det_voxel_size=_det_voxel_size(data_cfg), fused_vfe_nrf=4)
        jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
        rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
                "dropout": jax.random.PRNGKey(2)}
        variables = perturb_variables(jax.jit(lambda b: net.init(rngs, b, train=False))(jb))
        variables["params"]["conv_cls"]["bias"] = np.zeros_like(
            variables["params"]["conv_cls"]["bias"])
        res["variables"] = variables
        apply_rngs = {"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}
        JOS.db_proj_expand = db_proj
        try:
            with _Uniforms() as draws:
                if train:
                    def loss_fn(params):
                        out, _ = net.apply({"params": params,
                                            "batch_stats": variables["batch_stats"]}, jb,
                                           train=True, rngs=apply_rngs, mutable=["batch_stats"])
                        return out["loss"], out
                    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                        variables["params"])
                    res["loss"], res["grads"] = float(loss), to_np_tree(grads)
                else:
                    out, inter = jax.jit(lambda v, b: net.apply(
                        v, b, train=False, mutable=["intermediates"],
                        capture_intermediates=lambda mdl, name: name == "__call__"))(
                            variables, jb)
                    res["bb"] = to_np_tree(inter["intermediates"]["backbone_3d"]["__call__"][0])
                jax.effects_barrier()
        finally:
            JOS.db_proj_expand = orig_db
        res["draws"] = [draws.draws[i] for i in range(draws.calls)]
        res["out"] = {k: np.asarray(v) for k, v in out.items() if v is not None}
    return res


@functools.cache
def port_run(config, train: bool, parity: bool = True):
    """The port's `OccSubnet` on `config`'s micro batch. `parity`: with the
    JAX run's weights and draws (its gradients mapped alongside the port's
    at train), DB_PROJ expanding the JAX run's points; otherwise with synthetic weights (occupancy bias 0) and
    draws from a seeded generator, no JAX run."""
    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch import weights as W
    from btcdet_tpu_torch.models.occ import occ_subnet as TOS

    data_cfg, model_cfg = option_cfgs(config)
    tc = tcfg.EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
    ref = jax_run(config, train) if parity else None
    batch = ref["batch"] if parity else _batch(config, train)
    draws = list(ref["draws"]) if parity else []
    orig = (TOS.draw_occ_dropout, TOS.draw_occ_remain, TOS.db_proj_expand)
    seen = {}

    def db_proj(*args, **kw):
        # the JAX run's points: a point within float32 rounding of a det cell
        # edge would shift its whole lattice by a cell in one package
        return orig[2](*(t(a).to(x.dtype) for a, x in zip(ref["db_proj"], args)), **kw)

    def dropout(generator, rows, n):
        ratio, row = draws.pop(0), draws.pop(0)
        return t(ratio), t(row.reshape(rows, n))

    def remain(generator, rows, ncell):
        rate, use = draws.pop(0), draws.pop(0)
        return t(rate.reshape(rows)), t(use)

    with f32_mode():
        port = TOS.OccSubnet(tc.MODEL.OCC, tc.DATA_CONFIG, tuple(data_cfg.POINT_CLOUD_RANGE),
                             _det_voxel_size(data_cfg), 4)
        if parity:
            v = ref["variables"]
            sd = {k: t(np.array(x)) for k, x in W.occ_subnet_state(
                v["params"], v["batch_stats"], prefix="").items()}
        else:
            sd = W.synth_state_dict(port)
            sd["occ_dense_head.conv_cls.0.bias"].zero_()
        port.load_state_dict(sd, strict=True)
        port.train(train)
        hook = port.backbone_3d.register_forward_hook(lambda m, i, o: seen.update(bb=o))
        if parity:
            TOS.draw_occ_dropout, TOS.draw_occ_remain = dropout, remain
            TOS.db_proj_expand = db_proj
        try:
            out = port({k: t(x) for k, x in batch.items()}, torch.Generator().manual_seed(0))
        finally:
            TOS.draw_occ_dropout, TOS.draw_occ_remain, TOS.db_proj_expand = orig
            hook.remove()
        assert not draws, f"{len(draws)} JAX draws left unused"
        res = {"out": {k: x.detach().numpy() for k, x in out.items() if torch.is_tensor(x)}}
        x, m = seen["bb"]
        res["bb"] = (x.detach().permute(0, 2, 3, 4, 1).numpy(), m.numpy())
        if train:
            out["loss"].backward()
            res["loss"] = float(out["loss"].detach())
            res["grads"] = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
            if parity:
                res["ref_grads"] = {k: np.array(x) for k, x in W.occ_subnet_state(
                    ref["grads"], ref["variables"]["batch_stats"], prefix="").items()
                    if k in res["grads"]}
    return res


def same_point_sets(a, am, b, bm, tol=1e-4):
    """Per frame the valid rows of a and b pair up one to one within `tol`
    (max abs difference), in whatever order: probabilities that tie to
    within f32 rounding may rank in another order in the two packages."""
    for f in range(a.shape[0]):
        pa, pb = a[f][am[f]], b[f][bm[f]]
        assert pa.shape == pb.shape, (f, pa.shape, pb.shape)
        d = np.abs(pa[:, None, :] - pb[None, :, :]).max(-1)
        assert len(np.unique(d.argmin(1))) == len(pa), f"frame {f}: points pair up twice"
        assert d.min(1).max(initial=0.0) <= tol, (f, d.min(1).max())


def _merged_by_coord(o):
    c = o["det_voxel_coords"]
    v = c[:, 0] >= 0
    order = np.lexsort(c[v].T[::-1])
    return c[v][order], [o[k][v][order] for k in ("det_voxel_features", "det_occ_code",
                                                  "det_voxel_num_points")]


def db_proj_rounding_cells(ref):
    """`db_proj_expand` of the port on the JAX run's arguments keeps the
    JAX package's candidates but for those whose det cell centre lies on an
    occ cell edge to float32 rounding (the micro grid has them: the centre
    (2.8, -2.1) is at r = 3.5, z = -1.25 is a z edge): those round to either
    side (XLA on the CPU contracts x * x + y * y and the lattice arithmetic
    into fused multiply-adds and divides by a constant as a multiply by its
    reciprocal, torch does neither). Returns the det cells within one cell
    of such a candidate, of the lattice of a point on a det cell edge, or of
    a kept candidate on a det cell edge, (b, z, y, x)."""
    from btcdet_tpu_torch.models.occ import occ_subnet as TOS
    from btcdet_tpu_torch.utils import coords as TC

    *args, ref_keep = ref["db_proj"]
    kw = ref["db_proj_kw"]
    _, keep = TOS.db_proj_expand(*(t(a) for a in args), **kw)
    b, j = np.nonzero(keep.numpy() != ref_keep)
    xyz, rot = args[0], args[4]
    lo, vs = np.asarray(kw["det_lo"]), np.asarray(kw["det_vs"])
    E = keep.shape[1] // xyz.shape[1]
    offs = [np.arange(-e, e + 1, st) for e, st in zip(kw["expand"], kw["stride"])]
    off = np.stack(np.meshgrid(*offs, indexing="ij")[::-1], -1).reshape(-1, 3)
    c0 = np.clip(np.floor((xyz[b, j // E].astype(np.float64) - lo) / vs), 0,
                 np.asarray(kw["det_grid"]) - 1)
    cand = c0 + off[j % E]
    occ = TC.cartesian_to_occ((cand + 0.5) * vs + lo, kw["coord_type"])
    occ[:, 1] += rot[b]
    frac = (occ - np.asarray(kw["occ_lo"])) / np.asarray(kw["occ_vs"])
    on_edge = (np.abs(frac - np.round(frac)) < 1e-4).any(1)
    assert on_edge.all(), frac[~on_edge]
    # ... and the lattices of the points on a det cell edge: XLA divides by
    # the voxel size as a multiply by its reciprocal, so such a point's det
    # cell, and its whole lattice, may be one off
    q = (xyz.astype(np.float64) - lo) / vs
    pb, pk = np.nonzero((np.abs(q - np.round(q)) < 1e-4).any(-1) & args[2])
    lat = np.clip(np.floor(q[pb, pk]), 0, np.asarray(kw["det_grid"]) - 1)[:, None] + off
    cells = [(bb, c) for bb, c in zip(b, cand)]
    cells += [(bb, c) for bb, cs in zip(pb, lat) for c in cs]
    # ... and the kept candidates whose centre lies on a det cell edge (a
    # half-cell lattice offset on a whole cell): the merge floors it to
    # either side, for the same reasons
    _, kb, kj = (None, *np.nonzero(ref_keep))
    kc = np.clip(np.floor((xyz[kb, kj // E].astype(np.float64) - lo) / vs), 0,
                 np.asarray(kw["det_grid"]) - 1) + off[kj % E] + 0.5
    edge = (np.abs(kc - np.round(kc)) < 1e-4).any(-1)
    cells += [(bb, c - 0.5) for bb, c in zip(kb[edge], kc[edge])]
    near = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return {(int(bb), *(int(v) for v in (np.floor(c + 0.5) + d)[::-1]))
            for bb, c in cells for d in near}


def check_merged(out, ref, ref_run=None):
    """The merged det table as a set of coordinates, with each one's point
    count exact and its features and occ code to 1e-4. Under DB_PROJ the
    port's run expanded the JAX run's own arguments (`port_run`), so the
    candidates differ only where `db_proj_rounding_cells` says, and those
    cells are left out."""
    rc, rv = _merged_by_coord(ref)
    oc, ov = _merged_by_coord(out)
    if ref_run is not None and "db_proj" in ref_run:
        skip = db_proj_rounding_cells(ref_run)
        rk = np.array([tuple(c) not in skip for c in rc.tolist()], bool)
        ok = np.array([tuple(c) not in skip for c in oc.tolist()], bool)
        assert rk.sum() > 0.9 * len(rc), (rk.sum(), len(rc))
        rc, rv = rc[rk], [v[rk] for v in rv]
        oc, ov = oc[ok], [v[ok] for v in ov]
    np.testing.assert_array_equal(oc, rc)
    assert_close(ov[0], rv[0])
    assert_close(ov[1], rv[1])
    np.testing.assert_array_equal(ov[2], rv[2])


# ------------------------------------------------------------------ eval


@pytest.mark.parametrize("config", EVAL_CONFIGS)
def test_eval_masks_and_backbone_match(config):
    """Every target mask exact; the occ backbone's mask exact and its
    volume to 1e-4."""
    ref, out = jax_run(config, False), port_run(config, False)
    for k in TARGET_KEYS:
        np.testing.assert_array_equal(out["out"][k], ref["out"][k], err_msg=k)
    assert ref["out"]["general_cls_loss_mask"].any()
    rx, rm = ref["bb"]
    x, m = out["bb"]
    np.testing.assert_array_equal(m, rm)
    assert_close(x, rx)


@pytest.mark.parametrize("config", EVAL_CONFIGS)
def test_eval_occ_points_and_merge_match(config):
    """Probabilities to 1e-4; the occ point masks exact and the points as
    sets to 1e-4; the merged det table as sets."""
    run, port = jax_run(config, False), port_run(config, False)
    ref, out = run["out"], port["out"]
    assert_close(out["probs"], ref["probs"])
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    assert (ref["occ_points_mask"].sum(1) >= MIN_OCC_POINTS).all()
    same_point_sets(out["occ_points"], out["occ_points_mask"], ref["occ_points"],
                    ref["occ_points_mask"])
    check_merged(out, ref, run)


# ----------------------------------------------------------------- train


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_train_loss_and_gradients_match(config):
    """The train targets and loss maps (the dropout masks included), the
    loss to 1e-4 and every occ parameter's gradient within 1e-3 of its
    max, with the JAX draws."""
    ref, out = jax_run(config, True), port_run(config, True)
    for k in TARGET_KEYS + TRAIN_KEYS + ("voxel_drop_mask", "fore_voxel_drop_mask"):
        if k in ref["out"]:
            assert_close(out["out"][k], ref["out"][k], err_msg=k)
    assert_close(out["loss"], ref["loss"])
    assert set(out["grads"]) == set(out["ref_grads"])
    for n, g in out["ref_grads"].items():
        scale = max(float(np.abs(g).max()), 1e-12)
        err = float(np.abs(out["grads"][n] - g).max())
        assert err <= GRAD_RTOL * scale, (n, err, scale)


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_train_occ_points_and_merge_match(config):
    """At train: the occ point masks exact and the points as sets, and the
    merged det table (REAL_DROP takes the dropped occ voxels' det points
    out of it; REMAIN_PERCENTAGE thins the candidates)."""
    run, port = jax_run(config, True), port_run(config, True)
    ref, out = run["out"], port["out"]
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    assert ref["occ_points_mask"].sum() > 0
    same_point_sets(out["occ_points"], out["occ_points_mask"], ref["occ_points"],
                    ref["occ_points_mask"])
    check_merged(out, ref, run)


# ------------------------------------------- what each option changes (port)


def _port(config, train=False):
    return port_run(config, train, parity=False)["out"]


@pytest.mark.parametrize("option", ["back_track", "vcc"])
def test_reverse_vis_changes_the_occlusion_mask(option):
    assert (_port(option)["occ_voxelwise_mask"] != _port("")["occ_voxelwise_mask"]).any()


def test_pillar_targets_dilate_whole_columns():
    """OccTargetsPillar's predict area is the same at every z of a column
    and covers the 3-D one."""
    vcc, vcc3 = _port("pillar_2d")["vcc_mask"], _port("")["vcc_mask"]
    assert (vcc == vcc[:, :1]).all() and (vcc3 <= vcc).all() and (vcc3 != vcc).any()


def test_db_proj_densifies_the_merge_only():
    """DB_PROJ merges more det rows than the default, and the ConvHead's
    occ points stay the unexpanded ones."""
    base, out = _port(""), _port("db_proj")
    rows = [int((o["det_voxel_coords"][:, 0] >= 0).sum()) for o in (base, out)]
    assert rows[1] > rows[0], rows
    np.testing.assert_array_equal(out["occ_points"], base["occ_points"])


def test_dropout_drops_rows_and_real_drop_drops_det_points():
    """The dropout draws drop some occ voxel rows (their cells marked in
    voxel_drop_mask), and REAL_DROP leaves fewer det points in the merged
    table than the same draws without it."""
    on, off = _port("dropout_real_drop", True), _port("dropout", True)
    np.testing.assert_array_equal(on["voxel_drop_mask"], off["voxel_drop_mask"])
    assert on["voxel_drop_mask"].any() and on["fore_voxel_drop_mask"].any()
    assert on["det_voxel_num_points"].sum() < off["det_voxel_num_points"].sum()


def test_remain_percentage_thins_the_candidates():
    """REMAIN_PERCENTAGE drops candidates before the top-K: some of the
    default run's occ points are missing with it."""
    base, out = _port("", True), _port("remain", True)
    pts = [{tuple(p) for p in o["occ_points"][0][o["occ_points_mask"][0]].tolist()}
           for o in (base, out)]
    assert pts[1] and pts[0] - pts[1], [len(p) for p in pts]


# --------------------------------------------------------------- helpers


def _db_proj_case(coord_type):
    rng = np.random.RandomState(0 if coord_type == "cartesian" else 1)
    Bh, K = 2, 24
    if coord_type == "cartesian":
        det_lo, det_vs, det_grid = (0.0, -4.0, -1.0), (0.1, 0.1, 0.1), (80, 80, 20)
        occ_lo, occ_vs = det_lo, (0.8, 0.8, 0.4)
        xyz = np.stack([rng.uniform(0.5, 7.5, (Bh, K)), rng.uniform(-3.5, 3.5, (Bh, K)),
                        rng.uniform(-0.9, 0.9, (Bh, K))], -1).astype(np.float32)
        rot = np.zeros((Bh,), np.float32)
        occ = xyz
    else:
        from btcdet_tpu_torch.utils import coords as TC

        det_lo, det_vs, det_grid = (0.0, -3.2, -3.0), (0.2, 0.2, 0.1), (32, 32, 41)
        occ_lo, occ_vs = (2.0, -40.0, -2.6), (0.5, 4.0, 0.45)
        r, az = rng.uniform(2.5, 6.0, (Bh, K)), np.radians(rng.uniform(-25, 25, (Bh, K)))
        xyz = np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-2.0, 0.5, (Bh, K))],
                       -1).astype(np.float32)
        rot = np.array([0.0, 1.5], np.float32)
        occ = TC.cartesian_to_occ(xyz.astype(np.float64), "cylinder")
        occ[..., 1] += rot[:, None]
    src = np.floor((occ - np.asarray(occ_lo)) / np.asarray(occ_vs)).astype(np.int32)
    tail = rng.rand(Bh, K, 3).astype(np.float32)
    valid = rng.rand(Bh, K) < 0.8
    kw = dict(det_lo=det_lo, det_vs=det_vs, det_grid=det_grid, occ_lo=occ_lo, occ_vs=occ_vs,
              coord_type=coord_type, expand=(1.0, 5.0, 3.0), stride=(1.0, 2.5, 1.5))
    return (xyz, tail, valid, src, rot), kw


@pytest.mark.parametrize("coord_type", ["cartesian", "cylinder"])
def test_db_proj_expand_matches(coord_type):
    """The kept candidates exact, their points to 1e-5 (the float32 trig
    of the two packages)."""
    from btcdet_tpu.models.occ import occ_subnet as JOS

    from btcdet_tpu_torch.models.occ import occ_subnet as TOS

    args, kw = _db_proj_case(coord_type)
    ref_pts, ref_keep = (np.asarray(r) for r in JOS.db_proj_expand(
        *(jnp.asarray(a) for a in args), **kw))
    pts, keep = TOS.db_proj_expand(*(t(a) for a in args), **kw)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert ref_keep.sum() > args[2].sum()
    assert_close(pts.numpy(), ref_pts, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("coord_type", ["cartesian", "cylinder"])
def test_real_drop_det_points_matches(coord_type):
    """The compacted det table and the point counts, exact."""
    from btcdet_tpu.models.occ import occ_subnet as JOS

    from btcdet_tpu_torch.models.occ import occ_subnet as TOS

    rng = np.random.RandomState(4)
    Bh, N, Pd = 2, 60, 5
    if coord_type == "cartesian":
        occ_lo, occ_vs, grid = (0.0, -4.0, -1.0), (1.0, 1.0, 1.0), (8, 8, 2)
        xyz = rng.uniform((0.0, -4.5, -1.2), (8.5, 4.0, 1.0), (Bh, N, Pd, 3))
    else:
        occ_lo, occ_vs, grid = (2.0, -40.0, -2.6), (0.5, 4.0, 0.45), (9, 20, 8)
        r, az = rng.uniform(1.5, 7.0, (Bh, N, Pd)), np.radians(rng.uniform(-45, 45, (Bh, N, Pd)))
        xyz = np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-2.8, 1.2, (Bh, N, Pd))], -1)
    num = rng.randint(0, Pd + 1, (Bh, N)).astype(np.int32)
    vox = np.concatenate([xyz, rng.rand(Bh, N, Pd, 1)], -1).astype(np.float32)
    vox *= (np.arange(Pd)[None, None] < num[..., None])[..., None]
    drop = rng.rand(Bh, grid[2], grid[1], grid[0]) < 0.3
    rot = np.array([0.0, 2.0], np.float32)
    kw = dict(occ_lo=occ_lo, occ_vs=occ_vs, occ_grid=grid, coord_type=coord_type)
    ref_vox, ref_num = (np.asarray(r) for r in JOS.real_drop_det_points(
        jnp.asarray(vox), jnp.asarray(num), jnp.asarray(drop), jnp.asarray(rot), **kw))
    out_vox, out_num = TOS.real_drop_det_points(t(vox), t(num), t(drop), t(rot), **kw)
    np.testing.assert_array_equal(out_num.numpy(), ref_num)
    assert 0 < ref_num.sum() < num.sum()
    np.testing.assert_array_equal(out_vox.numpy(), ref_vox)


@pytest.mark.parametrize("path,value,error", [
    (("data", "OCC", "COORD_TYPE"), "cartesian", NotImplementedError),
    (("model", "OCC", "OCC_PNT_UPDATE", "MERGE_IMPL"), "v3", KeyError),
    (("model", "OCC", "TARGETS", "NAME"), "OccTargets2D", KeyError),
    (("model", "OCC", "OCC_DENSE_HEAD", "NAME"), "OccHead1D", KeyError),
    (("model", "OCC", "BACKBONE_3D", "NAME"), "VoxelBackBone", KeyError),
], ids=lambda v: v[-1] if isinstance(v, tuple) else None)
def test_still_refused(path, value, error):
    """What the port still refuses: a cartesian occ grid (the host
    processor refuses it too, as the JAX package's does); unknown module
    and merge names raise KeyError, as in the JAX package. The unfused
    merge runs (tests/test_torch_det_vfe.py)."""
    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.models.occ import occ_subnet as TOS

    cfgs = dict(zip(("data", "model"), option_cfgs("")))
    _set(path, value)(cfgs)
    tc = tcfg.EasyDict({"DATA_CONFIG": cfgs["data"], "MODEL": cfgs["model"]})
    with pytest.raises(error):
        TOS.OccSubnet(tc.MODEL.OCC, tc.DATA_CONFIG, tuple(tc.DATA_CONFIG.POINT_CLOUD_RANGE),
                      (0.2, 0.2, 0.1), 4)
