"""The occupancy slice of the port against the JAX package on the CPU:
the occ target masks, the dense occ backbone, the occ head, PassOccVox's
occ points, the fused merge + OccVFE, and K2's plain version (sparse
max-pool), module by module on random inputs and stage by stage on the
full micro config (same batch, same weights through
`weights.from_jax_variables`, float32, exact ball queries)."""

import numpy as np
import pytest
import torch

from torch_parity import assert_close, f32_mode, full_micro_run, to_np_tree

# the occupancy bias moved off its logit(0.01) prior, so random weights
# emit occ points (the JAX init predicts almost none above OCC_THRESH)
MIN_OCC_POINTS = 20
MIN_EXTRA_ROWS = 5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# ------------------------------------------------------- module level


def _occ_spec_pair(data_cfg):
    from btcdet_tpu.models.occ import occ_targets as JT

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.models.occ import occ_targets as TT

    return JT.build_grid_spec(data_cfg), TT.build_grid_spec(tcfg.EasyDict(data_cfg))


def _data_cfg(which):
    from btcdet_tpu.config import cfg_from_yaml_file
    from btcdet_tpu.datasets.mini_config import micro_data_cfg

    from btcdet_tpu_torch import config as tcfg

    if which == "micro":
        return micro_data_cfg(with_occ=True)
    return cfg_from_yaml_file(tcfg.FLAGSHIP_CFG).DATA_CONFIG


@pytest.mark.parametrize("coord_type", ["cylinder", "sphere", "cartesian"])
def test_coords_match(coord_type):
    """Both directions of the occ coordinate transforms, on torch float32
    tensors (against jnp) and on float64 numpy arrays (exact)."""
    import jax.numpy as jnp

    from btcdet_tpu.utils import coords as JC

    from btcdet_tpu_torch.utils import coords as TC

    rng = np.random.RandomState(11)
    pts = np.concatenate([rng.uniform(-40, 70, (500, 2)), rng.uniform(-3, 2, (500, 1)),
                          rng.rand(500, 1)], 1)
    occ = JC.cartesian_to_occ(pts, coord_type)
    np.testing.assert_array_equal(TC.cartesian_to_occ(pts, coord_type), occ)
    back = JC.occ_uvd_to_absxyz(occ[:, 0], occ[:, 1], occ[:, 2], coord_type)
    np.testing.assert_array_equal(TC.occ_uvd_to_absxyz(occ[:, 0], occ[:, 1], occ[:, 2],
                                                       coord_type), back)
    np.testing.assert_allclose(back, pts[:, :3], atol=1e-9)

    p32 = pts.astype(np.float32)
    o32 = TC.cartesian_to_occ(t(p32), coord_type)
    assert_close(o32.numpy(), np.asarray(JC.cartesian_to_occ(jnp.asarray(p32), coord_type)))
    j = jnp.asarray(o32.numpy())
    assert_close(TC.occ_uvd_to_absxyz(o32[:, 0], o32[:, 1], o32[:, 2], coord_type).numpy(),
                 np.asarray(JC.occ_uvd_to_absxyz(j[:, 0], j[:, 1], j[:, 2], coord_type)))


@pytest.mark.parametrize("which", ["micro", "flagship"])
def test_grid_spec_is_identical(which):
    js, ts = _occ_spec_pair(_data_cfg(which))
    for f in js._fields:
        if f == "sphere_reproj_2d":
            continue
        a, b = getattr(js, f), getattr(ts, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("which", ["micro", "flagship"])
def test_occlusion_mask_matches(which):
    """Random world points through the sphere grid, the empty-beam rule,
    the range cumsum and the sphere -> cylinder map: exact."""
    import jax.numpy as jnp

    from btcdet_tpu.models.occ import occ_targets as JT

    from btcdet_tpu_torch.models.occ import occ_targets as TT

    js, ts = _occ_spec_pair(_data_cfg(which))
    rng = np.random.RandomState(3)
    n, B = 6000, 2
    r = rng.uniform(2.5, js.point_cloud_range[3] - 0.5, n)
    az = np.radians(rng.uniform(-38, 38, n))
    pts = np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-2.0, 0.5, n)], 1).astype(np.float32)
    valid = rng.rand(n) < 0.9
    pb = (np.arange(n) >= n // 2).astype(np.int32)
    rot = np.array([0.0, 1.5], np.float32)
    ref = np.asarray(JT.occlusion_mask(js, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pb),
                                       jnp.asarray(rot), B))
    out = TT.occlusion_mask(TT.GridTables(ts), t(pts), t(valid), t(pb).long(), t(rot), B).numpy()
    assert ref.any() and (~ref).any()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kern,concede", [((5, 9, 5), 2), ((3, 5, 3), 0), ((3, 5, 3), 1)])
def test_dilate_predict_area_matches(kern, concede):
    import jax.numpy as jnp

    from btcdet_tpu.models.occ import occ_targets as JT

    from btcdet_tpu_torch.models.occ import occ_targets as TT

    m = np.random.RandomState(1).rand(2, 9, 20, 16) < 0.03
    ref = np.asarray(JT.dilate_predict_area(jnp.asarray(m), kern, concede))
    np.testing.assert_array_equal(TT.dilate_predict_area(t(m), kern, concede).numpy(), ref)


def test_mirror_and_box_membership_match():
    import jax.numpy as jnp

    from btcdet_tpu.models.occ import occ_targets as JT

    from btcdet_tpu_torch.models.occ import occ_targets as TT

    rng = np.random.RandomState(5)
    B, m, G = 2, 500, 3
    boxes = np.zeros((B, G, 8), np.float32)
    boxes[..., :3] = rng.uniform(-3, 3, (B, G, 3))
    boxes[..., 3:6] = rng.uniform(1.5, 4.0, (B, G, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    boxes[..., 7] = 1
    boxes[1, 2, 7] = 0
    pts = rng.uniform(-4, 4, (B * m, 3)).astype(np.float32)
    valid = rng.rand(B * m) < 0.9
    gv = boxes[..., 7] > 1e-2
    flag = np.array([[1, 0, 1], [1, 1, 1]], np.float32)
    ref = JT.mirror_points_in_boxes_blocked(jnp.asarray(pts), jnp.asarray(valid),
                                            jnp.asarray(boxes), jnp.asarray(gv),
                                            jnp.asarray(flag), B)
    out = TT.mirror_points_in_boxes_blocked(t(pts), t(valid), t(boxes), t(gv), t(flag), B)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert np.asarray(ref[2]).any()
    sel = np.asarray(ref[2])
    assert_close(out[1].numpy()[sel], np.asarray(ref[1])[sel])
    ref_in = JT.points_in_gt_blocked(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(boxes),
                                     jnp.asarray(gv), B)
    np.testing.assert_array_equal(TT.points_in_gt_blocked(t(pts), t(valid), t(boxes), t(gv),
                                                          B).numpy(), np.asarray(ref_in))


@pytest.mark.parametrize("transpose,stride,sub", [(False, 1, False), (False, 2, False),
                                                  (False, 1, True), (True, 2, False)],
                         ids=["conv", "strided", "subm", "transpose"])
def test_dense_sparse_block_matches(transpose, stride, sub):
    """One masked dense block, the transpose conv included: the port keeps
    the spconv deconv weights as stored, the JAX package flips them
    (`ref_import.t_deconv3d`)."""
    import jax
    import jax.numpy as jnp

    from btcdet_tpu.models.backbones_3d import _DenseSparseBlock
    from btcdet_tpu.train import ref_import

    from btcdet_tpu_torch.models.backbones_3d import DenseSparseBlock

    rng = np.random.RandomState(7)
    B, D, H, W, ci, co = 2, 5, 11, 9, 4, 6
    mask = rng.rand(B, D, H, W) < 0.3
    x = (rng.randn(B, D, H, W, ci) * mask[..., None]).astype(np.float32)
    w_ref = (rng.randn(3, 3, 3, ci, co) * 0.3).astype(np.float32)     # spconv layout
    bn = dict(scale=rng.normal(1, 0.2, co), bias=rng.normal(0, 0.1, co),
              mean=rng.normal(0, 0.3, co), var=rng.uniform(0.5, 1.5, co))
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    blk = _DenseSparseBlock(co, stride=(stride,) * 3, transpose=transpose, submanifold=sub)
    with f32_mode():
        v = blk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False)
        v = to_np_tree(v)
        conv = "ConvTranspose_0" if transpose else "Conv_0"
        v["params"][conv]["kernel"] = ref_import.t_deconv3d(w_ref) if transpose else w_ref
        v["params"]["_DenseBN_0"]["MaskedBatchNorm_0"] = {"scale": bn["scale"],
                                                          "bias": bn["bias"]}
        v["batch_stats"]["_DenseBN_0"]["MaskedBatchNorm_0"] = {"mean": bn["mean"],
                                                               "var": bn["var"]}
        ref_y, ref_m = blk.apply(v, jnp.asarray(x), jnp.asarray(mask), False)
        port = DenseSparseBlock(ci, co, stride=stride, transpose=transpose,
                                submanifold=sub).eval()
        port.load_state_dict({"0.weight": t(w_ref), "1.weight": t(bn["scale"]),
                              "1.bias": t(bn["bias"]), "1.running_mean": t(bn["mean"]),
                              "1.running_var": t(bn["var"]),
                              "1.num_batches_tracked": torch.zeros((), dtype=torch.long)})
        with torch.no_grad():
            y, m = port(t(x).permute(0, 4, 1, 2, 3), t(mask))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    assert np.asarray(ref_m).any()
    assert_close(y.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref_y))


def _merge_case(seed, Nd=300, Pd=5, K=400, grid=(40, 36, 12), extra=60):
    rng = np.random.RandomState(seed)
    nx, ny, nz = grid
    lo, vs = (0.0, -1.8, -0.6), (0.1, 0.1, 0.1)
    B = 2
    dvox = np.zeros((B, Nd, Pd, 4), np.float32)
    dcoords = np.full((B, Nd, 4), -1, np.int32)
    dnum = np.zeros((B, Nd), np.int32)
    for b in range(B):
        keys = np.sort(rng.choice(nx * ny * nz, Nd - 40 * (b + 1), replace=False))
        n = len(keys)
        dcoords[b, :n] = np.stack([np.full(n, b), keys // (ny * nx), keys % (ny * nx) // nx,
                                   keys % nx], 1)
        dnum[b, :n] = rng.randint(1, Pd + 1, n)
        slots = np.arange(Pd)[None, :] < dnum[b, :n, None]
        dvox[b, :n] = rng.randn(n, Pd, 4) * slots[..., None]
    # occ points: some in det voxels (shared cells), some new, some out of range
    base = dcoords[:, rng.randint(0, Nd - 80, K // 2), 1:4][..., ::-1].astype(np.float32)
    cells = np.concatenate([base, rng.randint(0, 12, (B, K - K // 2, 3)).astype(np.float32)
                            * np.array([3.3, 3.0, 1.0], np.float32)], axis=1)
    xyz = np.asarray(lo, np.float32) + (cells + rng.uniform(0.05, 0.95, cells.shape)) \
        * np.asarray(vs, np.float32)
    xyz[:, :7] += np.array([-0.5, 0.2, 3.0], np.float32)          # clamped into edge voxels
    prob = rng.uniform(0.3, 1.0, (B, K)).astype(np.float32)
    valid = rng.rand(B, K) < 0.8
    opts = np.concatenate([xyz, np.zeros((B, K, 1), np.float32), prob[..., None],
                           np.ones((B, K, 1), np.float32)], -1) * valid[..., None]
    return dvox, dcoords, dnum, opts.astype(np.float32), valid, dict(
        grid_size=grid, lo=lo, vs=vs, extra=extra, max_points=8, num_raw_features=4)


@pytest.mark.parametrize("seed,extra", [(0, 60), (1, 7)], ids=["roomy", "capped"])
def test_fused_merge_matches(seed, extra):
    """Kept set, clamp-into-edge rule, MERGED_CAP_EXTRA cap, counts and
    coords exact; features and occ code to f32 reassociation."""
    import jax
    import jax.numpy as jnp

    from btcdet_tpu.ops import voxelizer as JV

    from btcdet_tpu_torch.ops import voxelizer as TV

    dvox, dc, dn, opts, valid, kw = _merge_case(seed)
    kw["extra"] = extra
    jkw = dict(kw, lo=jnp.asarray(kw["lo"], jnp.float32), vs=jnp.asarray(kw["vs"], jnp.float32))
    ref = jax.vmap(lambda *a: JV.merge_points_into_voxel_features(*a, **jkw))(
        jnp.asarray(dvox), jnp.asarray(dc), jnp.asarray(dn), jnp.asarray(opts),
        jnp.asarray(valid))
    ref = [np.asarray(r) for r in ref]
    tkw = dict(kw, lo=torch.tensor(kw["lo"]), vs=torch.tensor(kw["vs"]))
    out = [o.numpy() for o in TV.merge_points_into_voxel_features(
        t(dvox), t(dc), t(dn), t(opts), t(valid), **tkw)]
    np.testing.assert_array_equal(out[4], ref[4])                  # row_valid
    rv = ref[4]
    assert rv[:, dvox.shape[1]:].sum() >= 2 * min(extra, 5)
    np.testing.assert_array_equal(out[3][rv], ref[3][rv])          # coords
    np.testing.assert_array_equal(out[2][rv], ref[2][rv])          # counts
    assert_close(out[0][rv], ref[0][rv])                           # features
    np.testing.assert_array_equal(out[1][rv], ref[1][rv])          # occ code (max)


def test_fused_merge_sums_each_voxels_points_in_point_order():
    """The merge sums a voxel's points in point order: four raw points
    into one det voxel whose values cancel only in that
    order in f32 ((1e8 + 1) - 1e8 + 1 = 1, where any other order gives 0
    or 2), then the det voxel's own point."""
    from btcdet_tpu_torch.ops import voxelizer as TV

    dvox = torch.zeros((1, 2, 5, 4))
    dvox[0, 0, 0] = torch.tensor([1.5, 1.5, 0.5, 0.25])
    dc = torch.tensor([[[0, 0, 1, 1], [-1, -1, -1, -1]]], dtype=torch.int32)
    dn = torch.tensor([[1, 0]], dtype=torch.int32)
    inten = [1e8, 1.0, -1e8, 1.0]
    opts = torch.tensor([[[1.1 + 0.1 * i, 1.5, 0.5, v, 0.0] for i, v in enumerate(inten)]])
    feats, _, num, _, rv = TV.merge_points_into_voxel_features(
        dvox, dc, dn, opts, torch.ones((1, 4), dtype=torch.bool), grid_size=(4, 4, 2),
        lo=torch.zeros(3), vs=torch.ones(3), extra=2, max_points=8, num_raw_features=4)
    s = np.float32(0.0)
    for v in inten:
        s = np.float32(s + np.float32(v))
    assert s == 1.0 and int(num[0, 0]) == 5 and bool(rv[0, 0])
    assert float(feats[0, 0, 3]) == float(np.float32(s + np.float32(0.25)) / np.float32(5.0))


def _sparse_table(seed, n=900, shape=(11, 40, 36), batch=2, C=2):
    from btcdet_tpu_torch.ops import sparse as TS

    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(0, batch, n), rng.randint(0, shape[0], n),
                  rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1)
    c = np.unique(c, axis=0).astype(np.int32)
    c = np.concatenate([c, np.full((37, 4), -1, np.int32)])
    f = rng.rand(len(c), C).astype(np.float32)
    f[c[:, 0] < 0] = 0
    return TS.from_coords(t(f), t(c), shape, batch)


def test_sparse_pool_plain_matches_jax_engine():
    """K2's plain version against the XLA twin `apply_rulebook_max` and the
    Pallas kernel in interpret mode (mode "max", bf16 table)."""
    import jax.numpy as jnp

    from btcdet_tpu.ops import pallas_conv as P
    from btcdet_tpu.ops import sparse as S

    from btcdet_tpu_torch.ops import cuda_pool
    from btcdet_tpu_torch.ops import sparse as TS

    st = _sparse_table(6)
    keys, coords, _, _ = TS.conv_output_sites(st, 3, 2, 1, st.capacity)
    out = cuda_pool.sparse_pool(st.features, st.keys, coords, st.spatial_shape, st.batch_size,
                                3, 2, 1).numpy()
    jst = S.from_coords(jnp.asarray(st.features.numpy()), jnp.asarray(st.coords.numpy()),
                        st.spatial_shape, st.batch_size)
    jkeys, jcoords, _, _ = S.conv_output_sites(jst, 3, 2, 1, jst.capacity)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
    in_idx, found = S.conv_rulebook(jst, jcoords, jkeys != S.INT32_MAX, 3, 2, 1)
    ref = np.asarray(S.apply_rulebook_max(jst.features, in_idx, found))
    np.testing.assert_array_equal(out, ref)
    assert (out[np.asarray(found).any(0)] > 0).all() and (out[coords.numpy()[:, 0] < 0] == 0).all()

    qk, G, TPG = P.qkeys_conv(jcoords, jkeys != S.INT32_MAX, jst.spatial_shape, jst.batch_size,
                              3, 2, 1, 128)
    pal = np.asarray(P.fused_pool(jst.features, jst.keys, qk, G, TPG, mode="max",
                                  M=jkeys.shape[0], interpret=True))
    bf = torch.from_numpy(st.features.numpy()).to(torch.bfloat16).float()
    out_bf = cuda_pool.sparse_pool(bf, st.keys, coords, st.spatial_shape, st.batch_size, 3, 2, 1)
    np.testing.assert_allclose(pal, out_bf.numpy(), atol=2e-2, rtol=2e-2)


def test_sparse_maxpool_module_reuses_cached_sites():
    """The pool takes the sites the strided conv of its indice_key cached,
    and refuses to run before they exist."""
    from btcdet_tpu_torch.ops import sparse as TS

    st = _sparse_table(8)
    cache = {}
    conv = TS.SparseConv3d(2, 4, 3, 2, 1, indice_key="spconv2", frame_capacity=(300, 300))
    x = conv(st, cache)
    pooled = TS.SparseMaxPool3d(3, 2, 1, indice_key="spconv2")(st, cache)
    assert pooled.keys is x.keys and pooled.capacity == 600
    with pytest.raises(RuntimeError, match="spconv2"):
        TS.SparseMaxPool3d(3, 2, 1, indice_key="spconv2")(st, {})


# ------------------------------------------------------- the full micro model


@pytest.fixture(scope="module")
def full_micro():
    """The full micro config (occ subnet on) through both packages
    (`torch_parity.full_micro_run`, shared with the model tests)."""
    return full_micro_run()


@pytest.mark.parametrize("key", ["voxelwise_mask", "vcc_mask", "occ_voxelwise_mask",
                                 "fore_voxelwise_mask", "mirr_voxelwise_mask",
                                 "bm_voxelwise_mask", "general_cls_loss_mask", "pos_mask"])
def test_eval_target_masks_match(full_micro, key):
    ref, out = full_micro["ref_occ"][key], full_micro["occ"][key]
    np.testing.assert_array_equal(out, ref)
    if key in ("vcc_mask", "occ_voxelwise_mask", "general_cls_loss_mask", "pos_mask"):
        assert ref.any(), key


def test_occ_backbone_output_matches(full_micro):
    x, m = full_micro["bb"]
    rx, rm = full_micro["ref_bb"]
    np.testing.assert_array_equal(m, rm)
    assert_close(x, rx)


def test_occ_probs_match(full_micro):
    ref, out = full_micro["ref"], full_micro["out"]
    assert_close(out["occ_probs"], ref["occ_probs"])
    assert_close(full_micro["occ"]["res_pred"], full_micro["ref_occ"]["res_pred"])
    np.testing.assert_array_equal(out["occ_pos_mask"], ref["occ_pos_mask"])
    np.testing.assert_array_equal(out["occ_cls_mask"], ref["occ_cls_mask"])


def test_occ_points_match(full_micro):
    """Same points in the same order (top-K tie order included)."""
    ref, out = full_micro["ref"], full_micro["out"]
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    assert (ref["occ_points_mask"].sum(1) >= MIN_OCC_POINTS).all(), ref["occ_points_mask"].sum(1)
    assert_close(out["occ_points"], ref["occ_points"])


def test_merged_det_voxels_match(full_micro):
    """The merged det table as a set of (b, z, y, x) per frame, with each
    coordinate's features, occ code and point count."""
    ref, occ, pf = full_micro["ref_occ"], full_micro["occ"], full_micro["per_frame"]
    rc, oc = ref["det_voxel_coords"], occ["det_voxel_coords"]
    B = 2
    merged = rc.shape[0] // B
    extra_rows = (rc.reshape(B, merged, 4)[:, pf:, 0] >= 0).sum(1)
    assert (extra_rows >= MIN_EXTRA_ROWS).all(), extra_rows

    def by_coord(c, *vals):
        v = c[:, 0] >= 0
        order = np.lexsort(c[v].T[::-1])
        return c[v][order], [x[v][order] for x in vals]

    rcs, rvals = by_coord(rc, ref["det_voxel_features"], ref["det_occ_code"],
                          ref["det_voxel_num_points"])
    ocs, ovals = by_coord(oc, occ["det_voxel_features"], occ["det_occ_code"],
                          occ["det_voxel_num_points"])
    np.testing.assert_array_equal(ocs, rcs)
    # the occ code is a max of probabilities, which differ by f32 rounding
    assert_close(ovals[0], rvals[0])
    assert_close(ovals[1], rvals[1])
    np.testing.assert_array_equal(ovals[2], rvals[2])
