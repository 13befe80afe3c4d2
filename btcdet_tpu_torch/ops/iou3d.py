"""Rotated-BEV box overlap / IoU and rotated NMS (counterpart of
`btcdet_tpu/ops/iou3d.py`).

The intersection of two rotated rectangles is computed by vectorized
Sutherland-Hodgman clipping with a slot-doubling vertex ring, the same
arithmetic as the JAX package, so the NMS keeps the same boxes.
`boxes_bev_iou_cpu` is the same clipping in numpy, for the host data
pipeline (the gt sampler's collision test): the JAX package's numpy path,
so the augmentor draws the same boxes, and no torch op in loader workers.

The rotated NMS of CUDA tensors is one kernel launch for a batch of frames
(`nms_rotated_batched`, `csrc/nms_rotated.cu`): it takes every decision of
the plain version (`nms_rotated_plain`, which CPU tensors take) with the
same float32 IoU to the bit, and reads nothing back. Its wrapper counts its
launches as the recorder's counter `launch.nms_rotated` and hands the chunks
each frame walked to the tally `nms.chunks`.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ..utils import box_utils, trace
from ..utils.trace import readback
from . import kernel_build


def _ring_forward_fill(verts, valid):
    """Replace invalid ring slots with the nearest preceding valid vertex
    (cyclically), by log2-step doubling."""
    P, S, _ = verts.shape
    v = torch.cat([verts, verts], dim=1)
    m = torch.cat([valid, valid], dim=1)
    step = 1
    while step < 2 * S:
        v_shift = torch.roll(v, step, dims=1)
        m_shift = torch.roll(m, step, dims=1)
        v = torch.where(m[..., None], v, v_shift)
        m = m | m_shift
        step *= 2
    return v[:, S:], m[:, S:]


def _pairwise_intersection_area(corners_a, corners_b):
    """corners_a (N, 4, 2), corners_b (M, 4, 2) -> (N, M) overlap area:
    A's quad clipped by B's four half-planes."""
    N, M = corners_a.shape[0], corners_b.shape[0]
    P = N * M
    b = corners_b[None].expand(N, M, 4, 2).reshape(P, 4, 2)
    b_next = torch.roll(b, -1, dims=1)
    winding = torch.sign(
        (b_next[..., 0] - b[..., 0]) * (b_next[..., 1] + b[..., 1])).sum(dim=1, keepdim=True)
    winding = torch.where(winding == 0, torch.ones_like(winding), torch.sign(winding))

    verts = corners_a[:, None].expand(N, M, 4, 2).reshape(P, 4, 2)
    alive = torch.ones((P,), dtype=torch.bool, device=corners_a.device)
    for e in range(4):
        e0 = b[:, e]
        ed = b_next[:, e] - e0
        d = (ed[:, None, 0] * (verts[..., 1] - e0[:, None, 1])
             - ed[:, None, 1] * (verts[..., 0] - e0[:, None, 0])) * (-winding)
        nxt = torch.roll(verts, -1, dims=1)
        d_nxt = torch.roll(d, -1, dims=1)
        in_cur = d >= 0
        in_nxt = d_nxt >= 0
        denom = d - d_nxt
        t = d / torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom), denom)
        pint = verts + t[..., None] * (nxt - verts)
        S = verts.shape[1]
        out = torch.stack([verts, pint], dim=2).reshape(P, 2 * S, 2)
        oval = torch.stack([in_cur, in_cur != in_nxt], dim=2).reshape(P, 2 * S)
        alive = alive & oval.any(dim=1)
        verts, _ = _ring_forward_fill(out, oval & alive[:, None])
    nxt = torch.roll(verts, -1, dims=1)
    contrib = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    area = 0.5 * torch.abs(contrib.sum(dim=1))
    return torch.where(alive, area, torch.zeros_like(area)).reshape(N, M)


def boxes_overlap_bev(boxes_a, boxes_b):
    """Rotated BEV overlap area (N, 7) x (M, 7) -> (N, M): box a clipped by box b."""
    return _pairwise_intersection_area(box_utils.boxes_to_corners_bev(boxes_a),
                                       box_utils.boxes_to_corners_bev(boxes_b))


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU (N, 7) x (M, 7) -> (N, M)."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU: rotated BEV overlap x z overlap over the union volume
    (reference `iou3d_nms_utils.boxes_iou3d_gpu`)."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_top, a_bot = boxes_a[:, 2] + boxes_a[:, 5] / 2, boxes_a[:, 2] - boxes_a[:, 5] / 2
    b_top, b_bot = boxes_b[:, 2] + boxes_b[:, 5] / 2, boxes_b[:, 2] - boxes_b[:, 5] / 2
    overlap_h = (torch.minimum(a_top[:, None], b_top[None, :])
                 - torch.maximum(a_bot[:, None], b_bot[None, :])).clamp(min=0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


NMS_CHUNK = 256


def _greedy_chunked(top_boxes, top_valid, post_max_size: int, thresh: float,
                    chunk: int = NMS_CHUNK):
    """The JAX package's chunked NMS (`iou3d.nms_rotated(impl="chunked")`):
    score-ordered chunks, each first suppressed by the survivors so far
    (candidate clipped by survivor), then greedily within itself; stops
    once `post_max_size` survive. About k * (chunk + post) box pairs."""
    with readback("nms.valid"):
        valid = top_valid.cpu().numpy()
    kept = []
    for c0 in range(0, top_boxes.shape[0], chunk):
        if len(kept) >= post_max_size:
            break
        cv = valid[c0:c0 + chunk]
        if not cv.any():
            continue
        cb = top_boxes[c0:c0 + chunk]
        # the survivors' indices are copied to the device: a wait once there are any
        with readback("nms.survivors") if kept else contextlib.nullcontext():
            cols = torch.cat([top_boxes[torch.as_tensor(kept, dtype=torch.int64,
                                                        device=cb.device)], cb])
        over = boxes_iou_bev(cb, cols) > thresh
        with readback("nms.chunk"):
            over = over.cpu().numpy()
        alive = cv & ~over[:, :len(kept)].any(axis=1)
        inner = over[:, len(kept):]
        for i in range(cb.shape[0]):
            if alive[i]:
                alive[i + 1:] &= ~inner[i, i + 1:]
        kept.extend((c0 + np.flatnonzero(alive))[:post_max_size - len(kept)].tolist())
    return kept


def nms_rotated_plain(boxes, scores, valid, *, thresh: float, pre_max_size: int,
                      post_max_size: int):
    """Greedy rotated-BEV NMS (reference `nms_gpu` semantics), in plain
    PyTorch on any device, a frame at a time.

    The top `pre_max_size` valid candidates by score (ties broken by the
    lower index, like `lax.top_k`) are visited in score order; each one
    still alive is kept and suppresses every candidate whose IoU with it
    exceeds `thresh`, until `post_max_size` are kept. The suppression is
    worked out chunk by chunk (`_greedy_chunked`), never as a k x k
    matrix. Returns (indices (post_max_size,) int64 into the input,
    0-padded, and their validity)."""
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    k = min(pre_max_size, boxes.shape[0])
    top_scores, top_idx = torch.sort(s, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_valid = top_scores > neg_inf
    out_idx = torch.zeros((post_max_size,), dtype=torch.int64)
    out_valid = torch.zeros((post_max_size,), dtype=torch.bool)
    if k > 0:
        top_boxes = boxes[top_idx]
        kept = _greedy_chunked(top_boxes, top_valid, post_max_size, thresh)
        if kept:
            kept_t = torch.as_tensor(kept, dtype=torch.int64)
            with readback("nms.kept"):
                out_idx[:len(kept)] = top_idx.cpu()[kept_t]
            out_valid[:len(kept)] = True
    with readback("nms.out"):                   # the kept indices copied to the device
        return out_idx.to(boxes.device), out_valid.to(boxes.device)


def nms_rotated(boxes, scores, valid, *, thresh: float, pre_max_size: int,
                post_max_size: int):
    """Greedy rotated-BEV NMS of one frame: boxes (N, 7), scores (N,),
    valid (N,) -> (indices (post_max_size,) int64 into the input, 0-padded,
    and their validity), with `nms_rotated_plain`'s semantics. A CUDA
    tensor runs the batched kernel as a batch of one."""
    if boxes.device.type == "cuda":
        idx, ok = nms_rotated_batched(boxes[None], scores[None], valid[None], thresh=thresh,
                                      pre_max_size=pre_max_size, post_max_size=post_max_size)
        return idx[0], ok[0]
    return nms_rotated_plain(boxes, scores, valid, thresh=thresh, pre_max_size=pre_max_size,
                             post_max_size=post_max_size)


def nms_rotated_batched(boxes, scores, valid, *, thresh: float, pre_max_size: int,
                        post_max_size: int):
    """`nms_rotated` of every frame of a batch: boxes (B, N, 7), scores
    (B, N), valid (B, N) -> (indices (B, post_max_size) int64, validity
    (B, post_max_size)), each frame's as `nms_rotated_plain` gives it.

    CUDA tensors: one stable sort of all frames' scores, the top k =
    min(pre_max_size, N) boxes gathered with their BEV corners
    (`box_utils.boxes_to_corners_bev`, as the plain version builds them)
    and areas, then one launch of `csrc/nms_rotated.cu`; nothing is read
    back. CPU tensors take `nms_rotated_plain` frame by frame."""
    B, N = scores.shape
    if boxes.device.type != "cuda":
        out = [nms_rotated_plain(boxes[b], scores[b], valid[b], thresh=thresh,
                                 pre_max_size=pre_max_size, post_max_size=post_max_size)
               for b in range(B)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_rotated_batched: boxes and scores must be float32, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if (boxes.dim() != 3 or boxes.shape[:2] != (B, N) or boxes.shape[2] < 7
            or valid.shape != (B, N)):
        raise ValueError(f"nms_rotated_batched: bad shapes boxes {tuple(boxes.shape)} scores "
                         f"{tuple(scores.shape)} valid {tuple(valid.shape)}")
    dev = boxes.device
    out_idx = torch.zeros((B, post_max_size), dtype=torch.int64, device=dev)
    out_valid = torch.zeros((B, post_max_size), dtype=torch.bool, device=dev)
    k = min(pre_max_size, N)
    if k <= 0:
        return out_idx, out_valid
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    top_scores, top_idx = torch.sort(s, dim=1, descending=True, stable=True)
    top_idx = top_idx[:, :k].contiguous()
    top_valid = (top_scores[:, :k] > neg_inf).contiguous()
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(B, k, boxes.shape[2]))
    corners = box_utils.boxes_to_corners_bev(top_boxes.reshape(B * k, -1)).contiguous()
    areas = (top_boxes[..., 3] * top_boxes[..., 4]).contiguous()
    chunks = torch.empty((B,), dtype=torch.int32, device=dev)
    fn, order = _nms_fn("nms_rotated", dev)
    err = fn(corners.data_ptr(), areas.data_ptr(), top_valid.data_ptr(), top_idx.data_ptr(),
             B, k, post_max_size, thresh, order, out_idx.data_ptr(), out_valid.data_ptr(),
             chunks.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_rotated kernel launch failed: cudaError {err}")
    trace.count("launch.nms_rotated")
    trace.tally("nms.chunks", lambda: chunks)
    return out_idx, out_valid


def boxes_iou_bev_kernel(boxes_a, boxes_b):
    """The NMS kernel's rotated BEV IoU (N, 7) x (M, 7) -> (N, M) float32 on
    CUDA tensors: its device function on every pair (A = row, B = column),
    equal to `boxes_iou_bev`'s to the bit. For the tests."""
    if boxes_a.device.type != "cuda" or boxes_b.device != boxes_a.device:
        raise ValueError("boxes_iou_bev_kernel: CUDA tensors on one device")
    if boxes_a.dtype != torch.float32 or boxes_b.dtype != torch.float32:
        raise TypeError("boxes_iou_bev_kernel: float32 boxes")
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    ca = box_utils.boxes_to_corners_bev(boxes_a).contiguous()
    cb = box_utils.boxes_to_corners_bev(boxes_b).contiguous()
    aa = (boxes_a[:, 3] * boxes_a[:, 4]).contiguous()
    ab = (boxes_b[:, 3] * boxes_b[:, 4]).contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=boxes_a.device)
    fn, order = _nms_fn("rotated_iou", boxes_a.device)
    err = fn(ca.data_ptr(), aa.data_ptr(), n, cb.data_ptr(), ab.data_ptr(), m, order,
             out.data_ptr(), torch.cuda.current_stream(boxes_a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotated_iou kernel launch failed: cudaError {err}")
    return out


_ARGTYPES = {
    "nms_rotated": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 4,
    "rotated_iou": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p],
}
# per device: which order PyTorch's CUDA sum adds a row of 64 float32 in
_SUM_ORDER: dict = {}


def _nms_fn(name: str, device):
    """The kernel entry `name` of `csrc/nms_rotated.cu` and the sum order
    its shoelace follows on `device` (`ring_sum_order`)."""
    fn = getattr(kernel_build.load("nms_rotated"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    key = str(device)
    if key not in _SUM_ORDER:
        _SUM_ORDER[key] = ring_sum_order(device)
    return fn, _SUM_ORDER[key]


def ring_tree_sum(rows: np.ndarray, falling: bool) -> np.ndarray:
    """float32 sums of rows (P, 64) in the order of PyTorch's CUDA reduction
    of a contiguous row of 64: x and x + 32 paired, then a warp-shuffle
    tree with offsets 16, 8, 4, 2, 1 (`falling`) or 1, 2, 4, 8, 16."""
    s = rows[:, :32] + rows[:, 32:]
    if falling:
        for o in (16, 8, 4, 2, 1):
            s[:, :o] = s[:, :o] + s[:, o:2 * o]
    else:
        for o in (1, 2, 4, 8, 16):
            s[:, ::2 * o] = s[:, ::2 * o] + s[:, o::2 * o]
    return s[:, 0]


def sum_probe_rows() -> np.ndarray:
    """(64, 64) float32 rows of wide range, on which `ring_tree_sum`'s two
    orders give other sums."""
    rng = np.random.RandomState(0)
    return (rng.standard_normal((64, 64)) * np.exp2(rng.randint(-24, 24, (64, 64)))
            ).astype(np.float32)


def ring_sum_order(device) -> int:
    """1 if `Tensor.sum(dim=1)` of a (P, 64) float32 CUDA tensor adds in
    `ring_tree_sum`'s falling order, 0 if in its rising one (it changed
    between PyTorch versions); raises if in neither. The plain clipper's
    shoelace is that sum (one read-back, once a device and process)."""
    rows = sum_probe_rows()
    got = torch.from_numpy(rows).to(device).sum(dim=1).cpu().numpy()
    for order, falling in ((1, True), (0, False)):
        if np.array_equal(got.view(np.int32), ring_tree_sum(rows.copy(), falling).view(np.int32)):
            return order
    raise RuntimeError("nms_rotated: PyTorch's CUDA sum of a row of 64 follows neither known "
                       "order, so the kernel's IoU would not equal the plain version's")


def nms_normal(boxes, scores, valid, *, thresh: float, pre_max_size: int,
               post_max_size: int):
    """The place of the reference's `nms_normal_gpu`: the JAX package
    suppresses by the same rotated BEV IoU as `nms_rotated`, so this is
    `nms_rotated` (no shipped config selects it)."""
    return nms_rotated(boxes, scores, valid, thresh=thresh, pre_max_size=pre_max_size,
                       post_max_size=post_max_size)


# ------------------------------------------------------------------ numpy

def _ring_forward_fill_np(verts, valid):
    P, S, _ = verts.shape
    v = np.concatenate([verts, verts], axis=1)
    m = np.concatenate([valid, valid], axis=1)
    step = 1
    while step < 2 * S:
        v_shift = np.roll(v, step, axis=1)
        m_shift = np.roll(m, step, axis=1)
        v = np.where(m[..., None], v, v_shift)
        m = m | m_shift
        step *= 2
    return v[:, S:], m[:, S:]


def _pairwise_intersection_area_np(corners_a, corners_b):
    """`_pairwise_intersection_area` in numpy, in the input's dtype."""
    N, M = corners_a.shape[0], corners_b.shape[0]
    P = N * M
    b = np.broadcast_to(corners_b[None], (N, M, 4, 2)).reshape(P, 4, 2)
    b_next = np.roll(b, -1, axis=1)
    winding = np.sign(
        (b_next[..., 0] - b[..., 0]) * (b_next[..., 1] + b[..., 1])).sum(axis=1, keepdims=True)
    winding = np.where(winding == 0, 1.0, np.sign(winding))
    verts = np.broadcast_to(corners_a[:, None], (N, M, 4, 2)).reshape(P, 4, 2)
    alive = np.ones((P,), dtype=bool)
    for e in range(4):
        e0 = b[:, e]
        ed = b_next[:, e] - e0
        d = (ed[:, None, 0] * (verts[..., 1] - e0[:, None, 1])
             - ed[:, None, 1] * (verts[..., 0] - e0[:, None, 0])) * (-winding)
        nxt = np.roll(verts, -1, axis=1)
        d_nxt = np.roll(d, -1, axis=1)
        in_cur = d >= 0
        in_nxt = d_nxt >= 0
        denom = d - d_nxt
        t = d / np.where(np.abs(denom) < 1e-12, 1.0, denom)
        pint = verts + t[..., None] * (nxt - verts)
        S = verts.shape[1]
        out = np.stack([verts, pint], axis=2).reshape(P, 2 * S, 2)
        oval = np.stack([in_cur, in_cur != in_nxt], axis=2).reshape(P, 2 * S)
        alive = alive & np.any(oval, axis=1)
        verts, _ = _ring_forward_fill_np(out, oval & alive[:, None])
    nxt = np.roll(verts, -1, axis=1)
    contrib = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    area = 0.5 * np.abs(contrib.sum(axis=1))
    return np.where(alive, area, 0.0).reshape(N, M)


def boxes_bev_iou_cpu(boxes_a, boxes_b) -> np.ndarray:
    """Rotated BEV IoU of numpy boxes (N, 7) x (M, 7) -> (N, M), numpy in
    the inputs' dtype."""
    boxes_a, boxes_b = np.asarray(boxes_a), np.asarray(boxes_b)
    inter = _pairwise_intersection_area_np(box_utils.boxes_to_corners_bev_np(boxes_a),
                                           box_utils.boxes_to_corners_bev_np(boxes_b))
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / np.clip(area_a + area_b - inter, 1e-6, None)
