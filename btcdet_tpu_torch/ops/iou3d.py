"""Rotated-BEV box overlap / IoU and rotated NMS (counterpart of
`btcdet_tpu/ops/iou3d.py`).

The intersection of two rotated rectangles is computed by vectorized
Sutherland-Hodgman clipping with a slot-doubling vertex ring, the same
arithmetic as the JAX package, so the NMS keeps the same boxes.
`boxes_bev_iou_cpu` is the same clipping in numpy, for the host data
pipeline (the gt sampler's collision test): the JAX package's numpy path,
so the augmentor draws the same boxes, and no torch op in loader workers.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils import box_utils
from ..utils.trace import readback


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


def nms_rotated(boxes, scores, valid, *, thresh: float, pre_max_size: int,
                post_max_size: int):
    """Greedy rotated-BEV NMS (reference `nms_gpu` semantics).

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
