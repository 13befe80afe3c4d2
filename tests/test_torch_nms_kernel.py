"""The rotated-NMS kernel (`ops/iou3d.nms_rotated_batched`,
`csrc/nms_rotated.cu`) against its plain version (`iou3d.nms_rotated_plain`,
a frame at a time) on the card: the same IoU to the bit, the same kept
indices and validity at the eval path's shapes (the proposal NMS, k 1024 ->
100 at 0.7, and the final NMS, k 100 -> 500 at 0.1) on 200 frames each, at
the train step's (k 9000 -> 256 at 0.8) with survivors carried over several
chunks, and on the edge cases; one launch a call, the chunks walked in the
`nms.chunks` tally. Tests marked `cuda` skip where no card is present; run
them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_nms_kernel.py -m cuda`."""

import numpy as np
import pytest
import torch

from btcdet_tpu_torch.ops import iou3d
from btcdet_tpu_torch.utils import trace

PROPOSAL = dict(thresh=0.7, pre_max_size=1024, post_max_size=100)
FINAL = dict(thresh=0.1, pre_max_size=4096, post_max_size=500)
TRAIN = dict(thresh=0.8, pre_max_size=9000, post_max_size=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def crowded_frames(seed, B, n, objects, jitter=(0.3, 0.3, 0.1, 0.15, 0.08, 0.05, 0.1),
                   spread=40.0, p_valid=0.95):
    """B frames of n boxes crowded round `objects` centres each (the RPN's
    and ConvHead's boxes gather on the objects), random scores with ties,
    validity drawn at p_valid: float32 numpy (B, n, 7), (B, n), bool (B, n)."""
    rng = np.random.RandomState(seed)
    centres = np.zeros((B, objects, 7), np.float32)
    centres[..., :2] = rng.uniform(-spread, spread, (B, objects, 2))
    centres[..., 2] = rng.uniform(-2, 0, (B, objects))
    centres[..., 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.6, 1.9, 1.8], (B, objects, 3))
    centres[..., 6] = rng.uniform(-np.pi, np.pi, (B, objects))
    pick = rng.randint(0, objects, (B, n))
    boxes = np.take_along_axis(centres, pick[..., None], axis=1)
    boxes = boxes + rng.normal(0, 1, (B, n, 7)) * np.asarray(jitter, np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6])
    scores = rng.rand(B, n).astype(np.float32)
    scores[:, ::9] = scores[:, :1]                                    # ties
    valid = rng.rand(B, n) < p_valid
    return boxes.astype(np.float32), scores, valid


def on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def plain_frames(boxes, scores, valid, **kw):
    out = [iou3d.nms_rotated_plain(boxes[b], scores[b], valid[b], **kw)
           for b in range(boxes.shape[0])]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def assert_same(kernel, plain, what):
    (ki, kv), (pi, pv) = kernel, plain
    assert torch.equal(kv, pv), f"{what}: validity differs in frames " \
        f"{torch.nonzero((kv != pv).any(1)).flatten().tolist()}"
    assert torch.equal(ki, pi), f"{what}: kept indices differ in frames " \
        f"{torch.nonzero((ki != pi).any(1)).flatten().tolist()}"


@pytest.mark.cuda
def test_iou_equals_plain_to_the_bit(cuda):
    """The kernel's IoU device function on every pair (A = row, B = column)
    of crowded boxes, a tenth of them with a zero width, equals
    `boxes_iou_bev`'s float32 bit for bit."""
    boxes, _, _ = crowded_frames(0, 1, 600, 20, spread=15.0)
    boxes = boxes[0]
    boxes[::10, 3] = 0.0
    boxes[1] = boxes[0]                                               # a duplicate
    a, b = on(cuda, boxes[:400], boxes[200:])
    got = iou3d.boxes_iou_bev_kernel(a, b)
    want = iou3d.boxes_iou_bev(a, b)
    assert int((want > 0).sum()) > 2000
    differ = ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
    assert not differ.any(), f"{int(differ.sum())} pairs differ, max " \
        f"{float((got - want)[differ].abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n", [("proposal", 2000), ("final", 100)])
def test_kept_sets_at_eval_shapes(cuda, shape, n):
    """200 seeded frames, 25 batches of 8, at the eval path's NMS shapes,
    the boxes loosely or tightly clustered by turns (the proposal NMS then
    keeps its 100 in the second chunk, or walks all four): the kernel keeps
    what the plain version keeps, frame by frame."""
    kw = PROPOSAL if shape == "proposal" else FINAL
    kept, walked = [], []
    for seed in range(25):
        jitter = (0.3, 0.3, 0.1, 0.15, 0.08, 0.05, 0.1) if seed % 2 else \
            (0.1, 0.1, 0.05, 0.08, 0.04, 0.03, 0.04)
        boxes, scores, valid = on(cuda, *crowded_frames(
            seed, 8, n, 12 if shape == "proposal" else 10, jitter=jitter,
            p_valid=0.95 if shape == "proposal" else 0.6))
        trace.enable()
        got = iou3d.nms_rotated_batched(boxes, scores, valid, **kw)
        walked += trace.disable().tally("nms.chunks").tolist()
        assert_same(got, plain_frames(boxes, scores, valid, **kw), f"{shape} seed {seed}")
        kept += got[1].sum(1).tolist()
    assert 0 < min(kept) and min(kept) < kw["post_max_size"]
    if shape == "proposal":
        assert max(kept) == 100 and set(walked) >= {2, 4}, (kept, walked)


@pytest.mark.cuda
def test_train_shape_over_several_chunks(cuda):
    """k 9000 -> 256 at 0.8 over boxes of 300 tight clusters in random score
    order: the survivors of each chunk suppress the next ones (IoU(A =
    candidate, B = survivor)) over at least three chunks, and post is
    reached inside a later chunk; the `nms.chunks` tally reads the chunks
    the plain version read back."""
    boxes, scores, valid = crowded_frames(3, 2, 12000, 300, spread=120.0,
                                          jitter=(0.04, 0.04, 0.02, 0.03, 0.02, 0.02, 0.01))
    boxes, scores, valid = on(cuda, boxes, scores, valid)
    trace.enable()
    got = iou3d.nms_rotated_batched(boxes, scores, valid, **TRAIN)
    chunks = trace.disable().tally("nms.chunks").tolist()
    read_back = []
    for b in range(2):
        trace.enable()
        want = iou3d.nms_rotated_plain(boxes[b], scores[b], valid[b], **TRAIN)
        read_back.append(trace.disable().sync_counts()["nms.chunk"])
        assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1]), b
    assert chunks == read_back and min(chunks) >= 3 and (got[1].sum(1) == 256).all(), chunks


@pytest.mark.cuda
def test_edge_cases(cuda):
    """Nothing valid; every box the same (one kept); post reached inside the
    first chunk; every score tied (the lower index first): each as the plain
    version decides it."""
    far = np.zeros((1, 300, 7), np.float32)
    far[0, :, 0] = np.arange(300) * 3.0
    far[0, :, 3:6] = [2.0, 1.0, 1.5]
    boxes, scores, valid = crowded_frames(5, 1, 300, 4)
    cases = {
        "nothing valid": (boxes, scores, np.zeros_like(valid), PROPOSAL),
        "all one box": (np.repeat(boxes[:, :1], 300, 1), scores, valid, FINAL),
        "post inside a chunk": (far, scores, valid, dict(PROPOSAL, post_max_size=40)),
        "tied scores": (boxes, np.full_like(scores, 0.5), valid, PROPOSAL),
        "tied and far": (far, np.zeros_like(scores), valid, dict(FINAL, post_max_size=7)),
    }
    for what, (b, s, v, kw) in cases.items():
        b, s, v = on(cuda, b, s, v)
        got = iou3d.nms_rotated_batched(b, s, v, **kw)
        assert_same(got, plain_frames(b, s, v, **kw), what)
        n = int(got[1].sum())
        assert n == {"nothing valid": 0, "all one box": 1, "post inside a chunk": 40,
                     "tied and far": 7}.get(what, n), (what, n)


@pytest.mark.cuda
def test_frames_independent_of_their_batch(cuda):
    """Each frame of a batch of 8 keeps what it keeps alone (B = 1, through
    `nms_rotated`), with different valid counts a frame."""
    boxes, scores, valid = crowded_frames(11, 8, 2000, 12)
    valid[np.arange(8)[:, None] * 250 <= np.arange(2000)[None]] = False   # 0 ... 1750 valid
    boxes, scores, valid = on(cuda, boxes, scores, valid)
    idx, ok = iou3d.nms_rotated_batched(boxes, scores, valid, **PROPOSAL)
    for b in range(8):
        one = iou3d.nms_rotated(boxes[b], scores[b], valid[b], **PROPOSAL)
        assert torch.equal(one[0], idx[b]) and torch.equal(one[1], ok[b]), b
    assert int(ok[0].sum()) == 0 and int(ok[7].sum()) > 0


@pytest.mark.cuda
def test_one_launch_a_call_and_the_chunk_tally(cuda):
    """`launch.nms_rotated` counts one launch a call, whatever the batch;
    the tally holds a frame's chunks walked (a frame with nothing valid
    walks none)."""
    boxes, scores, valid = crowded_frames(13, 4, 700, 200, spread=100.0)
    valid[1] = False
    boxes, scores, valid = on(cuda, boxes, scores, valid)
    before = trace.COUNTS.get("launch.nms_rotated", 0)
    trace.enable()
    iou3d.nms_rotated_batched(boxes, scores, valid, thresh=0.7, pre_max_size=700,
                              post_max_size=1000)
    iou3d.nms_rotated(boxes[0], scores[0], valid[0], **PROPOSAL)
    rec = trace.disable()
    assert trace.COUNTS["launch.nms_rotated"] - before == 2
    assert rec.counts["launch.nms_rotated"] == 2 and rec.sync_counts() == {}
    walked = rec.tallies["nms.chunks"]
    assert walked[0].tolist() == [3, 0, 3, 3] and walked[1].tolist() == [1]
