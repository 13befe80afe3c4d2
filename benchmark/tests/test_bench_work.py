"""The benchmark's work counts on hand-counted tiny shapes."""

import torch

from benchmark.reference.btcref.ops import cuda_conv, cuda_interp
from benchmark.reference.btcref.ops import sparse as rsparse
from benchmark.work import counts


def test_k1_work_by_hand():
    # 10 matched pairs, 4 -> 8 channels: 10 * 4 * 8 multiply-adds
    flops, nbytes = counts.k1_work(pairs=10, n_in=6, m_out=5, taps=27, cin=4, cout=8)
    assert flops == 2 * 10 * 4 * 8
    assert nbytes == 6 * 4 * 2 + 27 * 4 * 8 * 2 + 5 * 8 * 4


def test_k4_work_by_hand():
    flops, nbytes = counts.k4_work(samples=3, cells=5, rois=2, points=2, channels=8)
    assert flops == 3 * 8 * 16
    assert nbytes == 5 * 8 * 2 + 2 * 2 * 13 + 2 * 2 * 8 * 2


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0, counts.PEAK_BF16) == 1.0
    assert counts.least_seconds(0, 3.35e12, counts.PEAK_BF16) == 1.0


def test_trilinear_cells_by_hand():
    # one sample at a cell centre's corner: 8 cells; a second in the same
    # cube adds none; a third at the far edge keeps only its in-volume corners
    zyx = torch.tensor([[[0.5, 0.5, 0.5], [0.25, 0.75, 0.5], [3.5, 3.5, 3.5]]])
    valid = torch.tensor([[True, True, True]])
    assert counts.trilinear_cells(zyx, valid, torch.tensor([0]), (4, 4, 4)) == 8 + 1
    valid = torch.tensor([[True, True, False]])
    assert counts.trilinear_cells(zyx, valid, torch.tensor([0]), (4, 4, 4)) == 8


def test_dense_flops_by_hand():
    rec = counts.WorkRecorder()
    x = torch.randn(1, 3, 5, 5)
    with rec:
        torch.nn.functional.conv2d(x, torch.randn(4, 3, 3, 3), padding=1)      # 25 * 4 * 27
        torch.nn.functional.linear(torch.randn(2, 6), torch.randn(5, 6))     # 2 * 5 * 6
        torch.nn.functional.conv_transpose2d(x, torch.randn(3, 2, 2, 2), stride=2)  # 75 * 8
        torch.bmm(torch.randn(2, 3, 3), torch.randn(2, 3, 3))               # not a layer
    assert rec.dense_flops == 2 * (25 * 4 * 27 + 2 * 5 * 6 + 75 * 8)


def test_sparse_pairs_by_hand():
    # three sites in a row along x, a 3x3x3 submanifold conv: the middle
    # site sees 3 matches, each end 2: 7 pairs
    coords = torch.tensor([[0, 1, 1, 1], [0, 1, 1, 2], [0, 1, 1, 3]], dtype=torch.int32)
    st = rsparse.from_coords(torch.ones(3, 2), coords, (3, 3, 5), 1)
    nbr = cuda_conv.neighbor_map(st.keys, st.coords, st.spatial_shape, 1, 3, 1, 1)
    rec = counts.WorkRecorder()
    with rec:
        cuda_conv.sparse_conv(st.features, st.keys, st.coords, torch.ones(27, 2, 4),
                              st.spatial_shape, 1, 3, 1, 1, nbr=nbr)
        cuda_interp.trilinear_pool(torch.ones(1, 2, 2, 2, 8), torch.full((1, 1, 3), 0.5),
                                   torch.tensor([0]), torch.tensor([[True]]))
    assert rec.k1 == [(7, 3, 3, 27, 2, 4)]
    assert rec.sparse_flops() == 2 * 7 * 2 * 4
    assert rec.k4 == [(1, 8, 1, 1, 8)]
