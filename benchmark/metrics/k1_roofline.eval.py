"""K1's share of its roofline: the least time of the reference's matched pairs over the gather-GEMM kernels' time."""


def read(layers):
    return layers.k1_roofline()
