"""K4's share of its roofline: the least time of the valid roi samples over the trilinear pool kernel's time."""


def read(layers):
    return layers.k4_roofline()
