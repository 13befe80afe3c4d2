"""Device ms a batch of the operations launched inside the program's `point_head` span."""


def read(layers):
    return layers.stage_dev_ms("point_head")
