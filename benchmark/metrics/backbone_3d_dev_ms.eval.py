"""Device ms a batch of the operations launched inside the program's `backbone_3d` span."""


def read(layers):
    return layers.stage_dev_ms("backbone_3d")
