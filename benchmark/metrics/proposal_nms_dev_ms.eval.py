"""Device ms a batch of the operations launched inside the program's `proposal_nms` span."""


def read(layers):
    return layers.stage_dev_ms("proposal_nms")
