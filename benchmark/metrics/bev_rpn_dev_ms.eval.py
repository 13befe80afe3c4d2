"""Device ms a batch of the operations launched inside the `bev` and `dense_head` spans."""


def read(layers):
    return layers.stage_dev_ms("bev", "dense_head")
