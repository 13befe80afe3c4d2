"""Device ms a batch of the operations launched inside the `post_processing` span."""


def read(layers):
    return layers.stage_dev_ms("post_processing")
