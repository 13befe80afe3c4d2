"""Host wall ms a batch of the program's `post_processing` span (the final NMS)."""


def read(layers):
    return layers.stage_host_ms("post_processing")
