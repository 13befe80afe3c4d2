"""Host wall ms a batch of the program's `vsa` span (keypoint sampling and the VSA), in the traced eval window."""


def read(layers):
    return layers.stage_host_ms("vsa")
