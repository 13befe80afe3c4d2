"""Host wall ms a batch of the program's `roi_head` span, in the traced eval window."""


def read(layers):
    return layers.stage_host_ms("roi_head")
