"""Host wall ms a batch of the program's `proposal_nms` span, in the traced eval window."""


def read(layers):
    return layers.stage_host_ms("proposal_nms")
